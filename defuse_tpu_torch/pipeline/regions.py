"""Cluster align-region aggregation (``scripts/get_align_regions.pl``).

Canonical ascending (cluster, end) output order; the reference's Perl hash
order is arbitrary, so the canonical order is the contract both our
pipeline and the golden chain consume.
"""

from __future__ import annotations


def align_regions_lines(cluster_rows) -> list[str]:
    """Aggregate min/max alignment extents per (cluster, end).

    Accepts ClusterRow objects or raw TSV lines.
    """
    agg: dict[tuple[int, int], list] = {}
    for row in cluster_rows:
        if isinstance(row, str):
            fields = row.split("\t")
            cid, cend = int(fields[0]), int(fields[1])
            ref, strand = fields[4], 0 if fields[5] == "+" else 1
            start, end = int(fields[6]), int(fields[7])
        else:
            cid, cend = row.cluster_id, row.cluster_end
            ref, strand = row.ref_name, row.strand
            start, end = row.start, row.end
        key = (cid, cend)
        if key not in agg:
            agg[key] = [ref, strand, start, end]
        else:
            agg[key][2] = min(agg[key][2], start)
            agg[key][3] = max(agg[key][3], end)
    lines = []
    for (cid, cend) in sorted(agg):
        ref, strand, start, end = agg[(cid, cend)]
        lines.append(f"{cid}\t{cend}\t{ref}\t"
                     f"{'-' if strand else '+'}\t{start}\t{end}")
    return lines


def align_regions_file(sc_path, out_path) -> None:
    """File->file variant of :func:`align_regions_lines`, routed through
    the native ``dt_align_regions`` when built (byte-identical output,
    pinned by test) — the Python line loop was ~30ms on the bench
    workload and scales with cluster count at depth."""
    import ctypes
    import pathlib

    from ..cluster import native

    if native.available():
        lib = native.load_library()
        rc = lib.dt_align_regions(str(sc_path).encode(),
                                  str(out_path).encode())
        if rc > 0:
            return
        if rc == 0:
            # the python path writes a single newline for empty input
            # ("\n".join([]) + "\n"); keep the bytes identical
            pathlib.Path(out_path).write_text("\n")
            return
        # rc < 0: parse/IO error — fall through to the python path
    text = pathlib.Path(sc_path).read_text()
    pathlib.Path(out_path).write_text(
        "\n".join(align_regions_lines(text.splitlines())) + "\n")
