"""Supporting-read evidence viewer — ``defuse_get_reads.pl`` + the
``splitseq`` binary equivalents.

Prints the split-read alignment text for one cluster (re-running the
split alignment with backtrace, ``tools/splitseq.cpp:93-125`` /
``SplitAlignment::ReAlign`` + ``WriteAlignText``), then the spanning
compact rows whose fragments support the cluster
(``defuse_get_reads.pl:95-146``).
"""

from __future__ import annotations

import pathlib
import sys

from ..align.split_dp import SplitReadAligner, accept_threshold, \
    render_alignment_text
from ..align.tasks import SplitRow, create_tasks, read_align_region_pairs
from ..core.exons import ExonRegions
from ..core.types import revcomp
from ..io.fasta import FastaStore


def splitseq_text(task, rows, reads: dict[int, str], out) -> None:
    """WriteAlignText output for one fusion's predicted alignments."""
    out.write(f"{task.fusion_id}\n")
    out.write(f"{task.split_align_seq[0]}|{task.split_align_seq[1]}\n")
    aligner = SplitReadAligner(task.split_align_seq[0],
                               task.split_align_seq[1])
    for row in rows:
        read_id = row.fragment | (row.read_end << 31)
        read_seq = reads.get(read_id, "")
        if row.rev_comp:
            read_seq = revcomp(read_seq)
        hits = aligner.align(read_seq, accept_threshold(len(read_seq)),
                             force_split=True)
        seen = set()
        for hit in hits:
            if hit.ref_split in seen:
                continue
            seen.add(hit.ref_split)
            if hit.ref_split == row.ref_split:
                m1, m2 = aligner.matches_for_hit(hit)
                out.write(render_alignment_text(
                    row.fragment, row.read_end, read_seq,
                    len(task.split_align_seq[0]), m1, m2))
                break


def get_fusion_fastq(output_directory: str, cluster_ids,
                     fastq1_out: str, fastq2_out: str) -> int:
    """Export the supporting reads of the given clusters as renamed
    paired fastq — the ``get_fusion_fastq.pl`` contract (single ``--id``
    or batch ``--list`` mode, ``get_fusion_fastq.pl:17-25``).

    Fragments come from ``clusters.sc`` member rows plus
    ``splitreads.predalign`` split-read rows; each read is renamed
    ``{cluster_id}_{fragment_id}/{end}`` (later sources overwrite the
    name for shared fragments, as the reference's hash writes do) and
    records are pulled through the ``.fqi`` seek index in ascending
    fragment order.  Returns the number of fragments written.
    """
    outdir = pathlib.Path(output_directory)
    wanted = {str(c) for c in cluster_ids}
    names: dict[int, str] = {}
    with open(outdir / "clusters.sc") as fh:
        for line in fh:
            f = line.rstrip("\n").split("\t")
            if f[0] in wanted:
                names[int(f[2])] = f"{f[0]}_{f[2]}"
    predalign = outdir / "splitreads.predalign"
    if predalign.exists():
        with open(predalign) as fh:
            for line in fh:
                f = line.rstrip("\n").split("\t")
                if f[0] in wanted:
                    names[int(f[1])] = f"{f[0]}_{f[1]}"

    from ..io.readindex import ReadIndex
    prefix = outdir / "reads" / "reads"
    if not (outdir / "reads" / "reads.fqi").exists():
        raise FileNotFoundError(f"{prefix}.fqi (run with kept reads dir)")
    with ReadIndex(str(prefix)) as ridx:
        for end, path in ((0, fastq1_out), (1, fastq2_out)):
            with open(path, "w") as out:
                for frag in sorted(names):
                    rec = ridx.get_record(frag, end)
                    if rec is None:
                        raise KeyError(
                            f"unable to retrieve read {frag}/{end + 1}")
                    out.write(f"@{names[frag]}/{end + 1}\n{rec[1]}\n"
                              f"{rec[2]}\n{rec[3]}\n")
    return len(names)


def cluster_sequences(reference: FastaStore, clusters_path: str,
                      out=sys.stdout) -> int:
    """Approximate fusion sequences from cluster extents — the
    ``get_fusion_sequences.pl`` contract: per cluster end take the
    min-start/max-end envelope of its member alignments, fetch the
    reference span (1-based inclusive), and join the two flanks with an
    ``N`` oriented by the strand pair (``get_fusion_sequences.pl``
    strand table).  Clusters are emitted in ascending id order (the
    reference iterates an unordered Perl hash; sorted order is the
    deterministic choice).  Returns the number of clusters written.
    """
    ends: dict[str, dict[int, dict]] = {}
    with open(clusters_path) as fh:
        for line in fh:
            f = line.rstrip("\n").split("\t")
            info = ends.setdefault(f[0], {}).setdefault(
                int(f[1]), {"ref": f[4], "strand": f[5],
                            "start": int(f[6]), "end": int(f[7])})
            info["ref"] = f[4]
            info["strand"] = f[5]
            info["start"] = min(info["start"], int(f[6]))
            info["end"] = max(info["end"], int(f[7]))

    def fetch(info):
        seq = reference.sequence(info["ref"])
        return seq[info["start"] - 1:info["end"]]

    n = 0
    for cid in sorted(ends, key=lambda c: (len(c), c)):
        if 0 not in ends[cid] or 1 not in ends[cid]:
            continue
        s1, s2 = ends[cid][0]["strand"], ends[cid][1]["strand"]
        seq1, seq2 = fetch(ends[cid][0]), fetch(ends[cid][1])
        if (s1, s2) == ("+", "-"):
            seq = seq1 + "N" + seq2
        elif (s1, s2) == ("-", "+"):
            seq = seq2 + "N" + seq1
        elif (s1, s2) == ("-", "-"):
            seq = revcomp(seq1) + "N" + seq2
        else:
            seq = seq1 + "N" + revcomp(seq2)
        out.write(f">{cid}\n{seq}\n")
        n += 1
    return n


def get_reads(config, output_directory: str, cluster_id: int,
              out=sys.stdout) -> None:
    outdir = pathlib.Path(output_directory)
    reference = FastaStore.from_file(config.get_value("reference_fasta"))
    exons = ExonRegions.from_file(config.get_value("cdna_regions"))

    stats = {}
    with open(outdir / "concordant.read.stats") as fh:
        keys = fh.readline().rstrip("\n").split("\t")
        values = fh.readline().rstrip("\n").split("\t")
        stats = dict(zip(keys, values))

    fusion_regions = read_align_region_pairs(
        str(outdir / "clusters.sc.regions"))
    if cluster_id not in fusion_regions:
        raise KeyError(f"Unable to find cluster {cluster_id}")
    tasks = create_tasks(
        reference, exons, float(stats["fraglength_mean"]),
        float(stats["fraglength_stddev"]), int(stats["readlength_min"]),
        int(stats["readlength_max"]), {cluster_id:
                                       fusion_regions[cluster_id]})
    task = tasks[cluster_id]

    rows = []
    with open(outdir / "splitreads.predalign") as fh:
        for line in fh:
            row = SplitRow.parse(line)
            if row.fusion_id == cluster_id:
                rows.append(row)

    reads: dict[int, str] = {}
    prefix = outdir / "reads" / "reads"
    if (outdir / "reads" / "reads.fqi").exists():
        # O(1) seeks for just the rows' reads (ReadIndex.cpp contract)
        from ..io.readindex import ReadIndex
        with ReadIndex(str(prefix)) as ridx:
            for row in rows:
                rid = row.fragment | (row.read_end << 31)
                if rid not in reads:
                    reads[rid] = ridx.get(row.fragment, row.read_end)
    else:
        for end in (1, 2):
            path = outdir / "reads" / f"reads.{end}.fastq"
            if not path.exists():
                continue
            with open(path) as fh:
                while True:
                    header = fh.readline()
                    if not header:
                        break
                    seq = fh.readline().rstrip("\n")
                    fh.readline()
                    fh.readline()
                    frag = int(header[1:].rsplit("/", 1)[0])
                    reads[frag | ((end - 1) << 31)] = seq

    out.write("Split Reads:\n")
    splitseq_text(task, rows, reads, out)
    out.write("\n")

    # spanning reads matching the cluster extents
    cluster_info: dict = {}
    with open(outdir / "clusters.sc") as fh:
        for line in fh:
            f = line.rstrip("\n").split("\t")
            if int(f[0]) != cluster_id:
                continue
            cend = int(f[1])
            info = cluster_info.setdefault(cend, {
                "ref": f[4], "strand": f[5], "start": int(f[6]),
                "end": int(f[7]), "fragments": set()})
            info["start"] = min(info["start"], int(f[6]))
            info["end"] = max(info["end"], int(f[7]))
            info["fragments"].add(int(f[2]))

    out.write("Spanning Reads:\n")
    spanning_path = outdir / "spanning.compact"
    if not spanning_path.exists():
        return
    found: dict[int, dict[int, str]] = {}
    with open(spanning_path) as fh:
        for line in fh:
            f = line.rstrip("\n").split("\t")
            frag, strand = int(f[0]), f[3]
            start, end = int(f[4]), int(f[5])
            for cend, info in cluster_info.items():
                if frag in info["fragments"] and strand == info["strand"] \
                        and start <= info["end"] and end >= info["start"]:
                    found.setdefault(frag, {})[cend] = line
    for frag in sorted(found):
        for cend in (0, 1):
            if cend in found[frag]:
                out.write(found[frag][cend])
