"""Null-distribution sampling from concordant pairs — the ``calccov``
equivalent (``tools/calccov.cpp``).

Drops ``rand() % length + 1`` marker positions (exact glibc stream,
seed 11) on single-exon-gene transcripts in sorted gene order (the
canonical order of the golden build), then emits per-marker
(spanning fragment length) and (split position / split minimum)
statistic samples from concordant cdna pairs.
"""

from __future__ import annotations

import math

from ..core.exons import ExonRegions
from ..io.sam import iter_sam
from .crand import GlibcRand

BIN_SPACING = 10000


def calc_split_pos(start, end, position, anchor):
    value = max(0.0, float(position - start - anchor))
    rng = end - start + 1.0 - 2.0 * anchor
    return value / rng


def calc_split_min(start, end, position, anchor):
    value = max(0.0, float(min(position - start - anchor,
                               end + 1 - position - anchor)))
    rng = math.floor(0.5 * (end - start + 1.0 - 2.0 * anchor))
    return value / rng


def sample_positions(exon_regions: ExonRegions, density: float,
                     multi_exon: bool = False, seed: int = 11):
    """Marker positions per eligible transcript (``calccov.cpp:116-141``).

    Returns (ref_index: {transcript_id: int}, positions: [(ref_idx, pos)]).
    """
    rng = GlibcRand(seed)
    ref_index: dict[str, int] = {}
    positions: list[tuple[int, int]] = []
    genes = sorted(exon_regions._gene_transcripts)
    for gene in genes:
        transcripts = exon_regions.gene_transcripts(gene)
        if len(transcripts) == 1 or multi_exon:
            transcript = transcripts[0]
            tid = f"{gene}|{transcript}"
            idx = ref_index.setdefault(tid, len(ref_index))
            length = exon_regions.transcript_length(transcript)
            n_markers = int(length * density)
            for _ in range(n_markers):
                positions.append((idx, rng.rand() % length + 1))
    return ref_index, positions


def calccov(concordant_sam_path, exon_regions: ExonRegions, *,
            trim_length: int, split_min_anchor: int, density: float,
            multi_exon: bool = False):
    """Full calccov pass.  Returns (span_samples, splitpos_samples,
    splitmin_samples) as lists of (marker_index, value)."""
    ref_index, positions = sample_positions(exon_regions, density,
                                            multi_exon)

    binned: dict[tuple[int, int], list[int]] = {}
    for i, (ref, pos) in enumerate(positions):
        binned.setdefault((ref, pos // BIN_SPACING), []).append(i)

    def contained(ref, start, end):
        found = set()
        for b in range(start // BIN_SPACING, end // BIN_SPACING + 1):
            found.update(binned.get((ref, b), ()))
        return sorted(found)  # canonical ascending (ordered-shim golden)

    span, spos, smin = [], [], []

    def groups():
        cur = []
        for rec in iter_sam(concordant_sam_path):
            if cur and cur[0].fragment != rec.fragment:
                yield cur
                cur = []
            cur.append(rec)
        if cur:
            yield cur

    for group in groups():
        if len(group) != 2:
            raise ValueError("expected 2 alignments per fragment "
                             f"({group[0].fragment})")
        a0, a1 = group
        if a0.reference not in ref_index:
            continue
        ref = ref_index[a0.reference]
        unseq_start = min(a0.start + trim_length, a1.start + trim_length)
        unseq_end = max(a0.end - trim_length, a1.end - trim_length)
        frag_len = max(a0.end, a1.end) - min(a0.start, a1.start)
        for i in contained(ref, unseq_start, unseq_end):
            pos = positions[i][1]
            if unseq_start <= pos <= unseq_end:
                span.append((i, frag_len))
        for aln in (a0, a1):
            a_start = aln.start + split_min_anchor
            a_end = aln.end - split_min_anchor + 1
            for i in contained(ref, a_start, a_end):
                pos = positions[i][1]
                if a_start <= pos <= a_end:
                    spos.append((i, calc_split_pos(
                        aln.start, aln.end, pos, split_min_anchor)))
                    smin.append((i, calc_split_min(
                        aln.start, aln.end, pos, split_min_anchor)))
    return span, spos, smin


def _cxx_double(x: float) -> str:
    return f"{x:.6g}"


def write_samples(samples, path, float_values: bool) -> None:
    if str(path).endswith(".gz"):
        import gzip
        ctx = gzip.open(path, "wt", compresslevel=1)
    else:
        ctx = open(path, "w")
    with ctx as out:
        for idx, value in samples:
            if float_values:
                out.write(f"{idx}\t{_cxx_double(value)}\n")
            else:
                out.write(f"{idx}\t{value}\n")
