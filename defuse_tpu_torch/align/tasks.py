"""Split-alignment task construction, candidate realignment and breakpoint
voting — the ``dosplitalign`` / ``evalsplitalign`` equivalents.

Task setup (break regions from fragment-length stats, flanking reference
fetches, genomic mate regions remapped through overlapping transcripts)
mirrors ``tools/SplitAlignment.cpp:31-175``; candidate nomination streams
the improper SAM against 2kb-binned mate regions
(``SplitAlignment.cpp:177-303``); the per-fusion breakpoint vote and
sequence reconstruction mirror ``SplitAlignment.cpp:484-594``.

Candidate order per mate alignment is ascending signed (clusterID |
clusterEnd<<31) — the canonical order of the golden build.
"""

from __future__ import annotations

import dataclasses

from ..core.exons import ExonRegions
from ..core.types import revcomp
from ..io.fasta import FastaStore
from .split_dp import (MIN_ANCHOR, SplitReadAligner, accept_threshold)

NUM_BREAK_PADDING = 10  # SplitAlignment.cpp:25 (unused on this path)


def parse_transcript_id(ref_name: str):
    fields = ref_name.split("|")
    if len(fields) < 2:
        return None, None
    return fields[0], fields[1]


def calculate_break_region(min_read_length, max_read_length,
                           max_fragment_length, align_start, align_end,
                           strand):
    """``SplitAlignment.cpp:637-655``."""
    align_region_length = align_end - align_start + 1
    push = min(max_read_length, int(0.5 * align_region_length))
    break_length = (max_fragment_length - align_region_length
                    - min_read_length + 2 * push)
    if strand == 0:
        break_start = align_end - push + 1
    else:
        break_start = align_start + push - 1
    return break_start, break_length


@dataclasses.dataclass
class Location:
    ref_name: str
    strand: int
    start: int
    end: int


@dataclasses.dataclass
class SplitRow:
    """One split-alignment output row (``SplitAlignment.cpp:305-317``)."""
    fusion_id: int
    fragment: int
    read_end: int
    rev_comp: int
    ref_split: tuple[int, int]
    read_split: tuple[int, int]
    score: int

    def format(self) -> str:
        return "{}\t{}\t{}\t{}\t{}\t{}\t{}\t{}\t{}\t".format(
            self.fusion_id, self.fragment, self.read_end, self.rev_comp,
            self.ref_split[0], self.ref_split[1],
            self.read_split[0], self.read_split[1], self.score)

    @classmethod
    def parse(cls, line: str) -> "SplitRow":
        f = line.rstrip("\n").split("\t")
        return cls(int(f[0]), int(f[1]), int(f[2]), int(f[3]),
                   (int(f[4]), int(f[5])), (int(f[6]), int(f[7])),
                   int(f[8]))


class SplitAlignmentTask:
    """Per-fusion split alignment context (``SplitAlignmentTask``)."""

    def __init__(self, fusion_id: int, align_pair: list[Location],
                 reference: FastaStore, exon_regions: ExonRegions,
                 fragment_mean: float, fragment_stddev: float,
                 min_read_length: int, max_read_length: int):
        self.fusion_id = fusion_id
        self.align_ref_name = [l.ref_name for l in align_pair]
        self.align_strand = [l.strand for l in align_pair]
        self.split_seq_strand = [0, 0]
        self.split_align_seq = ["", ""]
        self.split_remainder_seq = ["", ""]
        self.split_align_seq_start = [0, 0]
        self.split_align_seq_length = [0, 0]
        self.mate_regions: list[list[Location]] = [[], []]

        min_fragment_length = int(fragment_mean - 3 * fragment_stddev)
        max_fragment_length = int(fragment_mean + 3 * fragment_stddev)

        for cluster_end in (0, 1):
            loc = align_pair[cluster_end]
            align_strand = loc.strand
            ref_seq_strand = (align_strand if cluster_end == 0
                              else 1 - align_strand)
            break_start, break_length = calculate_break_region(
                min_read_length, max_read_length, max_fragment_length,
                loc.start, loc.end, align_strand)

            self.split_seq_strand[cluster_end] = ref_seq_strand

            if align_strand == 0:
                seq_start = break_start - max_read_length
                seq_length = break_length + max_read_length
            else:
                seq_start = break_start - break_length + 1
                seq_length = break_length + max_read_length

            seq, seq_start, seq_length = reference.get(
                loc.ref_name, ref_seq_strand, seq_start, seq_length)
            self.split_align_seq[cluster_end] = seq
            self.split_align_seq_start[cluster_end] = seq_start
            self.split_align_seq_length[cluster_end] = seq_length

            # remainder sequence for fusion-sequence reconstruction
            if align_strand == 0:
                if loc.start < seq_start:
                    rem, _, _ = reference.get(
                        loc.ref_name, ref_seq_strand, loc.start,
                        seq_start - loc.start)
                    self.split_remainder_seq[cluster_end] = rem
            else:
                seq_end = seq_start + seq_length - 1
                if loc.end > seq_end:
                    rem, _, _ = reference.get(
                        loc.ref_name, ref_seq_strand, seq_end + 1,
                        loc.end - seq_end)
                    self.split_remainder_seq[cluster_end] = rem

            # genomic break-region start
            gene, transcript = parse_transcript_id(loc.ref_name)
            if transcript is not None and exon_regions.is_transcript(
                    transcript):
                chromosome, genome_align_strand, genome_break_start = \
                    exon_regions.remap_transcript_to_genome(
                        transcript, align_strand, break_start)
            else:
                chromosome = loc.ref_name
                genome_align_strand = align_strand
                genome_break_start = break_start

            mate_min = min_fragment_length - break_length - max_read_length + 1
            mate_max = max_fragment_length - min_read_length

            if genome_align_strand == 0:
                g_start = genome_break_start - mate_max
                g_end = genome_break_start - mate_min
            else:
                g_start = genome_break_start + mate_min
                g_end = genome_break_start + mate_max

            self.mate_regions[cluster_end].append(
                Location(chromosome, genome_align_strand, g_start, g_end))

            for t in exon_regions.region_transcripts(chromosome, g_start,
                                                     g_end):
                remap_gene = exon_regions.transcript_gene(t)
                res = exon_regions.remap_through_transcript(
                    t, genome_break_start, 1 - genome_align_strand,
                    mate_min, mate_max)
                if res is None:
                    continue
                remap_strand, m_start, m_end = res
                self.mate_regions[cluster_end].append(
                    Location(f"{remap_gene}|{t}", 1 - remap_strand,
                             m_start, m_end))

    # -- alignment -------------------------------------------------------

    def align_read(self, fragment: int, read_end: int, rev_comp: int,
                   read_seq: str) -> list[SplitRow]:
        """``SplitAlignmentTask::Align`` (``SplitAlignment.cpp:371-444``)."""
        aligner = SplitReadAligner(self.split_align_seq[0],
                                   self.split_align_seq[1])
        hits = aligner.align(read_seq, accept_threshold(len(read_seq)),
                             force_split=True)
        rows = []
        seen_splits = set()
        for hit in hits:
            if hit.ref_split in seen_splits:
                continue
            seen_splits.add(hit.ref_split)
            rows.append(SplitRow(
                self.fusion_id, fragment, read_end, rev_comp,
                hit.ref_split, hit.read_split,
                min(hit.score1, hit.score2)))
        return rows

    # -- evaluation ------------------------------------------------------

    def evaluate(self, rows: list[SplitRow]):
        """Breakpoint vote (``SplitAlignmentTask::Evaluate``)."""
        pred = BreakPrediction(
            fusion_id=self.fusion_id,
            align_ref_name=list(self.align_ref_name),
            align_strand=list(self.align_strand),
            sequence="N", split_read_count=0,
            split_pos_avg=-1.0, split_min_avg=-1.0,
            break_pos=[0, 0], alignments=[])
        if not rows:
            return pred

        split_score: dict[tuple[int, int], int] = {}
        for row in rows:
            split_score[row.ref_split] = split_score.get(row.ref_split, 0) \
                + row.score

        # strict > over ascending split order (canonical / ordered shim)
        max_score = -1
        best_split = None
        for split in sorted(split_score):
            if split_score[split] > max_score:
                best_split = split
                max_score = split_score[split]

        pred.alignments = [r for r in rows if r.ref_split == best_split]

        seq0, seq1 = self.split_align_seq
        align_break_1 = self.split_remainder_seq[0] + seq0[:best_split[0]]
        align_break_2 = seq1[best_split[1] + 1:] + self.split_remainder_seq[1]
        pred.sequence = align_break_1 + "|" + align_break_2

        if self.split_seq_strand[0] == 0:
            pred.break_pos[0] = self.split_align_seq_start[0] \
                + best_split[0] - 1
        else:
            pred.break_pos[0] = self.split_align_seq_start[0] \
                + self.split_align_seq_length[0] - best_split[0]
        if self.split_seq_strand[1] == 0:
            pred.break_pos[1] = self.split_align_seq_start[1] \
                + best_split[1] + 1
        else:
            pred.break_pos[1] = self.split_align_seq_start[1] \
                + self.split_align_seq_length[1] - best_split[1] - 2

        pos_sum = 0.0
        min_sum = 0.0
        for row in pred.alignments:
            left = row.read_split[0]
            right = row.read_split[1]
            pos_range = float(left + right - 2 * MIN_ANCHOR)
            pos_value = float(max(0, left - MIN_ANCHOR))
            import math
            min_range = math.floor(0.5 * float(left + right - 2 * MIN_ANCHOR))
            min_value = float(max(0, min(left - MIN_ANCHOR,
                                         right - MIN_ANCHOR)))
            pos_sum += pos_value / pos_range
            min_sum += min_value / min_range
        n = len(pred.alignments)
        pred.split_read_count = n
        pred.split_pos_avg = pos_sum / n
        pred.split_min_avg = min_sum / n
        return pred


@dataclasses.dataclass
class BreakPrediction:
    fusion_id: int
    align_ref_name: list[str]
    align_strand: list[int]
    sequence: str
    split_read_count: int
    split_pos_avg: float
    split_min_avg: float
    break_pos: list[int]
    alignments: list[SplitRow]

    def format_sequence(self) -> str:
        """``BreakPrediction::WriteSequence`` (C++ default float fmt)."""
        return "{}\t{}\t0\t{}\t{}\t{}".format(
            self.fusion_id, self.sequence, self.split_read_count,
            _cxx_double(self.split_pos_avg), _cxx_double(self.split_min_avg))

    def format_break(self) -> list[str]:
        return ["{}\t{}\t{}\t{}\t{}".format(
            self.fusion_id, end, self.align_ref_name[end],
            "+" if self.align_strand[end] == 0 else "-", self.break_pos[end])
            for end in (0, 1)]


def _cxx_double(x: float) -> str:
    """Format like ``std::ostream <<`` with default precision 6."""
    return f"{x:.6g}"


class BinnedLocations:
    """2kb-binned mate-region lookup (``SplitAlignment.cpp:177-229``)."""

    def __init__(self, bin_spacing: int = 2000):
        self.bin_spacing = bin_spacing
        self.ids: list[int] = []
        self.regions: list[tuple[int, int]] = []
        self.region_refs: list[str] = []   # per-region ref / strand for
        self.region_strands: list[int] = []  # array export (native path)
        self.binned: list[dict[str, dict[int, list[int]]]] = [{}, {}]

    def add(self, id_: int, location: Location) -> None:
        idx = len(self.ids)
        self.ids.append(id_)
        self.regions.append((location.start, location.end))
        self.region_refs.append(location.ref_name)
        self.region_strands.append(location.strand)
        by_ref = self.binned[location.strand].setdefault(
            location.ref_name, {})
        for b in range(location.start // self.bin_spacing,
                       location.end // self.bin_spacing + 1):
            by_ref.setdefault(b, []).append(idx)

    def overlapping(self, ref_name: str, strand: int, start: int,
                    end: int) -> set[int]:
        ids: set[int] = set()
        by_ref = self.binned[strand].get(ref_name)
        if by_ref is None:
            return ids
        for b in range(start // self.bin_spacing,
                       end // self.bin_spacing + 1):
            for idx in by_ref.get(b, ()):
                rs, re = self.regions[idx]
                if rs <= end and re >= start:
                    ids.add(self.ids[idx])
        return ids


def _signed32(x: int) -> int:
    return x - (1 << 32) if x >= (1 << 31) else x


class SplitReadRealigner:
    """Streams improper mate alignments, nominates and aligns split-read
    candidates (``SplitReadRealigner``, ``SplitAlignment.cpp:231-303``)."""

    def __init__(self):
        self.binned = BinnedLocations(2000)
        self.tasks: dict[int, SplitAlignmentTask] = {}
        self.reads: dict[int, str] = {}

    def add_task(self, task: SplitAlignmentTask) -> None:
        self.tasks[task.fusion_id] = task
        for cluster_end in (0, 1):
            cid = task.fusion_id | (cluster_end << 31)
            for region in task.mate_regions[cluster_end]:
                self.binned.add(cid, region)

    def add_reads_fastq(self, path: str) -> None:
        from ..io.readindex import iter_renamed_fastq
        for read_id, seq in iter_renamed_fastq(path):
            self.reads[read_id] = seq

    def align_stream(self, mate_alignments, out) -> None:
        """mate_alignments: iterable of SamRecord; out: writable."""
        candidate_unique: dict[int, set[tuple[int, int]]] = {}
        for aln in mate_alignments:
            ids = self.binned.overlapping(aln.reference, aln.strand,
                                          aln.start, aln.end)
            for cid in sorted(ids, key=_signed32):
                cluster_id = cid & 0x7FFFFFFF
                cluster_end = (cid >> 31) & 1
                fragment = int(aln.fragment)
                read_end = 0 if aln.read_end == 1 else 1
                rev_comp = 1 if cluster_end == 0 else 0
                read_id = fragment | (read_end << 31)
                read_seq = self.reads.get(read_id, "")
                if rev_comp:
                    read_seq = revcomp(read_seq)
                seen = candidate_unique.setdefault(cluster_id, set())
                if (read_id, rev_comp) in seen:
                    continue
                seen.add((read_id, rev_comp))
                for row in self.tasks[cluster_id].align_read(
                        fragment, read_end, rev_comp, read_seq):
                    out.write(row.format() + "\n")


def read_align_region_pairs(path: str) -> dict[int, list[Location]]:
    """Regions file: id, end, ref, strand, start, end
    (``Parsers.cpp:211-264``)."""
    pairs: dict[int, list[Location]] = {}
    with open(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line:
                continue
            f = line.split("\t")
            if len(f) < 5:
                continue
            pair_id = int(f[0])
            pair_end = int(f[1])
            loc = Location(f[2], 0 if f[3] == "+" else 1, int(f[4]),
                           int(f[5]))
            pairs.setdefault(pair_id, [None, None])[pair_end] = loc
    return pairs


def create_tasks(reference: FastaStore, exon_regions: ExonRegions,
                 fragment_mean, fragment_stddev, min_read_length,
                 max_read_length,
                 fusion_regions: dict[int, list[Location]]):
    tasks = {}
    for fid in sorted(fusion_regions):
        tasks[fid] = SplitAlignmentTask(
            fid, fusion_regions[fid], reference, exon_regions,
            fragment_mean, fragment_stddev, min_read_length,
            max_read_length)
    return tasks


def evaluate_file(tasks, split_alignments_path: str, seq_out, break_out,
                  predalign_out) -> None:
    """Group fusion-sorted rows and evaluate (``evalsplitalign.cpp:96-114``)."""
    with open(split_alignments_path) as fh:
        group: list[SplitRow] = []
        for line in fh:
            row = SplitRow.parse(line)
            if group and row.fusion_id != group[0].fusion_id:
                _emit(tasks, group, seq_out, break_out, predalign_out)
                group = []
            group.append(row)
        if group:
            _emit(tasks, group, seq_out, break_out, predalign_out)


def _emit(tasks, group, seq_out, break_out, predalign_out):
    pred = tasks[group[0].fusion_id].evaluate(group)
    seq_out.write(pred.format_sequence() + "\n")
    for line in pred.format_break():
        break_out.write(line + "\n")
    for row in pred.alignments:
        predalign_out.write(row.format() + "\n")
