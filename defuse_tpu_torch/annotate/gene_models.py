"""Gene models from GTF — the ``scripts/gene_models.pm`` equivalent.

Loads exon/CDS features, derives UTRs, builds genomic binning, gene
adjacency (bridging up to one gap) and coordinate maps between
transcript/genome space.  Transcript ids are ``gene|transcript`` like the
reference (``gene_models.pm:63``).

Deliberate deviation: the reference's nearest-gene candidate binning
carries a latent bug (``gene_models.pm:672,685`` read
``$bins_ref->{genes}`` which never exists, so the forward/backward
"current gene" tracking degrades to last-seen-in-hash-order — Perl hash
order, i.e. non-deterministic run to run).  We implement a correct,
deterministic nearest-gene: all genes in overlapped bins plus the nearest
gene on each side, distance-minimized with ties to the smaller gene id.
"""

from __future__ import annotations

import bisect
import dataclasses
import re

BIN_SPACING = 10000


@dataclasses.dataclass
class Transcript:
    gene: str
    chromosome: str
    strand: str
    exons: list  # sorted by start
    cds: list
    utr5p: list
    utr3p: list

    @property
    def length(self) -> int:
        return sum(e - s + 1 for s, e in self.exons)


@dataclasses.dataclass
class Gene:
    name: str
    chromosome: str
    strand: str
    source: str
    transcripts: list
    region: tuple[int, int] = (0, 0)


_ATTR_RE = re.compile(r"(\S+)\s+(.*)")


class GeneModels:
    def __init__(self, gtf_path: str):
        self.transcripts: dict[str, Transcript] = {}
        self.genes: dict[str, Gene] = {}
        self._chrom_genes: dict[str, list[str]] = {}
        self.adjacent: dict[str, set[str]] = {}

        accepted = {"CDS", "exon", "start_codon", "stop_codon"}
        with open(gtf_path) as fh:
            for line in fh:
                if line.startswith("#"):
                    continue
                f = line.rstrip("\n").split("\t")
                chromosome, source, feature = f[0], f[1], f[2]
                if feature not in accepted:
                    continue
                start, end, strand = int(f[3]), int(f[4]), f[6]
                attrs = {}
                for part in f[8].split(";"):
                    m = _ATTR_RE.match(part.strip())
                    if m:
                        attrs[m.group(1)] = m.group(2).replace('"', "")
                gene_id = attrs["gene_id"]
                transcript_id = gene_id + "|" + attrs["transcript_id"]
                gene_name = attrs.get("gene_name", gene_id)

                t = self.transcripts.get(transcript_id)
                if t is None:
                    t = Transcript(gene_id, chromosome, strand, [], [], [],
                                   [])
                    self.transcripts[transcript_id] = t
                if feature == "exon":
                    t.exons.append((start, end))
                elif feature == "CDS":
                    t.cds.append((start, end))

                g = self.genes.get(gene_id)
                if g is None:
                    g = Gene(gene_name, chromosome, strand, source, [])
                    self.genes[gene_id] = g
                    self._chrom_genes.setdefault(chromosome, []).append(
                        gene_id)
                if transcript_id not in g.transcripts:
                    g.transcripts.append(transcript_id)

        for t in self.transcripts.values():
            t.exons.sort()
            t.cds.sort()

        for gene_id, g in self.genes.items():
            starts = [self.transcripts[t].exons[0][0]
                      for t in g.transcripts]
            ends = [self.transcripts[t].exons[-1][1]
                    for t in g.transcripts]
            g.region = (min(starts), max(ends))

        # UTRs (gene_models.pm:139-182)
        for t in self.transcripts.values():
            if not t.cds:
                continue
            coding_start = t.cds[0][0]
            coding_end = t.cds[-1][1]
            for es, ee in t.exons:
                if es < coding_start:
                    seg = (es, min(ee, coding_start - 1))
                    (t.utr5p if t.strand == "+" else t.utr3p).append(seg)
                elif ee > coding_end:
                    seg = (max(es, coding_end + 1), ee)
                    (t.utr3p if t.strand == "+" else t.utr5p).append(seg)

        # per-chromosome structures
        self._bins: dict[str, dict[int, list[str]]] = {}
        self._sorted_by_start: dict[str, list[tuple[int, str]]] = {}
        for chromosome, gene_ids in self._chrom_genes.items():
            bins: dict[int, list[str]] = {}
            for gid in sorted(gene_ids):
                r = self.genes[gid].region
                for b in range(r[0] // BIN_SPACING, r[1] // BIN_SPACING + 1):
                    bins.setdefault(b, []).append(gid)
            self._bins[chromosome] = bins
            self._sorted_by_start[chromosome] = sorted(
                (self.genes[g].region[0], g) for g in gene_ids)
            self._build_adjacency(chromosome)

        # prefix-max of region ends over the start-sorted gene list, used
        # to bound the nearest-gene backward walk
        self._prefix_max_end: dict[str, list[int]] = {}
        for chromosome, genes in self._sorted_by_start.items():
            prefix = []
            m = -(1 << 60)
            for _start, gid in genes:
                m = max(m, self.genes[gid].region[1])
                prefix.append(m)
            self._prefix_max_end[chromosome] = prefix

    # -- adjacency (gene_models.pm:756-803) ------------------------------

    def _build_adjacency(self, chromosome: str) -> None:
        order = sorted(self._chrom_genes[chromosome],
                       key=lambda g: self.genes[g].region[0])
        for i, g1 in enumerate(order):
            neighbours = [g1]
            hood = list(self.genes[g1].region)
            bridged = 0
            for g2 in order[i + 1:]:
                r2 = self.genes[g2].region
                if hood[1] < r2[0] or hood[0] > r2[1]:
                    bridged += 1
                if bridged == 2:
                    break
                hood[0] = min(hood[0], r2[0])
                hood[1] = max(hood[1], r2[1])
                neighbours.append(g2)
            for a in neighbours:
                for b in neighbours:
                    if a != b:
                        self.adjacent.setdefault(a, set()).add(b)

    # -- queries ---------------------------------------------------------

    def is_transcript(self, ref_name: str) -> bool:
        return ref_name in self.transcripts

    def is_chromosome(self, ref_name: str) -> bool:
        return ref_name in self._chrom_genes

    def calc_gene(self, ref_name: str, break_pos: int) -> str:
        """``gene_models.pm:228-246``."""
        if self.is_transcript(ref_name):
            return self.transcripts[ref_name].gene
        if not self.is_chromosome(ref_name):
            return ""
        return self.calc_nearest_gene(ref_name, break_pos)

    def calc_nearest_gene(self, chromosome: str, pos: int) -> str:
        """Deterministic true nearest gene (see module docstring): the
        minimum-distance gene over (a) genes overlapping pos, (b) the
        closest gene ending before pos (via a prefix-max-end array), and
        (c) the first gene starting after pos.  Ties -> smaller gene id.
        """
        genes = self._sorted_by_start.get(chromosome)
        if not genes:
            return ""
        prefix = self._prefix_max_end.get(chromosome)
        idx = bisect.bisect_right(genes, (pos, "\x7f"))

        candidates: list[tuple[int, str]] = []
        # (a)+(b): walk back while a gene could still cover/approach pos;
        # the prefix-max-end array bounds the walk: stop once the best
        # possible remaining distance exceeds the current best.
        best_dist = None
        for j in range(idx - 1, -1, -1):
            max_end_here = prefix[j]
            dist_bound = 0 if max_end_here >= pos else pos - max_end_here
            if best_dist is not None and dist_bound > best_dist:
                break
            gid = genes[j][1]
            r = self.genes[gid].region
            dist = 0 if r[0] <= pos <= r[1] else pos - r[1]
            candidates.append((dist, gid))
            if best_dist is None or dist < best_dist:
                best_dist = dist
        if idx < len(genes):
            gid = genes[idx][1]
            candidates.append((genes[idx][0] - pos, gid))
        if not candidates:
            return ""
        return min(candidates)[1]

    def calc_overlapping_genes(self, ref_name: str, region) -> list[str]:
        if not (self.is_chromosome(ref_name)
                or self.is_transcript(ref_name)):
            return []
        chromosome = self.calc_genomic_chromosome(ref_name)
        out = set()
        for gr in self.calc_genomic_regions(ref_name, region):
            bins = self._bins.get(chromosome, {})
            for b in range(gr[0] // BIN_SPACING, gr[1] // BIN_SPACING + 1):
                for gid in bins.get(b, ()):
                    r = self.genes[gid].region
                    if not (gr[1] < r[0] or gr[0] > r[1]):
                        out.add(gid)
        return sorted(out)

    def calc_gene_location(self, gene_id: str, break_pos: int) -> str:
        """cds/utr/intron/upstream/downstream (``gene_models.pm:278-346``)."""
        if gene_id == "":
            return ""
        g = self.genes[gene_id]
        r = g.region
        if (break_pos < r[0] and g.strand == "+") or \
                (break_pos > r[1] and g.strand == "-"):
            return "upstream"
        if (break_pos > r[1] and g.strand == "+") or \
                (break_pos < r[0] and g.strand == "-"):
            return "downstream"
        in_cds = in_utr5p = in_utr3p = False
        for tid in g.transcripts:
            t = self.transcripts[tid]
            for s, e in t.cds:
                if s <= break_pos <= e:
                    in_cds = True
            for s, e in t.utr5p:
                if s <= break_pos <= e:
                    in_utr5p = True
            for s, e in t.utr3p:
                if s <= break_pos <= e:
                    in_utr3p = True
        if in_cds:
            return "coding"
        if in_utr5p:
            return "utr5p"
        if in_utr3p:
            return "utr3p"
        return "intron"

    # -- coordinate maps -------------------------------------------------

    def calc_genomic_chromosome(self, ref_name: str) -> str:
        if not self.is_transcript(ref_name):
            return ref_name
        return self.transcripts[ref_name].chromosome

    def calc_genomic_position(self, ref_name: str, position: int) -> int:
        """``gene_models.pm:372-412``."""
        if not self.is_transcript(ref_name):
            return position
        t = self.transcripts[ref_name]
        if t.strand == "-":
            position = t.length - position + 1
        if position < 1:
            return t.exons[0][0] + position - 1
        local_offset = 0
        for es, ee in t.exons:
            size = ee - es + 1
            if position <= local_offset + size:
                return position - local_offset - 1 + es
            local_offset += size
        return position - local_offset + t.exons[-1][1]

    def calc_genomic_regions(self, ref_name: str, region) -> list:
        """``gene_models.pm:415-469``."""
        if not self.is_transcript(ref_name):
            return [tuple(region)]
        t = self.transcripts[ref_name]
        length = t.length
        lo, hi = region
        if t.strand == "-":
            lo, hi = length - region[1] + 1, length - region[0] + 1
        if lo < 1:
            lo = 1
        if hi > length:
            hi = length
        genomic = []
        local_offset = 0
        for es, ee in t.exons:
            size = ee - es + 1
            local_start = lo - local_offset
            local_end = hi - local_offset
            ov_start = max(1, local_start) + es - 1
            ov_end = min(size, local_end) + es - 1
            if ov_start <= ov_end:
                genomic.append((ov_start, ov_end))
            local_offset += size
        return genomic

    def calc_genomic_strand(self, ref_name: str, strand: str) -> str:
        if not self.is_transcript(ref_name):
            return strand
        return "+" if self.transcripts[ref_name].strand == strand else "-"

    def calc_transcript_position(self, transcript_id: str,
                                 position: int) -> int:
        """``gene_models.pm:536-570``: intronic positions snap to the next
        exon start."""
        t = self.transcripts[transcript_id]
        local_offset = 0
        tpos = None
        for es, ee in t.exons:
            size = ee - es + 1
            if position <= ee:
                tpos = local_offset + 1 if position < es else \
                    local_offset + position - es + 1
                break
            local_offset += size
        if tpos is None:
            tpos = t.length
        if t.strand == "-":
            tpos = t.length - tpos + 1
        return tpos

    def calc_transcript_strand(self, transcript_id: str,
                               strand: str) -> str:
        return "+" if self.transcripts[transcript_id].strand == strand \
            else "-"

    def exon_to_genome(self, exon_id: str, position: int) -> int:
        """``gene_models.pm:472-503``: exon ids are gene|transcript|n."""
        fields = exon_id.split("|")
        if len(fields) != 3:
            raise ValueError(f"{exon_id} is not an exon id")
        transcript_id = fields[0] + "|" + fields[1]
        exon_number = int(fields[2])
        t = self.transcripts[transcript_id]
        es, ee = t.exons[exon_number]
        size = ee - es + 1
        if t.strand == "-":
            position = size - position + 1
        return es + position - 1
