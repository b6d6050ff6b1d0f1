"""Extra annotations: breakpoint-concordant counts and interrupted-index
inputs — ``scripts/calc_break_concordant.pl`` /
``scripts/calc_interrupted.pl`` equivalents.

Both consume the concordant cdna pair alignments; the reference shells
out to ``samtools view`` over a sorted BAM — here the SAM rows are
indexed in memory by reference name.  Quirks preserved: the gene
location screen uses the raw (possibly transcript-space) break position,
and the interrupted sizes are swapped once by gene strand and the
output pair again by fusion strand.
"""

from __future__ import annotations

from .gene_models import GeneModels


def index_sam_by_ref(sam_lines):
    """rname -> [(qname, strand, start, end)] from SAM text rows."""
    by_ref: dict[str, list] = {}
    for line in sam_lines:
        if line.startswith("@"):
            continue
        f = line.rstrip("\n").split("\t")
        strand = "-" if int(f[1]) & 0x10 else "+"
        start = int(f[3])
        end = start + len(f[9]) - 1
        by_ref.setdefault(f[2], []).append((f[0], strand, start, end))
    return by_ref


def index_tbl_by_ref(tbl_path):
    """``index_sam_by_ref`` equivalent fed from the binary pair table —
    identical output to parsing the (lazy) pair SAM: records are in
    fragment order, each contributing its end-1 then end-2 row, with
    strands from the table's packed end-1 strand bit (proper pairs are
    always opposite-strand).  Pinned against the SAM indexer by
    tests/test_pair_tbl_lazy.py.

    A LIST of per-rank part tables indexes each part in rank order —
    identical to indexing the concatenated table, since parts carry
    globalized fragment ids and concatenate in rank order."""
    if isinstance(tbl_path, (list, tuple)):
        by_ref: dict[str, list] = {}
        for part in tbl_path:
            for ref, rows in index_tbl_by_ref(part).items():
                by_ref.setdefault(ref, []).extend(rows)
        return by_ref
    from ..parallel.shard import pair_table_has_strand, \
        read_pair_table, unpack_seq_strand
    if not pair_table_has_strand(tbl_path):
        raise ValueError(
            f"{tbl_path} is a v1 pair table (no strand bit); index "
            "from the pair SAM instead")
    names, recs = read_pair_table(tbl_path)
    seq_id, strand1 = unpack_seq_strand(recs)
    by_ref: dict[str, list] = {}
    cols = zip(recs["frag"].tolist(), seq_id.tolist(),
               strand1.tolist(), recs["pos1"].tolist(),
               recs["len1"].tolist(), recs["pos2"].tolist(),
               recs["len2"].tolist())
    for frag, sid, s1, pos1, len1, pos2, len2 in cols:
        rows = by_ref.setdefault(names[sid], [])
        qname = str(frag)
        rows.append((qname, "-" if s1 else "+", pos1,
                     pos1 + len1 - 1))
        rows.append((qname, "+" if s1 else "-", pos2,
                     pos2 + len2 - 1))
    return by_ref


def _breakpos_genomic(gene_models, reference, strand, breakpos,
                      splice_bias):
    if strand == "+":
        return gene_models.calc_genomic_position(
            reference, breakpos - splice_bias) + splice_bias
    return gene_models.calc_genomic_position(
        reference, breakpos + splice_bias) - splice_bias


def break_concordant(breaks, gene_models: GeneModels, sam_by_ref,
                     max_fragment_length: int, splice_bias: int):
    """{(cluster_id, end): concordant_count}
    (``calc_break_concordant.pl:102-189``)."""
    out: dict[tuple[int, int], int] = {}
    for cid in sorted(breaks):
        for cend in (0, 1):
            reference, strand, breakpos = breaks[cid][cend]
            gene_id = gene_models.calc_gene(reference, breakpos)
            loc = gene_models.calc_gene_location(gene_id, breakpos)
            if loc in ("upstream", "downstream"):
                continue
            bp_genomic = _breakpos_genomic(gene_models, reference, strand,
                                           breakpos, splice_bias)
            count = 0
            for tid in sorted(gene_models.genes[gene_id].transcripts):
                bp_t = gene_models.calc_transcript_position(tid, bp_genomic)
                q_start = max(1, bp_t - max_fragment_length)
                q_end = bp_t + max_fragment_length
                qname_align: dict[str, dict[str, tuple[int, int]]] = {}
                for (qname, astrand, start, end) in sam_by_ref.get(tid,
                                                                   ()):
                    if start <= q_end and end >= q_start:
                        qname_align.setdefault(qname, {})[astrand] = \
                            (start, end)
                for qname, ends in qname_align.items():
                    if "+" in ends and "-" in ends and \
                            ends["+"][0] < bp_t and ends["-"][1] > bp_t:
                        count += 1
            out[(cid, cend)] = count
    return out


def _merge_regions(regions):
    regions = sorted(regions)
    merged = []
    cs, ce = regions[0]
    for s, e in regions:
        if s > ce + 1:
            merged.append((cs, ce))
            cs, ce = s, e
        else:
            ce = max(ce, e)
    merged.append((cs, ce))
    return merged


def interrupted(breaks, gene_models: GeneModels, sam_by_ref,
                splice_bias: int):
    """{(cluster_id, end): (gene, size_before, size_after, count_before,
    count_after)} (``calc_interrupted.pl``)."""
    fusion_pos: dict[str, dict[tuple[int, int], int]] = {}
    sizes: dict[tuple[int, int], tuple[int, int]] = {}
    genes: dict[tuple[int, int], str] = {}
    strands: dict[tuple[int, int], str] = {}
    for cid in sorted(breaks):
        for cend in (0, 1):
            reference, strand, breakpos = breaks[cid][cend]
            gene_id = gene_models.calc_gene(reference, breakpos)
            loc = gene_models.calc_gene_location(gene_id, breakpos)
            if loc in ("upstream", "downstream") or gene_id == "":
                continue
            bp_genomic = _breakpos_genomic(gene_models, reference, strand,
                                           breakpos, splice_bias)
            before, after = [], []
            for tid in sorted(gene_models.genes[gene_id].transcripts):
                bp_t = gene_models.calc_transcript_position(tid, bp_genomic)
                fusion_pos.setdefault(tid, {})[(cid, cend)] = bp_t
                for (es, ee) in gene_models.transcripts[tid].exons:
                    if ee < bp_genomic:
                        before.append((es, ee))
                    elif es > bp_genomic:
                        after.append((es, ee))
                    else:
                        before.append((es, bp_genomic))
                        after.append((bp_genomic, ee))
            size_before = sum(e - s + 1 for s, e in
                              _merge_regions(before)) if before else 0
            size_after = sum(e - s + 1 for s, e in
                             _merge_regions(after)) if after else 0
            if gene_models.genes[gene_id].strand == "-":
                size_before, size_after = size_after, size_before
            sizes[(cid, cend)] = (size_before, size_after)
            genes[(cid, cend)] = gene_id
            # the output-time swap keys on the GENE strand (the break
            # strand only biases the genomic breakpos),
            # calc_interrupted.pl:94,221
            strands[(cid, cend)] = gene_models.genes[gene_id].strand

    counts_before: dict[tuple[int, int], int] = {}
    counts_after: dict[tuple[int, int], int] = {}
    for tid in sorted(fusion_pos):
        for (_qname, _strand, start, end) in sam_by_ref.get(tid, ()):
            seq_len = end - start + 1
            for key, bp_t in fusion_pos[tid].items():
                if end < bp_t:
                    counts_before[key] = counts_before.get(key, 0) + seq_len
                elif start > bp_t:
                    counts_after[key] = counts_after.get(key, 0) + seq_len
                else:
                    counts_before[key] = counts_before.get(key, 0) \
                        + bp_t - start
                    counts_after[key] = counts_after.get(key, 0) \
                        + end - bp_t

    out: dict[tuple[int, int], tuple] = {}
    for key, gene_id in genes.items():
        cb = counts_before.get(key, 0)
        ca = counts_after.get(key, 0)
        sb, sa = sizes[key]
        if strands[key] == "-":
            cb, ca = ca, cb
            sb, sa = sa, sb
        out[key] = (gene_id, sb, sa, cb, ca)
    return out


def splicing_index(break_concordant_counts, span_counts):
    """splicing_indexN = concordant spanning count / span count
    (``annotate_fusions.pl:462-480``)."""
    out = {}
    for (cid, cend), count in break_concordant_counts.items():
        if cid in span_counts and span_counts[cid] > 0:
            out[(cid, cend)] = count / span_counts[cid]
    return out


def interrupted_index(interrupted_info):
    """interrupted_indexN (``annotate_fusions.pl:485-501``)."""
    out = {}
    for (cid, cend), (_gene, sb, sa, cb, ca) in interrupted_info.items():
        before = cb / (sb + 1) + 1
        after = ca / (sa + 1) + 1
        out[(cid, cend)] = before / after
    return out
