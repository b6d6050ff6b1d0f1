"""Seeded inputs shared by the port's split-DP tests (numpy only, so
the CUDA tests can run where ``jax`` is not installed)."""

import random

import numpy as np
import torch

from defuse_tpu.align.split_dp import accept_threshold
from defuse_tpu_torch.ops.split_dp_batch import pad_batch

SWEEP = ((60, 24), (90, 24), (100, 24), (130, 64), (128, 64), (257, 64),
         (384, 64))


def tensors(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def rand_seq(rng, n):
    return "".join(rng.choice("ACGT") for _ in range(n))


def sweep_inputs(R, L, seed=7, B=16):
    """Random codes at (R, L) with zero-length flanks and reads included."""
    rng = np.random.default_rng(seed + R * 1000 + L)
    refs = rng.integers(1, 5, (B, R)).astype(np.uint8)
    rl = rng.integers(0, R + 1, B).astype(np.int32)
    reads = rng.integers(1, 5, (B, L)).astype(np.uint8)
    ql = rng.integers(0, L + 1, B).astype(np.int32)
    rl[0], ql[1], rl[2], ql[2] = 0, 0, R, L
    for b in range(3, B, 2):  # exact substrings so rows clear the anchor
        n = min(rl[b], ql[b])
        s = rng.integers(0, rl[b] - n + 1)
        reads[b, :n] = refs[b, s:s + n]
    return refs, rl, reads, ql


def verify_case(seed=7, n_ref=5003, L=53, B=64, C=4096):
    """Packed-verify inputs (codes, starts, reads, read_idx, read_lens):
    codes 0..4 with N (4) runs on both sides of candidates, every lane,
    candidates in the plane's last words (their windows run past the
    reference, as out-of-bounds ones do before the caller drops them),
    read lengths 0, 1, 9, 10, 11 and L, an all-N read, repeated reads."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 5, n_ref).astype(np.int8)
    codes[100:140] = 4
    reads = rng.integers(0, 5, (B, L)).astype(np.int8)
    lens = rng.integers(0, L + 1, B).astype(np.int32)
    lens[:6] = (0, 1, 9, 10, 11, L)
    reads[6, :] = 4
    starts = rng.integers(0, n_ref, C).astype(np.int64)
    starts[:10] = np.arange(10)                    # every lane
    starts[10:20] = n_ref - 1 - np.arange(10)      # the last word(s)
    starts[20:30] = 100 + np.arange(10)            # N on both sides
    ridx = rng.integers(0, B, C).astype(np.int32)
    ridx[:64] = np.arange(64) % 8                  # repeats
    ridx[20:30] = 6
    return codes, starts, reads, ridx, lens


def frontend_config(ds, tmp, **overrides):
    """A ``Config`` naming the references of the synthetic dataset ``ds``,
    written under ``tmp``: its genome, its gene models and its transcripts
    (each with a 50 A tail, as the frontend tests build them).  The pair
    SAM is written on every route, so runs can compare it."""
    from defuse_tpu.config import Config
    from defuse_tpu.io.fasta import write_fasta
    from synthdata import write_genome_fasta, write_gtf
    tmp.mkdir(parents=True, exist_ok=True)
    write_gtf(ds, tmp / "genes.gtf")
    write_genome_fasta(ds, tmp / "genome.fa")
    write_fasta(str(tmp / "cdna.fa"),
                {f"{g.name}|{g.transcript}": g.cdna(ds.genome) + "A" * 50
                 for g in ds.genes})
    values = dict(gene_models=tmp / "genes.gtf",
                  genome_fasta=tmp / "genome.fa", cdna_fasta=tmp / "cdna.fa",
                  pair_sam_checkpoint="eager")
    return Config.defaults(**(values | overrides))


def screen_case():
    """The candidate set of test_split_dp_pallas's screen test."""
    rng = random.Random(3)
    uref1, uref2 = [], []
    for _ in range(5):
        uref1.append(rand_seq(rng, rng.randint(40, 90)))
        uref2.append(rand_seq(rng, rng.randint(40, 90)))
    reads, idx = [], []
    for i in range(40):
        k = rng.randrange(5)
        idx.append(k)
        if i % 3 == 0:
            half = rng.randrange(8, 16)
            r = uref1[k][-half:] + uref2[k][:24 - half]
        else:
            r = rand_seq(rng, 24)
        reads.append(r)
    u1p, u1l = pad_batch(uref1, 128)
    u2p, u2l = pad_batch([s[::-1] for s in uref2], 128)
    rp, rl = pad_batch(reads, 24)
    mins = np.array([accept_threshold(len(r)) for r in reads],
                    dtype=np.int32)
    return u1p, u1l, u2p, u2l, np.array(idx, np.int32), rp, rl, mins
