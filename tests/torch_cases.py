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
