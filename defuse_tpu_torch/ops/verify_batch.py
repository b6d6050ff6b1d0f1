"""Batched candidate verification: the 3-bit packing, the plain PyTorch
mismatch count, and the ``verify_fn`` adapter for ``SeedIndex.verify``.

Counterpart of ``defuse_tpu/ops/verify_batch.py``.  The aligner's verify
step counts, for every candidate end-to-end placement of a read, the
mismatching bases of the reference window (no gaps).  The reference plane
and the reads are packed 10 bases of 3 bits to a word (N = 4 fits, so
N == N compares equal), and a candidate start is split into
(word10, lane10) = (start // 10, start % 10), int32 and uint8.
``verify_packed3_ref`` is
the plain version of the CUDA kernel in ``csrc/verify.cu``
(``ops/verify_cuda.py``); the CPU tests run it, and ``chip_smoke.py``
holds the kernel against it on the card.

Each call of the verifier is routed as ``defuse_tpu``'s is: by
``verify_cost_model`` (round trips and upload over the card's link, lanes
over the kernel's rate, against candidates over the numpy oracle's rate)
with the rates measured on the card, not the JAX module's v5e figures.
"""

from __future__ import annotations

import os

import numpy as np
import torch

# Rates of one verifier call (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py
# phase 14, over the 16 calls the frontend makes on the bench dataset, 15 to
# 55,537 candidates of 50 bp against 50,052 or 92,800 reads): candidate-lanes
# (candidates x read length) a second of the device route beyond its link
# terms (``convert.verify_operands``, which packs every read of the call,
# the kernel, the counts' copy back), and candidates a second of the numpy
# oracle on one host core.  The device route's time there follows the reads
# packed (0.45-0.54 us a read), not the lanes, so this rate holds near the
# frontend's ratio of candidates to reads.
DEVICE_LANES_S = 24.09e6
HOST_CANDIDATES_S = 1.726e6

BASES_PER_WORD = 10
GROUP_LOW_BITS = 0x09249249  # bit 0 of each 3-bit base slot
WORD_MASK = 0x3FFFFFFF       # the low 30 bits a packed word uses


def pack_codes3(codes: np.ndarray) -> np.ndarray:
    """Pack codes (0..4, N = 4) into a 3-bit-per-base uint32 plane: 10
    bases per word in bits 0..29 (zero-padded tail)."""
    n = len(codes)
    n10 = (n + BASES_PER_WORD - 1) // BASES_PER_WORD * BASES_PER_WORD
    p = np.zeros(n10, np.uint32)
    p[:n] = codes.astype(np.uint32)
    p = p.reshape(-1, BASES_PER_WORD)
    packed = np.zeros(len(p), np.uint32)
    for j in range(BASES_PER_WORD):
        packed |= p[:, j] << np.uint32(3 * j)
    return packed


def pack_rows3(codes: np.ndarray) -> np.ndarray:
    """Row-wise 3-bit packing of a (B, L) code matrix into (B, ceil(L/10))
    uint32 (positions >= L packed as 0)."""
    b, length = codes.shape
    w = (length + BASES_PER_WORD - 1) // BASES_PER_WORD
    p = np.zeros((b, w * BASES_PER_WORD), np.uint32)
    p[:, :length] = codes.astype(np.uint32)
    p = p.reshape(b, w, BASES_PER_WORD)
    packed = np.zeros((b, w), np.uint32)
    for j in range(BASES_PER_WORD):
        packed |= p[:, :, j] << np.uint32(3 * j)
    return packed


def packed_words(L: int) -> int:
    """Words per packed row of L bases."""
    return (L + BASES_PER_WORD - 1) // BASES_PER_WORD


def verify_packed3_ref(ref3, word10, lane10, reads3, read_idx, read_lens, L):
    """Mismatch counts (C,) int32 of candidate placements, as
    ``defuse_tpu``'s ``_verify_packed3`` computes them.

    ref3 (Nw,) packed plane, reads3 (B, ceil(L/10)) packed reads, both
    int32 or int64 holding 30-bit words; word10, lane10, read_idx (C,) and
    read_lens (B,) integers.  The words are widened to int64, where torch's
    shifts and ANDs are exact (its uint32 support is partial).  Torch has
    no popcount: the count sums the 10 group bits of each masked word.
    """
    w = packed_words(L)
    if reads3.shape[1] != w:
        raise ValueError(f"reads3: expected {w} words per row for L={L}, "
                         f"got {reads3.shape[1]}")
    dev = ref3.device
    ref3 = ref3.to(torch.int64)
    k = torch.arange(w + 1, dtype=torch.int64, device=dev)[None, :]
    idx = torch.clamp(word10.to(torch.int64)[:, None] + k,
                      max=ref3.shape[0] - 1)
    g = ref3[idx]                                        # (C, W+1)
    sh = 3 * lane10.to(torch.int64)[:, None]             # 0..27
    lo = g[:, :-1] >> sh
    hi = (g[:, 1:] << (30 - sh)) & WORD_MASK
    win = (lo | hi) & WORD_MASK                          # (C, W)
    ridx = read_idx.to(torch.int64)
    x = win ^ reads3.to(torch.int64)[ridx]
    t = (x | (x >> 1) | (x >> 2)) & GROUP_LOW_BITS
    # word k holds bases [10k, 10k+10): keep the low 3v bits, v valid bases
    lens = read_lens.to(torch.int64)[ridx][:, None]
    v = torch.clamp(lens - BASES_PER_WORD * k[:, :-1], 0, BASES_PER_WORD)
    masked = t & ((1 << (3 * v)) - 1)
    slots = 3 * torch.arange(BASES_PER_WORD, dtype=torch.int64, device=dev)
    bits = (masked[:, :, None] >> slots) & 1
    return bits.sum(dim=(1, 2)).to(torch.int32)


def verify_cost_model(n_candidates: int, n_reads: int, L: int,
                      link: dict | None = None) -> tuple[float, float]:
    """(t_device, t_host) estimates for one verify call, in seconds: two
    round trips, the packed reads (0.4 B a base) and the candidates (8 B
    each) over the link, and the candidate-lanes at ``DEVICE_LANES_S``,
    against the candidates at ``HOST_CANDIDATES_S``.  ``link`` defaults to
    ``core.devices.link_profile()``."""
    if link is None:
        from ..core.devices import link_profile
        link = link_profile()
    bw = link["bw_MBps"] * 1e6
    rtt = link["rtt_ms"] / 1e3
    up_bytes = 0.4 * n_reads * L + 8 * n_candidates
    t_dev = 2 * rtt + up_bytes / bw + n_candidates * L / DEVICE_LANES_S
    t_host = n_candidates / HOST_CANDIDATES_S
    return t_dev, t_host


def host_counts(codes, cand_pos, reads_codes, read_idx, read_lens):
    """Mismatch counts of the candidate placements by the numpy oracle
    (``SeedIndex.verify``'s own), the verifier's host route."""
    L = reads_codes.shape[1]
    gather_idx = np.clip(
        cand_pos[:, None] + np.arange(L)[None, :], 0,
        len(codes) - 1)
    windows = codes[gather_idx]
    lens = read_lens[read_idx]
    diff = (windows != reads_codes[read_idx]) \
        & (np.arange(L)[None, :] < lens[:, None])
    return diff.sum(axis=1)


class DeviceVerifier:
    """``verify_fn`` adapter for ``SeedIndex.verify`` on ``device``.

    Each call is routed as ``defuse_tpu``'s verifier routes it:
    ``DEFUSE_DEVICE_VERIFY=force`` verifies on ``device``, ``off`` on the
    host, and ``auto`` (the default) where ``verify_cost_model`` with
    ``link_profile()`` puts the lower estimate.  ``calls_device`` and
    ``calls_host`` count the calls each route took.

    The device route keeps each reference's packed plane resident, keyed
    by the identity of the host code array (held beside it, so a collected
    array's reused address cannot alias), packs the reads once per call,
    and verifies all candidates of a call in one launch: the kernel keeps
    nothing per candidate but its operands and its count.  A CUDA device
    launches the kernel of ``csrc/verify.cu``; ``device="cpu"`` runs the
    plain version.  Returns the mismatch counts as int64 numpy.
    """

    def __init__(self, device):
        self.device = torch.device(device)
        self._resident: dict[int, tuple] = {}
        self.calls_device = 0
        self.calls_host = 0

    def _plane(self, codes):
        from ..convert import verify_plane  # convert imports this module
        entry = self._resident.get(id(codes))
        if entry is None or entry[0] is not codes:
            entry = (codes, verify_plane(codes, self.device))
            self._resident[id(codes)] = entry
        return entry[1]

    def __call__(self, codes, cand_pos, reads_codes, read_idx, read_lens):
        mode = os.environ.get("DEFUSE_DEVICE_VERIFY", "auto")
        if mode != "force":
            t_dev, t_host = verify_cost_model(
                len(cand_pos), reads_codes.shape[0], reads_codes.shape[1])
            if mode == "off" or t_dev >= t_host:
                self.calls_host += 1
                return host_counts(codes, cand_pos, reads_codes, read_idx,
                                   read_lens)
        from ..convert import verify_operands
        from .verify_cuda import verify_packed3  # it imports this module
        self.calls_device += 1
        ops = verify_operands(codes, cand_pos, reads_codes, read_idx,
                              read_lens, self.device, ref3=self._plane(codes))
        out = verify_packed3(*ops, reads_codes.shape[1])
        return out.cpu().numpy().astype(np.int64)
