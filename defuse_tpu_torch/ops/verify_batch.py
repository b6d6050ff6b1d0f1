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

Not carried over from the JAX module: its TPU-era cost model
(``verify_cost_model``, the link profile and the v5e lane rate).  When
the port's verifier is engaged it verifies on its device; the caller
passes no verifier at all for ``DEFUSE_DEVICE_VERIFY=off``.
"""

from __future__ import annotations

import numpy as np
import torch

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


class DeviceVerifier:
    """``verify_fn`` adapter for ``SeedIndex.verify`` on ``device``.

    Keeps each reference's packed plane resident on the device, keyed by
    the identity of the host code array (held beside it, so a collected
    array's reused address cannot alias), packs the reads once per call,
    and verifies all candidates of a call in one launch: the kernel keeps
    nothing per candidate but its operands and its count.
    Returns the mismatch counts as int64 numpy.  A CUDA device launches the
    kernel of ``csrc/verify.cu``; ``device="cpu"`` runs the plain version.
    """

    def __init__(self, device):
        self.device = torch.device(device)
        self._resident: dict[int, tuple] = {}

    def _plane(self, codes):
        from ..convert import verify_plane  # convert imports this module
        entry = self._resident.get(id(codes))
        if entry is None or entry[0] is not codes:
            entry = (codes, verify_plane(codes, self.device))
            self._resident[id(codes)] = entry
        return entry[1]

    def __call__(self, codes, cand_pos, reads_codes, read_idx, read_lens):
        from ..convert import verify_operands
        from .verify_cuda import verify_packed3  # it imports this module
        ops = verify_operands(codes, cand_pos, reads_codes, read_idx,
                              read_lens, self.device, ref3=self._plane(codes))
        out = verify_packed3(*ops, reads_codes.shape[1])
        return out.cpu().numpy().astype(np.int64)
