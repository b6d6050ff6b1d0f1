"""The packed verify's roofline: its bound and its gather/compute split.

Counterpart of ``scripts_dev/verify_roofline_probe.py``.  The kernel of
``csrc/verify.cu`` uses two resources: the memory system, for the two
gathers a candidate needs (its window of the packed plane, its read's
row), and integer issue, for the shifts, the fold and the count.  Two
variants of the kernel, built from the same source behind a template flag,
each keep one of them:

* ``gather``: only the two gathers, summed with ``lane10`` into a checksum
  per candidate so that no load is dropped;
* ``compute``: all of the arithmetic, on plane words 0..W and read row 0
  (loads that stay in L1), with ``word10`` added so the operand stays live;
* ``full``: the kernel itself.

Each is timed as a marginal over two candidate counts (``legs_ms``).
``full`` near ``max(gather, compute)`` says the legs overlap, and the
larger leg names what bounds the kernel.  ``gather_leg_ref`` and
``compute_leg_ref`` are the legs' plain versions; ``verify_leg`` takes them
for CPU tensors and launches the kernel's variant for CUDA tensors.

The bound (``verify_work``, ``verify_ops_ms``) is the larger of the least
bytes over the card's memory rate and the least operations at the issue
probe's measured ``alu`` rate.
"""

from __future__ import annotations

import torch

from . import verify_batch, verify_cuda
from .verify_batch import verify_packed3_ref

# The least integer operations a window word of 10 bases costs: the two
# shifts and the OR that cut the window out of two plane words, the mask,
# the XOR with the read word, the two shifts and two ORs that fold each
# 3-bit group, the population count and the add.
OPS_PER_WORD = 11
SECTOR = 32   # bytes the card's memory moves at the least
WARP = 32


def _wrap32(x):
    """int64 values as the int32 they are modulo 2^32."""
    return ((x + (1 << 31)) % (1 << 32) - (1 << 31)).to(torch.int32)


def gather_leg_ref(ref3, word10, lane10, reads3, read_idx, read_lens, L):
    """The gather leg's checksums (C,) int32: per candidate the sum of its
    W + 1 plane words (clamped to the last word), its read's W words and
    its ``lane10``, modulo 2^32."""
    w = verify_batch.packed_words(L)
    k = torch.arange(w + 1, dtype=torch.int64, device=ref3.device)[None, :]
    idx = torch.clamp(word10.to(torch.int64)[:, None] + k,
                      max=ref3.shape[0] - 1)
    g = ref3.to(torch.int64)[idx].sum(dim=1)
    rw = reads3.to(torch.int64)[read_idx.to(torch.int64)].sum(dim=1)
    return _wrap32(g + rw + lane10.to(torch.int64))


def compute_leg_ref(ref3, word10, lane10, reads3, read_idx, read_lens, L):
    """The compute leg's checksums (C,) int32: per candidate the mismatch
    count of read 0 against the plane's first window at the candidate's
    ``lane10``, plus its ``word10``, modulo 2^32."""
    counts = verify_packed3_ref(ref3, torch.zeros_like(word10), lane10,
                                reads3, torch.zeros_like(read_idx),
                                read_lens, L)
    return _wrap32(counts.to(torch.int64) + word10.to(torch.int64))


_LEG_REFS = {"full": verify_packed3_ref, "gather": gather_leg_ref,
             "compute": compute_leg_ref}


def verify_leg(leg, ref3, word10, lane10, reads3, read_idx, read_lens, L):
    """(C,) int32 of one leg (``full``, ``gather`` or ``compute``): the
    plain version for CPU tensors, the kernel's variant on the card."""
    ops = (ref3, word10, lane10, reads3, read_idx, read_lens)
    if ref3.device.type == "cpu":
        return _LEG_REFS[leg](*ops, L)
    return verify_cuda.verify_packed3(*ops, L, leg=leg)


def verify_work(ref3, word10, lane10, reads3, read_idx, read_lens):
    """What a call must move and do at the least, counted from its
    operands.

    ``bytes``: every input read once and the output written once: the plane
    words the windows cover (4 * (W + 1) a candidate, and no more than the
    plane), the packed reads, the read lengths, the candidate vectors, and
    4 B of count a candidate.  ``words``: window words, ``OPS_PER_WORD``
    operations each.  ``sector_bytes``, a diagnostic and not the bound: the
    same with each candidate's two gathers counted in the 32 B sectors they
    touch and neither capped by its array's size, which is what the
    gathers move when no cache helps.
    """
    C = word10.shape[0]
    n_words = ref3.shape[0]
    B, W = reads3.shape
    vectors = sum(t.numel() * t.element_size()
                  for t in (word10, lane10, read_idx, read_lens)) + 4 * C
    plane = min(4 * n_words, 4 * (W + 1) * C)
    reads = 4 * B * W
    w0 = word10.to(torch.int64).clamp(max=max(n_words - 1, 0))
    w1 = (w0 + W).clamp(max=max(n_words - 1, 0))
    per_word = SECTOR // 4
    sectors = int((w1 // per_word - w0 // per_word + 1).sum())
    if W:
        row = read_idx.to(torch.int64) * W
        sectors += int(((row + W - 1) // per_word - row // per_word + 1)
                       .sum())
    return {"candidates": C, "words": C * W,
            "bytes": plane + reads + vectors,
            "sector_bytes": SECTOR * sectors + vectors}


def verify_ops_ms(words: int, alu_ns_per_warp_instr: float) -> float:
    """Milliseconds the card needs for ``words`` window words at the least:
    ``OPS_PER_WORD`` integer operations each, 32 to a warp instruction, at
    the probe's card-wide ``alu`` cost of a warp instruction."""
    return words * OPS_PER_WORD / WARP * alu_ns_per_warp_instr / 1e6


def legs_ms(ops, L, counts, reps=20, rounds=3):
    """Each leg's time on the card at the two candidate counts ``counts``
    (the first candidates of ``ops``), and its marginal ns a candidate:
    ``{leg: {"ms": [small, big], "marginal_ns": x}}``.  Timed from a CUDA
    graph of ``reps`` launches, the least of ``rounds``."""
    from ..utils.profiling import cuda_time_ms
    ref3, word10, lane10, reads3, read_idx, read_lens = ops
    small, big = counts
    out = {}
    for leg in verify_cuda.LEGS:
        ms = [cuda_time_ms(
            lambda c=c: verify_leg(leg, ref3, word10[:c], lane10[:c], reads3,
                                   read_idx[:c], read_lens, L),
            reps, graph=True, rounds=rounds) for c in counts]
        out[leg] = {"ms": ms,
                    "marginal_ns": (ms[1] - ms[0]) * 1e6 / (big - small)}
    return out
