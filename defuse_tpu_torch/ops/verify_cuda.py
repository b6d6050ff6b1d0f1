"""Packed candidate verification on the card: the wrapper around
``csrc/verify.cu``.

Counterpart of ``defuse_tpu/ops/verify_batch.py::_verify_packed3``.
Operands as ``convert.verify_operands`` makes them: the packed plane
``ref3`` (Nw,) and reads ``reads3`` (B, ceil(L/10)) as int32 holding
30-bit words, ``word10``/``lane10``/``read_idx`` (C,) and ``read_lens``
(B,) int32, all contiguous.  A CPU tensor goes to the plain version
``verify_batch.verify_packed3_ref``; a CUDA tensor launches the kernel or
raises.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import verify_batch
from ._build import bind, check_operand, cuda_device

LAUNCHES = {"verify_packed3": 0}

# The least integer operations a window word of 10 bases costs, for the
# kernel's bound: the two shifts and the OR that cut the window out of two
# plane words, the mask, the XOR with the read word, the two shifts and two
# ORs that fold each 3-bit group, the population count and the add.
OPS_PER_WORD = 11

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGS = {"verify_packed3": [_P, ctypes.c_longlong, _P, _P, _P, _I, _P, _P,
                            _P, _I, _P]}


def reset_launches() -> None:
    LAUNCHES["verify_packed3"] = 0


def verify_packed3(ref3, word10, lane10, reads3, read_idx, read_lens, L):
    """Mismatch counts (C,) int32; see ``verify_batch.verify_packed3_ref``.
    The kernel trusts lanes in 0..9, ``read_idx`` in range and word indices
    >= 0; ``convert.verify_operands`` makes them so."""
    if ref3.device.type == "cpu":
        return verify_batch.verify_packed3_ref(ref3, word10, lane10, reads3,
                                               read_idx, read_lens, L)
    dev = cuda_device(ref3, "verify")
    check_operand("ref3", ref3, torch.int32, 1, dev)
    check_operand("reads3", reads3, torch.int32, 2, dev)
    for name, t in (("word10", word10), ("lane10", lane10),
                    ("read_idx", read_idx), ("read_lens", read_lens)):
        check_operand(name, t, torch.int32, 1, dev)
    C = word10.shape[0]
    B, W = reads3.shape
    if W != verify_batch.packed_words(L):
        raise ValueError(f"reads3: expected {verify_batch.packed_words(L)} "
                         f"words per row for L={L}, got {W}")
    if lane10.shape[0] != C or read_idx.shape[0] != C:
        raise ValueError("candidate vectors differ in length")
    if read_lens.shape[0] != B:
        raise ValueError(f"read_lens: expected ({B},), got "
                         f"{tuple(read_lens.shape)}")
    if C and (ref3.shape[0] == 0 or B == 0):
        raise ValueError("candidates against an empty plane or read set")
    out = torch.empty(C, dtype=torch.int32, device=dev)
    if C:
        with torch.cuda.device(dev):
            fn = bind("verify", _SIGS).verify_packed3
            err = fn(ref3.data_ptr(), ref3.shape[0], word10.data_ptr(),
                     lane10.data_ptr(), reads3.data_ptr(), W,
                     read_idx.data_ptr(), read_lens.data_ptr(),
                     out.data_ptr(), C,
                     torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"verify_packed3 launch failed: CUDA error "
                               f"{err}")
        LAUNCHES["verify_packed3"] += 1
    return out
