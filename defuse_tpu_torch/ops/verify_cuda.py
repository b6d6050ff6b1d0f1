"""Packed candidate verification on the card: the wrapper around
``csrc/verify.cu``.

Counterpart of ``defuse_tpu/ops/verify_batch.py::_verify_packed3``.
Operands as ``convert.verify_operands`` makes them: the packed plane
``ref3`` (Nw,) and reads ``reads3`` (B, ceil(L/10)) as int32 holding
30-bit words, ``word10``/``read_idx`` (C,) and ``read_lens`` (B,) int32,
``lane10`` (C,) uint8, all contiguous.  A CPU tensor goes to the plain
version ``verify_batch.verify_packed3_ref``; a CUDA tensor launches the
kernel or raises.  ``LAUNCHES`` counts kernel launches, the kernel's under
``verify_packed3`` and those of its two roofline legs
(``ops/verify_roofline.py``) under their own names.
"""

from __future__ import annotations

import ctypes

import torch

from . import verify_batch
from ._build import bind, check_operand, cuda_device

# leg -> (the C entry's code, the name its launches count under)
LEGS = {"full": (0, "verify_packed3"), "gather": (1, "verify_gather"),
        "compute": (2, "verify_compute")}
LAUNCHES = {name: 0 for _code, name in LEGS.values()}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGS = {"verify_packed3": [_P, ctypes.c_longlong, _P, _P, _P, _I, _P, _P,
                            _P, _I, _I, _P],
         "verify_group_lanes": [_I]}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def group_lanes(L: int) -> int:
    """Lanes the kernel gives a candidate of ``L`` bases: 8, 16 or 32, or 0
    where a warp walks the row (more than 31 words).  Builds the kernel."""
    return bind("verify", _SIGS).verify_group_lanes(
        verify_batch.packed_words(L))


def check_operands(ref3, word10, lane10, reads3, read_idx, read_lens, L):
    """The CUDA device of the operands; raises for what the kernel does not
    take."""
    dev = cuda_device(ref3, "verify")
    check_operand("ref3", ref3, torch.int32, 1, dev)
    check_operand("reads3", reads3, torch.int32, 2, dev)
    check_operand("lane10", lane10, torch.uint8, 1, dev)
    for name, t in (("word10", word10), ("read_idx", read_idx),
                    ("read_lens", read_lens)):
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
    if max(ref3.shape[0], reads3.numel(), C) >= 1 << 31:
        raise ValueError("the kernel indexes the plane, the reads and the "
                         "candidates with 32 bits: fewer than 2^31 each")
    if C and (ref3.shape[0] == 0 or B == 0):
        raise ValueError("candidates against an empty plane or read set")
    return dev


def verify_packed3(ref3, word10, lane10, reads3, read_idx, read_lens, L,
                   leg="full"):
    """Mismatch counts (C,) int32; see ``verify_batch.verify_packed3_ref``.
    The kernel trusts lanes in 0..9, ``read_idx`` in range and word indices
    >= 0; ``convert.verify_operands`` makes them so.

    The operands are checked once and all candidates go to the card in one
    launch that writes the returned tensor.  ``leg`` other than ``"full"``
    launches a roofline leg of the kernel
    (``ops/verify_roofline.verify_leg``).
    """
    if ref3.device.type == "cpu":
        if leg != "full":
            raise ValueError("the legs' plain versions are in verify_roofline")
        return verify_batch.verify_packed3_ref(ref3, word10, lane10, reads3,
                                               read_idx, read_lens, L)
    dev = check_operands(ref3, word10, lane10, reads3, read_idx, read_lens, L)
    code, counted = LEGS[leg]
    C = word10.shape[0]
    out = torch.empty(C, dtype=torch.int32, device=dev)
    if C == 0:
        return out
    with torch.cuda.device(dev):
        err = bind("verify", _SIGS).verify_packed3(
            ref3.data_ptr(), ref3.shape[0], word10.data_ptr(),
            lane10.data_ptr(), reads3.data_ptr(), reads3.shape[1],
            read_idx.data_ptr(), read_lens.data_ptr(), out.data_ptr(), C,
            code, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"verify_packed3 launch failed: CUDA error {err}")
    LAUNCHES[counted] += 1
    return out
