"""Batched mate-pair EM on the card: the wrapper around ``csrc/em.cu``.

Counterpart of the XLA program ``defuse_tpu/cluster/matepair_em_batch.py::
em_run`` (a ``lax.while_loop`` in one ``jit``).  ``em_rows`` runs every
(instance, K) row of a batch to convergence, failure or ``max_iters`` in
one launch of ``em_rows_kernel`` (a block a row, the loop on the card),
updating the carry in place.  ``cluster/matepair_em_batch.py``'s
``em_run`` calls it for CUDA tensors; CPU tensors never reach it (they run
the plain loop there).  A CUDA tensor launches the kernel or raises; a
failed build raises with ``nvcc``'s stderr.  ``LAUNCHES`` counts the
launches.  ``m_step_check`` is for the checks only: both forms of the
kernel's M-step (the sequential walk and the warp form the kernel runs) on
the same responsibilities, which must agree bit for bit; it is not
counted.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

LAUNCHES = {"em_rows_kernel": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_ROWS = [_P] * 14 + [_I] * 5 + [_D] * 3 + [_P]
_CHECK = [_P] * 10 + [_I] * 3 + [_D] * 2 + [_P]
_SIGS = {"em_rows_f64": _ROWS, "em_rows_f32": _ROWS,
         "em_m_step_check_f64": _CHECK, "em_m_step_check_f32": _CHECK,
         "em_scratch_row_bytes": [_I, _I, _I,
                                  ctypes.POINTER(ctypes.c_longlong)]}
_ENTRY = {torch.float64: "em_rows_f64", torch.float32: "em_rows_f32"}
_CHECK_ENTRY = {torch.float64: "em_m_step_check_f64",
                torch.float32: "em_m_step_check_f32"}


def reset_launches() -> None:
    LAUNCHES["em_rows_kernel"] = 0


def _lib() -> ctypes.CDLL:
    return _build.bind("em", _SIGS)


def _checked(x, y, u, n, k, r, a, b, ll=None):
    """The operands' device, type and (B, KM, N), or raise."""
    dev = _build.cuda_device(x, "EM")
    dtype = x.dtype
    if dtype not in _ENTRY:
        raise TypeError(f"EM kernel takes float64 or float32, got {dtype}")
    B, N = x.shape
    KM = r.shape[1]
    for name, t in (("x", x), ("y", y), ("u", u)):
        _build.check_operand(name, t, dtype, 2, dev)
    for name, t in (("n", n), ("k", k)):
        _build.check_operand(name, t, torch.int32, 1, dev)
    _build.check_operand("r", r, dtype, 3, dev)
    for name, t in (("a", a), ("b", b)):
        _build.check_operand(name, t, dtype, 2, dev)
    if ll is not None:
        _build.check_operand("ll", ll, dtype, 1, dev)
    if tuple(y.shape) != (B, N) or tuple(u.shape) != (B, N) \
            or tuple(r.shape) != (B, KM, N) or tuple(a.shape) != (B, KM) \
            or tuple(b.shape) != (B, KM) or n.shape[0] != B \
            or k.shape[0] != B or (ll is not None and ll.shape[0] != B):
        raise ValueError("EM operands differ in shape")
    if B and bool(((n < 0) | (n > N) | (k < 0) | (k > KM)).any()):
        raise ValueError(f"EM rows: n must lie in [0, {N}] and k in "
                         f"[0, {KM}]")
    return dev, dtype, B, KM, N


def _scratch(lib, B, KM, N, dtype, dev):
    """The device scratch a launch of B rows needs (None: none)."""
    row = ctypes.c_longlong()
    err = lib.em_scratch_row_bytes(KM, N, int(dtype == torch.float64),
                                   ctypes.byref(row))
    if err != 0:
        raise RuntimeError(f"em_scratch_row_bytes: CUDA error {err}")
    if not row.value:
        return None
    return torch.empty(B * row.value, dtype=torch.uint8, device=dev)


def em_rows(x, y, u, n, k, r, a, b, ll, *, max_iters: int, never: int,
            sigma: float, lam: float, tol: float):
    """Run the batched EM in one launch.

    x, y, u (B, N) float64 or float32; n, k (B,) int32 (each row's points
    and components, n <= N, k <= KM); the carry, updated in place: r (B, KM,
    N) responsibilities (components past k zero), a, b (B, KM) breakpoints,
    ll (B,) last log-likelihoods (-BIG for a fresh row).  ``never`` is the
    ``it_done`` of a row that does not finish.  Returns (w (B, KM), done,
    failed (B,) bool, it_done (B,) int32).
    """
    dev, dtype, B, KM, N = _checked(x, y, u, n, k, r, a, b, ll)
    w = torch.zeros((B, KM), dtype=dtype, device=dev)
    done = torch.zeros(B, dtype=torch.uint8, device=dev)
    failed = torch.zeros(B, dtype=torch.uint8, device=dev)
    it_done = torch.full((B,), never, dtype=torch.int32, device=dev)
    if B:
        with torch.cuda.device(dev):
            lib = _lib()
            scratch = _scratch(lib, B, KM, N, dtype, dev)
            err = getattr(lib, _ENTRY[dtype])(
                x.data_ptr(), y.data_ptr(), u.data_ptr(), n.data_ptr(),
                k.data_ptr(), r.data_ptr(), a.data_ptr(), b.data_ptr(),
                w.data_ptr(), ll.data_ptr(), done.data_ptr(),
                failed.data_ptr(), it_done.data_ptr(),
                scratch.data_ptr() if scratch is not None else None, B, KM,
                N, max_iters, never, sigma, lam, tol,
                torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"em_rows_kernel launch failed: CUDA "
                                   f"error {err}")
            LAUNCHES["em_rows_kernel"] += 1
    return w, done.bool(), failed.bool(), it_done


def m_step_check(x, y, u, n, k, r, a, b, *, sigma: float, lam: float):
    """Both forms of the kernel's M-step on the same operands, for the
    checks: each row's components through the sequential walk and through
    the warp form that ``em_rows_kernel`` runs, from the responsibilities
    ``r`` and breakpoints ``a``, ``b`` (operands as ``em_rows``'s, left as
    they are).  Returns {"walk": (a, b, nk), "warp": (a, b, nk)}, each
    (B, KM); components past k: nk 0, a and b as given.
    """
    dev, dtype, B, KM, N = _checked(x, y, u, n, k, r, a, b)
    out = torch.zeros((6, B, KM), dtype=dtype, device=dev)
    if B:
        with torch.cuda.device(dev):
            lib = _lib()
            scratch = _scratch(lib, B, KM, N, dtype, dev)
            err = getattr(lib, _CHECK_ENTRY[dtype])(
                x.data_ptr(), y.data_ptr(), u.data_ptr(), n.data_ptr(),
                k.data_ptr(), r.data_ptr(), a.data_ptr(), b.data_ptr(),
                out.data_ptr(),
                scratch.data_ptr() if scratch is not None else None, B, KM,
                N, sigma, lam, torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"em_m_step_check launch failed: CUDA "
                                   f"error {err}")
    return {"walk": tuple(out[:3]), "warp": tuple(out[3:])}
