"""Build, load and bind the hand-written CUDA kernels.

``nvcc`` compiles ``csrc/<name>.cu`` for ``sm_90a`` into a shared library
with a plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds).  The library lands under ``build/kernels/`` at the
repository root, named by a hash of its source, the headers of ``csrc/``
and its flags, so a changed source rebuilds and an unchanged one loads the
cached file.  The build runs at first use, never at import; a failed build
raises with ``nvcc``'s stderr.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent.parent / \
    "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# flags of one source beyond NVCC_FLAGS: the EM's sums and products round
# one by one, as the plain version's tensor operations do
EXTRA_FLAGS = {"em": ("--fmad=false",)}

_LOCK = threading.Lock()
_LOADED: dict[str, ctypes.CDLL] = {}
_BOUND: dict[str, ctypes.CDLL] = {}


def find_cuda_tool(tool: str) -> str:
    for cand in (os.environ.get("CUDA_HOME") and
                 os.path.join(os.environ["CUDA_HOME"], "bin", tool),
                 shutil.which(tool), f"/usr/local/cuda/bin/{tool}"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(f"{tool} not found (set CUDA_HOME or put it on PATH); "
                       "the CUDA kernels are built from source at first use")


def find_nvcc() -> str:
    return find_cuda_tool("nvcc")


def sass(name: str) -> str:
    """``cuobjdump -sass`` of the built ``csrc/<name>.cu`` library: the
    machine code the card runs, for the census checks."""
    path, _report = build(name)
    proc = subprocess.run([find_cuda_tool("cuobjdump"), "-sass", str(path)],
                          capture_output=True, text=True, check=True)
    return proc.stdout


def flags(name: str) -> tuple:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def library_path(name: str) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + headers + " ".join(flags(name)).encode()) \
        .hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(name: str) -> tuple[pathlib.Path, str]:
    """Compile ``csrc/<name>.cu`` unless its hashed library exists.
    Returns (library path, ptxas report; empty when it was cached)."""
    out = library_path(name)
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *flags(name), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed building {name} "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    tmp.replace(out)
    return out, proc.stderr


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            path, _report = build(name)
            lib = ctypes.CDLL(str(path))
            _LOADED[name] = lib
        return lib


def bind(name: str, sigs: dict) -> ctypes.CDLL:
    """``load(name)`` with the argument types of each C entry in ``sigs``
    set, once per process; every entry returns its launch's CUDA error
    code as an int."""
    lib = _BOUND.get(name)
    if lib is None:
        lib = load(name)
        for fn_name, argtypes in sigs.items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _BOUND[name] = lib
    return lib


def cuda_device(t, kernel: str):
    """The CUDA device of ``t``; raises for any other device (a wrapper
    takes the plain version only for CPU tensors)."""
    if t.device.type != "cuda":
        raise ValueError(f"{kernel} kernel needs CUDA tensors, got {t.device}")
    return t.device


def check_operand(name, t, dtype, ndim, device) -> None:
    """Raise unless ``t`` has the dtype, rank and device a kernel takes and
    is contiguous."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
