"""defuse_tpu_torch: the PyTorch/CUDA port of defuse-tpu for NVIDIA Hopper.

The JAX package ``defuse_tpu`` stays the reference.  This package holds
the device-facing layers in PyTorch, with every TPU kernel on its path
rewritten as a hand-written CUDA kernel (``csrc/``), and its own copy of
the host layer (io, host-side cluster/align code, the ``ctypes`` loader of
the native C++ library under ``native/``).  It imports ``torch``, never
``jax`` and nothing of ``defuse_tpu``.

The package's first lines open the process's ``process.import`` span
(``utils.profiling.PROCESS_SPANS``), which closes where the span system
first loads (for ``run``, in ``cli.main``).
"""

import resource as _resource
import sys as _sys
import time as _time

_START_NS = _time.perf_counter_ns()
_START_RSS_HWM = _resource.getrusage(_resource.RUSAGE_SELF).ru_maxrss * 1024
_TORCH_PRELOADED = "torch" in _sys.modules

__version__ = "0.1.0"
