"""defuse_tpu_torch: the PyTorch/CUDA port of defuse-tpu for NVIDIA Hopper.

The JAX package ``defuse_tpu`` stays the reference.  This package holds
the device-facing layers in PyTorch, with every TPU kernel on its path
rewritten as a hand-written CUDA kernel (``csrc/``), and imports the
JAX-free host layer (native C++ library, io, host-side cluster/align code)
from ``defuse_tpu`` rather than copying it.  It never imports ``jax``.
"""

__version__ = "0.1.0"
