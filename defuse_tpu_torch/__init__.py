"""defuse_tpu_torch: the PyTorch/CUDA port of defuse-tpu for NVIDIA Hopper.

The JAX package ``defuse_tpu`` stays the reference.  This package holds
the device-facing layers in PyTorch, with every TPU kernel on its path
rewritten as a hand-written CUDA kernel (``csrc/``), and its own copy of
the host layer (io, host-side cluster/align code, the ``ctypes`` loader of
the native C++ library under ``native/``).  It imports ``torch``, never
``jax`` and nothing of ``defuse_tpu``.
"""

__version__ = "0.1.0"
