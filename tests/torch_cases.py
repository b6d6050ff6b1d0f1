"""Seeded inputs shared by the port's tests and its smoke run on the card:
re-exported from ``defuse_tpu_torch.utils.synth`` (numpy and the port
only, so the CUDA tests can run where ``jax`` is not installed)."""

from defuse_tpu_torch.utils.synth import (  # noqa: F401
    EDGE_CASES, SWEEP, edge_case, frontend_config, rand_seq, screen_case,
    sweep_inputs, tensors, verify_case, verify_genome_case)
