"""cluster_generator_tpu_torch — the PyTorch/CUDA port of cluster_generator_tpu.

The same galaxy-cluster initial-conditions engine on one NVIDIA H100:
equilibrium models, Eddington DFs, inverse-CDF tables and particle draws,
as plain functions on tensors with a leading halo axis.  Float64 for the
equilibrium solve, float32 for tables and draws.  The TPU kernel of the
JAX package is a hand-written CUDA kernel here (``ops/csrc``), compiled by
``nvcc`` at first use.  Entry points run on the card unless called with
``device="cpu"``.  This package imports neither JAX nor
``cluster_generator_tpu``.
"""

from __future__ import annotations

from .pipeline import (binary_merger_ic, build_merger_models,
                       build_radius_tables, build_speed_tables,
                       merger_ic_fused, sample_merger_ic)

__all__ = ["binary_merger_ic", "build_merger_models", "build_radius_tables",
           "build_speed_tables", "merger_ic_fused", "sample_merger_ic"]
