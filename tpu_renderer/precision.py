"""f32 rounding in the render programs: the one place it is decided.

z, face ids and stencil must come out bit-identical on every device (the
GPU render is checked against the CPU's): coverage, depth and shadow-volume
decisions are sign tests, and pixels on a shadow outline are exact depth
ties between the floor and a shadow quad, so one ulp flips them. Two things
make every f32 operation round the same on the GPU and the CPU:

- **Expressions.** The render programs hold no XLA dot: small contractions
  (3/4-vectors, 4x4 matrices) are elementwise multiplies and adds summed in
  index order (``ops.transforms.dot`` / ``matmul``), so no GEMM library,
  summation order or reduced (TF32) matmul precision enters. The
  projections' tan is a multiply/add series (``transforms._tan``). The 4x4
  inverses of the skybox and the 3-point projection go through
  ``jnp.linalg.inv`` (an LU solve, which no matmul precision setting
  reaches).
- **Compiler.** :data:`EXACT_F32_XLA_FLAGS`. XLA:GPU otherwise divides with
  ``div.full`` (up to 2 ulp) and takes an approximate square root; XLA:CPU
  contracts multiply-adds into FMAs where the host has them (the GPU's code
  does not). ``import tpu_renderer`` adds the flags to ``XLA_FLAGS``
  (:func:`use_exact_f32_math`); XLA reads that variable once, when JAX
  creates its first backend, so import the package before running anything
  on JAX. Shading's ``pow`` / ``exp`` remain library routines whose last
  bit may differ between backends: a frame pixel may land one 8-bit step
  apart.
"""
from __future__ import annotations

import os
import warnings

__all__ = ["EXACT_F32_XLA_FLAGS", "use_exact_f32_math",
           "exact_f32_math_active"]

#: XLA flags under which every f32 operation rounds correctly on the GPU
#: (IEEE division and square root) and the CPU (no FMA contraction). They
#: cost the flagship frame about 2.4% on an H100 (PERF.md).
EXACT_F32_XLA_FLAGS = (
    "--xla_cpu_max_isa=AVX",
    "--xla_backend_extra_options=-nvptx-prec-divf32=2,-nvptx-prec-sqrtf32=1,"
    "-nvvm-reflect-add=__CUDA_PREC_SQRT=1",
)

_active = False


def _backends_started() -> bool:
    from jax._src import xla_bridge

    return xla_bridge.backends_are_initialized()


def use_exact_f32_math() -> bool:
    """Add :data:`EXACT_F32_XLA_FLAGS` to ``XLA_FLAGS`` (once).

    Returns whether they govern this process's compiles: True unless JAX
    created its backends before the flags were set, in which case it warns
    (the renders then run, but may differ from another device's on boundary
    pixels)."""
    global _active
    flags = os.environ.get("XLA_FLAGS", "")
    present = all(f in flags.split() for f in EXACT_F32_XLA_FLAGS)
    if _backends_started():
        _active = _active or present
        if not _active:
            warnings.warn(
                "JAX started its backends before tpu_renderer was imported, "
                "so tpu_renderer.precision.EXACT_F32_XLA_FLAGS do not apply: "
                "import tpu_renderer first for renders that are bit-equal "
                "across devices", RuntimeWarning, stacklevel=2)
        return _active
    if not present:
        os.environ["XLA_FLAGS"] = " ".join(
            [flags, *EXACT_F32_XLA_FLAGS]).strip()
    _active = True
    return True


def exact_f32_math_active() -> bool:
    """Whether :data:`EXACT_F32_XLA_FLAGS` govern this process's compiles."""
    return _active
