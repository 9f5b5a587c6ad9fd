"""SPMD multi-chip rendering via shard_map over a ('rows', 'tris') mesh.

Each device rasterizes a contiguous block of frame rows (the ``rows`` axis)
for its shard of the face batch (the ``tris`` axis); partial buffers merge
with XLA collectives inside the compiled program (ops/pipeline.py
``render_core``):

- z-buffer: ``pmin`` over ``tris`` (depth resolve is an associative min),
- winning face ids: final-z claim + ``pmax`` (shard-major ids = last-wins),
- silhouette parity: ``psum`` of per-shard edge-incidence counts,
- stencil: ``psum`` of per-shard signed crossing counts,
- shading attributes: ``all_gather`` over ``tris``.

There is no single-host assumption: geometry inputs are replicated, face-level
arrays are sharded, and the frame comes back row-sharded.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

try:
    from jax import shard_map as _shard_map

    def shard_map(f, mesh, in_specs, out_specs, check_rep=False):
        return _shard_map(f, mesh=mesh, in_specs=in_specs,
                          out_specs=out_specs, check_vma=check_rep)
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map as _shard_map

    def shard_map(f, mesh, in_specs, out_specs, check_rep=False):
        return _shard_map(f, mesh=mesh, in_specs=in_specs,
                          out_specs=out_specs, check_rep=check_rep)

from tpu_renderer.ops.pipeline import SceneConfig, render_core
from tpu_renderer.parallel.mesh import ROWS_AXIS, TRIS_AXIS

__all__ = ["render_frame_sharded", "pad_models_for_tris", "dyn_partition_specs"]

#: Per-model packet keys sharded along the face axis.
_FACE_KEYS = ("vid", "pad_valid", "uv", "kd", "ks", "ns", "pm", "pr", "ka",
              "kd_slot", "ks_slot", "norm_slot", "kd_shape", "ks_shape",
              "norm_shape", "norm_tangent", "vn")
#: Incidence arrays sharded along the (3 * faces) axis.
_INC_KEYS = ("inc_edge", "inc_dir", "inc_valid")


def pad_models_for_tris(dyn, n_tris: int, chunk: int = 8):
    """Pad each model's face arrays so every shard stays chunk-aligned."""
    if n_tris == 1:
        return dyn
    out_models = []
    for md in dyn["models"]:
        md = dict(md)
        f = md["vid"].shape[0]
        pad = (-f) % (n_tris * chunk)
        if pad:
            for k in _FACE_KEYS:
                if k in md:
                    a = md[k]
                    md[k] = jnp.concatenate(
                        [a, jnp.zeros((pad,) + a.shape[1:], a.dtype)])
            for k in _INC_KEYS:
                a = md[k]
                md[k] = jnp.concatenate(
                    [a, jnp.zeros((3 * pad,) + a.shape[1:], a.dtype)])
        out_models.append(md)
    return dict(dyn, models=out_models)


def dyn_partition_specs(dyn, n_tris: int):
    """PartitionSpec tree for the dynamic inputs: face-level arrays shard over
    TRIS_AXIS, everything else (vertices, textures, camera/light) replicates."""
    sharded_keys = set(_FACE_KEYS) | set(_INC_KEYS) if n_tris > 1 else set()

    def model_spec(md):
        return {k: (P(TRIS_AXIS) if k in sharded_keys else P())
                for k in md}

    specs = {k: jax.tree_util.tree_map(lambda _: P(), v)
             for k, v in dyn.items() if k != "models"}
    specs["models"] = [model_spec(md) for md in dyn["models"]]
    return specs


def render_frame_sharded(cfg: SceneConfig, dyn, mesh):
    """Render one frame across the mesh. Returns (frame_u8, zbuf, tid, stencil)
    as global row-sharded arrays. The program compiles once per (cfg, mesh)."""
    height = cfg.resolution[0]
    n_rows = mesh.shape[ROWS_AXIS]
    if height % n_rows:
        raise ValueError(f"height {height} not divisible by rows={n_rows}")
    return _render_sharded(cfg, dyn, mesh)


@partial(jax.jit, static_argnames=("cfg", "mesh"))
def _render_sharded(cfg: SceneConfig, dyn, mesh):
    n_tris = mesh.shape.get(TRIS_AXIS, 1)
    local_h = cfg.resolution[0] // mesh.shape[ROWS_AXIS]
    axis_tris = TRIS_AXIS if n_tris > 1 else None

    dyn = pad_models_for_tris(dyn, n_tris, cfg.chunk)
    in_specs = (dyn_partition_specs(dyn, n_tris),)
    out_specs = (P(ROWS_AXIS), P(ROWS_AXIS), P(ROWS_AXIS), P(ROWS_AXIS))

    def local_render(d):
        row0 = jax.lax.axis_index(ROWS_AXIS) * local_h
        return render_core(cfg, d, local_height=local_h, row0=row0,
                           axis_tris=axis_tris)

    frame, zbuf, tid, stencil = shard_map(local_render, mesh, in_specs,
                                          out_specs)(dyn)
    out = (jnp.clip(frame[::-1] ** 0.8, 0.0, 1.0) * 255).astype(jnp.uint8)
    return out, zbuf, tid, stencil
