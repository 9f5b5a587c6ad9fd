"""XLA visibility-buffer rasterizer (portable reference path).

Architecture (SURVEY.md §7): instead of the reference's per-face Python loop
with three mutable-buffer passes (core.py:603-636), the frame is resolved as a
**visibility buffer** — per pixel, the id of the winning triangle — after which
all shading is pixel-parallel (ops/shading.py). Two streamed passes over the
face batch, each a ``lax.scan`` carrying an (H, W) plane:

- *z pass* (reference pass 1's depth writes, triangular.py:96-118): for every
  z-writing face, coverage ∧ sign-aware depth test against the evolving
  z-buffer, sequential face order preserved so equal-depth ties resolve to the
  later face exactly like the reference's read-modify-write loop.
- *id pass* (reference pass 3's re-test against the final z-buffer,
  triangular.py:99-109): every face (including non-depth-writing ones) claims
  pixels where coverage ∧ final-z test passes; later faces overwrite — the
  reference's overdraw semantics.

Coverage folds the reference's per-pixel work: barycentric inside test
(triangular.py:74-78), integer bbox window (mgrid over the ceil'd clamped box,
:68-72), and the per-pixel clip-space test ``-w < x,y,z < w`` with
perspective-corrected barycentric weights (:80-91), optionally against a debug
camera's clip space as well.

This path is brute-force O(F·H·W): every face is tested against every pixel
of the (local) frame. It is the one rasterizer, on every device, and the
reference any faster rasterizer must match bit for bit on z and id.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

__all__ = ["face_fragments", "zbuffer_pass", "visibility_pass", "render_visibility"]


def face_fragments(face, rows, cols, with_clip_test):
    """Coverage mask and interpolated depth for ONE face over the full frame.

    face: dict of per-face scalars/vectors (see ops/vertex.gather_faces, plus
    ``clip_en`` bool and optionally ``clip_dbg``).
    rows: (H, 1) float32 pixel row coordinates (screen y).
    cols: (1, W) float32 pixel column coordinates (screen x).

    Returns (cov (H, W) bool, z (H, W) f32).
    """
    # Affine barycentric evaluation (coefficients precomputed once per face
    # in vertex.gather_faces; shading.pixel_barycentric evaluates the same
    # expression).
    aff = face["aff"]
    v = aff[0] * cols + aff[1] * rows + aff[2]
    w = aff[3] * cols + aff[4] * rows + aff[5]
    u = 1.0 - v - w

    inside = (u >= 0) & (v >= 0) & (w >= 0)
    box = face["bbox"]
    window = ((cols >= box[0]) & (cols < box[1]) &
              (rows >= box[2]) & (rows < box[3]))
    cov = inside & window & face["valid"]

    if with_clip_test:
        # Linearized perspective-corrected clip test. It is algebraically the
        # reference's divide form (core.py:155-160, pb_j = u*iw_j/S then
        # -w < x,y,z < w) but rounds differently at the S -> 0 horizon:
        # cond_j / S > 0  <=>  (q_j > 0) == (S > 0), q_j the interpolated
        # inv_w-scaled plane e[i, j] = iw_i * (x_i+w_i, w_i-x_i, ...).
        # S == 0 makes the reference's weights NaN -> every comparison
        # false -> dropped; ok = (S != 0) reproduces that exactly.
        iw = face["inv_w"]
        sw = u * iw[0] + v * iw[1] + w * iw[2]
        ok = sw != 0
        spaces = [face["clip"]]
        if "clip_dbg" in face:
            spaces.append(face["clip_dbg"])
        for cs in spaces:
            x_, y_, z_, w_ = cs[:, 0], cs[:, 1], cs[:, 2], cs[:, 3]
            conds = jnp.stack([x_ + w_, w_ - x_, y_ + w_, w_ - y_,
                               z_ + w_, w_ - z_], axis=-1)      # (3, 6)
            e = conds * iw[:, None]
            for j in range(6):
                q = u * e[0, j] + v * e[1, j] + w * e[2, j]
                ok &= (q > 0) == (sw > 0)
        # Models with clip=False skip the test (reference triangular.py:80).
        cov &= ok | ~face["clip_en"]

    z = aff[6] * cols + aff[7] * rows + aff[8]
    return cov, z


def _chunked(faces, chunk):
    """Reshape every (G, ...) leaf to (G/chunk, chunk, ...) for lax.scan."""
    def r(a):
        return a.reshape(a.shape[0] // chunk, chunk, *a.shape[1:])
    return jax.tree_util.tree_map(r, faces)


@partial(jax.jit, static_argnames=("height", "width", "sign", "chunk"))
def zbuffer_pass(faces, height, width, sign, chunk=8, row0=0):
    """Depth pre-pass: final z-buffer in sign space (z * sign, min-combine).

    Matches reference pass 1 z writes (triangular.py:117-118): only faces with
    ``z_write`` update; the test is ``z_buffer >= z`` (RH) / ``<=`` (LH), both
    expressed as ``zb' >= z'`` with z' = z*sign.

    ``row0`` offsets the pixel rows into the global frame — the hook that lets
    a device mesh shard the frame row-wise (parallel/sharded.py).
    """
    rows = jnp.arange(height, dtype=jnp.float32)[:, None] + row0
    cols = jnp.arange(width, dtype=jnp.float32)[None, :]
    zb0 = jnp.full((height, width), jnp.inf, jnp.float32)

    def body(zb, chunk_faces):
        for k in range(chunk):
            face = jax.tree_util.tree_map(lambda a: a[k], chunk_faces)
            cov, z = face_fragments(face, rows, cols, with_clip_test=True)
            zs = z * sign
            upd = cov & (zb >= zs) & face["z_write"]
            zb = jnp.where(upd, zs, zb)
        return zb, None

    zb, _ = jax.lax.scan(body, zb0, _chunked(faces, chunk))
    return zb


@partial(jax.jit, static_argnames=("height", "width", "sign", "chunk"))
def visibility_pass(faces, zb_sign, height, width, sign, chunk=8, row0=0):
    """Resolve the winning face id per pixel against the FINAL z-buffer.

    Reference pass 3 semantics (triangular.py:99-109 without the stencil mask,
    which applies at shading time): claim where coverage ∧ z-test vs final
    z-buffer; later faces overwrite (model/face order).
    Returns tid (H, W) int32, -1 where no face claims the pixel.
    """
    rows = jnp.arange(height, dtype=jnp.float32)[:, None] + row0
    cols = jnp.arange(width, dtype=jnp.float32)[None, :]
    tid0 = jnp.full((height, width), -1, jnp.int32)

    def body(tid, chunk_faces):
        for k in range(chunk):
            face = jax.tree_util.tree_map(lambda a: a[k], chunk_faces)
            cov, z = face_fragments(face, rows, cols, with_clip_test=True)
            upd = cov & (zb_sign >= z * sign)
            tid = jnp.where(upd, face["gid"], tid)
        return tid, None

    tid, _ = jax.lax.scan(body, tid0, _chunked(faces, chunk))
    return tid


def render_visibility(faces, height, width, sign, chunk=8, row0=0):
    """Full visibility resolve: (z-buffer in real z space, tid)."""
    zb_sign = zbuffer_pass(faces, height, width, sign, chunk, row0)
    tid = visibility_pass(faces, zb_sign, height, width, sign, chunk, row0)
    return zb_sign * sign, tid
