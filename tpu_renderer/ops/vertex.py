"""Batched vertex stage: world -> clip -> NDC -> screen, one matmul per model.

Replaces the reference's per-face transform (triangular.py:36-45, executed once
per triangle per pass in Python) with a single whole-model computation: all V
vertices transform through the MVP in one ``(V, 4) @ (4, 4)`` contraction, the
perspective divide stores 1/w per vertex for perspective-correct interpolation
(the reference stashes it in the W column, triangular.py:42-45), and per-face
attribute triples are gathered with one take per attribute.

Face validity folds the reference's early-out Errors into masks
(triangular.py:15-20, 47-48, 69-78): backface culling by screen-space normal z,
degenerate barycentric denominator, and empty clamped bounding box.
"""
from __future__ import annotations

import jax.numpy as jnp

from tpu_renderer.ops.transforms import bound_box_batch, matmul

__all__ = ["linearize_z", "transform_vertices", "gather_faces", "screen_normal_z"]


def linearize_z(depth, near, far):
    """Depth linearization (reference core.py:226-228), applied to the
    viewport-transformed z exactly like triangular.py:96."""
    return (2 * near * far) / (far + near - depth * (far - near))


def transform_vertices(world_vertices, mvp, viewport, near, far):
    """(V, 4) world -> dict of per-vertex pipeline arrays.

    Returns: clip (V, 4) clip-space positions; inv_w (V,); screen (V, 4) with
    xy in pixels and the reference's viewport z; zlin (V,) linearized depth.
    """
    world_vertices = jnp.asarray(world_vertices, jnp.float32)
    clip = matmul(world_vertices, jnp.asarray(mvp, jnp.float32))
    inv_w = 1.0 / clip[:, 3]
    ndc = clip * inv_w[:, None]
    screen = matmul(ndc, jnp.asarray(viewport, jnp.float32))
    zlin = linearize_z(screen[:, 2], near, far)
    return {"clip": clip, "inv_w": inv_w, "screen": screen, "zlin": zlin,
            "world": world_vertices[:, :3]}


def screen_normal_z(sx, sy, sz):
    """Z component of the (unnormalized) screen-space face normal.

    Sign-equal to the reference's ``unit_normal_current_space[2]``
    (core.py:133-136): cross(b - a, c - a).z of the post-viewport vertices.
    sx, sy, sz: (F, 3) per-face vertex components.
    """
    abx, aby, abz = sx[:, 1] - sx[:, 0], sy[:, 1] - sy[:, 0], sz[:, 1] - sz[:, 0]
    acx, acy, acz = sx[:, 2] - sx[:, 0], sy[:, 2] - sy[:, 0], sz[:, 2] - sz[:, 0]
    del abz, acz
    return abx * acy - aby * acx


def gather_faces(vert_arrays, face_vid, height, width, backface_culling):
    """Per-face triples + validity masks from per-vertex pipeline arrays.

    vert_arrays: output of :func:`transform_vertices`.
    face_vid: (F, 3) int32 vertex ids.

    Returns dict with sx/sy/szlin/inv_w (F, 3), clip (F, 3, 4), bbox (F, 4),
    denom (F,), valid (F,) — validity covering backface culling (when enabled),
    degenerate screen triangles and empty clamped bounding boxes; plus
    world (F, 3, 3) when vert_arrays carries per-vertex world positions.

    All per-vertex channels ride ONE packed (V, 10|13) gather instead of a
    separate gather pass per array: one multi-column gather amortizes the
    index walk across every channel. Values are bit-identical — only the
    storage layout changes.
    """
    world_v = vert_arrays.get("world")
    parts = [vert_arrays["screen"], vert_arrays["clip"],
             vert_arrays["inv_w"][:, None], vert_arrays["zlin"][:, None]]
    if world_v is not None:
        parts.append(world_v)
    packed = jnp.concatenate(parts, axis=1)[face_vid]   # ONE (F, 3, C) gather
    screen = packed[..., 0:4]                           # (F, 3, 4)
    clip = packed[..., 4:8]                             # (F, 3, 4)
    inv_w = packed[..., 8]                              # (F, 3)
    zlin = packed[..., 9]                               # (F, 3)

    sx = screen[..., 0]
    sy = screen[..., 1]
    sz = screen[..., 2]

    nz = screen_normal_z(sx, sy, sz)
    valid = jnp.ones(face_vid.shape[0], bool)
    if backface_culling:
        # Cull when the normalized screen normal z < 0 (triangular.py:47-48).
        valid &= ~(nz < 0)

    # Barycentric denominator (transformation.py:25-27) on screen xy.
    v0x, v0y = sx[:, 1] - sx[:, 0], sy[:, 1] - sy[:, 0]
    v1x, v1y = sx[:, 2] - sx[:, 0], sy[:, 2] - sy[:, 0]
    d00 = v0x * v0x + v0y * v0y
    d01 = v0x * v1x + v0y * v1y
    d11 = v1x * v1x + v1y * v1y
    denom = d00 * d11 - d01 * d01
    valid &= denom != 0                                  # Errors.EMPTY_B

    # Screen barycentrics as per-face AFFINE functions of the pixel center:
    # v = av*x + bv*y + cv, w likewise, u = 1 - v - w, z = az*x + bz*y + cz.
    # Algebraically identical to the two-dot-product form
    # (transformation.py:25-33) but one fused setup per FACE instead of per
    # pixel — the rasterizer (ops/raster_xla.py) and
    # shading.pixel_barycentric evaluate these coefficients with the same
    # expression, so coverage and shading agree bit for bit. Absolute
    # f32 error of the global-coordinate evaluation is ~|coef|*2^-14 px
    # (coords <= 4k), orders below the half-pixel coverage granularity.
    ax, ay = sx[:, 0], sy[:, 0]
    inv_denom = 1.0 / jnp.where(denom == 0, 1.0, denom)
    av = (d11 * v0x - d01 * v1x) * inv_denom
    bv = (d11 * v0y - d01 * v1y) * inv_denom
    cv = -(ax * av + ay * bv)
    aw = (d00 * v1x - d01 * v0x) * inv_denom
    bw = (d00 * v1y - d01 * v0y) * inv_denom
    cw = -(ax * aw + ay * bw)
    z10, z20 = zlin[:, 1] - zlin[:, 0], zlin[:, 2] - zlin[:, 0]
    az = av * z10 + aw * z20
    bz = bv * z10 + bw * z20
    cz = zlin[:, 0] + cv * z10 + cw * z20
    aff = jnp.stack([av, bv, cv, aw, bw, cw, az, bz, cz], axis=-1)

    box, box_valid = bound_box_batch(
        jnp.stack([sx, sy], axis=-1), height, width)
    valid &= box_valid                                   # Errors.EMPTY_Z / WRONG_MIN_MAX

    out = {
        "sx": sx, "sy": sy, "szlin": zlin, "inv_w": inv_w, "aff": aff,
        "clip": clip, "bbox": box, "denom": denom, "valid": valid,
    }
    if world_v is not None:
        out["world"] = packed[..., 10:13]               # (F, 3, 3)
    return out
