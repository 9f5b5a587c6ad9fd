"""Transform-matrix library: the L0 math core.

JAX re-implementation of the reference's ``obj/transformation.py`` as pure,
jit-traceable ``jax.numpy`` functions. Every matrix follows the reference's
**row-vector convention** (points are rows; matrices right-multiply:
``vertices @ M``, reference core.py:350-352, triangular.py:37), which is why e.g.
``translation`` returns the transposed column-major matrix
(transformation.py:219-227) and ``ViewPort`` carries translation in its last row
(transformation.py:123-136).

All functions accept Python scalars, numpy arrays, or traced jax values, so a
camera can be animated *inside* a jitted render step without recompilation.

Parity map (reference transformation.py):
  scale:207  translation:219  rotate_xyz:230  looka_at_translate:77
  look_at_rotate_lh:83  look_at_rotate_rh:92  lookAtLH:52  lookAtRH:101
  ViewPort:123  opengl_orthographicLH:139  opengl_perspectiveLH:157
  opengl_perspectiveRH:168  directx_perspectiveRH:179  directx_perspectiveLH:193
  FPSViewRH:266  perspective_matrix_3point:294  perspective_matrix_2point:314
  perspectives registry:346  barycentric:12  bound_box:35  normalize:46

``lookAtLH``/``lookAtRH``, ``FPSViewRH`` and the 2/3-point perspectives are
functions the reference exports but never calls itself; they are kept
DELIBERATELY as drop-in API surface for reference users (each oracle-tested
in tests/test_transforms.py), not as pipeline dependencies.
"""
from __future__ import annotations

import jax.numpy as jnp

from tpu_renderer.constants import PROJECTION_TYPE, SUBSYSTEM, SYSTEM, X, Y

__all__ = [
    "normalize", "barycentric", "barycentric_batch", "bound_box", "bound_box_batch",
    "scale", "translation", "rotate_xyz", "rotate",
    "looka_at_translate", "look_at_translate", "look_at_rotate_lh",
    "look_at_rotate_rh", "lookAtLH", "lookAtRH", "FPSViewRH", "ViewPort",
    "opengl_orthographicLH", "opengl_perspectiveLH", "opengl_perspectiveRH",
    "directx_perspectiveLH", "directx_perspectiveRH",
    "perspective_matrix_2point", "perspective_matrix_3point",
    "perspectives", "SYSTEM", "SUBSYSTEM",
]

def _flt():
    """Matrix dtype, resolved at call time: float32 normally, float64 inside
    a ``jax.enable_x64(True)`` scope. The device pipeline always runs f32;
    the host-side debug-overlay path (Scene.render) computes camera matrices
    under x64 because its clip decisions are sign-marginal by construction
    (the frustum-cube corners of a debug camera equal to the main camera lie
    exactly ON the clip planes) and must follow the reference's f64 numpy
    arithmetic (frustums.py:46-103)."""
    return jnp.result_type(float)


def dot(a, b):
    """Sum over the last axis of ``a * b``, added in index order.

    The small contractions of the render path (3- and 4-vectors, 4x4
    matrices) are written as elementwise products and adds instead of XLA
    dots: a dot lowers per backend (a GEMM library, tree or sequential
    sums) and rounds differently on each, while these elementwise ops round
    identically on every device. Coverage, depth and stencil decisions are
    sign-sensitive at the last ulp, so this keeps z, ids and stencil
    bit-identical between devices. It also leaves no product to run at a
    reduced (bf16 / TF32) matmul precision.
    """
    a = jnp.asarray(a)
    b = jnp.asarray(b)
    p = a * b
    out = p[..., 0]
    for k in range(1, p.shape[-1]):
        out = out + p[..., k]
    return out


def matmul(a, b):
    """Row-vector product ``a @ b``: ``a`` (..., K) times ``b`` (..., K, M),
    leading dims broadcast (so a (N, K) @ (K, M) matrix product, or one
    weight vector per pixel times one matrix per pixel). Summed in index
    order with elementwise ops, for the reason given in :func:`dot`."""
    a = jnp.asarray(a)
    b = jnp.asarray(b)
    out = a[..., 0, None] * b[..., 0, :]
    for k in range(1, a.shape[-1]):
        out = out + a[..., k, None] * b[..., k, :]
    return out


def normalize(a, axis=-1, order=2):
    """Safe L2 (or Lp) normalization (reference transformation.py:46-49).

    Zero-norm rows are passed through unchanged (norm treated as 1).
    """
    a = jnp.asarray(a)
    if order == 2:
        moved = jnp.moveaxis(a, axis, -1)
        l2 = jnp.atleast_1d(jnp.sqrt(dot(moved, moved)))
    else:
        l2 = jnp.atleast_1d(jnp.linalg.norm(a, order, axis))
    l2 = jnp.where(l2 == 0, 1, l2)
    return a / jnp.expand_dims(l2, axis)


def barycentric(a, b, c, p):
    """Barycentric coordinates of points ``p`` w.r.t. 2D triangle ``(a, b, c)``.

    Same dot-product formulation (in float32) as the reference
    (transformation.py:12-32). The reference returns ``None`` on a degenerate
    triangle (zero denominator); a jit-traceable function cannot, so this returns
    ``(bar, valid)`` where ``valid`` is a scalar bool and ``bar`` contains
    garbage (inf/nan) when invalid — callers mask on ``valid``.

    a, b, c: (2,) points.  p: (N, 2) points.  Returns ((N, 3), bool).
    """
    a = jnp.asarray(a, _flt())
    b = jnp.asarray(b, _flt())
    c = jnp.asarray(c, _flt())
    p = jnp.asarray(p, _flt())
    v0 = b - a
    v1 = c - a
    v2 = p - a
    d00 = dot(v0, v0)
    d01 = dot(v0, v1)
    d11 = dot(v1, v1)
    d20 = dot(v2, v0)
    d21 = dot(v2, v1)
    denom = d00 * d11 - d01 * d01
    inv_denom = 1.0 / denom
    v = (d11 * d20 - d01 * d21) * inv_denom
    w = (d00 * d21 - d01 * d20) * inv_denom
    u = 1.0 - v - w
    return jnp.stack([u, v, w], axis=-1), denom != 0


def barycentric_batch(tri_xy, p):
    """Batched barycentric: ``tri_xy`` (..., 3, 2) triangles, ``p`` (N, 2) pixels.

    Returns ``(bar, valid)`` with ``bar`` (..., N, 3) and ``valid`` (...,).
    This is the struct-of-arrays form the rasterizer uses: one fused device
    computation instead of the reference's per-face Python call
    (triangular.py:74).
    """
    tri_xy = jnp.asarray(tri_xy, _flt())
    p = jnp.asarray(p, _flt())
    a = tri_xy[..., 0, :]
    b = tri_xy[..., 1, :]
    c = tri_xy[..., 2, :]
    v0 = b - a                                     # (..., 2)
    v1 = c - a
    v2 = p - a[..., None, :]                       # (..., N, 2)
    d00 = jnp.sum(v0 * v0, -1)                     # (...,)
    d01 = jnp.sum(v0 * v1, -1)
    d11 = jnp.sum(v1 * v1, -1)
    d20 = jnp.sum(v2 * v0[..., None, :], -1)       # (..., N)
    d21 = jnp.sum(v2 * v1[..., None, :], -1)
    denom = d00 * d11 - d01 * d01
    inv_denom = 1.0 / denom
    v = (d11[..., None] * d20 - d01[..., None] * d21) * inv_denom[..., None]
    w = (d00[..., None] * d21 - d01[..., None] * d20) * inv_denom[..., None]
    u = 1.0 - v - w
    return jnp.stack([u, v, w], axis=-1), denom != 0


def bound_box(vert_xy, height, width):
    """Screen-clamped bounding box (reference transformation.py:35-43).

    Returns ``(box, valid)`` where ``box = ceil([min_x, max_x, min_y, max_y])``
    as int32 (x clamped to [0, width], y to [0, height]) and ``valid`` is False
    when the clamped box is empty (the reference returns ``None`` then,
    triangular.py:69-70).
    """
    vert_xy = jnp.asarray(vert_xy)
    min_x = jnp.maximum(vert_xy[X].min(), 0)
    max_x = jnp.minimum(vert_xy[X].max(), width)
    min_y = jnp.maximum(vert_xy[Y].min(), 0)
    max_y = jnp.minimum(vert_xy[Y].max(), height)
    valid = ~((min_x > max_x) | (min_y > max_y))
    box = jnp.ceil(jnp.stack([min_x, max_x, min_y, max_y])).astype(jnp.int32)
    return box, valid


def bound_box_batch(tri_xy, height, width):
    """Batched ``bound_box``: ``tri_xy`` (F, K, 2) -> ((F, 4) int32, (F,) bool)."""
    tri_xy = jnp.asarray(tri_xy)
    min_x = jnp.maximum(tri_xy[..., 0].min(-1), 0)
    max_x = jnp.minimum(tri_xy[..., 0].max(-1), width)
    min_y = jnp.maximum(tri_xy[..., 1].min(-1), 0)
    max_y = jnp.minimum(tri_xy[..., 1].max(-1), height)
    valid = ~((min_x > max_x) | (min_y > max_y))
    box = jnp.ceil(jnp.stack([min_x, max_x, min_y, max_y], -1)).astype(jnp.int32)
    return box, valid


# --------------------------------------------------------------------------
# Model transforms (row-vector convention)
# --------------------------------------------------------------------------

def scale(factor):
    """Uniform scale matrix (reference transformation.py:207-216)."""
    f = jnp.asarray(factor, _flt())
    one = jnp.ones((), _flt())
    zero = jnp.zeros((), _flt())
    return jnp.stack([
        jnp.stack([f, zero, zero, zero]),
        jnp.stack([zero, f, zero, zero]),
        jnp.stack([zero, zero, f, zero]),
        jnp.stack([zero, zero, zero, one]),
    ])


def translation(vec):
    """Translation matrix, transposed for row vectors (transformation.py:219-227)."""
    vec = jnp.asarray(vec, _flt())
    m = jnp.eye(4, dtype=_flt())
    return m.at[3, :3].set(vec)


def rotate_xyz(a):
    """Euler rotation from degrees ``(x, y, z)`` (transformation.py:230-263).

    Intentionally replicates the reference's angle wiring, where the matrix
    labelled ``rotate_x`` uses the *y* angle and ``rotate_y`` the *x* angle —
    user-visible semantics of the ``rotate_xyz`` API.
    """
    a = jnp.deg2rad(jnp.asarray(a, _flt()))
    x, y, z = a[0], a[1], a[2]
    one = jnp.ones((), _flt())
    zero = jnp.zeros((), _flt())

    rot_x = jnp.stack([
        jnp.stack([one, zero, zero, zero]),
        jnp.stack([zero, jnp.cos(y), -jnp.sin(y), zero]),
        jnp.stack([zero, jnp.sin(y), jnp.cos(y), zero]),
        jnp.stack([zero, zero, zero, one]),
    ]).T

    rot_y = jnp.stack([
        jnp.stack([jnp.cos(x), zero, jnp.sin(x), zero]),
        jnp.stack([zero, one, zero, zero]),
        jnp.stack([-jnp.sin(x), zero, jnp.cos(x), zero]),
        jnp.stack([zero, zero, zero, one]),
    ]).T

    rot_z = jnp.stack([
        jnp.stack([jnp.cos(z), jnp.sin(z), zero, zero]),
        jnp.stack([-jnp.sin(z), jnp.cos(z), zero, zero]),
        jnp.stack([zero, zero, one, zero]),
        jnp.stack([zero, zero, zero, one]),
    ]).T

    return matmul(matmul(rot_z, rot_y), rot_x)


#: The reference README documents ``rotate`` but ships only ``rotate_xyz``
#: (README.md:16 vs transformation.py:230) — provide both.
rotate = rotate_xyz


# --------------------------------------------------------------------------
# Look-at family
# --------------------------------------------------------------------------

def looka_at_translate(eye):
    """Look-at translation part (reference transformation.py:77-80).

    The misspelled name is kept for API parity; ``look_at_translate`` is the
    sane alias.
    """
    eye = jnp.asarray(eye, _flt())
    m = jnp.eye(4, dtype=_flt())
    return m.at[3, :3].set(-eye)


look_at_translate = looka_at_translate


def _look_at_rotate(eye, center, up, forward_sign):
    forward = normalize(jnp.asarray(center, _flt()) - jnp.asarray(eye, _flt())).ravel()
    right = normalize(jnp.cross(jnp.asarray(up, _flt()), forward)).ravel()
    new_up = jnp.cross(forward, right)
    rot = jnp.eye(4, dtype=_flt())
    return rot.at[:3, :3].set(
        jnp.column_stack((right, new_up, forward_sign * forward)))


def look_at_rotate_lh(eye, center, up):
    """LH look-at rotation part (reference transformation.py:83-89)."""
    return _look_at_rotate(eye, center, up, -1.0)


def look_at_rotate_rh(eye, center, up):
    """RH look-at rotation part (reference transformation.py:92-98)."""
    return _look_at_rotate(eye, center, up, 1.0)


def lookAtLH(eye, center, up=(0, 1, 0)):
    """Monolithic LH view matrix (reference transformation.py:52-74)."""
    eye = jnp.asarray(eye, _flt())
    rot = look_at_rotate_lh(eye, center, up)
    m = rot.at[3, :3].set(matmul(-eye, rot[:3, :3]))
    return m


def lookAtRH(eye, center, up=(0, 1, 0)):
    """Monolithic RH view matrix (reference transformation.py:101-120).

    Note: replicates the reference's ``eye @ rot`` translation (no negation),
    matching its commented-out final form.
    """
    eye = jnp.asarray(eye, _flt())
    rot = look_at_rotate_rh(eye, center, up)
    m = rot.at[3, :3].set(matmul(eye, rot[:3, :3]))
    return m


def FPSViewRH(eye, pitch, yaw):
    """First-person-shooter RH view matrix (reference transformation.py:266-291).

    pitch in [-90, 90] degrees, yaw in [0, 360) degrees.
    """
    eye = jnp.asarray(eye, _flt())
    pitch = jnp.deg2rad(jnp.asarray(pitch, _flt()))
    yaw = jnp.deg2rad(jnp.asarray(yaw, _flt()))
    cp, sp = jnp.cos(pitch), jnp.sin(pitch)
    cy, sy = jnp.cos(yaw), jnp.sin(yaw)
    xaxis = jnp.stack([cy, jnp.zeros((), _flt()), -sy])
    yaxis = jnp.stack([sy * sp, cp, cy * sp])
    zaxis = jnp.stack([sy * cp, -sp, cp * cy])
    rot = jnp.stack([xaxis, yaxis, zaxis], axis=1)          # rows: x/y/z of axes
    bottom = jnp.stack([-dot(xaxis, eye), -dot(yaxis, eye), -dot(zaxis, eye)])
    m = jnp.eye(4, dtype=_flt()).at[:3, :3].set(rot)
    return m.at[3, :3].set(bottom)


# --------------------------------------------------------------------------
# Viewport & projections
# --------------------------------------------------------------------------

def ViewPort(resolution, far, near, x_offset=0, y_offset=0):
    """NDC -> screen matrix, translation in last row (transformation.py:123-136).

    ``resolution`` is (height, width) like the reference.
    """
    height, width = resolution
    height = jnp.asarray(height, _flt())
    width = jnp.asarray(width, _flt())
    depth = jnp.asarray(far, _flt()) - jnp.asarray(near, _flt())
    zero = jnp.zeros((), _flt())
    one = jnp.ones((), _flt())
    hw, hh, hd = width / 2, height / 2, depth / 2
    return jnp.stack([
        jnp.stack([hw, zero, zero, zero]),
        jnp.stack([zero, hh, zero, zero]),
        jnp.stack([zero, zero, hd, zero]),
        jnp.stack([hw + x_offset, hh + y_offset, hd, one]),
    ])


def opengl_orthographicLH(fov, aspect_ratio, z_near, z_far):
    """OpenGL LH orthographic projection (transformation.py:139-154)."""
    z_near = jnp.asarray(z_near, _flt())
    z_far = jnp.asarray(z_far, _flt())
    half_fov_rad = jnp.radians(jnp.asarray(fov, _flt()) / 2.0)
    half_height = _tan(half_fov_rad) * z_near
    half_width = half_height * aspect_ratio
    zero = jnp.zeros((), _flt())
    one = jnp.ones((), _flt())
    return jnp.stack([
        jnp.stack([1.0 / half_width, zero, zero, zero]),
        jnp.stack([zero, 1.0 / half_height, zero, zero]),
        jnp.stack([zero, zero, -2.0 / (z_far - z_near), zero]),
        jnp.stack([zero, zero, (z_far + z_near) / (z_far - z_near), one]),
    ])


#: Taylor-series factors: sin x = x(1 - x²/(2·3)(1 - x²/(4·5)(1 - ...))),
#: cos x = 1 - x²/(1·2)(1 - x²/(3·4)(1 - ...)). Truncation error on
#: |x| <= pi/2 is below 1e-11, far under f32 rounding.
_SIN_STEPS = tuple(1.0 / ((2 * k) * (2 * k + 1)) for k in range(1, 8))
_COS_STEPS = tuple(1.0 / ((2 * k - 1) * (2 * k)) for k in range(1, 9))


def _series(x2, steps):
    acc = jnp.ones_like(x2)
    for c in reversed(steps):
        acc = 1.0 - (x2 * c) * acc
    return acc


def _tan(x):
    """tan of the half field-of-view angle of the projections.

    An f32 ``jnp.tan`` is a library routine whose last-bit rounding differs
    between XLA's CPU and GPU backends, and every projected coordinate
    inherits it. sin / cos from the series above use only multiplies and
    adds, so their quotient rounds the same on every device; it is within a
    few ulp of the true value for |x| <= pi/2. Under x64 (the host overlay
    path, which must match the reference's numpy f64 bit for bit) this is
    ``jnp.tan``.
    """
    x = jnp.asarray(x, _flt())
    if x.dtype != jnp.float32:
        return jnp.tan(x)
    x2 = x * x
    return x * _series(x2, _SIN_STEPS) / _series(x2, _COS_STEPS)


def _perspective(fovy, aspect, m22, m32, m23):
    f = 1.0 / _tan(jnp.radians(jnp.asarray(fovy, _flt())) / 2.0)
    zero = jnp.zeros((), _flt())
    return jnp.stack([
        jnp.stack([f / aspect, zero, zero, zero]),
        jnp.stack([zero, f, zero, zero]),
        jnp.stack([zero, zero, jnp.asarray(m22, _flt()), jnp.asarray(m23, _flt())]),
        jnp.stack([zero, zero, jnp.asarray(m32, _flt()), zero]),
    ])


def opengl_perspectiveLH(fovy, aspect, z_near, z_far):
    """OpenGL LH perspective (transformation.py:157-165)."""
    n = jnp.asarray(z_near, _flt())
    f = jnp.asarray(z_far, _flt())
    return _perspective(fovy, aspect, -(f + n) / (f - n), 2.0 * f * n / (f - n), 1.0)


def opengl_perspectiveRH(fovy, aspect, z_near, z_far):
    """OpenGL RH perspective (transformation.py:168-176)."""
    n = jnp.asarray(z_near, _flt())
    f = jnp.asarray(z_far, _flt())
    return _perspective(fovy, aspect, -(f + n) / (f - n), -2.0 * f * n / (f - n), -1.0)


def directx_perspectiveRH(fovy, aspect, z_near, z_far):
    """DirectX RH perspective (transformation.py:179-190)."""
    n = jnp.asarray(z_near, _flt())
    f = jnp.asarray(z_far, _flt())
    return _perspective(fovy, aspect, f / (n - f), n * f / (n - f), -1.0)


def directx_perspectiveLH(fovy, aspect, z_near, z_far):
    """DirectX LH perspective (transformation.py:193-204)."""
    n = jnp.asarray(z_near, _flt())
    f = jnp.asarray(z_far, _flt())
    return _perspective(fovy, aspect, -f / (f - n), n * f / (f - n), 1.0)


def perspective_matrix_3point(d, aspect_ratio, fov_y, angles):
    """Three-point perspective (reference transformation.py:294-311)."""
    f = 1.0 / jnp.tan(jnp.asarray(fov_y, _flt()) / 2.0)
    d0 = jnp.asarray(d[0], _flt())
    d1 = jnp.asarray(d[1], _flt())
    zero = jnp.zeros((), _flt())
    one = jnp.ones((), _flt())
    persp = jnp.stack([
        jnp.stack([f / aspect_ratio, zero, zero, zero]),
        jnp.stack([zero, f, zero, zero]),
        jnp.stack([zero, zero, (d1 + d0) / (d1 - d0), -2 * d0 * d1 / (d1 - d0)]),
        jnp.stack([zero, zero, one, zero]),
    ])
    a0 = jnp.asarray(angles[0], _flt())
    rot = jnp.stack([
        jnp.stack([jnp.cos(a0), -jnp.sin(a0), zero, zero]),
        jnp.stack([jnp.sin(a0), jnp.cos(a0), zero, zero]),
        jnp.stack([zero, zero, one, zero]),
        jnp.stack([zero, zero, zero, one]),
    ])
    return matmul(matmul(rot, persp), jnp.linalg.inv(rot))


def perspective_matrix_2point(d, aspect_ratio, fov_y, eye_sep):
    """Two-point perspective (reference transformation.py:314-331)."""
    f = 1.0 / jnp.tan(jnp.asarray(fov_y, _flt()) / 2.0)
    d0 = jnp.asarray(d[0], _flt())
    d1 = jnp.asarray(d[1], _flt())
    zero = jnp.zeros((), _flt())
    one = jnp.ones((), _flt())
    persp = jnp.stack([
        jnp.stack([f / aspect_ratio, zero, zero, zero]),
        jnp.stack([zero, f, zero, zero]),
        jnp.stack([zero, zero, (d1 + d0) / (d1 - d0), -2 * d0 * d1 / (d1 - d0)]),
        jnp.stack([zero, zero, one, zero]),
    ])
    trans = jnp.eye(4, dtype=_flt()).at[0, 2].set(-jnp.asarray(eye_sep, _flt()) / 2)
    return matmul(trans, persp)


#: Projection registry keyed by (SUBSYSTEM, PROJECTION_TYPE, SYSTEM), same shape
#: (including the intentionally-missing combinations that raise KeyError) as the
#: reference's ``perspectives`` dict (transformation.py:346-361).
perspectives = {
    SUBSYSTEM.DIRECTX: {
        PROJECTION_TYPE.PERSPECTIVE: {
            SYSTEM.LH: directx_perspectiveLH,
            SYSTEM.RH: directx_perspectiveRH,
        },
        PROJECTION_TYPE.ORTHOGRAPHIC: {},
    },
    SUBSYSTEM.OPENGL: {
        PROJECTION_TYPE.PERSPECTIVE: {
            SYSTEM.LH: opengl_perspectiveLH,
            SYSTEM.RH: opengl_perspectiveRH,
        },
        PROJECTION_TYPE.ORTHOGRAPHIC: {
            SYSTEM.LH: opengl_orthographicLH,
        },
    },
}
