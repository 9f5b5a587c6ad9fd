"""Frustum-plane math and polygon clipping.

JAX equivalent of the reference's ``obj/plane_intersection.py``:
Gribb–Hartmann plane extraction from an MVP matrix (row-vector convention, so
planes come from matrix *columns*), and Sutherland–Hodgman polygon clipping.

The reference clips one polygon at a time with Python lists
(plane_intersection.py:59-86). Here clipping is a **fixed-size, jit-traceable**
kernel over padded vertex buffers, so thousands of shadow-volume quads clip in one
vectorized device op (``jax.vmap(clip_polygon)``): each plane pass emits, per input
edge, up to two candidate vertices (current vertex if visible; edge/plane
intersection on visibility change) and compacts them with a stable prefix-position
key sort — the same output order as the reference's sequential appends.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from tpu_renderer.ops.transforms import dot, normalize

__all__ = [
    "normalize_plane", "extract_frustum_planes", "line_plane_intersection",
    "is_visible", "clipping", "clip_polygon", "get_parameterized",
    "LEFT", "RIGHT", "BOTTOM", "TOP", "NEAR", "FAR", "P_MAX",
]

# Plane indices (reference plane_intersection.py:10-15).
LEFT, RIGHT, BOTTOM, TOP, NEAR, FAR = range(6)

#: Padded vertex capacity for clipped polygons. A convex quad clipped by 6 planes
#: has at most 4 + 6 = 10 vertices; 16 leaves slack.
P_MAX = 16


def normalize_plane(plane):
    """Scale plane coefficients to unit norm (plane_intersection.py:17-21)."""
    return normalize(jnp.asarray(plane))


def extract_frustum_planes(matrix):
    """Frustum planes [left, right, bottom, top, near, far] from a row-vector MVP.

    Gribb–Hartmann extraction (reference plane_intersection.py:43-56): with the
    row-vector convention, plane k is a combination of the matrix's *columns*.
    """
    m = jnp.asarray(matrix)
    col = lambda i: m[..., i]
    planes = jnp.stack([
        col(3) + col(0),   # left
        col(3) - col(0),   # right
        col(3) + col(1),   # bottom
        col(3) - col(1),   # top
        col(3) + col(2),   # near
        col(3) - col(2),   # far
    ])
    return normalize(planes)


def extract_frustum_planes_host(matrix):
    """Numpy twin of :func:`extract_frustum_planes` for the host overlay
    path: with an f64 MVP composed by numpy, the planes come out
    bit-identical to the reference's (plane_intersection.py:43-56), which
    the overlay's sign-marginal clip decisions require."""
    import numpy as np

    m = np.asarray(matrix)
    col = lambda i: m[..., i]
    planes = np.stack([
        col(3) + col(0),
        col(3) - col(0),
        col(3) + col(1),
        col(3) - col(1),
        col(3) + col(2),
        col(3) - col(2),
    ])
    return planes / np.linalg.norm(planes, axis=-1, keepdims=True)


def line_plane_intersection(p1, p2, plane):
    """Intersection of segment ``p1 -> p2`` with a plane.

    Jit-traceable version of plane_intersection.py:24-36: returns
    ``(point, valid)`` instead of ``None``; ``valid`` is False for parallel
    segments (|denominator| < 1e-10) or intersections outside [0, 1].
    """
    p1 = jnp.asarray(p1)
    p2 = jnp.asarray(p2)
    direction = p2 - p1
    denom = dot(plane, direction)
    parallel = jnp.abs(denom) < 1e-10
    weight = -dot(plane, p1) / jnp.where(parallel, 1.0, denom)
    valid = (~parallel) & (weight >= 0) & (weight <= 1)
    return p1 + weight * direction, valid


def is_visible(point, plane):
    """Half-space test (plane_intersection.py:39-40)."""
    return dot(plane, point) >= 0


def _clip_one_plane(verts, count, plane):
    """One Sutherland–Hodgman pass over a padded polygon.

    verts: (P_MAX, 4) float32 padded vertex buffer; count: active vertex count.
    Emits per input edge i < count: the current vertex when visible, then the
    edge/plane intersection on a visibility transition — exactly the reference's
    append order (plane_intersection.py:69-83).

    The next vertex comes from a static roll + wrap select instead of a
    per-element gather, and kept candidates compact via a stable key sort
    (prefix position, dropped slots keyed last) — values move verbatim, unlike
    a one-hot contraction, whose f32 exactness needs precision="highest".
    Slots past the new count keep whatever the sort left there; clip_polygon
    zeroes them once at the end.
    """
    n = verts.shape[0]
    idx = jnp.arange(n)
    active = idx < count
    cur = verts
    nxt = jnp.where((idx + 1 >= count)[:, None], verts[0:1],
                    jnp.roll(verts, -1, axis=0))

    dist_cur = dot(cur, plane)
    dist_nxt = dot(nxt, plane)
    cur_vis = dist_cur >= 0
    nxt_vis = dist_nxt >= 0

    # Intersection of (nxt -> cur) with the plane, matching the reference's
    # argument order line_plane_intersection(next_vertex, current_vertex, plane).
    direction = cur - nxt
    denom = dot(direction, plane)
    parallel = jnp.abs(denom) < 1e-10
    weight = -dist_nxt / jnp.where(parallel, 1.0, denom)
    ip = nxt + weight[:, None] * direction
    ip_valid = (~parallel) & (weight >= 0) & (weight <= 1)

    emit_cur = active & cur_vis
    emit_ip = active & (cur_vis ^ nxt_vis) & ip_valid

    # Interleave candidates in reference order: cur_0, ip_0, cur_1, ip_1, ...
    cand = jnp.stack([cur, ip], axis=1).reshape(2 * n, 4)
    flags = jnp.stack([emit_cur, emit_ip], axis=1).reshape(2 * n)
    pos = jnp.cumsum(flags) - 1
    out_count = flags.sum()
    key = jnp.where(flags, pos, 2 * n)
    ordered = jax.lax.sort([key] + [cand[:, c] for c in range(4)],
                           num_keys=1)
    out = jnp.stack(ordered[1:], axis=-1)[:n]
    return out, out_count


def clip_polygon(verts, count, planes):
    """Clip a padded convex polygon by a stack of planes, fully on device.

    verts: (P_MAX, 4); count: scalar int; planes: (K, 4).
    Returns (clipped_verts (P_MAX, 4), new_count).
    """
    verts = jnp.asarray(verts, jnp.float32)
    count = jnp.asarray(count, jnp.int32)
    planes = jnp.asarray(planes, jnp.float32)

    def body(carry, plane):
        v, c = carry
        v2, c2 = _clip_one_plane(v, c, plane)
        return (v2, c2.astype(jnp.int32)), None

    # Plane count is tiny and static: unroll to avoid while-loop overhead.
    (verts, count), _ = jax.lax.scan(body, (verts, count), planes,
                                     unroll=True)
    # The per-plane sort compaction leaves stale values past the count; zero
    # them so callers see the same dead-slot contents as before.
    verts = jnp.where((jnp.arange(verts.shape[0]) < count)[:, None],
                      verts, 0.0)
    return verts, count


def clipping(polygon_vertices, clipping_planes):
    """Reference-compatible host clipper (plane_intersection.py:59-86).

    Takes an (N, 4) polygon, returns the clipped (M, 4) polygon (M dynamic).
    Useful outside jit (debug overlays, tests).

    Runs Sutherland–Hodgman in float64 numpy, keeping the reference's exact
    decision arithmetic: visibility is ``plane @ point >= 0``, a crossing
    edge intersects from *next* towards *current* vertex
    (plane_intersection.py:81), segments parallel to the plane
    (|denominator| < 1e-10) or with weight outside [0, 1] contribute no
    vertex. f64 matters: the debug-overlay frustum corners can lie exactly
    on the clip planes (debug camera == main camera), where an f32 clip
    flips whole dashed segments relative to the reference.
    """
    import numpy as np

    poly = [np.asarray(v, np.float64) for v in polygon_vertices]
    for plane in np.asarray(clipping_planes, np.float64):
        kept = []
        n = len(poly)
        for i in range(n):
            cur = poly[i]
            nxt = poly[(i + 1) % n]
            cur_in = plane @ cur >= 0
            nxt_in = plane @ nxt >= 0
            if cur_in:
                kept.append(cur)
            if cur_in != nxt_in:
                d = cur - nxt
                denom = plane @ d
                if abs(denom) >= 1e-10:
                    w = -(plane @ nxt) / denom
                    if 0 <= w <= 1:
                        kept.append(nxt + w * d)
        poly = kept
    return np.array(poly)


def get_parameterized(planes):
    """Print planes as GeoGebra-pasteable equations (plane_intersection.py:89-97)."""
    import numpy as np

    for plane in np.asarray(planes):
        coords = "xyz "
        eq = " + ".join(f"{coef:.2f}{var}" for coef, var in zip(plane, coords))
        print(eq.replace("+ -", "- ") + "= 0")
