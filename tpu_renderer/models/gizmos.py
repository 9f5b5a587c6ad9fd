"""Procedural meshes and textures: floor, sphere, camera gizmo, figure.

The reference references assets that are absent from its repo (gitignored
``*.obj``): ``floor.obj`` (main.py:48), ``obj_loader_test/sphere.obj`` and
``obj_loader_test/camera.obj`` (core.py:533, 547 — the Light/Camera ``show``
gizmos). These factories generate equivalent meshes procedurally so every demo
scene is reproducible (SURVEY.md §7 step 8).

``make_noise_figure`` and the ``*_texture`` generators stand in for the
reference's demo character (a ~5k-face textured, normal-mapped mesh whose
files are not part of this repository): same face budget, closed surface,
concave silhouettes, 1024² diffuse and tangent-space normal maps — all made
from a seed, with no image files.
"""
from __future__ import annotations

import numpy as np

from tpu_renderer.models.model import Model

__all__ = ["make_floor", "make_sphere", "make_camera_gizmo", "make_cube",
           "make_icosphere", "make_noise_figure", "noise_diffuse_texture",
           "noise_normal_texture", "floor_texture"]


def make_floor(size: float = 2.0, y: float = 0.0, uv_tiles: float = 1.0) -> Model:
    """A two-triangle quad in the XZ plane, UV-mapped, normals up."""
    s = float(size)
    vertices = np.array([
        [-s, y, -s, 1.0],
        [s, y, -s, 1.0],
        [s, y, s, 1.0],
        [-s, y, s, 1.0],
    ], dtype=np.float32)
    t = float(uv_tiles)
    uv = np.array([[0, 0, 0], [t, 0, 0], [t, t, 0], [0, t, 0]], dtype=np.float32)
    normals = np.array([[0, 1, 0]] * 4, dtype=np.float32)
    # Corner layout [vertex, uv, normal, material] (see Model.faces).
    faces = np.array([
        [[0, 0, 0, 0], [2, 2, 2, 0], [1, 1, 1, 0]],
        [[0, 0, 0, 0], [3, 3, 3, 0], [2, 2, 2, 0]],
    ], dtype=np.int32)
    return Model(vertices, uv, normals, faces, shadowing=False)


def make_sphere(subdiv_lat: int = 12, subdiv_lon: int = 18,
                radius: float = 1.0) -> Model:
    """UV sphere (used as the Light gizmo replacing sphere.obj, core.py:533)."""
    lats = np.linspace(0, np.pi, subdiv_lat + 1)
    lons = np.linspace(0, 2 * np.pi, subdiv_lon, endpoint=False)
    verts, norms, uvs = [], [], []
    for i, th in enumerate(lats):
        for j, ph in enumerate(lons):
            n = np.array([np.sin(th) * np.cos(ph), np.cos(th),
                          np.sin(th) * np.sin(ph)])
            verts.append([*(radius * n), 1.0])
            norms.append(n)
            uvs.append([j / subdiv_lon, 1 - i / subdiv_lat, 0])

    def vid(i, j):
        return i * subdiv_lon + (j % subdiv_lon)

    faces = []
    for i in range(subdiv_lat):
        for j in range(subdiv_lon):
            a, b = vid(i, j), vid(i, j + 1)
            c, d = vid(i + 1, j + 1), vid(i + 1, j)
            if i > 0:
                faces.append([[a, a, a, 0], [b, b, b, 0], [c, c, c, 0]])
            if i < subdiv_lat - 1:
                faces.append([[a, a, a, 0], [c, c, c, 0], [d, d, d, 0]])
    return Model(np.array(verts, np.float32), np.array(uvs, np.float32),
                 np.array(norms, np.float32), np.array(faces, np.int32),
                 shadowing=False)


def make_cube(size: float = 1.0) -> Model:
    """Axis-aligned cube, one quad per face (fan-triangulated)."""
    s = float(size) / 2
    corners = np.array([[x, y, z, 1.0]
                        for x in (-s, s) for y in (-s, s) for z in (-s, s)],
                       dtype=np.float32)
    # (corner ids, outward normal) per face; CCW seen from outside.
    quads = [
        ((1, 5, 7, 3), (0, 0, 1)), ((4, 0, 2, 6), (0, 0, -1)),
        ((5, 4, 6, 7), (1, 0, 0)), ((0, 1, 3, 2), (-1, 0, 0)),
        ((3, 7, 6, 2), (0, 1, 0)), ((0, 4, 5, 1), (0, -1, 0)),
    ]
    normals = np.array([n for _, n in quads], dtype=np.float32)
    uv = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], dtype=np.float32)
    faces = []
    for fi, (q, _) in enumerate(quads):
        for tri in ((0, 1, 2), (0, 2, 3)):
            faces.append([[q[k], k, fi, 0] for k in tri])
    return Model(corners, uv, normals, np.array(faces, np.int32), shadowing=False)


def make_camera_gizmo(size: float = 1.0) -> Model:
    """Small frustum-shaped mesh replacing the reference's missing camera.obj."""
    s = float(size)
    vertices = np.array([
        [0, 0, 0, 1],                              # apex
        [-s, -s, 2 * s, 1], [s, -s, 2 * s, 1],
        [s, s, 2 * s, 1], [-s, s, 2 * s, 1],
    ], dtype=np.float32)
    tris = [(0, 2, 1), (0, 3, 2), (0, 4, 3), (0, 1, 4), (1, 2, 3), (1, 3, 4)]
    faces = np.array([[[v, -1, -1, 0] for v in tri] for tri in tris],
                     dtype=np.int32)
    return Model(vertices, None, None, faces, shadowing=False)


# Regular icosahedron: 12 vertices, 20 faces wound counter-clockwise seen
# from outside.
_ICO_T = (1.0 + 5.0 ** 0.5) / 2.0
_ICO_VERTS = np.array([
    (-1, _ICO_T, 0), (1, _ICO_T, 0), (-1, -_ICO_T, 0), (1, -_ICO_T, 0),
    (0, -1, _ICO_T), (0, 1, _ICO_T), (0, -1, -_ICO_T), (0, 1, -_ICO_T),
    (_ICO_T, 0, -1), (_ICO_T, 0, 1), (-_ICO_T, 0, -1), (-_ICO_T, 0, 1),
], np.float64)
_ICO_FACES = np.array([
    (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
    (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
    (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
    (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
], np.int64)


def make_icosphere(level: int = 4):
    """Unit icosphere: (V, 3) float64 positions, (F, 3) int64 faces.

    Each level splits every triangle into four at shared edge midpoints, so
    the mesh stays welded and closed (every edge borders exactly two faces)
    with 20 * 4**level faces. Winding stays counter-clockwise from outside.
    """
    verts = _ICO_VERTS / np.linalg.norm(_ICO_VERTS, axis=1, keepdims=True)
    faces = _ICO_FACES
    for _ in range(level):
        edges = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                                faces[:, [2, 0]]])
        key = np.sort(edges, axis=1)
        uniq, inv = np.unique(key, axis=0, return_inverse=True)
        mid = verts[uniq[:, 0]] + verts[uniq[:, 1]]
        mid /= np.linalg.norm(mid, axis=1, keepdims=True)
        m = len(verts) + inv.reshape(3, -1)          # ab, bc, ca midpoints
        ab, bc, ca = m[0], m[1], m[2]
        a, b, c = faces[:, 0], faces[:, 1], faces[:, 2]
        faces = np.concatenate([
            np.stack([a, ab, ca], 1), np.stack([b, bc, ab], 1),
            np.stack([c, ca, bc], 1), np.stack([ab, bc, ca], 1)])
        verts = np.concatenate([verts, mid])
    return verts, faces


def _sin_field(rng, points, n_terms, freq_lo, freq_hi):
    """Sum of ``n_terms`` random sinusoids over (..., D) points, in [-1, 1]."""
    d = points.shape[-1]
    out = np.zeros(points.shape[:-1])
    for _ in range(n_terms):
        direction = rng.normal(size=d)
        direction /= np.linalg.norm(direction)
        freq = rng.uniform(freq_lo, freq_hi)
        out += np.sin(points @ (freq * direction) + rng.uniform(0, 2 * np.pi))
    return out / n_terms


def make_noise_figure(seed: int = 0) -> Model:
    """A closed, welded, radially noise-displaced icosphere standing like a
    figure (about 1.1 x 1.8 x 1.1, centered at the origin).

    The displacement is smooth but strong enough for concave silhouettes
    and self-shadowing. UVs are spherical per face corner; faces that
    straddle the u = 0/1 seam carry u < 0 on their far corners, which the
    sampler's negative-index wrap (core.py:141-143) maps back across the
    seam. Vertex normals are area-weighted face normals. Casts shadows.
    """
    rng = np.random.default_rng(seed)
    unit, faces = make_icosphere(4)
    radius = 1.0 + 0.3 * _sin_field(rng, unit, 6, 2.0, 5.0)
    pos = unit * radius[:, None] * np.array([0.55, 0.9, 0.55])

    a, b, c = (pos[faces[:, k]] for k in range(3))
    fn = np.cross(b - a, c - a)                    # area-weighted normals
    vn = np.zeros_like(pos)
    for k in range(3):
        np.add.at(vn, faces[:, k], fn)
    vn /= np.linalg.norm(vn, axis=1, keepdims=True)

    u = 0.5 + np.arctan2(unit[:, 2], unit[:, 0]) / (2 * np.pi)
    v = 0.5 + np.arcsin(np.clip(unit[:, 1], -1, 1)) / np.pi
    cu = u[faces]                                  # (F, 3) per corner
    seam = (cu.max(1) - cu.min(1)) > 0.5
    cu = np.where(seam[:, None] & (cu > 0.5), cu - 1.0, cu)
    uv = np.stack([cu.ravel(), v[faces].ravel(),
                   np.zeros(cu.size)], axis=1)

    n_f = len(faces)
    corner = np.arange(3 * n_f).reshape(n_f, 3)
    face_array = np.stack([faces, corner, faces, np.zeros_like(faces)],
                          axis=2).astype(np.int32)
    verts = np.concatenate([pos, np.ones((len(pos), 1))], axis=1)
    return Model(verts.astype(np.float32), uv.astype(np.float32),
                 vn.astype(np.float32), face_array, shadowing=True)


def _texture_grid(size):
    """(size, size, 2) texel coordinates in [0, 2*pi): integer frequencies
    of them tile seamlessly across the u and v wrap."""
    t = np.arange(size) * (2 * np.pi / size)
    return np.stack(np.meshgrid(t, t, indexing="ij"), axis=-1)


def _quantize(img):
    """Round to 8-bit levels, like a texture read from an image file."""
    return np.round(np.clip(img, 0.0, 1.0) * 255.0).astype(np.float32) / 255.0


def _tile_field(rng, grid, n_terms, max_freq):
    out = np.zeros(grid.shape[:2])
    for _ in range(n_terms):
        k = rng.integers(1, max_freq + 1, size=2) * rng.choice([-1, 1], 2)
        out += np.sin(grid @ k + rng.uniform(0, 2 * np.pi))
    return out / n_terms


def noise_diffuse_texture(seed: int = 0, size: int = 1024) -> np.ndarray:
    """(size, size, 3) seamless diffuse map in [0, 1], 8-bit levels."""
    rng = np.random.default_rng(seed)
    grid = _texture_grid(size)
    base = rng.uniform(0.25, 0.75, size=3)
    accent = rng.uniform(0.1, 0.9, size=3)
    s = 0.5 + 0.5 * _tile_field(rng, grid, 5, 6)
    fine = _tile_field(rng, grid, 4, 40)
    img = base * (1 - s[..., None]) + accent * s[..., None]
    return _quantize(img + 0.08 * fine[..., None])


def noise_normal_texture(seed: int = 0, size: int = 1024) -> np.ndarray:
    """(size, size, 3) seamless tangent-space normal map, encoded in [0, 1]
    (register with ``normalize=True, tangent=True``), 8-bit levels."""
    rng = np.random.default_rng(seed)
    grid = _texture_grid(size)
    h = _tile_field(rng, grid, 6, 24)
    dh_dv, dh_du = np.gradient(h * size / (2 * np.pi))
    n = np.stack([-0.6 * dh_du, -0.6 * dh_dv, np.ones_like(h)], axis=-1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return _quantize((n + 1.0) / 2.0)


def floor_texture(seed: int = 0, size: int = 512) -> np.ndarray:
    """(size, size, 3) seamless tiled-floor diffuse map in [0, 1]."""
    rng = np.random.default_rng(seed)
    grid = _texture_grid(size)
    checker = (np.sin(8 * grid[..., 0]) * np.sin(8 * grid[..., 1])) > 0
    tint = rng.uniform(0.3, 0.8, size=3)
    img = np.where(checker[..., None], tint, tint * 0.55)
    return _quantize(img + 0.06 * _tile_field(rng, grid, 4, 30)[..., None])
