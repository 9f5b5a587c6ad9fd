"""The flagship scene built from the repository alone (tpu_renderer.scenes):
the generated figure mesh, its textures, and a small CPU render."""
import numpy as np

from tpu_renderer.models import gizmos
from tpu_renderer.scenes import flagship_scene, orbit_positions


def _edge_counts(face_vids):
    edges = np.concatenate([face_vids[:, [0, 1]], face_vids[:, [1, 2]],
                            face_vids[:, [2, 0]]])
    _, counts = np.unique(np.sort(edges, axis=1), axis=0, return_counts=True)
    return counts


def test_noise_figure_closed_and_deterministic():
    """At least the reference demo mesh's 5,024 faces; closed and welded
    (every edge borders exactly two faces, so shadow-volume silhouettes
    see no open edges); the same seed gives the same mesh."""
    a = gizmos.make_noise_figure(seed=0)
    b = gizmos.make_noise_figure(seed=0)
    c = gizmos.make_noise_figure(seed=1)
    assert a.num_faces == 5120
    fv = a.face_array[:, :, 0]
    assert (_edge_counts(fv) == 2).all()
    assert a.edge_table.num_edges == 3 * a.num_faces // 2
    np.testing.assert_array_equal(a.vertices, b.vertices)
    np.testing.assert_array_equal(a.face_array, b.face_array)
    np.testing.assert_array_equal(a.uv, b.uv)
    assert not np.array_equal(a.vertices, c.vertices)
    # Radial displacement: the figure is not a scaled sphere, and it has
    # concave edges (dents and saddles), hence concave silhouettes.
    r = np.linalg.norm(a.vertices[:, :3] / [0.55, 0.9, 0.55], axis=1)
    assert r.max() - r.min() > 0.3
    v = a.vertices[:, :3].astype(np.float64)
    n = np.cross(v[fv[:, 1]] - v[fv[:, 0]], v[fv[:, 2]] - v[fv[:, 0]])
    inc = np.argsort(a.edge_table.incidence_edge, kind="stable")
    i0, i1 = inc[0::2], inc[1::2]                  # the two sides of each edge
    f0, f1 = i0 // 3, i1 // 3
    opposite = fv[f1, (i1 % 3 + 2) % 3]            # f1's vertex off the edge
    concave = np.einsum("ij,ij->i", n[f0], v[opposite] - v[fv[f0, 0]]) > 0
    assert concave.mean() > 0.05


def test_icosphere_levels_stay_closed():
    for level in range(4):
        verts, faces = gizmos.make_icosphere(level)
        assert faces.shape == (20 * 4 ** level, 3)
        assert len(verts) == 10 * 4 ** level + 2
        assert (_edge_counts(faces) == 2).all()
        np.testing.assert_allclose(np.linalg.norm(verts, axis=1), 1.0)


def test_generated_textures_deterministic():
    """Diffuse / normal / floor maps: requested size, [0, 1] on 8-bit
    levels like an image file, reproducible per seed; the normal map
    decodes to unit vectors facing out of the surface."""
    for make, size in ((gizmos.noise_diffuse_texture, 256),
                       (gizmos.noise_normal_texture, 256),
                       (gizmos.floor_texture, 128)):
        t = make(seed=4, size=size)
        assert t.shape == (size, size, 3) and t.dtype == np.float32
        assert 0.0 <= t.min() and t.max() <= 1.0
        np.testing.assert_array_equal(np.round(t * 255) / 255, t)
        np.testing.assert_array_equal(t, make(seed=4, size=size))
        assert not np.array_equal(t, make(seed=5, size=size))
    n = gizmos.noise_normal_texture(seed=4, size=256) * 2 - 1
    np.testing.assert_allclose(np.linalg.norm(n, axis=-1), 1.0, atol=0.02)
    assert (n[..., 2] > 0).all()


def test_flagship_scene_renders_on_cpu():
    """The chip smoke test's scene at 128x128: the figure covers pixels,
    its shadow lands on the floor, and the stand-in has the flagship's
    parts (textured figure + textured floor, shadows, LH / OpenGL)."""
    scene = flagship_scene((128, 128))
    assert scene.shadows and len(scene.models) == 2
    figure, floor = scene.models
    mat = figure.materials["default"]
    assert mat.map_Kd.shape == (1024, 1024, 3)
    assert mat.norm.shape == (1024, 1024, 3) and figure.normal_map_is_tangent
    assert floor.materials["default"].map_Kd.shape == (512, 512, 3)

    frame = scene.render()
    assert frame.shape == (128, 128, 3) and frame.dtype == np.uint8
    n_fig = scene._prepare()[0].models[0].num_faces
    tid = np.asarray(scene.last_tid)
    stencil = np.asarray(scene.last_stencil)
    assert ((tid >= 0) & (tid < n_fig)).mean() > 0.002
    assert ((stencil != 0) & (tid >= n_fig)).sum() > 0


def test_orbit_positions():
    pos = orbit_positions(5)
    assert pos.shape == (5, 3) and pos.dtype == np.float32
    np.testing.assert_allclose(pos[:, 1], 3.0)
    np.testing.assert_allclose(np.hypot(pos[:, 0] - 0.5, pos[:, 2]), 5.05,
                               rtol=1e-6)
