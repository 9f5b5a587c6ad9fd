"""Asset IO layer vs the reference oracle (SURVEY.md §7 step 2)."""
import os

import numpy as np
import pytest

from tpu_renderer.models.material import Material
from tpu_renderer.models.model import EdgeTable, Model
from tpu_renderer.models import gizmos
from tpu_renderer.ops import transforms as T

CUBE_PATH = "/root/reference/obj/obj_loader_test/cube.obj"


@pytest.fixture(scope="module")
def diablo(diablo_path):
    return Model.load_model(diablo_path)


@pytest.fixture(scope="module")
def figure():
    """The generated ~5k-face stand-in for the reference's demo mesh."""
    return gizmos.make_noise_figure(seed=0)


def test_load_diablo_matches_reference(reference, diablo, diablo_path):
    ref = reference.core.Model.load_model(diablo_path)
    np.testing.assert_array_equal(diablo.vertices, ref.vertices)
    np.testing.assert_array_equal(diablo.uv, ref.uv)
    np.testing.assert_array_equal(diablo.normals, ref.normals)
    np.testing.assert_array_equal(diablo.face_array, ref._faces)
    assert diablo.vertices.shape == (2519, 4)
    assert diablo.face_array.shape[0] == 5022  # SURVEY.md §6 geometry facts


def test_load_cube_with_mtl(reference):
    ours = Model.load_model(CUBE_PATH)
    ref = reference.core.Model.load_model(CUBE_PATH)
    np.testing.assert_array_equal(ours.vertices, ref.vertices)
    np.testing.assert_array_equal(ours.face_array, ref._faces)
    assert set(ours.materials) == set(ref.materials)
    assert ours.material_group == ref.material_group
    # MTL scalar/vector coercion parity for a parsed material.
    for name, mat in ref.materials.items():
        for key in ("Ns", "Ka", "Kd", "Ks"):
            if key in mat.__dict__:
                np.testing.assert_allclose(
                    np.asarray(getattr(ours.materials[name], key)),
                    np.asarray(getattr(mat, key)))


def test_texture_register_matches_reference(reference, diablo, diablo_path):
    ref = reference.core.Model.load_model(diablo_path)
    base = os.path.dirname(diablo_path)
    for m, normalize in ((diablo, True), (ref, True)):
        m.textures.register("normals", os.path.join(base, "diablo3_pose_nm_tangent.tga"),
                            tangent=True)
        m.textures.register("diffuse", os.path.join(base, "diablo3_pose_diffuse.tga"),
                            normalize=False)
    ours_mat, ref_mat = diablo.materials["default"], ref.materials["default"]
    np.testing.assert_allclose(ours_mat.map_Kd, ref_mat.map_Kd, atol=1e-6)
    np.testing.assert_allclose(ours_mat.norm, ref_mat.norm, atol=1e-6)
    assert ours_mat.norm.dtype.metadata["tangent"] is True
    assert diablo.normal_map_is_tangent


def test_material_alias_fixed():
    m = Material()
    # Reference's alias path raises TypeError (materials.py:75); ours resolves.
    np.testing.assert_array_equal(m.diffuse, m.Kd)
    m.map_Kd = np.zeros((2, 2, 3), np.float32)
    assert m.diffuse is m.map_Kd
    with pytest.raises(AttributeError):
        m.not_an_attribute  # noqa: B018


def test_matmul_is_pure(figure):
    before = figure.vertices.copy()
    moved = figure @ T.scale(2.0) @ T.translation([1, 0, 0])
    np.testing.assert_array_equal(figure.vertices, before)
    assert moved is not figure
    expected = before @ np.asarray(T.scale(2.0)) @ np.asarray(T.translation([1, 0, 0]))
    np.testing.assert_allclose(moved.vertices, expected, atol=1e-4)


def _reference_silhouette(reference, model, light):
    container = set()
    for face in model.faces:
        reference.triangular.shadow_volumes(face, light, container)
    return container


def test_edge_table_silhouette_parity(reference, diablo, diablo_path):
    """Batched parity silhouette == reference's per-face XOR set."""
    ref_model = reference.core.Model.load_model(diablo_path)
    light = reference.core.Light(position=(5, 5, 0), center=(0, 0.5, 0.5))
    ref_silhouette = _reference_silhouette(reference, ref_model, light)

    et = diablo.edge_table
    fv = diablo.face_array[:, :, 0]
    v = diablo.vertices[:, :3]
    a, b, c = v[fv[:, 0]], v[fv[:, 1]], v[fv[:, 2]]
    n = np.cross(b - a, c - a)
    n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-30)
    light_facing = n @ np.asarray(light.position, np.float32) > 0

    inc_lf = np.repeat(light_facing, 3)
    parity = np.zeros(et.num_edges, np.int64)
    np.add.at(parity, et.incidence_edge, inc_lf.astype(np.int64))
    ours = {frozenset(et.incidence_dir[i])
            for i in range(len(et.incidence_edge))
            if parity[et.incidence_edge[i]] % 2 == 1}
    theirs = {frozenset(e) for e in ref_silhouette}
    assert ours == theirs
    assert len(theirs) > 100  # sanity: a real silhouette


def test_edge_table_direction_semantics(figure):
    """Every incidence direction is one of the edge's two orientations."""
    et = figure.edge_table
    fv = figure.face_array[:, :, 0]
    assert et.incidence_edge.shape == (3 * len(fv),)
    assert et.incidence_dir.shape == (3 * len(fv), 2)
    # Directed pairs reconstruct the face loops.
    np.testing.assert_array_equal(
        et.incidence_dir[:, 0].reshape(-1, 3), fv)
    np.testing.assert_array_equal(
        et.incidence_dir[:, 1].reshape(-1, 3), np.roll(fv, -1, axis=1))


def test_gizmos_well_formed():
    for m in (gizmos.make_floor(), gizmos.make_sphere(6, 8),
              gizmos.make_cube(), gizmos.make_camera_gizmo()):
        assert m.vertices.ndim == 2 and m.vertices.shape[1] == 4
        assert m.face_array.ndim == 3 and m.face_array.shape[1:] == (3, 4)
        assert m.face_array[:, :, 0].max() < len(m.vertices)
        et = m.edge_table  # adjacency builds without error
        assert et.num_edges > 0


def test_render_stats():
    """Batched per-model stats (reference's Errors tally, core.py:634-636)."""
    import tpu_renderer as tr
    from tpu_renderer.models.gizmos import make_cube, make_floor

    cube = make_cube(1.0)
    floor = make_floor(2.0, y=-0.6)
    scene = tr.Scene(tr.Camera((2, 2.5, 4), center=(0, 0, 0), fovy=60,
                               near=0.01, far=50, backface_culling=True),
                     tr.Light((3, 4, 2)), resolution=(64, 64),
                     system=tr.SYSTEM.RH, subsystem=tr.SUBSYSTEM.OPENGL)
    scene.add_model(cube)
    scene.add_model(floor)
    scene.render()
    stats = scene.stats()
    assert len(stats) == 2
    assert stats[0]["total"] == 12
    assert stats[1]["total"] == 2
    # Backface culling discards roughly half the cube.
    assert 3 <= stats[0]["backface_culled"] <= 9
    assert stats[0]["rendered"] >= 1
    assert stats[1]["rendered"] >= 1
    for s in stats:
        assert (s["rendered"] + s["backface_culled"] + s["degenerate"]
                + s["offscreen"] + s["occluded_or_clipped"]) >= s["total"] - 1


def test_model_silhouette_helper(reference, diablo, diablo_path):
    """Model.silhouette() equals the reference's XOR set, Edge semantics."""
    from tpu_renderer.models.model import Edge

    ref_model = reference.core.Model.load_model(diablo_path)
    light = reference.core.Light(position=(5, 5, 0), center=(0, 0.5, 0.5))
    ref_set = _reference_silhouette(reference, ref_model, light)
    ours = diablo.silhouette((5, 5, 0))
    assert {frozenset(e) for e in ours} == {frozenset(e) for e in ref_set}
    assert Edge((3, 7)) == Edge((7, 3))
    assert hash(Edge((3, 7))) == hash(Edge((7, 3)))


def test_empty_scene_renders_background():
    import tpu_renderer as tr

    scene = tr.Scene(tr.Camera((0, 0, 2), center=(0, 0, 0)),
                     tr.Light((1, 1, 1)), resolution=(32, 64),
                     system=tr.SYSTEM.RH, subsystem=tr.SUBSYSTEM.OPENGL)
    frame = scene.render()
    # Uniform default background (core.py:600) after flip+gamma.
    assert frame.shape == (32, 64, 3)
    assert (frame == frame[0, 0]).all()


def test_model_without_uv_or_normals():
    """Camera gizmo mesh: no vt/vn at all; falls back to face normals."""
    import tpu_renderer as tr
    from tpu_renderer.models.gizmos import make_camera_gizmo

    m = make_camera_gizmo(0.5)
    assert m.uv is None and m.normals is None
    scene = tr.Scene(tr.Camera((1.5, 1, 2), center=(0, 0, 0.5), fovy=70,
                               near=0.01, far=20, backface_culling=False),
                     tr.Light((2, 3, 2), ambient_strength=0.2),
                     resolution=(48, 64), system=tr.SYSTEM.RH,
                     subsystem=tr.SUBSYSTEM.OPENGL)
    scene.add_model(m)
    frame = scene.render()
    assert frame.std() > 0


def test_animated_vertices_no_recompile():
    """Moving a model's vertices re-renders without recompiling."""
    import jax
    import tpu_renderer as tr
    from tpu_renderer.models.gizmos import make_cube
    from tpu_renderer.ops import transforms as T

    cube = make_cube(1.0)
    scene = tr.Scene(tr.Camera((2, 2, 4), center=(0, 0, 0), fovy=60,
                               near=0.01, far=50),
                     tr.Light((3, 4, 2), ambient_strength=0.2),
                     resolution=(32, 64), system=tr.SYSTEM.RH,
                     subsystem=tr.SUBSYSTEM.OPENGL)
    scene.add_model(cube)
    f0 = scene.render()
    from tpu_renderer.ops.pipeline import render_frame_jit
    misses = render_frame_jit._cache_miss_count if hasattr(
        render_frame_jit, "_cache_miss_count") else None

    # Animate: replace the model's vertices in place (per-frame motion).
    moved = cube @ T.translation([0.5, 0, 0])
    cube.vertices = moved.vertices
    f1 = scene.render()
    assert (f0 != f1).any()
    # And the camera: same compiled program.
    scene.camera.set_position((3, 1, 3))
    f2 = scene.render()
    assert (f1 != f2).any()


def test_scene_independence():
    """Two scenes sharing a model don't corrupt each other (the reference's
    Bound descriptor shares state across Scene instances, core.py:527-529)."""
    import tpu_renderer as tr
    from tpu_renderer.models.gizmos import make_cube

    cube = make_cube(1.0)
    kw = dict(resolution=(32, 64), system=tr.SYSTEM.RH,
              subsystem=tr.SUBSYSTEM.OPENGL)
    s1 = tr.Scene(tr.Camera((2, 2, 4), center=(0, 0, 0)),
                  tr.Light((3, 4, 2), ambient_strength=0.2), **kw)
    s2 = tr.Scene(tr.Camera((-2, 2, 4), center=(0, 0, 0)),
                  tr.Light((-3, 4, 2), ambient_strength=0.6), **kw)
    s1.add_model(cube)
    s2.add_model(cube)
    f1a = s1.render()
    f2 = s2.render()
    f1b = s1.render()
    np.testing.assert_array_equal(f1a, f1b)   # s2 didn't corrupt s1
    assert (f1a != f2).any()
    assert s1.camera.scene is s1 or s2.camera.scene is s2


def test_nan_debug_scope():
    from tpu_renderer.utils.profiling import nan_debug
    import jax
    import jax.numpy as jnp

    with nan_debug():
        assert jax.config.jax_debug_nans
        with pytest.raises(FloatingPointError):
            jnp.log(jnp.zeros(3) - 1.0).block_until_ready()
    assert not jax.config.jax_debug_nans


def test_texture_register_after_render_takes_effect():
    """Registering a texture after the first render must not be silently
    ignored by the packet cache."""
    import tpu_renderer as tr
    from tpu_renderer.models.gizmos import make_floor

    floor = make_floor(2.0, y=-0.5)
    scene = tr.Scene(tr.Camera((0, 2, 2.5), center=(0, -0.5, 0), fovy=70,
                               near=0.01, far=50),
                     tr.Light((2, 4, 1), ambient_strength=0.3),
                     resolution=(48, 64), system=tr.SYSTEM.RH,
                     subsystem=tr.SUBSYSTEM.OPENGL)
    scene.add_model(floor)
    before = scene.render()
    floor.textures.register("diffuse", gizmos.floor_texture(seed=1, size=32),
                            normalize=False)
    after = scene.render()
    assert (before != after).any()


def test_texture_register_array_matches_file(tmp_path):
    """An (H, W, 3) array in [0, 1] registers exactly like the same image
    read from a file, for color maps and normalized tangent normal maps."""
    Image = pytest.importorskip("PIL.Image")
    img = gizmos.noise_normal_texture(seed=3, size=48)
    path = str(tmp_path / "nm.png")
    Image.fromarray(np.round(img * 255).astype(np.uint8)).save(path)

    from_file, from_array = gizmos.make_cube(), gizmos.make_cube()
    for model, src in ((from_file, path), (from_array, img)):
        model.textures.register("normals", src, tangent=True)
        model.textures.register("diffuse", src, normalize=False)
    a = from_file.materials["default"]
    b = from_array.materials["default"]
    np.testing.assert_array_equal(a.map_Kd, b.map_Kd)
    np.testing.assert_array_equal(a.norm, b.norm)
    assert b.norm.dtype.metadata["tangent"] is True
    with pytest.raises(ValueError):
        gizmos.make_cube().textures.register("diffuse", img[..., :2])
