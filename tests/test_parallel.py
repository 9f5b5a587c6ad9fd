"""Multi-chip sharding tests on the virtual 8-device CPU mesh (conftest)."""
import numpy as np
import pytest

import jax

import tpu_renderer as tr
from tpu_renderer.models.gizmos import floor_texture, make_cube, make_floor
from tpu_renderer.parallel.mesh import make_render_mesh
from tpu_renderer.parallel.sharded import render_frame_sharded
from tpu_renderer.ops.pipeline import render_frame_jit
from tpu_renderer.scenes import flagship_figure


def _scene(resolution=(64, 64)):
    cube = make_cube(1.0)
    cube.shadowing = True          # gizmo factories default to non-casting
    floor = make_floor(2.0, y=-0.6)
    floor.textures.register("diffuse", floor_texture(seed=5, size=64),
                            normalize=False)
    light = tr.Light((3, 4, 2), light_type=tr.Lightning.POINT_LIGHTNING,
                     ambient_strength=0.1, specular_strength=0.3)
    cam = tr.Camera((2, 2.5, 4), center=(0, 0, 0), fovy=60, near=0.01, far=50,
                    backface_culling=True)
    scene = tr.Scene(cam, light, shadows=True, resolution=resolution,
                     system=tr.SYSTEM.RH, subsystem=tr.SUBSYSTEM.OPENGL)
    scene.add_model(cube)
    scene.add_model(floor)
    return scene


def _cfg_dyn(scene):
    cfg, dyn = scene._prepare()
    return cfg, dyn


@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4)])
def test_sharded_matches_single_chip(shape):
    n_rows, n_tris = shape
    assert len(jax.devices()) >= n_rows * n_tris
    scene = _scene()
    cfg, dyn = _cfg_dyn(scene)

    single, zb1, tid1, st1 = render_frame_jit(cfg, dyn)
    mesh = make_render_mesh(jax.devices()[:n_rows * n_tris], n_tris=n_tris)
    sharded, zb2, tid2, st2 = render_frame_sharded(cfg, dyn, mesh)

    single = np.asarray(single)
    sharded = np.asarray(sharded)
    # Equal-z claims may tie-break differently across the tris axis; require
    # pixel-exact agreement on >= 99.9% and tiny diffs elsewhere.
    same = (single == sharded).all(axis=-1)
    assert same.mean() >= 0.999, f"only {same.mean():.4f} identical"
    np.testing.assert_array_equal(np.asarray(st1), np.asarray(st2))
    np.testing.assert_allclose(np.asarray(zb1), np.asarray(zb2), rtol=1e-6)


def test_stencil_content_nontrivial():
    scene = _scene()
    cfg, dyn = _cfg_dyn(scene)
    _, _, _, st = render_frame_jit(cfg, dyn)
    st = np.asarray(st)
    assert (st != 0).any(), "shadow stencil should mark some pixels"


def test_sharded_prepare_quads_compacts_per_shard():
    """Tris-sharded silhouette compaction: prepare_quads must return
    PER-SHARD tables (O(E / n_shards) rows per chip, silhouettes compacted
    into the [:cap] prefix), and the shards' ok rows must partition the
    global silhouette set exactly — same count and same projected screen
    geometry as the single-chip tables."""
    from jax.sharding import PartitionSpec as P

    from tpu_renderer.ops.pipeline import _cam_matrices
    from tpu_renderer.ops.shadow import prepare_quads
    from tpu_renderer.parallel.mesh import TRIS_AXIS
    from tpu_renderer.parallel.sharded import (dyn_partition_specs,
                                               pad_models_for_tris, shard_map)

    d = flagship_figure(textured=False)
    light = tr.Light((5, 5, 0), light_type=tr.Lightning.POINT_LIGHTNING,
                     center=(0, 0.5, 0.5), ambient_strength=0.1)
    cam = tr.Camera((0.5, 3, 5), center=(0, 0, 0), fovy=90, near=1e-4,
                    far=400)
    scene = tr.Scene(cam, light, shadows=True, resolution=(256, 192),
                     system=tr.SYSTEM.LH, subsystem=tr.SUBSYSTEM.OPENGL)
    scene.add_model(d)
    cfg, dyn = _cfg_dyn(scene)
    cam_m = _cam_matrices(cfg, dyn["camera"], cfg.cam_projection_type)
    e_total = sum(mc.num_edges for mc in cfg.models if mc.shadowing)

    # Single-chip reference tables.
    s1, c1, ok1, n_sil1, caps1 = jax.jit(
        lambda dd: prepare_quads(cfg, dd, cam_m))(dyn)
    ok1 = np.asarray(ok1)
    n_sil1 = int(n_sil1)
    assert caps1 is not None and n_sil1 <= max(caps1), \
        "scene must hit compaction"

    n_tris = 4
    mesh = make_render_mesh(jax.devices()[:n_tris], n_tris=n_tris)
    dyn_p = pad_models_for_tris(dyn, n_tris, cfg.chunk)
    caps = {}

    def local(dd, cm):
        out = prepare_quads(cfg, dd, cm, axis_name=TRIS_AXIS,
                            shard_idx=jax.lax.axis_index(TRIS_AXIS))
        caps["cap"] = out[4]
        return out[:4]

    fn = shard_map(
        local, mesh,
        in_specs=(dyn_partition_specs(dyn_p, n_tris),
                  jax.tree_util.tree_map(lambda _: P(), cam_m)),
        out_specs=(P(TRIS_AXIS), P(TRIS_AXIS), P(TRIS_AXIS), P()))
    s4, c4, ok4, n_sil4 = jax.jit(fn)(dyn_p, cam_m)
    cap4 = max(caps["cap"])          # largest compaction level
    fs = s4.shape[0] // n_tris

    # O(E / n_shards): each shard's whole table is strictly smaller than the
    # global edge list, and the compacted prefix is smaller still.
    assert fs < e_total, f"per-shard table {fs} not smaller than E={e_total}"
    assert cap4 is not None and cap4 < fs
    assert int(n_sil4) == n_sil1

    ok4 = np.asarray(ok4)
    # Global silhouette set partitioned exactly once across shards.
    assert ok4.sum() == ok1.sum() == n_sil1
    # Compact branch taken (n_sil <= cap4 * n_tris): every ok row must sit
    # in its shard's [:cap4] prefix.
    assert n_sil1 <= cap4 * n_tris
    in_prefix = np.zeros(s4.shape[0], bool)
    for i in range(n_tris):
        in_prefix[i * fs:i * fs + cap4] = True
    assert not (ok4 & ~in_prefix).any(), "ok rows outside compacted prefix"
    # Identical projected geometry: multiset of ok screen polygons matches
    # the single-chip tables bit-for-bit (same f32 expressions).
    rows1 = np.asarray(s1)[ok1].reshape(n_sil1, -1)
    rows4 = np.asarray(s4)[ok4].reshape(n_sil1, -1)
    order1 = np.lexsort(rows1.T)
    order4 = np.lexsort(rows4.T)
    np.testing.assert_array_equal(rows1[order1], rows4[order4])
