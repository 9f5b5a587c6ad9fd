"""Instancing: Model.concat merged geometry + multi-model texture dedup.

The reference has no instancing — each of its models re-runs the full
Python pipeline (core.py:592-614). Here instancing is first-class:
``Model.concat`` merges transformed copies into one mesh (one vertex stage,
one silhouette reduction). Merged and separate instances must render
identically. The mesh is the flagship scene's generated ~5k-face figure.
"""
import numpy as np
import pytest

import tpu_renderer as tr
from tpu_renderer.models import gizmos

RES = (96, 96)


def _figure(textured=True):
    m = gizmos.make_noise_figure(seed=0)
    if textured:
        m.textures.register("diffuse", gizmos.noise_diffuse_texture(0, 128),
                            normalize=False)
    return m


def _scene():
    light = tr.Light((5, 5, 0), light_type=tr.Lightning.POINT_LIGHTNING,
                     center=(0, 0.5, 0.5), ambient_strength=0.1,
                     specular_strength=0.1, linear=1e-9, quadratic=1e-10)
    camera = tr.Camera((0.5, 3, 6), center=(0, 0, 0), fovy=90, near=0.0001,
                       far=400, backface_culling=False)
    return tr.Scene(camera, light, shadows=True, resolution=RES,
                    system=tr.SYSTEM.LH, subsystem=tr.SUBSYSTEM.OPENGL)


def _instances(base, n=3):
    return [base @ tr.rotate([0, 40 * i, 0])
            @ tr.translation([1.6 * (i - (n - 1) / 2), 0, 0])
            for i in range(n)]


def test_concat_matches_multi_model():
    """Merged Model.concat geometry renders EXACTLY like the same instances
    added as separate scene models (face order, gids, depth ties, shadow
    silhouettes all line up)."""
    base = _figure()
    insts = _instances(base)

    s_multi = _scene()
    for m in insts:
        s_multi.add_model(m)
    f_multi = s_multi.render()

    s_merged = _scene()
    s_merged.add_model(tr.Model.concat(insts))
    f_merged = s_merged.render()

    assert f_merged.shape == f_multi.shape
    np.testing.assert_array_equal(f_merged, f_multi)


def test_concat_requires_shared_assets():
    base = _figure(textured=False)
    other = _figure(textured=False)   # separate load: different objects
    with pytest.raises(ValueError):
        tr.Model.concat([base, other])


def test_concat_offsets_vertices_only():
    base = _figure(textured=False)
    insts = [base @ tr.translation([i, 0, 0]) for i in range(3)]
    m = tr.Model.concat(insts)
    nv = len(base.vertices)
    fa = m.face_array
    assert m.num_faces == 3 * base.num_faces
    assert (fa[: base.num_faces * 1, :, 0] == base.face_array[:, :, 0]).all()
    assert (fa[base.num_faces: 2 * base.num_faces, :, 0]
            == base.face_array[:, :, 0] + nv).all()
    # uv / normal / material index columns untouched.
    np.testing.assert_array_equal(fa[:, :, 1:],
                                  np.tile(base.face_array[:, :, 1:], (3, 1, 1)))
