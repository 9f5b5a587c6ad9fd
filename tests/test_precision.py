"""The one precision decision (tpu_renderer.precision): the package sets its
exact-f32 XLA flags at import, and the render programs hold no XLA dot."""
import dataclasses
import os

import jax
import pytest

import tpu_renderer as tr
from tpu_renderer import precision
from tpu_renderer.models.gizmos import noise_diffuse_texture
from tpu_renderer.ops import pipeline as P
from tpu_renderer.scenes import flagship_scene


def test_import_sets_exact_flags():
    flags = os.environ["XLA_FLAGS"].split()
    for flag in precision.EXACT_F32_XLA_FLAGS:
        assert flags.count(flag) == 1, flag
    assert precision.exact_f32_math_active()
    # Idempotent: a second call adds nothing.
    assert precision.use_exact_f32_math()
    assert os.environ["XLA_FLAGS"].split() == flags


def test_late_import_warns_and_reports_inactive(monkeypatch):
    """Backends already running without the flags: warn, report False,
    leave XLA_FLAGS alone (setting it now would change nothing)."""
    jax.devices()
    monkeypatch.setenv("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
    monkeypatch.setattr(precision, "_active", False)
    with pytest.warns(RuntimeWarning, match="import tpu_renderer first"):
        assert not precision.use_exact_f32_math()
    assert not precision.exact_f32_math_active()
    assert os.environ["XLA_FLAGS"] == "--xla_force_host_platform_device_count=8"


def _primitives(jaxpr, found):
    """Primitive names in ``jaxpr`` and its sub-jaxprs, except the matvec /
    transpose jaxprs of a linear solve (used only under differentiation)."""
    for eqn in jaxpr.eqns:
        found.add(eqn.primitive.name)
        if eqn.primitive.name == "custom_linear_solve":
            subs = [eqn.params["jaxprs"].solve]
        else:
            subs = [q for p in eqn.params.values()
                    for q in (p if isinstance(p, (list, tuple)) else [p])]
        for sub in subs:
            if hasattr(sub, "jaxpr") and hasattr(sub.jaxpr, "eqns"):
                _primitives(sub.jaxpr, found)
            elif hasattr(sub, "eqns"):
                _primitives(sub, found)
    return found


def _program(name):
    scene = flagship_scene((32, 32))
    if name == "skybox":
        scene.skybox = tr.CubeMap(**{
            side: noise_diffuse_texture(10 + i, 16) for i, side in enumerate(
                ("back", "bottom", "front", "left", "right", "top"))})
    cfg, dyn = scene._prepare()
    if name in ("wireframe", "points"):
        return lambda d: P.render_debug_frame(cfg, d, name), (dyn,)
    if name == "face_statistics":
        tid = P.render_frame_jit(cfg, dyn)[2]
        return lambda d, t: P.face_statistics(cfg, d, t), (dyn, tid)
    if name == "sharded":
        from tpu_renderer.parallel.mesh import make_render_mesh
        from tpu_renderer.parallel.sharded import render_frame_sharded
        mesh = make_render_mesh(jax.devices()[:4], n_tris=2)
        return lambda d: render_frame_sharded(cfg, d, mesh), (dyn,)
    if name != "skybox":
        cfg = dataclasses.replace(cfg, shader=name)
    return lambda d: P.render_frame(cfg, d), (dyn,)


@pytest.mark.parametrize("name", ["general", "flat", "gouraud", "pbr",
                                  "skybox", "wireframe", "points",
                                  "face_statistics", "sharded"])
def test_render_programs_hold_no_xla_dot(name):
    """Every contraction is an elementwise, index-ordered sum
    (transforms.dot / matmul), so no matmul precision or GEMM library
    decides how it rounds."""
    fn, args = _program(name)
    prims = _primitives(jax.make_jaxpr(fn)(*args).jaxpr, set())
    assert "scan" in prims or "select_n" in prims     # the walk saw the body
    assert "dot_general" not in prims
