"""Line/axis/overlay layer vs the reference oracle."""
import numpy as np
import pytest

import tpu_renderer as tr
from tpu_renderer.ops.lines import bresenham_line
from tpu_renderer.ops.overlay import Frustum, draw_axis

RNG = np.random.default_rng(5)


def test_bresenham_matches_reference(reference):
    for _ in range(20):
        a = RNG.uniform(-50, 200, size=4)
        b = RNG.uniform(-50, 200, size=4)
        ours = bresenham_line(a, b)
        ref = reference.triangular.bresenham_line(a, b)
        np.testing.assert_allclose(ours, ref, atol=1e-9)
    # Zero-length line returns the single point (line.py:12-13).
    p = np.array([3.0, 4.0, 5.0, 1.0])
    np.testing.assert_array_equal(bresenham_line(p, p), p[None])


def test_frustum_geometry_matches_reference(reference):
    ref = reference.frustums.Frustum if hasattr(reference, "frustums") else None
    if ref is None:
        import frustums as ref_mod
        ref = ref_mod.Frustum
    np.testing.assert_array_equal(Frustum.vertices, ref.vertices)
    np.testing.assert_array_equal(Frustum.edges, ref.edges)
    np.testing.assert_array_equal(Frustum.faces, ref.faces)
    np.testing.assert_array_equal(Frustum.triangles, ref.triangles)


def test_draw_axis_runs():
    cam = tr.Camera((2, 2, 4), center=(0, 0, 0), fovy=60, near=0.1, far=50)
    scene = tr.Scene(cam, tr.Light((1, 1, 1)), resolution=(96, 96),
                     system=tr.SYSTEM.RH, subsystem=tr.SUBSYSTEM.OPENGL)
    frame = np.zeros((96, 96, 3))
    zb = np.full((96, 96), np.inf)
    out = draw_axis(frame, {k: np.asarray(v) for k, v in
                            cam._matrices().items()}, zb, scene.system)
    assert out.shape == (96, 96, 3)
    assert out.max() > 0  # axes drawn


def test_light_gizmo_added():
    """Light(show=True) materializes a sphere model (reference Bound,
    core.py:532-544; its sphere.obj is absent so a procedural one stands in)."""
    cam = tr.Camera((2, 2, 4), center=(0, 0, 0), fovy=60, near=0.1, far=50)
    light = tr.Light((1.5, 1.5, 0), show=True, ambient_strength=0.2)
    scene = tr.Scene(cam, light, resolution=(96, 96), system=tr.SYSTEM.RH,
                     subsystem=tr.SUBSYSTEM.OPENGL)
    assert len(scene.models) == 1          # the gizmo
    assert scene.models[0].clip is False
    frame = scene.render()
    assert frame.std() > 0


def test_draw_line_matches_reference(reference):
    """ops/lines.py draw_line vs the executed reference (line.py:19-50):
    identical frame and z-buffer writes for segments that exercise the
    inverse-viewport clip test, the z test, and the +-1px AA half-blend.
    The reference itself never calls draw_line, but it is exported API here."""
    import types

    from tpu_renderer.ops.lines import draw_line

    res = (96, 96)
    cam = tr.Camera((0, 0, 5), center=(0, 0, 0), fovy=60, near=0.1, far=50)
    tr.Scene(cam, tr.Light((1, 1, 1)), resolution=res, system=tr.SYSTEM.RH,
             subsystem=tr.SUBSYSTEM.OPENGL)
    m = {k: np.asarray(v, np.float64) for k, v in cam._matrices().items()}

    ref_cam = types.SimpleNamespace(
        viewport=m["viewport"], scene=types.SimpleNamespace(resolution=res))

    # Screen-space segments (x, y, z, w): fully inside, z-blocked in a band,
    # partially outside the frustum (clip-test rejects the tail), zero length.
    segments = [
        (np.array([70.0, 20.0, 0.4, 1.0]), np.array([15.0, 80.0, 0.6, 1.0])),
        (np.array([10.0, 48.0, 0.5, 1.0]), np.array([90.0, 50.0, 0.5, 1.0])),
        (np.array([50.0, 5.0, 0.2, 1.0]), np.array([50.0, 140.0, 0.9, 1.0])),
        (np.array([33.0, 33.0, 0.5, 1.0]), np.array([33.0, 33.0, 0.5, 1.0])),
    ]

    frame_ours = np.zeros((*res, 3))
    zb_ours = np.full(res, np.inf)
    frame_ref = np.zeros((*res, 3))
    zb_ref = np.full(res, np.inf)
    # A near-z band blocks part of the second segment.
    zb_ours[45:55, 30:60] = 0.1
    zb_ref[45:55, 30:60] = 0.1

    for a, b in segments:
        draw_line(a, b, m, res, zb_ours, frame_ours)
        reference.line.draw_line(a, b, ref_cam, zb_ref, frame_ref)

    assert frame_ours.max() > 0            # something was drawn
    np.testing.assert_array_equal(frame_ours, frame_ref)
    np.testing.assert_array_equal(zb_ours, zb_ref)


def _host_dda_mask(p0, p1, h, w):
    """Pixels the host wireframe loop visits (overlay.draw_wireframe with
    an empty z-buffer): every DDA point, truncated, in the open interior."""
    mask = np.zeros((h, w), bool)
    for a, b in zip(p0, p1):
        for x, y, _ in bresenham_line(a, b):
            r, c = int(y), int(x)
            if 0 < r < h - 1 and 0 < c < w - 1:
                mask[r, c] = True
    return mask


def test_pack_lines_inverts_dda():
    """ops/lines.pack_lines + wireframe_mask (the device wireframe's closed
    form DDA inversion) light the pixels lines.bresenham_line walks, for
    random edges of every slope and direction, partly off-frame."""
    import jax.numpy as jnp

    from tpu_renderer.ops.lines import pack_lines, wireframe_mask

    h, w = 48, 64
    rng = np.random.default_rng(11)
    n = 60
    p0 = np.zeros((n, 3))
    p1 = np.zeros((n, 3))
    p0[:, :2] = rng.uniform(-10, 70, (n, 2))
    p1[:, :2] = rng.uniform(-10, 70, (n, 2))
    p1[:4, :2] = p0[:4, :2] + rng.uniform(-0.4, 0.4, (4, 2))   # sub-pixel
    p0[4, :2] = p1[4, :2] = (20.5, 30.25)                      # zero length
    p0, p1 = p0.astype(np.float32), p1.astype(np.float32)

    lines = pack_lines(jnp.asarray(p0), jnp.asarray(p1))
    device = np.asarray(wireframe_mask(lines, jnp.ones(n, bool),
                                       jnp.full((h, w), jnp.inf)))
    host = _host_dda_mask(p0.astype(np.float64), p1.astype(np.float64), h, w)
    assert host.sum() > 500
    # f32 closed form vs the host's f64 walk may truncate a boundary point
    # differently; everything else must agree.
    assert (device != host).sum() <= 0.01 * host.sum()
    assert device[30, 20]              # the zero-length edge's one pixel
    for k in range(4):                 # sub-pixel edges (0 < steps < 1)
        one = np.asarray(wireframe_mask(lines[k:k + 1], jnp.ones(1, bool),
                                        jnp.full((h, w), jnp.inf)))
        assert not one.any()


@pytest.mark.parametrize("shader", ["wireframe", "points"])
def test_device_debug_shaders_match_host(shader):
    """The device wireframe/points path (pipeline.render_debug_frame: closed
    form DDA inversion / scatter-max splat) against the host per-face loop
    implementation it replaced (Scene._render_debug_shader_host). f32 device
    math vs the host's f64 can flip trunc decisions on boundary pixels —
    require near-total agreement, not bit equality."""
    from tpu_renderer.models.gizmos import make_cube, make_floor

    cube = make_cube(1.0)
    floor = make_floor(2.0, y=-0.6)
    scene = tr.Scene(tr.Camera((2, 2.5, 4), center=(0, 0, 0), fovy=60,
                               near=0.01, far=50),
                     tr.Light((3, 4, 2), ambient_strength=0.1),
                     resolution=(96, 96), system=tr.SYSTEM.RH,
                     subsystem=tr.SUBSYSTEM.OPENGL, shader=shader)
    scene.add_model(cube)
    scene.add_model(floor)
    cfg, dyn = scene._prepare()

    device = scene._render_debug_shader(cfg, dyn)
    host = scene._render_debug_shader_host(cfg, dyn)
    assert device.shape == host.shape
    same = (device == host).all(axis=-1)
    assert same.mean() >= 0.98, f"only {same.mean():.4f} identical"
    # Both actually drew something beyond the background (the cube + floor
    # scene has only ~12 distinct vertex pixels for the points shader).
    bg = host[0, 0]
    floor_px = 5 if shader == "points" else 50
    assert (device != bg).any(axis=-1).sum() > floor_px
    assert (host != bg).any(axis=-1).sum() > floor_px
