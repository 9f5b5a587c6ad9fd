"""Golden tests: skybox/cubemap, orthographic projection, MTL materials."""
import os

import numpy as np
import pytest

import tpu_renderer as tr
from tests.test_golden import CAM_KW, DEBUG_CAM_KW, LIGHT_KW, RES, compare

OBJ = "/root/reference/obj"
SKYBOX = {side: os.path.join(OBJ, "skybox", f"{side}.jpg")
          for side in ("back", "bottom", "front", "left", "right", "top")}


def test_cubemap_getitem_matches_reference(reference):
    ref_cm = reference.cube_map.CubeMap(**SKYBOX)
    ours_cm = tr.CubeMap(**SKYBOX)
    np.testing.assert_allclose(ours_cm.textures, ref_cm.textures, atol=1e-6)
    rng = np.random.default_rng(7)
    dirs = rng.normal(size=(500, 3)).astype(np.float64)
    ref_tex = ref_cm[dirs]
    ours_tex = ours_cm[dirs]
    match = (np.abs(ref_tex - ours_tex) < 1e-5).all(axis=-1).mean()
    assert match > 0.99  # borderline texel picks may differ in f32


def _scenes(reference, skymap_ref, skymap_ours, cam_extra=None):
    cam_kw = dict(CAM_KW, **(cam_extra or {}))
    model = tr.Model.load_model(os.path.join(OBJ, "diablo3_pose",
                                             "diablo3_pose.obj"))
    scene = tr.Scene(tr.Camera(**cam_kw),
                     tr.Light(light_type=tr.Lightning.DIRECTIONAL_LIGHTNING,
                              **LIGHT_KW),
                     shadows=True, debug_camera=tr.Camera(**cam_kw),
                     resolution=RES, system=tr.SYSTEM.LH,
                     subsystem=tr.SUBSYSTEM.OPENGL, skymap=skymap_ours)
    scene.add_model(model)

    ref_model = reference.core.Model.load_model(
        os.path.join(OBJ, "diablo3_pose", "diablo3_pose.obj"))
    ref_scene = reference.core.Scene(
        reference.core.Camera(**cam_kw),
        reference.core.Light(
            light_type=reference.Lightning.DIRECTIONAL_LIGHTNING, **LIGHT_KW),
        shadows=True, debug_camera=reference.core.Camera(**cam_kw),
        resolution=RES, system=reference.transformation.SYSTEM.LH,
        subsystem=reference.transformation.SUBSYSTEM.OPENGL,
        skymap=skymap_ref)
    ref_scene.add_model(ref_model)
    return scene, ref_scene


def test_golden_skybox(reference, ref_render):
    # Must build the CubeMap from the class object core.py imported —
    # isinstance() in Scene.render (core.py:595) checks module identity.
    scene, ref_scene = _scenes(reference,
                               reference.core.CubeMap(**SKYBOX),
                               tr.CubeMap(**SKYBOX))
    ref = ref_render("skybox",
                     dict(light=LIGHT_KW, cam=CAM_KW, sky=SKYBOX, res=RES),
                     ref_scene.render)
    compare(scene.render(), ref, "skybox")


def test_golden_solid_background(reference, ref_render):
    scene, ref_scene = _scenes(reference, [0.1, 0.2, 0.3], [0.1, 0.2, 0.3])
    ref = ref_render("solid_bg",
                     dict(light=LIGHT_KW, cam=CAM_KW, bg=[0.1, 0.2, 0.3],
                          res=RES),
                     ref_scene.render)
    compare(scene.render(), ref, "solid_bg")


def test_golden_orthographic(reference, ref_render):
    extra = dict(projection_type=tr.PROJECTION_TYPE.ORTHOGRAPHIC,
                 position=(0.5, 1.0, 2.0), fovy=30)
    scene, ref_scene = _scenes(reference, None, None, cam_extra=extra)
    # ORTHOGRAPHIC forces near = |position| in both (core.py:387).
    assert np.isclose(scene.camera.near, ref_scene.camera.near)
    # Root-caused in round 3 (tools/exp_ortho.py): the gap was never "ortho
    # depth rounding" — debug camera == main camera puts the frustum-cube
    # corners exactly ON the clip planes, so the overlay's clip decisions
    # are sign-marginal and must run in f64 like the reference
    # (frustums.py). With the f64 overlay path: 0.9957 within ±2, mean
    # 0.077.
    #
    # The remaining 97/22500 pixels are CLASSIFIED (round 4, exp_ortho):
    # all 97 on geometry; 87 are shadow-stencil tie flips (ours ambient
    # [33,33,33] vs ref lit or vice versa) on the shadow-quad boundary
    # bands, 67 on silhouette (tid) edges. Ortho maps the whole mesh to a
    # nearly constant linearized depth (z = -0.0116 +- 1e-5 at every bad
    # pixel, near=|position|, far=400), so the quad-vs-surface depth test
    # margin sits below f32 epsilon where the reference computes it in f64
    # (core.py:590) — a tie-break class, not a shading error. The
    # assertion below pins that bound: every deviating pixel must lie on a
    # tid edge, a shadow boundary, or inside the shadow band.
    ours = scene.render()
    ref = ref_render("ortho", dict(light=LIGHT_KW, cam=CAM_KW, extra=extra,
                                   res=RES), ref_scene.render)
    compare(ours, ref, "ortho", good_frac=0.995, mean_tol=0.2)

    B = 5
    bad = (np.abs(ours[B:-B, B:-B].astype(np.int32) -
                  ref[B:-B, B:-B].astype(np.int32)).max(-1) > 2)
    tid = np.asarray(scene.last_tid)[::-1][B:-B, B:-B]
    stencil = np.asarray(scene.last_stencil)[::-1][B:-B, B:-B]

    def boundary(m):
        e = np.zeros_like(m, bool)
        e[1:] |= m[1:] != m[:-1]
        e[:-1] |= m[:-1] != m[1:]
        e[:, 1:] |= m[:, 1:] != m[:, :-1]
        e[:, :-1] |= m[:, :-1] != m[:, 1:]
        return e

    allowed = boundary(tid) | boundary(stencil > 0) | (stencil > 0)
    stray = bad & ~allowed
    assert stray.sum() <= 3, (
        f"{stray.sum()} deviating pixels outside the edge/shadow tie-flip "
        f"classes at {np.argwhere(stray)[:5]}")


def test_golden_mtl_cube(reference, ref_render):
    """cube.obj loads its MTL (container texture) — per-material maps."""
    cam_kw = dict(position=(1.5, 1.5, 2.5), center=(0.5, 0.5, 0.5), fovy=60,
                  near=0.01, far=50, backface_culling=True)
    path = os.path.join(OBJ, "obj_loader_test", "cube.obj")

    model = tr.Model.load_model(path)
    scene = tr.Scene(tr.Camera(**cam_kw),
                     tr.Light((3, 4, 2), light_type=tr.Lightning.POINT_LIGHTNING,
                              ambient_strength=0.1),
                     shadows=True, debug_camera=tr.Camera(**cam_kw),
                     resolution=RES, system=tr.SYSTEM.LH,
                     subsystem=tr.SUBSYSTEM.OPENGL)
    scene.add_model(model)

    ref_model = reference.core.Model.load_model(path)
    ref_scene = reference.core.Scene(
        reference.core.Camera(**cam_kw),
        reference.core.Light((3, 4, 2),
                             light_type=reference.Lightning.POINT_LIGHTNING,
                             ambient_strength=0.1),
        shadows=True, debug_camera=reference.core.Camera(**cam_kw),
        resolution=RES, system=reference.transformation.SYSTEM.LH,
        subsystem=reference.transformation.SUBSYSTEM.OPENGL)
    ref_scene.add_model(ref_model)
    ref = ref_render("mtl_cube", dict(cam=cam_kw, path=path, res=RES),
                     ref_scene.render)
    compare(scene.render(), ref, "mtl_cube")


def test_golden_chained_transforms_multimodel(reference, ref_render):
    """Two models with @-chained scale/translation/rotate transforms
    (BASELINE config 4; reference core.py:350-352, main.py:43-62)."""
    cam_kw = dict(position=(1.5, 2.0, 3.5), center=(0, 0, 0), fovy=70,
                  near=0.01, far=100, backface_culling=False)
    cube_path = os.path.join(OBJ, "obj_loader_test", "cube.obj")
    diablo_path = os.path.join(OBJ, "diablo3_pose", "diablo3_pose.obj")

    d = tr.Model.load_model(diablo_path)
    d = d @ tr.scale(0.8) @ tr.translation([0.4, 0, 0]) @ tr.rotate_xyz([0, 30, 0])
    c = tr.Model.load_model(cube_path)
    c = c @ tr.scale(0.4) @ tr.translation([-1.0, 0.2, 0.5])
    scene = tr.Scene(tr.Camera(**cam_kw),
                     tr.Light((4, 5, 1), ambient_strength=0.15),
                     shadows=True, debug_camera=tr.Camera(**cam_kw),
                     resolution=RES, system=tr.SYSTEM.LH,
                     subsystem=tr.SUBSYSTEM.OPENGL)
    scene.add_model(d)
    scene.add_model(c)

    rt = reference.transformation
    rd = reference.core.Model.load_model(diablo_path)
    rd = rd @ rt.scale(0.8) @ rt.translation([0.4, 0, 0]) @ rt.rotate_xyz([0, 30, 0])
    rc = reference.core.Model.load_model(cube_path)
    rc = rc @ rt.scale(0.4) @ rt.translation([-1.0, 0.2, 0.5])
    ref_scene = reference.core.Scene(
        reference.core.Camera(**cam_kw),
        reference.core.Light((4, 5, 1), ambient_strength=0.15),
        shadows=True, debug_camera=reference.core.Camera(**cam_kw),
        resolution=RES, system=rt.SYSTEM.LH,
        subsystem=rt.SUBSYSTEM.OPENGL)
    ref_scene.add_model(rd)
    ref_scene.add_model(rc)
    ref = ref_render("chained_multimodel", dict(cam=cam_kw, res=RES),
                     ref_scene.render)
    compare(scene.render(), ref, "chained_multimodel")


@pytest.mark.parametrize("system_name", ["LH", "RH"])
def test_golden_directx_subsystem(reference, ref_render, system_name):
    """DirectX projection family x handedness (transformation.py:346-352)."""
    system = getattr(tr.SYSTEM, system_name)
    ref_system = getattr(reference.transformation.SYSTEM, system_name)
    cam_kw = dict(CAM_KW)
    # A debug camera identical to the main one puts the frustum overlay
    # exactly on the clip planes — f32-vs-f64 luck decides each dash. Use the
    # distinct debug camera for a deterministic overlay.
    dbg_kw = dict(DEBUG_CAM_KW)
    model = tr.Model.load_model(os.path.join(OBJ, "diablo3_pose",
                                             "diablo3_pose.obj"))
    scene = tr.Scene(tr.Camera(**cam_kw),
                     tr.Light(light_type=tr.Lightning.DIRECTIONAL_LIGHTNING,
                              **LIGHT_KW),
                     shadows=True, debug_camera=tr.Camera(**dbg_kw),
                     resolution=RES, system=system,
                     subsystem=tr.SUBSYSTEM.DIRECTX)
    scene.add_model(model)

    ref_model = reference.core.Model.load_model(
        os.path.join(OBJ, "diablo3_pose", "diablo3_pose.obj"))
    ref_scene = reference.core.Scene(
        reference.core.Camera(**cam_kw),
        reference.core.Light(
            light_type=reference.Lightning.DIRECTIONAL_LIGHTNING, **LIGHT_KW),
        shadows=True, debug_camera=reference.core.Camera(**dbg_kw),
        resolution=RES, system=ref_system,
        subsystem=reference.transformation.SUBSYSTEM.DIRECTX)
    ref_scene.add_model(ref_model)
    ref = ref_render(f"directx_{system_name}",
                     dict(light=LIGHT_KW, cam=cam_kw, dbg=dbg_kw,
                          system=system_name, res=RES),
                     ref_scene.render)
    compare(scene.render(), ref, f"directx_{system_name}")


def _write_ten_boxes(tmp_path):
    """Ten distinct textured box OBJs (our objwrite exporter), loadable by
    both loaders: bright per-model procedural textures (distinct hue +
    seeded noise, so a stack/slot mixup across models is visible), 2x5
    grid."""
    from PIL import Image

    from tpu_renderer.utils.objwrite import write_textured_box

    paths = []
    for i in range(10):
        tex = os.path.join(tmp_path, f"tex{i}.png")
        rng = np.random.default_rng(100 + i)
        base = np.array([(i * 53) % 256, (i * 97 + 80) % 256,
                         (255 - i * 23) % 256], np.float64)
        img = np.clip(base * (0.55 + 0.45 * rng.random((48, 48, 1))), 0,
                      255).astype(np.uint8)
        Image.fromarray(img).save(tex)
        r, c = divmod(i, 5)
        center = ((c - 2) * 0.8, 0.35 * r - 0.2, -0.6 * r)
        paths.append(write_textured_box(
            os.path.join(tmp_path, f"box{i}.obj"), tex, size=0.62,
            center=center))
    return paths


# near/far chosen like CAM_KW so the identical debug camera's frustum
# overlay lands on the screen border (excluded by compare()'s interior).
TEN_CAM = dict(position=(0.1, 2.2, 3.6), center=(0, 0, -0.4), fovy=65,
               near=0.0001, far=400, backface_culling=False)


def test_golden_ten_distinct_models(reference, ref_render, tmp_path):
    """Heterogeneous-scene scaling (10 distinct textured models): the
    per-model where-chains in _shade must keep reference parity."""
    paths = _write_ten_boxes(str(tmp_path))

    scene = tr.Scene(tr.Camera(**TEN_CAM),
                     tr.Light((3, 5, 2), ambient_strength=0.15),
                     shadows=True, debug_camera=tr.Camera(**TEN_CAM),
                     resolution=RES, system=tr.SYSTEM.LH,
                     subsystem=tr.SUBSYSTEM.OPENGL)
    for p in paths:
        scene.add_model(tr.Model.load_model(p))
    ours = scene.render()

    def _ref():
        ref_scene = reference.core.Scene(
            reference.core.Camera(**TEN_CAM),
            reference.core.Light((3, 5, 2), ambient_strength=0.15),
            shadows=True, debug_camera=reference.core.Camera(**TEN_CAM),
            resolution=RES, system=reference.transformation.SYSTEM.LH,
            subsystem=reference.transformation.SUBSYSTEM.OPENGL)
        for p in paths:
            ref_scene.add_model(reference.core.Model.load_model(p))
        return ref_scene.render()

    # Key on the box/texture recipe, not tmp_path (fresh every run).
    ref = ref_render("ten_models", dict(cam=TEN_CAM, res=RES, n=10,
                                        boxes="imgpng-64-grid2x5-v1"), _ref)
    compare(ours, ref, "ten_models")

