"""Render the showcase gallery (the reference keeps one in obj/img/).

    python examples/gallery.py [outdir]

Every shot is built from generated meshes and textures (tpu_renderer.scenes).
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import tpu_renderer as tr
from tpu_renderer.models.gizmos import make_cube, noise_diffuse_texture
from tpu_renderer.scenes import flagship_figure as figure
from tpu_renderer.scenes import flagship_floor as textured_floor
from tpu_renderer.utils.compile_cache import enable_compile_cache
from tpu_renderer.utils.image import save_frame

RES = (640, 640)


def textured_cube():
    c = make_cube(1.0)
    c.textures.register("diffuse", noise_diffuse_texture(5, 256),
                        normalize=False)
    return c


def cam(**kw):
    base = dict(position=(0.5, 3, 5), center=(0, 0, 0), fovy=90, near=1e-4,
                far=400, backface_culling=False)
    return tr.Camera(**{**base, **kw})


def scene(*models, light=None, **kw):
    base = dict(resolution=RES, system=tr.SYSTEM.LH,
                subsystem=tr.SUBSYSTEM.OPENGL)
    light = light or tr.Light((5, 5, 0), ambient_strength=0.1,
                              specular_strength=0.1,
                              light_type=tr.Lightning.POINT_LIGHTNING,
                              center=(0, 0.5, 0.5), linear=1e-9,
                              quadratic=1e-10)
    s = tr.Scene(kw.pop("camera", cam()), light, **{**base, **kw})
    for m in models:
        s.add_model(m)
    return s


def main(outdir="gallery"):
    enable_compile_cache()
    os.makedirs(outdir, exist_ok=True)
    shots = {}

    shots["01_shadow_volumes"] = scene(figure(), textured_floor(),
                                       shadows=True)
    shots["02_normal_mapping"] = scene(figure(), camera=cam(
        position=(0.3, 1.2, 2.2), center=(0, 0.4, 0), fovy=50))
    shots["03_skybox"] = scene(
        figure(), textured_floor(), shadows=True,
        skymap=tr.CubeMap(**{s: noise_diffuse_texture(10 + i, 256)
                             for i, s in enumerate(
                                 ("back", "bottom", "front", "left", "right",
                                  "top"))}))
    shots["04_spot_light"] = scene(
        figure(), textured_floor(), shadows=True,
        light=tr.Light((3, 5, 2), light_type=tr.Lightning.SPOT_LIGHTNING,
                       center=(0, 0, 0), ambient_strength=0.08,
                       specular_strength=0.3, linear=1e-9, quadratic=1e-10))
    shots["05_pbr"] = scene(figure(textured=False), shader="pbr", camera=cam(
        position=(0.3, 1.2, 2.2), center=(0, 0.4, 0), fovy=50))
    shots["06_wireframe"] = scene(figure(textured=False), shader="wireframe",
                                  camera=cam(position=(0.3, 1.0, 2.4),
                                             center=(0, 0.3, 0), fovy=55))
    shots["07_textured_cube"] = scene(
        textured_cube(),
        camera=cam(position=(1.6, 1.4, 2.4), center=(0.5, 0.5, 0.5), fovy=55,
                   backface_culling=True),
        light=tr.Light((3, 4, 2), ambient_strength=0.15))
    shots["08_frustum_overlay"] = scene(
        figure(), shadows=True,
        debug_camera=tr.Camera((0, 3, 0.01), center=(0, 0, 0), fovy=80,
                               near=1, far=3))
    shots["09_orthographic"] = scene(figure(), camera=cam(
        position=(0.5, 1.0, 2.0), fovy=30,
        projection_type=tr.PROJECTION_TYPE.ORTHOGRAPHIC))
    shots["10_gouraud"] = scene(figure(textured=False), shader="gouraud")

    for name, s in shots.items():
        frame = s.render()
        path = os.path.join(outdir, f"{name}.png")
        save_frame(frame, path)
        print("rendered", path, "mean", round(float(np.asarray(frame).mean()), 1))


if __name__ == "__main__":
    main(*sys.argv[1:2])
