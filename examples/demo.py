"""Demo scene: the reference's main.py, on the JAX renderer.

Builds the reference demo's layout — a ~5k-face figure + floor with
tangent-space normal mapping, directional light, two cameras (main + debug)
and an optional skybox — from generated meshes and textures
(tpu_renderer.scenes), renders one frame, prints the render time, and
saves/shows the result.

    python examples/demo.py [--save out.png] [--show] [--resolution 1024]
                            [--skybox] [--shadows/--no-shadows]
                            [--shader general|flat|gouraud|pbr|wireframe|points]
                            [--orbit N]   # render N orbit frames, print fps
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import tpu_renderer as tr
from tpu_renderer.models.gizmos import noise_diffuse_texture
from tpu_renderer.scenes import flagship_figure, flagship_floor
from tpu_renderer.utils.compile_cache import enable_compile_cache
from tpu_renderer.utils.image import save_frame, show_frame
from tpu_renderer.utils.profiling import FrameTimer


def build_scene(args):
    figure = flagship_figure()
    floor = flagship_floor()

    light = tr.Light((5, 5, 0), light_type=tr.Lightning.DIRECTIONAL_LIGHTNING,
                     center=(0, 0.5, 0.5), fovy=90, linear=1e-9,
                     quadratic=1e-10, ambient_strength=0.1,
                     specular_strength=0.1)
    camera = tr.Camera((0.5, 3, 5), up=np.array((0, 1, 0)), fovy=90,
                       near=0.0001, far=400, backface_culling=False,
                       center=(0, 0, 0))
    debug_camera = tr.Camera((0, 3, 0.01), up=np.array((0, 1, 0)), fovy=80,
                             near=1, far=3, backface_culling=True,
                             center=(0, 0, 0))

    skymap = None
    if args.skybox:
        skymap = tr.CubeMap(**{side: noise_diffuse_texture(10 + i, 256)
                               for i, side in enumerate(
                                   ("back", "bottom", "front", "left",
                                    "right", "top"))})

    scene = tr.Scene(camera, light, shadows=args.shadows,
                     debug_camera=debug_camera if args.debug_camera else None,
                     resolution=(args.resolution, args.resolution),
                     system=tr.SYSTEM.LH, subsystem=tr.SUBSYSTEM.OPENGL,
                     skymap=skymap, shader=args.shader)
    scene.add_model(figure)
    scene.add_model(floor)
    return scene


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--save", default="demo.png")
    p.add_argument("--show", action="store_true")
    p.add_argument("--resolution", type=int, default=1024)
    p.add_argument("--skybox", action="store_true")
    p.add_argument("--shader", default="general")
    p.add_argument("--orbit", type=int, default=0)
    p.add_argument("--debug-camera", action="store_true")
    p.add_argument("--no-shadows", dest="shadows", action="store_false")
    p.set_defaults(shadows=True)
    args = p.parse_args()

    enable_compile_cache()
    scene = build_scene(args)
    start = time.time()
    picture = scene.render()
    print(f"render took {time.time() - start}")          # main.py:155

    if args.orbit:
        with FrameTimer() as t:
            for i in range(args.orbit):
                angle = 0.1 * i
                scene.camera.set_position(
                    (5.05 * np.sin(angle) + 0.5, 3.0, 5.05 * np.cos(angle)))
                t.frame(scene.render())
        print("orbit:", t.summary())

    if args.save:
        save_frame(picture, args.save)
        print("saved", args.save)
    if args.show:
        show_frame(picture)


if __name__ == "__main__":
    main()
