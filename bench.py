"""Frame-rate benchmark: the flagship scene and BASELINE.json configs 1-6.

    python bench.py                  # flagship only
    python bench.py --all            # configs 1-6 first (one JSON line each)
    python bench.py --trace DIR      # also trace 3 flagship frames into DIR

The flagship is BASELINE.json config 5: a textured, normal-mapped ~5k-face
figure over a textured floor, point light, stencil shadow volumes, general
shader, 1024x1024, LH / OpenGL, camera orbiting the figure. Every scene is
built from the repository alone: meshes and textures are generated from
seeds (tpu_renderer.scenes, models/gizmos.py).

Each frame is one dispatch of the compiled frame program, synchronized with
``block_until_ready`` before the next (utils.profiling.orbit_times); the
end-to-end column also copies every frame to the host. An early line names
the device; the last line of standard output is one JSON object with the
flagship's numbers. With ``--trace``, lines before it give each device
stream's busy share over the 3 traced frames and its dominant XLA ops per
frame (utils.profiling.trace_orbit).
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from tpu_renderer.scenes import flagship_scene, orbit_positions

ORBIT_FRAMES = 30


def build_highpoly_scene(n_instances=20, resolution=(1024, 1024),
                         shadows=True, textured=True, merged=True,
                         cull=True, cam_height=4.5):
    """A grid of instanced copies of the flagship figure (5,120 faces each)
    over a floor — the triangle-count scaling config (SURVEY.md §6 names
    Mtri/s as a first-class metric). merged=True concatenates the instances
    into ONE mesh (Model.concat): one vertex stage and one silhouette
    reduction."""
    import tpu_renderer as tr
    from tpu_renderer.models.gizmos import floor_texture, make_floor
    from tpu_renderer.scenes import flagship_figure

    figure = flagship_figure(textured=textured)
    # Compute the edge table once on the base so instanced shallow copies
    # share it instead of re-deriving it per instance.
    figure.edge_table

    light = tr.Light((5, 8, 0), light_type=tr.Lightning.POINT_LIGHTNING,
                     center=(0, 0.5, 0.5), ambient_strength=0.1,
                     specular_strength=0.1, linear=1e-9, quadratic=1e-10)
    # cam_height 4.5 looks over the grid (every instance visible); ~1.5
    # looks THROUGH the crowd (rows occlude rows).
    camera = tr.Camera((0.5, cam_height, 8.5), center=(0, 0, 0), fovy=90,
                       near=0.0001, far=400, backface_culling=cull)
    scene = tr.Scene(camera, light, shadows=shadows, resolution=resolution,
                     system=tr.SYSTEM.LH, subsystem=tr.SUBSYSTEM.OPENGL)
    # Grid layout, slight scale / Y-rotation variation so silhouettes differ.
    side = int(np.ceil(np.sqrt(n_instances)))
    spacing = 2.2
    insts = []
    with tr.host_build():
        for i in range(n_instances):
            r, c = divmod(i, side)
            x = (c - (side - 1) / 2) * spacing
            z = (r - (side - 1) / 2) * spacing
            insts.append(figure @ tr.scale(0.9 + 0.2 * ((i * 7) % 5) / 4)
                         @ tr.rotate([0, (i * 37) % 360, 0])
                         @ tr.translation([x, 0, z]))
        merged_model = tr.Model.concat(insts) if merged else None
    if merged:
        scene.add_model(merged_model)
    else:
        for inst in insts:
            scene.add_model(inst)
    floor = make_floor(1.2 * side * spacing, y=-1.0)
    floor.textures.register("diffuse", floor_texture(2), normalize=False)
    scene.add_model(floor)
    return scene


def _orbit_row(scene, n_frames, positions=None):
    """Per-dispatch and host-copy timings of ``scene`` over ``n_frames``."""
    from tpu_renderer.utils.profiling import ms_summary, orbit_times

    cfg, dyn = scene._prepare()
    if positions is None:
        positions = np.broadcast_to(
            np.asarray(scene.camera.position, np.float32), (n_frames, 3))
    t0 = time.perf_counter()
    device = ms_summary(orbit_times(cfg, dyn, positions))
    compile_and_device_s = time.perf_counter() - t0
    host = ms_summary(orbit_times(cfg, dyn, positions, to_host=True))
    faces = sum(m.num_faces for m in scene.models)
    fps = 1e3 / device["median_ms"]
    return {"fps": fps, "ms_per_frame": device, "faces": faces,
            "mtri_per_s": faces * fps / 1e6,
            "e2e_ms_with_host_copy": host,
            "first_pass_s_incl_compile": compile_and_device_s}


def _print_trace(scene, positions, log_dir):
    """Trace the flagship over ``positions`` and print the summary."""
    from tpu_renderer.utils.profiling import trace_orbit

    cfg, dyn = scene._prepare()
    for row in trace_orbit(cfg, dyn, positions, log_dir):
        print(f"trace: {row['plane']} {row['line']!r}: {row['events']} "
              f"events in {len(positions)} frames, busy {row['busy_ms']:.3f} "
              f"of {row['window_ms']:.3f} ms (idle share "
              f"{1 - row['busy_share']:.4f})", flush=True)
        for ms, launches, name in row["ops"]:
            print(f"trace:   {ms:10.3f} ms/frame  x{launches:<8g} {name}",
                  flush=True)


def main(trace_dir=None):
    import jax

    from tpu_renderer.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    devices = jax.devices()
    print(json.dumps({"device_kind": devices[0].device_kind,
                      "platform": devices[0].platform,
                      "device_count": len(devices)}), flush=True)
    scene = flagship_scene()
    positions = orbit_positions(ORBIT_FRAMES)
    row = _orbit_row(scene, ORBIT_FRAMES, positions)
    if trace_dir:
        _print_trace(scene, positions[:3], trace_dir)
    result = {
        "metric": "fps@1024x1024 flagship shadow-volume scene (camera orbit)",
        "value": row["fps"],
        "unit": "fps",
        "method": "one block_until_ready dispatch per frame, median",
        "frames": ORBIT_FRAMES,
        **{k: v for k, v in row.items() if k != "fps"},
        "device_kind": devices[0].device_kind,
        "device_count": len(devices),
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
    }
    print(json.dumps(result), flush=True)


def _bench_scene(name, scene, n=15, positions=None):
    row = {"config": name, **_orbit_row(scene, n, positions)}
    print(json.dumps(row), flush=True)
    return row


def bench_all():
    """BASELINE.json configs 1-6, one JSON line each, all from generated
    assets (the flagship, config 5's 1024² single figure, is main())."""
    import tpu_renderer as tr
    from tpu_renderer.models import gizmos
    from tpu_renderer.scenes import flagship_figure, flagship_floor
    from tpu_renderer.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    # 1: figure @512², Gouraud, no shadows.
    cam = tr.Camera((0.5, 3, 5), center=(0, 0, 0), fovy=90, near=1e-4, far=400)
    s1 = tr.Scene(cam, tr.Light((5, 5, 0)), resolution=(512, 512),
                  system=tr.SYSTEM.LH, subsystem=tr.SUBSYSTEM.OPENGL,
                  shader="gouraud")
    s1.add_model(flagship_figure(textured=False))
    _bench_scene("1: figure 512 gouraud no-shadows", s1)

    # 2: textured figure + backface culling, perspective and orthographic.
    for proj, label in ((tr.PROJECTION_TYPE.PERSPECTIVE, "persp"),
                        (tr.PROJECTION_TYPE.ORTHOGRAPHIC, "ortho")):
        figure = flagship_figure(textured=False)
        figure.textures.register("diffuse", gizmos.noise_diffuse_texture(0),
                                 normalize=False)
        cam2 = tr.Camera((0.5, 3, 5), center=(0, 0, 0), fovy=45, near=1e-4,
                         far=400, backface_culling=True, projection_type=proj)
        s2 = tr.Scene(cam2, tr.Light((5, 5, 0), ambient_strength=0.1),
                      resolution=(512, 512), system=tr.SYSTEM.LH,
                      subsystem=tr.SUBSYSTEM.OPENGL)
        s2.add_model(figure)
        _bench_scene(f"2: textured figure backface {label}", s2)

    # 3: floor + textured cube, tangent normal mapping, spot light.
    floor = flagship_floor()
    floor.textures.register("normals", gizmos.noise_normal_texture(3, 512),
                            tangent=True)
    cube = gizmos.make_cube(1.0)
    cube.textures.register("diffuse", gizmos.noise_diffuse_texture(4, 256),
                           normalize=False)
    s3 = tr.Scene(tr.Camera((2, 2.5, 4), center=(0, 0, 0), fovy=60, near=0.01,
                            far=50),
                  tr.Light((3, 4, 2), light_type=tr.Lightning.SPOT_LIGHTNING,
                           ambient_strength=0.1),
                  resolution=(512, 512), system=tr.SYSTEM.LH,
                  subsystem=tr.SUBSYSTEM.OPENGL)
    s3.add_model(floor)
    s3.add_model(cube)
    _bench_scene("3: floor+cube normal-mapped spot", s3)

    # 4: skybox + multi-model chained transforms.
    with tr.host_build():
        f4 = (flagship_figure(textured=False) @ tr.scale(0.8)
              @ tr.translation([0.3, 0, 0]) @ tr.rotate([0, 20, 0]))
        c4 = gizmos.make_cube(0.6) @ tr.translation([-1, 0, 0.5])
    sky = tr.CubeMap(**{side: gizmos.noise_diffuse_texture(10 + i, 256)
                        for i, side in enumerate(
                            ("back", "bottom", "front", "left", "right",
                             "top"))})
    s4 = tr.Scene(tr.Camera((1.5, 2, 3.5), center=(0, 0, 0), fovy=70,
                            near=0.01, far=100),
                  tr.Light((4, 5, 1), ambient_strength=0.15),
                  resolution=(512, 512), system=tr.SYSTEM.LH,
                  subsystem=tr.SUBSYSTEM.OPENGL, skymap=sky)
    s4.add_model(f4)
    s4.add_model(c4)
    _bench_scene("4: skybox multi-model chained", s4)

    # 5 (scaled): triangle-count scaling — ~100k faces (20 instanced textured
    # figures, shadow volumes, backface culling like config 2), 1024².
    _bench_scene("5: 20 instanced figures 1024 highpoly shadows",
                 build_highpoly_scene(20), n=3)

    # 6: heterogeneous scene — TEN distinct textured boxes (distinct texture
    # stacks), 512². Program size grows with the per-model select depth.
    s6 = tr.Scene(tr.Camera((0.1, 2.2, 3.6), center=(0, 0, -0.4), fovy=65,
                            near=0.0001, far=400),
                  tr.Light((3, 5, 2), ambient_strength=0.15),
                  shadows=True, resolution=(512, 512), system=tr.SYSTEM.LH,
                  subsystem=tr.SUBSYSTEM.OPENGL)
    rng = np.random.default_rng(7)
    with tr.host_build():
        for i in range(10):
            base = np.array([(i * 53) % 256, (i * 97 + 80) % 256,
                             (255 - i * 23) % 256], np.float64)
            img = np.clip(base * (0.55 + 0.45 * rng.random((48, 48, 1))),
                          0, 255).astype(np.uint8) / 255.0
            r, c = divmod(i, 5)
            box = (gizmos.make_cube(0.62)
                   @ tr.translation([(c - 2) * 0.8, 0.35 * r - 0.2, -0.6 * r]))
            box.textures.register("diffuse", img, normalize=False)
            s6.add_model(box)
    _bench_scene("6: ten distinct textured models 512 shadows", s6)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--all", action="store_true",
                        help="BASELINE configs 1-6 before the flagship")
    parser.add_argument("--trace", metavar="DIR",
                        help="trace 3 flagship frames into DIR and summarize")
    args = parser.parse_args()
    if args.all:
        bench_all()
    main(args.trace)
