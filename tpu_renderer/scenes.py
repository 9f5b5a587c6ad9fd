"""The flagship scene, built from the repository alone.

BASELINE.json config 5: a textured ~5k-face figure over a textured floor, a
point light, stencil shadow volumes, the general (Blinn-Phong) shader with a
diffuse map and a tangent-space normal map, 1024x1024, LH / OpenGL. The
figure and its textures are generated from a seed (models/gizmos.py), so the
scene needs no asset files. The benchmark, the GPU smoke test, the
``__graft_entry__`` hooks and the tests all build it here.
"""
from __future__ import annotations

import numpy as np

__all__ = ["flagship_figure", "flagship_floor", "flagship_scene",
           "orbit_positions"]


def flagship_figure(seed: int = 0, textured: bool = True):
    """The ~5k-face figure (5,120 faces), optionally with its seeded 1024²
    diffuse map and tangent-space normal map."""
    from tpu_renderer.models import gizmos

    figure = gizmos.make_noise_figure(seed)
    if textured:
        figure.textures.register(
            "diffuse", gizmos.noise_diffuse_texture(seed), normalize=False)
        figure.textures.register(
            "normals", gizmos.noise_normal_texture(seed + 1), tangent=True)
    return figure


def flagship_floor(seed: int = 0):
    """The 2x2, 2-triangle floor at y = -1 with its seeded 512² diffuse
    map."""
    from tpu_renderer.models import gizmos

    floor = gizmos.make_floor(2.0, y=-1.0)
    floor.textures.register("diffuse", gizmos.floor_texture(seed + 2),
                            normalize=False)
    return floor


def flagship_scene(resolution=(1024, 1024), seed: int = 0):
    """Figure + floor, point light, shadows on, LH / OpenGL."""
    import tpu_renderer as tr

    light = tr.Light((5, 5, 0), light_type=tr.Lightning.POINT_LIGHTNING,
                     center=(0, 0.5, 0.5), ambient_strength=0.1,
                     specular_strength=0.1, linear=1e-9, quadratic=1e-10)
    camera = tr.Camera((0.5, 3, 5), center=(0, 0, 0), fovy=90, near=0.0001,
                       far=400, backface_culling=False)
    scene = tr.Scene(camera, light, shadows=True, resolution=resolution,
                     system=tr.SYSTEM.LH, subsystem=tr.SUBSYSTEM.OPENGL)
    scene.add_model(flagship_figure(seed))
    scene.add_model(flagship_floor(seed))
    return scene


def orbit_positions(n_frames: int):
    """(n_frames, 3) float32 camera positions on the flagship's orbit: a
    circle of radius 5.05 at height 3 around (0.5, 3, 0), 0.1 rad apart."""
    t = 0.2 + 0.1 * np.arange(n_frames, dtype=np.float32)
    return np.stack([5.05 * np.sin(t) + 0.5, np.full_like(t, 3.0),
                     5.05 * np.cos(t)], axis=1).astype(np.float32)
