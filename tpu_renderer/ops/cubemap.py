"""Cubemap skyboxes: host-side texture assembly + device-side sampling.

Parity with the reference's ``obj/cube_map.py``: the 6 textures get the same
per-face flip/rotate/transpose orientation fixups (:25-43), the screen is two
NDC-corner triangles (:45-54), direction vectors map to (face, u, v) by
major-axis selection (:63-80), and the frame fill interpolates rays from the
NDC corners through the inverse rotation-only view-projection (:83-101).

The reference zeroes the translation row of its *cached* lookat in place
(cube_map.py:96 — a latent mutation bug); here the rotation-only view is built
functionally.
"""
from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np

from tpu_renderer.ops.transforms import matmul

__all__ = ["CubeMap", "sample_cubemap", "fill_frame_from_skybox", "NDC_FACES"]

#: Two triangles covering the NDC square (reference cube_map.py:45-54).
NDC_FACES = np.array([
    [[-1, 1, 1, 1], [1, 1, 1, 1], [-1, -1, 1, 1]],
    [[1, 1, 1, 1], [1, -1, 1, 1], [-1, -1, 1, 1]],
], dtype=np.float32)


class CubeMap:
    """Six-face environment map (reference cube_map.py:8-61).

    Face order in the stacked texture array: +X, -X, +Y, -Y, +Z, -Z
    (sides = (amplitude < 0) + 2 * major_axis).
    """

    def __init__(self, left, right, top, bottom, front, back,
                 normalize_input=True):
        load = self.load_texture
        if normalize_input:
            textures = [
                np.flip(load(right), axis=(0, 1)),
                np.rot90(load(left).transpose((1, 0, 2)), -1),
                load(top).transpose((1, 0, 2)),
                np.rot90(load(bottom)),
                np.rot90(load(front), -1),
                load(back).transpose((1, 0, 2)),
            ]
        else:
            textures = [load(right), load(left), load(top), load(bottom),
                        load(front), load(back)]
        self.textures = np.array(textures, dtype=np.float32)
        self.faces = NDC_FACES.copy()

    @staticmethod
    def load_texture(name):
        """Image file -> (T, T, 3) float32 in [0, 1]; an array in [0, 1]
        passes through, so generated skyboxes need no image file."""
        if not isinstance(name, (str, os.PathLike)):
            return np.asarray(name, dtype=np.float32)[..., :3]
        from PIL import Image

        texture = np.asarray(Image.open(name), dtype=np.float32)[..., :3]
        return texture / 255.0

    def __getitem__(self, vectors):
        """Vectorized direction -> texel lookup (reference cube_map.py:63-80)."""
        return np.asarray(sample_cubemap(jnp.asarray(self.textures),
                                         jnp.asarray(vectors, jnp.float32)))

    def as_device_arrays(self):
        # RGB packed into one u32 texel: one indexed element per pixel
        # instead of a 3-wide slice gather; the sources are 8-bit images,
        # so u8 quantization reconstructs exactly.
        q = np.round(self.textures * 255).astype(np.uint32)
        packed = q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16)
        return {"textures": jnp.asarray(self.textures),
                "packed": jnp.asarray(packed)}


def cubemap_index(t, vectors):
    """Direction -> (side, iu, iv) cubemap texel index.

    Major-axis face selection and UV normalization matching the reference's
    ``__getitem__`` (cube_map.py:63-80), including its ``* T - 1`` index scale
    (0 maps to texel -1, wrapping to the last row/column) and truncating cast.
    The -1 wrap uses a conditional add instead of an integer ``%``.
    """
    ax, ay, az = vectors[..., 0], vectors[..., 1], vectors[..., 2]
    major = jnp.argmax(jnp.abs(vectors), axis=-1)
    # Select the major component arithmetically instead of a per-element
    # take_along_axis gather.
    amp = jnp.where(major == 0, ax, jnp.where(major == 1, ay, az))

    # np.delete keeps the non-major components in original order:
    # major 0 -> (y, z); 1 -> (x, z); 2 -> (x, y).
    u = jnp.where(major == 0, ay, ax)
    v = jnp.where(major == 2, ay, az)

    nu = (u / amp + 1) / 2
    nv = (v / amp + 1) / 2
    side = (amp < 0).astype(jnp.int32) + major * 2
    iu = (nu * t - 1).astype(jnp.int32)
    iv = (nv * t - 1).astype(jnp.int32)
    iu = jnp.where(iu < 0, iu + t, iu)
    iv = jnp.where(iv < 0, iv + t, iv)
    return side, iu, iv


def sample_cubemap(textures, vectors):
    """Sample a (6, T, T, 3) cubemap with (..., 3) direction vectors."""
    side, iu, iv = cubemap_index(textures.shape[1], vectors)
    return textures[side, iu, iv]


def sample_cubemap_packed(packed, vectors):
    """Sample a (6, T, T) u32-packed cubemap: one gather + unpack."""
    side, iu, iv = cubemap_index(packed.shape[1], vectors)
    texel = packed[side, iu, iv]
    r = (texel & 0xFF).astype(jnp.float32)
    g = ((texel >> 8) & 0xFF).astype(jnp.float32)
    b = ((texel >> 16) & 0xFF).astype(jnp.float32)
    return jnp.stack([r, g, b], axis=-1) / 255.0


def _corner_barycentric(corners_xy, height, width, row0=0):
    """Screen barycentric of every pixel w.r.t. an int-cast NDC triangle.

    Matches fill_frame_from_skybox's ``barycentric(*test[XY].astype(int), p)``
    (cube_map.py:89) over the full pixel grid. Returns (bar (H, W, 3), cover).
    """
    cols = jnp.arange(width, dtype=jnp.float32)[None, :]
    rows = jnp.arange(height, dtype=jnp.float32)[:, None] + row0
    c = corners_xy.astype(jnp.int32).astype(jnp.float32)
    ax, ay = c[0, 0], c[0, 1]
    v0x, v0y = c[1, 0] - ax, c[1, 1] - ay
    v1x, v1y = c[2, 0] - ax, c[2, 1] - ay
    d00 = v0x * v0x + v0y * v0y
    d01 = v0x * v1x + v0y * v1y
    d11 = v1x * v1x + v1y * v1y
    inv_denom = 1.0 / (d00 * d11 - d01 * d01)
    v2x = cols - ax
    v2y = rows - ay
    d20 = v2x * v0x + v2y * v0y
    d21 = v2x * v1x + v2y * v1y
    v = (d11 * d20 - d01 * d21) * inv_denom
    w = (d00 * d21 - d01 * d20) * inv_denom
    u = 1.0 - v - w
    bar = jnp.stack([u, v, w], axis=-1)
    return bar, (bar >= 0).all(axis=-1)


def fill_frame_from_skybox(skybox, cam_m, resolution, row0=0):
    """Full-frame skybox background (reference cube_map.py:83-101).

    skybox: dict with ``textures`` (6, T, T, 3).
    cam_m: camera matrices dict (lookat/projection/viewport).
    Returns (H, W, 3) float32.
    """
    height, width = resolution
    faces = jnp.asarray(NDC_FACES)

    # Rotation-only view (the reference zeroes lookat's translation row).
    view_rot = cam_m["lookat"].at[3, :3].set(0.0)
    inv_vp = jnp.linalg.inv(matmul(view_rot, cam_m["projection"]))

    # The two NDC triangles partition the frame: select each pixel's ray
    # first (second triangle wins on the shared diagonal, like the
    # reference's sequential overwrite), then sample the cubemap ONCE with
    # the u32-packed single-element gather.
    dirs, covers = [], []
    for i in range(2):
        face = faces[i]
        screen = matmul(face, cam_m["viewport"])
        bar, cover = _corner_barycentric(screen[:, :2], height, width, row0)
        rays = matmul(face, inv_vp)
        rays = rays / rays[:, 3:4]
        dirs.append(matmul(bar, rays[:, :3]))
        covers.append(cover)
    ray_dirs = jnp.where(covers[1][..., None], dirs[1], dirs[0])
    covered = covers[0] | covers[1]

    if "packed" in skybox:
        sampled = sample_cubemap_packed(skybox["packed"], ray_dirs)
    else:
        sampled = sample_cubemap(skybox["textures"], ray_dirs)
    return jnp.where(covered[..., None], sampled, 0.0)
