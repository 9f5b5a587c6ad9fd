"""Deferred, pixel-parallel shading over the visibility buffer.

The reference shades per-face fragment batches from inside the rasterizer
(general_shading, triangular.py:135-171; texture/normal fetch via the Face
object, core.py:138-224). Here shading happens once per frame over the whole
(H, W) grid: the visibility buffer gives each pixel its winning face id, per-face
attributes are gathered with vectorized takes, and every term — perspective-
correct barycentric, nearest-neighbor texture sampling, tangent-space normal
mapping (batched closed-form 3x3 inverse), attenuation, spot smoothstep,
Blinn-Phong halfway specular — is one fused elementwise/gather expression: no
data-dependent control flow, gathers for texture access, all in f32.

Semantics preserved bit-for-bit-in-spirit from the reference, including the
quirks that are user-visible: ambient-only base pass ``clip(0.05, 1)``
(triangular.py:145-147), diffuse intensity NOT clamped at zero (:169-170),
texture V flip and ``clip(max=1)``-only UV clamp with negative-index wrap
(core.py:138-143), spot cone smoothstep cos20°→cos10° (:157-161), and the
specular map red channel * 255 (core.py:145-153).
"""
from __future__ import annotations

import jax.numpy as jnp

from tpu_renderer.ops.lightning import Lightning
from tpu_renderer.ops.transforms import dot, matmul, normalize

__all__ = [
    "pixel_barycentric", "sample_texture", "tangent_basis_normal",
    "shade_general", "shade_flat", "shade_gouraud",
    "shade_pbr", "smoothstep",
    "mix",
]


def smoothstep(edge0, edge1, x):
    """Hermite smoothstep (reference core.py:497-515)."""
    t = jnp.clip((x - edge0) / (edge1 - edge0), 0.0, 1.0)
    return t * t * (3 - 2 * t)


def mix(x, y, a):
    """Linear interpolation (reference triangular.py:391-395)."""
    return x * (1 - a) + y * a


def pixel_barycentric(aff, inv_w, row0=0):
    """Screen + perspective-corrected barycentric for every pixel.

    aff: (H, W, 9) per-pixel winning-face affine barycentric coefficients
    (vertex.gather_faces — the same values and evaluation expression as the
    rasterizers, keeping deferred shading consistent with coverage);
    inv_w: (H, W, 3). ``row0`` offsets rows into the global frame for
    row-sharded rendering. Returns (bar, pb): both (H, W, 3). ``pb`` is the
    reference's ``screen_perspective`` (core.py:155-160): bar * (1/w)
    renormalized.
    """
    H, W = aff.shape[:2]
    cols = jnp.arange(W, dtype=jnp.float32)[None, :]
    rows = jnp.arange(H, dtype=jnp.float32)[:, None] + row0
    v = aff[..., 0] * cols + aff[..., 1] * rows + aff[..., 2]
    w = aff[..., 3] * cols + aff[..., 4] * rows + aff[..., 5]
    u = 1.0 - v - w
    bar = jnp.stack([u, v, w], axis=-1)
    scaled = bar * inv_w
    pb = scaled / jnp.sum(scaled, axis=-1, keepdims=True)
    return bar, pb


def sample_texture(texture, pb, uv):
    """Nearest-neighbor texture fetch with the reference's UV mapping.

    texture: (TH, TW, C); pb: (H, W, 3) perspective-corrected barycentric;
    uv: (H, W, 3, 2) per-corner (u, v) texture coordinates.

    Reference get_UV (core.py:138-143): column index from interpolated u
    clipped only at max=1; row index from 1 - interpolated v, same clamp;
    truncating int cast; negative indices wrap like numpy fancy indexing.
    """
    from tpu_renderer.ops.pipeline import _wrap_index

    th, tw = texture.shape[0], texture.shape[1]
    iu = jnp.sum(pb * uv[..., 0], axis=-1)
    iv = jnp.sum(pb * uv[..., 1], axis=-1)
    col = _wrap_index(jnp.clip(iu, max=1.0) * (tw - 1), float(tw))
    row = _wrap_index((1.0 - jnp.clip(iv, max=1.0)) * (th - 1), float(th))
    return texture[row, col]


def _inv3x3(m):
    """Batched closed-form 3x3 inverse via adjugate (rows r0, r1, r2).

    m: (..., 3, 3). Cheaper and more fusion-friendly than linalg.inv for the
    per-pixel TBN solve (reference uses np.linalg.inv on an (N, 3, 3) batch,
    core.py:210-214).
    """
    r0, r1, r2 = m[..., 0, :], m[..., 1, :], m[..., 2, :]
    c0 = jnp.cross(r1, r2)
    c1 = jnp.cross(r2, r0)
    c2 = jnp.cross(r0, r1)
    det = jnp.sum(r0 * c0, axis=-1, keepdims=True)[..., None]
    return jnp.stack([c0, c1, c2], axis=-1) / det


def tangent_basis_normal(sampled, pb, world, uv, normals):
    """World-space normal from a tangent-space normal map sample.

    Per-pixel TBN construction matching Face.tangent_ (core.py:191-224):
    solve A @ [T B] = [du dv] with A rows (b-a, c-a, n) for the tangent and
    bitangent, then rotate the sampled normal by the (T, B, n) basis.

    sampled: (H, W, 3) normal-map sample in [-1, 1];
    pb: (H, W, 3); world: (H, W, 3, 3) triangle world xyz;
    uv: (H, W, 3, 2); normals: (H, W, 3, 3) vertex normals.
    """
    n = normalize(matmul(pb, normals))
    a = world[..., 0, :]
    A = jnp.stack([world[..., 1, :] - a, world[..., 2, :] - a, n], axis=-2)
    AI = _inv3x3(A)

    du = jnp.stack([uv[..., 1, 0] - uv[..., 0, 0],
                    uv[..., 2, 0] - uv[..., 0, 0],
                    jnp.zeros_like(uv[..., 0, 0])], axis=-1)
    dv = jnp.stack([uv[..., 1, 1] - uv[..., 0, 1],
                    uv[..., 2, 1] - uv[..., 0, 1],
                    jnp.zeros_like(uv[..., 0, 0])], axis=-1)
    tangent = normalize(dot(AI, du[..., None, :]))
    bitangent = normalize(dot(AI, dv[..., None, :]))
    basis = jnp.stack([tangent, bitangent, n], axis=-1)     # columns T, B, n
    return dot(basis, sampled[..., None, :])


def shade_general(pix, light, camera_position, *, shadows_mask=None):
    """Blinn-Phong ambient + lit shading (reference general_shading).

    pix: dict of per-pixel quantities —
      ``color`` (H, W, 3) object color, ``normal`` (H, W, 3) world normal
      (normalized), ``frag_world`` (H, W, 3), ``specular_light`` (H, W, 1 or 3)
      the specular-map/Ks factor, ``ns`` (H, W, 1) specular exponent.
    light: dict with position, direction, color, ambient (3,), and scalars
      specular_strength, constant, linear, quadratic; plus static
      ``light_type``.
    shadows_mask: optional (H, W) bool — True where the pixel is in shadow
      (stencil != 0), selecting the ambient-only result (the reference's pass 1
      output surviving pass 3's stencil mask, core.py:603-636).

    Returns (H, W, 3) float32 in [0.05, 1].
    """
    frag = pix["frag_world"]
    distance = jnp.linalg.norm(light["position"] - frag, axis=-1)
    att = (1.0 / (light["constant"] + distance *
                  (light["linear"] + light["quadratic"] * distance)))[..., None]

    color = pix["color"]
    ambient_rgb = jnp.clip(att * light["ambient"] * color, 0.05, 1.0)

    normals = pix["normal"]
    if light["light_type"] == Lightning.DIRECTIONAL_LIGHTNING:
        light_dir = jnp.broadcast_to(light["direction"], frag.shape)
    else:
        light_dir = normalize(light["position"] - frag)

    view_dir = normalize(camera_position - frag)
    if light["light_type"] == Lightning.SPOT_LIGHTNING:
        in_light = smoothstep(jnp.cos(jnp.deg2rad(20.0)),
                              jnp.cos(jnp.deg2rad(10.0)),
                              jnp.sum(light["direction"] * light_dir, axis=-1))
        color = color * in_light[..., None]

    halfway = normalize(light_dir + view_dir)
    spec_reflection = jnp.clip(
        jnp.sum(normals * halfway, axis=-1), 0)[..., None] ** pix["ns"]
    specular = (light["color"] * spec_reflection *
                light["specular_strength"] * pix["specular_light"])
    intensity = jnp.sum(normals * light_dir, axis=-1)[..., None]
    diffuse = intensity * light["color"]       # deliberately unclamped (:169)
    lit_rgb = jnp.clip(att * color * (light["ambient"] + diffuse + specular),
                       0.05, 1.0)

    if shadows_mask is None:
        return lit_rgb
    return jnp.where(shadows_mask[..., None], ambient_rgb, lit_rgb)


def shade_flat(face_world_normal, light):
    """Flat shading (reference triangular.py:174-177).

    face_world_normal: (H, W, 3) the winning face's world normal.
    NOTE: like the reference, writes a 0..255-scale intensity into the float
    frame — the quantization quirk is part of the observable behavior.
    """
    intensity = jnp.sum(face_world_normal * light["direction"], axis=-1)
    return jnp.clip(intensity, 0.3, 1.0)[..., None] * jnp.full(3, 255.0)


def shade_gouraud(bar, normals, light):
    """Gouraud shading (reference triangular.py:180-182), screen barycentric."""
    n = matmul(bar, normals)
    intensity = jnp.clip(jnp.sum(n * light["direction"], axis=-1), 0, 1)
    return intensity[..., None] * jnp.full(3, 255.0)


# ----------------------------------------------------------------- PBR (GGX)

def fresnel_schlick(cos_theta, F0):
    """(reference triangular.py:185-187)"""
    return F0 + (1.0 - F0) * ((1 - cos_theta[..., None]) ** 5)


def distribution_ggx(N, H, roughness):
    """(reference triangular.py:190-199)"""
    a2 = (roughness * roughness) ** 2
    ndoth = jnp.clip(jnp.sum(N * H, axis=-1), 0)
    denom = ndoth * ndoth * (a2 - 1.0) + 1.0
    return a2 / (jnp.pi * denom * denom)


def geometry_schlick_ggx(ndotv, roughness):
    """(reference triangular.py:202-208)"""
    r = roughness + 1.0
    k = (r * r) / 8.0
    return ndotv / (ndotv * (1.0 - k) + k)


def geometry_smith(N, V, L, roughness):
    """(reference triangular.py:211-217)"""
    ndotv = jnp.clip(jnp.sum(N * V, axis=-1), 0)
    ndotl = jnp.clip(jnp.sum(N * L, axis=-1), 0)
    return geometry_schlick_ggx(ndotl, roughness) * geometry_schlick_ggx(ndotv, roughness)


def shade_pbr(pix, light, camera_position):
    """Cook-Torrance PBR (reference triangular.py:220-266).

    Uses screen-barycentric-interpolated vertex normals and *screen-space*
    vertex positions exactly like the reference (bar @ face.vertices[XYZ] —
    the reference passes post-viewport vertices here), metallic/roughness from
    material Pm/Pr, Reinhard tonemap + gamma 1/2.2.

    pix additionally needs: ``normal_raw`` (H, W, 3) bar-interpolated vertex
    normals (normalized), ``screen_pos`` (H, W, 3) bar @ screen xyz,
    ``metallic``/``roughness``/``ao`` per-pixel material scalars/vectors.
    """
    albedo = 1.0
    metallic = pix["metallic"]
    roughness = pix["roughness"]
    ao = pix["ao"]

    N = pix["normal_raw"]
    V = normalize(camera_position - pix["screen_pos"])
    F0 = mix(jnp.full(3, 0.04), albedo, metallic)

    to_light = light["position"] - pix["screen_pos"]
    L = normalize(to_light)
    H = normalize(V + L)
    distance = jnp.linalg.norm(to_light, axis=-1)
    radiance = light["color"] * (1.0 / (distance * distance))[..., None]

    ndf = distribution_ggx(N, H, roughness)[..., None]
    g = geometry_smith(N, V, L, roughness)[..., None]
    f = fresnel_schlick(jnp.clip(jnp.sum(H * V, axis=-1), 0), F0)

    ks = f
    kd = (1.0 - ks) * (1.0 - metallic)

    numerator = ndf * g * f
    denominator = (4.0 * jnp.clip(jnp.sum(N * V, axis=-1), 0) *
                   jnp.clip(jnp.sum(N * L, axis=-1), 0) + 0.0001)
    specular = numerator / denominator[..., None]

    ndotl = jnp.clip(jnp.sum(N * L, axis=-1), 0)
    lo = (kd * albedo / jnp.pi + specular) * radiance * ndotl[..., None]
    color = albedo * ao + lo
    color = color / (color + 1.0)
    return color ** (1.0 / 2.2)
