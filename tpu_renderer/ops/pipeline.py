"""The whole-frame device program: one jitted computation per frame.

Replaces the reference's host-side render orchestration (Scene.render,
core.py:587-640 — three Python loops over faces plus buffer mutation) with a
single traced pipeline:

    vertex stage (per model, batched matmuls)      ops/vertex.py
    -> global face batch (all models concatenated)
    -> visibility buffer (z + winning face id)     ops/raster_xla.py
    -> shadow stencil (signed crossing counts)     ops/shadow.py
    -> deferred shading (pixel-parallel)           ops/shading.py
    -> background + vertical flip + gamma 0.8 + uint8 quantize (core.py:640)

Static configuration (resolution, handedness, subsystem, shader, per-model
flags, texture presence) lives in a hashable ``SceneConfig``; everything that
can change per frame (camera/light parameters, vertex positions, textures) is a
traced argument, so camera orbits and animated models never recompile.

How f32 operations round in these programs, so that z / id / stencil are
bit-identical between devices, is decided in :mod:`tpu_renderer.precision`.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from tpu_renderer.models.camera import camera_matrices
from tpu_renderer.ops import shading as sh
from tpu_renderer.ops.lightning import Lightning
from tpu_renderer.ops.transforms import matmul, normalize
from tpu_renderer.ops.vertex import gather_faces, transform_vertices

__all__ = ["SceneConfig", "ModelConfig", "render_frame", "render_core",
           "face_statistics", "SHADER_GENERAL", "SHADER_FLAT",
           "SHADER_GOURAUD", "SHADER_PBR", "SHADER_WIREFRAME",
           "SHADER_POINTS"]

SHADER_GENERAL = "general"
SHADER_FLAT = "flat"
SHADER_GOURAUD = "gouraud"
SHADER_PBR = "pbr"
SHADER_WIREFRAME = "wireframe"     # host-side debug shader (Scene.render)
SHADER_POINTS = "points"           # host-side debug shader (Scene.render)


@dataclass(frozen=True)
class ModelConfig:
    """Static per-model facts baked into the compiled program."""
    num_faces: int                 # padded face count
    clip: bool                     # per-pixel clip test (reference Model.clip)
    depth_test: bool               # z-buffer writes (reference Model.depth_test)
    shadowing: bool                # casts shadow volumes
    has_vn: bool                   # vertex normals present
    has_uv: bool
    has_map_kd: bool
    has_map_ks: bool
    has_norm: bool
    num_edges: int = 0             # padded silhouette-edge count


@dataclass(frozen=True)
class SceneConfig:
    """Static scene facts: the jit specialization key."""
    resolution: Tuple[int, int]    # (height, width)
    system: int                    # SYSTEM.LH (-1) / SYSTEM.RH (+1)
    subsystem: int
    shadows: bool
    shader: str
    background: str                # 'color' | 'cubemap'
    cam_projection_type: int
    backface_culling: bool
    has_debug_camera: bool
    dbg_projection_type: int
    light_type: Lightning
    models: Tuple[ModelConfig, ...]
    chunk: int = 8


def _cam_matrices(cfg: SceneConfig, cam, projection_type):
    return camera_matrices(
        cam["position"], cam["center"], cam["up"], cam["fovy"], cam["near"],
        cam["far"], projection_type=projection_type, system=cfg.system,
        subsystem=cfg.subsystem, resolution=cfg.resolution)


def _build_face_batch(cfg: SceneConfig, dyn, cam_m, dbg_mvp, tris_idx=0):
    """Vertex stage + per-face gathers for every model, concatenated.

    ``tris_idx`` supports triangle sharding over a mesh axis: face arrays
    arrive pre-sharded, and global face ids are shard-major
    (tris_idx * G_local + local index) so they index the all-gathered
    attribute arrays directly. Depth ties between equal-z faces on different
    shards then resolve shard-major instead of strictly model-major — a
    sub-pixel-rare deviation.
    """
    height, width = cfg.resolution
    raster_parts = []
    attr_parts = []
    for mc, md in zip(cfg.models, dyn["models"]):
        verts = md["verts"]
        va = transform_vertices(verts, cam_m["MVP"], cam_m["viewport"],
                                dyn["camera"]["near"], dyn["camera"]["far"])
        vid = md["vid"]
        f = gather_faces(va, vid, height, width, cfg.backface_culling)
        F = vid.shape[0]                    # local (possibly sharded) count

        world = f["world"]                              # (F, 3, 3)
        fn_raw = jnp.cross(world[:, 1] - world[:, 0], world[:, 2] - world[:, 0])
        face_normal = normalize(fn_raw)                 # (F, 3) world normal

        if mc.has_vn:
            vn = md["vn"]
        else:
            # Faces without vertex normals shade with the face normal
            # (reference Face.get_normals fallback, core.py:186-187).
            vn = jnp.broadcast_to(face_normal[:, None, :], (F, 3, 3))

        raster = {
            "inv_w": f["inv_w"], "aff": f["aff"], "clip": f["clip"],
            "bbox": f["bbox"],
            "valid": f["valid"] & md["pad_valid"],
            "clip_en": jnp.full((F,), mc.clip),
            "z_write": jnp.full((F,), mc.depth_test),
        }
        if cfg.has_debug_camera:
            clip_dbg = matmul(verts, dbg_mvp)[vid]
            raster["clip_dbg"] = clip_dbg

        attrs = {
            "sx": f["sx"], "sy": f["sy"], "inv_w": f["inv_w"],
            "szlin": f["szlin"], "aff": f["aff"],
            "world": world, "vn": vn, "face_normal": face_normal,
            "uv": md["uv"], "kd": md["kd"], "ks": md["ks"], "ns": md["ns"],
            "kd_slot": md["kd_slot"], "ks_slot": md["ks_slot"],
            "norm_slot": md["norm_slot"], "norm_tangent": md["norm_tangent"],
            "kd_shape": md["kd_shape"], "ks_shape": md["ks_shape"],
            "norm_shape": md["norm_shape"],
            "model_id": jnp.full((F,), len(raster_parts), jnp.int32),
            "pm": md["pm"], "pr": md["pr"], "ka": md["ka"],
        }
        raster_parts.append(raster)
        attr_parts.append(attrs)

    cat = lambda parts: jax.tree_util.tree_map(
        lambda *xs: jnp.concatenate(xs, axis=0), *parts)
    raster, attrs = cat(raster_parts), cat(attr_parts)
    g_local = raster["aff"].shape[0]
    raster["gid"] = jnp.arange(g_local, dtype=jnp.int32) + tris_idx * g_local
    return raster, attrs


def _unpack_texel(packed, scale_off):
    """RGB-packed u32/i32 texels -> float RGB under the stack's (scale,
    offset) dequantization affine (models/scene.py _texture_stack)."""
    r = (packed & 0xFF).astype(jnp.float32)
    g = ((packed >> 8) & 0xFF).astype(jnp.float32)
    b = ((packed >> 16) & 0xFF).astype(jnp.float32)
    rgb = jnp.stack([r, g, b], axis=-1) / 255.0
    return rgb * scale_off[0] + scale_off[1]


def _sample_stack(stack, slot, row, col, scale_off):
    """Gather one RGB-packed u32 texel per pixel and unpack to float RGB
    (one indexed element per pixel instead of a 3-wide slice)."""
    packed = stack[jnp.clip(slot, 0).astype(jnp.int32), row, col]
    return _unpack_texel(packed, scale_off)


def _wrap_index(x, dim):
    """Truncate-to-int then numpy-negative-wrap, in pure float arithmetic.

    Matches the reference's ``.astype(int)`` + fancy-index wrap
    (core.py:141-143) for any index in (-dim, dim), with a float floor-mod in
    place of an integer ``% dim`` by a per-pixel divisor.
    """
    i = jnp.trunc(x)
    wrapped = i - dim * jnp.floor(i / dim)
    return wrapped.astype(jnp.int32)


def _stack_uv_index(pb, uv, shape_hw):
    """Reference get_UV (core.py:138-143) with per-pixel texture shapes.

    shape_hw: (H, W, 2) float32 real (TH, TW) of each pixel's material map.
    Returns integer (row, col) with numpy-style negative wrap.
    """
    iu = jnp.sum(pb * uv[..., 0], axis=-1)
    iv = jnp.sum(pb * uv[..., 1], axis=-1)
    th = shape_hw[..., 0]
    tw = shape_hw[..., 1]
    col = _wrap_index(jnp.clip(iu, max=1.0) * (tw - 1), tw)
    row = _wrap_index((1.0 - jnp.clip(iv, max=1.0)) * (th - 1), th)
    return row, col


def _shade(cfg: SceneConfig, dyn, tid, stencil, attrs, cam_m, row0=0):
    """Deferred shading of the whole frame from the visibility buffer."""
    height, width = tid.shape[0], cfg.resolution[1]
    fid = jnp.clip(tid, 0)
    bg = tid < 0

    g = lambda name: attrs[name][fid]
    sx, sy, inv_w = g("sx"), g("sy"), g("inv_w")
    bar, pb = sh.pixel_barycentric(g("aff"), inv_w, row0)

    world = g("world")                              # (H, W, 3, 3)
    frag_world = matmul(pb, world)

    uv = g("uv")                                    # (H, W, 3, 2)
    model_id = g("model_id")

    # ---- object color: per-face Kd, overridden by each model's diffuse stack.
    color = g("kd")
    for m, (mc, md) in enumerate(zip(cfg.models, dyn["models"])):
        if not mc.has_map_kd:
            continue
        row, col = _stack_uv_index(pb, uv, g("kd_shape"))
        sampled = _sample_stack(md["kd_stack"], g("kd_slot"), row, col,
                                md["kd_scale_off"])
        mask = (model_id == m) & (g("kd_slot") >= 0)
        color = jnp.where(mask[..., None], sampled, color)

    # ---- normals: vertex-normal interpolation, overridden by normal maps.
    vn = g("vn")                                    # (H, W, 3, 3)
    normal = normalize(matmul(pb, vn))
    for m, (mc, md) in enumerate(zip(cfg.models, dyn["models"])):
        if not mc.has_norm:
            continue
        row, col = _stack_uv_index(pb, uv, g("norm_shape"))
        sampled = _sample_stack(md["norm_stack"], g("norm_slot"), row, col,
                                md["norm_scale_off"])
        tangent_n = sh.tangent_basis_normal(sampled, pb, world, uv, vn)
        mapped = jnp.where(g("norm_tangent")[..., None], tangent_n, sampled)
        mask = (model_id == m) & (g("norm_slot") >= 0)
        normal = jnp.where(mask[..., None], normalize(mapped), normal)

    # ---- specular factor: Ks * 255 or specular-map red channel * 255
    # (reference Face.get_specular, core.py:145-153).
    specular_light = g("ks") * 255.0
    for m, (mc, md) in enumerate(zip(cfg.models, dyn["models"])):
        if not mc.has_map_ks:
            continue
        row, col = _stack_uv_index(pb, uv, g("ks_shape"))
        sampled = _sample_stack(md["ks_stack"], g("ks_slot"), row, col,
                                md["ks_scale_off"])
        mask = (model_id == m) & (g("ks_slot") >= 0)
        specular_light = jnp.where(mask[..., None],
                                   sampled[..., 0:1] * 255.0, specular_light)

    light = dict(dyn["light"])
    light["light_type"] = cfg.light_type
    light["direction"] = normalize(
        light["position"] - light["center"]).ravel()

    if cfg.shader == SHADER_GENERAL:
        pix = {
            "color": color, "normal": normal, "frag_world": frag_world,
            "specular_light": specular_light, "ns": g("ns")[..., None],
        }
        shadows_mask = (stencil != 0) if cfg.shadows else None
        rgb = sh.shade_general(pix, light, dyn["camera"]["position"],
                               shadows_mask=shadows_mask)
    elif cfg.shader == SHADER_FLAT:
        rgb = sh.shade_flat(g("face_normal"), light)
    elif cfg.shader == SHADER_GOURAUD:
        rgb = sh.shade_gouraud(bar, vn, light)
    elif cfg.shader == SHADER_PBR:
        # The reference's pbr shader runs after rasterize replaced vertex z
        # with linearized depth (triangular.py:96, 220-266): positions here are
        # post-viewport (x, y, z_lin).
        szlin_pos = jnp.stack([sx, sy, g("szlin")], axis=-1)
        pix = {
            "normal_raw": normalize(matmul(bar, vn)),
            "screen_pos": matmul(bar, szlin_pos),
            # roughness stays rank-(H, W): the GGX terms combine it with
            # (H, W) dot products; metallic broadcasts against RGB.
            "metallic": g("pm")[..., None], "roughness": g("pr"),
            "ao": g("ka"),
        }
        rgb = sh.shade_pbr(pix, light, dyn["camera"]["position"])
    else:
        raise ValueError(f"unknown shader {cfg.shader!r}")

    background = _background(cfg, dyn, cam_m, height, width, row0)
    return jnp.where(bg[..., None], background, rgb)


def _background(cfg: SceneConfig, dyn, cam_m, height, width, row0):
    """Fill color or skybox (reference core.py:595-600)."""
    if cfg.background == "color":
        return jnp.broadcast_to(dyn["background_color"], (height, width, 3))
    from tpu_renderer.ops.cubemap import fill_frame_from_skybox
    return fill_frame_from_skybox(dyn["skybox"], cam_m, (height, width), row0)


def render_core(cfg: SceneConfig, dyn, *, local_height=None, row0=0,
                axis_tris=None):
    """Render the (possibly row/triangle-sharded) frame BEFORE flip/quantize.

    Single device: ``render_core(cfg, dyn)`` computes the whole frame.

    Under ``shard_map`` over a ('rows', 'tris') mesh: each shard rasterizes its
    face subset over its row block (``row0`` offsets its rows into the global
    frame); z-buffers combine with ``pmin`` (depth is an associative
    min-reduce, SURVEY.md §5.8), winning ids with a final-z claim + ``pmax``,
    stencil counts with ``psum`` (signed crossing counts commute), and shading
    attributes ``all_gather`` over the triangle axis. The collectives run
    inside the compiled program; no host round-trips.

    Returns (frame f32 (local_H, W, 3), zbuf, tid, stencil).
    """
    from tpu_renderer.ops.raster_xla import visibility_pass, zbuffer_pass
    from tpu_renderer.ops.shadow import shadow_stencil

    height, width = cfg.resolution
    if local_height is None:
        local_height = height
    sign = cfg.system

    cam_m = _cam_matrices(cfg, dyn["camera"], cfg.cam_projection_type)
    dbg_mvp = None
    if cfg.has_debug_camera:
        dbg_mvp = _cam_matrices(cfg, dyn["debug_camera"],
                                cfg.dbg_projection_type)["MVP"]

    if not cfg.models:
        # Empty scene: background only (the reference renders its fill color).
        zbuf = jnp.full((local_height, width), jnp.inf * sign, jnp.float32)
        tid = jnp.full((local_height, width), -1, jnp.int32)
        stencil = jnp.zeros((local_height, width), jnp.int32)
        frame = _background(cfg, dyn, cam_m, local_height, width, row0)
        return frame, zbuf, tid, stencil

    tris_idx = jax.lax.axis_index(axis_tris) if axis_tris else 0
    faces, attrs = _build_face_batch(cfg, dyn, cam_m, dbg_mvp,
                                     tris_idx=tris_idx)

    zb_sign = zbuffer_pass(faces, local_height, width, sign, cfg.chunk, row0)
    if axis_tris:
        zb_sign = jax.lax.pmin(zb_sign, axis_tris)
    tid = visibility_pass(faces, zb_sign, local_height, width, sign,
                          cfg.chunk, row0)
    if axis_tris:
        # Last-wins across shards: ids are shard-major, so pmax picks the
        # highest-id claimant among shards passing the final z-test.
        tid = jax.lax.pmax(tid, axis_tris)
        # Gather every shard's attributes so shading can index global ids.
        attrs = jax.tree_util.tree_map(
            lambda a: jax.lax.all_gather(a, axis_tris).reshape(
                (-1,) + a.shape[1:]),
            attrs)
    zbuf = zb_sign * sign

    if cfg.shadows:
        stencil = shadow_stencil(cfg, dyn, cam_m, zbuf, row0=row0,
                                 axis_name=axis_tris, shard_idx=tris_idx)
        if axis_tris:
            stencil = jax.lax.psum(stencil, axis_tris)
    else:
        stencil = jnp.zeros((local_height, width), jnp.int32)

    frame = _shade(cfg, dyn, tid, stencil, attrs, cam_m, row0=row0)
    return frame, zbuf, tid, stencil


def render_frame(cfg: SceneConfig, dyn):
    """The per-frame device program. Returns (frame_u8, zbuf, tid, stencil)."""
    frame, zbuf, tid, stencil = render_core(cfg, dyn)
    # Vertical flip + gamma 0.8 + quantize (reference core.py:640).
    out = (jnp.clip(frame[::-1] ** 0.8, 0.0, 1.0) * 255).astype(jnp.uint8)
    return out, zbuf, tid, stencil


render_frame_jit = jax.jit(render_frame, static_argnames=("cfg",))


@partial(jax.jit, static_argnames=("cfg", "kind"))
def render_debug_frame(cfg: SceneConfig, dyn, kind):
    """Wireframe / points shaders, fully on device (reference
    triangular.py:269-283). Replaces the per-face host loops of
    overlay.draw_wireframe / draw_points with one compiled program:

    - the normal pipeline resolves the z-buffer (shading discarded),
    - every REAL face (no culling/validity masks — the host shaders iterate
      all of model.face_array) re-runs the vertex stage,
    - wireframe: the closed-form DDA inversion (ops/lines.wireframe_mask)
      marks pixels where any edge's DDA point passes the strict
      ``zbuf - z > 0`` test; one color makes the host's sequential splat
      order-free,
    - points: endpoint splats resolve write order with a scatter-max over
      the write index (last-wins, parity bit = red/blue) instead of a
      serialized scatter.

    Returns (frame_u8, zbuf, tid, stencil) like render_frame.
    """
    import dataclasses

    from tpu_renderer.ops.lines import pack_lines, wireframe_mask

    assert kind in (SHADER_WIREFRAME, SHADER_POINTS)
    cfg2 = dataclasses.replace(cfg, shader=SHADER_GOURAUD)
    _, zbuf, tid, stencil = render_core(cfg2, dyn)
    height, width = cfg.resolution
    cam_m = _cam_matrices(cfg, dyn["camera"], cfg.cam_projection_type)
    background = _background(cfg, dyn, cam_m, height, width, 0)

    sxs, sys_, szs, fns, valids = [], [], [], [], []
    for mc, md in zip(cfg.models, dyn["models"]):
        va = transform_vertices(md["verts"], cam_m["MVP"], cam_m["viewport"],
                                dyn["camera"]["near"], dyn["camera"]["far"])
        vid = md["vid"]
        screen = va["screen"][vid]
        sxs.append(screen[..., 0])
        sys_.append(screen[..., 1])
        szs.append(va["zlin"][vid])
        world = md["verts"][vid][..., :3]
        fns.append(normalize(jnp.cross(world[:, 1] - world[:, 0],
                                       world[:, 2] - world[:, 0])))
        valids.append(md["pad_valid"])
    sx = jnp.concatenate(sxs)
    sy = jnp.concatenate(sys_)
    sz = jnp.concatenate(szs)
    fn = jnp.concatenate(fns)
    valid = jnp.concatenate(valids)

    if kind == SHADER_WIREFRAME:
        ia = jnp.array([0, 1, 2])
        ib = jnp.array([1, 2, 0])
        p0 = jnp.stack([sx[:, ia], sy[:, ia], sz[:, ia]], -1).reshape(-1, 3)
        p1 = jnp.stack([sx[:, ib], sy[:, ib], sz[:, ib]], -1).reshape(-1, 3)
        mask = wireframe_mask(pack_lines(p0, p1), jnp.repeat(valid, 3), zbuf,
                              cfg.chunk)
        color = jnp.asarray([64 / 255, 64 / 255, 128 / 255], jnp.float32)
        frame = jnp.where(mask[..., None], color, background)
    else:
        # Backface cull against the camera direction (triangular.py:277-283:
        # cam_dir = -position normalized; keep normal . cam_dir > 0).
        pos = dyn["camera"]["position"]
        cam_dir = -pos / jnp.maximum(jnp.linalg.norm(pos), 1e-30)
        keep = valid & (jnp.sum(fn * cam_dir, axis=-1) > 0)
        # Write sequence per face: (v0 R)(v1 B)(v1 R)(v2 B)(v2 R)(v0 B) —
        # last write wins; resolve with a scatter-max over the write index
        # whose parity is the color.
        vsel = jnp.array([0, 1, 1, 2, 2, 0])
        ci = sx[:, vsel].astype(jnp.int32)           # trunc, like .astype
        ri = sy[:, vsel].astype(jnp.int32)
        inb = (ri >= 0) & (ri < height) & (ci >= 0) & (ci < width)
        ok = keep[:, None] & inb
        order = jnp.arange(ok.size, dtype=jnp.int32).reshape(ok.shape)
        lin = jnp.where(ok, ri * width + ci, -1)
        win = jnp.full(height * width, -1, jnp.int32).at[
            lin.reshape(-1)].max(order.reshape(-1), mode="drop")
        win = win.reshape(height, width)
        rgb = jnp.where(((win & 1) == 1)[..., None],
                        jnp.asarray([0.0, 0.0, 1.0]),
                        jnp.asarray([1.0, 0.0, 0.0]))
        frame = jnp.where((win >= 0)[..., None], rgb, background)

    out = (jnp.clip(frame[::-1] ** 0.8, 0.0, 1.0) * 255).astype(jnp.uint8)
    return out, zbuf, tid, stencil


@partial(jax.jit, static_argnames=("cfg",))
def render_core_jit(cfg, dyn):
    """Pre-flip float frame + buffers — for host-side debug overlays."""
    return render_core(cfg, dyn)


@partial(jax.jit, static_argnames=("cfg", "ss"))
def render_ssaa_jit(cfg, dyn, ss):
    """Supersampled render: cfg.resolution is already ss-scaled; box-filter
    the float frame down by ss before flip/gamma/quantize."""
    frame, zbuf, tid, stencil = render_core(cfg, dyn)
    hh, ww = frame.shape[0], frame.shape[1]
    frame = frame.reshape(hh // ss, ss, ww // ss, ss, 3).mean(axis=(1, 3))
    out = (jnp.clip(frame[::-1] ** 0.8, 0.0, 1.0) * 255).astype(jnp.uint8)
    return out, zbuf, tid, stencil


@partial(jax.jit, static_argnames=("cfg",))
def face_statistics(cfg: SceneConfig, dyn, tid):
    """Per-model face counters, the batched equivalent of the reference's
    per-face Errors tally (core.py:624-636, triangular.py:15-20).

    Returns a list (one dict per model) of device scalars:
    total, rendered (faces owning >= 1 pixel in the visibility buffer),
    backface_culled, degenerate (EMPTY_B), offscreen (WRONG_MIN_MAX /
    empty clamped bbox), and occluded_or_clipped (the remainder — the
    reference's CLIPPED / EMPTY_Z outcomes are fragment-level and collapse
    here).
    """
    height, width = cfg.resolution
    cam_m = _cam_matrices(cfg, dyn["camera"], cfg.cam_projection_type)

    # Which faces own at least one pixel.
    g_total = sum(md["vid"].shape[0] for md in dyn["models"])
    owned = jnp.zeros(g_total + 1, jnp.int32).at[
        jnp.clip(tid, -1) + 0].add(jnp.where(tid >= 0, 1, 0), mode="drop")

    stats = []
    offset = 0
    for mc, md in zip(cfg.models, dyn["models"]):
        verts = md["verts"]
        va = transform_vertices(verts, cam_m["MVP"], cam_m["viewport"],
                                dyn["camera"]["near"], dyn["camera"]["far"])
        vid = md["vid"]
        F = vid.shape[0]
        screen = va["screen"][vid]
        sx, sy, sz = screen[..., 0], screen[..., 1], screen[..., 2]

        from tpu_renderer.ops.vertex import screen_normal_z
        from tpu_renderer.ops.transforms import bound_box_batch
        nz = screen_normal_z(sx, sy, sz)
        real = md["pad_valid"]
        culled = real & (nz < 0) if cfg.backface_culling else jnp.zeros(F, bool)

        v0x, v0y = sx[:, 1] - sx[:, 0], sy[:, 1] - sy[:, 0]
        v1x, v1y = sx[:, 2] - sx[:, 0], sy[:, 2] - sy[:, 0]
        denom = ((v0x * v0x + v0y * v0y) * (v1x * v1x + v1y * v1y) -
                 (v0x * v1x + v0y * v1y) ** 2)
        degenerate = real & ~culled & (denom == 0)

        _, box_valid = bound_box_batch(jnp.stack([sx, sy], -1), height, width)
        offscreen = real & ~culled & ~degenerate & ~box_valid

        rendered = real & (owned[offset:offset + F] > 0)
        leftover = real & ~culled & ~degenerate & ~offscreen & ~rendered
        stats.append({
            "total": real.sum(),
            "rendered": rendered.sum(),
            "backface_culled": culled.sum(),
            "degenerate": degenerate.sum(),
            "offscreen": offscreen.sum(),
            "occluded_or_clipped": leftover.sum(),
        })
        offset += F
    return stats
