"""Scene: model container + camera/light binding + the render() entry point.

Reference surface (core.py:558-640) with the render loop replaced by one jitted
device program (ops/pipeline.py). Fixed reference quirks (SURVEY.md §2):

- ``shadows=`` is honored (the reference ignores it, core.py:568) and
  ``Model.shadowing`` gates which models cast shadow volumes.
- ``debug_camera`` is truly optional (the reference dereferences it
  unconditionally, triangular.py:39).
- Camera/Light binding state lives on the Scene instance, not on a class-level
  descriptor shared across scenes (core.py:527-529), and default camera/light
  are fresh per Scene (mutable-default quirk, core.py:565-567).

Per-model device packets (vertex/face/texture arrays) are packed once and
cached; the compiled program is cached by the scene's static configuration, so
moving the camera/light or animating vertices re-renders without recompiling.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import jax.numpy as jnp

from tpu_renderer.constants import SUBSYSTEM, SYSTEM
from tpu_renderer.models.camera import Camera, Light
from tpu_renderer.models.model import Model
from tpu_renderer.ops import transforms as T
from tpu_renderer.ops.pipeline import (ModelConfig, SceneConfig, SHADER_GENERAL,
                                       render_frame_jit)

__all__ = ["Scene"]

_PAD = 8  # face-count padding multiple (== pipeline chunk)


def _pad_rows(a: np.ndarray, rows: int) -> np.ndarray:
    if len(a) == rows:
        return a
    pad = np.zeros((rows - len(a), *a.shape[1:]), dtype=a.dtype)
    return np.concatenate([a, pad], axis=0)


def _material_table(model: Model, attr: str, width: int) -> np.ndarray:
    """Per-material-group scalar/vector attribute table, broadcast to width."""
    out = []
    for name in model.material_group:
        mat = model.materials.get(name, model.materials["default"])
        val = np.atleast_1d(np.asarray(getattr(mat, attr), dtype=np.float32))
        out.append(np.broadcast_to(val, (width,)) if width > 1 else val[:1])
    return np.stack(out)


def _texture_stack(model: Model, attr: str):
    """Stack all materials' ``attr`` maps, RGB-packed into one uint32 texel.

    One u32 texel per pixel is one indexed element per gather instead of a
    3-wide slice. Textures originate from 8-bit images (core.py:100-105), so
    quantizing back to u8 under a per-stack (scale, offset) affine — (1, 0)
    for raw [0,1] maps, (2, -1) for ``*2-1``-normalized normal maps —
    reconstructs the original float values exactly.

    Returns (stack (N, TH, TW) uint32, slot (G,), shape (G, 2), tangent (G,),
    scale_offset (2,) float32) or None when no material carries the map.
    """
    groups = model.material_group
    entries = []
    for gi, name in enumerate(groups):
        mat = model.materials.get(name, model.materials["default"])
        tex = mat.__dict__.get(attr)
        if tex is not None:
            tangent = bool((tex.dtype.metadata or {}).get("tangent", False))
            entries.append((gi, np.asarray(tex, np.float32), tangent))
    if not entries:
        return None
    th = max(t.shape[0] for _, t, _ in entries)
    tw = max(t.shape[1] for _, t, _ in entries)
    lo = min(float(t.min()) for _, t, _ in entries)
    scale, offset = (2.0, -1.0) if lo < 0 else (1.0, 0.0)

    stack = np.zeros((len(entries), th, tw), np.uint32)
    slot = np.full(len(groups), -1, np.int32)
    shape = np.ones((len(groups), 2), np.float32)
    tangent_flags = np.zeros(len(groups), bool)
    for si, (gi, tex, tangent) in enumerate(entries):
        q = np.round(np.clip((tex[..., :3] - offset) / scale, 0, 1) * 255)
        q = q.astype(np.uint32)
        packed = q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16)
        stack[si, :tex.shape[0], :tex.shape[1]] = packed
        slot[gi] = si
        shape[gi] = tex.shape[:2]
        tangent_flags[gi] = tangent
    return (stack, slot, shape, tangent_flags,
            np.array([scale, offset], np.float32))


class Scene:
    def __init__(self, camera: Optional[Camera] = None,
                 light: Optional[Light] = None, shadows: bool = False,
                 debug_camera: Optional[Camera] = None,
                 resolution=(1500, 1500), system=SYSTEM.RH,
                 subsystem=SUBSYSTEM.DIRECTX, skymap=None,
                 shader: str = SHADER_GENERAL, supersample: int = 1):
        self.system = system
        self.subsystem = subsystem
        self.resolution = tuple(int(r) for r in resolution)
        self.models: List[Model] = []
        self.shadows = shadows
        self.skybox = skymap
        self.shader = shader
        #: Draw the debug camera's frustum wireframe like the reference
        #: (core.py:638) whenever a debug camera is present.
        self.debug_overlay = True
        #: Supersampling anti-aliasing factor (beyond the reference): render
        #: at N x the resolution, box-filter down before quantization.
        self.supersample = int(supersample)
        self.camera = camera if camera is not None else Camera(
            position=(0, 0, 1), center=(0, 0, 0))
        self.light = light if light is not None else Light(position=(1, 1, 1))
        self.debug_camera = debug_camera
        self._packets: Dict[int, dict] = {}
        self.last_zbuf = None
        self.last_tid = None
        self.last_stencil = None

    # ------------------------------------------------------------- binding

    def __setattr__(self, key, value):
        # Bind camera/light-like objects to this scene (reference Bound
        # descriptor, core.py:527-555) and materialize their gizmos.
        if key in ("camera", "light", "debug_camera") and value is not None:
            value.scene = self
            super().__setattr__(key, value)
            if getattr(value, "show", False):
                self._add_gizmo(value)
            return
        super().__setattr__(key, value)

    def _add_gizmo(self, obj):
        """Show a sphere at a light / a frustum mesh at a camera
        (reference core.py:532-552; its gizmo OBJs are absent from the repo,
        so procedural meshes stand in)."""
        from tpu_renderer.models import gizmos as gz

        sub = gz.make_sphere() if isinstance(obj, Light) else gz.make_camera_gizmo()
        sub.clip = False
        sub = sub @ T.scale(0.1)
        lookat = np.asarray(obj.lookat, np.float64)
        try:
            inv = np.linalg.inv(lookat)
        except np.linalg.LinAlgError:
            inv = np.linalg.pinv(lookat)
        sub = sub @ inv
        try:
            inv3 = np.linalg.inv(lookat[:3, :3])
        except np.linalg.LinAlgError:
            inv3 = np.linalg.pinv(lookat[:3, :3])
        sub.normals = (-sub.normals @ inv3).astype(np.float32) \
            if sub.normals is not None else None
        self.add_model(sub)

    def add_model(self, model: Model):
        self.models.append(model)

    # ------------------------------------------------------------- packing

    def _pack_model(self, model: Model) -> dict:
        key = id(model)
        cached = self._packets.get(key)
        if (cached is not None and cached["_verts_src"] is model.vertices
                and cached["_version"] == model._version):
            return cached

        F = model.num_faces
        Fp = max(_PAD, -(-F // _PAD) * _PAD)
        faces = model.face_array

        vid = _pad_rows(faces[:, :, 0].astype(np.int32), Fp)
        pad_valid = np.zeros(Fp, bool)
        pad_valid[:F] = True

        if model.uv is not None:
            uv = model.uv[faces[:, :, 1]][..., :2].astype(np.float32)
        else:
            uv = np.zeros((F, 3, 2), np.float32)
        uv = _pad_rows(uv, Fp)

        has_vn = model.normals is not None
        vn = (_pad_rows(model.normals[faces[:, :, 2]].astype(np.float32), Fp)
              if has_vn else None)

        mtl = faces[:, 0, 3].astype(np.int32)
        kd_t = _material_table(model, "Kd", 3)
        ks_t = _material_table(model, "Ks", 3)
        ns_t = _material_table(model, "Ns", 1)[:, 0]
        pm_t = _material_table(model, "Pm", 1)[:, 0]
        pr_t = _material_table(model, "Pr", 1)[:, 0]
        ka_t = _material_table(model, "Ka", 3)

        packet = {
            "_verts_src": model.vertices,
            "_version": model._version,
            "verts": jnp.asarray(model.vertices, jnp.float32),
            "vid": jnp.asarray(vid),
            "pad_valid": jnp.asarray(pad_valid),
            "uv": jnp.asarray(uv),
            "kd": jnp.asarray(_pad_rows(kd_t[mtl], Fp)),
            "ks": jnp.asarray(_pad_rows(ks_t[mtl], Fp)),
            "ns": jnp.asarray(_pad_rows(ns_t[mtl], Fp)),
            "pm": jnp.asarray(_pad_rows(pm_t[mtl], Fp)),
            "pr": jnp.asarray(_pad_rows(pr_t[mtl], Fp)),
            "ka": jnp.asarray(_pad_rows(ka_t[mtl], Fp)),
        }
        if has_vn:
            packet["vn"] = jnp.asarray(vn)

        # Edge incidence arrays for batched silhouette extraction (ops/shadow).
        et = model.edge_table
        inc_edge = np.zeros(3 * Fp, np.int32)
        inc_dir = np.zeros((3 * Fp, 2), np.int32)
        inc_valid = np.zeros(3 * Fp, bool)
        inc_edge[:3 * F] = et.incidence_edge
        inc_dir[:3 * F] = et.incidence_dir
        inc_valid[:3 * F] = True
        packet["inc_edge"] = jnp.asarray(inc_edge)
        packet["inc_dir"] = jnp.asarray(inc_dir)
        packet["inc_valid"] = jnp.asarray(inc_valid)

        flags = {}
        for kind, attr in (("kd", "map_Kd"), ("ks", "map_Ks"), ("norm", "norm")):
            st = _texture_stack(model, attr)
            flags[kind] = st is not None
            if st is None:
                packet[f"{kind}_slot"] = jnp.full(Fp, -1, jnp.int32)
                packet[f"{kind}_shape"] = jnp.ones((Fp, 2), jnp.float32)
                continue
            stack, slot, shape, tangent, scale_off = st
            packet[f"{kind}_stack"] = jnp.asarray(stack)
            packet[f"{kind}_slot"] = jnp.asarray(
                _pad_rows(slot[mtl], Fp) if F else slot[mtl])
            packet[f"{kind}_shape"] = jnp.asarray(_pad_rows(shape[mtl], Fp))
            packet[f"{kind}_scale_off"] = jnp.asarray(scale_off)
            if kind == "norm":
                packet["norm_tangent"] = jnp.asarray(
                    _pad_rows(tangent[mtl], Fp))
        if "norm_tangent" not in packet:
            packet["norm_tangent"] = jnp.zeros(Fp, bool)

        packet["_config"] = ModelConfig(
            num_faces=Fp, clip=model.clip, depth_test=model.depth_test,
            shadowing=model.shadowing, has_vn=has_vn,
            has_uv=model.uv is not None, num_edges=et.num_edges,
            has_map_kd=flags["kd"], has_map_ks=flags["ks"],
            has_norm=flags["norm"])
        self._packets[key] = packet
        return packet

    @staticmethod
    def _cam_dyn(cam) -> dict:
        return {
            "position": jnp.asarray(cam.position, jnp.float32),
            "center": jnp.asarray(cam.center, jnp.float32),
            "up": jnp.asarray(cam.up, jnp.float32),
            "fovy": jnp.float32(cam.fovy),
            "near": jnp.float32(cam.near),
            "far": jnp.float32(cam.far),
        }

    def _light_dyn(self) -> dict:
        lt = self.light
        return {
            "position": jnp.asarray(lt.position, jnp.float32),
            "center": jnp.asarray(lt.center, jnp.float32),
            "color": jnp.asarray(lt.color, jnp.float32),
            "ambient": jnp.asarray(lt.ambient, jnp.float32),
            "specular_strength": jnp.float32(lt.specular_strength),
            "constant": jnp.float32(lt.constant),
            "linear": jnp.float32(lt.linear),
            "quadratic": jnp.float32(lt.quadratic),
        }

    def _background(self):
        from tpu_renderer.ops.cubemap import CubeMap

        if isinstance(self.skybox, CubeMap):
            return "cubemap", None
        if self.skybox is not None:
            return "color", jnp.asarray(np.asarray(self.skybox, np.float32))
        # Reference default purple-ish background (core.py:600).
        return "color", jnp.asarray([64 / 255, 0.5, 198 / 255], jnp.float32)

    # -------------------------------------------------------------- render

    def _prepare(self, resolution=None):
        """Pack the scene into (static SceneConfig, dynamic input pytree)."""
        packets = [self._pack_model(m) for m in self.models]
        background, bg_color = self._background()

        cfg = SceneConfig(
            resolution=resolution or self.resolution, system=self.system,
            subsystem=self.subsystem, shadows=self.shadows,
            shader=self.shader, background=background,
            cam_projection_type=self.camera.projection_type,
            backface_culling=self.camera.backface_culling,
            has_debug_camera=self.debug_camera is not None,
            dbg_projection_type=(self.debug_camera.projection_type
                                 if self.debug_camera else 0),
            light_type=self.light.light_type,
            models=tuple(p["_config"] for p in packets),
        )
        dyn = {
            "models": [{k: v for k, v in p.items() if not k.startswith("_")}
                       for p in packets],
            "camera": self._cam_dyn(self.camera),
            "light": self._light_dyn(),
        }
        if self.debug_camera is not None:
            dyn["debug_camera"] = self._cam_dyn(self.debug_camera)
        if background == "color":
            dyn["background_color"] = bg_color
        else:
            dyn["skybox"] = self.skybox.as_device_arrays()
        return cfg, dyn

    def render(self) -> np.ndarray:
        """Render one frame; returns (H, W, 3) uint8, same as core.py:587-640."""
        ss = self.supersample
        if ss > 1 and (self.shader in ("wireframe", "points")
                       or self.debug_camera is not None):
            # Supersampling composes with neither the debug shaders (their
            # pixel splats are resolution-exact, not shade-averaged) nor the
            # host-side frustum overlay (drawn at native resolution on the
            # pre-flip frame). Warn instead of silently dropping the kwarg.
            import warnings
            reason = ("wireframe/points shader" if self.shader in
                      ("wireframe", "points") else "debug-camera overlay")
            warnings.warn(
                f"supersample={ss} is ignored with a {reason}; rendering at "
                "native resolution", RuntimeWarning, stacklevel=2)
        if ss > 1 and self.shader not in ("wireframe", "points") \
                and self.debug_camera is None:
            h, w = self.resolution
            cfg, dyn = self._prepare(resolution=(h * ss, w * ss))
            from tpu_renderer.ops.pipeline import render_ssaa_jit

            out, zbuf, tid, stencil = render_ssaa_jit(cfg, dyn, ss)
            self.last_zbuf, self.last_tid, self.last_stencil = \
                zbuf, tid, stencil
            return np.asarray(out)

        cfg, dyn = self._prepare()
        if self.shader in ("wireframe", "points"):
            return self._render_debug_shader(cfg, dyn)
        if self.debug_camera is not None and self.debug_overlay:
            # Debug overlays draw on the pre-flip float frame (core.py:638),
            # then flip + gamma 0.8 + quantize on the host.
            from tpu_renderer.ops.overlay import draw_view_frustum
            from tpu_renderer.ops.pipeline import render_core_jit

            frame_f32, zbuf, tid, stencil = render_core_jit(cfg, dyn)
            frame = np.asarray(frame_f32).astype(np.float64)
            zb = np.asarray(zbuf).astype(np.float64)
            # Overlay matrices in f64 (x64 scope; ops.transforms._flt): the
            # frustum-cube corners sit exactly ON the clip planes whenever
            # debug camera == main camera, so the overlay's clip decisions
            # must follow the reference's f64 numpy arithmetic.
            import jax
            with jax.enable_x64(True):
                cam_m = {k: np.asarray(v) for k, v in
                         self.camera._matrices().items()}
                dbg_m = {k: np.asarray(v) for k, v in
                         self.debug_camera._matrices().items()}
            draw_view_frustum(frame, cam_m, dbg_m, self.camera.position,
                              self.camera.near, self.camera.far,
                              self.resolution, zb, self.system)
            self.last_zbuf, self.last_tid, self.last_stencil = zb, tid, stencil
            return (np.clip(frame[::-1] ** 0.8, 0, 1) * 255).astype(np.uint8)

        out, zbuf, tid, stencil = render_frame_jit(cfg, dyn)
        self.last_zbuf, self.last_tid, self.last_stencil = zbuf, tid, stencil
        return np.asarray(out)

    # ------------------------------------------------------------- stats

    def stats(self):
        """Per-model render statistics from the last render() — the batched
        equivalent of the reference's per-face Errors printout
        (core.py:634-636). Returns a list of dicts of ints; each dict also
        carries ``by_error``, the same discard counters keyed by the
        reference's :class:`tpu_renderer.Errors` flags (triangular.py:15-20).

        NOTE: this is a debug helper that runs a SECOND device pass — it
        re-packs the scene and recomputes the whole vertex stage
        (pipeline.face_statistics) against the cached visibility buffer.
        Don't call it inside a hot render loop.
        """
        if self.last_tid is None:
            raise RuntimeError("render() must run before stats()")
        from tpu_renderer.ops.errors import Errors
        from tpu_renderer.ops.pipeline import face_statistics

        cfg, dyn = self._prepare()
        raw = face_statistics(cfg, dyn, jnp.asarray(self.last_tid))
        out = []
        for s in raw:
            d = {k: int(v) for k, v in s.items()}
            d["by_error"] = {
                Errors.BACK_FACE_CULLING: d["backface_culled"],
                Errors.EMPTY_B: d["degenerate"],
                Errors.WRONG_MIN_MAX: d["offscreen"],
                # Fragment-level discards collapse in the batched pipeline
                # (pipeline.face_statistics).
                Errors.CLIPPED | Errors.EMPTY_Z: d["occluded_or_clipped"],
            }
            out.append(d)
        return out

    def _render_debug_shader(self, cfg, dyn) -> np.ndarray:
        """Wireframe / points shaders (reference triangular.py:269-283), on
        device: the closed-form DDA inversion / scatter-max point splat
        (pipeline.render_debug_frame) replace the per-face host loops —
        O(faces) Python iteration mattered at 40k-face meshes."""
        from tpu_renderer.ops.pipeline import render_debug_frame

        out, zbuf, tid, stencil = render_debug_frame(cfg, dyn, self.shader)
        self.last_zbuf, self.last_tid, self.last_stencil = zbuf, tid, stencil
        return np.asarray(out)

    def _render_debug_shader_host(self, cfg, dyn) -> np.ndarray:
        """Host-loop reference implementation of the wireframe / points
        shaders (the round-2 path): kept as the comparison oracle for
        tests/test_overlay.py::test_device_debug_shaders_match_host."""
        import dataclasses

        from tpu_renderer.ops.overlay import draw_points, draw_wireframe
        from tpu_renderer.ops.pipeline import SHADER_GOURAUD, render_core_jit

        cfg2 = dataclasses.replace(cfg, shader=SHADER_GOURAUD)
        _, zbuf, tid, stencil = render_core_jit(cfg2, dyn)
        zb = np.asarray(zbuf).astype(np.float64)
        self.last_zbuf, self.last_tid, self.last_stencil = zb, tid, stencil

        h, w = self.resolution
        if cfg.background == "color":
            frame = np.broadcast_to(
                np.asarray(dyn["background_color"], np.float64),
                (h, w, 3)).copy()
        else:
            from tpu_renderer.ops.cubemap import fill_frame_from_skybox
            frame = np.asarray(fill_frame_from_skybox(
                dyn["skybox"], self.camera._matrices(),
                self.resolution)).astype(np.float64)

        mvp = np.asarray(self.camera.MVP, np.float64)
        vp = np.asarray(self.camera.viewport, np.float64)
        near, far = self.camera.near, self.camera.far
        tris, normals = [], []
        for m in self.models:
            v = m.vertices.astype(np.float64) @ mvp
            v = v / v[:, [3]]
            v = v @ vp
            # The reference linearizes vertex z before its (alternate)
            # wireframe/points shaders run (triangular.py:96, then :269/:277)
            # — the z test below compares against the linearized z-buffer.
            v[:, 2] = (2 * near * far) / (far + near - v[:, 2] * (far - near))
            fv = m.face_array[:, :, 0]
            tris.append(v[fv][:, :, :3])
            world = m.vertices[:, :3].astype(np.float64)
            n = np.cross(world[fv[:, 1]] - world[fv[:, 0]],
                         world[fv[:, 2]] - world[fv[:, 0]])
            norm = np.linalg.norm(n, axis=1, keepdims=True)
            normals.append(n / np.where(norm == 0, 1, norm))
        tris = np.concatenate(tris)
        normals = np.concatenate(normals)

        if self.shader == "wireframe":
            draw_wireframe(frame, zb, tris)
        else:
            draw_points(frame, tris, self.camera.position, normals)
        return (np.clip(frame[::-1] ** 0.8, 0, 1) * 255).astype(np.uint8)
