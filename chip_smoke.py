"""Smoke test of the render path on one GPU (or, with --four, on four).

    python chip_smoke.py           # one card: render, time, compare, wireframe
    python chip_smoke.py --four    # only the 4-card sharded render + its check

Drives ``Scene.render()`` on the flagship scene (BASELINE config 5, built
from a seed by tpu_renderer.scenes) at 1024x1024, times a camera orbit,
compares the card's z-buffer, ids, stencil and frame with the same program
run on the host CPU, and checks the on-device wireframe shader against its
host loop. Every phase must pass. The last line of standard output is one
JSON object naming the device; earlier lines carry the measurements.

The script imports tpu_renderer before JAX starts, as any user does, so it
checks and times the build that ``Scene.render()`` runs: the one whose XLA
flags the package sets at import (tpu_renderer.precision), under which the
card's z-buffer, ids and stencil equal the CPU's bit for bit.

Exit codes: 0 all phases passed; 1 a phase failed; 2 no GPU or no
tpu_renderer package (no CPU fallback: nothing is measured and no result
line is printed).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

RESOLUTION = (1024, 1024)
ORBIT_FRAMES = 30


def _log(msg):
    print(msg, flush=True)


def _card_line():
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"
    return out.strip()


def _stats_ms(seconds):
    from tpu_renderer.utils.profiling import ms_summary

    s = ms_summary(seconds)
    return (f"median {s['median_ms']:.3f} ms, IQR {s['q1_ms']:.3f}-"
            f"{s['q3_ms']:.3f} ms, min {s['min_ms']:.3f} ms, max "
            f"{s['max_ms']:.3f} ms, n {s['n']}")


def _with_position(dyn, pos):
    return dict(dyn, camera=dict(dyn["camera"], position=pos))


def phase_render(state):
    """Scene.render() at full size; figure coverage and shadowed floor."""
    from tpu_renderer.scenes import flagship_scene

    scene = flagship_scene(RESOLUTION)
    t0 = time.perf_counter()
    frame = scene.render()
    state["first_render_s"] = time.perf_counter() - t0
    n_fig = scene._prepare()[0].models[0].num_faces
    tid = np.asarray(scene.last_tid)
    stencil = np.asarray(scene.last_stencil)
    figure_share = float(((tid >= 0) & (tid < n_fig)).mean())
    shadowed_floor = int(((stencil != 0) & (tid >= n_fig)).sum())
    _log(f"render: frame {frame.shape} {frame.dtype}, first Scene.render() "
         f"(trace + compile + run) {state['first_render_s']:.3f} s, figure "
         f"covers {figure_share:.4%} of pixels, {shadowed_floor} shadowed "
         f"floor pixels")
    assert frame.shape == (*RESOLUTION, 3) and frame.dtype == np.uint8
    assert figure_share > 0.002, figure_share
    assert shadowed_floor > 0
    state["scene"] = scene


def phase_time(state):
    """Camera orbit through render_frame_jit, one synchronized dispatch per
    frame (utils.profiling.orbit_times)."""
    import jax

    from tpu_renderer.ops.pipeline import _cam_matrices
    from tpu_renderer.ops.shadow import prepare_quads
    from tpu_renderer.scenes import orbit_positions
    from tpu_renderer.utils.profiling import orbit_times

    scene = state["scene"]
    cfg, dyn = scene._prepare()
    positions = orbit_positions(ORBIT_FRAMES)
    device_s = orbit_times(cfg, dyn, positions)
    host_s = orbit_times(cfg, dyn, positions, to_host=True)

    faces = sum(m.num_faces for m in scene.models)
    cam_m = _cam_matrices(cfg, dyn["camera"], cfg.cam_projection_type)
    screen, _, ok, n_sil, _ = jax.jit(
        lambda d, c: prepare_quads(cfg, d, c))(dyn, cam_m)
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    _log(f"time: compile (first Scene.render(): trace + compile + one run) "
         f"{state['first_render_s']:.3f} s, persistent cache "
         f"{'warm' if state['cache_warm'] else 'cold'}")
    _log(f"time: {ORBIT_FRAMES}-frame orbit, block_until_ready: "
         f"{_stats_ms(device_s)}")
    _log(f"time: {ORBIT_FRAMES}-frame orbit, frame copied to host: "
         f"{_stats_ms(host_s)}")
    _log(f"time: peak_bytes_in_use {peak}, faces {faces}, silhouette "
         f"quads {int(n_sil)} (clipped ok {int(np.asarray(ok).sum())}, "
         f"stencil table rows {screen.shape[0]})")


def phase_compare_cpu(state):
    """The same cfg/dyn and program on the host CPU: z, tid, stencil, frame."""
    import jax

    from tpu_renderer.ops.pipeline import render_frame_jit

    cfg, dyn = state["scene"]._prepare()
    gpu = [np.asarray(a) for a in render_frame_jit(cfg, dyn)]
    cpu_dev = jax.devices("cpu")[0]
    t0 = time.perf_counter()
    cpu = [np.asarray(a) for a in
           render_frame_jit(cfg, jax.device_put(dyn, cpu_dev))]
    cpu_s = time.perf_counter() - t0
    frame_g, z_g, tid_g, st_g = gpu
    frame_c, z_c, tid_c, st_c = cpu
    tid_diff = int((tid_g != tid_c).sum())
    st_diff = int((st_g != st_c).sum())
    z_diff = int((z_g != z_c).sum())
    px_same = float((frame_g == frame_c).all(-1).mean())
    max_dev = int(np.abs(frame_g.astype(int) - frame_c.astype(int)).max())
    _log(f"compare_cpu: resolution {cfg.resolution}, CPU render (compile + "
         f"run) {cpu_s:.1f} s; pixels differing: z {z_diff}, tid {tid_diff}, "
         f"stencil {st_diff}; frame identical on {px_same:.6%} of pixels, "
         f"max deviation {max_dev}/255")
    # Under tpu_renderer.precision every operation that decides coverage,
    # depth and stencil rounds the same on both devices: those must be
    # identical.
    # Shading also calls pow / exp, library routines whose last bit differs
    # between the backends, so a pixel may land one 8-bit step apart: the
    # frame is held to >= 99.9% identical pixels and the goldens' +-2/255.
    assert z_diff == tid_diff == st_diff == 0, "z / tid / stencil differ"
    assert px_same >= 0.999 and max_dev <= 2, "frame outside the bound"
    _log("compare_cpu: z, tid and stencil identical; frame within bound "
         "(>= 99.9% identical pixels, max deviation <= 2/255)")


def phase_wireframe(state):
    """On-device wireframe shader vs its host loop at full size."""
    scene = state["scene"]
    scene.shader = "wireframe"
    try:
        cfg, dyn = scene._prepare()
        t0 = time.perf_counter()
        device = scene._render_debug_shader(cfg, dyn)
        dev_s = time.perf_counter() - t0
        host = scene._render_debug_shader_host(cfg, dyn)
    finally:
        scene.shader = "general"
    same = float((device == host).all(-1).mean())
    bg = host[0, 0]
    drawn = int((device != bg).any(-1).sum())
    _log(f"wireframe: {same:.6%} of pixels identical to the host loop "
         f"(bound 98%), {drawn} device pixels drawn, first device call "
         f"{dev_s:.3f} s")
    assert same >= 0.98 and drawn > 0


def phase_four(state):
    """Sharded render on (4, 1) and (2, 2) meshes vs the single card."""
    import jax

    from tpu_renderer.ops.pipeline import render_frame_jit
    from tpu_renderer.parallel.mesh import make_render_mesh
    from tpu_renderer.parallel.sharded import render_frame_sharded
    from tpu_renderer.scenes import flagship_scene, orbit_positions

    devices = jax.devices()
    assert len(devices) >= 4, f"--four needs 4 devices, found {len(devices)}"
    cfg, dyn = flagship_scene(RESOLUTION)._prepare()
    single = [np.asarray(a) for a in render_frame_jit(cfg, dyn)]
    dyns = [_with_position(dyn, p) for p in orbit_positions(10)]

    def timed(fn):
        fn(dyn)[0].block_until_ready()
        secs = []
        for d in dyns:
            t0 = time.perf_counter()
            fn(d)[0].block_until_ready()
            secs.append(time.perf_counter() - t0)
        return secs

    one_s = timed(lambda d: render_frame_jit(cfg, d))
    _log(f"four: single card {_stats_ms(one_s)}")
    for n_tris in (1, 2):
        mesh = make_render_mesh(devices[:4], n_tris=n_tris)
        out = render_frame_sharded(cfg, dyn, mesh)
        cards = {s.device.id for s in out[0].addressable_shards}
        frame, z, _, st = (np.asarray(a) for a in out)
        same = float((frame == single[0]).all(-1).mean())
        z_ok = bool(np.array_equal(z, single[1]))
        st_ok = bool(np.array_equal(st, single[3]))
        secs = timed(lambda d: render_frame_sharded(cfg, d, mesh))
        _log(f"four: mesh {dict(mesh.shape)} on cards {sorted(cards)}: "
             f"frame identical on {same:.6%}, z equal {z_ok}, stencil "
             f"equal {st_ok}; {_stats_ms(secs)} (single card median "
             f"{np.median(one_s) * 1e3:.3f} ms)")
        assert len(cards) == 4 and z_ok and st_ok and same >= 0.999


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four", action="store_true",
                        help="run only the 4-card sharded phase")
    args = parser.parse_args(argv)

    try:
        from tpu_renderer import precision
    except ImportError as e:
        print(f"chip_smoke: tpu_renderer not importable ({e}); nothing "
              "measured", file=sys.stderr)
        return 2
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (found {devices[0].platform}); nothing "
              "measured", file=sys.stderr)
        return 2

    from tpu_renderer.utils.compile_cache import enable_compile_cache

    cache_dir = enable_compile_cache()
    state = {"cache_warm": os.path.isdir(cache_dir) and bool(os.listdir(cache_dir))}
    _log(f"compile cache: {cache_dir}")
    _log(f"card: {_card_line()}")
    _log(f"device: {devices[0].device_kind}, {len(devices)} visible, "
         f"jax {jax.__version__}")
    _log(f"XLA_FLAGS: {os.environ.get('XLA_FLAGS', '')}")
    if not precision.exact_f32_math_active():
        print("chip_smoke: tpu_renderer's exact-f32 XLA flags are not in "
              "effect", file=sys.stderr)
        return 1

    phases = ([phase_four] if args.four else
              [phase_render, phase_time, phase_compare_cpu, phase_wireframe])
    failed = []
    for phase in phases:
        name = phase.__name__
        t0 = time.perf_counter()
        try:
            phase(state)
        except Exception:   # report every phase, then fail the run
            traceback.print_exc()
            failed.append(name)
            _log(f"{name}: FAILED")
            if name == "phase_render":
                break
        _log(f"{name}: {time.perf_counter() - t0:.1f} s")
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
