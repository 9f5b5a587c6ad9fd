"""Line drawing: DDA stepper and z-tested anti-aliased line splatting.

Parity with the reference's ``obj/line.py``: ``bresenham_line`` is (as there)
actually a uniform-step DDA that normalizes to right-to-left drawing
(line.py:6-16); ``draw_line`` clips against the inverse viewport in clip space,
z-tests, and splats a poor-man's anti-aliased +-1 pixel half-blend
(line.py:19-50). These are host-side debug utilities operating on numpy
buffers, exactly like the overlay layer that uses them (reference runs them on
the host frame too); the hot rendering path never touches them.

``pack_lines`` / ``wireframe_mask`` are the device form of the wireframe
shader's DDA (pipeline.render_debug_frame): each edge's DDA is inverted in
closed form per pixel, streamed over edge chunks like ops/raster_xla.py.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["bresenham_line", "draw_line", "splat_line_aa", "pack_lines",
           "wireframe_mask"]


def bresenham_line(start_point, end_point):
    """Uniform-step DDA along the major axis (reference line.py:6-16).

    Keeps the reference's right-to-left normalization quirk: lines with
    increasing x are drawn from their far endpoint.
    """
    start_point = np.asarray(start_point, dtype=np.float64)
    end_point = np.asarray(end_point, dtype=np.float64)
    delta = end_point - start_point
    if delta[0] > 0:
        return bresenham_line(end_point, start_point)
    steps = np.max(np.abs(delta[:2]))
    if steps == 0:
        return start_point[None]
    step_size = delta / steps
    return start_point + np.arange(int(steps))[:, None] * step_size


def splat_line_aa(frame, z_buffer, x, y, z, color, sign):
    """Z-tested pixel write + +-1px half-blend AA (frustums.py:84-103).

    x: row indices, y: column indices (the reference's swapped naming), z:
    depths; writes in place.
    """
    h, w = z_buffer.shape
    idx = ((z_buffer[x, y] - z) * sign >= 0)
    x, y, z = x[idx], y[idx], z[idx]
    z_buffer[x, y] = z
    frame[x, y] = color
    for i in (-1, 1):
        xs = np.clip(x + i, 0, h - 1)
        ys = np.clip(y + i, 0, w - 1)
        z_buffer[xs, y] = z
        z_buffer[x, ys] = z
        frame[xs, y] = frame[xs, y] * 0.5 + np.asarray(color) / 2
        frame[x, ys] = frame[x, ys] * 0.5 + np.asarray(color) / 2
    return frame, z_buffer


def draw_line(start, end, camera_matrices, resolution, z_buffer, frame,
              color=(1.0, 0.0, 0.0)):
    """Screen-space line with inverse-viewport clip test (line.py:19-50).

    camera_matrices: dict with 'viewport' (host numpy). Operates on the
    pre-flip frame orientation like the reference.
    """
    viewport = np.asarray(camera_matrices["viewport"], np.float64)
    inv_viewport = np.linalg.inv(viewport)
    pxls = bresenham_line(np.asarray(start), np.asarray(end))
    homog = pxls.copy()
    homog[:, 3] = 1
    pxls_ndc = homog @ inv_viewport
    pxls_clip = pxls_ndc / pxls[:, [3]]
    w = pxls_clip[:, 3]
    inside = ((-w < pxls_clip[:, 0]) & (pxls_clip[:, 0] < w) &
              (-w < pxls_clip[:, 1]) & (pxls_clip[:, 1] < w) &
              (-w < pxls_clip[:, 2]) & (pxls_clip[:, 2] < w))
    if not inside.any():
        return
    y, x, z, _ = pxls[inside].T
    x = x.astype(np.int32)
    y = y.astype(np.int32)
    keep = z_buffer[x, y] > z
    x, y, z = x[keep], y[keep], z[keep]
    z_buffer[x, y] = z
    frame[x, y] = color
    h, w_res = resolution
    for i in (-1, 1):
        xs = np.clip(x + i, 0, h - 1)
        ys = np.clip(y + i, 0, w_res - 1)
        z_buffer[xs, y] = z
        z_buffer[x, ys] = z
        frame[xs, y] = frame[xs, y] * 0.5 + np.array([0.5, 0, 0])
        frame[x, ys] = frame[x, ys] * 0.5 + np.array([0.5, 0, 0])


def pack_lines(p0, p1):
    """Directed screen-space edges -> closed-form DDA table.

    Replicates :func:`bresenham_line` (reference line.py:6-16) in closed
    form: right-to-left normalization (dx > 0 swaps endpoints), steps =
    max(|dx|, |dy|), ``int(steps)`` uniform float steps, truncating int cast
    per emitted pixel. A zero-length edge draws its single start pixel; a
    sub-pixel edge (0 < steps < 1) draws nothing, like the host DDA.

    p0/p1: (E, 3) float32 (x, y, z) endpoints. Returns (E, 8) float32 rows
    [x0, y0, z0, step_x, step_y, step_z, step count, major-x flag].
    """
    swap = (p1[:, 0] - p0[:, 0]) > 0
    a = jnp.where(swap[:, None], p1, p0)
    b = jnp.where(swap[:, None], p0, p1)
    d = b - a
    adx = jnp.abs(d[:, 0])
    ady = jnp.abs(d[:, 1])
    steps = jnp.maximum(adx, ady)
    pt = steps == 0
    stepv = d / jnp.where(pt, 1.0, steps)[:, None]
    nsteps = jnp.where(pt, 1.0, jnp.floor(steps))
    majx = jnp.where(pt, True, adx >= ady).astype(jnp.float32)
    return jnp.concatenate([a, stepv, nsteps[:, None], majx[:, None]], axis=1)


def _line_pixels(line, rows, cols):
    """(H, W) on-line mask and DDA depth of ONE packed edge.

    Along the major axis the DDA step is exactly +-1, so the step index that
    lands on a pixel is k = floor(x0 - col) (major-x: the normalization makes
    the x step -1) or the matching ceil/floor form in y; the pixel is on the
    line iff the minor axis truncates to it at that step. Coordinates are
    positive wherever the frame test passes, so trunc == floor.
    """
    x0, y0, z0, sxv, syv, szv, nst, majx = (line[i] for i in range(8))
    majx = majx > 0
    k_x = jnp.floor(x0 - cols)
    k_y = jnp.where(syv > 0, jnp.ceil(rows - y0), jnp.floor(y0 - rows))
    kk = jnp.where(majx, k_x, k_y)
    other = jnp.where(majx, jnp.floor(y0 + kk * syv) - rows,
                      jnp.floor(x0 + kk * sxv) - cols)
    lit = (other == 0) & (kk >= 0) & (kk < nst)
    return lit, z0 + kk * szv


def wireframe_mask(lines, active, zbuf, chunk=8):
    """Wireframe coverage vs the final z-buffer. Returns (H, W) bool.

    The host wireframe (ops/overlay.draw_wireframe, reference
    triangular.py:269-274) walks DDA pixels per edge against a mutating
    z-buffer; since every edge writes the same color, a pixel is lit iff ANY
    edge's DDA pixel inside the frame's open interior passes the strict
    ``z_buffer - z > 0`` test (no handedness sign: the reference shader
    hard-codes ``> 0``) against the render z-buffer.

    lines: (E, 8) from :func:`pack_lines`; active: (E,) bool.
    """
    height, width = zbuf.shape
    rows = jnp.arange(height, dtype=jnp.float32)[:, None]
    cols = jnp.arange(width, dtype=jnp.float32)[None, :]
    # Host bounds are 0 < row < h-1 and 0 < col < w-1.
    inframe = ((rows > 0) & (rows < height - 1) &
               (cols > 0) & (cols < width - 1))
    pad = (-lines.shape[0]) % chunk
    lines = jnp.concatenate([lines, jnp.zeros((pad, 8), lines.dtype)])
    active = jnp.concatenate([active, jnp.zeros(pad, bool)])

    def body(mask, xs):
        chunk_lines, chunk_active = xs
        for k in range(chunk):
            lit, z = _line_pixels(chunk_lines[k], rows, cols)
            mask |= lit & (zbuf - z > 0) & chunk_active[k]
        return mask, None

    mask, _ = jax.lax.scan(
        body, jnp.zeros((height, width), bool),
        (lines.reshape(-1, chunk, 8), active.reshape(-1, chunk)))
    return mask & inframe
