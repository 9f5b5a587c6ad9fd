"""Device-mesh helpers for multi-chip rendering.

The scaling axes of a rasterizer are pixels and primitives (SURVEY.md §5.7-5.8):
the frame shards row-wise over a ``rows`` mesh axis (embarrassingly parallel),
and the face batch shards over a ``tris`` axis whose partial z/id/stencil
buffers merge with XLA collectives (pmin / pmax / psum — depth and signed
stencil counts are associative reductions). The mesh follows the algorithm
alone: the devices of one host reach each other all to all (NVLink), so
which device sits on which axis does not matter.
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh

__all__ = ["make_render_mesh", "ROWS_AXIS", "TRIS_AXIS"]

ROWS_AXIS = "rows"
TRIS_AXIS = "tris"


def make_render_mesh(devices=None, n_tris: int = 1) -> Mesh:
    """A ('rows', 'tris') mesh over the given (or all) devices.

    ``n_tris`` devices cooperate on the face batch per row block; the rest of
    the devices split the frame rows.
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if n % n_tris != 0:
        raise ValueError(f"{n} devices not divisible by n_tris={n_tris}")
    grid = np.asarray(devices).reshape(n // n_tris, n_tris)
    return Mesh(grid, (ROWS_AXIS, TRIS_AXIS))
