"""Test harness configuration.

Forces JAX onto a virtual 8-device CPU platform so every test — including the
multi-chip sharding tests — runs without an accelerator (SURVEY.md §4c).

Also provides the ``reference`` fixture: the NumPy reference renderer, imported
from a checkout of it at ``REFERENCE_ROOT`` as a behavioral oracle (we execute
it for golden comparisons; we never copy its code). The reference has a dead
``numba`` import (triangular.py:3) and pre-NumPy-2.0 API usage, shimmed here.
Tests that need the reference or its asset files skip when it is absent.
"""
import os
import sys
import types

# Must run before the jax backend initializes. pytest plugins (jaxtyping) may
# already have imported jax's config module, freezing env defaults — so set
# both the env vars and the live config.
os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "--xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

from tpu_renderer.utils.compile_cache import enable_compile_cache  # noqa: E402

# Persist compiled executables across suite runs (the suite compiles
# hundreds of render programs; warm-cache runs skip all of it).
enable_compile_cache()

import numpy as np
import pytest

REFERENCE_ROOT = "/root/reference"
REFERENCE_OBJ = os.path.join(REFERENCE_ROOT, "obj")


def _install_reference_shims():
    # The reference imports numba but never uses it (triangular.py:3).
    if "numba" not in sys.modules:
        fake = types.ModuleType("numba")
        fake.jit = lambda *a, **k: (lambda f: f) if not (a and callable(a[0])) else a[0]
        sys.modules["numba"] = fake
    # np.row_stack was removed in NumPy 2.0; the reference uses it
    # (cube_map.py:78).
    if not hasattr(np, "row_stack"):
        np.row_stack = np.vstack


class ReferenceModules:
    """Lazily imported reference modules, path-shimmed."""

    def __init__(self):
        _install_reference_shims()
        for p in (REFERENCE_ROOT, REFERENCE_OBJ):
            if p not in sys.path:
                sys.path.insert(0, p)
        import obj.constants as constants          # noqa: F401
        import transformation                      # noqa: F401
        import plane_intersection                  # noqa: F401
        import core                                # noqa: F401
        import triangular                          # noqa: F401
        import cube_map                            # noqa: F401
        import frustums                            # noqa: F401
        import obj.line as line                    # noqa: F401
        from obj.lightning import Lightning        # noqa: F401

        self.constants = constants
        self.transformation = transformation
        self.plane_intersection = plane_intersection
        self.core = core
        self.triangular = triangular
        self.cube_map = cube_map
        self.frustums = frustums
        self.line = line
        self.Lightning = Lightning


_REF = None


def require_reference():
    """Skip the calling test when the reference checkout is absent."""
    if not os.path.isdir(REFERENCE_OBJ):
        pytest.skip(f"reference renderer not present at {REFERENCE_ROOT}")


@pytest.fixture(scope="session")
def reference():
    global _REF
    require_reference()
    if _REF is None:
        _REF = ReferenceModules()
    return _REF


@pytest.fixture(scope="session")
def diablo_path():
    require_reference()
    return os.path.join(REFERENCE_OBJ, "diablo3_pose", "diablo3_pose.obj")


CACHE_DIR = os.path.join(os.path.dirname(__file__), "_ref_cache")


@pytest.fixture(scope="session")
def ref_render():
    """Disk cache for executed-reference oracle frames.

    The NumPy reference costs seconds-to-minutes per frame and dominates the
    suite's wall time; the oracle scenes are deterministic, so repeat runs
    re-compute identical frames. ``ref_render(name, key, fn)`` returns the
    cached frame for (name, key) or executes ``fn`` once and stores the
    result under tests/_ref_cache/. The key must include every parameter the
    oracle scene depends on — any change hashes to a new file and forces a
    fresh reference execution. Delete tests/_ref_cache/ to re-execute
    everything (e.g. after a NumPy upgrade that could change the oracle).
    """
    import hashlib
    import json

    def get(name, key, fn):
        blob = json.dumps(key, sort_keys=True, default=repr)
        h = hashlib.sha1(blob.encode()).hexdigest()[:16]
        path = os.path.join(CACHE_DIR, f"{name}_{h}.npy")
        if os.path.exists(path):
            return np.load(path)
        out = np.asarray(fn())
        os.makedirs(CACHE_DIR, exist_ok=True)
        np.save(path, out)
        return out

    return get
