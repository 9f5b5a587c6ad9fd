"""Entry-point helpers: the compile-cache location and chip_smoke.py's
refusal to run without a GPU."""
import importlib.util
import os

import jax

from tpu_renderer.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_compile_cache_uses_env_dir(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        assert compile_cache.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_defaults_to_repo_dir(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = compile_cache.enable_compile_cache()
        assert path == os.path.join(REPO, ".jax_cache")
        assert path == compile_cache.DEFAULT_CACHE_DIR
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_chip_smoke_refuses_cpu(capsys):
    """No GPU: non-zero exit, no result line, no CPU fallback."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert jax.devices()[0].platform == "cpu"
    assert chip_smoke.main([]) != 0
    assert chip_smoke.main(["--four"]) != 0
    assert '"ok"' not in capsys.readouterr().out


def test_summarize_device_trace_reads_a_trace(tmp_path):
    """bench.py --trace's reader: busy time is the union of event intervals
    within the stream's window; ops come out largest first. The CPU trace
    has host streams only, which the default device filter leaves out."""
    import jax.numpy as jnp

    from tpu_renderer.utils.profiling import summarize_device_trace, trace

    f = jax.jit(lambda x: jnp.sin(x).sum())
    x = jnp.ones((256, 256))
    f(x).block_until_ready()
    with trace(str(tmp_path)):
        for _ in range(2):
            f(x).block_until_ready()
    rows = summarize_device_trace(str(tmp_path), n_frames=2,
                                  plane_prefix="/host:CPU", top=3)
    assert rows
    for row in rows:
        assert 0 < row["busy_ms"] <= row["window_ms"] + 1e-9
        assert 0 < row["busy_share"] <= 1
        ms = [op[0] for op in row["ops"]]
        assert ms == sorted(ms, reverse=True) and len(ms) <= 3
    assert summarize_device_trace(str(tmp_path)) == []
    assert summarize_device_trace(str(tmp_path / "absent")) == []
