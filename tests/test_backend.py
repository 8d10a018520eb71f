"""ops/backend.py: the one place that chooses implementations, with the
JAX backend monkeypatched; and the compile-cache placement."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest

from haconvdr_tpu.ops import backend


def _on(monkeypatch, platform):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)


@pytest.mark.parametrize(
    "platform,dtype,k,dim,want",
    [
        ("cpu", "bfloat16", 100, 768, "xla"),
        ("cpu", "int8", 100, 768, "xla"),
        ("gpu", "float32", 100, 768, "fused" if jnp.dtype("float32") in backend.FUSED_SEARCH_DTYPES else "xla"),
        ("gpu", "bfloat16", 100, 768, "fused" if jnp.dtype("bfloat16") in backend.FUSED_SEARCH_DTYPES else "xla"),
        ("gpu", "int8", 100, 768, "fused" if jnp.dtype("int8") in backend.FUSED_SEARCH_DTYPES else "xla"),
        ("gpu", "bfloat16", 500, 768, "xla"),  # rescore-oversampled first stage
        ("gpu", "int8", 129, 768, "xla"),
        ("gpu", "bfloat16", 100, 100, "xla"),  # width not a multiple of 16
    ],
)
def test_search_impl(monkeypatch, platform, dtype, k, dim, want):
    _on(monkeypatch, platform)
    assert backend.search_impl(jnp.dtype(dtype), k, dim) == want


@pytest.mark.parametrize(
    "platform,dtype,want",
    [
        ("gpu", "bfloat16", "cudnn"),
        ("gpu", "float16", "cudnn"),
        ("gpu", "float32", "xla"),  # cuDNN's fused attention takes no f32
        ("cpu", "bfloat16", "xla"),
        ("cpu", "float32", "xla"),
    ],
)
def test_attention_impl(monkeypatch, platform, dtype, want):
    _on(monkeypatch, platform)
    assert backend.attention_impl(jnp.dtype(dtype)) == want


@pytest.mark.parametrize("platform", ["rocm", "METAL", "neuron"])
def test_unknown_backend_raises(monkeypatch, platform):
    _on(monkeypatch, platform)
    with pytest.raises(RuntimeError, match="no implementation"):
        backend.search_impl(jnp.dtype("bfloat16"), 100, 768)
    with pytest.raises(RuntimeError, match="no implementation"):
        backend.attention_impl(jnp.dtype("bfloat16"))


@pytest.mark.parametrize(
    "dtype,want",
    [
        ("float32", jax.lax.Precision.HIGHEST),
        ("float64", jax.lax.Precision.HIGHEST),
        ("bfloat16", jax.lax.Precision.DEFAULT),
        ("int8", jax.lax.Precision.DEFAULT),
    ],
)
def test_matmul_precision(dtype, want):
    assert backend.matmul_precision(jnp.dtype(dtype)) == want


def test_f32_search_traces_at_highest():
    """The plain scan's score matmul carries HIGHEST into the program for
    f32 (no TF32 on the GPU); bf16 and int8 keep the default."""
    from haconvdr_tpu.ops.topk import topk_block

    for dtype, highest in (("float32", True), ("bfloat16", False), ("int8", False)):
        q = jnp.zeros((4, 16), jnp.float32)
        p = jnp.zeros((64, 16), dtype)
        text = str(jax.make_jaxpr(lambda q, p: topk_block(q, p, 64, 5, 32))(q, p))
        assert "dot_general" in text
        assert ("Precision.HIGHEST" in text) == highest, (dtype, text)


_CACHE_PROBE = (
    "import jax; from haconvdr_tpu.utils.cache import enable_compilation_cache; "
    "d = enable_compilation_cache(); print(d); print(jax.config.jax_compilation_cache_dir)"
)


def _cache_dirs(env):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": repo, **env}
    out = subprocess.run(
        [sys.executable, "-c", _CACHE_PROBE], env=env, capture_output=True,
        text=True, check=True, timeout=120,
    )
    return repo, out.stdout.split()


def test_cache_honours_env(tmp_path):
    _, (chosen, configured) = _cache_dirs({"JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
    assert chosen == configured == str(tmp_path)


def test_cache_defaults_to_checkout(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    repo, (chosen, configured) = _cache_dirs({**env, "JAX_COMPILATION_CACHE_DIR": ""})
    assert chosen == configured == os.path.join(repo, ".jax_cache")
