"""Card-only checks: compiled (not interpreted) kernels on an NVIDIA GPU.

Marked ``gpu``; each skips inside its fixture unless JAX runs on a GPU,
so on the CPU suite they are collected everywhere and skip with a reason.
On the card: ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu.py``.
chip_smoke.py runs the same checks at full width in its search and encode
phases.
"""

import os
import sys

import jax
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture()
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (runs on the card; chip_smoke.py covers it)")


def test_fused_search_compiled(gpu):
    res = cs.phase_search(262_144, 256, seed=0)
    assert res["bfloat16_impl"] == res["int8_impl"] == "fused"


def test_cudnn_attention_compiled(gpu):
    impl, _ = cs.check_attention(0, batch=8)
    assert impl == "cudnn"
