"""chip_smoke.py's phases at tiny sizes on the CPU mesh, its checks
against broken results, and its refusal to run without a GPU."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from haconvdr_tpu.config import ModelConfig  # noqa: E402


def _tiny(**kw):
    return ModelConfig.tiny(embedding_dim=32, **kw)


def test_phase_serve_tiny():
    res = cs.phase_serve(_tiny(), 3000, seed=0)
    assert res["requests"] == 7 and res["embedding_max_abs_err"] <= 1e-3


def test_phase_search_tiny():
    res = cs.phase_search(3000, 24, seed=0, dim=32, chunk=512, passage_chunk=1024)
    assert {k for k in res if k.endswith("mismatches")} == {
        f"{p}_{d}_id_mismatches" for p in ("sharded", "stream")
        for d in ("float32", "bfloat16", "int8")
    }


def test_phase_encode_tiny():
    res = cs.phase_encode(_tiny(), 2, 16, 32, seed=0)
    assert res["bf16_min_cos"] >= 0.999 and res["int8_min_cos"] >= 0.99
    assert res["bf16_memory"]["temp_size_in_bytes"] > 0


def test_phase_train_tiny():
    cfg = _tiny(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1, remat="mlp")
    res = cs.phase_train(cfg, 8, 32, 24, steps=3, seed=0)
    assert len(res["losses"]) == 3 and res["max_param_change"] > 0


def test_phase_four_search_tiny():
    res = cs.phase_four_search(5000, 16, seed=0, dim=32, chunk=256)
    assert res["cards"] == 8 and res["shard_rows"] * 8 >= 5000


def test_phase_four_train_tiny():
    res = cs.phase_four_train(_tiny(), 8, 32, 24, seed=0)
    assert res["dp"] == 8 and res["loss_dp"] == pytest.approx(res["loss_one"], rel=1e-5)
    assert res["max_rel_grad_diff"] <= cs.GRAD_TOL


def _tf32(tree):
    """f32 leaves rounded to TF32's 10 mantissa bits: the operands a TF32
    matmul multiplies (it then sums the products in f32)."""
    import jax
    import jax.numpy as jnp

    def rnd(a):
        a = np.asarray(a)
        if a.dtype != np.float32:
            return a
        return np.asarray(jax.lax.reduce_precision(jnp.asarray(a), exponent_bits=8, mantissa_bits=10))

    return jax.tree_util.tree_map(rnd, tree)


def test_search_check_passes_reordered_sums_and_fails_tf32(rng):
    """At 768-d the search limit passes another f32 summation order of the
    same operands (the plain scan at HIGHEST) and fails TF32 products."""
    import jax.numpy as jnp

    from haconvdr_tpu.ops import topk

    q = rng.randn(16, 768).astype(np.float32)
    p = rng.randn(20_000, 768).astype(np.float32)
    ref_s, ref_i = cs.oracle_topk(q, p, 100)
    tol = cs.reorder_tolerance(q, p)
    s, i = topk.topk_block(jnp.asarray(q), jnp.asarray(p), jnp.int32(20_000), 100, 4000)
    i = np.asarray(i)
    cs.check_topk("f32", s, i, ref_s, ref_i, cs.row_scores(q, p, i), tol)
    s, i = cs.oracle_topk(_tf32(q), _tf32(p), 100)
    with pytest.raises(AssertionError, match="scores differ"):
        cs.check_topk("tf32", s, i, ref_s, ref_i, cs.row_scores(q, p, i), tol)


def test_embedding_check_fails_tf32():
    """The encoder at HIGHEST is within EMB_TOL of the reference; the
    reference on TF32-rounded weights is not."""
    import jax
    import jax.numpy as jnp

    from haconvdr_tpu.models.encoder import encode, init_encoder_params

    cfg = _tiny()
    params = init_encoder_params(jax.random.PRNGKey(0), cfg)
    rs = np.random.RandomState(0)
    ids = rs.randint(4, cfg.vocab_size, (4, 32)).astype(np.int32)
    mask = np.ones_like(ids)
    ref = cs.reference_encode(params, cfg, ids, mask)
    got = np.asarray(encode(params, cfg, jnp.asarray(ids), jnp.asarray(mask)))
    assert np.abs(got - ref).max() <= cs.EMB_TOL
    assert np.abs(cs.reference_encode(_tf32(params), cfg, ids, mask) - ref).max() > cs.EMB_TOL


def test_grad_check_fails_tf32():
    """One step's gradients at TF32-rounded weights differ from the exact
    ones by more than GRAD_TOL, the limit dp and one card must meet."""
    import jax

    from haconvdr_tpu.models.encoder import init_encoder_params, stack_layer_params

    cfg = _tiny(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    params = stack_layer_params(init_encoder_params(jax.random.PRNGKey(0), cfg))
    batch = cs._train_batch(np.random.RandomState(0), 8, 32, 24, cfg.vocab_size)
    one = jax.devices()[:1]
    _, g = cs.train_grads(cfg, params, batch, one, 0)
    _, g_again = cs.train_grads(cfg, params, batch, one, 0)
    assert cs.grad_rel_diff(g_again, g) <= cs.GRAD_TOL
    _, g_tf32 = cs.train_grads(cfg, _tf32(params), batch, one, 0)
    assert cs.grad_rel_diff(g_tf32, g) > cs.GRAD_TOL


def _good(rng, q=3, k=5):
    ref_s = -np.sort(-rng.rand(q, k).astype(np.float32), axis=1)
    ref_i = rng.permutation(100)[: q * k].reshape(q, k)
    return ref_s, ref_i


@pytest.mark.parametrize(
    "break_it,message",
    [
        (lambda s, i, t: (s + 1e-3, i, t + 1e-3), "scores differ"),
        # a foreign row claiming a top-k score it does not have
        (lambda s, i, t: (s, np.where(np.arange(5) == 0, 1000, i), t - (np.arange(5) == 0)),
         "does not have its returned score"),
        (lambda s, i, t: (s, np.concatenate([i[:, :1], i[:, :-1]], 1), t), "duplicate"),
        (lambda s, i, t: (s[:, :4], i[:, :4], t[:, :4]), "broken"),
        (lambda s, i, t: (np.where(np.arange(5) == 4, -np.inf, s), i, t), "non-finite"),
    ],
)
def test_check_topk_rejects_wrong_results(rng, break_it, message):
    ref_s, ref_i = _good(rng)
    tol = np.full((3, 1), 1e-4)
    assert cs.check_topk("ok", ref_s, ref_i, ref_s, ref_i, ref_s, tol) == (0, 0.0)
    s, i, t = break_it(ref_s.copy(), ref_i.copy(), ref_s.copy())
    with pytest.raises(AssertionError, match=message):
        cs.check_topk("broken", s, i, ref_s, ref_i, t, tol)


def test_check_topk_allows_boundary_ties(rng):
    """A different row with the k-th score (a tie) is accepted and counted."""
    ref_s, ref_i = _good(rng)
    i = ref_i.copy()
    i[:, -1] = 1000 + np.arange(3)
    assert cs.check_topk("tie", ref_s, i, ref_s, ref_i, ref_s, np.zeros((3, 1))) == (3, 0.0)


def test_check_topk_rejects_swaps_without_a_tie(rng):
    """Each error within the limit but adding up beyond it: a returned
    row scored 0.9 limits above the oracle's list, whose own score is 0.9
    limits higher again, is not a tie with the row the oracle put there."""
    ref_s, ref_i = _good(rng)
    tol = np.full((3, 1), 1e-4)
    s = ref_s + 0.9e-4
    i = ref_i.copy()
    i[:, 0] = 1000 + np.arange(3)
    assert cs.check_topk("near", s, ref_i, ref_s, ref_i, s + 0.9e-4, tol)[0] == 0
    with pytest.raises(AssertionError, match="without a tie"):
        cs.check_topk("swap", s, i, ref_s, ref_i, s + 0.9e-4, tol)


def test_oracle_topk_chunks_keep_lowest_row_on_ties():
    rows = np.zeros((10, 4), np.float32)
    rows[[7, 2, 9]] = 1.0
    s, i = cs.oracle_topk(np.ones((1, 4), np.float32), rows, 3, chunk=4)
    assert i.tolist() == [[2, 7, 9]] and s.tolist() == [[4.0, 4.0, 4.0]]


def _run(cwd, env):
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True, text=True,
        env={**os.environ, **env}, timeout=300,
    )


def test_script_exits_nonzero_without_gpu():
    out = _run(REPO, {"JAX_PLATFORMS": "cpu"})
    assert out.returncode != 0 and '"ok"' not in out.stdout


def test_script_alone_exits_nonzero(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {"JAX_PLATFORMS": "cpu", "PYTHONPATH": ""}
    out = _run(str(tmp_path), env)
    assert out.returncode != 0 and '"ok"' not in out.stdout
