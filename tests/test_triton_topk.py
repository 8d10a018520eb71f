"""The fused search kernel (ops/triton_topk.py) in Pallas interpret mode:
its panels, its exact selection, the fallback, and the paths that call it
(ops/topk.fused_topk_block, BlockSearcher, sharded_topk), against the
HIGHEST-precision oracle.

Scores: f32/bf16 results may differ from the oracle in the last bits
(the same products summed in another order), so scores compare at rtol
1e-5 and ids exactly on random data; int8 scores are exact integers times
one f32 scale, so they compare at rtol 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from haconvdr_tpu.index.quantize import quantize_int8
from haconvdr_tpu.ops import backend, topk, triton_topk

DTYPES = ["float32", "bfloat16", "int8"]


def _index(rng, n, d, dtype):
    """(passages as stored, queries as the caller passes them, oracle
    operands (q, p) in f32, per-query post-scale or None)."""
    x = rng.randn(n, d).astype(np.float32)
    q = rng.randn(7, d).astype(np.float32)
    return _operands(x, q, dtype)


def _operands(x, q, dtype):
    if dtype == "int8":
        codes, scale = quantize_int8(x)
        qf = q * scale[None, :]
        qs = np.maximum(np.abs(qf).max(axis=1), np.float32(1e-30))
        qc = np.clip(np.round(qf / qs[:, None] * np.float32(127.0)), -127, 127)
        return (jnp.asarray(codes), jnp.asarray(qf), (qc, codes.astype(np.float32)),
                qs / np.float32(127.0))
    p = jnp.asarray(x, dtype)
    qo = np.asarray(jnp.asarray(q, dtype).astype(jnp.float32))
    return p, jnp.asarray(q), (qo, np.asarray(p.astype(jnp.float32))), None


def _oracle(ops, post, k, n_valid):
    q, p = ops
    s, i = topk.exact_topk_oracle(jnp.asarray(q), jnp.asarray(p[:n_valid]), k)
    s = np.asarray(s)
    if post is not None:
        s = s * post[:, None]
    return s, np.asarray(i)


def _select(q, p, n_valid, k, budget):
    """The kernel's panels and the exact selection, without the fallback."""
    qo, _ = topk._operands(q, p)
    n_q = qo.shape[0]
    geo = topk.fused_geometry(p.shape[0], k, p.shape[1], n_q)
    qo = jnp.pad(qo, ((0, -n_q % geo["block_q"]), (0, 0)))
    v1, a1, v2 = triton_topk.window_top2(qo, p, jnp.int32(n_valid), **geo)
    return triton_topk.select_from_windows(
        qo, p, jnp.int32(n_valid), v1, a1, v2, k, geo["window"], geo["block_p"], budget, n_q
    )


def _window(w, n, k, d):
    """The rows of window ``w`` of the fused kernel at these shapes."""
    geo = topk.fused_geometry(n, k, d, 1)
    return np.asarray(triton_topk.window_rows(jnp.int32(w), n, geo["window"], geo["block_p"]))


def _assert_matches(s, i, ref_s, ref_i, dtype):
    rtol = 1e-6 if dtype == "int8" else 1e-5
    np.testing.assert_allclose(np.asarray(s), ref_s, rtol=rtol, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(i), ref_i)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", [1, 10, 100])
def test_fused_matches_oracle(rng, dtype, k):
    n, d = 4096, 32
    p, q, ops, post = _index(rng, n, d, dtype)
    s, i = topk.fused_topk_block(q, p, jnp.int32(n), k, 1024, budget=64)
    _assert_matches(s, i, *_oracle(ops, post, k, n), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_valid,n_queries", [(3000, 5), (4001, 19)])
def test_fused_ragged_rows_and_queries(rng, dtype, n_valid, n_queries):
    """n_valid < N (padded tail masked in-kernel) and a query count that
    is not a tile multiple (padded, then sliced off)."""
    n, d, k = 4096, 32, 10
    x = rng.randn(n, d).astype(np.float32)
    x[n_valid:] = 50.0  # padding rows that would win if not masked
    q = rng.randn(n_queries, d).astype(np.float32)
    p, qj, ops, post = _operands(x, q, dtype)
    s, i = topk.fused_topk_block(qj, p, jnp.int32(n_valid), k, 1024)
    assert s.shape == (n_queries, k)
    _assert_matches(s, i, *_oracle(ops, post, k, n_valid), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_ties_take_lowest_rows(rng, dtype):
    """Duplicated rows score identically: like lax.top_k over the whole
    score row, the lowest rows win, in row order."""
    n, d, k = 4096, 32, 10
    x = rng.randn(n, d).astype(np.float32) * 0.1
    hot = rng.randn(d).astype(np.float32)
    dup_rows = np.array([3000, 17, 2048, 555, 4000, 1024, 90, 3333])
    x[dup_rows] = hot
    q = np.tile(hot, (3, 1))
    p, qj, ops, post = _operands(x, q, dtype)
    s, i = topk.fused_topk_block(qj, p, jnp.int32(n), k, 1024)
    np.testing.assert_array_equal(np.asarray(i)[:, :8], np.tile(np.sort(dup_rows), (3, 1)))
    _assert_matches(s, i, *_oracle(ops, post, k, n), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_flagged_windows_are_rescored(rng, dtype):
    """Several top-k rows in one window: the window's second value clears
    the k-th window bound, the window is rescored in full, and the result
    stays exact without the fallback."""
    n, d, k = 4096, 32, 10
    x = rng.randn(n, d).astype(np.float32)
    q = rng.randn(3, d).astype(np.float32)
    x[_window(9, n, k, d)[:6]] = q[0] * 3.0 + rng.randn(6, d).astype(np.float32) * 0.01
    p, qj, ops, post = _operands(x, q, dtype)
    _, _, n_flag, _ = _select(qj, p, n, k, 8)
    assert 1 <= int(np.max(n_flag)) <= 8
    s_all, i_all = topk.fused_topk_block(qj, p, jnp.int32(n), k, 1024)
    _assert_matches(s_all, i_all, *_oracle(ops, post, k, n), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_budget_overflow_falls_back_exactly(rng, dtype):
    """More flagged windows than the budget: those queries take the plain
    path and the call stays exact."""
    n, d, k = 4096, 32, 64
    p, q, ops, post = _index(rng, n, d, dtype)
    _, _, n_flag, _ = _select(q, p, n, k, 1)
    assert int(np.max(n_flag)) > 1
    s, i = topk.fused_topk_block(q, p, jnp.int32(n), k, 1024, budget=1)
    _assert_matches(s, i, *_oracle(ops, post, k, n), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("crowded", [(1,), (1, 4, 6), tuple(range(7))])
def test_fallback_is_per_query(rng, dtype, crowded):
    """Queries whose top-k rows share windows go over the flag budget;
    only they are searched again, and every answer stays exact."""
    n, d, k = 4096, 32, 10
    x = rng.randn(n, d).astype(np.float32)
    q = rng.randn(7, d).astype(np.float32)
    # each crowded query: top-k rows in 6 windows, 4 in each
    for j in crowded:
        for w in range(2 + j, 64, 9)[:6]:
            x[_window(w, n, k, d)[4 * j : 4 * j + 4]] = (
                q[j] * 3.0 + rng.randn(4, d).astype(np.float32) * 0.1
            )
    p, qj, ops, post = _operands(x, q, dtype)
    flags, _ = (np.asarray(a) for a in topk.fused_flags(qj, p, jnp.int32(n), k))
    assert flags.shape == (7,) and (flags[list(crowded)] >= 6).all()
    s, i = topk.fused_topk_block(qj, p, jnp.int32(n), k, 1024, budget=4)
    _assert_matches(s, i, *_oracle(ops, post, k, n), dtype)


def test_rescan_touches_only_queries_to_redo(rng):
    """_rescan replaces exactly the rows marked to redo, across several
    passes and a last partial slot, and leaves the others as they were."""
    n, d, k = 2048, 16, 5
    p = jnp.asarray(rng.randn(n, d).astype(np.float32))
    q = jnp.asarray(rng.randn(9, d).astype(np.float32))
    s0 = jnp.full((9, k), 7.0)
    i0 = jnp.full((9, k), -5, jnp.int32)
    redo = jnp.asarray(np.array([1, 0, 1, 1, 0, 0, 1, 1, 0], bool))
    s, i = topk._rescan(q, p, jnp.int32(n), s0, i0, redo, k, 1024, 2)
    ref_s, ref_i = topk.exact_topk_oracle(q, p, k)
    r = np.asarray(redo)
    np.testing.assert_array_equal(np.asarray(i)[r], np.asarray(ref_i)[r])
    np.testing.assert_allclose(np.asarray(s)[r], np.asarray(ref_s)[r], rtol=1e-5)
    assert (np.asarray(s)[~r] == 7.0).all() and (np.asarray(i)[~r] == -5).all()


@pytest.mark.parametrize("dtype", DTYPES)
def test_window_panels_match_numpy(rng, dtype):
    """(max, lowest argmax row, second max) per window of the masked
    score matrix, windows taken from interleaved tiles."""
    n, d, n_valid = 1024, 32, 1000
    p, q, ops, post = _index(rng, n, d, dtype)
    qo, _ = topk._operands(q, p)
    geo = dict(window=64, block_q=16, block_p=128, block_k=16, num_warps=4, num_stages=2)
    qp = jnp.pad(qo, ((0, 16 - qo.shape[0]), (0, 0)))
    v1, a1, v2 = (np.asarray(a)[:7] for a in triton_topk.window_top2(qp, p, jnp.int32(n_valid), **geo))
    full = ops[0] @ ops[1].T
    full[:, n_valid:] = -np.inf
    rows = np.asarray(triton_topk.window_rows(jnp.arange(n // 64), n, 64, 128))
    assert sorted(rows.ravel().tolist()) == list(range(n))
    assert (np.diff(rows, axis=1) == n // 128).all()  # tile j: rows j + a * n_tiles
    w = full[:, rows]  # [7, n_win, window]
    np.testing.assert_allclose(v1, w.max(axis=2), rtol=1e-5)
    np.testing.assert_array_equal(a1, np.take_along_axis(rows[None], w.argmax(axis=2)[..., None], 2)[..., 0])
    second = np.sort(w, axis=2)[:, :, -2]
    np.testing.assert_allclose(v2, second, rtol=1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
def test_runs_of_alike_rows_spread_over_windows(rng, dtype):
    """A query's top-k as one run of consecutive, nearly equal rows (one
    article's chunks): interleaved tiles put each in its own window, so
    nothing is flagged and the fused answer stands."""
    n, d, k = 4096, 32, 10
    x = rng.randn(n, d).astype(np.float32)
    q = rng.randn(3, d).astype(np.float32)
    x[1000:1016] = q[0] * 3.0 + rng.randn(16, d).astype(np.float32) * 0.01
    p, qj, ops, post = _operands(x, q, dtype)
    flags, tie = (np.asarray(a) for a in topk.fused_flags(qj, p, jnp.int32(n), k))
    assert flags[0] == 0 and not tie[0]
    s, i = topk.fused_topk_block(qj, p, jnp.int32(n), k, 1024)
    _assert_matches(s, i, *_oracle(ops, post, k, n), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_dup,searched_again", [(14, False), (24, True)])
def test_boundary_tie_takes_lowest_rows(rng, dtype, n_dup, searched_again):
    """Equal top rows, one per window, placed so that window order and row
    order disagree.  Up to k + TIE_SLACK of them are all taken; more send
    the query to the plain scan.  Either way the lowest rows win, as in
    the oracle."""
    n, d, k = 4096, 32, 10
    x = rng.randn(n, d).astype(np.float32) * 0.1
    hot = rng.randn(d).astype(np.float32)
    wins = rng.permutation(64)[:n_dup]
    dup_rows = np.array([_window(w, n, k, d)[rng.randint(64)] for w in wins])
    x[dup_rows] = hot
    q = np.stack([hot, -hot])  # the copies rank first, and last
    p, qj, ops, post = _operands(x, q, dtype)
    flags, tie = (np.asarray(a) for a in topk.fused_flags(qj, p, jnp.int32(n), k))
    assert flags[0] == 0 and tie.tolist() == [searched_again, False]
    s, i = topk.fused_topk_block(qj, p, jnp.int32(n), k, 1024)
    np.testing.assert_array_equal(np.asarray(i)[0], np.sort(dup_rows)[:k])
    _assert_matches(s, i, *_oracle(ops, post, k, n), dtype)


@pytest.mark.parametrize(
    "n_rows,k,dim,n_queries,window,block_q,block_k",
    [
        (2_560_000, 100, 768, 2048, 128, 128, 64),
        (2_560_000, 100, 768, 1, 128, 16, 64),
        (4096, 10, 32, 7, 64, 16, 32),
        (4096, 100, 48, 40, 16, 64, 16),
    ],
)
def test_fused_geometry(n_rows, k, dim, n_queries, window, block_q, block_k):
    geo = topk.fused_geometry(n_rows, k, dim, n_queries)
    assert (geo["window"], geo["block_q"], geo["block_k"]) == (window, block_q, block_k)
    assert geo["block_p"] == 2 * window
    for v in (geo["window"], geo["block_q"], geo["block_p"], geo["block_k"]):
        assert v & (v - 1) == 0  # Triton block sizes are powers of two


@pytest.mark.parametrize("dtype", DTYPES)
def test_block_searcher_fused(rng, monkeypatch, dtype):
    """BlockSearcher over two streamed blocks through the fused kernel
    equals the oracle over their concatenation."""
    d, k = 32, 10
    x = rng.randn(5000, d).astype(np.float32)
    q = rng.randn(6, d).astype(np.float32)
    ids = np.arange(5000, dtype=np.int64) + 100
    monkeypatch.setattr(backend, "search_impl", lambda *a: "fused")
    searcher = BlockSearcher_for(dtype)
    if dtype == "int8":
        blocks = [(*quantize_int8(x[a:b])[:1], ids[a:b], quantize_int8(x[a:b])[1])
                  for a, b in ((0, 3000), (3000, 5000))]
        ref = []
        for blk in blocks:
            qf = q * blk[2][None, :]
            qs = np.maximum(np.abs(qf).max(axis=1), np.float32(1e-30))
            qc = np.clip(np.round(qf / qs[:, None] * np.float32(127.0)), -127, 127)
            ref.append((qc @ blk[0].astype(np.float32).T) * (qs / np.float32(127.0))[:, None])
        full = np.concatenate(ref, axis=1)
    else:
        blocks = [(x[:3000], ids[:3000]), (x[3000:], ids[3000:])]
        xo = np.asarray(jnp.asarray(x, dtype).astype(jnp.float32))
        qo = np.asarray(jnp.asarray(q, dtype).astype(jnp.float32))
        full = np.asarray(jnp.dot(qo, xo.T, precision="highest"))
    s, i = searcher.search(q, blocks)
    ref_s, ref_i = jax.lax.top_k(jnp.asarray(full), k)
    _assert_matches(s, i, np.asarray(ref_s), ids[np.asarray(ref_i)], dtype)


def BlockSearcher_for(dtype):
    return topk.BlockSearcher(
        top_k=10, passage_chunk=1024,
        compute_dtype="bfloat16" if dtype == "bfloat16" else "float32",
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sharded_topk_fused(rng, monkeypatch, dtype):
    """sharded_topk over the 8-device mesh with the fused kernel in every
    shard equals the oracle, across the shard holding the n_valid edge."""
    from haconvdr_tpu.parallel.mesh import make_mesh
    from haconvdr_tpu.parallel.sharded_search import sharded_topk

    n_valid, d, k = 7_000, 32, 10
    x = np.zeros((8 * 1024, d), np.float32)
    x[:n_valid] = rng.randn(n_valid, d)
    q = rng.randn(5, d).astype(np.float32)
    monkeypatch.setattr(backend, "search_impl", lambda *a: "fused")
    s, i = sharded_topk(
        make_mesh(), jnp.asarray(q, dtype), jnp.asarray(x, dtype), n_valid, k, chunk=512
    )
    xo = np.asarray(jnp.asarray(x[:n_valid], dtype).astype(jnp.float32))
    qo = np.asarray(jnp.asarray(q, dtype).astype(jnp.float32))
    ref_s, ref_i = topk.exact_topk_oracle(jnp.asarray(qo), jnp.asarray(xo), k)
    _assert_matches(s, i, np.asarray(ref_s), np.asarray(ref_i), dtype)


def test_sharded_index_int8_fused(rng, monkeypatch):
    """ShardedIndex int8 (per-shard scales) through the fused kernel
    equals the plain path bit for bit: both score exact integers."""
    from haconvdr_tpu.parallel.mesh import make_mesh
    from haconvdr_tpu.parallel.sharded_search import ShardedIndex

    x = rng.randn(6000, 32).astype(np.float32)
    q = rng.randn(5, 32).astype(np.float32)
    plain = ShardedIndex(make_mesh(), x, chunk=512, dtype="int8")
    s1, i1 = plain.search(q, 10)
    monkeypatch.setattr(backend, "search_impl", lambda *a: "fused")
    fused = ShardedIndex(make_mesh(), x, chunk=512, dtype="int8")
    s2, i2 = fused.search(q, 10)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_array_equal(s1, s2)
