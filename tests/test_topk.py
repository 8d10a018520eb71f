"""Blocked top-k search vs full-matrix oracle, merge semantics, dedup."""

import numpy as np
import jax.numpy as jnp

from haconvdr_tpu.ops.topk import (
    BlockSearcher,
    exact_topk_oracle,
    merge_topk,
    topk_block,
)
from haconvdr_tpu.eval.trec import dedup_ranked_candidates


def _data(rng, q=7, n=1000, d=16):
    queries = rng.randn(q, d).astype(np.float32)
    passages = rng.randn(n, d).astype(np.float32)
    return queries, passages


def test_topk_block_matches_oracle(rng):
    queries, passages = _data(rng)
    k = 10
    ref_s, ref_i = exact_topk_oracle(jnp.asarray(queries), jnp.asarray(passages), k)
    # pad to chunk multiple
    chunk = 128
    n = passages.shape[0]
    pad = (-n) % chunk
    padded = np.concatenate([passages, np.zeros((pad, passages.shape[1]), np.float32)])
    s, i = topk_block(jnp.asarray(queries), jnp.asarray(padded), jnp.int32(n), k, chunk)
    np.testing.assert_allclose(np.asarray(s), np.asarray(ref_s), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(i), np.asarray(ref_i))


def test_topk_block_k_larger_than_chunk(rng):
    queries, passages = _data(rng, q=3, n=64, d=8)
    k = 20
    chunk = 16
    ref_s, ref_i = exact_topk_oracle(jnp.asarray(queries), jnp.asarray(passages), k)
    s, i = topk_block(jnp.asarray(queries), jnp.asarray(passages), jnp.int32(64), k, chunk)
    np.testing.assert_allclose(np.asarray(s), np.asarray(ref_s), rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(i), np.asarray(ref_i))


def test_merge_topk_prefers_earlier_on_ties():
    # reference 2-pointer merge keeps the earlier block's entry on equal
    # scores (src/test_HAConvDR_topiocqa.py:137)
    sa = jnp.asarray([[5.0, 3.0]])
    ia = jnp.asarray([[10, 11]], dtype=jnp.int32)
    sb = jnp.asarray([[5.0, 4.0]])
    ib = jnp.asarray([[20, 21]], dtype=jnp.int32)
    s, i = merge_topk(sa, ia, sb, ib, 3)
    np.testing.assert_allclose(np.asarray(s[0]), [5.0, 5.0, 4.0])
    assert list(np.asarray(i[0])) == [10, 20, 21]


def test_block_searcher_multi_block_equals_oracle(rng):
    queries, passages = _data(rng, q=5, n=703, d=12)
    ids = rng.permutation(10_000)[:703].astype(np.int64)
    k = 25
    searcher = BlockSearcher(top_k=k, passage_chunk=64, query_chunk=3)
    blocks = [
        (passages[:300], ids[:300]),
        (passages[300:500], ids[300:500]),
        (passages[500:], ids[500:]),
    ]
    s, got_ids = searcher.search(queries, blocks)

    ref_s, ref_i = exact_topk_oracle(jnp.asarray(queries), jnp.asarray(passages), k)
    np.testing.assert_allclose(s, np.asarray(ref_s), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got_ids, ids[np.asarray(ref_i)])


def test_block_searcher_bf16_recall(rng):
    """bf16 scoring must keep top-k recall high (ordering may differ)."""
    queries, passages = _data(rng, q=8, n=2048, d=32)
    k = 50
    f32 = BlockSearcher(top_k=k, passage_chunk=256)
    b16 = BlockSearcher(top_k=k, passage_chunk=256, compute_dtype="bfloat16")
    ids = np.arange(2048, dtype=np.int64)
    _, ids32 = f32.search(queries, [(passages, ids)])
    _, ids16 = b16.search(queries, [(passages, ids)])
    recalls = [
        len(set(ids32[i]) & set(ids16[i])) / k for i in range(queries.shape[0])
    ]
    assert min(recalls) >= 0.9, recalls


def test_dedup_ranked_candidates():
    # mirrors output_test_res dedup (src/test_HAConvDR_topiocqa.py:249-255):
    # offsets mapping to the same pid collapse, placeholder (0,0) fills tail
    offset2pid = [100, 100, 200, 300]
    scores = np.asarray([[9.0, 8.0, 7.0, 6.0]])
    offsets = np.asarray([[0, 1, 2, 3]])
    out = dedup_ranked_candidates(["q1"], scores, offsets, offset2pid, top_n=4)
    assert out["q1"][0] == (100, 9.0)
    assert out["q1"][1] == (200, 7.0)
    assert out["q1"][2] == (300, 6.0)
    assert out["q1"][3] == (0, 0.0)


def test_block_searcher_multi_block_dispatch(rng):
    """blocks_per_dispatch>1 fuses equal-shape blocks into one scanned
    dispatch; results must equal the dispatch-per-block path and the
    oracle, including a ragged tail block and an int8 block that forces a
    group flush."""
    import jax.numpy as jnp

    from haconvdr_tpu.index.quantize import quantize_int8
    from haconvdr_tpu.ops.topk import BlockSearcher, exact_topk_oracle

    Q, D, k = 24, 16, 9
    q = rng.randn(Q, D).astype(np.float32)
    sizes = [256, 256, 256, 100]  # 3 equal + ragged tail
    blocks_np = [rng.randn(n, D).astype(np.float32) for n in sizes]
    ids, base = [], 0
    for n in sizes:
        ids.append(np.arange(base, base + n, dtype=np.int64))
        base += n

    single = BlockSearcher(top_k=k, passage_chunk=128)
    s1, i1 = single.search(q, list(zip(blocks_np, ids)))
    multi = BlockSearcher(
        top_k=k, passage_chunk=128, blocks_per_dispatch=3
    )
    s2, i2 = multi.search(q, list(zip(blocks_np, ids)))
    np.testing.assert_array_equal(s1, s2)
    np.testing.assert_array_equal(i1, i2)
    rs, ri = exact_topk_oracle(
        jnp.asarray(q), jnp.asarray(np.concatenate(blocks_np)), k
    )
    np.testing.assert_allclose(s2, np.asarray(rs), rtol=1e-5)
    np.testing.assert_array_equal(i2, np.asarray(ri))

    # int8 block mid-stream: scale-presence mismatch flushes the group
    q8, sc = quantize_int8(blocks_np[1])
    mixed = [
        (blocks_np[0], ids[0], None),
        (q8, ids[1], sc),
        (blocks_np[2], ids[2], None),
        (blocks_np[3], ids[3], None),
    ]
    s3, i3 = multi.search(q, mixed)
    s4, i4 = single.search(q, mixed)
    np.testing.assert_array_equal(s3, s4)
    np.testing.assert_array_equal(i3, i4)


def test_block_searcher_repeated_searches_independent(rng):
    """One BlockSearcher instance serves many searches: the cached -inf
    init buffers (avoiding two eager allocations per call) must not leak
    state between calls — same query set twice, then a different corpus,
    all match fresh oracles."""
    import jax.numpy as jnp

    from haconvdr_tpu.ops.topk import exact_topk_oracle

    k = 7
    searcher = BlockSearcher(top_k=k, passage_chunk=64)
    q = rng.randn(12, 16).astype(np.float32)
    p1 = rng.randn(300, 16).astype(np.float32)
    p2 = rng.randn(200, 16).astype(np.float32)
    ids1 = np.arange(300, dtype=np.int64)
    ids2 = np.arange(200, dtype=np.int64) + 1000

    for p, ids in ((p1, ids1), (p1, ids1), (p2, ids2)):
        s, i = searcher.search(q, [(p, ids)])
        rs, ri = exact_topk_oracle(jnp.asarray(q), jnp.asarray(p), k)
        np.testing.assert_allclose(s, np.asarray(rs), rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(i, ids[np.asarray(ri)])


def test_block_searcher_superblock_matches_oracle(rng):
    """Super-block streaming (superblock_rows): odd-size blocks crossing
    accumulator boundaries must give the same exact top-k as the plain
    per-block path and the oracle, with global ids mapped through."""
    import jax.numpy as jnp

    from haconvdr_tpu.ops.topk import exact_topk_oracle

    k, D, C = 9, 16, 128
    sizes = [100, 37, 115, 60]  # 312 rows -> 2 full superblocks + tail
    blocks, all_emb, base = [], [], 0
    for n in sizes:
        emb = rng.randn(n, D).astype(np.float32)
        blocks.append((emb, np.arange(base, base + n, dtype=np.int64) * 5))
        all_emb.append(emb)
        base += n
    full = np.concatenate(all_emb)
    ids_all = np.concatenate([b[1] for b in blocks])
    q = rng.randn(10, D).astype(np.float32)

    sb = BlockSearcher(
        top_k=k, passage_chunk=64, superblock_rows=C
    )
    s, i = sb.search(q, list(blocks))
    rs, ri = exact_topk_oracle(jnp.asarray(q), jnp.asarray(full), k)
    np.testing.assert_allclose(s, np.asarray(rs), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(i, ids_all[np.asarray(ri)])

    # second search on the SAME searcher with a smaller corpus: stale
    # accumulator rows from the first stream must be masked by n_valid
    small = rng.randn(90, D).astype(np.float32)
    sid = np.arange(90, dtype=np.int64) + 7
    s2, i2 = sb.search(q, [(small, sid)])
    rs2, ri2 = exact_topk_oracle(jnp.asarray(q), jnp.asarray(small), k)
    np.testing.assert_allclose(s2, np.asarray(rs2), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(i2, sid[np.asarray(ri2)])


def test_block_searcher_superblock_int8_dequantized(rng):
    """int8 blocks are dequantized into the f32 accumulator: results must
    equal the dequantized-rows oracle exactly (f32 scoring)."""
    import jax.numpy as jnp

    from haconvdr_tpu.index.quantize import dequantize_int8, quantize_int8
    from haconvdr_tpu.ops.topk import exact_topk_oracle

    k, D, C = 5, 8, 64
    q = rng.randn(6, D).astype(np.float32)
    blocks, deq = [], []
    base = 0
    for n in (70, 50):
        emb = rng.randn(n, D).astype(np.float32)
        i8, sc = quantize_int8(emb)
        blocks.append((i8, np.arange(base, base + n, dtype=np.int64), sc))
        deq.append(dequantize_int8(i8, sc))
        base += n
    full = np.concatenate(deq)

    sb = BlockSearcher(
        top_k=k, passage_chunk=32, superblock_rows=C
    )
    s, i = sb.search(q, list(blocks))
    rs, ri = exact_topk_oracle(jnp.asarray(q), jnp.asarray(full), k)
    np.testing.assert_allclose(s, np.asarray(rs), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(i, np.asarray(ri))

    # int8 without scale must raise, same contract as the per-block path
    import pytest

    with pytest.raises(ValueError):
        sb.search(q, [(blocks[0][0], blocks[0][1])])


def test_block_searcher_superblock_int8_accumulator(rng):
    """superblock_dtype='int8': blocks requantize into an int8
    accumulator at the corpus-level scale (store.global_scale semantics)
    and each filled buffer is searched with the scale folded into the
    queries, which are then quantised per query: int8(q*gscale) @ codes
    in exact integers — the test replicates that model exactly; ids must
    match the replicated model's top-k and scores its values."""
    import jax
    import jax.numpy as jnp

    from haconvdr_tpu.index.quantize import quantize_int8

    k, D, C = 7, 16, 64
    sizes = [50, 30, 60]  # crosses one fill boundary + tail
    blocks, codes_g, ids_list, scales = [], [], [], []
    base = 0
    for n in sizes:
        emb = rng.randn(n, D).astype(np.float32)
        q8, sc = quantize_int8(emb)
        ids = np.arange(base, base + n, dtype=np.int64) * 3
        blocks.append((q8, ids, sc))
        ids_list.append(ids)
        scales.append(sc)
        base += n
    gscale = np.maximum.reduce(scales)
    for (q8, _, sc) in blocks:
        codes_g.append(
            np.clip(np.round(q8.astype(np.float32) * (sc / gscale)), -127, 127)
        )
    codes_all = np.concatenate(codes_g)
    ids_all = np.concatenate(ids_list)
    q = rng.randn(9, D).astype(np.float32)

    sb = BlockSearcher(
        top_k=k, passage_chunk=32,
        superblock_rows=C, superblock_dtype="int8", superblock_scale=gscale,
    )
    s, i = sb.search(q, list(blocks))
    # replicate the scoring model: per-query int8 codes of q*gscale times
    # the corpus codes, summed exactly, scaled by the query scale / 127
    qf = (q * gscale[None, :]).astype(np.float32)
    qs = np.abs(qf).max(axis=1)
    qc = np.clip(np.round(qf / qs[:, None] * np.float32(127.0)), -127, 127)
    ints = qc.astype(np.float64) @ codes_all.astype(np.float64).T
    full = ints.astype(np.float32) * (qs / np.float32(127.0))[:, None]
    rs, ri = jax.lax.top_k(jnp.asarray(full), k)
    np.testing.assert_allclose(s, np.asarray(rs), rtol=1e-5)
    np.testing.assert_array_equal(i, ids_all[np.asarray(ri)])

    # missing scale must raise
    import pytest

    bad = BlockSearcher(
        top_k=k, passage_chunk=32,
        superblock_rows=C, superblock_dtype="int8",
    )
    with pytest.raises(ValueError, match="superblock_scale"):
        bad.search(q, list(blocks))


def test_store_global_scale(tmp_path, rng):
    """global_scale == elementwise max of per-block scales; raises on
    float blocks and empty stores."""
    import pytest

    from haconvdr_tpu.index.quantize import quantize_int8
    from haconvdr_tpu.index.store import EmbeddingBlockStore

    store = EmbeddingBlockStore(str(tmp_path / "s"), fmt="npy")
    scales = []
    for b in range(3):
        emb = rng.randn(20, 8).astype(np.float32) * (b + 1)
        q8, sc = quantize_int8(emb)
        store.write_block(b, q8, np.arange(20, dtype=np.int64), scale=sc)
        scales.append(sc)
    np.testing.assert_allclose(
        store.global_scale(), np.maximum.reduce(scales)
    )

    fstore = EmbeddingBlockStore(str(tmp_path / "f"), fmt="npy")
    fstore.write_block(0, rng.randn(4, 8).astype(np.float32),
                       np.arange(4, dtype=np.int64))
    with pytest.raises(ValueError, match="no embscale"):
        fstore.global_scale()
