"""IVF (cluster-pruned) serving index: construction invariants, recall on
a clustered mixture distribution, and the full-probe == exact property."""

import numpy as np
import jax.numpy as jnp

from haconvdr_tpu.index.ivf import build_ivf, ivf_search, spherical_kmeans
from haconvdr_tpu.ops.topk import exact_topk_oracle


def _mixture(rng, n, d, n_modes=16, spread=0.15):
    """Clustered unit-norm vectors (the regime IVF is for; uniform random
    directions do not cluster and are the wrong benchmark)."""
    modes = rng.randn(n_modes, d).astype(np.float32)
    modes /= np.linalg.norm(modes, axis=1, keepdims=True)
    pick = rng.randint(0, n_modes, n)
    x = modes[pick] + spread * rng.randn(n, d).astype(np.float32)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def test_kmeans_centroids_unit_norm(rng):
    x = _mixture(rng, 512, 24)
    cent = np.asarray(spherical_kmeans(jnp.asarray(x), nlist=8, iters=5))
    np.testing.assert_allclose(np.linalg.norm(cent, axis=1), 1.0, rtol=1e-4)


def test_build_partitions_every_row(rng):
    n, d = 700, 16
    x = _mixture(rng, n, d)
    ids = np.arange(100, 100 + n, dtype=np.int32)
    index = build_ivf(x, nlist=16, nprobe=4, slack=1.1, ids=ids, seed=3)
    got = np.concatenate(
        [np.asarray(index.bucket_ids).ravel(), np.asarray(index.tail_ids)]
    )
    got = got[got >= 0]
    assert sorted(got.tolist()) == sorted(ids.tolist())  # no loss, no dupes


def test_full_probe_equals_exact(rng):
    """nprobe == nlist scans everything: IVF must equal the exact oracle
    (the spill tail plus all buckets cover the corpus)."""
    n, d, k = 600, 16, 9
    x = _mixture(rng, n, d)
    q = _mixture(rng, 5, d)
    index = build_ivf(x, nlist=8, nprobe=8, slack=1.05, seed=1)
    s, i = ivf_search(index, q, k=k)
    rs, ri = exact_topk_oracle(jnp.asarray(q), jnp.asarray(x), k)
    np.testing.assert_allclose(s, np.asarray(rs), rtol=1e-5)
    # equal scores can reorder between implementations; compare sets
    for r in range(5):
        assert set(i[r].tolist()) == set(np.asarray(ri)[r].tolist())


def test_partial_probe_recall_on_clustered_data(rng):
    n, d, k = 4000, 32, 10
    x = _mixture(rng, n, d, n_modes=24)
    q = _mixture(rng, 16, d, n_modes=24)
    index = build_ivf(x, nlist=64, nprobe=8, slack=1.3, seed=2)
    s, i = ivf_search(index, q, k=k)
    _, ri = exact_topk_oracle(jnp.asarray(q), jnp.asarray(x), k)
    ri = np.asarray(ri)
    recall = np.mean([len(set(i[r]) & set(ri[r])) / k for r in range(len(q))])
    # 12.5% of clusters probed on clustered data
    assert recall >= 0.9, recall
    # and a smaller probe trades recall down, never errors
    s2, i2 = ivf_search(index, q, k=k, nprobe=2)
    recall2 = np.mean([len(set(i2[r]) & set(ri[r])) / k for r in range(len(q))])
    assert recall2 <= recall + 1e-9


def test_ivf_scores_are_true_inner_products(rng):
    n, d, k = 800, 16, 7
    x = _mixture(rng, n, d)
    q = _mixture(rng, 3, d)
    index = build_ivf(x, nlist=16, nprobe=6, seed=4)
    s, i = ivf_search(index, q, k=k)
    full = q @ x.T
    for r in range(3):
        np.testing.assert_allclose(s[r], full[r, i[r]], rtol=1e-5)


def test_device_build_matches_host_build_semantics(rng):
    """build_ivf_device (sort + static scatter, no host round-trip) must
    produce an index with the same partition invariants and the same
    full-probe == exact property as the host builder."""
    from haconvdr_tpu.index.ivf import build_ivf_device

    n, d, k = 600, 16, 9
    x = _mixture(rng, n, d)
    q = _mixture(rng, 4, d)
    index = build_ivf_device(jnp.asarray(x), nlist=8, nprobe=8, slack=1.05, seed=1)
    got = np.concatenate(
        [np.asarray(index.bucket_ids).ravel(), np.asarray(index.tail_ids)]
    )
    got = got[got >= 0]
    assert sorted(got.tolist()) == list(range(n))  # every row exactly once
    s, i = ivf_search(index, q, k=k)
    rs, ri = exact_topk_oracle(jnp.asarray(q), jnp.asarray(x), k)
    np.testing.assert_allclose(s, np.asarray(rs), rtol=1e-5)
    for r in range(4):
        assert set(i[r].tolist()) == set(np.asarray(ri)[r].tolist())


def test_device_build_overflow_raises(rng):
    from haconvdr_tpu.index.ivf import build_ivf_device

    x = _mixture(rng, 400, 8, n_modes=1, spread=0.0)  # everything one cluster
    import pytest as _pytest

    with _pytest.raises(ValueError, match="IVF overflow"):
        build_ivf_device(
            jnp.asarray(x), nlist=16, nprobe=4, slack=1.0, tail_frac=0.02
        )


def test_param_validation_and_clamps(rng):
    from haconvdr_tpu.index.ivf import build_ivf_device
    import pytest as _pytest

    x = _mixture(rng, 64, 8)
    with _pytest.raises(ValueError, match="< nlist"):
        build_ivf(x, nlist=128)
    with _pytest.raises(ValueError, match="< nlist"):
        build_ivf_device(jnp.asarray(x), nlist=128)
    with _pytest.raises(ValueError, match="float32/bfloat16"):
        build_ivf(x, nlist=4, dtype="int8")
    # nprobe > nlist clamps instead of crashing in top_k
    index = build_ivf(x, nlist=4, nprobe=99)
    s, i = ivf_search(index, _mixture(rng, 2, 8), k=3)
    assert s.shape == (2, 3)
    s2, i2 = ivf_search(index, _mixture(rng, 2, 8), k=3, nprobe=50)
    assert s2.shape == (2, 3)


def test_sharded_ivf_matches_single_device(rng):
    """Cluster-axis sharded IVF over the 8-device mesh returns the same
    results as the single-device search over the same index."""
    from haconvdr_tpu.parallel.mesh import make_mesh
    from haconvdr_tpu.parallel.sharded_ivf import shard_ivf, sharded_ivf_search

    n, d, k = 3000, 32, 10
    x = _mixture(rng, n, d, n_modes=24)
    q = _mixture(rng, 6, d, n_modes=24)
    index = build_ivf(x, nlist=32, nprobe=6, slack=1.3, seed=5)
    s1, i1 = ivf_search(index, q, k=k)

    mesh = make_mesh()
    sharded = shard_ivf(mesh, index)
    s2, i2 = sharded_ivf_search(mesh, sharded, q, k=k)
    np.testing.assert_allclose(s1, s2, rtol=1e-5)
    for r in range(len(q)):
        assert set(i1[r].tolist()) == set(i2[r].tolist())
    # and full probe equals the exact oracle through the sharded path too
    s3, i3 = sharded_ivf_search(mesh, sharded, q, k=k, nprobe=32)
    rs, ri = exact_topk_oracle(jnp.asarray(q), jnp.asarray(x), k)
    np.testing.assert_allclose(s3, np.asarray(rs), rtol=1e-5)
    for r in range(len(q)):
        assert set(i3[r].tolist()) == set(np.asarray(ri)[r].tolist())


def test_shard_ivf_divisibility_guard(rng):
    from haconvdr_tpu.parallel.mesh import make_mesh
    from haconvdr_tpu.parallel.sharded_ivf import shard_ivf
    import pytest as _pytest

    x = _mixture(rng, 500, 8)
    index = build_ivf(x, nlist=12, nprobe=4)  # 12 % 8 != 0
    with _pytest.raises(ValueError, match="divide"):
        shard_ivf(make_mesh(), index)


def test_int8_quantized_ivf(rng):
    """quantize_ivf: int8 buckets with the query-folded scale must rank
    like the float index (quantization-level tolerance) and score the
    true dequantized inner products; works through the sharded path too."""
    from haconvdr_tpu.index.ivf import quantize_ivf
    from haconvdr_tpu.parallel.mesh import make_mesh
    from haconvdr_tpu.parallel.sharded_ivf import shard_ivf, sharded_ivf_search

    n, d, k = 2000, 32, 10
    x = _mixture(rng, n, d, n_modes=24)
    q = _mixture(rng, 6, d, n_modes=24)
    index = build_ivf(x, nlist=16, nprobe=16, slack=1.2, seed=6)
    q8 = quantize_ivf(index, by_residual=False)  # the GLOBAL scheme
    assert q8.buckets.dtype == jnp.int8 and q8.scale is not None
    assert quantize_ivf(q8) is q8  # idempotent

    s_f, i_f = ivf_search(index, q, k=k)
    s_q, i_q = ivf_search(q8, q, k=k)
    overlap = np.mean([len(set(i_f[r]) & set(i_q[r])) / k for r in range(6)])
    assert overlap >= 0.8, overlap
    np.testing.assert_allclose(s_q, s_f, rtol=0.05, atol=0.05)

    # scores follow the folding contract: int8 rows dotted with the
    # bf16-rounded folded query (checked wherever the hit lives —
    # bucket or tail — so the assertion always runs)
    all_rows = np.concatenate(
        [np.asarray(q8.buckets, np.float32).reshape(-1, d),
         np.asarray(q8.tail, np.float32)]
    )
    all_ids = np.concatenate(
        [np.asarray(q8.bucket_ids).reshape(-1), np.asarray(q8.tail_ids)]
    )
    qf = np.asarray(
        jnp.asarray(q * np.asarray(q8.scale)[None, :], jnp.bfloat16), np.float32
    )
    r, c = 0, 0
    pos = np.flatnonzero(all_ids == i_q[r][c])
    assert len(pos) == 1
    ref = float(all_rows[pos[0]] @ qf[r])
    np.testing.assert_allclose(s_q[r][c], ref, rtol=1e-3)

    mesh = make_mesh()
    sh = shard_ivf(mesh, q8)
    s_s, i_s = sharded_ivf_search(mesh, sh, q, k=k)
    np.testing.assert_allclose(s_s, s_q, rtol=1e-5)
    for r in range(6):
        assert set(i_s[r].tolist()) == set(i_q[r].tolist())


def test_save_load_roundtrip(rng, tmp_path):
    from haconvdr_tpu.index.ivf import load_ivf, quantize_ivf, save_ivf

    x = _mixture(rng, 800, 16).astype(np.float32)
    q = _mixture(rng, 3, 16)
    for make in (lambda: build_ivf(x, nlist=8, nprobe=4, dtype="bfloat16"),
                 lambda: quantize_ivf(build_ivf(x, nlist=8, nprobe=4))):
        index = make()
        d = tmp_path / ("i8" if index.scale is not None else "bf16")
        save_ivf(index, str(d))
        back = load_ivf(str(d))
        assert back.nprobe == index.nprobe
        assert back.buckets.dtype == index.buckets.dtype
        s1, i1 = ivf_search(index, q, k=5)
        s2, i2 = ivf_search(back, q, k=5)
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_array_equal(s1, s2)


def test_save_over_quantized_removes_stale_scale(rng, tmp_path):
    """Re-saving a float index over a quantized one must not leave the
    old scale sidecar behind (a loaded float index with a scale attached
    silently corrupts every score)."""
    from haconvdr_tpu.index.ivf import load_ivf, quantize_ivf, save_ivf

    x = _mixture(rng, 400, 8)
    d = str(tmp_path / "idx")
    save_ivf(quantize_ivf(build_ivf(x, nlist=4, nprobe=4)), d)
    save_ivf(build_ivf(x, nlist=4, nprobe=4), d)
    back = load_ivf(d)
    assert back.scale is None and back.buckets.dtype != jnp.int8


def test_shard_ivf_pads_tail_to_shard_count(rng):
    """A tail whose row count doesn't divide the mesh is padded with
    -1-id rows instead of raising; results unchanged."""
    from haconvdr_tpu.parallel.mesh import make_mesh
    from haconvdr_tpu.parallel.sharded_ivf import shard_ivf, sharded_ivf_search

    x = _mixture(rng, 900, 16)
    q = _mixture(rng, 3, 16)
    index = build_ivf(x, nlist=16, nprobe=16, slack=1.05)
    short = index._replace(
        tail=index.tail[: index.tail.shape[0] - 4],
        tail_ids=index.tail_ids[: index.tail.shape[0] - 4],
    )
    mesh = make_mesh()
    sh = shard_ivf(mesh, short)
    assert sh.tail.shape[0] % 8 == 0
    s, i = sharded_ivf_search(mesh, sh, q, k=5)
    s1, i1 = ivf_search(short, q, k=5)
    np.testing.assert_allclose(s, s1, rtol=1e-5)


def test_device_build_trims_tail_to_spill(rng):
    """The always-scanned tail must shrink to the actual spill, not the
    allocated tail_frac capacity (per-query cost scales with tail rows)."""
    from haconvdr_tpu.index.ivf import build_ivf_device

    x = _mixture(rng, 2000, 16, n_modes=8)
    index = build_ivf_device(
        jnp.asarray(x), nlist=8, nprobe=8, slack=1.05, tail_frac=0.5
    )
    n_spill = int(np.sum(np.asarray(index.tail_ids) >= 0))
    assert index.tail.shape[0] <= max(8, -(-n_spill // 8) * 8)
    # exactness preserved through the trim
    q = _mixture(rng, 3, 16, n_modes=8)
    s, i = ivf_search(index, q, k=7)
    rs, ri = exact_topk_oracle(jnp.asarray(q), jnp.asarray(x), 7)
    np.testing.assert_allclose(s, np.asarray(rs), rtol=1e-5)


def _write_store(tmp_path, rng, x, n_blocks=3, name="ivf_store"):
    from haconvdr_tpu.index.store import EmbeddingBlockStore

    store = EmbeddingBlockStore(str(tmp_path / name))
    n = x.shape[0]
    per = -(-n // n_blocks)
    row = 0
    for b in range(n_blocks):
        blk = x[row : row + per]
        store.write_block(b, blk, np.arange(row, row + len(blk), dtype=np.int64))
        row += len(blk)
    return store


def test_sharded_build_from_store_matches_single_device(rng, tmp_path):
    """build_ivf_from_store (pod-scale, no single-host corpus buffer) must
    return search results identical to the single-device host build over
    the same data: with N <= train_rows both k-means runs see the whole
    corpus in the same order, so centroids/assignments/bucket contents
    coincide (tail order differs — the tail is fully scanned)."""
    from haconvdr_tpu.parallel.mesh import make_mesh
    from haconvdr_tpu.parallel.sharded_ivf import (
        build_ivf_from_store,
        sharded_ivf_search,
    )

    n, d, k = 3000, 32, 10
    x = _mixture(rng, n, d, n_modes=24)
    q = _mixture(rng, 6, d, n_modes=24)
    store = _write_store(tmp_path, rng, x)
    mesh = make_mesh()

    sharded = build_ivf_from_store(
        mesh, store, nlist=32, nprobe=6, slack=1.3, seed=5,
        dtype="float32", chunk_rows=512,
    )
    single = build_ivf(x, nlist=32, nprobe=6, slack=1.3, seed=5)

    # same centroids (same sample, same seed) => same partition
    np.testing.assert_allclose(
        np.asarray(sharded.centroids), np.asarray(single.centroids), rtol=1e-5
    )
    # every row lands exactly once across buckets + tail
    all_ids = np.concatenate(
        [np.asarray(sharded.bucket_ids).reshape(-1), np.asarray(sharded.tail_ids)]
    )
    real = all_ids[all_ids >= 0]
    assert len(real) == n and len(set(real.tolist())) == n

    s1, i1 = ivf_search(single, q, k=k)
    s2, i2 = sharded_ivf_search(mesh, sharded, q, k=k)
    np.testing.assert_allclose(s1, s2, rtol=1e-5)
    for r in range(len(q)):
        assert set(i1[r].tolist()) == set(i2[r].tolist())

    # full probe == exact oracle through the sharded-build index
    s3, i3 = sharded_ivf_search(mesh, sharded, q, k=k, nprobe=32)
    rs, ri = exact_topk_oracle(jnp.asarray(q), jnp.asarray(x), k)
    np.testing.assert_allclose(s3, np.asarray(rs), rtol=1e-5)
    for r in range(len(q)):
        assert set(i3[r].tolist()) == set(np.asarray(ri)[r].tolist())


def test_sharded_build_int8_and_guards(rng, tmp_path):
    """dtype='int8' builds quantized buckets (global per-dim scale, folded
    into queries at search) with float-index-level ranking; nlist must
    divide the shard count; bf16 buckets carry the right dtype."""
    import pytest as _pytest

    from haconvdr_tpu.parallel.mesh import make_mesh
    from haconvdr_tpu.parallel.sharded_ivf import (
        build_ivf_from_store,
        sharded_ivf_search,
    )

    n, d, k = 2000, 32, 10
    x = _mixture(rng, n, d, n_modes=24)
    q = _mixture(rng, 6, d, n_modes=24)
    store = _write_store(tmp_path, rng, x, name="ivf_store8")
    mesh = make_mesh()

    with _pytest.raises(ValueError, match="divide"):
        build_ivf_from_store(mesh, store, nlist=12)

    i8 = build_ivf_from_store(
        mesh, store, nlist=16, nprobe=16, dtype="int8", chunk_rows=512
    )
    assert i8.buckets.dtype == jnp.int8 and i8.scale is not None
    assert i8.means is not None and i8.mu is not None  # residual default
    i8g = build_ivf_from_store(
        mesh, store, nlist=16, nprobe=16, dtype="int8", chunk_rows=512,
        by_residual=False,
    )
    assert i8g.scale is not None and i8g.means is None  # global scheme
    sf = build_ivf_from_store(
        mesh, store, nlist=16, nprobe=16, dtype="bfloat16", chunk_rows=512
    )
    assert sf.buckets.dtype == jnp.bfloat16
    s_f, i_f = sharded_ivf_search(mesh, sf, q, k=k)
    s_q, i_q = sharded_ivf_search(mesh, i8, q, k=k)
    overlap = np.mean([len(set(i_f[r]) & set(i_q[r])) / k for r in range(6)])
    assert overlap >= 0.8, overlap
    np.testing.assert_allclose(s_q, s_f, rtol=0.05, atol=0.05)


def test_sharded_build_int8_residual_beats_global(rng, tmp_path):
    """On the low-rank + common-mode manifold (the real-encoder shape),
    the store-build's residual int8 (default) preserves the float
    ranking where the global scheme loses it — pod-scale analog of
    test_int8_residual_ivf."""
    from haconvdr_tpu.parallel.mesh import make_mesh
    from haconvdr_tpu.parallel.sharded_ivf import (
        build_ivf_from_store,
        sharded_ivf_search,
    )

    n, d, k = 4000, 64, 10
    centers = rng.normal(size=(32, d)).astype(np.float32) * 0.5
    x = centers[rng.randint(0, 32, size=n)] + rng.normal(
        size=(n, d)
    ).astype(np.float32) * 0.02
    x = x + rng.normal(size=(d,)).astype(np.float32) * 4.0
    q = x[:24] + rng.normal(size=(24, d)).astype(np.float32) * 0.01
    store = _write_store(tmp_path, rng, x, name="ivf_resid")
    mesh = make_mesh()

    kw = dict(nlist=32, nprobe=32, chunk_rows=512, seed=2)
    f32 = build_ivf_from_store(mesh, store, dtype="float32", **kw)
    res = build_ivf_from_store(mesh, store, dtype="int8", **kw)
    glo = build_ivf_from_store(
        mesh, store, dtype="int8", by_residual=False, **kw
    )
    _, i_f = sharded_ivf_search(mesh, f32, q, k=k)
    _, i_r = sharded_ivf_search(mesh, res, q, k=k)
    _, i_g = sharded_ivf_search(mesh, glo, q, k=k)
    rec_r = np.mean([len(set(i_f[r]) & set(i_r[r])) / k for r in range(len(q))])
    rec_g = np.mean([len(set(i_f[r]) & set(i_g[r])) / k for r in range(len(q))])
    assert rec_r >= 0.95, (rec_r, rec_g)
    assert rec_r > rec_g + 0.2, (rec_r, rec_g)


def test_ivf_sweep_harness(rng, tmp_path):
    """The nlist/nprobe/slack sweep CLI: recall/latency rows on the
    mixture distribution, monotone recall in nprobe, full-probe ~ 1.0,
    and the data-ready entry points (npy matrix + query matrix)."""
    from haconvdr_tpu.cli.ivf_sweep import main as sweep_main

    n, d = 2000, 16
    x = _mixture(rng, n, d, n_modes=16)
    q = _mixture(rng, 32, d, n_modes=16)
    emb_path = tmp_path / "emb.npy"
    q_path = tmp_path / "q.npy"
    np.save(emb_path, x)
    np.save(q_path, q)
    out = tmp_path / "sweep.jsonl"
    sweep_main([
        f"embeddings={emb_path}", f"queries={q_path}",
        "nlist=16", "nprobe=2,16", "slack=1.3", "k=10", f"out={out}",
        "dtype=float32",
    ])
    import json as _json

    rows = [_json.loads(l) for l in open(out)]
    assert len(rows) == 2
    by_probe = {r["nprobe"]: r for r in rows}
    assert by_probe[16]["recall_at_k"] >= by_probe[2]["recall_at_k"]
    assert by_probe[16]["recall_at_k"] >= 0.99  # full probe == exact
    for r in rows:
        assert r["latency_ms_per_query"] > 0
        assert r["memory_overhead"] >= 1.0


def test_int8_residual_ivf(rng):
    """quantize_ivf(by_residual=True) (the default): codes store
    row - mean(cluster) and search adds the exact q.mean correction.

    On a LOW-RANK + large-common-mode manifold (the real-encoder
    geometry shape: .probe_int8_fix.py measured global int8 recall@100 =
    0.538 vs bf16 0.998 on the 1M geometry-check matrix), the global
    scheme loses the neighbor ordering while residual codes keep it."""
    from haconvdr_tpu.index.ivf import quantize_ivf
    from haconvdr_tpu.parallel.mesh import make_mesh
    from haconvdr_tpu.parallel.sharded_ivf import shard_ivf, sharded_ivf_search

    n, d, k = 4000, 64, 10
    # tight clusters riding a large common mode: per-dim amax is dominated
    # by the offset, so global int8 steps dwarf the within-cluster gaps
    base = _mixture(rng, n, d, n_modes=32, spread=0.02).astype(np.float32)
    common = rng.normal(size=(d,)).astype(np.float32) * 8.0
    x = base + common
    q = base[:32] + common + rng.normal(size=(32, d)).astype(np.float32) * 0.002

    index = build_ivf(x, nlist=32, nprobe=32, slack=1.3, seed=3)
    s_f, i_f = ivf_search(index, q, k=k)

    q8g = quantize_ivf(index, by_residual=False)
    q8r = quantize_ivf(index)  # residual default
    assert q8r.means is not None and q8r.mu is not None
    assert quantize_ivf(q8r) is q8r  # idempotent

    _, i_g = ivf_search(q8g, q, k=k)
    s_r, i_r = ivf_search(q8r, q, k=k)
    rec_g = np.mean([len(set(i_f[r]) & set(i_g[r])) / k for r in range(len(q))])
    rec_r = np.mean([len(set(i_f[r]) & set(i_r[r])) / k for r in range(len(q))])
    assert rec_r >= 0.95, (rec_r, rec_g)
    assert rec_r > rec_g + 0.2, (rec_r, rec_g)  # global collapses here
    # scores are the true inner products within residual-quant error
    np.testing.assert_allclose(s_r, s_f, rtol=0.02, atol=0.02)

    # sharded search over the residual index == single-device
    mesh = make_mesh()
    sh = shard_ivf(mesh, q8r)
    s_s, i_s = sharded_ivf_search(mesh, sh, q, k=k)
    np.testing.assert_array_equal(i_s, i_r)
    np.testing.assert_allclose(s_s, s_r, rtol=1e-5, atol=1e-5)


def test_int8_residual_ivf_exact_at_zero_residual(rng):
    """Zero residuals (every row == its cluster mean) make the residual
    int8 scores EXACTLY the f32 correction q.mean — equal to the float
    index's scores at f32 tolerance."""
    from haconvdr_tpu.index.ivf import IVFIndex, quantize_ivf

    d, k, nlist, cap = 16, 4, 8, 16
    centers = rng.normal(size=(nlist, d)).astype(np.float32) * 3.0
    # hand-built index (build_ivf's k-means can merge duplicate-valued
    # clusters and spill, which would reintroduce residuals): one bucket
    # per center, every row equal to it, empty always-padded tail
    buckets = np.repeat(centers[:, None, :], cap, axis=1)
    bucket_ids = np.arange(nlist * cap, dtype=np.int32).reshape(nlist, cap)
    index = IVFIndex(
        centroids=jnp.asarray(
            centers / np.linalg.norm(centers, axis=1, keepdims=True)
        ),
        buckets=jnp.asarray(buckets),
        bucket_ids=jnp.asarray(bucket_ids),
        tail=jnp.zeros((8, d), jnp.float32),
        tail_ids=jnp.full((8,), -1, jnp.int32),
        nprobe=nlist,
    )
    q = rng.normal(size=(5, d)).astype(np.float32)
    q8 = quantize_ivf(index)
    s_f, _ = ivf_search(index, q, k=k)
    s_r, _ = ivf_search(q8, q, k=k)
    np.testing.assert_allclose(s_r, s_f, rtol=1e-5, atol=1e-5)


def test_ivf_sweep_int8(rng, tmp_path):
    """dtype=int8 sweeps QUANTIZED buckets (build bf16 -> quantize_ivf,
    the serve-path contract, never a raw float->int8 cast): recall at
    full probe stays high and the rows carry the dtype tag."""
    from haconvdr_tpu.cli.ivf_sweep import sweep

    n, d = 2000, 16
    x = _mixture(rng, n, d, n_modes=16)
    q = _mixture(rng, 32, d, n_modes=16)
    rows = sweep(x, q, nlists=[16], nprobes=[16], slacks=[1.3], k=10,
                 dtype="int8", rescore_oversample=3.0)
    ok = [r for r in rows if "recall_at_k" in r]
    assert ok and ok[0]["dtype"] == "int8"
    assert ok[0]["recall_at_k"] >= 0.9  # full probe, int8 rounding only
    # the two-stage column reranks the oversampled candidates exactly:
    # never worse than the raw int8 recall
    assert ok[0]["recall_two_stage"] >= ok[0]["recall_at_k"]


def test_ivf_sweep_overflow_row(rng, tmp_path):
    """A slack too low for a lumpy assignment records an error row and
    keeps sweeping instead of aborting the whole sweep."""
    from haconvdr_tpu.cli.ivf_sweep import sweep

    n, d = 512, 16
    # one dominant mode of EXACTLY identical rows: every copy shares the
    # same nearest-centroid argmin, so one bucket takes n-8 rows and any
    # slack*N/nlist capacity with a small tail overflows deterministically
    x = _mixture(rng, n, d, n_modes=2, spread=0.01).astype(np.float32)
    x[: n - 8] = x[0]
    q = x[:16]
    rows = sweep(x, q, nlists=[8], nprobes=[8], slacks=[1.05, 64.0], k=5)
    errs = [r for r in rows if "error" in r]
    ok = [r for r in rows if "recall_at_k" in r]
    assert errs and errs[0]["slack"] == 1.05
    assert ok and ok[0]["slack"] == 64.0


def test_ivf_geometry_check_cli(tmp_path):
    """End-to-end geometry harness on a toy encoder: trains a step,
    embeds, emits a geometry preamble + sweep rows (the proxy for
    real-encoder-manifold IVF recall)."""
    from haconvdr_tpu.cli.ivf_geometry_check import main as geo_main

    out = tmp_path / "geo.jsonl"
    rows = geo_main([
        "n=512", "steps=1", "n_topics=8", "layers=1", "hidden=32",
        "heads=2", "intermediate=64", "vocab=512", "p_len=16", "q_len=8",
        "n_queries=32", "batch=16", "nlist=8", "nprobe=2,8",
        "slack=2.0", "k=10", f"out={out}",
    ])
    geo = rows[0]
    assert geo["metric"] == "geometry" and geo["train_steps"] == 1
    assert 1.0 <= geo["effective_rank"] <= 32.0
    assert -1.0 <= geo["mean_cos_to_centroid"] <= 1.0
    sweep_rows = [r for r in rows[1:] if "recall_at_k" in r]
    assert sweep_rows, rows[1:]
    by_probe = {r["nprobe"]: r for r in sweep_rows}
    assert by_probe[8]["recall_at_k"] >= by_probe[2]["recall_at_k"]
    assert by_probe[8]["recall_at_k"] >= 0.99  # full probe == exact
    import json as _json

    disk = [_json.loads(l) for l in open(out)]
    assert len(disk) == len(rows)


def test_sharded_ivf_save_load_roundtrip(rng, tmp_path):
    """save_ivf_sharded -> load_ivf_sharded must reproduce the sharded
    search bitwise on the same mesh, survive a CHANGED shard count (8 -> 4
    and 8 -> 2: cluster slices re-split, tail rows re-partition), and
    round-trip the residual-int8 sidecars."""
    import jax

    from haconvdr_tpu.parallel.mesh import make_mesh
    from haconvdr_tpu.parallel.sharded_ivf import (
        build_ivf_from_store,
        load_ivf_sharded,
        save_ivf_sharded,
        sharded_ivf_search,
    )

    n, d, k = 3000, 32, 10
    x = _mixture(rng, n, d, n_modes=24)
    q = _mixture(rng, 6, d, n_modes=24)
    store = _write_store(tmp_path, rng, x, name="persist_store")
    mesh = make_mesh()

    for dtype in ("float32", "int8"):
        built = build_ivf_from_store(
            mesh, store, nlist=32, nprobe=6, slack=1.3, seed=5,
            dtype=dtype, chunk_rows=512,
        )
        s0, i0 = sharded_ivf_search(mesh, built, q, k=k)
        out = str(tmp_path / f"ivf_{dtype}")
        save_ivf_sharded(built, out)

        loaded = load_ivf_sharded(mesh, out)
        assert loaded.nprobe == built.nprobe
        if dtype == "int8":  # residual sidecars survive the round trip
            for name in ("scale", "means", "mu", "tail_scale"):
                np.testing.assert_array_equal(
                    np.asarray(getattr(loaded, name)),
                    np.asarray(getattr(built, name)),
                )
        s1, i1 = sharded_ivf_search(mesh, loaded, q, k=k)
        np.testing.assert_array_equal(s0, s1)
        np.testing.assert_array_equal(i0, i1)

        for n_dev in (4, 2):  # pod reshape: fewer devices than saved
            small = jax.sharding.Mesh(
                np.array(jax.devices()[:n_dev]), ("dp",)
            )
            re = load_ivf_sharded(small, out)
            s2, i2 = sharded_ivf_search(small, re, q, k=k)
            np.testing.assert_allclose(s0, s2, rtol=1e-6)
            for r in range(len(q)):
                assert set(i0[r].tolist()) == set(i2[r].tolist())


def test_sharded_ivf_load_shard_count_guard(rng, tmp_path):
    """nlist that does not divide the target shard count raises with the
    remedy in the message (never silently mis-shards clusters)."""
    import jax
    import pytest as _pytest

    from haconvdr_tpu.parallel.mesh import make_mesh
    from haconvdr_tpu.parallel.sharded_ivf import (
        build_ivf_from_store,
        load_ivf_sharded,
        save_ivf_sharded,
    )

    x = _mixture(rng, 2000, 16, n_modes=8)
    store = _write_store(tmp_path, rng, x, name="guard_store")
    mesh = make_mesh()
    built = build_ivf_from_store(
        mesh, store, nlist=8, nprobe=4, slack=1.5, dtype="float32",
        chunk_rows=512,
    )
    out = str(tmp_path / "ivf_guard")
    save_ivf_sharded(built, out)
    three = jax.sharding.Mesh(np.array(jax.devices()[:3]), ("dp",))
    with _pytest.raises(ValueError, match="divide"):
        load_ivf_sharded(three, out)


def test_build_ivf_cli(rng, tmp_path, capsys):
    """cli.build_ivf: store dir in -> persisted sharded artifacts out,
    loadable and searchable; the JSON stats line is parseable."""
    import json

    from haconvdr_tpu.cli.build_ivf import main as build_main
    from haconvdr_tpu.parallel.mesh import make_mesh
    from haconvdr_tpu.parallel.sharded_ivf import (
        load_ivf_sharded,
        sharded_ivf_search,
    )

    x = _mixture(rng, 2500, 16, n_modes=8)
    q = _mixture(rng, 4, 16, n_modes=8)
    _write_store(tmp_path, rng, x, name="cli_store")
    out = str(tmp_path / "cli_ivf")
    build_main([
        f"embeddings={tmp_path / 'cli_store'}", f"out={out}",
        "nlist=8", "nprobe=8", "dtype=float32", "chunk_rows=512",
        "train_rows=2500",
    ])
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["nlist"] == 8 and stats["dtype"] == "float32"

    mesh = make_mesh()
    idx = load_ivf_sharded(mesh, out)
    s, i = sharded_ivf_search(mesh, idx, q, k=5)
    rs, ri = exact_topk_oracle(jnp.asarray(q), jnp.asarray(x), 5)
    np.testing.assert_allclose(s, np.asarray(rs), rtol=1e-5)


def test_ivf_sweep_oversample_clamps_to_pool(rng, tmp_path):
    """An oversample whose m exceeds the candidate pool (nprobe*capacity
    + tail) must clamp instead of crashing lax.top_k mid-sweep."""
    from haconvdr_tpu.cli.ivf_sweep import sweep

    x = _mixture(rng, 2000, 16, n_modes=8)
    q = _mixture(rng, 8, 16, n_modes=8)
    # nprobe=1 over 16 clusters: pool ~ capacity + tail << 50x oversample
    rows = sweep(x, q, nlists=[16], nprobes=[1], slacks=[1.3], k=10,
                 dtype="float32", rescore_oversample=50.0)
    ok = [r for r in rows if "recall_at_k" in r]
    assert ok and ok[0]["recall_two_stage"] is not None
