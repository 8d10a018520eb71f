"""IVF (inverted-file) index for low-latency online serving.

Beyond the reference: HAConvDR serves every query by scanning the whole
block set with faiss ``IndexFlatIP`` (src/test_HAConvDR_topiocqa.py:74-162).
Exact scan is the right call for batch evaluation (one read of the index
is amortized over thousands of queries — see ops/topk.py), but a SINGLE
online query still pays the full index read.  This module trades a little recall for reading only the
probed clusters: spherical k-means centroids + equal-capacity cluster
buckets, searched by gathering the top-``nprobe`` buckets per query and
running the exact top-k inside them.

Design decisions:
  * **Equal-capacity buckets, one dense [nlist, capacity, D] array.**
    Variable-length inverted lists are hostile to XLA (dynamic shapes);
    instead every cluster gets the same padded capacity and rows that
    overflow a full bucket spill into a shared TAIL block that is ALWAYS
    scanned.  All shapes static; the recall knob is ``nprobe`` alone.
  * **Spherical k-means on device** (jit Lloyd iterations, cosine
    assignment): inner-product retrieval clusters on direction, and ANCE
    embeddings are LayerNorm'd to near-constant norm (models/encoder.py),
    so spherical cells match the score geometry.
  * **Gather-then-exact**: probed buckets are gathered into a static
    [nprobe * capacity, D] panel and ranked by the same exact machinery
    as the flat path (f32 accumulation), so IVF results are exact over
    the union of probed buckets + tail.

Memory: the dense bucket array pads N by the fill factor (~1/slack); at
the default slack 1.3 that is +30% rows — use bfloat16/int8 storage to
stay ahead.  Recall on real (clustered) embedding distributions reaches
>0.95 @ top-10 with nprobe/nlist ~ 2-6% (tests/test_ivf.py measures this
on a mixture distribution; uniform random vectors do NOT cluster and are
the wrong benchmark for IVF).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(jax.jit, static_argnames=("nlist", "iters"))
def spherical_kmeans(
    x: jax.Array,  # [N, D] float; rows are L2-normalized internally
    nlist: int,
    iters: int = 10,
    key: Optional[jax.Array] = None,
) -> jax.Array:
    """[nlist, D] unit-norm centroids via jit Lloyd iterations (cosine
    assignment, mean update, renormalize).  Empty clusters keep their
    previous centroid."""
    if key is None:
        key = jax.random.PRNGKey(0)
    x = x.astype(jnp.float32)
    xn = x / jnp.maximum(jnp.linalg.norm(x, axis=1, keepdims=True), 1e-6)
    init_idx = jax.random.choice(key, x.shape[0], (nlist,), replace=False)
    cent = xn[init_idx]

    def step(cent, _):
        scores = xn @ cent.T  # [N, nlist]
        assign = jnp.argmax(scores, axis=1)
        # segment_sum, not one_hot.T @ xn: the [N, nlist] one-hot would be
        # GBs at production sample sizes
        sums = jax.ops.segment_sum(xn, assign, num_segments=nlist)
        counts = jax.ops.segment_sum(
            jnp.ones((xn.shape[0],), jnp.float32), assign, num_segments=nlist
        )[:, None]
        new = jnp.where(counts > 0, sums / jnp.maximum(counts, 1.0), cent)
        new = new / jnp.maximum(jnp.linalg.norm(new, axis=1, keepdims=True), 1e-6)
        return new, None

    cent, _ = jax.lax.scan(step, cent, None, length=iters)
    return cent


class IVFIndex(NamedTuple):
    """Static-shape inverted file: dense buckets + always-scanned tail."""

    centroids: jax.Array  # [nlist, D] f32, unit norm
    buckets: jax.Array  # [nlist, capacity, D] store dtype; zero-padded
    bucket_ids: jax.Array  # [nlist, capacity] int32 global offsets; -1 pad
    tail: jax.Array  # [tail_rows, D] overflow rows (always scanned)
    tail_ids: jax.Array  # [tail_rows] int32; -1 pad
    nprobe: int
    # int8 buckets only (quantize_ivf): [D] per-dim dequant scale, folded
    # into the query at search time (index/quantize.py semantics)
    scale: Optional[jax.Array] = None
    # residual quantization (quantize_ivf by_residual=True): codes store
    # (row - means[cluster]); search adds the exact q.means[c] back per
    # probed bucket (and q.mu for the tail, whose rows quantize vs the
    # global mean).  means [nlist, D] f32, mu [D] f32.  The tail gets its
    # OWN scale: tail residuals (row - corpus mean) are much larger than
    # within-cluster residuals, and one shared amax would inflate the
    # bucket step by their ratio (measured: shared-scale recall 0.92 vs
    # separate 0.95+ on the common-mode mixture)
    means: Optional[jax.Array] = None
    mu: Optional[jax.Array] = None
    tail_scale: Optional[jax.Array] = None


def quantize_ivf(index: IVFIndex, by_residual: bool = True) -> IVFIndex:
    """int8-quantize an IVF index in place on device.  Quarters the
    bucket bytes vs f32, halves them vs bf16.

    ``by_residual=True`` (default, the faiss IVF-SQ ``by_residual``
    analog): buckets store int8 codes of ``row - mean(cluster)`` and the
    tail stores ``row - mean(corpus)``; at search the exact f32
    ``q . mean`` correction is added per probed bucket / tail row, so
    only the (much smaller) residual suffers quantization error.  On
    real-encoder geometry (effective rank ~3, tight clusters) GLOBAL
    symmetric int8 loses the neighbor ordering entirely — measured
    recall@100 = 0.538 vs bf16's 0.998 on the 1M geometry-check manifold
    (the quantization step exceeds the median rank-100 score gap;
    mean-centering 0.67, random rotation HURTS 0.62 — see
    .probe_int8_fix.py) — while cluster residuals shrink the step by the
    cluster-spread ratio.  ``by_residual=False`` keeps the flat-path
    global scheme (valid on high-rank manifolds; the synthetic-mixture
    tests measure 0.987 with it)."""
    if index.scale is not None:
        return index
    from haconvdr_tpu.index.quantize import encode_int8, scale_from_amax

    if not by_residual:

        @jax.jit
        def q8(buckets, tail):
            amax = jnp.maximum(
                jnp.abs(buckets.astype(jnp.float32)).max(axis=(0, 1)),
                jnp.abs(tail.astype(jnp.float32)).max(axis=0),
            )
            scale = scale_from_amax(amax)
            return encode_int8(buckets, scale), encode_int8(tail, scale), scale

        b8, t8, scale = q8(index.buckets, index.tail)
        return index._replace(buckets=b8, tail=t8, scale=scale)

    @jax.jit
    def q8_res(buckets, bucket_ids, tail, tail_ids):
        valid_b = (bucket_ids >= 0)[..., None]  # [nlist, cap, 1]
        valid_t = (tail_ids >= 0)[..., None]  # [rows, 1]
        bf = buckets.astype(jnp.float32) * valid_b
        tf = tail.astype(jnp.float32) * valid_t
        cnt_b = jnp.maximum(valid_b.sum(axis=1), 1.0)  # [nlist, 1]
        means = bf.sum(axis=1) / cnt_b  # [nlist, D]
        n_all = jnp.maximum(valid_b.sum() + valid_t.sum(), 1.0)
        mu = (bf.sum(axis=(0, 1)) + tf.sum(axis=0)) / n_all  # [D]
        res_b = (bf - means[:, None, :]) * valid_b  # pad rows stay 0
        res_t = (tf - mu) * valid_t
        # PER-CLUSTER per-dim scales [nlist, D]: k-means merges/uneven
        # clusters inflate a shared amax by the worst cluster's spread —
        # per-cluster scales keep each bucket's step at ITS residual
        # scale (the query fold moves inside per_probe, a [D] multiply)
        scale = scale_from_amax(jnp.abs(res_b).max(axis=1))
        tail_scale = scale_from_amax(jnp.abs(res_t).max(axis=0))
        return (
            encode_int8(res_b, scale[:, None, :]),
            encode_int8(res_t, tail_scale),
            scale, means, mu, tail_scale,
        )

    b8, t8, scale, means, mu, tail_scale = q8_res(
        index.buckets, index.bucket_ids, index.tail, index.tail_ids
    )
    return index._replace(
        buckets=b8, tail=t8, scale=scale, means=means, mu=mu,
        tail_scale=tail_scale,
    )


def build_ivf(
    embeddings: np.ndarray,  # [N, D]
    nlist: int = 1024,
    nprobe: int = 32,
    slack: float = 1.3,
    train_rows: int = 262_144,
    kmeans_iters: int = 10,
    ids: Optional[np.ndarray] = None,
    dtype: str = "float32",
    seed: int = 0,
) -> IVFIndex:
    """Cluster, reorder into equal-capacity buckets, spill overflow to the
    tail.  ``capacity = ceil(N / nlist * slack)`` rounded up to 8 rows."""
    N, D = embeddings.shape
    if N < nlist:
        raise ValueError(f"corpus has {N} rows < nlist={nlist}")
    nprobe = min(nprobe, nlist)
    jdt = jnp.dtype(dtype)
    if jdt not in (jnp.float32, jnp.bfloat16):
        raise ValueError("IVF stores float32/bfloat16 buckets, got " + dtype)
    ids = np.arange(N, dtype=np.int32) if ids is None else np.asarray(ids, np.int32)
    key = jax.random.PRNGKey(seed)
    sample = embeddings
    if N > train_rows:
        sel = np.random.RandomState(seed).choice(N, train_rows, replace=False)
        sample = embeddings[sel]
    cent = spherical_kmeans(jnp.asarray(sample, jnp.float32), nlist, kmeans_iters, key)
    cent_np = np.asarray(cent)

    # host-side assignment in chunks (one pass over the corpus)
    capacity = int(np.ceil(N * slack / nlist))
    capacity = max(8, -(-capacity // 8) * 8)
    buckets = np.zeros((nlist, capacity, D), jdt)
    bucket_ids = np.full((nlist, capacity), -1, np.int32)
    fill = np.zeros(nlist, np.int64)
    spill_rows, spill_ids = [], []

    assign_fn = jax.jit(
        lambda xb: jnp.argmax(
            (
                xb / jnp.maximum(jnp.linalg.norm(xb, axis=1, keepdims=True), 1e-6)
            )
            @ cent.T,
            axis=1,
        )
    )
    CH = 65536
    for s in range(0, N, CH):
        xb = np.asarray(embeddings[s : s + CH], np.float32)
        a = np.asarray(assign_fn(jnp.asarray(xb)))
        for j, c in enumerate(a):
            f = fill[c]
            if f < capacity:
                buckets[c, f] = xb[j]
                bucket_ids[c, f] = ids[s + j]
                fill[c] = f + 1
            else:
                spill_rows.append(xb[j])
                spill_ids.append(ids[s + j])

    tail_n = len(spill_rows)
    tail_pad = max(8, -(-max(tail_n, 1) // 8) * 8)
    tail = np.zeros((tail_pad, D), jdt)
    tail_ids = np.full((tail_pad,), -1, np.int32)
    if tail_n:
        tail[:tail_n] = np.stack(spill_rows)
        tail_ids[:tail_n] = np.asarray(spill_ids, np.int32)

    return IVFIndex(
        centroids=cent,
        buckets=jnp.asarray(buckets),
        bucket_ids=jnp.asarray(bucket_ids),
        tail=jnp.asarray(tail),
        tail_ids=jnp.asarray(tail_ids),
        nprobe=int(nprobe),
    )


def build_ivf_device(
    embeddings: jax.Array,  # [N, D] device-resident
    nlist: int = 1024,
    nprobe: int = 32,
    slack: float = 1.3,
    tail_frac: float = 0.1,
    train_rows: int = 262_144,
    kmeans_iters: int = 10,
    ids: Optional[jax.Array] = None,
    seed: int = 0,
) -> IVFIndex:
    """Whole-on-device IVF build: k-means, assignment, and the bucket
    reorder all happen in HBM — the corpus never round-trips the host
    (at 25.7M x 768 that round-trip is the build cost).  The reorder is a
    stable sort by cluster followed by one static scatter:
    ``dest = cluster * capacity + rank_within_cluster`` for in-capacity
    rows, tail positions for the overflow.  Raises if the overflow
    exceeds ``tail_frac`` of N (re-run with more slack)."""
    N, D = embeddings.shape
    if N < nlist:
        raise ValueError(f"corpus has {N} rows < nlist={nlist}")
    nprobe = min(nprobe, nlist)
    ids = (
        jnp.arange(N, dtype=jnp.int32) if ids is None else ids.astype(jnp.int32)
    )
    capacity = int(np.ceil(N * slack / nlist))
    capacity = max(8, -(-capacity // 8) * 8)
    tail_cap = max(8, -(-int(N * tail_frac) // 8) * 8)
    key = jax.random.PRNGKey(seed)
    # sample BEFORE casting: a full f32 copy of a bf16 corpus would double
    # its HBM footprint just to draw the k-means sample
    if N <= train_rows:
        sample = embeddings.astype(jnp.float32)
    else:
        sel = jax.random.choice(key, N, (train_rows,), replace=False)
        sample = embeddings[sel].astype(jnp.float32)
    cent = spherical_kmeans(sample, nlist, kmeans_iters, key)
    sample = None

    CH = min(65536, N)
    n_chunks = -(-N // CH)

    @jax.jit
    def reorder(x, ids, cent):
        # chunked assignment: a materialized [N, nlist] score matrix is
        # tens of GB at corpus scale.  Overlapping dynamic-slice windows
        # (the last one clamped to N - CH) avoid padding the corpus into
        # a second full-size copy; double-written rows get the same value.
        starts = jnp.minimum(
            jnp.arange(n_chunks, dtype=jnp.int32) * CH, N - CH
        )

        def assign_chunk(s):
            xc = jax.lax.dynamic_slice_in_dim(x, s, CH).astype(jnp.float32)
            xc = xc / jnp.maximum(jnp.linalg.norm(xc, axis=1, keepdims=True), 1e-6)
            return jnp.argmax(xc @ cent.T, axis=1).astype(jnp.int32)

        parts = jax.lax.map(assign_chunk, starts)  # [n_chunks, CH]
        row = (starts[:, None] + jnp.arange(CH, dtype=jnp.int32)).reshape(-1)
        a = jnp.zeros((N,), jnp.int32).at[row].set(parts.reshape(-1))
        order = jnp.argsort(a, stable=True)
        a_sorted = a[order]
        start = jnp.searchsorted(a_sorted, jnp.arange(nlist, dtype=jnp.int32))
        rank = jnp.arange(N, dtype=jnp.int32) - start[a_sorted].astype(jnp.int32)
        in_bucket = rank < capacity
        spill_rank = jnp.cumsum(~in_bucket) - 1
        dest = jnp.where(
            in_bucket,
            a_sorted * capacity + rank,
            nlist * capacity + spill_rank,
        )
        total = nlist * capacity + tail_cap
        # invert the permutation with a tiny int32 scatter, then build the
        # bucket and tail arrays by direct gathers from x: scattering
        # x[order] (or slicing one big flat array afterwards) would
        # materialize extra corpus-sized copies (OOM at 2.5M x 768)
        src = jnp.full((total,), -1, jnp.int32).at[dest].set(
            order.astype(jnp.int32), mode="drop"
        )

        def take(s):
            v = (s >= 0)[..., None]
            return (
                jnp.where(v, x[jnp.clip(s, 0)], jnp.zeros((), x.dtype)),
                jnp.where(s >= 0, ids[jnp.clip(s, 0)], -1),
            )

        split = nlist * capacity
        buckets, bucket_ids = take(src[:split].reshape(nlist, capacity))
        tail, tail_ids = take(src[split:])
        return buckets, bucket_ids, tail, tail_ids, (~in_bucket).sum()

    buckets, bucket_ids, tail, tail_ids, spill = reorder(embeddings, ids, cent)
    n_spill = int(spill)
    if n_spill > tail_cap:
        raise ValueError(
            f"IVF overflow: {n_spill} rows spill but tail capacity is "
            f"{tail_cap}; raise slack= or tail_frac="
        )
    # trim the tail to its used prefix (spill rows are contiguous from 0):
    # the always-scanned tail costs every query tail_ROWS x D of HBM
    # traffic, so capacity headroom beyond the actual spill is pure waste
    used = max(8, -(-n_spill // 8) * 8)
    if used < tail.shape[0]:
        tail = tail[:used]
        tail_ids = tail_ids[:used]
    return IVFIndex(
        centroids=cent,
        buckets=buckets,
        bucket_ids=bucket_ids,
        tail=tail,
        tail_ids=tail_ids,
        nprobe=int(nprobe),
    )


@functools.partial(jax.jit, static_argnames=("k", "nprobe"))
def _ivf_search_one(
    index_arrays,
    q: jax.Array,  # [D]
    k: int,
    nprobe: int,
) -> Tuple[jax.Array, jax.Array]:
    (cent, buckets, bucket_ids, tail, tail_ids, scale, means, mu,
     tail_scale) = index_arrays
    nlist, capacity, D = buckets.shape
    qf = q.astype(jnp.float32)
    qn = qf / jnp.maximum(jnp.linalg.norm(qf), 1e-6)
    _, probe = jax.lax.top_k(cent @ qn, nprobe)  # [nprobe]
    if scale is None:
        qb = q.astype(buckets.dtype)
        cast = lambda r: r  # noqa: E731
    elif scale.ndim == 1:  # int8, one global scale: pre-fold the query
        qb = (qf * scale).astype(jnp.bfloat16)
        cast = lambda r: r.astype(jnp.bfloat16)  # noqa: E731
    else:  # int8, PER-CLUSTER scales: fold inside per_probe
        qb = None
        cast = lambda r: r.astype(jnp.bfloat16)  # noqa: E731
    # residual codes (quantize_ivf by_residual): the exact f32 q.mean
    # correction per cluster — one [nlist, D] matvec, ~1.6 MFLOP
    cm = None if means is None else means @ qf  # [nlist]
    tail_corr = jnp.float32(0.0) if mu is None else mu @ qf

    # loop the probed buckets with dynamic slices (whole-bucket reads
    # instead of a row gather); scoring in the store dtype with f32
    # accumulation avoids materializing an f32 copy of the panel
    def per_probe(p):
        b = jax.lax.dynamic_index_in_dim(buckets, p, axis=0, keepdims=False)
        pid = jax.lax.dynamic_index_in_dim(bucket_ids, p, axis=0, keepdims=False)
        qb_p = qb if qb is not None else (qf * scale[p]).astype(jnp.bfloat16)
        s = jax.lax.dot_general(
            cast(b), qb_p, (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )  # [capacity]
        if cm is not None:
            s = s + cm[p]
        return s, pid

    scores_p, ids_p = jax.lax.map(per_probe, probe)  # [nprobe, capacity]
    # residual tail rows carry their own (larger) scale
    qb_t = qb if tail_scale is None else (qf * tail_scale).astype(jnp.bfloat16)
    tail_scores = jax.lax.dot_general(
        cast(tail), qb_t, (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    ) + tail_corr
    scores = jnp.concatenate([scores_p.reshape(-1), tail_scores])
    ids = jnp.concatenate([ids_p.reshape(-1), tail_ids])
    scores = jnp.where(ids >= 0, scores, -jnp.inf)  # mask pad rows
    top_s, pos = jax.lax.top_k(scores, k)
    return top_s, ids[pos]


def ivf_search(
    index: IVFIndex,
    queries: np.ndarray,  # [Q, D]
    k: int = 100,
    nprobe: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """(scores [Q, k], global ids [Q, k]); exact over the probed buckets +
    tail.  Queries are mapped one at a time (lax.map) to bound the gather
    working set — the intended regime is online/small-batch serving; batch
    evaluation should use the exact flat path."""
    nprobe = index.nprobe if nprobe is None else nprobe
    nprobe = min(nprobe, index.centroids.shape[0])
    arrays = (
        index.centroids, index.buckets, index.bucket_ids,
        index.tail, index.tail_ids, index.scale, index.means, index.mu,
        index.tail_scale,
    )
    s, i = _ivf_search_batch(arrays, jnp.asarray(queries), k, nprobe)
    return np.asarray(s), np.asarray(i)


# module-level jit: index arrays are ARGUMENTS, not closure captures
# (capturing bakes GBs of constants into the program), and the cache must
# persist across ivf_search calls (a per-call jit wrapper would retrace +
# recompile every query — seconds per call at serving scale)
@functools.partial(jax.jit, static_argnames=("k", "nprobe"))
def _ivf_search_batch(arrays, qs, k, nprobe):
    return jax.lax.map(lambda one: _ivf_search_one(arrays, one, k, nprobe), qs)


def save_ivf(index: IVFIndex, dir_path: str) -> None:
    """Persist an IVF index (arrays as .npy + meta.json), so the build
    cost (~6 s at 2.5M, minutes at 54M) is paid once offline — the
    serving analog of the reference's embedding-block artifacts."""
    import json
    import os

    os.makedirs(dir_path, exist_ok=True)
    for name in ("centroids", "buckets", "bucket_ids", "tail", "tail_ids"):
        np.save(os.path.join(dir_path, name + ".npy"), np.asarray(getattr(index, name)))
    for name in ("scale", "means", "mu", "tail_scale"):
        path = os.path.join(dir_path, name + ".npy")
        val = getattr(index, name)
        if val is not None:
            np.save(path, np.asarray(val))
        elif os.path.exists(path):
            # a float index re-saved over a quantized one must not leave
            # stale sidecars behind (load would fold them into scores)
            os.remove(path)
    with open(os.path.join(dir_path, "ivf_meta.json"), "w") as f:
        json.dump({"nprobe": index.nprobe, "version": 1}, f)


def load_ivf(dir_path: str) -> IVFIndex:
    """Inverse of :func:`save_ivf`; bf16 arrays round-trip through
    np.save's raw-void encoding like the embedding block store."""
    import json
    import os

    def _load(name):
        arr = np.load(os.path.join(dir_path, name + ".npy"))
        if arr.dtype == np.dtype("V2"):  # np.save round-trips bf16 as raw
            import ml_dtypes

            arr = arr.view(ml_dtypes.bfloat16)
        return jnp.asarray(arr)

    with open(os.path.join(dir_path, "ivf_meta.json")) as f:
        meta = json.load(f)

    def _opt(name):
        return (
            _load(name)
            if os.path.exists(os.path.join(dir_path, name + ".npy"))
            else None
        )

    return IVFIndex(
        centroids=_load("centroids"),
        buckets=_load("buckets"),
        bucket_ids=_load("bucket_ids"),
        tail=_load("tail"),
        tail_ids=_load("tail_ids"),
        nprobe=int(meta["nprobe"]),
        scale=_opt("scale"),
        means=_opt("means"),
        mu=_opt("mu"),
        tail_scale=_opt("tail_scale"),
    )
