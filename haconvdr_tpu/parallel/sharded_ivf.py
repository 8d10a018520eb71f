"""Mesh-sharded IVF serving: the cluster-pruned index at pod scale.

The single-device IVF index (index/ivf.py) is capacity-limited by one card:
QReCC-54M buckets are ~90 GB bf16 with the build's slack.  Here the bucket
array is sharded along the CLUSTER axis across the mesh (each device owns
``nlist / n_shards`` whole clusters plus a slice of the spill tail) and a
query is answered cooperatively:

  * every shard computes the same global top-``nprobe`` centroid probe
    (centroids are replicated — tiny);
  * each shard scores only the probed clusters IT OWNS (non-owned probes
    are masked, keeping shapes static) plus its local tail slice;
  * per-shard candidates meet in the same ``all_gather`` + on-device
    ``lax.top_k`` merge as the flat sharded index
    (parallel/sharded_search.py), so results are identical to the
    single-device IVF search over the same index.

Latency stays in the single-chip IVF class (each shard does at most the
single-chip amount of bucket work; the merge adds one small collective);
the win is CAPACITY — buckets live once across the pod, replacing faiss's
GPU shard clone (src/test_HAConvDR_topiocqa.py:55-66) for the pruned
serving path the reference does not have at all.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from haconvdr_tpu.index.ivf import IVFIndex, spherical_kmeans


def _flat_mesh(mesh: Mesh) -> Mesh:
    return Mesh(mesh.devices.reshape(-1), ("d",))


def shard_ivf(mesh: Mesh, index: IVFIndex) -> IVFIndex:
    """Place an IVFIndex across the mesh: buckets/bucket_ids sharded on the
    cluster axis, tail sharded on rows, centroids replicated.  ``nlist``
    and the tail row count must divide the shard count (build with
    matching nlist / tail_frac, or pad the tail)."""
    fmesh = _flat_mesh(mesh)
    n = fmesh.devices.size
    nlist = index.buckets.shape[0]
    if nlist % n:
        raise ValueError(
            f"nlist ({nlist}) must divide the shard count ({n}); build with "
            f"a matching nlist"
        )
    tail_rows = index.tail.shape[0]
    pad = -tail_rows % n
    if pad:  # pad the tail with -1-id rows so every shard gets a slice
        index = index._replace(
            tail=jnp.concatenate(
                [index.tail, jnp.zeros((pad, index.tail.shape[1]), index.tail.dtype)]
            ),
            tail_ids=jnp.concatenate(
                [index.tail_ids, jnp.full((pad,), -1, jnp.int32)]
            ),
        )
    rep = NamedSharding(fmesh, P())
    row_sh = NamedSharding(fmesh, P("d"))
    return IVFIndex(
        centroids=jax.device_put(index.centroids, rep),
        buckets=jax.device_put(index.buckets, NamedSharding(fmesh, P("d", None, None))),
        bucket_ids=jax.device_put(index.bucket_ids, NamedSharding(fmesh, P("d", None))),
        tail=jax.device_put(index.tail, NamedSharding(fmesh, P("d", None))),
        tail_ids=jax.device_put(index.tail_ids, row_sh),
        nprobe=index.nprobe,
        scale=None if index.scale is None else jax.device_put(index.scale, rep),
        means=None if index.means is None else jax.device_put(index.means, rep),
        mu=None if index.mu is None else jax.device_put(index.mu, rep),
        tail_scale=None if index.tail_scale is None else jax.device_put(
            index.tail_scale, rep
        ),
    )


@functools.partial(jax.jit, static_argnames=("mesh", "k", "nprobe"))
def _sharded_ivf_search(
    mesh: Mesh,
    centroids: jax.Array,
    buckets: jax.Array,
    bucket_ids: jax.Array,
    tail: jax.Array,
    tail_ids: jax.Array,
    queries: jax.Array,  # [Q, D] replicated
    k: int,
    nprobe: int,
    scale: jax.Array = None,  # [D] int8 dequant scale (quantize_ivf)
    means: jax.Array = None,  # [nlist, D] residual-quant cluster means
    mu: jax.Array = None,  # [D] residual-quant tail reference
    tail_scale: jax.Array = None,  # [D] residual tail's own scale
) -> Tuple[jax.Array, jax.Array]:
    fmesh = _flat_mesh(mesh)
    n_shards = fmesh.devices.size
    nlist = buckets.shape[0]
    per_shard = nlist // n_shards

    def local(q_all, cent, b, bi, t, ti, *rest):
        shard = jax.lax.axis_index("d")
        lo = shard * per_shard

        def one(q):
            qf = q.astype(jnp.float32)
            qn = qf / jnp.maximum(jnp.linalg.norm(qf), 1e-6)
            _, probe = jax.lax.top_k(cent @ qn, nprobe)  # global cluster ids
            if rest and rest[0].ndim == 1:
                # int8 buckets, one global scale: pre-fold the query
                qb = (qf * rest[0]).astype(jnp.bfloat16)
                cast = lambda r: r.astype(jnp.bfloat16)  # noqa: E731
            elif rest:  # int8, PER-CLUSTER scales: fold inside per_probe
                qb = None
                cast = lambda r: r.astype(jnp.bfloat16)  # noqa: E731
            else:
                qb = q.astype(b.dtype)
                cast = lambda r: r  # noqa: E731
            # residual codes (quantize_ivf by_residual): exact q.mean
            # corrections — means/mu are replicated, probe ids are GLOBAL
            # so cm indexes with the global probe id; tail rows carry
            # their own (larger) residual scale
            cm = rest[1] @ qf if len(rest) == 4 else None  # [nlist]
            t_corr = rest[2] @ qf if len(rest) == 4 else jnp.float32(0.0)
            qb_t = (
                (qf * rest[3]).astype(jnp.bfloat16) if len(rest) == 4 else qb
            )
            owned = (probe >= lo) & (probe < lo + per_shard)
            local_idx = jnp.clip(probe - lo, 0, per_shard - 1)

            def per_probe(args):
                p, gp, own = args
                rows = jax.lax.dynamic_index_in_dim(b, p, axis=0, keepdims=False)
                pid = jax.lax.dynamic_index_in_dim(bi, p, axis=0, keepdims=False)
                qb_p = (
                    qb
                    if qb is not None
                    else (qf * rest[0][gp]).astype(jnp.bfloat16)
                )
                s = jax.lax.dot_general(
                    cast(rows), qb_p, (((1,), (0,)), ((), ())),
                    preferred_element_type=jnp.float32,
                )
                if cm is not None:
                    s = s + cm[gp]
                # non-owned probes are dummy work on clamped indices:
                # masked out here so only the owning shard reports them
                return jnp.where(own, s, -jnp.inf), jnp.where(own, pid, -1)

            s_p, i_p = jax.lax.map(per_probe, (local_idx, probe, owned))
            t_s = jax.lax.dot_general(
                cast(t), qb_t, (((1,), (0,)), ((), ())),
                preferred_element_type=jnp.float32,
            ) + t_corr
            scores = jnp.concatenate([s_p.reshape(-1), t_s])
            ids = jnp.concatenate([i_p.reshape(-1), ti])
            scores = jnp.where(ids >= 0, scores, -jnp.inf)
            ts, pos = jax.lax.top_k(scores, k)
            return ts, ids[pos]

        ls, li = jax.lax.map(one, q_all)  # [Q, k] local candidates
        sg = jax.lax.all_gather(ls, "d")  # [n_shards, Q, k]
        ig = jax.lax.all_gather(li, "d")
        Q = q_all.shape[0]
        sg = jnp.moveaxis(sg, 0, 1).reshape(Q, n_shards * k)
        ig = jnp.moveaxis(ig, 0, 1).reshape(Q, n_shards * k)
        best_s, pos = jax.lax.top_k(sg, k)
        return best_s, jnp.take_along_axis(ig, pos, axis=1)

    extra = ()
    if scale is not None:
        extra = (
            (scale,) if means is None else (scale, means, mu, tail_scale)
        )
    in_specs = (
        P(), P(), P("d", None, None), P("d", None), P("d", None), P("d")
    ) + (P(),) * len(extra)
    args = (queries, centroids, buckets, bucket_ids, tail, tail_ids) + extra
    fn = jax.shard_map(
        local,
        mesh=fmesh,
        in_specs=in_specs,
        out_specs=(P(), P()),
        check_vma=False,
    )
    return fn(*args)


# -- pod-scale build ---------------------------------------------------------
#
# Memory math at reference scale (SURVEY §6): QReCC 54,573,064 x 768.
#   bf16 rows                = 83.9 GB
#   IVF buckets at slack 1.3 = 109 GB bf16 / 54.5 GB int8 (+ tail)
# The build below streams the corpus from disk in blocks, holding at most
# ONE scatter chunk on the host (default 64k rows = 100 MB f32), and pushes
# each row directly to its owning shard's device.  Per-shard device peak is
# its own bucket slab + one chunk: bf16 buckets over four 80 GB cards are
# ~27 GB per shard, and no single-host full-corpus buffer is needed.  Disk is read three times (sample, assign,
# scatter); all three passes are sequential streaming reads.


@functools.partial(jax.jit, donate_argnums=(0, 1))
def _scatter_chunk(flat, flat_ids, rows, row_ids, slots):
    """Scatter one padded chunk into a shard's flat row/id slabs.  Padded
    entries carry slot == len(flat) (one past the end) and are dropped —
    positive OOB, never a negative index (which jnp would wrap)."""
    return (
        flat.at[slots].set(rows, mode="drop"),
        flat_ids.at[slots].set(row_ids, mode="drop"),
    )


@functools.partial(jax.jit, static_argnames=("per_shard", "capacity"))
def _split_shard(flat, flat_ids, per_shard, capacity):
    pc = per_shard * capacity
    return (
        flat[:pc].reshape(per_shard, capacity, flat.shape[1]),
        flat_ids[:pc].reshape(per_shard, capacity),
        flat[pc:],
        flat_ids[pc:],
    )


@functools.partial(jax.jit, static_argnames=("nlist",))
def _assign_chunk(xc, cent, nlist):
    xc = xc.astype(jnp.float32)
    xc = xc / jnp.maximum(jnp.linalg.norm(xc, axis=1, keepdims=True), 1e-6)
    return jnp.argmax(xc @ cent.T, axis=1).astype(jnp.int32)


def build_ivf_from_store(
    mesh: Mesh,
    store,  # EmbeddingBlockStore
    nlist: int = 4096,
    nprobe: int = 64,
    slack: float = 1.3,
    train_rows: int = 262_144,
    kmeans_iters: int = 10,
    dtype: str = "bfloat16",
    seed: int = 0,
    num_blocks: int = -1,
    chunk_rows: int = 65_536,
    by_residual: bool = True,
) -> IVFIndex:
    """Mesh-sharded IVF build straight from an EmbeddingBlockStore — the
    multi-device replacement for ``index.ivf.build_ivf_device`` (one device)
    and for the faiss GPU shard clone it supersedes
    (src/test_HAConvDR_topiocqa.py:55-66).

    Layout matches :func:`shard_ivf`: shard ``s`` owns whole clusters
    ``[s*nlist/n, (s+1)*nlist/n)`` (buckets sharded on the cluster axis)
    plus a round-robin slice of the spill tail; centroids are replicated.
    The returned IVFIndex is searched with :func:`sharded_ivf_search` and
    returns results identical to a single-device build over the same data
    (tests assert this on the virtual mesh).

    Three streaming passes over the store: (0) strided k-means sample
    (+ per-dim amax when ``dtype='int8'`` with ``by_residual=False``),
    (1) chunked device-side cluster assignment (+ per-cluster mean
    accumulation) keeping only an int32 per row on the host, (2)
    scatter — each block's rows are routed to their owning shard in
    fixed-size padded chunks and folded into that shard's flat slab with a
    donated in-place scatter.  The tail is sized to the measured spill
    (no tail_frac guess, no overflow failure mode).

    ``dtype='int8'`` defaults to RESIDUAL quantization (the
    index.ivf.quantize_ivf by_residual scheme: codes store
    ``row - mean(cluster)``, tail rows ``row - mean(corpus)``, search adds
    the exact q.mean corrections) — the global scheme measured
    recall@100 = 0.539 on real-encoder geometry (NOTES.md).  Residual
    scales need the final means before encoding, so it costs one extra
    streaming pass (per-row residual amax); ``by_residual=False`` keeps
    the 3-pass global build.
    """
    fmesh = _flat_mesh(mesh)
    devices = list(fmesh.devices.reshape(-1))
    n_shards = len(devices)
    if nlist % n_shards:
        raise ValueError(f"nlist ({nlist}) must divide shard count ({n_shards})")
    jdt = jnp.dtype(dtype)
    is_int8 = jdt == jnp.int8
    if jdt not in (jnp.float32, jnp.bfloat16, jnp.int8):
        raise ValueError("IVF bucket dtype must be float32/bfloat16/int8")

    nb = store.num_blocks() if num_blocks < 0 else num_blocks
    sizes = [store.block_size(b) for b in range(nb)]
    N = int(sum(sizes))
    if N < nlist:
        raise ValueError(f"corpus has {N} rows < nlist={nlist}")
    nprobe = min(nprobe, nlist)

    residual = is_int8 and by_residual
    # pass 0: strided sample for k-means (+ amax for the GLOBAL int8
    # scale; the residual scale needs the final means, see pass 1.5)
    stride = max(1, N // train_rows)
    sample_parts = []
    amax = None
    for emb, _ids in store.iter_blocks(nb):
        sample_parts.append(np.asarray(emb[::stride], np.float32))
        if is_int8 and not residual:
            a = np.abs(np.asarray(emb, np.float32)).max(axis=0)
            amax = a if amax is None else np.maximum(amax, a)
    sample = np.concatenate(sample_parts)[: max(train_rows, nlist)]
    D = sample.shape[1]
    cent = spherical_kmeans(
        jnp.asarray(sample), nlist, kmeans_iters, jax.random.PRNGKey(seed)
    )
    del sample_parts, sample
    if is_int8:
        from haconvdr_tpu.index.quantize import encode_int8, scale_from_amax
    scale = None
    if is_int8 and not residual:
        scale = scale_from_amax(jnp.asarray(amax))
        scale_np = np.asarray(scale)

    # pass 1: chunked assignment; host keeps int32 per row (216 MB at
    # 54M).  Residual builds also accumulate per-cluster sums/counts on
    # the host (means for the residual codes; [nlist, D] f64 accumulator)
    assign = np.empty((N,), np.int32)
    ids_all = np.empty((N,), np.int64)
    msum = np.zeros((nlist, D), np.float64) if residual else None
    mcnt = np.zeros((nlist,), np.int64) if residual else None
    row = 0
    for emb, ids in store.iter_blocks(nb):
        ids_all[row : row + len(ids)] = ids
        for s in range(0, emb.shape[0], chunk_rows):
            xc = np.asarray(emb[s : s + chunk_rows], np.float32)
            n = xc.shape[0]
            if n < chunk_rows:  # fixed-shape jit: pad the last chunk
                xc = np.concatenate(
                    [xc, np.zeros((chunk_rows - n, D), np.float32)]
                )
            a = np.asarray(_assign_chunk(jnp.asarray(xc), cent, nlist))
            assign[row + s : row + s + n] = a[:n]
            if residual:
                # reduceat over cluster-sorted rows: O(n D) without the
                # notoriously slow np.add.at scatter
                o = np.argsort(a[:n], kind="stable")
                a_srt = a[:n][o]
                starts = np.flatnonzero(
                    np.r_[True, a_srt[1:] != a_srt[:-1]]
                )
                sums = np.add.reduceat(xc[:n][o], starts, axis=0)
                uniq = a_srt[starts]
                msum[uniq] += sums
                mcnt += np.bincount(a_srt, minlength=nlist)
        row += emb.shape[0]
    assert ids_all.max() < 2**31, "ids exceed int32 (IVF ids are int32)"
    means_np = mu_np = None
    if residual:
        means_np = np.where(
            mcnt[:, None] > 0, msum / np.maximum(mcnt[:, None], 1), 0.0
        ).astype(np.float32)
        mu_np = (msum.sum(axis=0) / max(N, 1)).astype(np.float32)

    # destinations: rank-within-cluster in corpus order (same fill rule as
    # build_ivf_device's stable sort), overflow round-robins to shard tails
    capacity = int(np.ceil(N * slack / nlist))
    capacity = max(8, -(-capacity // 8) * 8)
    per_shard = nlist // n_shards
    order = np.argsort(assign, kind="stable")
    a_sorted = assign[order]
    start = np.searchsorted(a_sorted, np.arange(nlist))
    rank_sorted = np.arange(N, dtype=np.int64) - start[a_sorted]
    rank = np.empty((N,), np.int64)
    rank[order] = rank_sorted
    in_bucket = rank < capacity
    spill_rank = np.cumsum(~in_bucket) - 1  # corpus order
    n_spill = int((~in_bucket).sum())
    tail_per_shard = max(8, -(-(-(-n_spill // n_shards)) // 8) * 8)
    flat_rows = per_shard * capacity + tail_per_shard
    dest_shard = np.where(in_bucket, assign // per_shard, spill_rank % n_shards)
    dest_slot = np.where(
        in_bucket,
        (assign % per_shard).astype(np.int64) * capacity + rank,
        per_shard * capacity + spill_rank // n_shards,
    ).astype(np.int32)

    tail_scale = tail_scale_np = None
    if residual:
        # pass 1.5: exact per-dim residual amax — SEPARATE for bucket
        # rows (vs their cluster mean) and spill rows (vs the corpus
        # mean): tail residuals are much larger and a shared scale would
        # inflate the bucket step by their ratio.  The residual scale
        # cannot come from pass 0 because the means are only final after
        # pass 1; sampling instead would clip outliers
        amax_b = np.zeros((nlist, D), np.float32)  # per-cluster per-dim
        amax_t = np.zeros((D,), np.float32)
        row = 0
        for emb, _ids in store.iter_blocks(nb):
            nrow = emb.shape[0]
            for s in range(0, nrow, chunk_rows):
                xc = np.asarray(emb[s : s + chunk_rows], np.float32)
                sl = slice(row + s, row + s + xc.shape[0])
                ib = in_bucket[sl]
                if ib.any():
                    a = assign[sl][ib]
                    res = np.abs(xc[ib] - means_np[a])
                    # reduceat-max over cluster-sorted rows (cheap
                    # per-cluster reduction, same trick as the means)
                    o = np.argsort(a, kind="stable")
                    a_srt = a[o]
                    starts = np.flatnonzero(
                        np.r_[True, a_srt[1:] != a_srt[:-1]]
                    )
                    mx = np.maximum.reduceat(res[o], starts, axis=0)
                    uniq = a_srt[starts]
                    amax_b[uniq] = np.maximum(amax_b[uniq], mx)
                if (~ib).any():
                    amax_t = np.maximum(
                        amax_t, np.abs(xc[~ib] - mu_np).max(axis=0)
                    )
            row += nrow
        scale = scale_from_amax(jnp.asarray(amax_b))
        scale_np = np.asarray(scale)
        tail_scale = scale_from_amax(jnp.asarray(amax_t))
        tail_scale_np = np.asarray(tail_scale)

    # pass 2: stream blocks, route rows to shards in fixed-size chunks
    import ml_dtypes

    if is_int8:
        host_dt, dev_dt = np.int8, jnp.int8
    elif jdt == jnp.bfloat16:
        host_dt, dev_dt = ml_dtypes.bfloat16, jnp.bfloat16
    else:
        host_dt, dev_dt = np.float32, jnp.float32
    flats = [
        jax.device_put(jnp.zeros((flat_rows, D), dev_dt), devices[s])
        for s in range(n_shards)
    ]
    flat_ids = [
        jax.device_put(jnp.full((flat_rows,), -1, jnp.int32), devices[s])
        for s in range(n_shards)
    ]
    row = 0
    for emb, ids in store.iter_blocks(nb):
        nrow = emb.shape[0]
        blk_shard = dest_shard[row : row + nrow]
        blk_slot = dest_slot[row : row + nrow]
        for s in range(n_shards):
            sel = np.flatnonzero(blk_shard == s)
            for c0 in range(0, len(sel), chunk_rows):
                idx = sel[c0 : c0 + chunk_rows]
                n = len(idx)
                rows_np = np.asarray(emb[idx], np.float32)
                if is_int8:
                    if residual:
                        g = row + idx
                        ib = in_bucket[g][:, None]
                        rows_np = rows_np - np.where(
                            ib, means_np[assign[g]], mu_np
                        )
                        row_scale = np.where(
                            ib, scale_np[assign[g]], tail_scale_np
                        )
                        rows_np = np.clip(
                            np.rint(rows_np / row_scale), -127, 127
                        )
                    else:
                        rows_np = np.asarray(encode_int8(rows_np, scale_np))
                rows_np = rows_np.astype(host_dt)
                slots_np = blk_slot[idx]
                if n < chunk_rows:  # pad: slot == flat_rows drops (OOB)
                    rows_np = np.concatenate(
                        [rows_np, np.zeros((chunk_rows - n, D), host_dt)]
                    )
                    slots_np = np.concatenate(
                        [slots_np, np.full((chunk_rows - n,), flat_rows, np.int32)]
                    )
                rid = ids_all[row + idx].astype(np.int32)
                if n < chunk_rows:
                    rid = np.concatenate(
                        [rid, np.full((chunk_rows - n,), -1, np.int32)]
                    )
                flats[s], flat_ids[s] = _scatter_chunk(
                    flats[s],
                    flat_ids[s],
                    jax.device_put(rows_np, devices[s]),
                    jax.device_put(rid, devices[s]),
                    jax.device_put(slots_np.astype(np.int32), devices[s]),
                )
        row += nrow

    # assemble the globally-sharded IVFIndex (shard_ivf layout)
    pieces = [
        _split_shard(flats[s], flat_ids[s], per_shard, capacity)
        for s in range(n_shards)
    ]
    buckets = jax.make_array_from_single_device_arrays(
        (nlist, capacity, D),
        NamedSharding(fmesh, P("d", None, None)),
        [p[0] for p in pieces],
    )
    bucket_ids = jax.make_array_from_single_device_arrays(
        (nlist, capacity),
        NamedSharding(fmesh, P("d", None)),
        [p[1] for p in pieces],
    )
    tail = jax.make_array_from_single_device_arrays(
        (n_shards * tail_per_shard, D),
        NamedSharding(fmesh, P("d", None)),
        [p[2] for p in pieces],
    )
    tail_ids = jax.make_array_from_single_device_arrays(
        (n_shards * tail_per_shard,),
        NamedSharding(fmesh, P("d")),
        [p[3] for p in pieces],
    )
    rep = NamedSharding(fmesh, P())
    return IVFIndex(
        centroids=jax.device_put(cent, rep),
        buckets=buckets,
        bucket_ids=bucket_ids,
        tail=tail,
        tail_ids=tail_ids,
        nprobe=int(nprobe),
        scale=None if scale is None else jax.device_put(scale, rep),
        means=None if means_np is None else jax.device_put(
            jnp.asarray(means_np), rep
        ),
        mu=None if mu_np is None else jax.device_put(jnp.asarray(mu_np), rep),
        tail_scale=None if tail_scale is None else jax.device_put(
            tail_scale, rep
        ),
    )


def sharded_ivf_search(
    mesh: Mesh,
    index: IVFIndex,
    queries: np.ndarray,  # [Q, D]
    k: int = 100,
    nprobe: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """(scores [Q, k], ids [Q, k]) — identical results to the
    single-device ivf_search over the same index (tests assert this on
    the virtual mesh)."""
    nprobe = nprobe or index.nprobe
    nprobe = min(nprobe, index.centroids.shape[0])
    s, i = _sharded_ivf_search(
        mesh, index.centroids, index.buckets, index.bucket_ids,
        index.tail, index.tail_ids, jnp.asarray(queries), k, nprobe,
        scale=index.scale, means=index.means, mu=index.mu,
        tail_scale=index.tail_scale,
    )
    return np.asarray(s), np.asarray(i)


# -- sharded persistence -----------------------------------------------------
#
# The pod-scale build above is a 3-4 pass stream over the whole corpus
# (minutes at QReCC-54M); serving restarts must not repay it.  The
# single-device save_ivf/load_ivf (index/ivf.py) round-trips through one
# host buffer, which the 54M bucket slab cannot do — so the sharded index
# persists PER SHARD: each device's cluster slice and tail slice is pulled
# and written one at a time (host peak = one shard's slab), and loading
# re-assembles device-resident pieces with
# jax.make_array_from_single_device_arrays, never materializing the global
# arrays on host.  The shard count may CHANGE between save and load (pod
# reconfiguration): cluster slices re-split as long as nlist divides the
# new shard count; the spill tail re-splits on rows unconditionally (any
# row partition of the always-scanned tail is search-equivalent).  This is
# the serving analog of the reference's embedding-block artifact directory
# (gen_doc_embeddings.py blocks), applied to the pruned index.


def _save_bf16_safe(path, arr):
    np.save(path, np.asarray(arr))


def _mmap_load(path):
    from haconvdr_tpu.utils.io import load_npy_bf16

    return load_npy_bf16(path, mmap=True)


def save_ivf_sharded(index: IVFIndex, dir_path: str) -> None:
    """Persist a mesh-sharded IVFIndex as per-shard .npy slabs + one set
    of replicated sidecars.  Pulls ONE shard's slice to host at a time.

    Multi-process (multi-controller) pods: ``dir_path`` must be a SHARED
    filesystem.  Each process writes the global shards it owns (the
    lowest-device-id replica of each axis-0 slice wins, so every shard is
    written exactly once across the pod), all processes barrier, then
    process 0 writes the replicated sidecars + meta — counting valid rows
    from the just-written id files, so no cross-process collective is
    needed.  This is the reference's own persistence model
    (``barrier_array_merge``, src/utils.py:173-228: per-rank pickles to a
    shared filesystem + dist.barrier()), minus its gather-everything read
    side — ``load_ivf_sharded`` reads only each process's own slices."""
    import json
    import os

    os.makedirs(dir_path, exist_ok=True)

    def _write_shards(arr, name):
        """Write this process's owned global axis-0 shards; return the
        GLOBAL shard count (derived from the sharding's full device→index
        map, which covers non-addressable devices too)."""
        imap = arr.sharding.devices_indices_map(arr.shape)
        writer = {}
        for dev, idx in imap.items():
            sl = idx[0]
            start = 0 if sl.start is None else sl.start
            if start not in writer or dev.id < writer[start].id:
                writer[start] = dev
        order = {s: i for i, s in enumerate(sorted(writer))}
        for sh in arr.addressable_shards:
            sl = sh.index[0]
            start = 0 if sl.start is None else sl.start
            if writer[start].id != sh.device.id:
                continue  # another device (possibly another process) owns it
            _save_bf16_safe(
                os.path.join(dir_path, f"{name}_{order[start]:03d}.npy"),
                sh.data,
            )
        return len(order)

    n_shards = _write_shards(index.buckets, "buckets")
    for name in ("bucket_ids", "tail", "tail_ids"):
        n = _write_shards(getattr(index, name), name)
        if n != n_shards:
            raise ValueError(
                f"{name} has {n} shards, buckets {n_shards} — "
                "not a shard_ivf/build_ivf_from_store layout"
            )
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices("save_ivf_sharded:shards")
    if jax.process_index() == 0:
        _save_bf16_safe(
            os.path.join(dir_path, "centroids.npy"), index.centroids
        )
        for name in ("scale", "means", "mu", "tail_scale"):
            val = getattr(index, name)
            path = os.path.join(dir_path, name + ".npy")
            if val is not None:
                _save_bf16_safe(path, val)
            elif os.path.exists(path):
                os.remove(path)  # never leave stale quantization sidecars
        # staleness fingerprint for reload guards (serve.Retriever): the
        # exact valid-row count and the canonical bucket dtype.  Counted
        # from the saved id files (one mmap'd shard at a time) — the
        # global arrays are not addressable from one process on a pod.
        corpus_rows = 0
        for s in range(n_shards):
            for nm in ("bucket_ids", "tail_ids"):
                ids = _mmap_load(os.path.join(dir_path, f"{nm}_{s:03d}.npy"))
                corpus_rows += int((np.asarray(ids) >= 0).sum())
        with open(os.path.join(dir_path, "ivf_sharded_meta.json"), "w") as f:
            json.dump(
                {
                    "version": 1,
                    "n_shards": n_shards,
                    "nprobe": int(index.nprobe),
                    "nlist": int(index.buckets.shape[0]),
                    "capacity": int(index.buckets.shape[1]),
                    "dim": int(index.buckets.shape[2]),
                    "tail_rows": int(index.tail.shape[0]),
                    "bucket_dtype": str(index.buckets.dtype),
                    "corpus_rows": corpus_rows,
                },
                f,
            )
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        # every process returns only once the directory is complete
        multihost_utils.sync_global_devices("save_ivf_sharded:meta")


def load_ivf_sharded(mesh: Mesh, dir_path: str, with_meta: bool = False):
    """Inverse of :func:`save_ivf_sharded` onto ``mesh`` — which may have
    a DIFFERENT device count than the saving mesh (the target shard count
    must divide the saved nlist).  Host peak is one target shard's slab
    (per-shard mmap reads).  ``with_meta=True`` returns
    ``(index, meta_dict)`` so callers can run staleness checks."""
    import json
    import os

    with open(os.path.join(dir_path, "ivf_sharded_meta.json")) as f:
        meta = json.load(f)
    fmesh = _flat_mesh(mesh)
    devices = list(fmesh.devices.reshape(-1))
    n_new = len(devices)
    nlist, cap, D = meta["nlist"], meta["capacity"], meta["dim"]
    n_saved = meta["n_shards"]
    if nlist % n_new:
        raise ValueError(
            f"the target shard count ({n_new}) must divide the saved "
            f"nlist ({nlist}) — use a device count that divides {nlist}"
        )
    per_saved = nlist // n_saved
    per_new = nlist // n_new

    def _cluster_piece(name, i):
        """Global cluster rows [i*per_new, (i+1)*per_new) assembled from
        the saved shard files they live in."""
        lo, hi = i * per_new, (i + 1) * per_new
        parts = []
        g = lo
        while g < hi:
            f = g // per_saved
            f_lo = g - f * per_saved
            f_hi = min(per_saved, hi - f * per_saved)
            arr = _mmap_load(os.path.join(dir_path, f"{name}_{f:03d}.npy"))
            parts.append(np.array(arr[f_lo:f_hi]))
            g = f * per_saved + f_hi
        return np.concatenate(parts) if len(parts) > 1 else parts[0]

    # tail: re-split the global row set across the new shards (row
    # partition is search-equivalent; pad with -1-id zero rows to divide)
    t_sizes = [
        _mmap_load(os.path.join(dir_path, f"tail_ids_{s:03d}.npy")).shape[0]
        for s in range(n_saved)
    ]
    R = sum(t_sizes)
    Rp = max(1, -(-R // n_new))  # rows per new shard, padded
    t_starts = np.concatenate([[0], np.cumsum(t_sizes)])

    def _tail_piece(name, i, pad_value, pad_shape, pad_dtype):
        lo, hi = i * Rp, min((i + 1) * Rp, R)
        parts = []
        g = lo
        while g < hi:
            f = int(np.searchsorted(t_starts, g, side="right")) - 1
            f_lo = g - t_starts[f]
            f_hi = min(t_sizes[f], hi - t_starts[f])
            arr = _mmap_load(os.path.join(dir_path, f"{name}_{f:03d}.npy"))
            parts.append(np.array(arr[f_lo:f_hi]))
            g = t_starts[f] + f_hi
        need = Rp - max(0, hi - lo)
        if need:
            parts.append(np.full((need,) + pad_shape, pad_value, pad_dtype))
        return np.concatenate(parts) if len(parts) > 1 else parts[0]

    b_pieces, bi_pieces, t_pieces, ti_pieces = [], [], [], []
    tail_dtype = _mmap_load(os.path.join(dir_path, "tail_000.npy")).dtype
    for i in range(n_new):
        dev = devices[i]
        if dev.process_index != jax.process_index():
            # multi-controller pod: each process loads (and mmap-reads)
            # only the slices destined for its own devices
            continue
        b_pieces.append(jax.device_put(_cluster_piece("buckets", i), dev))
        bi_pieces.append(
            jax.device_put(_cluster_piece("bucket_ids", i), dev)
        )
        t = _tail_piece("tail", i, 0, (D,), tail_dtype)
        t_pieces.append(jax.device_put(t, dev))
        ti = _tail_piece("tail_ids", i, -1, (), np.int32)
        ti_pieces.append(jax.device_put(ti.astype(np.int32), dev))

    buckets = jax.make_array_from_single_device_arrays(
        (nlist, cap, D), NamedSharding(fmesh, P("d", None, None)), b_pieces
    )
    bucket_ids = jax.make_array_from_single_device_arrays(
        (nlist, cap), NamedSharding(fmesh, P("d", None)), bi_pieces
    )
    tail = jax.make_array_from_single_device_arrays(
        (n_new * Rp, D), NamedSharding(fmesh, P("d", None)), t_pieces
    )
    tail_ids = jax.make_array_from_single_device_arrays(
        (n_new * Rp,), NamedSharding(fmesh, P("d")), ti_pieces
    )
    rep = NamedSharding(fmesh, P())

    def _opt(name):
        path = os.path.join(dir_path, name + ".npy")
        if not os.path.exists(path):
            return None
        # np.array: materialize off the mmap before the device_put
        return jax.device_put(jnp.asarray(np.array(_mmap_load(path))), rep)

    index = IVFIndex(
        centroids=_opt("centroids"),
        buckets=buckets,
        bucket_ids=bucket_ids,
        tail=tail,
        tail_ids=tail_ids,
        nprobe=int(meta["nprobe"]),
        scale=_opt("scale"),
        means=_opt("means"),
        mu=_opt("mu"),
        tail_scale=_opt("tail_scale"),
    )
    return (index, meta) if with_meta else index
