"""Exact inner-product top-k with a fused score kernel (Pallas, Triton route).

The plain path (:func:`haconvdr_tpu.ops.topk.topk_block`) writes every
[Q, chunk] f32 score tile to device memory and sorts windows of it.  Here
one program per (query tile, passage tile) computes the score tile with
the tensor cores, masks rows at or beyond ``n_valid`` and reduces each
``window``-row group to three panels: its max, the max's global row
(lowest row on ties) and its second-largest value.  The score tile never
leaves the chip; the panels are ``window`` times smaller.

Passage tiles are interleaved: of ``n_tiles`` tiles, tile ``j`` holds rows
``j, j + n_tiles, j + 2 n_tiles, ...``, read in place through a strided
block.  Neighbouring rows, which in a real corpus are often alike
(consecutive chunks of one article, duplicated pages), so land in
different windows, and a query's top-k rarely shares one.

Selection stays in XLA and is exact:

1. ``T`` = each query's k-th largest window max.  Window maxes are scores,
   so ``T`` <= the true k-th score ``t``.
2. A window whose second value is ``>= T`` is *flagged*: only such a
   window can hold a top-k member besides its max (that member and the
   max are both ``>= t >= T``).  Flagged windows are scored again in
   full (``budget`` of them per query); unflagged windows contribute
   their max only.
3. The top ``k + TIE_SLACK`` windows by max are taken.  If more windows
   than that reach ``T`` (a wide tie at the boundary), the ones left out
   may hold lower rows than the ones taken.
4. Otherwise the taken windows' maxes plus the rescored rows hold every
   member of the answer, including the lowest-row members of a tie at
   ``t``, and one narrow sort on (score desc, row asc) over that pool
   gives the oracle's answer.

A query with more flagged windows than ``budget`` or with a wide tie at
the boundary is searched again by the plain scan, and only that query
(:func:`haconvdr_tpu.ops.topk.fused_topk_block`): the result stays exact,
and the extra cost grows with the share of such queries.

int8 passages take int8 queries (quantised per query by the caller,
:func:`haconvdr_tpu.ops.topk.quantize_queries`) and accumulate in int32:
every score is an exact integer.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

NEG_INF = float("-inf")
# windows taken beyond the k-th: int8 scores are integers, and several
# windows often share the k-th window max
TIE_SLACK = 8


def _window_top2_kernel(
    nv_ref,  # [1] int32: valid passage rows
    q_ref,  # [BQ, D] query tile
    p_ref,  # [BP, D] passage tile
    v1_ref,  # [BQ, BP // window] window max
    a1_ref,  # [BQ, BP // window] its global row
    v2_ref,  # [BQ, BP // window] window second max
    *,
    bk: int,
    window: int,
):
    j = pl.program_id(1)
    n_tiles = pl.num_programs(1)
    bq, d = q_ref.shape
    bp = p_ref.shape[0]
    acc_dtype = jnp.int32 if q_ref.dtype == jnp.int8 else jnp.float32

    def body(t, acc):
        k0 = pl.multiple_of(t * bk, bk)
        q = q_ref[:, pl.ds(k0, bk)]
        p = p_ref[:, pl.ds(k0, bk)]
        return acc + jax.lax.dot_general(
            q, p, (((1,), (1,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=acc_dtype,
        )

    s = jax.lax.fori_loop(0, d // bk, body, jnp.zeros((bq, bp), acc_dtype))
    # int32 scores of int8 operands are below 2**24 in magnitude for
    # D <= 1040, so this cast is exact
    s = s.astype(jnp.float32)
    # position a of tile j is row a * n_tiles + j (interleaved tiles)
    row = jax.lax.broadcasted_iota(jnp.int32, (bq, bp), 1) * n_tiles + j
    s = jnp.where(row < nv_ref[0], s, NEG_INF)
    g = bp // window
    s3 = s.reshape(bq, g, window)
    v1 = jnp.max(s3, axis=2)
    l1 = jax.lax.argmax(s3, 2, jnp.int32)  # Triton takes only i32 indices
    lane = jax.lax.broadcasted_iota(jnp.int32, (bq, g, window), 2)
    v2 = jnp.max(jnp.where(lane == l1[:, :, None], NEG_INF, s3), axis=2)
    pos = jax.lax.broadcasted_iota(jnp.int32, (bq, g), 1) * window + l1
    v1_ref[...] = v1
    a1_ref[...] = pos * n_tiles + j
    v2_ref[...] = v2


def window_top2(
    queries: jax.Array,  # [Qp, D], Qp % block_q == 0
    passages: jax.Array,  # [Np, D], Np % block_p == 0
    n_valid: jax.Array,  # scalar int32
    *,
    window: int,
    block_q: int,
    block_p: int,
    block_k: int,
    num_warps: int,
    num_stages: int,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """The (max, argmax row, second max) panels, each [Qp, Np // window];
    window ``w`` holds rows ``(w % G * window + t) * n_tiles + w // G``
    for ``t < window``, with ``G = block_p // window`` windows per tile
    (:func:`window_rows`).

    Compiled for the card on the GPU backend; run by the Pallas
    interpreter on any other (the CPU tests)."""
    qp, d = queries.shape
    np_, d2 = passages.shape
    assert d == d2 and d % block_k == 0
    assert qp % block_q == 0 and np_ % block_p == 0 and block_p % window == 0
    n_win = np_ // window
    n_tiles = np_ // block_p
    g = block_p // window
    nv = jnp.reshape(jnp.asarray(n_valid, jnp.int32), (1,))
    # row a * n_tiles + j sits at [a, j]: tile j is a strided block
    tiles = passages.reshape(block_p, n_tiles, d)
    out_spec = pl.BlockSpec((block_q, g), lambda i, j: (i, j))
    return pl.pallas_call(
        functools.partial(_window_top2_kernel, bk=block_k, window=window),
        # query tiles vary fastest: a passage tile is read from device
        # memory once and reused from L2 by every query tile
        grid=(qp // block_q, np_ // block_p),
        in_specs=[
            pl.BlockSpec((1,), lambda i, j: (0,)),
            pl.BlockSpec((block_q, d), lambda i, j: (i, 0)),
            pl.BlockSpec((block_p, None, d), lambda i, j: (0, j, 0)),
        ],
        out_specs=[out_spec] * 3,
        out_shape=[
            jax.ShapeDtypeStruct((qp, n_win), jnp.float32),
            jax.ShapeDtypeStruct((qp, n_win), jnp.int32),
            jax.ShapeDtypeStruct((qp, n_win), jnp.float32),
        ],
        backend="triton",
        compiler_params=pltriton.CompilerParams(
            num_warps=num_warps, num_stages=num_stages
        ),
        interpret=jax.default_backend() != "gpu",
        name="window_top2",
    )(nv, queries, tiles)


def window_rows(w: jax.Array, n_rows: int, window: int, block_p: int) -> jax.Array:
    """The rows of windows ``w`` (any shape), in a new last axis of
    ``window``, in ascending order."""
    g = block_p // window
    n_tiles = n_rows // block_p
    t = jnp.arange(window, dtype=jnp.int32)
    return ((w[..., None] % g) * window + t) * n_tiles + w[..., None] // g


def select_from_windows(
    queries: jax.Array,  # [Qp, D] as scored by the kernel
    passages: jax.Array,  # [Np, D]
    n_valid: jax.Array,
    v1: jax.Array,
    a1: jax.Array,
    v2: jax.Array,
    k: int,
    window: int,
    block_p: int,
    budget: int,
    n_queries: int,
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """(scores [Qp, k], rows [Qp, k], flagged windows [Qp], boundary tie
    [Qp]) from the window panels; see the module docstring.  A query's
    answer is exact when it has at most ``budget`` flagged windows and no
    boundary tie.  Rows at or beyond ``n_queries`` are padding: they count
    no flags and no ties."""
    qp, n_win = v1.shape
    kw = min(k + TIE_SLACK, n_win)
    top_v, top_w = jax.lax.top_k(v1, kw)
    t_bound = top_v[:, k - 1 : k] if n_win >= k else jnp.full(
        (qp, 1), NEG_INF, jnp.float32
    )
    real = jnp.arange(qp)[:, None] < n_queries
    flag = (v2 >= t_bound) & (v2 > NEG_INF) & real
    n_flag = jnp.sum(flag, axis=1, dtype=jnp.int32)
    at_bound = (v1 >= t_bound) & (v1 > NEG_INF)
    tie = (jnp.sum(at_bound, axis=1) > kw) & real[:, 0]
    nb = min(budget, n_win)
    f_v, f_w = jax.lax.top_k(jnp.where(flag, v2, NEG_INF), nb)
    f_ok = f_v > NEG_INF
    rows = window_rows(f_w, passages.shape[0], window, block_p).reshape(qp, nb * window)
    ok = jnp.repeat(f_ok, window, axis=1) & (rows < n_valid)
    cand = passages[jnp.where(ok, rows, 0)]  # fused into the reduction
    if passages.dtype == jnp.int8:
        resc = jnp.sum(
            cand.astype(jnp.int32) * queries.astype(jnp.int32)[:, None, :],
            axis=-1,
        ).astype(jnp.float32)
    else:
        qf = queries.astype(jnp.float32)
        if queries.dtype == jnp.bfloat16:
            # keep the bf16 rounding the kernel scored with: XLA may drop
            # a f32->bf16->f32 convert pair (excess precision allowed),
            # which would rescore with the unrounded query
            qf = jax.lax.reduce_precision(qf, exponent_bits=8, mantissa_bits=7)
        resc = jnp.sum(cand.astype(jnp.float32) * qf[:, None, :], axis=-1)
    resc = jnp.where(ok, resc, NEG_INF)
    top_flagged = jnp.take_along_axis(flag, top_w, axis=1)
    win_s = jnp.where(top_flagged, NEG_INF, top_v)
    win_i = jnp.take_along_axis(a1, top_w, axis=1)
    pool_s = jnp.concatenate([win_s, resc], axis=1)
    pool_i = jnp.concatenate([win_i, jnp.where(ok, rows, -1)], axis=1)
    pool_i = jnp.where(pool_s > NEG_INF, pool_i, jnp.iinfo(jnp.int32).max)
    neg_s, top_i = jax.lax.sort((-pool_s, pool_i), dimension=1, num_keys=2)
    top_s = -neg_s[:, :k]
    top_i = top_i[:, :k]
    if top_s.shape[1] < k:
        pad = k - top_s.shape[1]
        top_s = jnp.pad(top_s, ((0, 0), (0, pad)), constant_values=NEG_INF)
        top_i = jnp.pad(top_i, ((0, 0), (0, pad)))
    top_i = jnp.where(top_s > NEG_INF, top_i, -1)
    return top_s, top_i, n_flag, tie
