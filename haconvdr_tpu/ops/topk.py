"""Exact inner-product top-k search.

Replaces faiss ``IndexFlatIP`` + the host-side block loop of the reference
(src/test_HAConvDR_topiocqa.py:39-162).  The reference's per-block
``index.add`` -> GPU GEMM+topk -> host 2-pointer merge becomes:

  * one jit-compiled search per resident block: either the plain scan over
    passage tiles (:func:`topk_block`: matmul -> [Q, chunk] f32 score tile
    -> window-max select -> running merge) or the fused kernel of
    ops/triton_topk.py, which keeps the score tile on chip
    (:func:`fused_topk_block`); ops/backend.py chooses;
  * block-to-block merging also stays on device (:func:`merge_topk`),
    eliminating the reference's CPU merge loop (":131-149");
  * tie-breaking matches the reference merge: earlier blocks / lower
    indices win ties (``merged_list[p1][0] >= cur_list[p2][0]``, ":137").

Index dtypes: float32 scores at full fp32 precision (ops/backend.py); a
bfloat16 index halves the bytes per row; an int8 index (index/quantize.py)
quarters them and is scored int8 x int8 -> int32 against per-query
quantised queries (:func:`quantize_queries`), so every int8 score is an
exact integer and both paths rank identically.
"""

from __future__ import annotations

import functools
from typing import Iterable, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from haconvdr_tpu.ops import backend

NEG_INF = jnp.float32(-jnp.inf)
# flagged windows per query that the fused path rescores itself; a query
# with more is searched again by the plain scan (fused_topk_block)
FLAG_BUDGET = 8
# queries per plain-scan pass over those the fused path cannot settle
RESCAN_SLOT = 256


def exact_topk_oracle(
    queries: jax.Array, passages: jax.Array, k: int
) -> Tuple[jax.Array, jax.Array]:
    """Reference oracle: full [Q, N] f32 score matrix at HIGHEST + top_k."""
    scores = jnp.dot(
        queries.astype(jnp.float32),
        passages.astype(jnp.float32).T,
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )
    return jax.lax.top_k(scores, k)


def quantize_queries(queries: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Per-query symmetric int8: (codes [Q, D] int8, scale [Q] f32) with
    ``queries ~= codes * scale[:, None] / 127``.  The scale is a positive
    constant per query, so ranking the int32 scores of the codes ranks the
    dequantised scores."""
    qf = queries.astype(jnp.float32)
    scale = jnp.maximum(jnp.max(jnp.abs(qf), axis=1), 1e-30)
    codes = jnp.clip(jnp.round(qf / scale[:, None] * 127.0), -127, 127)
    return codes.astype(jnp.int8), scale


def merge_topk(
    scores_a: jax.Array,
    idx_a: jax.Array,
    scores_b: jax.Array,
    idx_b: jax.Array,
    k: int,
) -> Tuple[jax.Array, jax.Array]:
    """Merge two per-query top lists into a global top-k.

    ``lax.top_k`` is stable (lowest position wins ties), so concatenating A
    before B reproduces the reference 2-pointer merge preference for the
    earlier block on equal scores (src/test_HAConvDR_topiocqa.py:137)."""
    s = jnp.concatenate([scores_a, scores_b], axis=1)
    i = jnp.concatenate([idx_a, idx_b], axis=1)
    top_s, pos = jax.lax.top_k(s, k)
    return top_s, jnp.take_along_axis(i, pos, axis=1)


def _chunk_topk(scores: jax.Array, k: int, window: int) -> Tuple[jax.Array, jax.Array]:
    """Exact top-k over a [Q, C] score tile.

    ``window > 0`` enables the window-max selection: split columns into
    ``window``-wide groups, rank groups by their max, gather the top
    min(k, C/window) whole groups, and take the exact top-k inside them.
    Exactness: any overall top-k element x has <= k-1 elements above it, so
    at most k-1 groups have a larger max than x's group — x's group is
    always selected.  The gathered groups are put back in column order, so
    the stable ``lax.top_k`` keeps the lowest column on ties.  This
    replaces one C-wide ``lax.top_k`` with a max-reduce and two narrow
    ones.
    """
    Q, C = scores.shape
    if window <= 0 or C <= window * k or C % window != 0:
        return jax.lax.top_k(scores, min(k, C))
    G = C // window
    grouped = scores.reshape(Q, G, window)
    gmax = grouped.max(axis=2)  # [Q, G]
    kw = min(k, G)
    _, gidx = jax.lax.top_k(gmax, kw)  # [Q, kw]
    gidx = jnp.sort(gidx, axis=1)
    gathered = jnp.take_along_axis(grouped, gidx[:, :, None], axis=1)  # [Q, kw, window]
    flat = gathered.reshape(Q, kw * window)
    top_s, flat_i = jax.lax.top_k(flat, k)
    col = flat_i % window
    grp = jnp.take_along_axis(gidx, flat_i // window, axis=1)
    return top_s, grp * window + col


def _operands(queries: jax.Array, passages: jax.Array):
    """(queries in the passages' dtype, per-query int8 scale or None)."""
    if passages.dtype == jnp.int8:
        return quantize_queries(queries)
    return queries.astype(passages.dtype), None


def _dequantize(scores: jax.Array, q_scale) -> jax.Array:
    if q_scale is None:
        return scores
    return scores * (q_scale / 127.0)[:, None]


def _scan_topk(q, passages, n_valid, k: int, chunk: int, window: int):
    """Plain scan over [chunk, D] tiles; ``q`` already in the operand dtype."""
    Q = q.shape[0]
    N, D = passages.shape
    assert N % chunk == 0, "pad passages to a multiple of chunk"
    num_chunks = N // chunk
    tiles = passages.reshape(num_chunks, chunk, D)
    acc = jnp.int32 if q.dtype == jnp.int8 else jnp.float32
    precision = backend.matmul_precision(q.dtype)

    init = (
        jnp.full((Q, k), NEG_INF, jnp.float32),
        jnp.full((Q, k), -1, jnp.int32),
    )

    def step(carry, inp):
        tile, c_idx = inp
        best_s, best_i = carry
        scores = jax.lax.dot_general(
            q,
            tile,
            dimension_numbers=(((1,), (1,)), ((), ())),
            precision=precision,
            preferred_element_type=acc,
        ).astype(jnp.float32)  # [Q, chunk]; int32 scores are exact in f32
        base = c_idx * chunk
        col = base + jax.lax.broadcasted_iota(jnp.int32, (Q, chunk), 1)
        scores = jnp.where(col < n_valid, scores, NEG_INF)
        tile_s, tile_i = _chunk_topk(scores, k, window)
        tile_idx = base + tile_i
        if k > tile_s.shape[1]:  # pad tile result up to k columns
            pad = k - tile_s.shape[1]
            tile_s = jnp.pad(tile_s, ((0, 0), (0, pad)), constant_values=-jnp.inf)
            tile_idx = jnp.pad(tile_idx, ((0, 0), (0, pad)), constant_values=-1)
        # running state first => earlier tiles win ties, faiss-style
        return merge_topk(best_s, best_i, tile_s, tile_idx, k), None

    (best_s, best_i), _ = jax.lax.scan(
        step, init, (tiles, jnp.arange(num_chunks, dtype=jnp.int32))
    )
    return best_s, best_i


@functools.partial(jax.jit, static_argnames=("k", "chunk", "window"))
def topk_block(
    queries: jax.Array,  # [Q, D] float32/bfloat16 (int8 index: scale-folded f32)
    passages: jax.Array,  # [N, D]; N padded to a multiple of ``chunk``
    n_valid: jax.Array,  # scalar int32: true passage count (<= N)
    k: int,
    chunk: int,
    window: int = 128,
) -> Tuple[jax.Array, jax.Array]:
    """Streaming top-k over one resident passage block (the plain path).

    Scans ``passages`` in [chunk, D] tiles; each step computes the score
    tile, masks padded rows to -inf, takes an exact on-tile top-k
    (window-max selection, see _chunk_topk) and merges into the running
    [Q, k] state.  Peak live memory beyond inputs is one [Q, chunk] f32
    tile.
    """
    q, q_scale = _operands(queries, passages)
    s, i = _scan_topk(q, passages, n_valid, k, chunk, window)
    return _dequantize(s, q_scale), i


def fused_geometry(n_rows: int, k: int, dim: int, n_queries: int) -> dict:
    """Tile sizes for ops/triton_topk.window_top2, from the shapes.

    A window of 128 rows at full size; smaller blocks keep at least 4k
    windows so the window bound stays tight (tests, small shards).  Every
    size is a power of two, as Triton requires."""
    window = 128
    while window > 16 and n_rows < 4 * k * window:
        window //= 2
    block_q = 16
    while block_q < 128 and block_q < n_queries:
        block_q *= 2
    block_k = next(b for b in (64, 32, 16) if dim % b == 0)
    return dict(
        window=window, block_q=block_q, block_p=2 * window, block_k=block_k,
        num_warps=8, num_stages=3,
    )


def _fused_select(q, passages, n_valid, k: int, budget: int):
    """The fused kernel's panels and selection for ``q`` in the operand
    dtype: (scores [Q, k], rows [Q, k], flagged windows per query [Q],
    boundary tie per query [Q])."""
    from haconvdr_tpu.ops import triton_topk

    Q, D = q.shape
    geo = fused_geometry(passages.shape[0], k, D, Q)
    assert passages.shape[0] % geo["block_p"] == 0, "pad passages"
    q_pad = -Q % geo["block_q"]
    qp = jnp.pad(q, ((0, q_pad), (0, 0))) if q_pad else q
    v1, a1, v2 = triton_topk.window_top2(qp, passages, n_valid, **geo)
    s, i, n_flag, tie = triton_topk.select_from_windows(
        qp, passages, n_valid, v1, a1, v2, k, geo["window"], geo["block_p"], budget, Q
    )
    return s[:Q], i[:Q], n_flag[:Q], tie[:Q]


def _rescan(q, passages, n_valid, s, i, redo, k: int, chunk: int, slot: int):
    """Replace the answers of the ``redo`` queries by the plain scan's,
    ``slot`` queries per pass; no pass runs when no query needs one."""
    Q = q.shape[0]
    slot = min(slot, Q)
    n_redo = jnp.sum(redo, dtype=jnp.int32)
    # the queries to redo first, in query order, padded to whole slots
    order = jnp.argsort(jnp.where(redo, 0, 1), stable=True).astype(jnp.int32)
    order = jnp.pad(order, (0, -Q % slot))

    def one_pass(carry):
        p, s, i = carry
        sel = jax.lax.dynamic_slice(order, (p * slot,), (slot,))
        ps, pi = _scan_topk(q[sel], passages, n_valid, k, chunk, 128)
        # slot entries beyond the last query to redo write nowhere
        dst = jnp.where(p * slot + jnp.arange(slot) < n_redo, sel, Q)
        return p + 1, s.at[dst].set(ps, mode="drop"), i.at[dst].set(pi, mode="drop")

    _, s, i = jax.lax.while_loop(
        lambda c: c[0] * slot < n_redo, one_pass, (jnp.int32(0), s, i)
    )
    return s, i


@functools.partial(jax.jit, static_argnames=("k", "chunk", "budget"))
def fused_topk_block(
    queries: jax.Array,  # [Q, D]
    passages: jax.Array,  # [N, D]; N a multiple of ``chunk``
    n_valid: jax.Array,
    k: int,
    chunk: int,
    budget: int = FLAG_BUDGET,
) -> Tuple[jax.Array, jax.Array]:
    """:func:`topk_block`'s contract through the fused kernel
    (ops/triton_topk.py).  ``budget`` flagged windows per query are
    rescored; each query that needs more, or has a tie at the k-th
    window (ops/triton_topk.py), is searched again by the plain scan,
    RESCAN_SLOT of them per pass, so the extra cost follows the share of
    such queries.  Exact either way."""
    q, q_scale = _operands(queries, passages)
    s, i, n_flag, tie = _fused_select(q, passages, n_valid, k, budget)
    redo = (n_flag > budget) | tie
    s, i = _rescan(q, passages, n_valid, s, i, redo, k, chunk, RESCAN_SLOT)
    return _dequantize(s, q_scale), i


@functools.partial(jax.jit, static_argnames=("k",))
def fused_flags(queries, passages, n_valid, k: int) -> jax.Array:
    """(flagged windows [Q], boundary tie [Q]) per query of the fused
    path: a query with more flags than the budget, or a tie, is searched
    twice (:func:`fused_topk_block`)."""
    q, _ = _operands(queries, passages)
    return _fused_select(q, passages, n_valid, k, 1)[2:]


def search_block(queries, passages, n_valid, k: int, chunk: int):
    """Exact top-k over one resident block by the implementation that
    ops/backend.py chooses for this platform and index dtype."""
    impl = backend.search_impl(passages.dtype, k, passages.shape[1])
    fn = fused_topk_block if impl == "fused" else topk_block
    return fn(queries, passages, jnp.asarray(n_valid, jnp.int32), k, chunk)


def _pad_rows(x: np.ndarray, multiple: int) -> np.ndarray:
    n = x.shape[0]
    target = -(-n // multiple) * multiple
    if target == n:
        return x
    return np.concatenate([x, np.zeros((target - n,) + x.shape[1:], x.dtype)], axis=0)


class BlockSearcher:
    """Searches a stream of passage-embedding blocks, merging on device.

    Equivalent of search_one_by_one_with_faiss
    (src/test_HAConvDR_topiocqa.py:74-162): iterate blocks, top-k per
    block, merge into a running global top-k per query.  Unlike the
    reference the merged list stays at k entries (the reference grows it by
    topN per block but only ever consumes the first topN, ":144-149 vs
    :238-239").
    """

    def __init__(
        self,
        top_k: int = 100,
        passage_chunk: int = 65536,
        query_chunk: int = 1024,
        compute_dtype: str = "float32",
        blocks_per_dispatch: int = 1,
        superblock_rows: int = 0,
        superblock_dtype: str = "",
        superblock_scale=None,
    ):
        self.top_k = top_k
        self.passage_chunk = passage_chunk
        self.query_chunk = query_chunk
        self.compute_dtype = jnp.dtype(compute_dtype)
        # >0: streaming strategy 2 — instead of one search per incoming
        # block (a fixed per-block select/merge cost), copy blocks into a
        # device-resident [superblock_rows, D] accumulator (donated
        # dynamic_update_slice) and run ONE search per FILLED accumulator,
        # so the corpus is searched at resident speed regardless of how
        # it was blocked.  Merging super-block results is exact and costs
        # one lax.top_k.  Pick superblock_rows as large as device memory
        # allows.  int8 blocks are DEQUANTIZED into the accumulator's
        # compute dtype (the 4x memory saving does not apply inside the
        # accumulator; int8-resident serving should use ShardedIndex).
        self.superblock_rows = superblock_rows
        if superblock_rows:
            assert superblock_rows % passage_chunk == 0, (
                "superblock_rows must be a multiple of passage_chunk"
            )
        # superblock_dtype="int8": the accumulator itself stays int8 —
        # 4x the rows per fill vs f32, searched as an int8 index.
        # Incoming blocks are REQUANTIZED to one corpus-level per-dim
        # scale (``superblock_scale``, [D] float32 — use
        # EmbeddingBlockStore.global_scale(): the elementwise max of the
        # per-block scales, so requantization never clips); float blocks
        # quantize directly.  Adds <= 0.5 int8-ulp requant rounding on
        # top of the int8 serving model's own error.
        assert superblock_dtype in ("", "int8"), superblock_dtype
        self.superblock_dtype = superblock_dtype
        if superblock_dtype == "int8":
            assert superblock_rows, "superblock_dtype needs superblock_rows"
            self._sb_dt = jnp.dtype(jnp.int8)
            self.superblock_scale = (
                None
                if superblock_scale is None
                else np.asarray(superblock_scale, np.float32)
            )
        else:
            self._sb_dt = jnp.dtype(compute_dtype)
            self.superblock_scale = None
        self._sb_buf = None  # cached (buf, idbuf) accumulator pair
        # >1: several equal-shape staged blocks inside ONE jitted dispatch
        # (many small blocks that fit device memory together); full-size
        # 2.5M-row blocks keep K=1.
        self.blocks_per_dispatch = max(1, blocks_per_dispatch)
        # remember the exact construction args so with_top_k can clone
        self._init_kw = dict(
            passage_chunk=passage_chunk, query_chunk=query_chunk,
            compute_dtype=compute_dtype,
            blocks_per_dispatch=blocks_per_dispatch,
            superblock_rows=superblock_rows, superblock_dtype=superblock_dtype,
            superblock_scale=superblock_scale,
        )

        def _one_block(best_s, best_ids, queries, passages, ids_arr, n_valid):
            """One block's whole step — per-query-chunk top-k,
            local->global id map (":110") and running merge."""
            Q = best_s.shape[0]
            s_parts, i_parts = [], []
            for qs in range(0, Q, self.query_chunk):
                qe = min(Q, qs + self.query_chunk)
                s, i = search_block(
                    queries[qs:qe], passages, n_valid, top_k,
                    self.passage_chunk,
                )
                s_parts.append(s)
                i_parts.append(i)
            block_s = jnp.concatenate(s_parts, axis=0)
            block_i = jnp.concatenate(i_parts, axis=0)
            # id -1 entries are unfilled slots: their scores are dropped
            block_ids = ids_arr[jnp.clip(block_i, 0, n_valid - 1)]
            block_ids = jnp.where(block_i >= 0, block_ids, -1)
            block_s = jnp.where(block_i >= 0, block_s, NEG_INF)
            new_s, pos = jax.lax.top_k(
                jnp.concatenate([best_s, block_s], axis=1), top_k
            )
            new_ids = jnp.take_along_axis(
                jnp.concatenate([best_ids, block_ids], axis=1), pos, axis=1
            )
            return new_s, new_ids

        _search_block = jax.jit(_one_block)

        @functools.partial(jax.jit, static_argnames=("with_scales", "n"))
        def _search_blocks(best_s, best_ids, queries, *flat, with_scales=False, n=1):
            """K blocks in one dispatch (unrolled).  Blocks are passed as
            SEPARATE arrays, not stacked: jnp.stack would copy the whole
            staged set (an extra corpus-sized device allocation)."""
            per = 4 if with_scales else 3
            for b in range(n):
                item = flat[b * per : (b + 1) * per]
                if with_scales:
                    emb, ids, nv, sc = item
                    q_eff = queries.astype(jnp.float32) * sc
                else:
                    emb, ids, nv = item
                    q_eff = queries
                best_s, best_ids = _one_block(
                    best_s, best_ids, q_eff, emb, ids, nv
                )
            return best_s, best_ids

        @functools.partial(jax.jit, donate_argnums=(0, 1))
        def _sb_insert(buf, idbuf, emb, ids, offset):
            """Copy one (chunk of a) block into the super-block
            accumulator in place (donated buffers -> true XLA aliasing,
            no reallocation); int8 chunks arrive pre-dequantized."""
            buf = jax.lax.dynamic_update_slice(
                buf, emb.astype(buf.dtype),
                (offset, jnp.asarray(0, offset.dtype)),
            )
            idbuf = jax.lax.dynamic_update_slice(idbuf, ids, (offset,))
            return buf, idbuf

        @functools.partial(jax.jit, donate_argnums=(0, 1))
        def _sb_insert_q(buf, idbuf, emb, ids, offset, factor):
            """int8-accumulator insert: requantize the incoming chunk to
            the corpus-level scale in the same fused dispatch.  ``factor``
            [D] f32 = block_scale/target_scale for int8 code chunks, or
            1/target_scale for float chunks; with target = elementwise
            max of block scales the clip never truncates real values."""
            codes = jnp.clip(
                jnp.round(emb.astype(jnp.float32) * factor), -127, 127
            ).astype(jnp.int8)
            buf = jax.lax.dynamic_update_slice(
                buf, codes, (offset, jnp.asarray(0, offset.dtype))
            )
            idbuf = jax.lax.dynamic_update_slice(idbuf, ids, (offset,))
            return buf, idbuf

        self._search_block = _search_block
        self._search_blocks = _search_blocks
        self._sb_insert = _sb_insert
        self._sb_insert_q = _sb_insert_q
        self._init_best = {}  # (Q,) -> cached (-inf scores, -1 ids) pair

    def with_top_k(self, top_k: int) -> "BlockSearcher":
        """A clone with a different k (k is baked into the jitted merge
        shapes at construction).  Used by the two-stage rescore path to
        oversample the first stage (serve.Retriever)."""
        if top_k == self.top_k:
            return self
        return BlockSearcher(top_k=top_k, **self._init_kw)

    def search(
        self,
        query_embs: np.ndarray,  # [Q, D]
        blocks: Iterable[Tuple[np.ndarray, ...]],  # (emb [Nb,D], ids [Nb][, scale [D]])
        return_device: bool = False,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (scores [Q, k], passage_ids [Q, k]) over all blocks.

        ``ids`` are the per-block embedding->offset arrays (the reference's
        passage_embid_block_*, gen_doc_embeddings.py:133-135); output ids
        are already mapped through them.  Blocks may carry a third element:
        the per-dim dequant scale of an int8 block (index/quantize.py),
        folded into the queries for that block before they are quantised
        per query (int8 x int8 scoring, see quantize_queries) — half bf16's
        host-to-device traffic.
        Device-resident inputs (jax arrays) take a zero-host-copy path;
        ``return_device`` skips the final device->host pull for callers
        that keep consuming on device.
        """
        k = self.top_k
        Q = query_embs.shape[0]
        if Q not in self._init_best:
            # cached per query-count: repeated searches skip two eager
            # device allocations per call.  int32 offsets: corpora up to 2^31 rows (reference max 54.6M)
            self._init_best[Q] = (
                jnp.full((Q, k), NEG_INF, jnp.float32),
                jnp.full((Q, k), -1, jnp.int32),
            )
        best_s, best_ids = self._init_best[Q]

        if isinstance(query_embs, jax.Array):
            queries = query_embs.astype(self.compute_dtype)
        else:
            queries = jnp.asarray(np.asarray(query_embs), self.compute_dtype)
        row_multiple = self.passage_chunk

        def to_device(item):
            emb, ids = item[0], item[1]
            scale = item[2] if len(item) > 2 else None
            if emb.dtype == np.int8 and scale is None:
                # scoring raw quantized codes unscaled is silently wrong;
                # int8 blocks must arrive as (emb, ids, scale) triples
                # (store.iter_blocks(with_scales=True))
                raise ValueError(
                    "int8 block without a dequant scale: pass (emb, ids, "
                    "scale) — see index/quantize.py"
                )
            n_valid = emb.shape[0]
            # int8 blocks keep their dtype (compute_dtype would destroy
            # the quantized values)
            blk_dtype = jnp.int8 if emb.dtype == np.int8 else self.compute_dtype
            if isinstance(emb, jax.Array) and n_valid % row_multiple == 0:
                # device-resident block (e.g. freshly encoded): no host
                # round-trip
                emb_dev = emb.astype(blk_dtype)
            else:
                emb_dev = jnp.asarray(
                    _pad_rows(np.asarray(emb), row_multiple), blk_dtype
                )
            if isinstance(ids, jax.Array):
                if ids.dtype != jnp.int32:
                    # a silent astype would wrap >=2^31 ids into the -1
                    # empty-slot sentinel range; the host branch below
                    # checks the bound, device arrays can't without a sync
                    raise ValueError(
                        "device-resident block ids must be int32 "
                        f"(got {ids.dtype}); cast on host where the 2^31 "
                        "bound is checked"
                    )
                ids_dev = ids
            else:
                ids = np.asarray(ids)
                assert ids.size == 0 or int(ids.max()) < 2**31, "ids exceed int32"
                ids_dev = jnp.asarray(ids.astype(np.int32))
            scale_dev = None if scale is None else jnp.asarray(scale, jnp.float32)
            # async dispatch: the next block's H2D overlaps the current search
            return (emb_dev, ids_dev, n_valid, scale_dev)

        group: list = []

        def flush_group():
            nonlocal best_s, best_ids
            if not group:
                return
            if len(group) == 1:
                passages, ids_arr, n_valid, scale_dev = group[0]
                if scale_dev is None:
                    q_eff = queries
                else:  # fold the int8 block's dequant scale into the queries
                    q_eff = queries.astype(jnp.float32) * scale_dev
                best_s, best_ids = self._search_block(
                    best_s, best_ids, q_eff, passages, ids_arr,
                    jnp.int32(n_valid),
                )
            else:  # fused dispatch over K equal-shape blocks
                with_scales = group[0][3] is not None
                flat = []
                for emb, ids, nv, sc in group:
                    flat.extend([emb, ids, jnp.int32(nv)])
                    if with_scales:
                        flat.append(sc)
                best_s, best_ids = self._search_blocks(
                    best_s, best_ids, queries, *flat,
                    with_scales=with_scales, n=len(group),
                )
            group.clear()

        if self.superblock_rows:
            best_s, best_ids = self._stream_superblocks(
                queries, blocks, best_s, best_ids
            )
        else:
            it = iter(blocks)
            nxt = next(it, None)
            staged = to_device(nxt) if nxt is not None else None
            while staged is not None:
                item = staged
                nxt = next(it, None)
                staged = to_device(nxt) if nxt is not None else None
                if group and (
                    item[0].shape != group[0][0].shape
                    or (item[3] is None) != (group[0][3] is None)
                ):
                    flush_group()  # ragged tail / mixed quantization: own group
                group.append(item)
                if len(group) >= self.blocks_per_dispatch:
                    flush_group()
            flush_group()

        if return_device:
            return best_s, best_ids
        return np.asarray(best_s), np.asarray(best_ids)

    def _stream_superblocks(self, queries, blocks, best_s, best_ids):
        """Streaming strategy 2 (``superblock_rows``): accumulate incoming
        blocks into one device-resident buffer and search each FILLED
        buffer once at full resident speed.  Replaces the reference's per-block faiss loop
        (src/test_HAConvDR_topiocqa.py:77-149) with resident-speed search
        plus device copies; exact regardless of block boundaries.
        ``queries`` arrive already cast by search()."""
        C = self.superblock_rows
        buf = idbuf = None
        fill = 0
        int8_acc = self.superblock_dtype == "int8"
        if int8_acc:
            if self.superblock_scale is None:
                raise ValueError(
                    "superblock_dtype='int8' needs superblock_scale "
                    "([D] per-dim corpus scale — "
                    "EmbeddingBlockStore.global_scale())"
                )
            tscale = jnp.asarray(self.superblock_scale, jnp.float32)
            q_sb = queries.astype(jnp.float32) * tscale  # fold once

        def flush(best_s, best_ids, n_valid):
            # the running best merges exactly inside _one_block
            return self._search_block(
                best_s, best_ids, q_sb if int8_acc else queries, buf, idbuf,
                jnp.int32(n_valid),
            )

        for item in blocks:
            emb, ids = item[0], item[1]
            scale = item[2] if len(item) > 2 else None
            is_int8 = (
                emb.dtype == jnp.int8
                if isinstance(emb, jax.Array)
                else emb.dtype == np.int8
            )
            if is_int8 and scale is None:
                raise ValueError(
                    "int8 block without a dequant scale: pass (emb, ids, "
                    "scale) — see index/quantize.py"
                )
            if not isinstance(emb, jax.Array):
                emb = jnp.asarray(emb)
            factor = None
            if int8_acc:  # requantize to the corpus scale inside insert
                factor = (
                    jnp.asarray(scale, jnp.float32) / tscale
                    if is_int8
                    else 1.0 / tscale
                )
            elif is_int8:  # dequantize into the accumulator's dtype
                emb = emb.astype(jnp.float32) * jnp.asarray(scale, jnp.float32)
            if isinstance(ids, jax.Array):
                if ids.dtype != jnp.int32:
                    raise ValueError(
                        "device-resident block ids must be int32 "
                        f"(got {ids.dtype}); cast on host where the 2^31 "
                        "bound is checked"
                    )
            else:
                ids = np.asarray(ids)
                assert ids.size == 0 or int(ids.max()) < 2**31, "ids exceed int32"
                ids = jnp.asarray(ids.astype(np.int32))
            if buf is None:
                D = emb.shape[1]
                cached = self._sb_buf
                if cached is not None and cached[0].shape == (C, D) and (
                    cached[0].dtype == self._sb_dt
                ):
                    buf, idbuf = cached  # rows beyond fill are masked by
                    # n_valid at search time, so stale content is harmless
                else:
                    buf = jnp.zeros((C, D), self._sb_dt)
                    idbuf = jnp.full((C,), -1, jnp.int32)
                self._sb_buf = None  # consumed (inserts donate it)
            off = 0
            n = emb.shape[0]
            while off < n:
                take = min(C - fill, n - off)
                if off == 0 and take == n:  # whole block: skip the slice
                    e_c, i_c = emb, ids  # (one less eager dispatch)
                else:
                    e_c = emb[off : off + take]
                    i_c = ids[off : off + take]
                if int8_acc:
                    buf, idbuf = self._sb_insert_q(
                        buf, idbuf, e_c, i_c, jnp.int32(fill), factor
                    )
                else:
                    buf, idbuf = self._sb_insert(
                        buf, idbuf, e_c, i_c, jnp.int32(fill),
                    )
                fill += take
                off += take
                if fill == C:
                    best_s, best_ids = flush(best_s, best_ids, C)
                    fill = 0
        if fill > 0:
            best_s, best_ids = flush(best_s, best_ids, fill)
        if buf is not None:
            self._sb_buf = (buf, idbuf)  # reuse across search() calls
        return best_s, best_ids
