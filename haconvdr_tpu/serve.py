"""End-user serving API: conversational query -> top-k passages.

The reference exposes retrieval only through batch evaluation scripts; this
wraps the same machinery as a reusable object for interactive / production
use: load a trained ANCE checkpoint + an embedding store once, then answer
(conversation state -> ranked pids) queries with the exact device search.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from haconvdr_tpu.config import DataConfig, SearchConfig
from haconvdr_tpu.data.loader import batch_iter
from haconvdr_tpu.data.sequence import ConcatBuilder, encode_no_trunc
from haconvdr_tpu.index.store import EmbeddingBlockStore
from haconvdr_tpu.ops.topk import BlockSearcher
from haconvdr_tpu.parallel.mesh import make_mesh
from haconvdr_tpu.parallel.sharded_encode import (
    encode_batches,
    make_sharded_encode_fn,
    shard_params,
)
from haconvdr_tpu.parallel.sharded_search import ShardedIndex

logger = logging.getLogger(__name__)


class Retriever:
    """query encoder + index, resident on the mesh.

    ``resident=True`` loads the whole store into device memory as a
    ShardedIndex (fastest exact path; needs the corpus to fit — bf16
    halves it, store_dtype="int8" quarters it); ``resident=False``
    streams blocks per search (BlockSearcher).  ``ivf=True`` REPLACES the
    exact index with the cluster-pruned serving structure, built
    MESH-SHARDED straight from the store at load time
    (parallel/sharded_ivf.py:build_ivf_from_store — cluster-axis bucket
    layout, no single-host corpus buffer, capacity scales with the
    mesh's device memory): a single query reads only the probed clusters,
    at an nprobe-controlled recall (beyond the reference, which only has
    the exact scan).
    ``store_dtype`` applies to the IVF buckets too ("int8" builds
    quantized buckets).  ``ivf_dir`` persists the built index as
    per-shard artifacts (parallel/sharded_ivf.save_ivf_sharded) and
    reloads them on the next construction — restart without repaying the
    multi-pass corpus build, even onto a different pod shape.  Build a
    second Retriever without ``ivf`` when exact batch evaluation is also
    needed.

    **IVF is the LATENCY tier, not the throughput tier**: its per-query
    probed-bucket gathers do not coalesce across a batch (lax.map one
    query at a time), while the flat scan's matmul amortizes one read of
    the corpus over the whole batch.  Composing ``ivf=True`` with
    ``BatchingRetriever`` at ``max_batch`` > 16 therefore trades
    throughput for no latency benefit — BatchingRetriever warns on that
    composition.  (Where the two cross on the card is not measured.)
    """

    def __init__(
        self,
        tokenizer,
        params,
        model_cfg,
        store: EmbeddingBlockStore,
        offset2pid: Optional[Sequence[int]] = None,
        data_cfg: Optional[DataConfig] = None,
        search_cfg: Optional[SearchConfig] = None,
        resident: bool = True,
        store_dtype: str = "float32",
        ivf: bool = False,
        ivf_nlist: int = 1024,
        ivf_nprobe: Optional[int] = None,
        ivf_dir: Optional[str] = None,
        encoder_int8: bool = False,
    ):
        self.tokenizer = tokenizer
        self.model_cfg = model_cfg
        self.data_cfg = data_cfg or DataConfig(is_train=False, use_PRL=False)
        self.search_cfg = search_cfg or SearchConfig()
        self.mesh = make_mesh()
        if encoder_int8:
            # int8 x int8 query-tower weights (the serving-side analog
            # of IndexConfig.compute_int8): an approximation of the
            # float tower, for batched serving
            from haconvdr_tpu.models.encoder import quantize_encoder_params

            params = quantize_encoder_params(params)
        self.params = shard_params(self.mesh, params)
        self._encode = make_sharded_encode_fn(self.mesh, self.model_cfg)
        self.offset2pid = offset2pid

        # two-stage rescore (SearchConfig.rescore_oversample > 1): the
        # FLOAT disk store stays available as the exact second stage even
        # when the resident copy is int8 (index/rescore.py)
        self._rescore_store = store
        self._rescorer = None

        self.ivf_index = None
        if ivf:  # cluster-pruned serving: replaces the flat index
            import os

            from haconvdr_tpu.parallel.sharded_ivf import (
                build_ivf_from_store,
                load_ivf_sharded,
                save_ivf_sharded,
            )

            if ivf_dir and os.path.exists(
                os.path.join(ivf_dir, "ivf_sharded_meta.json")
            ):
                # restart path: reload the persisted per-shard slabs
                # instead of repaying the multi-pass corpus build —
                # works across a CHANGED pod shape (the target shard
                # count must divide nlist; sharded_ivf.load_ivf_sharded).
                # The persisted nprobe (which captured the build's
                # probe-everything rounding) is the default, so a restart
                # with the same arguments serves the same results; an
                # explicit ivf_nprobe overrides it.  Cheap staleness
                # guards: the bucket dtype must match store_dtype, and
                # the store's row count (block-header metadata only — the
                # embedding payloads are NOT read) must match the count
                # recorded at build time.
                idx, meta = load_ivf_sharded(self.mesh, ivf_dir, with_meta=True)
                saved_dtype = meta.get("bucket_dtype")
                if saved_dtype is not None and saved_dtype != store_dtype:
                    raise ValueError(
                        f"ivf_dir {ivf_dir!r} holds {saved_dtype} buckets "
                        f"but store_dtype={store_dtype!r} was requested; "
                        "rebuild (remove the dir) or match store_dtype"
                    )
                saved_rows = meta.get("corpus_rows")
                rows = None
                if saved_rows is not None and hasattr(store, "num_blocks"):
                    rows = sum(
                        store.block_size(b) for b in range(store.num_blocks())
                    )
                    if rows != saved_rows:
                        raise ValueError(
                            f"ivf_dir {ivf_dir!r} was built from "
                            f"{saved_rows} corpus rows but the store now "
                            f"has {rows}; the persisted index is stale — "
                            "remove the dir to rebuild"
                        )
                nlist = idx.centroids.shape[0]
                if ivf_nprobe is not None:
                    # the build path's probe-everything rule, re-applied
                    # with the same inputs so identical constructor args
                    # serve identical results across a restart
                    n_rows = rows if rows is not None else saved_rows
                    if n_rows is not None:
                        req_nlist = min(ivf_nlist, max(1, n_rows // 8))
                        nprobe = nlist if ivf_nprobe >= req_nlist else ivf_nprobe
                    else:
                        nprobe = min(ivf_nprobe, nlist)
                    idx = idx._replace(nprobe=int(nprobe))
                self.ivf_index = idx
                self.index = None
                self.store = None
                return

            # mesh-sharded build straight from the store: rows stream from
            # disk to their owning shard's device — no single-host corpus
            # buffer, so capacity is the mesh's device memory, not one
            # card's (memory math in parallel/sharded_ivf.py).  store_dtype carries
            # through: "int8" builds quantized buckets (a global per-dim
            # scale folded into queries at search), not silently-f32 ones.
            n_blocks = store.num_blocks()
            n_valid = sum(store.block_size(b) for b in range(n_blocks))
            n_shards = int(np.prod(self.mesh.devices.shape))
            req_nlist = min(ivf_nlist, max(1, n_valid // 8))
            nlist = max(n_shards, (req_nlist // n_shards) * n_shards)
            # "probe everything" requests survive the shard-divisibility
            # rounding of nlist; None = the class default of 32
            want_nprobe = 32 if ivf_nprobe is None else ivf_nprobe
            nprobe = nlist if want_nprobe >= req_nlist else want_nprobe
            self.ivf_index = build_ivf_from_store(
                self.mesh,
                store,
                nlist=nlist,
                nprobe=nprobe,
                dtype=store_dtype,
            )
            if ivf_dir:  # persist so the next load skips the build
                save_ivf_sharded(self.ivf_index, ivf_dir)
            self.index = None
            self.store = None
            return
        if resident:
            self.index: object = ShardedIndex.from_store(
                self.mesh, store, dtype=store_dtype
            )
            self.store = None
        else:
            self.index = None
            self.store = store
            sb_scale = (
                store.global_scale()
                if self.search_cfg.superblock_dtype == "int8"
                and self.search_cfg.superblock_rows
                else None
            )
            self.searcher = BlockSearcher(
                top_k=self.search_cfg.top_k,
                passage_chunk=self.search_cfg.passage_chunk,
                superblock_rows=self.search_cfg.superblock_rows,
                superblock_dtype=self.search_cfg.superblock_dtype,
                superblock_scale=sb_scale,
            )

    @classmethod
    def load(
        cls,
        checkpoint_path: str,
        embeddings_dir: str,
        model_type: str = "ANCE",
        **kw,
    ) -> "Retriever":
        from haconvdr_tpu.models.hf_import import load_model

        tokenizer, encoder = load_model(model_type + "_Query", checkpoint_path)
        store = EmbeddingBlockStore.open_auto(embeddings_dir)
        return cls(tokenizer, encoder.params, encoder.cfg, store, **kw)

    # -- query construction -------------------------------------------------
    def build_query(
        self,
        question: str,
        history: Optional[Sequence[Tuple[str, str]]] = None,
        history_passages: Optional[Sequence[str]] = None,
    ) -> Dict:
        """Conversational convqp-style input: current question, prior
        (question, answer) turns, optional prior gold/selected passages —
        the serving analog of the convqp eval concat (src/data.py:97-127)."""
        d = self.data_cfg
        builder = ConcatBuilder(d.max_concat_length)
        builder.ids.extend(
            encode_no_trunc(self.tokenizer, question, d.max_query_length)
        )
        history = list(history or [])
        history_passages = list(history_passages or [])
        for t in range(len(history) - 1, -1, -1):
            if t < len(history_passages) and history_passages[t]:
                if not builder.add(
                    encode_no_trunc(self.tokenizer, history_passages[t], d.max_doc_length)
                ):
                    break
            hq, ha = history[t]
            if ha and not builder.add(
                encode_no_trunc(self.tokenizer, ha, d.max_response_length)
            ):
                break
            if not builder.add(
                encode_no_trunc(self.tokenizer, hq, d.max_query_length)
            ):
                break
        ids, mask = builder.padded()
        return {"sample_id": "q", "conv_qp": ids, "conv_qp_mask": mask}

    # -- retrieval -----------------------------------------------------------
    def embed(self, examples: List[Dict]) -> np.ndarray:
        n_dev = int(np.prod(self.mesh.devices.shape))
        bs = max(n_dev, self.search_cfg.per_device_test_batch_size * n_dev)
        embs, _ = encode_batches(
            self._encode, self.params,
            batch_iter(examples, min(bs, max(len(examples), n_dev))),
            self.mesh, "conv_qp", "conv_qp_mask",
        )
        return embs

    def search(
        self, query_embs: np.ndarray, k: Optional[int] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        k = k or self.search_cfg.top_k
        oversample = self.search_cfg.rescore_oversample
        k1 = int(np.ceil(k * oversample)) if oversample > 1.0 else k
        if self.ivf_index is not None:
            from haconvdr_tpu.parallel.sharded_ivf import sharded_ivf_search

            scores, ids = sharded_ivf_search(
                self.mesh, self.ivf_index, query_embs, k=k1
            )
        elif self.index is not None:
            scores, ids = self.index.search(query_embs, k1)
        else:
            if k1 != self.searcher.top_k:
                # the streaming searcher's k is baked at construction;
                # rebuild once for the oversampled first stage
                self.searcher = self.searcher.with_top_k(k1)
            scores, ids = self.searcher.search(
                query_embs,
                self.store.iter_blocks(
                    self.search_cfg.passage_block_num, with_scales=True
                ),
            )
        if k1 != k:  # exact second stage from the float disk store
            if self._rescorer is None:
                from haconvdr_tpu.index.rescore import StoreRescorer

                self._rescorer = StoreRescorer(self._rescore_store)
            scores, ids = self._rescorer.rescore(query_embs, ids, k)
        if self.offset2pid is not None:
            safe = np.clip(ids, 0, len(self.offset2pid) - 1)
            ids = np.where(
                ids >= 0, np.asarray(self.offset2pid)[safe], -1
            )
        return scores, ids

    def retrieve(
        self,
        question: str,
        history: Optional[Sequence[Tuple[str, str]]] = None,
        history_passages: Optional[Sequence[str]] = None,
        k: Optional[int] = None,
    ) -> List[Tuple[int, float]]:
        """One conversational query -> [(pid, score)] ranked."""
        ex = self.build_query(question, history, history_passages)
        embs = self.embed([ex])
        scores, ids = self.search(embs, k)
        return [(int(p), float(s)) for p, s in zip(ids[0], scores[0]) if p >= 0]


class _Request:
    __slots__ = ("example", "k", "future")

    def __init__(self, example: Dict, k: int, future: Future):
        self.example = example
        self.k = k
        self.future = future


_SHUTDOWN = object()


class BacklogFull(RuntimeError):
    """submit() backpressure: the batcher's bounded queue is at
    ``queue_depth`` (the dispatch worker is not keeping up — e.g. a
    stalled device).  Callers should shed load (HTTP: 503 + Retry-After)
    rather than queue unboundedly."""


class BatchingRetriever:
    """Micro-batching serving frontend over a :class:`Retriever`.

    Motivation: a single query pays a whole query-tower forward and a
    whole read of the index; coalescing concurrent queries into one device
    dispatch shares both across the batch, so throughput grows with the
    batch at nearly constant per-query latency; this class is that
    coalescer.  (The reference has no serving layer at
    all — retrieval exists only as offline batch-eval scripts,
    /root/reference/src/test_HAConvDR_topiocqa.py — so this is
    beyond-reference surface, like Retriever itself.)

    Design:

    * ONE worker thread owns all device dispatch (two concurrent dispatch
      streams contend for the card and spoil each other's timing), so
      callers may submit from any number of threads.
    * Static shapes: a coalesced batch of n requests runs at the smallest
      power-of-two bucket >= n (capped at ``max_batch``), so XLA compiles
      once per bucket instead of once per arrival count.  Encoder padding
      rides the existing ``collate(pad_to=bucket)`` valid-mask machinery;
      the search stage pads the query matrix with copies of row 0 and
      slices per-request results.
    * Tokenization/concat (``build_query``) runs in the CALLER's thread at
      :meth:`submit` — host work stays parallel, the worker only touches
      the device.
    * ``k`` is per-request but bounded by the retriever's configured
      ``search_cfg.top_k`` (one compiled k; requests slice their prefix).

    ``max_wait_ms`` bounds added latency: the worker dispatches as soon as
    ``max_batch`` requests are queued or the oldest waiting request has
    aged past the window, whichever comes first.  A lone request therefore
    pays at most ``max_wait_ms`` over the single-query path.
    """

    def __init__(
        self,
        retriever: Retriever,
        max_batch: int = 64,
        max_wait_ms: float = 2.0,
        queue_depth: int = 1024,
    ):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if retriever.ivf_index is not None and max_batch > 16:
            # IVF's per-query bucket gathers do not share work across a
            # batch — see the Retriever docstring ("latency tier")
            logger.warning(
                "BatchingRetriever(max_batch=%d) over an IVF retriever: "
                "IVF search does not coalesce across a batch; the exact "
                "flat index shares one scan over the batch.  Use "
                "ivf=False for the throughput tier.",
                max_batch,
            )
        self.retriever = retriever
        self.max_batch = int(max_batch)
        self.max_wait_ms = float(max_wait_ms)
        self._q: "queue.Queue" = queue.Queue(maxsize=queue_depth)
        self._closed = threading.Event()
        # serializes the closed-check-then-enqueue in submit() against
        # close() setting the flag, so the shutdown sentinel is provably
        # the LAST item ever enqueued (no request can slip in behind it
        # and hang its caller)
        self._submit_gate = threading.Lock()
        self._lock = threading.Lock()
        self._n_queries = 0
        self._n_dispatches = 0
        self._batch_hist: Dict[int, int] = {}
        self._worker = threading.Thread(
            target=self._run, name="haconvdr-serve-batcher", daemon=True
        )
        self._worker.start()

    # -- client API ----------------------------------------------------------
    def submit(
        self,
        question: str,
        history: Optional[Sequence[Tuple[str, str]]] = None,
        history_passages: Optional[Sequence[str]] = None,
        k: Optional[int] = None,
    ) -> Future:
        """Enqueue one conversational query; resolves to [(pid, score)]."""
        k = k or self.retriever.search_cfg.top_k
        if k > self.retriever.search_cfg.top_k:
            raise ValueError(
                f"k={k} exceeds the retriever's compiled top_k="
                f"{self.retriever.search_cfg.top_k}; raise SearchConfig.top_k"
            )
        ex = self.retriever.build_query(question, history, history_passages)
        fut: Future = Future()
        with self._submit_gate:
            if self._closed.is_set():
                raise RuntimeError("BatchingRetriever is closed")
            try:
                # non-blocking: a full queue must reject, not block the
                # caller's thread behind a stalled dispatch (and a
                # blocking put under the gate would also stall close())
                self._q.put_nowait(_Request(ex, int(k), fut))
            except queue.Full:
                raise BacklogFull(
                    f"batcher backlog at queue_depth={self._q.maxsize}; "
                    "retry later or raise queue_depth"
                ) from None
        with self._lock:
            self._n_queries += 1
        return fut

    def retrieve(self, *args, **kw) -> List[Tuple[int, float]]:
        """Blocking convenience wrapper over :meth:`submit`."""
        return self.submit(*args, **kw).result()

    def stats(self) -> Dict:
        """{"queries", "dispatches", "batch_histogram", "backlog",
        "queue_depth"} so far."""
        with self._lock:
            return {
                "queries": self._n_queries,
                "dispatches": self._n_dispatches,
                "batch_histogram": dict(self._batch_hist),
                "backlog": self._q.qsize(),
                "queue_depth": self._q.maxsize,
            }

    def close(self) -> None:
        """Drain in-flight work, then stop the worker.  Idempotent."""
        with self._submit_gate:
            if self._closed.is_set():
                return
            self._closed.set()
        # the gate guarantees no request is enqueued after this sentinel,
        # so the worker drains every accepted request before exiting
        self._q.put(_SHUTDOWN)
        self._worker.join()
        # belt-and-braces: nothing should remain, but never hang a caller
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not _SHUTDOWN:
                item.future.set_exception(
                    RuntimeError("BatchingRetriever closed before dispatch")
                )

    def __enter__(self) -> "BatchingRetriever":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- worker --------------------------------------------------------------
    def _run(self) -> None:
        while True:
            try:
                first = self._q.get(timeout=0.05)
            except queue.Empty:
                if self._closed.is_set():
                    # close() was observed between the timeout and this
                    # check; a request accepted just before the flag flipped
                    # may still sit in the queue ahead of the sentinel —
                    # drain and DISPATCH it (close() promises to drain
                    # in-flight work, not error it)
                    tail: List[_Request] = []
                    while True:
                        try:
                            item = self._q.get_nowait()
                        except queue.Empty:
                            break
                        if item is _SHUTDOWN:
                            break
                        tail.append(item)
                    while tail:
                        self._dispatch(tail[: self.max_batch])
                        tail = tail[self.max_batch :]
                    return
                continue
            if first is _SHUTDOWN:
                return
            batch = [first]
            deadline = time.monotonic() + self.max_wait_ms / 1e3
            stop = False
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is _SHUTDOWN:
                    stop = True
                    break
                batch.append(nxt)
            self._dispatch(batch)
            if stop:
                return

    def _dispatch(self, batch: List[_Request]) -> None:
        n = len(batch)
        bucket = 1
        while bucket < n:
            bucket *= 2
        # honor the documented cap: with a non-power-of-two max_batch the
        # pow2 round-up of a full batch would overshoot it (n <= max_batch
        # always, so the cap never truncates below n)
        bucket = min(bucket, self.max_batch)
        with self._lock:
            self._n_dispatches += 1
            self._batch_hist[n] = self._batch_hist.get(n, 0) + 1
        try:
            r = self.retriever
            # fixed-bucket encode: collate(pad_to=bucket) carries a valid
            # mask, encode_batches drops the pad rows -> embs is [n, D]
            embs, _ = encode_batches(
                r._encode, r.params,
                batch_iter([req.example for req in batch], bucket),
                r.mesh, "conv_qp", "conv_qp_mask",
            )
            if n < bucket:  # static search shape: pad queries to the bucket
                pad = np.broadcast_to(embs[:1], (bucket - n, embs.shape[1]))
                embs = np.concatenate([embs, pad], axis=0)
            scores, ids = r.search(embs)
            for i, req in enumerate(batch):
                # slice to req.k BEFORE the validity filter so per-request
                # k returns exactly what the sequential Retriever.retrieve
                # path would (no backfill from beyond rank k); a cancelled
                # future must not poison its batchmates, so claim it first
                hits = [
                    (int(p), float(s))
                    for p, s in zip(ids[i][: req.k], scores[i][: req.k])
                    if p >= 0
                ]
                if req.future.set_running_or_notify_cancel():
                    req.future.set_result(hits)
        except Exception as e:  # surface the failure on every waiter
            logger.exception("batched dispatch failed (%d queries)", n)
            for req in batch:
                if not req.future.done() and req.future.set_running_or_notify_cancel():
                    req.future.set_exception(e)
