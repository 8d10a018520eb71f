"""CLI: IVF recall/latency tuning sweep (round-3, beyond the reference).

The IVF serving index's recall is a property of the embedding
distribution (clustered ANCE embeddings vs the synthetic mixtures the
unit tests use), so the right nlist/nprobe/slack for a real corpus can
only be measured on real embeddings.  This harness answers that question
in one run the moment embeddings exist: point it at an embedding matrix
(.npy) or an EmbeddingBlockStore directory plus a query matrix, and it
builds one IVF index per nlist, sweeps nprobe, and emits one JSON line
per configuration with recall@k against the exact scan and measured
batch latency.

    python -m haconvdr_tpu.cli.ivf_sweep \
        embeddings=emb.npy queries=q.npy \
        nlist=1024,4096 nprobe=8,16,32,64 slack=1.3 k=100 out=sweep.jsonl

With no queries=..., a held-out strided sample of the corpus itself is
used (self-retrieval recall — still distribution-faithful).  Exact
ground truth comes from the same exact search the flat index uses.
"""

from __future__ import annotations

import json
import logging
import sys
import time
from typing import Dict, List

import numpy as np

logger = logging.getLogger(__name__)


from haconvdr_tpu.utils.io import load_npy_bf16, parse_kv_args as _parse_args


def _load_embeddings(spec: str) -> np.ndarray:
    import os

    if os.path.isdir(spec):
        from haconvdr_tpu.index.store import EmbeddingBlockStore

        store = EmbeddingBlockStore.open_auto(spec)
        parts = [np.asarray(e, np.float32) for e, _ in store.iter_blocks()]
        return np.concatenate(parts, axis=0)
    return np.asarray(load_npy_bf16(spec), np.float32)


def sweep(
    embeddings: np.ndarray,
    queries: np.ndarray,
    nlists: List[int],
    nprobes: List[int],
    slacks: List[float],
    k: int = 100,
    dtype: str = "bfloat16",
    seed: int = 0,
    latency_reps: int = 3,
    rescore_oversample: float = 0.0,
) -> List[dict]:
    """One row per (nlist, slack, nprobe): recall@k vs the exact scan,
    batch latency, and the bucket-memory overhead factor.

    ``rescore_oversample > 1`` adds a ``recall_two_stage`` column: the
    first stage retrieves ``oversample * k`` candidates and the exact
    scores (from the in-memory float matrix — the serve path reads the
    disk store instead, index/rescore.py) rerank to k.  Answers "what
    oversample restores exact quality" per configuration in one run."""
    import jax
    import jax.numpy as jnp

    from haconvdr_tpu.index.ivf import build_ivf_device, ivf_search, quantize_ivf
    from haconvdr_tpu.ops.topk import BlockSearcher

    N, D = embeddings.shape
    searcher = BlockSearcher(top_k=k)
    gt_s, gt_i = searcher.search(
        queries, [(embeddings, np.arange(N, dtype=np.int64))]
    )
    gt_sets = [set(row[row >= 0].tolist()) for row in gt_i]

    rows = []
    # "int8" means QUANTIZED buckets (build at bf16, then quantize_ivf —
    # the serve-path contract), never a raw float->int8 cast
    int8 = dtype == "int8"
    x = jnp.asarray(embeddings, jnp.bfloat16 if int8 else jnp.dtype(dtype))
    for nlist in nlists:
        if nlist > N:
            logger.warning("skipping nlist=%d > corpus %d", nlist, N)
            continue
        for slack in slacks:
            t0 = time.time()
            try:
                index = build_ivf_device(
                    x, nlist=nlist, nprobe=max(nprobes), slack=slack,
                    tail_frac=min(0.5, 4.0 / slack / nlist + 0.1), seed=seed,
                )
            except ValueError as e:
                # lumpy geometry can overflow a low slack; record the
                # failed configuration and keep sweeping the rest
                rows.append({
                    "nlist": nlist, "slack": slack, "error": str(e),
                })
                logger.warning("nlist=%d slack=%.2f: %s", nlist, slack, e)
                continue
            if int8:
                index = quantize_ivf(index)
            build_s = time.time() - t0
            bucket_rows = index.buckets.shape[0] * index.buckets.shape[1]
            tail_rows = index.tail.shape[0]
            for nprobe in sorted(nprobes):
                s, i = ivf_search(index, queries, k=k, nprobe=nprobe)
                recall = float(np.mean([
                    len(set(i[r].tolist()) & gt_sets[r]) / max(1, len(gt_sets[r]))
                    for r in range(len(queries))
                ]))
                recall2 = None
                if rescore_oversample > 1.0:
                    # clamp to the candidate pool: probed buckets + tail
                    # (lax.top_k errors when k exceeds the scored axis)
                    pool = (
                        nprobe * index.buckets.shape[1] + tail_rows
                    )
                    m = min(int(np.ceil(k * rescore_oversample)), pool)
                    _, ci = ivf_search(index, queries, k=m, nprobe=nprobe)
                    r2 = []
                    for r in range(len(queries)):
                        cand = ci[r][ci[r] >= 0]
                        ex = queries[r] @ embeddings[cand].T
                        top = cand[np.argsort(-ex, kind="stable")[:k]]
                        r2.append(
                            len(set(top.tolist()) & gt_sets[r])
                            / max(1, len(gt_sets[r]))
                        )
                    recall2 = round(float(np.mean(r2)), 4)
                t0 = time.time()
                for _ in range(latency_reps):
                    s, i = ivf_search(index, queries, k=k, nprobe=nprobe)
                lat = (time.time() - t0) / latency_reps / len(queries)
                rows.append({
                    "nlist": nlist, "nprobe": nprobe, "slack": slack,
                    "k": k, "dtype": dtype,
                    "recall_at_k": round(recall, 4),
                    **(
                        {"recall_two_stage": recall2,
                         "rescore_oversample": rescore_oversample}
                        if recall2 is not None else {}
                    ),
                    "latency_ms_per_query": round(lat * 1000.0, 4),
                    "build_s": round(build_s, 2),
                    "memory_overhead": round((bucket_rows + tail_rows) / N, 3),
                    "scanned_frac": round(
                        (nprobe * index.buckets.shape[1] + tail_rows) / N, 4
                    ),
                })
                logger.info("%s", rows[-1])
    return rows


def main(argv=None):
    from haconvdr_tpu.utils.io import setup_logging

    setup_logging()
    from haconvdr_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    args = _parse_args(list(sys.argv[1:] if argv is None else argv))
    emb = _load_embeddings(args["embeddings"])
    if "queries" in args:
        q = np.asarray(np.load(args["queries"]), np.float32)
    else:
        stride = max(1, emb.shape[0] // int(args.get("n_queries", "256")))
        q = emb[::stride][: int(args.get("n_queries", "256"))].copy()
    rows = sweep(
        emb,
        q,
        nlists=[int(v) for v in args.get("nlist", "1024").split(",")],
        nprobes=[int(v) for v in args.get("nprobe", "8,32,64").split(",")],
        slacks=[float(v) for v in args.get("slack", "1.3").split(",")],
        k=int(args.get("k", "100")),
        dtype=args.get("dtype", "bfloat16"),
        seed=int(args.get("seed", "0")),
        rescore_oversample=float(args.get("rescore_oversample", "0")),
    )
    out = args.get("out", "ivf_sweep.jsonl")
    with open(out, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    logger.info("wrote %d rows to %s", len(rows), out)
    best = max(rows, key=lambda r: (r["recall_at_k"], -r["latency_ms_per_query"]))
    print(json.dumps({"best": best}))


if __name__ == "__main__":
    main()
