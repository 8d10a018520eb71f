"""Benchmark modes on one NVIDIA GPU; each prints one JSON line.

    python bench.py                         # flat: resident 2.5M x 768 top-100
    BENCH_<MODE>=1 python bench.py          # one mode (see MODES)
    BENCH_ALL=1 python bench.py             # every mode, one child process each

The flat mode is the reference's serving hot loop: faiss ``IndexFlatIP``
search over a resident 2.5M x 768 block, top-100, 2048 queries
(src/test_HAConvDR_topiocqa.py:101-108).  Every result names the device it
ran on and the card's power limit.  There is no CPU fallback: without a
GPU the script exits non-zero.

Knobs (bench only): ``BENCH_DTYPE`` = float32 | bfloat16 | int8 (index
dtype), ``BENCH_SEARCH_IMPL`` = fused | xla | both (both alternates the two
in one process and checks they agree), ``BENCH_CORPUS`` = a comma list of
iid | articles | topics (flat mode; see ``_corpus``), ``BENCH_ATTN`` =
cudnn | xla | both,
``BENCH_ENCODE_INT8`` = 0 | 1, ``BENCH_REMAT`` = mlp | true | false,
``BENCH_TRAIN_DTYPE`` = float32 | bfloat16.  The two ``both`` knobs time
the hand-written or library path against what XLA makes of the plain one.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

N_PASSAGES = 2_500_000
DIM = 768
N_QUERIES = 2048
TOP_K = 100
CHUNK = 131_072  # SearchConfig.passage_chunk


def _sink(jnp, s, i):
    """Scalar folding EVERY score and id of a timed search, so XLA cannot
    drop part of the pipeline.  Ids are summed in f32: their int32 sum
    overflows at 2.5M rows."""
    return (
        jnp.sum(jnp.where(jnp.isfinite(s), s, 0.0)).astype(jnp.float32)
        + jnp.sum(i.astype(jnp.float32))
    )


def _index_dtype(jnp):
    return jnp.dtype(os.environ.get("BENCH_DTYPE", "float32"))


ARTICLE_ROWS = 8  # consecutive passages of one article
TOPIC_ARTICLES = 32  # articles that share a topic, scattered over the corpus


def _corpus(jax, jnp, n_rows, dtype, seed=0, kind="iid"):
    """([n_rows padded to CHUNK, DIM] rows made on the device in slices,
    [N_QUERIES, DIM] f32 queries).

    ``iid``: standard-normal rows and queries.  ``articles``: rows come in
    runs of ARTICLE_ROWS that share an article vector (cosine 0.8 within a
    run, as consecutive chunks of one document), and each query is aimed
    at one article.  ``topics``: articles also share a topic vector with
    TOPIC_ARTICLES - 1 others stored elsewhere (cosine 0.48 between their
    rows), and each query is aimed at one topic, so its top-k comes in
    many short runs.  Every row has unit variance per dimension.
    """
    n_pad = -(-n_rows // CHUNK) * CHUNK
    key = jax.random.PRNGKey(seed)
    k_art, k_top, k_assign, k_q, k_qn = jax.random.split(jax.random.fold_in(key, 1 << 20), 5)
    n_art = n_pad // ARTICLE_ROWS
    n_top = max(1, n_art // TOPIC_ARTICLES)
    if kind == "iid":
        centers = None
    else:
        centers = jax.random.normal(k_art, (n_art, DIM), jnp.float32)
        if kind == "topics":
            topics = jax.random.normal(k_top, (n_top, DIM), jnp.float32)
            topic_of = jax.random.randint(k_assign, (n_art,), 0, n_top)
            centers = np.float32(0.6) ** 0.5 * topics[topic_of] + np.float32(0.4) ** 0.5 * centers
        elif kind != "articles":
            raise ValueError(f"unknown corpus {kind!r}")

    @jax.jit
    def part(key, c, centers):
        x = jax.random.normal(key, (CHUNK, DIM), jnp.float32)
        if centers is not None:
            art = (c * CHUNK + jnp.arange(CHUNK)) // ARTICLE_ROWS
            x = np.float32(0.8) ** 0.5 * centers[art] + np.float32(0.2) ** 0.5 * x
        if dtype == jnp.int8:
            return jnp.clip(jnp.round(x * 32.0), -127, 127).astype(jnp.int8)
        return x.astype(dtype)

    passages = jnp.concatenate(
        [part(jax.random.fold_in(key, c), c, centers) for c in range(n_pad // CHUNK)]
    )
    queries = jax.random.normal(k_qn, (N_QUERIES, DIM), jnp.float32)
    if kind != "iid":
        aim = topics if kind == "topics" else centers
        target = jax.random.randint(k_q, (N_QUERIES,), 0, aim.shape[0])
        queries = np.float32(0.5) ** 0.5 * (aim[target] + queries)
    return passages, queries


def _override(attr, value):
    """Pin one ops.backend choice for an A/B run of this process."""
    from haconvdr_tpu.ops import backend

    setattr(backend, attr, lambda *a, **k: value)


def _timed(fn, *args, reps=5):
    """Median seconds of ``reps`` calls after one warm-up call; every call
    ends in a host pull of its result."""
    np.asarray(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        np.asarray(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), times


def bench_flat(jax, jnp):
    """Resident-block exact top-100 QPS at 2.5M x 768, Q=2048, on each
    corpus of ``BENCH_CORPUS``, with the share of queries the fused path
    searches twice."""
    from haconvdr_tpu.ops import topk

    dtype = _index_dtype(jnp)
    impl = os.environ.get("BENCH_SEARCH_IMPL", "")
    nv = jnp.int32(N_PASSAGES)

    def make(fn):
        return jax.jit(lambda q, p: _sink(jnp, *fn(q, p, nv, TOP_K, CHUNK)))

    fns = {"xla": topk.topk_block, "fused": topk.fused_topk_block,
           "chosen": topk.search_block}
    order = ["xla", "fused", "fused", "xla"] if impl == "both" else ["chosen"]
    jitted = {name: make(fns[name]) for name in set(order)}
    out = {"metric": f"flat_top100_qps_2.5M_{dtype.name}", "unit": "queries/s"}
    for kind in os.environ.get("BENCH_CORPUS", "iid").split(","):
        passages, queries = _corpus(jax, jnp, N_PASSAGES, dtype, kind=kind)
        res = {}
        runs = {}
        for name in order:
            med, times = _timed(jitted[name], queries, passages)
            runs.setdefault(name, []).extend(times)
        for name, times in runs.items():
            res[f"{name}_qps"] = N_QUERIES / float(np.median(times))
            res[f"{name}_ms"] = [t * 1e3 for t in times]
        flags, tie = (np.asarray(a) for a in topk.fused_flags(queries, passages, nv, TOP_K))
        res["flag_budget"] = topk.FLAG_BUDGET
        res["over_budget_share"] = float(np.mean(flags > topk.FLAG_BUDGET))
        res["boundary_tie_share"] = float(np.mean(tie))
        res["flagged_windows_p50_max"] = [float(np.median(flags)), int(flags.max())]
        if impl == "both":
            s1, i1 = topk.topk_block(queries, passages, nv, TOP_K, CHUNK)
            s2, i2 = topk.fused_topk_block(queries, passages, nv, TOP_K, CHUNK)
            res["id_mismatches_vs_xla"] = int(np.sum(np.asarray(i1) != np.asarray(i2)))
            res["max_score_diff_vs_xla"] = float(
                np.max(np.abs(np.asarray(s1) - np.asarray(s2))))
        out[kind] = res
        del passages
    first = out[next(k for k in out if isinstance(out[k], dict))]
    out["value"] = first[f"{order[0]}_qps"]
    return out


def bench_latency(jax, jnp):
    """Single-query latency over one resident 2.5M block."""
    from haconvdr_tpu.ops.topk import search_block

    dtype = _index_dtype(jnp)
    passages, queries = _corpus(jax, jnp, N_PASSAGES, dtype)
    query = queries[:1]
    fn = jax.jit(lambda q, p: _sink(jnp, *search_block(q, p, N_PASSAGES, TOP_K, CHUNK)))
    med, times = _timed(fn, query, passages, reps=20)
    return {"metric": f"flat_top100_single_query_ms_2.5M_{dtype.name}",
            "value": med * 1e3, "unit": "ms", "ms": [t * 1e3 for t in times]}


def bench_stream(jax, jnp):
    """BlockSearcher over 4 device-made blocks of 622,592 rows, against the
    same corpus searched as one resident block."""
    from haconvdr_tpu.ops.topk import BlockSearcher, search_block

    dtype = _index_dtype(jnp)
    n_blocks, rows = 4, 622_592
    blocks_dev = [_corpus(jax, jnp, rows, jnp.float32, seed=b)[0][:rows] for b in range(n_blocks)]
    queries = jax.random.normal(jax.random.PRNGKey(9), (N_QUERIES, DIM), jnp.float32)
    resident = jnp.concatenate(blocks_dev).astype(
        jnp.bfloat16 if dtype == jnp.bfloat16 else jnp.float32
    )
    resident = jnp.pad(resident, ((0, -resident.shape[0] % CHUNK), (0, 0)))
    res = jax.jit(lambda q, p: _sink(jnp, *search_block(q, p, n_blocks * rows, TOP_K, CHUNK)))
    res_s, _ = _timed(res, queries, resident, reps=3)
    del resident
    searcher = BlockSearcher(
        top_k=TOP_K, passage_chunk=CHUNK, query_chunk=N_QUERIES,
        compute_dtype="bfloat16" if dtype == jnp.bfloat16 else "float32",
        superblock_rows=-(-n_blocks * rows // CHUNK) * CHUNK,
    )
    items = [
        (np.asarray(b), np.arange(i * rows, (i + 1) * rows, dtype=np.int64))
        for i, b in enumerate(blocks_dev)
    ]
    stream_s, times = _timed(
        lambda q: searcher.search(q, items, return_device=True)[0], queries, reps=3
    )
    return {"metric": f"stream_top100_qps_4x622k_{dtype.name}",
            "value": N_QUERIES / stream_s, "unit": "queries/s",
            "overhead_vs_resident": stream_s / res_s, "ms": [t * 1e3 for t in times]}


def _encode_run(jax, jnp, mcfg, params, B, L, batches):
    from haconvdr_tpu.models.encoder import encode

    @jax.jit
    def run(params, key):
        def body(c, k):
            ids = jax.random.randint(k, (B, L), 2, 50000, jnp.int32)
            e = encode(params, mcfg, ids, jnp.ones((B, L), jnp.int32))
            return c + jnp.sum(e[:, 0]), None

        return jax.lax.scan(body, jnp.float32(0), jax.random.split(key, batches))[0]

    return run


def bench_encode(jax, jnp):
    """Corpus-encode throughput: bf16 tower (int8 weights with
    BENCH_ENCODE_INT8=1) over 384-token passages, B=512."""
    from haconvdr_tpu.config import ModelConfig
    from haconvdr_tpu.models.encoder import (
        init_encoder_params,
        quantize_encoder_params,
        stack_layer_params,
    )

    B, L, BATCHES = 512, 384, 4
    use_int8 = os.environ.get("BENCH_ENCODE_INT8", "0") == "1"
    mcfg = ModelConfig(dtype="bfloat16")
    params = stack_layer_params(init_encoder_params(jax.random.PRNGKey(0), mcfg))
    if use_int8:
        params = quantize_encoder_params(params)
    attn = os.environ.get("BENCH_ATTN", "")
    order = ["xla", "cudnn", "cudnn", "xla"] if attn == "both" else [attn or "chosen"]
    out = {"metric": "corpus_encode_passages_per_s" + ("_int8" if use_int8 else "_bf16"),
           "unit": "passages/s"}
    jitted = {}
    for impl in dict.fromkeys(order):
        # the choice is read while tracing, so each implementation is
        # traced and compiled under its own override
        if impl != "chosen":
            _override("attention_impl", impl)
        jitted[impl] = _encode_run(jax, jnp, mcfg, params, B, L, BATCHES)
        np.asarray(jitted[impl](params, jax.random.PRNGKey(0)))
    runs = {}
    for impl in order:
        med, times = _timed(jitted[impl], params, jax.random.PRNGKey(1), reps=3)
        runs.setdefault(impl, []).extend(times)
    for name, times in runs.items():
        out[f"{name}_passages_per_s"] = B * BATCHES / float(np.median(times))
        out[f"{name}_ms"] = [t * 1e3 for t in times]
    out["value"] = out[f"{next(iter(runs))}_passages_per_s"]
    return out


def bench_train(jax, jnp):
    """Reference-geometry train step: B=64, 512-token query tower (grad +
    dropout) + 4 frozen 384-token towers (src/train_HAConvDR_topiocqa.py)."""
    from haconvdr_tpu.config import ModelConfig, TrainConfig
    from haconvdr_tpu.models.encoder import init_encoder_params, stack_layer_params
    from haconvdr_tpu.parallel.mesh import make_mesh
    from haconvdr_tpu.train.trainer import init_train_state, make_optimizer, make_train_step

    B, LQ, LD = 64, 512, 384
    remat = {"true": True, "false": False}.get(
        os.environ.get("BENCH_REMAT", "mlp"), os.environ.get("BENCH_REMAT", "mlp")
    )
    mcfg = ModelConfig(dtype=os.environ.get("BENCH_TRAIN_DTYPE", "float32"), remat=remat)
    tcfg = TrainConfig(per_device_train_batch_size=B, accumulation_steps=8,
                       is_pseudo_prepos=True, is_prepos_neg=True)
    rs = np.random.RandomState(0)
    batch = {"valid": np.ones((B,), np.int32), "has_pseudo_prepos": np.ones((B,), np.int32),
             "has_prepos_neg": np.ones((B,), np.int32),
             "conv_qp": rs.randint(2, 50000, (B, LQ)).astype(np.int32),
             "conv_qp_mask": np.ones((B, LQ), np.int32)}
    for k in ("pos_docs", "neg_docs", "pseudo_prepos_docs", "prepos_neg_docs"):
        batch[k] = rs.randint(2, 50000, (B, LD)).astype(np.int32)
        batch[k + "_mask"] = np.ones((B, LD), np.int32)
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    opt = make_optimizer(tcfg, 1000)
    step = make_train_step(make_mesh(), mcfg, tcfg, opt)
    params = stack_layer_params(init_encoder_params(jax.random.PRNGKey(0), mcfg))
    state = init_train_state(params, opt, seed=1)
    compiled = step.lower(state, params, batch).compile()
    mem = compiled.memory_analysis()
    holder = {"state": state}

    def one():
        holder["state"], loss = compiled(holder["state"], params, batch)
        return loss

    med, times = _timed(one, reps=5)
    return {"metric": f"train_examples_per_s_b64_{mcfg.dtype}_remat_{remat}",
            "value": B / med, "unit": "examples/s", "step_ms": [t * 1e3 for t in times],
            "temp_bytes": int(mem.temp_size_in_bytes),
            "argument_bytes": int(mem.argument_size_in_bytes)}


def bench_e2e_batch(jax, jnp):
    """Coalesced serving compute: 64 512-token query forwards (bf16) and
    one top-100 search over the resident 2.5M block, one dispatch."""
    from haconvdr_tpu.config import ModelConfig
    from haconvdr_tpu.models.encoder import encode, init_encoder_params, stack_layer_params
    from haconvdr_tpu.ops.topk import search_block

    B, L = 64, 512
    dtype = _index_dtype(jnp)
    mcfg = ModelConfig(dtype="bfloat16")
    params = stack_layer_params(init_encoder_params(jax.random.PRNGKey(0), mcfg))
    passages = _corpus(jax, jnp, N_PASSAGES, dtype)[0]

    @jax.jit
    def e2e(params, passages, key):
        ids = jax.random.randint(key, (B, L), 2, 50000, jnp.int32)
        q = encode(params, mcfg, ids, jnp.ones((B, L), jnp.int32))
        return _sink(jnp, *search_block(q, passages, N_PASSAGES, TOP_K, CHUNK))

    med, times = _timed(e2e, params, passages, jax.random.PRNGKey(2), reps=10)
    return {"metric": f"serve_compute_qps_b64_2.5M_{dtype.name}", "value": B / med,
            "unit": "queries/s", "batch_ms": [t * 1e3 for t in times]}


MODES = {
    "flat": bench_flat,
    "latency": bench_latency,
    "stream": bench_stream,
    "encode": bench_encode,
    "train": bench_train,
    "e2e_batch": bench_e2e_batch,
}

ALL = [
    {"BENCH_FLAT": "1", "BENCH_DTYPE": dt, "BENCH_SEARCH_IMPL": "both"}
    for dt in ("float32", "bfloat16", "int8")
] + [
    {"BENCH_LATENCY": "1", "BENCH_DTYPE": "bfloat16"},
    {"BENCH_STREAM": "1"},
    {"BENCH_ENCODE": "1", "BENCH_ATTN": "both"},
    {"BENCH_ENCODE": "1", "BENCH_ENCODE_INT8": "1"},
    {"BENCH_TRAIN": "1", "BENCH_REMAT": "mlp"},
    {"BENCH_TRAIN": "1", "BENCH_REMAT": "false"},
    {"BENCH_E2E_BATCH": "1", "BENCH_DTYPE": "bfloat16"},
]


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def run_all() -> int:
    """Each mode in its own child, one at a time, so only one process ever
    holds the card (this parent never starts JAX).  Any failed mode makes
    the exit code non-zero."""
    failed = 0
    for extra in ALL:
        env = {k: v for k, v in os.environ.items() if k != "BENCH_ALL"}
        env.update(extra)
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__)], env=env,
            capture_output=True, text=True, timeout=3600,
        )
        lines = out.stdout.strip().splitlines()
        if out.returncode != 0 or not lines:
            failed += 1
            print(json.dumps({"failed": extra, "rc": out.returncode,
                              "stderr": out.stderr[-2000:]}), flush=True)
        else:
            print(lines[-1], flush=True)
    return 1 if failed else 0


def main() -> int:
    if os.environ.get("BENCH_ALL"):
        return run_all()
    import jax
    import jax.numpy as jnp

    from haconvdr_tpu.utils.cache import enable_compilation_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py needs a GPU; JAX found {dev.platform}", file=sys.stderr)
        return 1
    enable_compilation_cache()
    impl = os.environ.get("BENCH_SEARCH_IMPL", "")
    if impl in ("fused", "xla"):
        _override("search_impl", impl)
    name = next((m for m in MODES if os.environ.get("BENCH_" + m.upper())), "flat")
    res = MODES[name](jax, jnp)
    res.update(device=dev.device_kind, platform=dev.platform,
               device_count=len(jax.devices()), card=card())
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
