"""Offline corpus indexing: tokenize + encode pipelines.

Rebuild of gen_tokenized_doc.py / gen_doc_embeddings.py:

  * :func:`tokenize_collection` — stream the raw collection (TSV/JSONL)
    through the host tokenizer into a TokenizedCorpus, optionally with a
    multiprocessing pool (reference forks 32 line-mod workers,
    gen_tokenized_doc.py:117-132);
  * :func:`encode_corpus` — stream the tokenized corpus through the
    jit-compiled, mesh-sharded passage encoder in fixed-shape batches and
    write embedding blocks of ``per_block_passage_num`` passages
    (gen_doc_embeddings.py:65-158).  Multi-host runs shard the stream
    rank-mod (``stride``/``offset``), the analog of StreamingDataset
    (src/utils.py:133-147).
"""

from __future__ import annotations

import json
import logging
import os
import time
from multiprocessing import Pool
from typing import Iterable, List, Optional, Tuple

import numpy as np

from haconvdr_tpu.config import IndexConfig
from haconvdr_tpu.index.store import (
    EmbeddingBlockStore,
    TokenizedCorpus,
    TokenizedCorpusWriter,
)

logger = logging.getLogger(__name__)

_WORKER_TOK = None


def parse_collection_line(
    line: str, ext: str, max_doc_character: int, title: bool = False
) -> Optional[Tuple[int, str, Optional[str]]]:
    """One collection record -> (pid, text, title_or_None).

    Mirrors PassagePreprocessingFn's field handling
    (gen_tokenized_doc.py:200-239): TSV = ``pid\\ttext\\ttitle`` (title mode
    joins the de-[SEP]ed title before the text); JSONL = {id, text, title}
    encoded as a text pair.  Returns None for bad/header lines.
    """
    line = line.strip()
    if not line:
        return None
    if ext == ".jsonl":
        obj = json.loads(line)
        return int(obj["id"]), obj["text"][:max_doc_character], obj["title"]
    # tsv
    arr = line.split("\t")
    if arr[0] == "id":  # header
        return None
    try:
        pid = int(arr[0])
        if title:
            text = arr[2].rstrip().replace(" [SEP] ", " ") + " " + arr[1].rstrip()
        else:
            text = arr[1].rstrip()
    except (IndexError, ValueError):
        return None
    return pid, text[:max_doc_character], None


def _encode_passage(tokenizer, text: str, title: Optional[str], max_seq_length: int) -> List[int]:
    if title is not None:
        return tokenizer.encode(
            title,
            text_pair=text,
            add_special_tokens=True,
            truncation=True,
            max_length=max_seq_length,
        )
    return tokenizer.encode(
        text, add_special_tokens=True, truncation=True, max_length=max_seq_length
    )


def _pool_init(tokenizer_factory):
    global _WORKER_TOK
    _WORKER_TOK = tokenizer_factory()


def _pool_tokenize(args):
    lines, ext, max_doc_character, max_seq_length, title = args
    out = []
    for line in lines:
        parsed = parse_collection_line(line, ext, max_doc_character, title)
        if parsed is None:
            continue
        pid, text, ttl = parsed
        ids = _encode_passage(_WORKER_TOK, text, ttl, max_seq_length)
        out.append((pid, ids))
    return out


def tokenize_collection(
    cfg: IndexConfig,
    tokenizer=None,
    tokenizer_factory=None,
    title: bool = False,
    lines: Optional[Iterable[str]] = None,
) -> TokenizedCorpus:
    """Tokenize the raw collection into ``cfg.data_output_path``.

    Idempotent like the reference ("exists -> exit",
    gen_tokenized_doc.py:147-149): an existing corpus dir is reused.
    Provide either a ``tokenizer`` (in-process) or a picklable
    ``tokenizer_factory`` (for the worker pool).
    """
    out_dir = cfg.data_output_path
    if os.path.exists(os.path.join(out_dir, "meta.json")):
        logger.info("tokenized corpus already exists at %s, skipping", out_dir)
        return TokenizedCorpus(out_dir)

    ext = cfg.raw_collection_path[cfg.raw_collection_path.rfind("."):]
    writer = TokenizedCorpusWriter(out_dir, cfg.max_seq_length)

    def line_iter():
        if lines is not None:
            yield from lines
        else:
            with open(cfg.raw_collection_path, "r", encoding="utf-8") as f:
                yield from f

    t0 = time.time()
    if cfg.num_tokenize_workers > 1 and tokenizer_factory is not None:
        with Pool(
            cfg.num_tokenize_workers, initializer=_pool_init, initargs=(tokenizer_factory,)
        ) as pool:
            def chunk_gen():
                chunk: List[str] = []
                for line in line_iter():
                    chunk.append(line)
                    if len(chunk) >= 10000:
                        yield (chunk, ext, cfg.max_doc_character, cfg.max_seq_length, title)
                        chunk = []
                if chunk:
                    yield (chunk, ext, cfg.max_doc_character, cfg.max_seq_length, title)

            for result in pool.imap(_pool_tokenize, chunk_gen()):
                for pid, ids in result:
                    writer.add(pid, ids)
    else:
        assert tokenizer is not None, "need a tokenizer for in-process tokenization"
        for line in line_iter():
            parsed = parse_collection_line(line, ext, cfg.max_doc_character, title)
            if parsed is None:
                continue
            pid, text, ttl = parsed
            writer.add(pid, _encode_passage(tokenizer, text, ttl, cfg.max_seq_length))

    writer.finalize()
    logger.info(
        "tokenized %d passages in %.1fs -> %s", writer.count, time.time() - t0, out_dir
    )
    return TokenizedCorpus(out_dir)


def encode_corpus(
    corpus: TokenizedCorpus,
    encode_fn,
    params,
    out_dir: str,
    batch_size: int = 512,
    per_block_passage_num: int = 2_500_000,
    store_dtype: str = "float32",
    fmt: str = "npy",
    stride: int = 1,
    offset: int = 0,
    start_block_id: int = 0,
) -> EmbeddingBlockStore:
    """Stream-encode the corpus into embedding blocks.

    ``encode_fn(params, ids, mask) -> [B, D]`` is typically
    parallel.make_sharded_encode_fn's output.  Every batch has the same
    static shape (the tail is padded and the pad rows dropped host-side),
    so the encoder compiles exactly once.
    """
    import jax.numpy as jnp

    store = EmbeddingBlockStore(out_dir, fmt=fmt)
    quantize = store_dtype == "int8"
    if quantize:
        # int8 blocks: buffer float, quantize per block at flush time
        # (per-block per-dim scales, index/quantize.py); halves the H2D
        # stream vs bf16 on the BlockSearcher path and quarters it vs f32
        assert fmt == "npy", "int8 blocks require the native npy format"
        dtype = np.dtype(np.float32)
    elif store_dtype == "bfloat16":
        import ml_dtypes

        dtype = np.dtype(ml_dtypes.bfloat16)
    else:
        dtype = np.dtype(store_dtype)
    # whole batches per block, matching the reference's block_size
    # accounting (gen_doc_embeddings.py:87-88: block_size = expect // batch)
    block_rows = max(per_block_passage_num // batch_size, 1) * batch_size

    emb_buf: List[np.ndarray] = []
    id_buf: List[np.ndarray] = []
    buffered = 0
    block_id = start_block_id
    total = 0
    t0 = time.time()

    def flush():
        nonlocal emb_buf, id_buf, buffered, block_id, total
        if not buffered:
            return
        emb = np.concatenate(emb_buf, axis=0)
        ids = np.concatenate(id_buf, axis=0)
        if quantize:
            from haconvdr_tpu.index.quantize import quantize_int8

            emb, scale = quantize_int8(emb)
            store.write_block(block_id, emb, ids, scale=scale)
        else:
            store.write_block(block_id, emb, ids)
        total += len(emb)
        logger.info(
            "wrote block %d (%d passages, %.1f s elapsed)",
            block_id, len(emb), time.time() - t0,
        )
        block_id += 1
        emb_buf, id_buf, buffered = [], [], 0

    L = corpus.max_seq_length
    # Keep several batches in flight: device compute, D2H transfer, and
    # host-side block assembly overlap (jax dispatch is async; a per-batch
    # np.asarray sync would serialize the whole stream).
    from collections import deque

    inflight: deque = deque()
    PIPELINE_DEPTH = 8

    def drain(limit: int) -> None:
        nonlocal buffered
        while len(inflight) > limit:
            emb_dev, offs, n = inflight.popleft()
            emb = np.asarray(emb_dev)[:n]
            if emb.ndim == 3:
                # multi-chunk long-sequence output [B, n_chunks, D]: one
                # row per chunk, all carrying the passage's offset, in the
                # reference's chunk-major order (gen_doc_embeddings.py:
                # 115-121 appends (idxs, embs[:, chunk_no, :]) per chunk);
                # downstream pid-dedup keeps each passage's best chunk
                # (test_HAConvDR_topiocqa.py:249-255)
                n_chunks = emb.shape[1]
                emb = np.ascontiguousarray(emb.transpose(1, 0, 2)).reshape(
                    n_chunks * n, emb.shape[2]
                )
                offs = np.tile(offs, n_chunks)
                n = n_chunks * n
            if dtype is not None and emb.dtype != dtype:
                emb = emb.astype(dtype)
            emb_buf.append(emb)
            id_buf.append(offs)
            buffered += n
            if buffered >= block_rows:
                flush()

    for offsets, ids, mask in corpus.batches(batch_size, stride=stride, offset=offset):
        n = len(offsets)
        if n < batch_size:  # pad tail to the static batch shape
            pad = batch_size - n
            ids = np.concatenate([ids, np.zeros((pad, L), np.int32)])
            mask = np.concatenate([mask, np.zeros((pad, L), np.int32)])
            mask[n:, 0] = 1  # avoid fully-masked rows
        emb_dev = encode_fn(params, jnp.asarray(ids), jnp.asarray(mask))
        try:
            emb_dev.copy_to_host_async()
        except AttributeError:
            pass
        inflight.append((emb_dev, np.asarray(offsets, np.int64), n))
        drain(PIPELINE_DEPTH)
    drain(0)
    flush()
    logger.info("encoded %d passages total", total)
    return store
