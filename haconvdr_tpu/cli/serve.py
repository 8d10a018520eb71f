"""CLI: online retrieval serving daemon.

Loads a trained query-encoder checkpoint + an embedding store, makes the
index device-resident (flat or IVF, f32/bf16/int8 per [serve] config),
and serves the HTTP/JSON API (haconvdr_tpu/serve_http.py) until SIGINT.
Beyond-reference surface: the reference's retrieval exists only as batch
eval scripts (/root/reference/src/test_HAConvDR_topiocqa.py).

Usage: python -m haconvdr_tpu.cli.serve --config cfg.toml
       [serve.port=8080 serve.store_dtype=int8 serve.ivf=true
        search.rescore_oversample=5 ...]

Deployment tiers (their speed on the card: PERF.md):
  quality/throughput: serve.store_dtype=bfloat16, flat resident —
      coalesced batches share one scan of the index
  latency:  serve.ivf=true — single queries at nprobe-tuned recall
  capacity: serve.ivf=true serve.store_dtype=int8
      search.rescore_oversample=5 — int8 memory cost, exact-quality
      results via the two-stage host rescore
"""

import logging

from haconvdr_tpu.config import config_from_argv
from haconvdr_tpu.utils.io import setup_logging

logger = logging.getLogger(__name__)


def main(argv=None):
    setup_logging()
    from haconvdr_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    cfg = config_from_argv(argv)
    cfg.data.is_train = False  # serving builds eval-style concats
    cfg.data.use_PRL = False
    s = cfg.serve
    if not s.checkpoint_path or not s.embeddings_dir:
        raise SystemExit(
            "serve.checkpoint_path and serve.embeddings_dir are required"
        )

    offset2pid = None
    if s.offset2pid_path:
        from haconvdr_tpu.utils.io import pload

        offset2pid = pload(s.offset2pid_path)

    from haconvdr_tpu.serve import Retriever
    from haconvdr_tpu.serve_http import RetrievalServer

    retriever = Retriever.load(
        s.checkpoint_path,
        s.embeddings_dir,
        model_type=cfg.model.model_type,
        offset2pid=offset2pid,
        data_cfg=cfg.data,
        search_cfg=cfg.search,
        resident=s.resident,
        store_dtype=s.store_dtype,
        ivf=s.ivf,
        ivf_nlist=s.ivf_nlist,
        ivf_nprobe=None if s.ivf_nprobe < 0 else s.ivf_nprobe,
        ivf_dir=s.ivf_dir or None,
        encoder_int8=s.encoder_int8,
    )
    server = RetrievalServer(
        retriever,
        host=s.host,
        port=s.port,
        max_batch=s.max_batch,
        max_wait_ms=s.max_wait_ms,
        queue_depth=s.queue_depth,
        request_timeout_s=s.request_timeout_s,
    )
    logger.info(
        "serving %s/%s on http://%s:%d (max_batch=%d, wait=%.1fms)",
        "ivf" if s.ivf else "flat", s.store_dtype,
        server.host, server.port, s.max_batch, s.max_wait_ms,
    )
    server.run()


if __name__ == "__main__":
    main()
