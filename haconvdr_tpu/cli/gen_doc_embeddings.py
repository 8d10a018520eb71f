"""CLI: encode the tokenized collection into embedding blocks
(reference gen_doc_embeddings.py), streaming through the device mesh.

Usage: python -m haconvdr_tpu.cli.gen_doc_embeddings --config cfg.toml
       [shard_stride=N shard_offset=i start_block_id=B]

Multi-host / resumable runs: shard the corpus rank-mod with
``shard_stride``/``shard_offset`` (each host writes its own block-id range
via ``start_block_id``) — the analog of the reference's rank-mod
StreamingDataset + restart-after-crash skip (src/utils.py:133-147,
gen_doc_embeddings.py:98-100).
"""

import logging
import sys

from haconvdr_tpu.config import config_from_argv
from haconvdr_tpu.index.build import encode_corpus
from haconvdr_tpu.index.store import TokenizedCorpus
from haconvdr_tpu.models.hf_import import load_hf_checkpoint
from haconvdr_tpu.parallel.mesh import make_mesh
from haconvdr_tpu.parallel.sharded_encode import make_sharded_encode_fn, shard_params
from haconvdr_tpu.utils.io import setup_logging

logger = logging.getLogger(__name__)


def main(argv=None):
    setup_logging()
    from haconvdr_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    argv = list(sys.argv[1:] if argv is None else argv)
    extra = {"shard_stride": "1", "shard_offset": "0", "start_block_id": "0"}
    rest = []
    for a in argv:
        k, _, v = a.partition("=")
        if k in extra:
            extra[k] = v
        else:
            rest.append(a)
    cfg = config_from_argv(rest)
    corpus = TokenizedCorpus(cfg.index.tokenized_dir or cfg.index.data_output_path)
    params, model_cfg = load_hf_checkpoint(
        cfg.model.pretrained_encoder_path, cfg.model.model_type
    )
    mesh = make_mesh()
    n_dev = mesh.devices.size
    if cfg.index.compute_int8:
        # int8 x int8 inference (config.IndexConfig.compute_int8)
        from haconvdr_tpu.models.encoder import quantize_encoder_params

        params = quantize_encoder_params(params)
    encode_fn = make_sharded_encode_fn(mesh, model_cfg)
    params = shard_params(mesh, params)
    store = encode_corpus(
        corpus,
        encode_fn,
        params,
        cfg.index.data_output_path,
        batch_size=cfg.index.per_device_eval_batch_size * n_dev,
        per_block_passage_num=cfg.index.per_block_passage_num,
        store_dtype=cfg.index.store_dtype,
        stride=int(extra["shard_stride"]),
        offset=int(extra["shard_offset"]),
        start_block_id=int(extra["start_block_id"]),
    )
    logger.info("embedding blocks written: %d", store.num_blocks())


if __name__ == "__main__":
    main()
