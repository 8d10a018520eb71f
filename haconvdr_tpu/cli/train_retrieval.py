"""CLI: contrastive training (reference src/train_HAConvDR_topiocqa.py /
train_HAConvDR_qrecc.py / train_HAConvDR_topiocqa_PRF.py).

Usage: python -m haconvdr_tpu.cli.train_retrieval --config cfg.toml
       [data.dataset=topiocqa data.mode=convqp train.learning_rate=1e-5 ...]

The PRF variant (data.is_PRF=true, with a PRF-merged train file) dispatches
the expanded dataset (one extra example per pseudo-prepos passage used as a
positive) + the plain ranking loss + the PRF checkpoint naming, matching the
reference's separate _PRF script (src/train_HAConvDR_topiocqa_PRF.py:37-41,
81,146).
"""

import logging
import os

from haconvdr_tpu.config import config_from_argv
from haconvdr_tpu.models.hf_import import load_model, save_hf_checkpoint
from haconvdr_tpu.parallel.mesh import make_mesh
from haconvdr_tpu.train.trainer import Trainer
from haconvdr_tpu.utils.io import set_seed, setup_logging

logger = logging.getLogger(__name__)

_QUERY_KEY = {"raw": "raw_query", "convq": "conv_q", "convqa": "conv_qa",
              "convqp": "conv_qp", "rewrite": "rewrite"}


def checkpoint_name(cfg) -> str:
    """Reference checkpoint naming: the PRF trainer encodes hard_neg_type /
    is_PRF / PRF_top (src/train_HAConvDR_topiocqa_PRF.py:37-41); the
    standard trainer encodes the prepos flags
    (src/train_HAConvDR_topiocqa.py:36-39)."""
    prl = "goldPRL" if cfg.data.use_PRL else "noPRL"
    if cfg.data.is_PRF:
        return (
            f"bs{cfg.train.per_device_train_batch_size}-{cfg.data.mode}-{prl}-"
            f"{cfg.data.hard_neg_type}hard-{cfg.train.is_pseudo_prepos}prepos-"
            f"{cfg.data.is_PRF}PRF-{cfg.data.PRF_top}-retriever"
        )
    return (
        f"bs{cfg.train.per_device_train_batch_size}-{cfg.data.mode}-{prl}-"
        f"{cfg.train.is_prepos_neg}preposhard-{cfg.train.is_pseudo_prepos}prepos-"
        "best-retriever"
    )


def main(argv=None):
    setup_logging()
    from haconvdr_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    cfg = config_from_argv(argv)
    set_seed(cfg.train.seed)
    cfg.data.is_train = True

    tokenizer, encoder = load_model(
        cfg.model.model_type + "_Query", cfg.model.pretrained_encoder_path
    )
    remat = cfg.model.remat
    cfg.model = encoder.cfg
    cfg.model.remat = remat
    from haconvdr_tpu.models.encoder import stack_layer_params, unstack_layer_params

    # stacked layer layout: the train step compiles one scanned layer
    # instead of num_layers unrolled copies
    params = stack_layer_params(encoder.params)
    frozen = params  # frozen passage tower starts from the same checkpoint

    if cfg.data.dataset == "topiocqa" and cfg.data.is_PRF:
        # the PRF trainer (src/train_HAConvDR_topiocqa_PRF.py:81,146) uses
        # the ORIGINAL Retrieval_topiocqa dataset — one extra example per
        # pseudo-prepos passage used as a positive — with the plain
        # cal_ranking_loss (pos matrix + 1 hard-neg column)
        from haconvdr_tpu.data.topiocqa import build_topiocqa_train_examples_expanded

        examples = build_topiocqa_train_examples_expanded(
            cfg.data, tokenizer, cfg.data.train_file_path,
            is_pseudo_prepos=cfg.train.is_pseudo_prepos,
        )
        loss_variant = "ranking"
    elif cfg.data.dataset == "topiocqa":
        from haconvdr_tpu.data.topiocqa import build_topiocqa_train_examples

        examples = build_topiocqa_train_examples(
            cfg.data, tokenizer, cfg.data.train_file_path
        )
        loss_variant = "prepos"
    elif cfg.data.num_negs > 1:
        from haconvdr_tpu.data.qrecc import build_qrecc_multineg_examples

        examples = build_qrecc_multineg_examples(
            cfg.data, tokenizer, cfg.data.train_file_path, num_negs=cfg.data.num_negs
        )
        loss_variant = "ranking"
    else:
        from haconvdr_tpu.data.qrecc import build_qrecc_examples

        examples = build_qrecc_examples(cfg.data, tokenizer, cfg.data.train_file_path)
        loss_variant = "ranking"
    logger.info("train examples: %d", len(examples))

    out_dir = os.path.join(cfg.train.model_output_path, checkpoint_name(cfg))

    def save(p, step):
        save_hf_checkpoint(unstack_layer_params(p), cfg.model, out_dir)
        tokenizer.save_pretrained(out_dir)
        logger.info("step %d: checkpoint saved at %s", step, out_dir)

    mesh = make_mesh()
    trainer = Trainer(
        mesh, cfg.model, cfg.train,
        loss_variant=loss_variant,
        query_key=_QUERY_KEY[cfg.data.mode],
        save_fn=save,
    )
    state, best = trainer.fit(params, frozen, examples)
    logger.info("training done; best loss %.5f", best)


if __name__ == "__main__":
    main()
