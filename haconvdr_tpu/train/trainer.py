"""Contrastive training step + host loop, jit/pjit over a device mesh.

Rebuilds the reference training loop (src/train_HAConvDR_topiocqa.py:81-208,
train_HAConvDR_qrecc.py):

  * trainable query tower + FROZEN passage tower — frozen params live
    outside the grad computation and passage embeddings pass through
    ``stop_gradient`` (reference: torch.no_grad + .detach, ":159-178");
  * AdamW with no-decay groups for bias/LayerNorm (src/utils.py:114-122)
    and the linear warmup->linear decay schedule
    (get_linear_schedule_with_warmup, ":106-107");
  * gradient accumulation every ``accumulation_steps`` micro-batches with
    SUM semantics + global-norm clip at apply time, matching
    loss.backward() accumulation + clip_grad_norm_ + optimizer.step()
    (":199-204") — implemented with a grad buffer in the train state and a
    lax.cond, all inside one jit;
  * best-(micro)batch-loss checkpointing hook (":206-208");
  * the whole step is one jit with batch sharded over 'dp' and params
    replicated (or tp-sharded) — the DataParallel analog with zero host
    sync beyond the scalar loss.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from haconvdr_tpu.config import ModelConfig, TrainConfig
from haconvdr_tpu.models.encoder import EncoderParams, encode
from haconvdr_tpu.train.loss import ranking_loss, ranking_loss_prepos

logger = logging.getLogger(__name__)


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    accum_grads: Any
    micro_step: jax.Array  # int32 counter within the accumulation window
    global_step: jax.Array  # applied-update counter
    rng: jax.Array  # dropout PRNG, split every micro step


def linear_warmup_decay_schedule(
    learning_rate: float, num_warmup_steps: int, num_training_steps: int
):
    """transformers.get_linear_schedule_with_warmup semantics."""

    def schedule(step):
        step = jnp.asarray(step, jnp.float32)
        warm = jnp.maximum(num_warmup_steps, 1)
        lr_warm = step / warm
        denom = jnp.maximum(num_training_steps - num_warmup_steps, 1)
        lr_decay = jnp.maximum(
            0.0, (num_training_steps - step) / denom
        )
        return learning_rate * jnp.where(step < num_warmup_steps, lr_warm, lr_decay)

    return schedule


def _no_decay_mask(params) -> Any:
    """weight decay applies to kernels/embeddings only — biases and
    LayerNorm scales are excluded (src/utils.py:115-120)."""

    def mask_tree(tree, path=()):
        if isinstance(tree, dict):
            return {k: mask_tree(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(mask_tree(v, path + (str(i),)) for i, v in enumerate(tree))
        name = path[-1] if path else ""
        parent = path[-2] if len(path) > 1 else ""
        is_ln = "layer_norm" in parent or parent == "norm" or "layer_norm" in name
        return not (name == "bias" or is_ln)

    return mask_tree(params)


def make_optimizer(cfg: TrainConfig, total_steps: int) -> optax.GradientTransformation:
    schedule = linear_warmup_decay_schedule(
        cfg.learning_rate, int(cfg.num_warmup_portion * total_steps), total_steps
    )
    return optax.chain(
        optax.clip_by_global_norm(cfg.max_grad_norm),
        optax.adamw(
            schedule,
            b1=0.9,
            b2=0.999,
            eps=cfg.adam_epsilon,
            weight_decay=cfg.weight_decay,
            mask=_no_decay_mask,
        ),
    )


def make_train_step(
    mesh: Mesh,
    model_cfg: ModelConfig,
    train_cfg: TrainConfig,
    optimizer: optax.GradientTransformation,
    loss_variant: str = "prepos",  # "prepos" (topiocqa) | "ranking" (qrecc)
    query_key: str = "conv_qp",
) -> Callable[[TrainState, Any, Dict[str, jax.Array]], tuple]:
    """Returns jitted ``step(state, frozen_params, batch) -> (state, loss)``.

    ``batch`` is a collate() dict; the query input field is selected by
    ``query_key`` (the reference's --mode dispatch,
    src/train_HAConvDR_topiocqa.py:130-146).
    """
    data_sharding = NamedSharding(mesh, P("dp", None))
    K = train_cfg.accumulation_steps
    # frozen towers: no grads flow (stop_gradient + zero-tangent params),
    # so they may run a faster compute dtype (and cuDNN attention in bf16)
    # without touching the trained tower's numerics
    frozen_cfg = model_cfg
    if train_cfg.frozen_dtype and train_cfg.frozen_dtype != model_cfg.dtype:
        import dataclasses

        # "int8": dense kernels arrive pre-quantized (fit() calls
        # quantize_encoder_params; direct step() users must do the same)
        # and _dense routes by the int8 kernel leaf — the surrounding
        # activations/attention run bf16
        frozen_cfg = dataclasses.replace(
            model_cfg,
            dtype=(
                "bfloat16"
                if train_cfg.frozen_dtype == "int8"
                else train_cfg.frozen_dtype
            ),
        )

    def loss_fn(params, frozen_params, batch, dropout_rng):
        # query tower in train mode (dropout active,
        # src/train_HAConvDR_topiocqa.py:125); frozen passage tower in eval
        # mode (":126", passage_encoder.eval())
        q = encode(
            params, model_cfg, batch[query_key], batch[f"{query_key}_mask"],
            dropout_rng=dropout_rng,
        )
        sg = jax.lax.stop_gradient

        def frozen_encode(ids, mask):
            return sg(encode(frozen_params, frozen_cfg, ids, mask))

        pos = frozen_encode(batch["pos_docs"], batch["pos_docs_mask"])
        neg_ids, neg_mask = batch["neg_docs"], batch["neg_docs_mask"]
        neg_valid = None
        if neg_ids.ndim == 3:
            # multi-negative batches (Retrieval_qrecc_negs,
            # src/data.py:745-818): fold the R axis into the batch for the
            # frozen tower, unfold for the loss; padded slots (beyond
            # num_negs) are masked out of the softmax
            Bn, R, Ln = neg_ids.shape
            neg = frozen_encode(
                neg_ids.reshape(Bn * R, Ln), neg_mask.reshape(Bn * R, Ln)
            ).reshape(Bn, R, -1)
            if "num_negs" in batch:
                neg_valid = (
                    jnp.arange(R)[None, :] < batch["num_negs"][:, None]
                ).astype(jnp.int32)
        else:
            neg = frozen_encode(neg_ids, neg_mask)
        valid = batch["valid"]
        if loss_variant == "ranking":
            return ranking_loss(q, pos, neg, valid=valid, neg_valid=neg_valid)
        pseudo = prepos = has_pseudo = has_prepos = None
        if train_cfg.is_pseudo_prepos and "pseudo_prepos_docs" in batch:
            pseudo = frozen_encode(
                batch["pseudo_prepos_docs"], batch["pseudo_prepos_docs_mask"]
            )
            has_pseudo = batch["has_pseudo_prepos"]
        if train_cfg.is_prepos_neg and "prepos_neg_docs" in batch:
            prepos = frozen_encode(
                batch["prepos_neg_docs"], batch["prepos_neg_docs_mask"]
            )
            has_prepos = batch["has_prepos_neg"]
        return ranking_loss_prepos(
            q,
            pos,
            neg,
            pseudo_prepos_embs=pseudo,
            prepos_neg_doc_embs=prepos,
            has_pseudo=has_pseudo,
            has_prepos_neg=has_prepos,
            alpha=train_cfg.alpha,
            is_pseudo_prepos=train_cfg.is_pseudo_prepos,
            is_prepos_neg=train_cfg.is_prepos_neg,
            valid=valid,
        )

    @jax.jit
    def step(state: TrainState, frozen_params, batch):
        batch = {
            k: (
                jax.lax.with_sharding_constraint(v, data_sharding)
                if v.ndim >= 2
                else v
            )
            for k, v in batch.items()
        }
        rng, dropout_rng = jax.random.split(state.rng)
        drop = (
            dropout_rng
            if (model_cfg.hidden_dropout_prob > 0 or model_cfg.attention_probs_dropout_prob > 0)
            else None
        )
        loss, grads = jax.value_and_grad(loss_fn)(
            state.params, frozen_params, batch, drop
        )
        accum = jax.tree_util.tree_map(jnp.add, state.accum_grads, grads)
        micro = state.micro_step + 1

        def apply(_):
            updates, new_opt = optimizer.update(accum, state.opt_state, state.params)
            new_params = optax.apply_updates(state.params, updates)
            zeros = jax.tree_util.tree_map(jnp.zeros_like, accum)
            return TrainState(
                new_params, new_opt, zeros, jnp.int32(0), state.global_step + 1, rng
            )

        def hold(_):
            return TrainState(
                state.params, state.opt_state, accum, micro, state.global_step, rng
            )

        new_state = jax.lax.cond(micro >= K, apply, hold, None)
        return new_state, loss

    return step


def init_train_state(
    params: EncoderParams, optimizer: optax.GradientTransformation, seed: int = 42
) -> TrainState:
    return TrainState(
        params=params,
        opt_state=optimizer.init(params),
        accum_grads=jax.tree_util.tree_map(jnp.zeros_like, params),
        micro_step=jnp.int32(0),
        global_step=jnp.int32(0),
        rng=jax.random.PRNGKey(seed),
    )


@dataclass
class Trainer:
    """Host loop: epochs x shuffled batches -> jitted step; logging and
    best-loss checkpointing mirror the reference loop
    (src/train_HAConvDR_topiocqa.py:119-208).  Beyond the reference:
    periodic full-train-state checkpoints (``state_ckpt_dir`` +
    ``state_ckpt_every`` micro steps) with exact resume, and structured
    telemetry (``metrics``)."""

    mesh: Mesh
    model_cfg: ModelConfig
    train_cfg: TrainConfig
    loss_variant: str = "prepos"
    query_key: str = "conv_qp"
    save_fn: Optional[Callable[[EncoderParams, int], None]] = None
    state_ckpt_dir: str = ""
    state_ckpt_every: int = 0
    resume: bool = False
    metrics: Any = None  # utils.telemetry.MetricsLogger

    def fit(self, params, frozen_params, examples, collate_batches=None):
        from haconvdr_tpu.data.loader import batch_iter, num_batches

        cfg = self.train_cfg
        n_dev = int(np.prod(self.mesh.devices.shape))
        batch_size = cfg.per_device_train_batch_size * max(1, n_dev)
        steps_per_epoch = num_batches(len(examples), batch_size)
        total_steps = cfg.num_train_epochs * steps_per_epoch
        optimizer = make_optimizer(cfg, max(1, total_steps // cfg.accumulation_steps))
        step_fn = make_train_step(
            self.mesh, self.model_cfg, cfg, optimizer,
            loss_variant=self.loss_variant, query_key=self.query_key,
        )
        state = init_train_state(params, optimizer, seed=cfg.seed)
        if self.resume and self.state_ckpt_dir:
            from haconvdr_tpu.train.checkpoint import latest_step, restore_train_state

            step_no = latest_step(self.state_ckpt_dir)
            if step_no is not None:
                state = restore_train_state(self.state_ckpt_dir, state, step_no)
                logger.info("resumed train state from step %d", step_no)
        frozen = jax.tree_util.tree_map(jnp.asarray, frozen_params)
        if cfg.frozen_dtype == "int8":
            # one-time per-output-channel weight quantization (the per-
            # token activation side is dynamic, inside _dense)
            from haconvdr_tpu.models.encoder import quantize_encoder_params

            frozen = quantize_encoder_params(frozen)

        best_loss = float("inf")
        global_micro = 0
        total_loss = 0.0
        t0 = time.time()
        for epoch in range(cfg.num_train_epochs):
            if callable(collate_batches):
                it = collate_batches(epoch)
            elif collate_batches is not None:
                it = iter(collate_batches)  # single-epoch custom batches
            else:
                it = batch_iter(
                    examples, batch_size, shuffle=True, seed=cfg.seed + epoch
                )
            for batch in it:
                arrays = {
                    k: jnp.asarray(v)
                    for k, v in batch.items()
                    if isinstance(v, np.ndarray)
                }
                state, loss = step_fn(state, frozen, arrays)
                loss = float(loss)
                total_loss += loss
                global_micro += 1
                if cfg.print_steps > 0 and global_micro % cfg.print_steps == 0:
                    logger.info(
                        "epoch %d step %d loss %.5f total %.2f (%.1fs)",
                        epoch + 1, global_micro, loss, total_loss, time.time() - t0,
                    )
                if self.metrics is not None:
                    self.metrics.log(
                        "train_step", epoch=epoch + 1, micro_step=global_micro,
                        loss=loss,
                    )
                if loss < best_loss:  # per-batch best, ":206-208"
                    best_loss = loss
                    if self.save_fn is not None:
                        self.save_fn(state.params, global_micro)
                if (
                    self.state_ckpt_dir
                    and self.state_ckpt_every > 0
                    and global_micro % self.state_ckpt_every == 0
                ):
                    from haconvdr_tpu.train.checkpoint import save_train_state

                    save_train_state(self.state_ckpt_dir, global_micro, state)
        return state, best_loss
