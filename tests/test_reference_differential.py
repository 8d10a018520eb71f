"""Differential whole-pipeline parity against the REFERENCE'S OWN CODE.

The reference's executable pieces that run on CPU torch in this image —
``src/models.py`` (ANCE) and ``src/data.py`` (``Retrieval_topiocqa``, eval
branch) — are imported directly from /root/reference and run on a
fabricated mini-TopiOCQA; the rebuild must produce byte-identical token
sequences, matching embeddings, and an identical TREC run through its own
components.  This converts the data-layer "intended behavior" claims
(SURVEY.md SS7 hard part (c)) into executed evidence.

Only read-only imports of the reference are performed; pieces whose modules
cannot be imported here (test_HAConvDR_topiocqa.py imports faiss and
pytrec_eval, neither installed) are replicated inline as cited oracles
(output_test_res dedup+write, src/test_HAConvDR_topiocqa.py:229-283).
"""

import importlib.util
import json
import os
import sys
from argparse import Namespace

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from haconvdr_tpu.config import DataConfig, ModelConfig
from haconvdr_tpu.models.encoder import encode, init_encoder_params
from haconvdr_tpu.models.hf_import import save_hf_checkpoint

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

REF = "/root/reference/src"


def _load_ref_module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _load_ref_or_skip(name, path):
    """Load a reference module by path, skipping when the tree is absent."""
    if not os.path.exists(path):
        pytest.skip("reference tree not mounted")
    return _load_ref_module(name, path)


_QRECC_PRE = "/root/reference/preprocess/preprocess_qrecc.py"
# the function region of preprocess_qrecc.py is clean; everything from the
# __main__ block (line 414+, syntax error at 418) is excluded
_QRECC_PRE_FN_LINES = 413


def _load_qrecc_pre_ns(extra=None):
    """Slice-exec preprocess_qrecc.py's function region (the file itself is
    unparseable — trailing ':' in __main__).  Injects the names the file
    uses but never imports/defines (pickle, logger) plus any extras."""
    import logging
    import pickle as _pickle

    if not os.path.exists(_QRECC_PRE):
        pytest.skip("reference tree not mounted")
    src_lines = open(_QRECC_PRE).read().splitlines(keepends=True)
    ns = {"logger": logging.getLogger("_ref_qrecc_pre"), "pickle": _pickle}
    ns.update(extra or {})
    exec(compile("".join(src_lines[:_QRECC_PRE_FN_LINES]), _QRECC_PRE, "exec"), ns)
    return ns


@pytest.fixture(scope="module")
def ref_modules():
    if not os.path.isdir(REF):
        pytest.skip("reference tree not mounted")
    ref_models = _load_ref_module("_ref_models", os.path.join(REF, "models.py"))
    ref_data = _load_ref_module("_ref_data", os.path.join(REF, "data.py"))
    return ref_models, ref_data


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """Byte-level-BPE tokenizer + tiny converted ANCE checkpoint that both
    the reference torch classes and the rebuild load."""
    out = tmp_path_factory.mktemp("refdiff_ckpt")
    from transformers.models.gpt2.tokenization_gpt2 import bytes_to_unicode

    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3, "<mask>": 4}
    for s in bytes_to_unicode().values():
        if s not in vocab:
            vocab[s] = len(vocab)
    with open(out / "vocab.json", "w") as f:
        json.dump(vocab, f)
    with open(out / "merges.txt", "w") as f:
        f.write("#version: 0.2\nt h\nth e\n")
    # the reference ANCE hardcodes a 768-d head (src/models.py:27-28)
    cfg = ModelConfig.tiny(
        vocab_size=len(vocab) + 8, max_position_embeddings=80, embedding_dim=768
    )
    params = init_encoder_params(jax.random.PRNGKey(7), cfg)
    save_hf_checkpoint(params, cfg, str(out))
    return str(out), cfg, params


def _mini_topiocqa(path):
    """3 conversations x up to 3 turns; rel_label mixes exercise the PRL
    branch, the all-zero branch, and first turns."""
    docs = {
        1: "the cat sat on the mat",
        2: "dogs chase the red ball",
        3: "teapots hold hot tea",
        4: "a mouse hid under the chair",
        5: "rivers flow to the sea",
        6: "the moon orbits the earth",
    }
    recs = [
        # conv 1
        {"sample_id": "1_1", "cur_utt_text": "what do cats sit on",
         "last_response": "", "rel_label": [],
         "pos_docs": [docs[1]], "pos_docs_pids": [1]},
        {"sample_id": "1_2",
         "cur_utt_text": "what do cats sit on [SEP] the mat [SEP] and dogs chase what",
         "last_response": docs[1], "rel_label": [1],
         "pos_docs": [docs[2]], "pos_docs_pids": [2]},
        {"sample_id": "1_3",
         "cur_utt_text": "what do cats sit on [SEP] the mat [SEP] and dogs chase what [SEP] a red ball [SEP] where does tea go",
         "last_response": docs[2], "rel_label": [0, 1],
         "pos_docs": [docs[3]], "pos_docs_pids": [3]},
        # conv 2 (all-zero labels)
        {"sample_id": "2_1", "cur_utt_text": "where do rivers flow",
         "last_response": "", "rel_label": [],
         "pos_docs": [docs[5]], "pos_docs_pids": [5]},
        {"sample_id": "2_2",
         "cur_utt_text": "where do rivers flow [SEP] to the sea [SEP] what orbits the earth",
         "last_response": docs[5], "rel_label": [0],
         "pos_docs": [docs[6]], "pos_docs_pids": [6]},
    ]
    with open(path, "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")
    return recs, docs


def _ref_args(**kw):
    base = dict(
        is_train=False, use_PRL=False, is_PRF=False, PRF_top=1,
        max_query_length=16, max_doc_length=24, max_response_length=16,
        max_concat_length=48, hard_neg_type="bm25",
        is_pseudo_prepos=False,
    )
    base.update(kw)
    return Namespace(**base)


def _our_cfg(**kw):
    base = dict(
        dataset="topiocqa", is_train=False, use_PRL=False, is_PRF=False,
        PRF_top=1, max_query_length=16, max_doc_length=24,
        max_response_length=16, max_concat_length=48,
    )
    base.update(kw)
    return DataConfig(**base)


@pytest.mark.parametrize("use_prl", [False, True])
def test_conv_qp_tokens_match_reference(ref_modules, ckpt, tmp_path, use_prl):
    """The eval-side conversation concat (conv_qp) must be byte-identical
    to the reference Retrieval_topiocqa's flat_qp_concat
    (/root/reference/src/data.py:25-199)."""
    _, ref_data = ref_modules
    ckpt_dir, _, _ = ckpt
    tok = transformers.RobertaTokenizer.from_pretrained(ckpt_dir)
    test_file = tmp_path / "test.json"
    _mini_topiocqa(test_file)

    ref_ds = ref_data.Retrieval_topiocqa(
        _ref_args(use_PRL=use_prl), tok, str(test_file)
    )
    collate = ref_data.Retrieval_topiocqa.get_collate_fn(_ref_args(use_PRL=use_prl))
    ref_batch = collate([ref_ds[i] for i in range(len(ref_ds))])

    from haconvdr_tpu.data.topiocqa import build_topiocqa_test_examples

    ours = build_topiocqa_test_examples(
        _our_cfg(use_PRL=use_prl), tok, str(test_file)
    )
    assert len(ours) == len(ref_ds)
    ref_qp = np.asarray(ref_batch["bt_conv_qp"])
    ref_qp_mask = np.asarray(ref_batch["bt_conv_qp_mask"])
    ref_raw = np.asarray(ref_batch["bt_raw_query"])
    for i, ex in enumerate(ours):
        assert ref_batch["bt_sample_ids"][i] == ex["sample_id"]
        np.testing.assert_array_equal(ref_qp[i], np.asarray(ex["conv_qp"]),
                                      err_msg=f"conv_qp sample {i}")
        np.testing.assert_array_equal(ref_qp_mask[i], np.asarray(ex["conv_qp_mask"]))
        np.testing.assert_array_equal(ref_raw[i], np.asarray(ex["raw_query"]))


def test_query_embeddings_match_reference(ref_modules, ckpt, tmp_path):
    """Our JAX encoder on the reference dataset's token output must match
    the reference torch ANCE (src/models.py:20-64) in float64."""
    ref_models, ref_data = ref_modules
    ckpt_dir, mcfg, params = ckpt
    tok = transformers.RobertaTokenizer.from_pretrained(ckpt_dir)
    test_file = tmp_path / "test.json"
    _mini_topiocqa(test_file)

    ref_ds = ref_data.Retrieval_topiocqa(_ref_args(), tok, str(test_file))
    collate = ref_data.Retrieval_topiocqa.get_collate_fn(_ref_args())
    batch = collate([ref_ds[i] for i in range(len(ref_ds))])

    config = transformers.RobertaConfig.from_pretrained(ckpt_dir)
    ance = ref_models.ANCE.from_pretrained(ckpt_dir, config=config).double().eval()
    with torch.no_grad():
        ref_emb = ance.query_emb(
            batch["bt_conv_qp"], batch["bt_conv_qp_mask"]
        ).numpy()

    import dataclasses

    mcfg64 = dataclasses.replace(mcfg, dtype="float64")
    params64 = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64), params
    )
    ours = np.asarray(
        encode(
            params64, mcfg64,
            jnp.asarray(np.asarray(batch["bt_conv_qp"])),
            jnp.asarray(np.asarray(batch["bt_conv_qp_mask"])),
        )
    )
    np.testing.assert_allclose(ours, ref_emb, rtol=1e-8, atol=1e-8)


def test_trec_run_matches_reference_semantics(ref_modules, ckpt, tmp_path):
    """End-to-end run-file differential: the same embeddings pushed through
    (a) an inline oracle of the reference's brute-force + output_test_res
    dedup/format (src/test_HAConvDR_topiocqa.py:229-283, quirks included)
    and (b) our BlockSearcher + dedup_ranked_candidates + write_run must
    produce identical TREC files; metrics over both runs must agree."""
    ref_models, ref_data = ref_modules
    ckpt_dir, mcfg, params = ckpt
    tok = transformers.RobertaTokenizer.from_pretrained(ckpt_dir)
    test_file = tmp_path / "test.json"
    recs, docs = _mini_topiocqa(test_file)

    ref_ds = ref_data.Retrieval_topiocqa(_ref_args(), tok, str(test_file))
    collate = ref_data.Retrieval_topiocqa.get_collate_fn(_ref_args())
    batch = collate([ref_ds[i] for i in range(len(ref_ds))])
    qids = list(batch["bt_sample_ids"])

    # shared embeddings (ours, f32): queries from the REFERENCE's token
    # output; passages tokenized the same way both sides would
    q = np.asarray(encode(
        params, mcfg,
        jnp.asarray(np.asarray(batch["bt_conv_qp"])),
        jnp.asarray(np.asarray(batch["bt_conv_qp_mask"])),
    ), np.float32)
    pids = sorted(docs)
    from haconvdr_tpu.data.sequence import encode_trunc, pad_seq_to_length

    p_ids, p_masks = [], []
    for pid in pids:
        ids, mask = pad_seq_to_length(encode_trunc(tok, docs[pid], 24), 24)
        p_ids.append(ids)
        p_masks.append(mask)
    p = np.asarray(encode(
        params, mcfg, jnp.asarray(np.asarray(p_ids)), jnp.asarray(np.asarray(p_masks))
    ), np.float32)
    offset2pid = list(pids)
    # rank the full mini-corpus: the tiny random model yields near-tied
    # scores, and a selection boundary would make membership at rank k
    # accumulation-order-dependent rather than semantics-dependent
    top_k = len(pids)

    # (a) reference-semantics oracle: numpy brute force (faiss IndexFlatIP
    # order: by score desc) + output_test_res dedup and line format
    scores = q @ p.T
    order = np.argsort(-scores, axis=1, kind="stable")[:, :top_k]
    oracle_file = tmp_path / "oracle.trec"
    with open(oracle_file, "w") as g:
        for qi, qid in enumerate(qids):
            seen, rank = set(), 0
            ranked = [(0, 0.0)] * top_k
            for idx in order[qi]:
                pid = offset2pid[idx]
                if pid in seen:
                    continue
                ranked[rank] = (pid, float(scores[qi, idx]))
                rank += 1
                seen.add(pid)
            for i in range(top_k):
                pid, score = ranked[i]
                g.write(f"{qid} Q0 {pid} {i + 1} {-i - 1 + 200} {score} ance\n")

    # (b) the rebuild's components end to end
    from haconvdr_tpu.eval.trec import dedup_ranked_candidates, write_run
    from haconvdr_tpu.ops.topk import BlockSearcher

    searcher = BlockSearcher(top_k=top_k, passage_chunk=8)
    s2, i2 = searcher.search(q, [(p, np.arange(len(pids), dtype=np.int64))])
    ranked = dedup_ranked_candidates(qids, s2, i2, offset2pid, top_k)
    ours_file = tmp_path / "ours.trec"
    write_run(ranked, str(ours_file))

    oracle_lines = open(oracle_file).read().splitlines()
    ours_lines = open(ours_file).read().splitlines()
    assert len(oracle_lines) == len(ours_lines)
    per_q = {}
    for la, lb in zip(oracle_lines, ours_lines):
        fa, fb = la.split(), lb.split()
        # qid / Q0 / rank / 200-rank / tag columns are exact
        assert (fa[0], fa[1], fa[3], fa[4], fa[6]) == (
            fb[0], fb[1], fb[3], fb[4], fb[6]
        ), (la, lb)
        assert fa[6] == "ance"
        # scores agree to f32 accumulation-order tolerance (numpy oracle
        # matmul vs the on-device chunked matmul)
        sa, sb = float(fa[5]), float(fb[5])
        tol = 1e-5 * max(1.0, abs(sa))
        assert abs(sa - sb) <= tol, (la, lb)
        # pids may differ within score ties (extraction order is
        # implementation-defined); per-query set equality is checked below
        per_q.setdefault(fa[0], ([], []))
        per_q[fa[0]][0].append(fa[2])
        per_q[fa[0]][1].append(fb[2])
    for qid, (pa, pb) in per_q.items():
        assert sorted(pa) == sorted(pb), qid

    # metric agreement over the shared qrels
    qrel_file = tmp_path / "qrel.trec"
    with open(qrel_file, "w") as f:
        for r in recs:
            f.write(f"{r['sample_id']} 0 {r['pos_docs_pids'][0]} 1\n")
    from haconvdr_tpu.eval.trec import print_trec_res

    m1 = print_trec_res(str(oracle_file), str(qrel_file), rel_threshold=1)
    m2 = print_trec_res(str(ours_file), str(qrel_file), rel_threshold=1)
    # score ties in the tiny random model can move a gold passage by one
    # rank between the two accumulation orders; metrics must agree to that
    # tie wiggle (exact metric-harness parity is covered by
    # tests/test_metrics.py golden cases)
    for key in m1:
        assert abs(m1[key] - m2[key]) <= 2.0, (key, m1[key], m2[key])
    assert m1["MRR"] > 0 and m2["MRR"] > 0


def _mini_topiocqa_train(path):
    """Train-side fixture: the eval records plus the train-only fields.
    pseudo_prepos_docs / prepos_neg_docs stay EMPTY on purpose: the
    reference's non-empty branches are dead code (the record lists are
    shadowed by the just-initialized empty token lists at
    /root/reference/src/data.py:325-333, and the non-empty prepos branch
    hits the ``prepos_neg_docss`` NameError) — the differential covers the
    executable subset; the intended non-empty behavior is covered by the
    rebuild's own golden tests."""
    recs, docs = [], {
        1: "the cat sat on the mat",
        2: "dogs chase the red ball",
        3: "teapots hold hot tea",
        5: "rivers flow to the sea",
        6: "the moon orbits the earth",
    }
    base = [
        {"sample_id": "1_1", "cur_utt_text": "what do cats sit on",
         "last_response": "", "rel_label": [],
         "pos_docs": [docs[1]], "pos_docs_pids": [1],
         "bm25_hard_neg_docs": [docs[5]]},
        {"sample_id": "1_2",
         "cur_utt_text": "what do cats sit on [SEP] the mat [SEP] and dogs chase what",
         "last_response": docs[1], "rel_label": [1],
         "pos_docs": [docs[2]], "pos_docs_pids": [2],
         "bm25_hard_neg_docs": [docs[6]]},
        {"sample_id": "1_3",
         "cur_utt_text": "what do cats sit on [SEP] the mat [SEP] and dogs chase what [SEP] a red ball [SEP] where does tea go",
         "last_response": docs[2], "rel_label": [0, 1],
         "pos_docs": [docs[3]], "pos_docs_pids": [3],
         "bm25_hard_neg_docs": [docs[1]]},
        {"sample_id": "2_1", "cur_utt_text": "where do rivers flow",
         "last_response": "", "rel_label": [],
         "pos_docs": [docs[5]], "pos_docs_pids": [5],
         "bm25_hard_neg_docs": [docs[2]]},
        {"sample_id": "2_2",
         "cur_utt_text": "where do rivers flow [SEP] to the sea [SEP] what orbits the earth",
         "last_response": docs[5], "rel_label": [0],
         "pos_docs": [docs[6]], "pos_docs_pids": [6],
         "bm25_hard_neg_docs": [docs[3]]},
    ]
    for r in base:
        r["pseudo_prepos_docs"] = []
        r["prepos_neg_docs"] = []
        recs.append(r)
    with open(path, "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")
    return recs


@pytest.mark.parametrize("use_prl", [False, True])
def test_train_concat_matches_reference(ref_modules, ckpt, tmp_path, use_prl):
    """Train-side differential: Retrieval_topiocqa_new
    (/root/reference/src/data.py:253-335, the dataset every topiocqa train
    run uses) vs build_topiocqa_train_examples — conv_qp concat, masks and
    pos/bm25-neg doc tokenization must be byte-identical."""
    _, ref_data = ref_modules
    ckpt_dir, _, _ = ckpt
    tok = transformers.RobertaTokenizer.from_pretrained(ckpt_dir)
    train_file = tmp_path / "train.json"
    _mini_topiocqa_train(train_file)

    args = _ref_args(is_train=True, use_PRL=use_prl)
    ref_ds = ref_data.Retrieval_topiocqa_new(args, tok, str(train_file))
    collate = ref_data.Retrieval_topiocqa_new.get_collate_fn(args)
    ref_batch = collate([ref_ds[i] for i in range(len(ref_ds))])

    from haconvdr_tpu.data.topiocqa import build_topiocqa_train_examples

    ours = build_topiocqa_train_examples(
        _our_cfg(is_train=True, use_PRL=use_prl), tok, str(train_file)
    )
    assert len(ours) == len(ref_ds)
    for key, ref_key in [
        ("conv_qp", "bt_conv_qp"), ("conv_qp_mask", "bt_conv_qp_mask"),
        ("pos_docs", "bt_pos_docs"), ("pos_docs_mask", "bt_pos_docs_mask"),
        ("neg_docs", "bt_neg_docs"), ("neg_docs_mask", "bt_neg_docs_mask"),
    ]:
        ref_arr = np.asarray(ref_batch[ref_key])
        for i, ex in enumerate(ours):
            np.testing.assert_array_equal(
                ref_arr[i], np.asarray(ex[key]),
                err_msg=f"{key} sample {i} (use_PRL={use_prl})",
            )


@pytest.fixture()
def ref_train_module(ref_modules):
    """Load the reference train script itself (its loss functions are the
    training contract).  Its import chain needs: toml + tensorboardX stubs
    (not installed / pulls TF), bare-name modules ``models``/``data``/
    ``utils`` on sys.modules (the reference uses flat sys.path imports),
    and ``transformers.AdamW`` (removed upstream; utils.py:11 imports it —
    shimmed with torch.optim.AdamW, never called here)."""
    import types

    names = ("toml", "tensorboardX", "models", "utils", "data", "_ref_train")
    saved = {k: sys.modules.get(k) for k in names}
    had_adamw = True  # resolved against the live module inside try
    try:
        sys.modules["toml"] = types.ModuleType("toml")
        tbx = types.ModuleType("tensorboardX")
        tbx.SummaryWriter = object
        sys.modules["tensorboardX"] = tbx
        sys.modules["models"] = ref_modules[0]
        sys.modules["data"] = ref_modules[1]
        # loading models.py finalizes transformers' lazy init, which SWAPS
        # the sys.modules['transformers'] object — shim the CURRENT one,
        # immediately before utils.py's `from transformers import AdamW`
        tf_now = sys.modules["transformers"]
        had_adamw = hasattr(tf_now, "AdamW")
        if not had_adamw:
            tf_now.AdamW = torch.optim.AdamW
        _load_ref_module("utils", os.path.join(REF, "utils.py"))
        train = _load_ref_module(
            "_ref_train", os.path.join(REF, "train_HAConvDR_topiocqa.py")
        )
        yield train
    finally:
        for k in names:
            if saved[k] is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = saved[k]
        tf_now = sys.modules.get("transformers")
        if not had_adamw and tf_now is not None and hasattr(tf_now, "AdamW"):
            del tf_now.AdamW


def test_losses_match_reference(ref_train_module):
    """Loss differential against the reference's OWN cal_ranking_loss /
    cal_ranking_loss_prepos / cal_kd_loss
    (/root/reference/src/train_HAConvDR_topiocqa.py:47-79), across the
    hard_neg_type and is_pseudo_prepos/is_prepos_neg flag matrix."""
    import itertools

    from haconvdr_tpu.train.loss import kd_loss, ranking_loss, ranking_loss_prepos

    m = ref_train_module
    rng = np.random.RandomState(11)
    B, D = 6, 16
    q, pos, neg, pseudo, prepos = (
        rng.randn(B, D).astype(np.float32) for _ in range(5)
    )
    tq, tpos, tneg, tpseudo, tprepos = (
        torch.tensor(a) for a in (q, pos, neg, pseudo, prepos)
    )

    m.args = Namespace(hard_neg_type="bm25", device="cpu")
    ref = float(m.cal_ranking_loss(tq, tpos, tneg))
    ours = float(ranking_loss(jnp.asarray(q), jnp.asarray(pos), jnp.asarray(neg)))
    assert abs(ref - ours) < 1e-5, (ref, ours)

    m.args = Namespace(hard_neg_type=None, device="cpu")
    ref = float(m.cal_ranking_loss(tq, tpos, tneg))
    ours = float(ranking_loss(jnp.asarray(q), jnp.asarray(pos), None))
    assert abs(ref - ours) < 1e-5, (ref, ours)

    for isp, ipn in itertools.product([False, True], repeat=2):
        m.args = Namespace(
            is_pseudo_prepos=isp, is_prepos_neg=ipn, alpha=0.5, device="cpu"
        )
        ref = float(
            m.cal_ranking_loss_prepos(
                tq, tpos, tneg,
                pseudo_prepos_embs=tpseudo if isp else None,
                prepos_neg_doc_embs=tprepos if ipn else None,
            )
        )
        ours = float(
            ranking_loss_prepos(
                jnp.asarray(q), jnp.asarray(pos), jnp.asarray(neg),
                pseudo_prepos_embs=jnp.asarray(pseudo) if isp else None,
                prepos_neg_doc_embs=jnp.asarray(prepos) if ipn else None,
                alpha=0.5, is_pseudo_prepos=isp, is_prepos_neg=ipn,
            )
        )
        assert abs(ref - ours) < 1e-5, (isp, ipn, ref, ours)

    ref = float(m.cal_kd_loss(tq, tpos))
    ours = float(kd_loss(jnp.asarray(q), jnp.asarray(pos)))
    assert abs(ref - ours) < 1e-5, (ref, ours)


def test_prj_probe_generation_matches_reference(tmp_path):
    """L1 differential: the reference's create_label_rel_turn
    (/root/reference/preprocess/PRJ_topiocqa.py:238-300, a pure file
    transform) vs mine/prj.create_label_rel_turn — identical probe
    records for identical inputs."""
    ref_prj = _load_ref_or_skip("_ref_prj", "/root/reference/preprocess/PRJ_topiocqa.py")

    recs = []
    for conv in (1, 2):
        for turn in (1, 2, 3):
            recs.append({
                "id": f"{conv}-{turn}",
                "conv_id": conv, "turn_id": turn,
                "history_query": [f"q{conv}-{t}" for t in range(1, turn)],
                "history_rewrite": [f"r{conv}-{t}" for t in range(1, turn)],
                "history_answer": [f"a{conv}-{t}" for t in range(1, turn)],
                "last_response": f"resp{conv}-{turn}",
                "topic": "T", "sub_topic": "S",
                "query": f"q{conv}-{turn}", "rewrite": f"r{conv}-{turn}",
                "answer": f"a{conv}-{turn}",
                "pos_docs": [f"doc{conv}{turn}"], "pos_docs_id": [conv * 10 + turn],
            })
    inp = tmp_path / "in.jsonl"
    with open(inp, "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")
    out = tmp_path / "ref_out.jsonl"
    ref_prj.create_label_rel_turn(str(inp), str(out))
    ref_probes = [json.loads(l) for l in open(out)]

    from haconvdr_tpu.mine.prj import create_label_rel_turn

    ours = create_label_rel_turn(recs)
    assert len(ours) == len(ref_probes)
    ref_by_id = {p["id"]: p for p in ref_probes}
    for p in ours:
        ref_p = ref_by_id[p["id"]]
        for key in ref_p:  # every reference field must exist and match
            assert key in p and p[key] == ref_p[key], (p["id"], key)


def test_l0_preprocess_matches_reference(tmp_path, monkeypatch):
    """L0 differential: gen_topiocqa_qrel + gen_train_test_files vs the
    reference's own implementations
    (/root/reference/preprocess/preprocess_topicoqa.py:7-161) on a
    fabricated gold dump.  All deterministic fields must match exactly;
    the random negative is compared semantically (the reference's module
    random.choice is pinned to seq[0] so its 25.7M-pid draw stays inside
    the tiny fixture collection).  One DOCUMENTED divergence is pinned:
    the reference's dev loop never resets last_response at a conversation
    boundary (:108-118 lacks the train loop's reset), leaking the
    previous conversation's response into the next conversation's first
    turn; the rebuild resets it."""
    ref_pre = _load_ref_or_skip("_ref_pre", "/root/reference/preprocess/preprocess_topicoqa.py")

    def turn(conv, t, pid, q):
        return {
            "conv_id": conv, "turn_id": t, "question": q,
            "answers": [f"answer {conv}-{t}"],
            "positive_ctxs": [{
                "passage_id": str(pid),
                "title": f"Title{pid} [SEP] Sub{pid}",
                "text": f"passage text {pid}  ",
            }],
        }

    train = [turn(1, 1, 1, "first q"), turn(1, 2, 2, "second q"),
             turn(2, 1, 3, "other conv q"), turn(2, 2, 4, "other conv q2")]
    dev = [turn(5, 1, 5, "dev q1"), turn(5, 2, 6, "dev q2"),
           turn(6, 1, 2, "dev conv2 q1")]
    (tmp_path / "gold_train.json").write_text(json.dumps(train))
    (tmp_path / "gold_dev.json").write_text(json.dumps(dev))
    with open(tmp_path / "collection.tsv", "w") as f:
        f.write("id\ttext\ttitle\n")
        for pid in range(0, 8):  # includes pid 0 for the pinned random draw
            f.write(f"{pid}\tpassage text {pid}\tTitle{pid} [SEP] Sub{pid}\n")

    # pin the reference's random.choice (module-level) to the first element
    monkeypatch.setattr(ref_pre.random, "choice", lambda seq: seq[0])
    ref_train = tmp_path / "ref_train.json"
    ref_test = tmp_path / "ref_test.json"
    ref_pre.gen_train_test_files(
        str(tmp_path / "gold_train.json"), str(tmp_path / "gold_dev.json"),
        str(ref_train), str(ref_test), str(tmp_path / "collection.tsv"),
    )
    ref_qrel = tmp_path / "ref_qrel.trec"
    ref_pre.gen_topiocqa_qrel(str(tmp_path / "gold_dev.json"), str(ref_qrel))

    from haconvdr_tpu.preprocess import topiocqa as ours

    our_train = tmp_path / "our_train.json"
    our_test = tmp_path / "our_test.json"
    ours.gen_train_test_files(
        str(tmp_path / "gold_train.json"), str(tmp_path / "gold_dev.json"),
        str(our_train), str(our_test),
        collection_file_path=str(tmp_path / "collection.tsv"),
    )
    our_qrel = tmp_path / "our_qrel.trec"
    ours.gen_topiocqa_qrel(str(tmp_path / "gold_dev.json"), str(our_qrel))

    assert open(our_qrel).read() == open(ref_qrel).read()

    for ref_path, our_path, split in (
        (ref_train, our_train, "train"), (ref_test, our_test, "test"),
    ):
        ref_recs = [json.loads(l) for l in open(ref_path)]
        our_recs = [json.loads(l) for l in open(our_path)]
        assert len(ref_recs) == len(our_recs)
        for i, (a, b) in enumerate(zip(ref_recs, our_recs)):
            det = ["sample_id", "cur_utt_text", "pos_docs", "pos_docs_pids"]
            is_dev_conv_boundary = split == "test" and b["sample_id"].endswith("_6_1")
            if not is_dev_conv_boundary:
                det.append("last_response")
            else:
                # the pinned divergence: reference leaks, rebuild resets
                assert a["last_response"] != "" and b["last_response"] == ""
            for key in det:
                assert a[key] == b[key], (split, i, key)
            assert sorted(a["prepos_neg_docs_pids"]) == sorted(
                b["prepos_neg_docs_pids"]
            )
            # negative: when prepos negatives exist both must draw from them
            if a["prepos_neg_docs_pids"]:
                assert b["neg_docs_pids"][0] in a["prepos_neg_docs_pids"]


def test_l0_merge_and_reformulate_match_reference(tmp_path):
    """L0 differential for the enrichment steps that assemble
    train_with_info.json: merge_rel_label_info and merge_bm25_neg_info
    must match the reference byte-for-byte
    (preprocess_topicoqa.py:163-211); reformulate_dataset_info pins the
    reference's known indexing defect (``data[i - idx]`` includes the
    CURRENT turn at idx=0; intended mapping is i-(len-idx), the same
    convention the train reader uses, src/data.py:284-290)."""
    ref_pre = _load_ref_or_skip("_ref_pre2", "/root/reference/preprocess/preprocess_topicoqa.py")

    from haconvdr_tpu.preprocess import topiocqa as ours

    # PRJ-stage records use 'conv-turn' sample ids (combine_topiocqa_data)
    recs = [
        {"sample_id": "1-1", "cur_utt_text": "q11", "last_response": "",
         "pos_docs": ["D11"], "pos_docs_pids": [11],
         "prepos_neg_docs_pids": []},
        {"sample_id": "1-2", "cur_utt_text": "q12", "last_response": "D11",
         "pos_docs": ["D12"], "pos_docs_pids": [12],
         "prepos_neg_docs_pids": [11]},
        {"sample_id": "1-3", "cur_utt_text": "q13", "last_response": "D12",
         "pos_docs": ["D13"], "pos_docs_pids": [13],
         "prepos_neg_docs_pids": [11, 12]},
    ]
    orig = tmp_path / "orig.json"
    with open(orig, "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")
    rel = tmp_path / "rel.json"
    with open(rel, "w") as f:
        for r, label in zip(recs, ([], [1], [0, 1])):
            f.write(json.dumps({"id": r["sample_id"], "rel_label": label}) + "\n")

    ref_out = tmp_path / "ref_rel.json"
    our_out = tmp_path / "our_rel.json"
    ref_pre.merge_rel_label_info(str(rel), str(orig), str(ref_out))
    ours.merge_rel_label_info(str(rel), str(orig), str(our_out))
    assert [json.loads(l) for l in open(ref_out)] == [
        json.loads(l) for l in open(our_out)
    ]

    run = tmp_path / "bm25.trec"
    with open(run, "w") as f:
        for r in recs:
            for rank, pid in enumerate([r["pos_docs_pids"][0], 90, 91]):
                f.write(f"{r['sample_id']} Q0 {pid} {rank+1} {10-rank} bm25\n")
    ref_out2 = tmp_path / "ref_neg.json"
    our_out2 = tmp_path / "our_neg.json"
    ref_pre.merge_bm25_neg_info(str(run), str(ref_out), str(ref_out2))
    ours.merge_bm25_neg_info(str(run), str(our_out), str(our_out2))
    ref_neg = [json.loads(l) for l in open(ref_out2)]
    our_neg = [json.loads(l) for l in open(our_out2)]
    assert ref_neg == our_neg
    assert ref_neg[0]["bm25_hard_neg_docs_pids"] == [90, 91]  # pos filtered

    # reformulate: add the doc-content field both variants read
    enriched = tmp_path / "enriched.json"
    with open(enriched, "w") as f:
        for r in ref_neg:
            r = dict(r)
            r["bm25_hard_neg_docs"] = [f"N{p}" for p in r["bm25_hard_neg_docs_pids"]]
            f.write(json.dumps(r) + "\n")
    ref_final = tmp_path / "ref_final.json"
    our_final = tmp_path / "our_final.json"
    ref_pre.reformulate_dataset_info(str(enriched), str(ref_final), str(enriched))
    ours.reformulate_dataset_info(str(enriched), str(our_final))
    ref_f = [json.loads(l) for l in open(ref_final)]
    our_f = [json.loads(l) for l in open(our_final)]
    for a, b in zip(ref_f, our_f):
        for key in ("sample_id", "cur_utt_text", "last_response", "pos_docs",
                    "pos_docs_pids", "bm25_hard_neg_docs",
                    "bm25_hard_neg_docs_pids", "rel_label"):
            assert a[key] == b[key], key
    # the pinned indexing divergence on record '1-2' (rel_label [1]):
    # reference reads data[i - 0] = the CURRENT record's positives; the
    # rebuild reads the history turn (record '1-1')
    assert ref_f[1]["pseudo_prepos_docs_pids"] == [12]  # self-reference
    assert our_f[1]["pseudo_prepos_docs_pids"] == [11]  # true history turn


def test_prf_selection_matches_reference(tmp_path):
    """PRF selection differential: select_pseudo_relevant_feedback_passage
    vs the reference's (preprocess_topicoqa.py:315-375) on fabricated
    aligned BM25/ANCE runs covering the three selection regimes (disjoint
    runs, heavy overlap, partial overlap)."""
    ref_pre = _load_ref_or_skip("_ref_pre3", "/root/reference/preprocess/preprocess_topicoqa.py")

    rng = np.random.RandomState(5)
    bm25_path = tmp_path / "bm25.trec"
    ance_path = tmp_path / "ance.trec"
    with open(bm25_path, "w") as fb, open(ance_path, "w") as fa:
        # q1: disjoint runs; q2: identical runs; q3: partial overlap
        for qid, (b_base, a_base, overlap) in {
            "q1": (1000, 2000, 0.0), "q2": (3000, 3000, 1.0),
            "q3": (4000, 5000, 0.4),
        }.items():
            b_pids = list(range(b_base, b_base + 100))
            a_pids = list(range(a_base, a_base + 100))
            if 0 < overlap < 1:
                take = int(100 * overlap)
                mix = rng.permutation(100)[:take]
                for j, m in enumerate(mix):
                    a_pids[m] = b_pids[(m * 7) % 100]
            for r in range(100):
                fb.write(f"{qid} Q0 {b_pids[r]} {r+1} {200-r} bm25\n")
                fa.write(f"{qid} Q0 {a_pids[r]} {r+1} {300-r} ance\n")

    ref_pos, ref_neg = ref_pre.select_pseudo_relevant_feedback_passage(
        str(bm25_path), str(ance_path), neg_ratio=3
    )
    from haconvdr_tpu.preprocess.topiocqa import (
        select_pseudo_relevant_feedback_passage,
    )

    our_pos, our_neg = select_pseudo_relevant_feedback_passage(
        str(bm25_path), str(ance_path), neg_ratio=3
    )
    assert ref_pos == our_pos
    assert ref_neg == our_neg


def test_prf_merge_matches_reference(tmp_path):
    """PRF merge differential: merge_pseudo_relevant_feedback vs the
    reference's (preprocess_topicoqa.py:377-422).  The reference reads the
    undefined name ``collection_file_path`` instead of its parameter
    (documented defect) — set as a module global here so its own code
    path executes; outputs must then match byte-for-byte."""
    ref_pre = _load_ref_or_skip("_ref_pre4", "/root/reference/preprocess/preprocess_topicoqa.py")

    # runs: 100 aligned ranks per qid, partially overlapping
    qids = ["7-2", "7-3"]
    bm25_path = tmp_path / "bm25.trec"
    ance_path = tmp_path / "ance.trec"
    all_pids = set()
    with open(bm25_path, "w") as fb, open(ance_path, "w") as fa:
        for base, qid in zip((1000, 3000), qids):
            b_pids = list(range(base, base + 100))
            a_pids = list(range(base + 50, base + 150))  # 50% overlap
            all_pids |= set(b_pids) | set(a_pids)
            for r in range(100):
                fb.write(f"{qid} Q0 {b_pids[r]} {r+1} {200-r} bm25\n")
                fa.write(f"{qid} Q0 {a_pids[r]} {r+1} {300-r} ance\n")
    collection = tmp_path / "collection.tsv"
    with open(collection, "w") as f:
        f.write("id\ttext\ttitle\n")
        for pid in sorted(all_pids):
            f.write(f"{pid}\ttext {pid}\tT{pid} [SEP] S{pid}\n")
    queries = tmp_path / "queries.json"
    with open(queries, "w") as f:
        for qid in qids:
            f.write(json.dumps({"sample_id": qid, "cur_utt_text": "q"}) + "\n")

    ref_out = tmp_path / "ref_prf.json"
    ref_pre.collection_file_path = str(collection)  # the reference's bug
    ref_pre.merge_pseudo_relevant_feedback(
        str(queries), str(ance_path), str(bm25_path), str(collection), str(ref_out)
    )

    from haconvdr_tpu.preprocess.topiocqa import merge_pseudo_relevant_feedback

    our_out = tmp_path / "our_prf.json"
    merge_pseudo_relevant_feedback(
        str(queries), str(ance_path), str(bm25_path), str(collection), str(our_out)
    )
    ref_recs = [json.loads(l) for l in open(ref_out)]
    our_recs = [json.loads(l) for l in open(our_out)]
    assert ref_recs == our_recs


def test_prj_token_probes_and_gold_trec_match_reference(tmp_path):
    """Token-level probe generation (create_label_rel_token,
    /root/reference/preprocess/PRJ_topiocqa.py:302-353) and the gold->trec
    converter (:455-468) vs the reference's own file transforms."""
    ref_prj = _load_ref_or_skip("_ref_prj2", "/root/reference/preprocess/PRJ_topiocqa.py")

    recs = [
        {"id": "3-1", "conv_id": 3, "turn_id": 1, "history_query": [],
         "history_answer": [], "query": "first", "answer": "a1",
         "pos_docs_id": [31]},
        {"id": "3-2", "conv_id": 3, "turn_id": 2,
         "history_query": ["what is  jax", "who wrote it"],
         "history_answer": ["a lib", "google"],
         "query": "second q", "answer": "a2", "pos_docs_id": [32]},
    ]
    inp = tmp_path / "in.jsonl"
    with open(inp, "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")
    ref_out = tmp_path / "ref_tok.jsonl"
    ref_prj.create_label_rel_token(str(inp), str(ref_out))
    ref_probes = [json.loads(l) for l in open(ref_out)]

    from haconvdr_tpu.mine.prj import convert_gold_to_trec, create_label_rel_token

    ours = create_label_rel_token(recs)
    assert len(ours) == len(ref_probes)
    for a, b in zip(ref_probes, ours):
        for key in a:
            assert a[key] == b[key], (a["id"], key)

    trec_out = tmp_path / "ref_gold.trec"
    ref_prj.convert_gold_to_trec(str(ref_out), str(trec_out))
    ref_lines = open(trec_out).read().splitlines()
    # the reference writes 'id Q0 pid 1'; ours emits the same lines
    assert convert_gold_to_trec(ref_probes) == ref_lines


@pytest.mark.parametrize("mode", ["topic", "sub_topic"])
def test_topic_oracle_labels_match_reference(tmp_path, mode):
    """Topic-oracle rel labels (create_topic_rel_turn,
    /root/reference/preprocess/PRJ_topiocqa.py:355-418) vs the rebuild."""
    ref_prj = _load_ref_or_skip("_ref_prj3", "/root/reference/preprocess/PRJ_topiocqa.py")

    def rec(conv, t, topic, sub):
        return {"id": f"{conv}-{t}", "conv_id": conv, "turn_id": t,
                "history_query": [], "topic": topic, "sub_topic": sub,
                "query": f"q{conv}{t}"}

    recs = [rec(1, 1, "A", "a1"), rec(1, 2, "A", "a2"), rec(1, 3, "B", "a2"),
            rec(2, 1, "C", "c"), rec(2, 2, "C", "c")]
    inp = tmp_path / "in.jsonl"
    with open(inp, "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")
    out = tmp_path / "ref.jsonl"
    ref_prj.create_topic_rel_turn(str(inp), str(out), mode)
    ref_labels = [json.loads(l) for l in open(out)]

    from haconvdr_tpu.mine.prj import create_topic_rel_turn

    ours = create_topic_rel_turn(recs, mode=mode)
    assert ours == ref_labels


def test_prj_triples_match_reference(tmp_path):
    """Classifier-training triples (create_PRJ,
    /root/reference/preprocess/PRJ_topiocqa.py:470-504) vs
    mine/prj.create_prj_triples."""
    ref_prj = _load_ref_or_skip("_ref_prj4", "/root/reference/preprocess/PRJ_topiocqa.py")

    labels = [
        {"id": "4-1", "conv_id": 4, "turn_id": 1, "rel_label": []},
        {"id": "4-2", "conv_id": 4, "turn_id": 2, "rel_label": [1]},
        {"id": "4-3", "conv_id": 4, "turn_id": 3, "rel_label": [0, 1]},
    ]
    queries = [
        {"query": "q1", "history_query": [], "last_response": ""},
        {"query": "q2", "history_query": ["q1"], "last_response": "r1"},
        {"query": "q3", "history_query": ["q1", "q2"], "last_response": "r2"},
    ]
    lf = tmp_path / "labels.jsonl"
    qf = tmp_path / "queries.jsonl"
    for p, rows in ((lf, labels), (qf, queries)):
        with open(p, "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    out = tmp_path / "ref_triples.jsonl"
    ref_prj.create_PRJ(str(lf), str(qf), str(out))
    ref_triples = [json.loads(l) for l in open(out)]

    from haconvdr_tpu.mine.prj import create_prj_triples

    ours = create_prj_triples(labels, queries)
    assert len(ours) == len(ref_triples)
    for a, b in zip(ref_triples, ours):
        for key in a:
            assert a[key] == b[key], (a["id"], key)


def test_prj_qrecc_probes_match_reference(tmp_path):
    """QReCC probe generation differential (create_label_rel_turn,
    /root/reference/preprocess/PRJ_qrecc.py:17-66): empty-positive turns
    skipped, 'conv-turn' id parsing, last_response carried."""
    ref_prj = _load_ref_or_skip("_ref_prjq", "/root/reference/preprocess/PRJ_qrecc.py")

    recs = [
        {"sample_id": "9-1", "context_queries": [], "query": "q1",
         "oracle_query": "o1", "last_response": "", "pos_docs": [91]},
        {"sample_id": "9-2", "context_queries": ["q1"], "query": "q2",
         "oracle_query": "o2", "last_response": "r1", "pos_docs": [92]},
        {"sample_id": "9-3", "context_queries": ["q1", "q2"], "query": "q3",
         "oracle_query": "o3", "last_response": "r2", "pos_docs": []},  # skipped
        {"sample_id": "9-4", "context_queries": ["q1", "q2", "q3"], "query": "q4",
         "oracle_query": "o4", "last_response": "r3", "pos_docs": [94]},
    ]
    inp = tmp_path / "in.jsonl"
    with open(inp, "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")
    out = tmp_path / "ref.jsonl"
    ref_prj.create_label_rel_turn(str(inp), str(out))
    ref_probes = [json.loads(l) for l in open(out)]

    from haconvdr_tpu.mine.prj import create_label_rel_turn

    ours = create_label_rel_turn(recs, dataset="qrecc")
    assert len(ours) == len(ref_probes)
    for a, b in zip(ref_probes, ours):
        for key in a:
            assert a[key] == b[key], (a["id"], key)


def test_improve_judge_matches_reference(tmp_path):
    """The PRJ labeling rule itself (improve_judge,
    /root/reference/src/test_PRJ_topiocqa.py:443-472) — extracted via AST
    (its module imports faiss, not installed) and run against the rebuild
    on identical probe scores.  This is the MRR-diff rule that makes the
    pipeline 'history-aware'."""
    import ast as ast_mod

    path = os.path.join(REF, "test_PRJ_topiocqa.py")
    if not os.path.exists(path):
        pytest.skip("reference tree not mounted")
    tree = ast_mod.parse(open(path).read())
    fn = next(
        n for n in tree.body
        if isinstance(n, ast_mod.FunctionDef) and n.name == "improve_judge"
    )
    ns = {"json": json}
    exec(compile(ast_mod.Module(body=[fn], type_ignores=[]), path, "exec"), ns)
    ref_improve = ns["improve_judge"]

    # probes in the reference's file order: conv 1 turns 2-3, conv 2 turn 2
    probes = [
        {"id": "1-2-0"}, {"id": "1-2-1"},
        {"id": "1-3-0"}, {"id": "1-3-1"}, {"id": "1-3-2"},
        {"id": "2-2-0"}, {"id": "2-2-1"},
    ]
    scores = [0.5, 0.7, 0.25, 0.1, 0.3, 1.0, 1.0]
    probe_file = tmp_path / "probes.jsonl"
    with open(probe_file, "w") as f:
        for p in probes:
            f.write(json.dumps(p) + "\n")
    ref_labels = ref_improve(str(probe_file), scores)

    from haconvdr_tpu.mine.prj import improve_judge

    ours = improve_judge(probes, {p["id"]: s for p, s in zip(probes, scores)})
    assert ours == ref_labels
    # spot-check the rule itself: 0.7 > 0.5 -> 1; 0.1 < 0.25 -> 0; tie -> 0
    assert ref_labels["1-2"] == [1]
    assert ref_labels["1-3"] == [0, 1]
    assert ref_labels["2-2"] == [0]


def _mini_qrecc(path):
    """QReCC train fixture: ctx q/a alternation, PRL labels, live
    pseudo/prepos lists kept single-element so random.choice is
    deterministic, plus one empty-positive record (skipped by both)."""
    recs = [
        {"sample_id": "QReCC-Train_3_1", "cur_utt_text": "what is jax",
         "cur_response_text": "a library", "ctx_utts_text": [],
         "pos_docs_text": ["jax is a library for arrays"],
         "bm25_hard_neg_docs": ["dogs chase balls"],
         "pseudo_prepos_docs": [], "prepos_neg_docs": [], "rel_label": []},
        {"sample_id": "QReCC-Train_3_2", "cur_utt_text": "who wrote it",
         "cur_response_text": "google", "ctx_utts_text": ["what is jax", "a library"],
         "pos_docs_text": ["google wrote jax"],
         "bm25_hard_neg_docs": ["cats sit on mats"],
         "pseudo_prepos_docs": ["jax is a library for arrays"],
         "prepos_neg_docs": ["dogs chase balls"], "rel_label": [1]},
        {"sample_id": "QReCC-Train_3_3", "cur_utt_text": "skipped",
         "cur_response_text": "", "ctx_utts_text": ["a", "b", "c", "d"],
         "pos_docs_text": [], "bm25_hard_neg_docs": ["x"],
         "pseudo_prepos_docs": [], "prepos_neg_docs": [], "rel_label": [0, 0]},
        {"sample_id": "QReCC-Train_3_4", "cur_utt_text": "and when",
         "cur_response_text": "", "ctx_utts_text": ["q1", "a1", "q2", "a2", "q3", "a3"],
         "pos_docs_text": ["released in two thousand eighteen"],
         "bm25_hard_neg_docs": ["rivers flow to the sea"],
         "pseudo_prepos_docs": [], "prepos_neg_docs": ["cats sit on mats"],
         "rel_label": [0, 1, 0]},
    ]
    with open(path, "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")
    return recs


@pytest.mark.parametrize("use_prl", [False, True])
def test_qrecc_train_concat_matches_reference(ref_modules, ckpt, tmp_path, use_prl):
    """QReCC train-side differential: Retrieval_qrecc_new
    (/root/reference/src/data.py:508-605) vs build_qrecc_examples —
    conv_qa concat, masks and all four doc fields (the qrecc pseudo/
    prepos branches are LIVE, unlike topiocqa's shadowed ones; kept
    deterministic with single-element lists)."""
    _, ref_data = ref_modules
    ckpt_dir, _, _ = ckpt
    tok = transformers.RobertaTokenizer.from_pretrained(ckpt_dir)
    train_file = tmp_path / "qrecc_train.json"
    _mini_qrecc(train_file)

    args = _ref_args(is_train=True, use_PRL=use_prl, max_concat_length=40)
    ref_ds = ref_data.Retrieval_qrecc_new(args, tok, str(train_file))
    collate = ref_data.Retrieval_qrecc_new.get_collate_fn(args)
    ref_batch = collate([ref_ds[i] for i in range(len(ref_ds))])

    from haconvdr_tpu.data.qrecc import build_qrecc_examples

    ours = build_qrecc_examples(
        _our_cfg(dataset="qrecc", is_train=True, use_PRL=use_prl,
                 max_concat_length=40),
        tok, str(train_file),
    )
    assert len(ours) == len(ref_ds) == 3  # empty-positive record skipped
    # always-present fields compare unconditionally
    for key, ref_key in [
        ("conv_qa", "bt_conv_qa"), ("conv_qa_mask", "bt_conv_qa_mask"),
        ("pos_docs", "bt_pos_docs"), ("pos_docs_mask", "bt_pos_docs_mask"),
        ("neg_docs", "bt_neg_docs"), ("neg_docs_mask", "bt_neg_docs_mask"),
    ]:
        ref_arr = ref_batch[ref_key]
        for i, ex in enumerate(ours):
            np.testing.assert_array_equal(
                np.asarray(ref_arr[i]), np.asarray(ex[key]),
                err_msg=f"{key} sample {i} (use_PRL={use_prl})",
            )
    # the LIVE pseudo/prepos branches, compared against the RAW dataset
    # examples (the reference's collate mangles ragged lists — examples
    # mix [] and [L]); ours pads to [L] with a presence flag
    for key, ref_idx in [
        ("pseudo_prepos_docs", 7), ("prepos_neg_docs", 9),
    ]:
        flag = {"pseudo_prepos_docs": "has_pseudo_prepos",
                "prepos_neg_docs": "has_prepos_neg"}[key]
        non_empty = 0
        for i, ex in enumerate(ours):
            a = np.asarray(ref_ds[i][ref_idx])
            assert (a.size > 0) == bool(ex[flag]), (key, i)
            if a.size:
                non_empty += 1
                np.testing.assert_array_equal(
                    a, np.asarray(ex[key]),
                    err_msg=f"{key} sample {i} (use_PRL={use_prl})",
                )
        assert non_empty >= 1, key  # the fixture's carrying records fire


def test_cast_eval_concat_matches_reference(ref_modules, ckpt, tmp_path):
    """TREC-CAsT eval differential: Test_Retrieval_cast
    (/root/reference/src/data.py:648-743) vs build_cast_test_examples —
    conv_q and conv_qp concats across the manual-response (conv>80) and
    plain branches (manual responses kept single-element so
    random.choice is deterministic)."""
    _, ref_data = ref_modules
    ckpt_dir, _, _ = ckpt
    tok = transformers.RobertaTokenizer.from_pretrained(ckpt_dir)
    recs = [
        {"id": "79_1", "topic_number": 79, "query_number": 1,
         "input": ["what are teapots"], "manual_response": []},
        {"id": "79_2", "topic_number": 79, "query_number": 2,
         "input": ["what are teapots", "and kettles"], "manual_response": []},
        {"id": "81_1", "topic_number": 81, "query_number": 1,
         "input": ["where do rivers flow"],
         "manual_response": ["rivers flow to the sea"]},
        {"id": "81_2", "topic_number": 81, "query_number": 2,
         "input": ["where do rivers flow", "and lakes"],
         "manual_response": ["lakes drain into rivers"]},
        {"id": "81_3", "topic_number": 81, "query_number": 3,
         "input": ["where do rivers flow", "and lakes", "what about seas"],
         "manual_response": []},
    ]
    cast_file = tmp_path / "cast.json"
    with open(cast_file, "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")

    args = _ref_args(max_concat_length=40)
    ref_ds = ref_data.Test_Retrieval_cast(args, tok, str(cast_file))
    collate = ref_data.Test_Retrieval_cast.get_collate_fn(args)
    ref_batch = collate([ref_ds[i] for i in range(len(ref_ds))])

    from haconvdr_tpu.data.cast import build_cast_test_examples

    ours = build_cast_test_examples(
        _our_cfg(dataset="cast", max_concat_length=40), tok, str(cast_file)
    )
    assert len(ours) == len(ref_ds)
    for key, ref_key in [
        ("conv_q", "bt_conv_q"), ("conv_q_mask", "bt_conv_q_mask"),
        ("conv_qp", "bt_conv_qp"), ("conv_qp_mask", "bt_conv_qp_mask"),
    ]:
        ref_arr = np.asarray(ref_batch[ref_key])
        for i, ex in enumerate(ours):
            np.testing.assert_array_equal(
                ref_arr[i], np.asarray(ex[key]), err_msg=f"{key} sample {i}"
            )


def test_qrecc_eval_and_multineg_match_reference(ref_modules, ckpt, tmp_path):
    """Eval-side Retrieval_qrecc (/root/reference/src/data.py:381-460,
    is_train=False) and the multi-negative Retrieval_qrecc_negs
    (:745-818) vs the rebuild's builders (single-element positives keep
    random.choice deterministic)."""
    _, ref_data = ref_modules
    ckpt_dir, _, _ = ckpt
    tok = transformers.RobertaTokenizer.from_pretrained(ckpt_dir)
    train_file = tmp_path / "qrecc.json"
    recs = _mini_qrecc(train_file)
    # multineg wants a per-record hard-negative LIST
    negs_file = tmp_path / "qrecc_negs.json"
    with open(negs_file, "w") as f:
        for r in recs:
            r = dict(r)
            r["bm25_hard_neg_docs"] = [
                r["bm25_hard_neg_docs"][0], "another hard negative"
            ]
            f.write(json.dumps(r) + "\n")

    # eval-side conv_qa
    args = _ref_args(is_train=False, max_concat_length=40)
    ref_ds = ref_data.Retrieval_qrecc(args, tok, str(train_file))
    collate = ref_data.Retrieval_qrecc.get_collate_fn(args)
    ref_batch = collate([ref_ds[i] for i in range(len(ref_ds))])

    from haconvdr_tpu.data.qrecc import (
        build_qrecc_examples,
        build_qrecc_multineg_examples,
    )

    ours = build_qrecc_examples(
        _our_cfg(dataset="qrecc", is_train=False, max_concat_length=40),
        tok, str(train_file),
    )
    assert len(ours) == len(ref_ds)
    ref_qa = np.asarray(ref_batch["bt_conv_qa"])
    for i, ex in enumerate(ours):
        np.testing.assert_array_equal(ref_qa[i], np.asarray(ex["conv_qa"]))

    # multineg: same concat + per-neg tokenization, reference keeps ALL
    # negatives ragged; ours clamps/pads to num_negs with a count
    args = _ref_args(is_train=True, max_concat_length=40)
    ref_negs = ref_data.Retrieval_qrecc_negs(args, tok, str(negs_file))
    ours_negs = build_qrecc_multineg_examples(
        _our_cfg(dataset="qrecc", is_train=True, max_concat_length=40),
        tok, str(negs_file), num_negs=2,
    )
    assert len(ours_negs) == len(ref_negs)
    for i, ex in enumerate(ours_negs):
        sample = ref_negs[i]
        np.testing.assert_array_equal(
            np.asarray(sample[1]), np.asarray(ex["conv_qa"])
        )
        np.testing.assert_array_equal(
            np.asarray(sample[3]), np.asarray(ex["pos_docs"])
        )
        ref_neg_tok = np.asarray(sample[5][0])  # [R, L] ragged list
        assert int(ex["num_negs"]) == ref_neg_tok.shape[0]
        np.testing.assert_array_equal(
            ref_neg_tok, np.asarray(ex["neg_docs"])[: ref_neg_tok.shape[0]]
        )


def test_qrecc_l0_preprocess_matches_reference(tmp_path):
    """QReCC L0 differential: gen_qrecc_qrel + gen_qrecc_train_test_files
    vs the reference's own functions.  The reference FILE is unparseable
    (trailing ':' in its __main__ block, preprocess_qrecc.py:418 — a
    documented defect), so the clean function region (lines 1-413) is
    sliced and exec'd; its undefined ``logger`` (another defect: the file
    never defines one) is stubbed.  Deterministic fields must match
    exactly; random negatives are compared structurally."""
    import logging
    import pickle

    ns = _load_qrecc_pre_ns()

    rawpids = [f"http://raw/{i}" for i in range(8)]
    with open(tmp_path / "pid2rawpid.pkl", "wb") as f:
        pickle.dump(rawpids, f)

    def turn(conv, t, q, rewrite, answer, passages, ctx):
        return {"Conversation_no": conv, "Turn_no": t,
                "Conversation_source": "quac", "Question": q,
                "Truth_rewrite": rewrite, "Truth_answer": answer,
                "Truth_passages": passages, "Context": ctx}

    train = [
        turn(1, 1, "who is he", "who is albert einstein", "a physicist",
             ["http://raw/1"], []),
        turn(1, 2, "when was he born", "when was einstein born", "1879",
             ["http://raw/2"],
             ["who is he", "a physicist"]),
        turn(2, 1, "what is jax", "what is the jax library", "a library",
             ["http://raw/3"], []),
    ]
    test = [
        turn(5, 1, "where is it", "where is the nile", "africa",
             ["http://raw/4"], []),
        turn(5, 2, "how long", "how long is the nile", "6650 km",
             ["http://raw/5"], ["where is it", "africa"]),
    ]
    (tmp_path / "train_in.json").write_text(json.dumps(train))
    (tmp_path / "test_in.json").write_text(json.dumps(test))

    ns["gen_qrecc_train_test_files"](
        str(tmp_path / "train_in.json"), str(tmp_path / "test_in.json"),
        str(tmp_path / "ref_train.json"), str(tmp_path / "ref_test.json"),
        str(tmp_path / "pid2rawpid.pkl"),
    )
    ns["gen_qrecc_qrel"](
        str(tmp_path / "test_in.json"), str(tmp_path / "ref_qrel.trec"),
        str(tmp_path / "pid2rawpid.pkl"),
    )

    from haconvdr_tpu.preprocess import qrecc as ours

    ours.gen_qrecc_train_test_files(
        str(tmp_path / "train_in.json"), str(tmp_path / "test_in.json"),
        str(tmp_path / "our_train.json"), str(tmp_path / "our_test.json"),
        str(tmp_path / "pid2rawpid.pkl"),
    )
    ours.gen_qrecc_qrel(
        str(tmp_path / "test_in.json"), str(tmp_path / "our_qrel.trec"),
        str(tmp_path / "pid2rawpid.pkl"),
    )

    assert (
        open(tmp_path / "our_qrel.trec").read()
        == open(tmp_path / "ref_qrel.trec").read()
    )
    for split in ("train", "test"):
        ref_recs = [json.loads(l) for l in open(tmp_path / f"ref_{split}.json")]
        our_recs = [json.loads(l) for l in open(tmp_path / f"our_{split}.json")]
        assert len(ref_recs) == len(our_recs)
        for a, b in zip(ref_recs, our_recs):
            for key in ("sample_id", "source", "cur_utt_text",
                        "oracle_utt_text", "cur_response_text",
                        "ctx_utts_text", "pos_docs_pids"):
                assert a[key] == b[key], (split, a["sample_id"], key)
            if "random_neg_docs_pids" in a:
                assert len(b["random_neg_docs_pids"]) == len(
                    a["random_neg_docs_pids"]
                )
                assert set(b["prepos_neg_docs_pids"]) == set(
                    a["prepos_neg_docs_pids"]
                )
    # the CONQRR substitution: turn-1 cur_utt is the rewrite, and later
    # turns' ctx reconstructs queries from the SUBSTITUTED sid2utt map
    ref_train_recs = [json.loads(l) for l in open(tmp_path / "ref_train.json")]
    assert ref_train_recs[0]["cur_utt_text"] == "who is albert einstein"
    assert ref_train_recs[1]["ctx_utts_text"][0] == "who is albert einstein"


def test_qrecc_merge_steps_match_reference(tmp_path):
    """QReCC enrichment differentials (merge_rel_label_info with its
    id-alignment walk and zero-fill, merge_bm25_neg_info) against the
    reference's sliced functions; pins the reference's exhaustion defect
    (its bare except + continue silently DROPS every record after the rel
    file runs out, preprocess_qrecc.py:261-268 — the rebuild keeps them
    with zero-fill labels)."""
    ns = _load_qrecc_pre_ns()

    recs = [
        {"sample_id": "QReCC-Train_8_1", "pos_docs_pids": [1]},
        {"sample_id": "QReCC-Train_8_2", "pos_docs_pids": [2]},
        {"sample_id": "QReCC-Train_8_3", "pos_docs_pids": [3]},
        {"sample_id": "QReCC-Train_9_1", "pos_docs_pids": [4]},
        {"sample_id": "QReCC-Train_9_2", "pos_docs_pids": [5]},
    ]
    orig = tmp_path / "orig.json"
    with open(orig, "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")
    # rel labels present for 8-2 only; 8-3 mismatches, 9-2 beyond the file
    rel = tmp_path / "rel.json"
    with open(rel, "w") as f:
        f.write(json.dumps({"id": "8-2", "rel_label": [1]}) + "\n")

    ref_out = tmp_path / "ref.json"
    our_out = tmp_path / "our.json"
    ns["merge_rel_label_info"](str(rel), str(orig), str(ref_out))
    from haconvdr_tpu.preprocess import qrecc as ours

    ours.merge_rel_label_info(str(rel), str(orig), str(our_out))
    ref_recs = [json.loads(l) for l in open(ref_out)]
    our_recs = [json.loads(l) for l in open(our_out)]
    # records written by both agree exactly...
    assert ref_recs == our_recs[: len(ref_recs)]
    assert [r["rel_label"] for r in ref_recs] == [[], [1]]
    # ...and the reference DROPS every record once the rel file is
    # exhausted (8-3, 9-1, 9-2 all vanish); ours keeps them with the
    # zero-fill the in-range mismatch branch applies
    assert len(ref_recs) == 2 and len(our_recs) == 5
    assert [r["rel_label"] for r in our_recs[2:]] == [[0, 0], [], [0]]

    # bm25 merge: byte-identical
    run = tmp_path / "bm25.trec"
    with open(run, "w") as f:
        for r in recs:
            for rank, pid in enumerate([r["pos_docs_pids"][0], 70, 71]):
                f.write(f"{r['sample_id']} Q0 {pid} {rank+1} {9-rank} bm25\n")
    ref_out2 = tmp_path / "ref2.json"
    our_out2 = tmp_path / "our2.json"
    ns["merge_bm25_neg_info"](str(run), str(orig), str(ref_out2))
    ours.merge_bm25_neg_info(str(run), str(orig), str(our_out2))
    assert [json.loads(l) for l in open(ref_out2)] == [
        json.loads(l) for l in open(our_out2)
    ]


def test_print_res_matches_reference(tmp_path):
    """JSON-variant metric printer differential: src/utils.py print_res
    (:230-274; its undefined ``logger`` — a documented defect — injected)
    vs eval/analysis.print_res on identical result/gold dumps."""
    import logging
    import types

    path = os.path.join(REF, "utils.py")
    if not os.path.exists(path):
        pytest.skip("reference tree not mounted")
    tf_now = sys.modules["transformers"]
    had_adamw = hasattr(tf_now, "AdamW")
    if not had_adamw:
        tf_now.AdamW = torch.optim.AdamW
    try:
        ref_utils = _load_ref_module("_ref_utils_pr", path)
    finally:
        if not had_adamw:
            del tf_now.AdamW
    ref_utils.logger = logging.getLogger("_ref_utils_pr")

    gold = [
        {"conv_id": 1, "turn_id": 1,
         "positive_ctxs": [{"passage_id": 11}]},
        {"conv_id": 1, "turn_id": 2,
         "positive_ctxs": [{"passage_id": 22}]},
        {"conv_id": 2, "turn_id": 1,
         "positive_ctxs": [{"passage_id": 33}]},
    ]
    results = [
        {"conv_id": 1, "turn_id": 1,
         "ctxs": [{"doc_id": 11}, {"doc_id": 5}]},         # rank 1
        {"conv_id": 1, "turn_id": 2,
         "ctxs": [{"doc_id": 7}, {"doc_id": 9}, {"doc_id": 22}]},  # rank 3
        {"conv_id": 2, "turn_id": 1,
         "ctxs": [{"doc_id": 4}]},                          # not found
    ]
    rf, gf = tmp_path / "res.json", tmp_path / "gold.json"
    rf.write_text(json.dumps(results))
    gf.write_text(json.dumps(gold))
    ref_scores = ref_utils.print_res(str(rf), str(gf))

    from haconvdr_tpu.eval.analysis import print_res

    ours = print_res(results, gold)
    assert ours == ref_scores


def test_qrecc_doc_extract_and_reformulate_match_reference(tmp_path):
    """QReCC doc-content extraction (preprocess_qrecc.py:180-243; its
    modify_pos/neg_docs live un-imported in the topiocqa file — another
    cross-file defect, injected here as the identity passthroughs they
    are) and reformulate_dataset_info (:361-411, pinning the same
    data[i-idx] indexing defect as the topiocqa variant)."""
    ns = _load_qrecc_pre_ns(extra={
        "modify_pos_docs": lambda sample, texts: texts,
        "modify_neg_docs": lambda sample, texts: texts,
    })

    from haconvdr_tpu.preprocess import qrecc as ours

    # doc-content extraction
    recs = [
        {"sample_id": "QReCC-Train_1_1", "pos_docs_pids": [1],
         "random_neg_docs_pids": [3, 4]},
        {"sample_id": "QReCC-Train_1_2", "pos_docs_pids": [2],
         "random_neg_docs_pids": [5, 6]},
        {"sample_id": "QReCC-Train_1_3", "pos_docs_pids": [7],  # bad doc
         "random_neg_docs_pids": [3]},
    ]
    train_in = tmp_path / "train.json"
    with open(train_in, "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")
    coll = tmp_path / "collection.tsv"
    with open(coll, "w") as f:
        for pid in (1, 2, 3, 4, 5, 6):
            f.write(f"{pid}\tpassage {pid}\n")
        f.write("7\n")  # bad line: pid only (the reference's except path)

    ref_out = tmp_path / "ref.json"
    our_out = tmp_path / "our.json"
    ns["extract_doc_content_of_random_negs_for_train_file"](
        str(coll), str(train_in), str(ref_out), random_neg_ratio=1
    )
    ours.extract_doc_content_of_random_negs_for_train_file(
        str(coll), str(train_in), str(our_out), random_neg_ratio=1
    )
    ref_docs = [json.loads(l) for l in open(ref_out)]
    our_docs = [json.loads(l) for l in open(our_out)]
    assert ref_docs[:2] == our_docs[:2]
    # pinned divergence: the reference turns a bad collection line into an
    # EMPTY-STRING positive (its except path logs and keeps it), which
    # downstream len(pos_docs_text)>0 checks treat as a real positive; the
    # rebuild drops it so the dataset classes skip the record cleanly
    assert ref_docs[2]["pos_docs_text"] == [""]
    assert our_docs[2]["pos_docs_text"] == []

    # reformulate with the indexing divergence pinned
    enriched = tmp_path / "enriched.json"
    rows = [
        {"sample_id": "QReCC-Train_2_1", "cur_utt_text": "q1",
         "cur_response_text": "a1", "ctx_utts_text": [],
         "pos_docs_text": ["P1"], "pos_docs_pids": [1],
         "prepos_neg_docs_pids": [], "rel_label": [],
         "bm25_hard_neg_docs_pids": [9], "bm25_hard_neg_docs": ["N9"]},
        {"sample_id": "QReCC-Train_2_2", "cur_utt_text": "q2",
         "cur_response_text": "a2", "ctx_utts_text": ["q1", "a1"],
         "pos_docs_text": ["P2"], "pos_docs_pids": [2],
         "prepos_neg_docs_pids": [1], "rel_label": [1],
         "bm25_hard_neg_docs_pids": [8], "bm25_hard_neg_docs": ["N8"]},
    ]
    with open(enriched, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    ref_final = tmp_path / "ref_final.json"
    our_final = tmp_path / "our_final.json"
    ns["reformulate_dataset_info"](str(enriched), str(ref_final))
    ours.reformulate_dataset_info(str(enriched), str(our_final))
    ref_f = [json.loads(l) for l in open(ref_final)]
    our_f = [json.loads(l) for l in open(our_final)]
    for a, b in zip(ref_f, our_f):
        for key in a:
            if key.startswith(("pseudo_prepos", "prepos_neg")):
                continue
            assert a[key] == b[key], key
    # pinned: reference's idx=0 reads the CURRENT record; ours the history
    assert ref_f[1]["pseudo_prepos_docs_pids"] == [2]
    assert our_f[1]["pseudo_prepos_docs_pids"] == [1]


def test_bm25_decode_mode_matches_reference():
    """BM25 ``decode`` query mode + eval_type answer / oracle+answer
    (/root/reference/bm25/bm25_topiocqa.py:135-142; same block in
    bm25_qrecc.py:102-109): the branch is AST-extracted from the
    reference's main() (its module imports pyserini, not installed) and
    executed against fabricated records; build_query must assemble
    byte-identical query text for all three eval_type settings."""
    import ast as ast_mod

    path = "/root/reference/bm25/bm25_topiocqa.py"
    if not os.path.exists(path):
        pytest.skip("reference tree not mounted")
    tree = ast_mod.parse(open(path).read())

    decode_body = None
    for node in ast_mod.walk(tree):
        if (
            isinstance(node, ast_mod.If)
            and isinstance(node.test, ast_mod.Compare)
            and isinstance(node.test.comparators[0], ast_mod.Constant)
            and node.test.comparators[0].value == "decode"
        ):
            decode_body = node.body
            break
    assert decode_body is not None, "decode branch not found in reference"

    from haconvdr_tpu.cli.bm25_search import build_query

    record = {"oracle_utt_text": "who wrote the raven", "sample_id": "1_1"}
    answer = {"answer_utt_text": "edgar allan poe wrote it"}
    for eval_type in ("", "answer", "oracle+answer"):
        ns = {
            "json": json,
            "record": dict(record),
            "data_2": [json.dumps(answer)],  # raw line, json.loads'd by ref
            "i": 0,
            "args": Namespace(query_type="decode", eval_type=eval_type),
        }
        exec(
            compile(
                ast_mod.Module(body=decode_body, type_ignores=[]),
                path,
                "exec",
            ),
            ns,
        )
        ours = build_query(
            dict(record), "decode", decode2=dict(answer), eval_type=eval_type
        )
        assert ours == ns["query"], (eval_type, ours, ns["query"])


def test_chained_pipeline_matches_reference(
    ref_modules, ref_train_module, tmp_path, monkeypatch
):
    """ONE chained differential across every pipeline seam, in the
    reference README's order (/root/reference/README.md:15-98):

      reference L0 (gen_train_test_files + qrel) -> reference PRJ probe
      generation (create_label_rel_turn) -> rebuild dense retrieval as the
      MRR oracle -> reference improve_judge vs rebuild improve_judge on
      identical MRRs -> label merge-back -> BM25 negatives (rebuild CPU
      BM25; reference merge_bm25_neg_info consumes its run file) ->
      reformulate -> 3 reference torch train steps vs the rebuild train
      step from the SAME init (save_hf_checkpoint) on the SAME records ->
      embed -> search -> TREC -> metrics, asserting the final run files
      (qid/pid/rank) and metric dicts agree.

    Every stage consumes the PREVIOUS stage's artifact, so field-name or
    format drift between stage outputs fails here even when each stage's
    own differential passes.  Reference functions are used wherever the
    reference is executable; rebuild stand-ins are limited to the pinned
    defects (merge_rel_label_info's never-matching id-format check,
    reformulate's data[i-idx] indexing, Retrieval_topiocqa_new's
    prepos_neg NameError — each pinned by its own dedicated test) and to
    faiss/pyserini/pytrec_eval which are not installed here.  Everything
    runs in float64 so torch-vs-JAX rank order is deterministic.
    """
    import dataclasses

    ref_models, ref_data = ref_modules
    m = ref_train_module
    ref_pre = _load_ref_or_skip(
        "_ref_pre_chain", "/root/reference/preprocess/preprocess_topicoqa.py"
    )
    ref_prj = _load_ref_or_skip(
        "_ref_prj_chain", "/root/reference/preprocess/PRJ_topiocqa.py"
    )

    # -- a dropout-free f64-friendly checkpoint both frameworks load -----
    from transformers.models.gpt2.tokenization_gpt2 import bytes_to_unicode

    ckpt_dir = tmp_path / "ckpt"
    ckpt_dir.mkdir()
    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3, "<mask>": 4}
    for s_ in bytes_to_unicode().values():
        if s_ not in vocab:
            vocab[s_] = len(vocab)
    with open(ckpt_dir / "vocab.json", "w") as f:
        json.dump(vocab, f)
    with open(ckpt_dir / "merges.txt", "w") as f:
        f.write("#version: 0.2\nt h\nth e\n")
    mcfg = ModelConfig.tiny(
        vocab_size=len(vocab) + 8, max_position_embeddings=80,
        embedding_dim=768, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0,
    )
    params0 = init_encoder_params(jax.random.PRNGKey(3), mcfg)
    save_hf_checkpoint(params0, mcfg, str(ckpt_dir))
    tok = transformers.RobertaTokenizer.from_pretrained(str(ckpt_dir))
    mcfg64 = dataclasses.replace(mcfg, dtype="float64")
    params64 = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64), params0
    )

    # -- stage A: reference L0 on a fabricated gold dump -----------------
    def turn(conv, t, pid, q):
        return {
            "conv_id": conv, "turn_id": t, "question": q,
            "answers": [f"answer {conv}-{t}"],
            "positive_ctxs": [{
                "passage_id": str(pid),
                "title": f"Title{pid} [SEP] Sub{pid}",
                "text": f"passage text about thing{pid}",
            }],
        }

    # conv 1 gets a third turn so consecutive conversations never end on
    # the same turn id: the reference's improve_judge flushes on turn-id
    # change only (src/test_PRJ_topiocqa.py:466), and its conv-boundary
    # defect at equal turn ids is pinned by its own dedicated test
    gold_train = [turn(1, 1, 1, "passage thing1"), turn(1, 2, 2, "passage thing2"),
                  turn(1, 3, 7, "passage thing7"),
                  turn(2, 1, 3, "passage thing3"), turn(2, 2, 4, "passage thing4")]
    gold_dev = [turn(5, 1, 5, "passage thing5"), turn(5, 2, 6, "passage thing6")]
    (tmp_path / "gold_train.json").write_text(json.dumps(gold_train))
    (tmp_path / "gold_dev.json").write_text(json.dumps(gold_dev))
    coll = tmp_path / "collection.tsv"
    with open(coll, "w") as f:
        f.write("id\ttext\ttitle\n")
        for pid in range(0, 8):
            f.write(f"{pid}\tpassage text about thing{pid}\tTitle{pid} [SEP] Sub{pid}\n")
    monkeypatch.setattr(ref_pre.random, "choice", lambda seq: seq[0])
    train_file = tmp_path / "train.json"
    test_file = tmp_path / "test.json"
    ref_pre.gen_train_test_files(
        str(tmp_path / "gold_train.json"), str(tmp_path / "gold_dev.json"),
        str(train_file), str(test_file), str(coll),
    )
    qrel_file = tmp_path / "qrel.trec"
    ref_pre.gen_topiocqa_qrel(str(tmp_path / "gold_dev.json"), str(qrel_file))

    # -- stage B: reference PRJ probes over the combined layout ----------
    docs = {pid: f"Title{pid} [SEP] Sub{pid} passage text about thing{pid}"
            for pid in range(0, 8)}

    def combined(gold):
        recs, hist, prev_pid = [], {}, {}
        for g in gold:
            c, t = g["conv_id"], g["turn_id"]
            hq, ha = hist.get(c, ([], []))
            pid = int(g["positive_ctxs"][0]["passage_id"])
            recs.append({
                "id": f"{c}-{t}", "conv_id": c, "turn_id": t,
                "history_query": list(hq), "history_rewrite": list(hq),
                "history_answer": list(ha),
                "last_response": docs[prev_pid[c]] if t > 1 else "",
                "topic": "T", "sub_topic": "S",
                "query": g["question"], "rewrite": g["question"],
                "answer": g["answers"][0],
                "pos_docs": [docs[pid]], "pos_docs_id": [pid],
            })
            hist[c] = (hq + [g["question"]], ha + [g["answers"][0]])
            prev_pid[c] = pid
        return recs

    probes_by_split, labels_by_split = {}, {}
    from haconvdr_tpu.data.prj import build_prj_probe_examples
    from haconvdr_tpu.data.sequence import encode_trunc, pad_seq_to_length
    from haconvdr_tpu.eval.metrics import trec_metrics
    from haconvdr_tpu.mine.prj import improve_judge
    from haconvdr_tpu.ops.topk import BlockSearcher

    # corpus embeddings once (frozen tower = initial checkpoint), f64
    p_ids, p_masks = [], []
    pids = sorted(docs)
    for pid in pids:
        ids_, mask_ = pad_seq_to_length(encode_trunc(tok, docs[pid], 24), 24)
        p_ids.append(ids_)
        p_masks.append(mask_)
    corpus_emb = np.asarray(encode(
        params64, mcfg64, jnp.asarray(np.asarray(p_ids)),
        jnp.asarray(np.asarray(p_masks)),
    ))

    import ast as ast_mod

    prj_path = os.path.join(REF, "test_PRJ_topiocqa.py")
    prj_tree = ast_mod.parse(open(prj_path).read())
    fn = next(n for n in prj_tree.body
              if isinstance(n, ast_mod.FunctionDef) and n.name == "improve_judge")
    ns = {"json": json}
    exec(compile(ast_mod.Module(body=[fn], type_ignores=[]), prj_path, "exec"), ns)
    ref_improve = ns["improve_judge"]

    for split, gold in (("train", gold_train), ("dev", gold_dev)):
        comb_file = tmp_path / f"combined_{split}.json"
        with open(comb_file, "w") as f:
            for r in combined(gold):
                f.write(json.dumps(r) + "\n")
        probe_file = tmp_path / f"probes_{split}.json"
        ref_prj.create_label_rel_turn(str(comb_file), str(probe_file))
        probes = [json.loads(l) for l in open(probe_file)]
        probes_by_split[split] = probes

        # rebuild dense retrieval as the MRR oracle for the probes
        cfg = _our_cfg(max_concat_length=64)
        examples = build_prj_probe_examples(cfg, tok, str(probe_file))
        q_emb = np.asarray(encode(
            params64, mcfg64,
            jnp.asarray(np.asarray([e["pair_query"] for e in examples])),
            jnp.asarray(np.asarray([e["pair_query_mask"] for e in examples])),
        ))
        searcher = BlockSearcher(top_k=len(pids), passage_chunk=8)
        s_, i_ = searcher.search(
            q_emb.astype(np.float32),
            [(corpus_emb.astype(np.float32), np.asarray(pids, np.int64))],
        )
        runs = {
            e["sample_id"]: {str(pids[j]): float(s_[qi, r])
                             for r, j in enumerate(np.searchsorted(pids, i_[qi]))}
            for qi, e in enumerate(examples)
        }
        # probe qrels: each probe's gold pid (convert_gold_to_trec intent)
        qrels = {p["id"]: {str(p["pos_docs_id"][0]): 1} for p in probes}
        runs = {qid: {str(p): float(sc) for p, sc in
                      zip(i_[qi], s_[qi]) if p >= 0}
                for qi, qid in enumerate(e2["sample_id"] for e2 in examples)}
        _, per_q = trec_metrics(runs, qrels, qrels)
        mrr = {qid: met["recip_rank"] for qid, met in per_q.items()}

        # identical MRRs -> reference rule vs rebuild rule
        scores_in_file_order = [mrr[p["id"]] for p in probes]
        ref_labels = ref_improve(str(probe_file), scores_in_file_order)
        our_labels = improve_judge(probes, mrr)
        assert ref_labels == our_labels, split
        labels_by_split[split] = our_labels

    # -- stage C: merge labels + BM25 negatives into train/test files ----
    from haconvdr_tpu.mine.bm25 import BM25Index
    from haconvdr_tpu.preprocess import topiocqa as ours_pre

    merged = {}
    for split, fname in (("train", train_file), ("dev", test_file)):
        recs = [json.loads(l) for l in open(fname)]
        rel_file = tmp_path / f"rel_{split}.json"
        labels = labels_by_split[split]
        with open(rel_file, "w") as f:
            for r in recs:
                conv, t = r["sample_id"].split("_")[-2:]
                f.write(json.dumps({
                    "id": f"{conv}-{t}",
                    "rel_label": labels.get(f"{conv}-{t}", []),
                }) + "\n")
        out = tmp_path / f"{split}_rel.json"
        # rebuild merge: the reference's own format check can never match
        # its own L0 layout (pinned in the dedicated merge test)
        ours_pre.merge_rel_label_info(str(rel_file), str(fname), str(out))
        merged[split] = out

    # BM25 mining (rebuild CPU BM25 stands in for pyserini/Lucene); the
    # REFERENCE merge consumes its run file — the run-format seam
    idx = BM25Index()
    for pid in pids:
        idx.add(str(pid), docs[pid])
    idx.finalize()
    train_recs = [json.loads(l) for l in open(merged["train"])]
    queries = [r["cur_utt_text"].split(" [SEP] ")[-1] for r in train_recs]
    d_, s_ = idx.batch_search(queries, k=4)
    bm25_run = tmp_path / "bm25.trec"
    with open(bm25_run, "w") as f:
        for qi, r in enumerate(train_recs):
            for rank in range(d_.shape[1]):
                if d_[qi, rank] < 0:
                    break
                f.write(
                    f"{r['sample_id']} Q0 {idx.doc_ids[d_[qi, rank]]} "
                    f"{rank + 1} {10 - rank} bm25\n"
                )
    with_negs = tmp_path / "train_negs.json"
    ref_pre.merge_bm25_neg_info(str(bm25_run), str(merged["train"]), str(with_negs))
    ours_pre.extract_doc_content_of_bm25_hard_negs_for_train_file(
        "", str(with_negs), str(with_negs), qid2passage={p: docs[p] for p in pids}
    )
    train_info = tmp_path / "train_with_info.json"
    # rebuild reformulate (the reference's data[i-idx] defect is pinned in
    # its dedicated test; the chain wants the intended mapping)
    ours_pre.reformulate_dataset_info(str(with_negs), str(train_info))
    info_recs = [json.loads(l) for l in open(train_info)]
    assert any(r.get("bm25_hard_neg_docs") for r in info_recs)

    # strip pseudo/prepos for the train stage: Retrieval_topiocqa_new
    # NameErrors on non-empty prepos_neg_docs (src/data.py:333, pinned
    # elsewhere); pseudo/prepos loss parity has its own differential
    train_plain = tmp_path / "train_plain.json"
    with open(train_plain, "w") as f:
        for r in info_recs:
            r = dict(r)
            r["pseudo_prepos_docs"] = []
            r["prepos_neg_docs"] = []
            f.write(json.dumps(r) + "\n")

    # -- stage D: 3 reference torch train steps vs the rebuild ----------
    args = _ref_args(is_train=True, use_PRL=True)
    ref_ds = ref_data.Retrieval_topiocqa_new(args, tok, str(train_plain))
    collate = ref_data.Retrieval_topiocqa_new.get_collate_fn(args)
    ref_batch = collate([ref_ds[i] for i in range(len(ref_ds))])

    config = transformers.RobertaConfig.from_pretrained(str(ckpt_dir))
    config.hidden_dropout_prob = 0.0  # deterministic torch loop (the JAX
    config.attention_probs_dropout_prob = 0.0  # side trains dropout-free)
    q_enc = ref_models.ANCE.from_pretrained(str(ckpt_dir), config=config).double()
    p_enc = ref_models.ANCE.from_pretrained(str(ckpt_dir), config=config).double()
    q_enc.train()
    p_enc.eval()
    opt_args = Namespace(learning_rate=5e-3, adam_epsilon=1e-8)
    optimizer = m.get_optimizer(opt_args, q_enc, weight_decay=0.0)
    scheduler = transformers.get_linear_schedule_with_warmup(
        optimizer, num_warmup_steps=0, num_training_steps=3
    )
    m.args = Namespace(is_pseudo_prepos=False, is_prepos_neg=False,
                       alpha=1.0, device="cpu")
    tq = torch.tensor(np.asarray(ref_batch["bt_conv_qp"]))
    tqm = torch.tensor(np.asarray(ref_batch["bt_conv_qp_mask"]))
    tp = torch.tensor(np.asarray(ref_batch["bt_pos_docs"]))
    tpm = torch.tensor(np.asarray(ref_batch["bt_pos_docs_mask"]))
    tn = torch.tensor(np.asarray(ref_batch["bt_neg_docs"]))
    tnm = torch.tensor(np.asarray(ref_batch["bt_neg_docs_mask"]))
    ref_losses = []
    for _ in range(3):  # the hot loop, src/train_HAConvDR_topiocqa.py:127-208
        q_enc.zero_grad()
        q_embs = q_enc.query_emb(tq, tqm)
        with torch.no_grad():
            pos_embs = p_enc.query_emb(tp, tpm).detach()
            neg_embs = p_enc.query_emb(tn, tnm).detach()
        loss = m.cal_ranking_loss_prepos(q_embs, pos_embs, neg_embs, None, None)
        loss.backward()
        torch.nn.utils.clip_grad_norm_(q_enc.parameters(), 1.0)
        optimizer.step()
        scheduler.step()
        ref_losses.append(float(loss))

    from haconvdr_tpu.config import TrainConfig
    from haconvdr_tpu.data.topiocqa import build_topiocqa_train_examples
    from haconvdr_tpu.models.encoder import stack_layer_params
    from haconvdr_tpu.parallel.mesh import make_mesh
    from haconvdr_tpu.train.trainer import (
        init_train_state, make_optimizer, make_train_step,
    )

    our_cfg = _our_cfg(is_train=True, use_PRL=True)
    ours_ex = build_topiocqa_train_examples(our_cfg, tok, str(train_plain))
    assert len(ours_ex) == len(ref_ds)
    from haconvdr_tpu.data.loader import collate as our_collate

    our_np = our_collate(ours_ex)
    # the seam itself: chain-produced records must tokenize identically
    # through both sides' dataset builders
    for ok, rk in (("conv_qp", "bt_conv_qp"), ("pos_docs", "bt_pos_docs"),
                   ("neg_docs", "bt_neg_docs")):
        np.testing.assert_array_equal(
            np.asarray(our_np[ok]), np.asarray(ref_batch[rk]), err_msg=ok
        )
    batch = {k: jnp.asarray(v) for k, v in our_np.items()
             if isinstance(v, np.ndarray)}
    tcfg = TrainConfig(
        per_device_train_batch_size=len(ours_ex), learning_rate=5e-3,
        accumulation_steps=1, num_train_epochs=3, weight_decay=0.0,
        is_pseudo_prepos=False, is_prepos_neg=False,
    )
    mesh = make_mesh(dp=1, tp=1, devices=jax.devices()[:1])
    opt = make_optimizer(tcfg, 3)
    step_fn = make_train_step(mesh, mcfg64, tcfg, opt)
    state = init_train_state(
        jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                               stack_layer_params(params0)),
        opt,
    )
    frozen = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64), stack_layer_params(params0)
    )
    our_losses = []
    for _ in range(3):
        state, loss = step_fn(state, frozen, batch)
        our_losses.append(float(loss))
    np.testing.assert_allclose(our_losses, ref_losses, rtol=1e-6, atol=1e-8)

    # -- stage E: embed -> search -> TREC -> metrics, both routes --------
    from haconvdr_tpu.data.topiocqa import build_topiocqa_test_examples
    from haconvdr_tpu.eval.trec import dedup_ranked_candidates, read_qrels, read_run, write_run
    from haconvdr_tpu.models.encoder import unstack_layer_params

    eval_args = _ref_args(is_train=False, use_PRL=False)
    ref_eval = ref_data.Retrieval_topiocqa(eval_args, tok, str(merged["dev"]))
    eval_collate = ref_data.Retrieval_topiocqa.get_collate_fn(eval_args)
    ebatch = eval_collate([ref_eval[i] for i in range(len(ref_eval))])
    qids = list(ebatch["bt_sample_ids"])
    q_enc.eval()
    with torch.no_grad():
        ref_q = q_enc.query_emb(
            torch.tensor(np.asarray(ebatch["bt_conv_qp"])),
            torch.tensor(np.asarray(ebatch["bt_conv_qp_mask"])),
        ).numpy()

    our_eval = build_topiocqa_test_examples(
        _our_cfg(is_train=False, use_PRL=False), tok, str(merged["dev"])
    )
    trained = unstack_layer_params(state.params)
    our_q = np.asarray(encode(
        trained, mcfg64,
        jnp.asarray(np.asarray([e["conv_qp"] for e in our_eval])),
        jnp.asarray(np.asarray([e["conv_qp_mask"] for e in our_eval])),
    ))
    assert [e["sample_id"] for e in our_eval] == qids
    # torch AdamW and optax adamw agree on the math but not on f64
    # rounding order; after 3 updates the embedding drift is ~1e-7 —
    # far below the mini-corpus score gaps, so ranks stay deterministic
    np.testing.assert_allclose(our_q, ref_q, rtol=1e-5, atol=1e-5)

    run_files = {}
    for name, q_emb in (("ref", ref_q), ("ours", our_q)):
        searcher = BlockSearcher(top_k=len(pids), passage_chunk=8)
        s_, i_ = searcher.search(
            q_emb.astype(np.float32),
            [(corpus_emb.astype(np.float32), np.asarray(pids, np.int64))],
        )
        ranked = dedup_ranked_candidates(qids, s_, i_, None, len(pids))
        run_path = tmp_path / f"run_{name}.trec"
        write_run(ranked, str(run_path))
        run_files[name] = run_path

    la = open(run_files["ref"]).read().splitlines()
    lb = open(run_files["ours"]).read().splitlines()
    assert len(la) == len(lb)
    for a, b in zip(la, lb):
        fa, fb = a.split(), b.split()
        # qid, pid, rank equal between the torch route and the JAX route
        assert (fa[0], fa[2], fa[3]) == (fb[0], fb[2], fb[3]), (a, b)

    qrels, qrels_ndcg = read_qrels(str(qrel_file), 1)
    met_ref, _ = trec_metrics(read_run(str(run_files["ref"])), qrels, qrels_ndcg)
    met_ours, _ = trec_metrics(read_run(str(run_files["ours"])), qrels, qrels_ndcg)
    assert met_ref == met_ours
    assert met_ref["MRR"] > 0  # the chain retrieves something real


@pytest.fixture()
def ref_qrecc_train_module(ref_modules):
    """train_HAConvDR_qrecc.py under the same import shims as
    ref_train_module (its cal_ranking_loss is the QReCC training
    contract, /root/reference/src/train_HAConvDR_qrecc.py:46-59)."""
    import types

    names = ("toml", "tensorboardX", "models", "utils", "data", "_ref_train_q")
    saved = {k: sys.modules.get(k) for k in names}
    had_adamw = True
    try:
        sys.modules["toml"] = types.ModuleType("toml")
        tbx = types.ModuleType("tensorboardX")
        tbx.SummaryWriter = object
        sys.modules["tensorboardX"] = tbx
        sys.modules["models"] = ref_modules[0]
        sys.modules["data"] = ref_modules[1]
        tf_now = sys.modules["transformers"]
        had_adamw = hasattr(tf_now, "AdamW")
        if not had_adamw:
            tf_now.AdamW = torch.optim.AdamW
        _load_ref_module("utils", os.path.join(REF, "utils.py"))
        train = _load_ref_module(
            "_ref_train_q", os.path.join(REF, "train_HAConvDR_qrecc.py")
        )
        yield train
    finally:
        for k in names:
            if saved[k] is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = saved[k]
        tf_now = sys.modules.get("transformers")
        if not had_adamw and tf_now is not None and hasattr(tf_now, "AdamW"):
            del tf_now.AdamW


def test_chained_qrecc_pipeline_matches_reference(
    ref_modules, ref_qrecc_train_module, tmp_path, monkeypatch
):
    """The QReCC analog of test_chained_pipeline_matches_reference — one
    differential across every QReCC seam in the reference README's order:

      reference L0 (gen_qrecc_train_test_files with the CONQRR first-turn
      Truth_rewrite substitution + gen_qrecc_qrel + the random-negs
      pos_docs_text extract) -> reference PRJ_qrecc probe generation on
      records DERIVED FROM the L0 output -> rebuild dense retrieval as the
      MRR oracle -> reference test_PRJ_qrecc improve_judge (the qrel-id
      filtered variant) vs rebuild improve_judge on identical MRRs ->
      rel-label merge (REFERENCE and rebuild outputs asserted equal on
      aligned inputs) -> BM25 negatives (rebuild CPU BM25; reference
      merge + doc-content extract consume its run file) -> reformulate ->
      3 reference torch train steps (Retrieval_qrecc + cal_ranking_loss,
      convqa mode) vs the rebuild's ranking-variant step from the SAME
      init -> embed -> search -> TREC -> metrics with the stage-A qrel.

    Reference functions run wherever executable; the qrecc file's
    missing-name defects (logger, pickle, modify_pos_docs/modify_neg_docs
    from preprocess_topicoqa.py, the qrecc_collection_path global in the
    bm25 extract) are injected into its exec namespace rather than
    worked around.  Everything is float64 so torch-vs-JAX ranks are
    deterministic."""
    import dataclasses
    import itertools
    import pickle as _pickle

    ref_models, ref_data = ref_modules
    mq = ref_qrecc_train_module
    ref_prj = _load_ref_or_skip(
        "_ref_prjq_chain", "/root/reference/preprocess/PRJ_qrecc.py"
    )

    # -- shared tiny checkpoint (torch + JAX load the same weights) ------
    from transformers.models.gpt2.tokenization_gpt2 import bytes_to_unicode

    ckpt_dir = tmp_path / "ckpt"
    ckpt_dir.mkdir()
    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3, "<mask>": 4}
    for s_ in bytes_to_unicode().values():
        if s_ not in vocab:
            vocab[s_] = len(vocab)
    with open(ckpt_dir / "vocab.json", "w") as f:
        json.dump(vocab, f)
    with open(ckpt_dir / "merges.txt", "w") as f:
        f.write("#version: 0.2\nt h\nth e\n")
    mcfg = ModelConfig.tiny(
        vocab_size=len(vocab) + 8, max_position_embeddings=80,
        embedding_dim=768, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0,
    )
    params0 = init_encoder_params(jax.random.PRNGKey(11), mcfg)
    save_hf_checkpoint(params0, mcfg, str(ckpt_dir))
    tok = transformers.RobertaTokenizer.from_pretrained(str(ckpt_dir))
    mcfg64 = dataclasses.replace(mcfg, dtype="float64")
    params64 = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64), params0
    )

    # -- stage A: reference L0 on fabricated scai-qrecc21 dumps ----------
    docs = {p: f"passage text about thing{p}" for p in range(10)}
    rawpids = [f"http://raw/{p}" for p in range(10)]
    with open(tmp_path / "pid2rawpid.pkl", "wb") as f:
        _pickle.dump(rawpids, f)
    coll = tmp_path / "qrecc_collection.tsv"
    with open(coll, "w") as f:
        for p, text in docs.items():
            f.write(f"{p}\t{text}\n")

    def turn(conv, t, pid, q, rewrite, prior):
        # Context = [q1, a1, q2, a2, ...] for the prior turns
        ctx = []
        for pq, pa in prior:
            ctx.extend([pq, pa])
        return {
            "Conversation_no": conv, "Turn_no": t,
            "Conversation_source": "quac",
            "Question": q, "Truth_rewrite": rewrite,
            "Truth_answer": f"answer {conv}-{t}",
            "Truth_passages": [rawpids[pid]], "Context": ctx,
        }

    # conv 1 has three turns so improve_judge's flush-on-turn-change sees
    # a mid-conversation boundary; conv 2 ends on a different turn id
    def conv_turns(conv, pids, qs):
        out, prior = [], []
        for t, (pid, q) in enumerate(zip(pids, qs), start=1):
            out.append(turn(conv, t, pid, q, f"rewritten {q}", list(prior)))
            prior.append((q, f"answer {conv}-{t}"))
        return out

    train_in = conv_turns(1, [1, 2, 7], ["passage thing1", "passage thing2", "passage thing7"]) \
        + conv_turns(2, [3, 4], ["passage thing3", "passage thing4"])
    test_in = conv_turns(5, [5, 6], ["passage thing5", "passage thing6"])
    (tmp_path / "train_in.json").write_text(json.dumps(train_in))
    (tmp_path / "test_in.json").write_text(json.dumps(test_in))

    ns = _load_qrecc_pre_ns(extra={
        "modify_pos_docs": lambda rec, texts: texts,
        "modify_neg_docs": lambda rec, texts: texts,
        "qrecc_collection_path": str(coll),
    })
    counter = itertools.count()
    monkeypatch.setattr(
        ns["random"], "randint", lambda a, b: next(counter) % 10
    )
    monkeypatch.setattr(ns["random"], "sample", lambda seq, k: list(seq)[:k])
    train_l0 = tmp_path / "train.json"
    test_l0 = tmp_path / "test.json"
    ns["gen_qrecc_train_test_files"](
        str(tmp_path / "train_in.json"), str(tmp_path / "test_in.json"),
        str(train_l0), str(test_l0), str(tmp_path / "pid2rawpid.pkl"),
    )
    qrel_file = tmp_path / "qrecc_qrel.tsv"
    ns["gen_qrecc_qrel"](
        str(tmp_path / "test_in.json"), str(qrel_file),
        str(tmp_path / "pid2rawpid.pkl"),
    )
    # pos_docs_text (+ random-neg text) via the reference extract
    train_doc = tmp_path / "train_doc.json"
    ns["extract_doc_content_of_random_negs_for_train_file"](
        str(coll), str(train_l0), str(train_doc)
    )

    # -- stage B: PRJ probes from records DERIVED from the L0 output -----
    from haconvdr_tpu.data.prj import build_prj_probe_examples
    from haconvdr_tpu.data.sequence import encode_trunc, pad_seq_to_length
    from haconvdr_tpu.eval.metrics import trec_metrics
    from haconvdr_tpu.mine.prj import create_label_rel_turn, improve_judge
    from haconvdr_tpu.ops.topk import BlockSearcher

    pids = sorted(docs)
    p_ids, p_masks = [], []
    for pid in pids:
        ids_, mask_ = pad_seq_to_length(encode_trunc(tok, docs[pid], 24), 24)
        p_ids.append(ids_)
        p_masks.append(mask_)
    corpus_emb = np.asarray(encode(
        params64, mcfg64, jnp.asarray(np.asarray(p_ids)),
        jnp.asarray(np.asarray(p_masks)),
    ))

    import ast as ast_mod

    prj_eval_path = os.path.join(REF, "test_PRJ_qrecc.py")
    prj_tree = ast_mod.parse(open(prj_eval_path).read())
    fn = next(n for n in prj_tree.body
              if isinstance(n, ast_mod.FunctionDef) and n.name == "improve_judge")
    ns2 = {"json": json}
    exec(compile(ast_mod.Module(body=[fn], type_ignores=[]), prj_eval_path, "exec"), ns2)
    ref_improve = ns2["improve_judge"]

    labels_by_split = {}
    for split, l0_file in (("train", train_l0), ("test", test_l0)):
        recs = [json.loads(l) for l in open(l0_file)]
        # the "new_*.json" layout PRJ_qrecc consumes, derived from the L0
        # records themselves (ids 'conv-turn'; context_queries are the
        # even Context slots, which L0 already rebuilt through its
        # CONQRR-substituted sid2utt map — the seam under test)
        new_file = tmp_path / f"new_{split}.json"
        new_recs = []
        for r in recs:
            conv, t = r["sample_id"].split("_")[-2:]
            ctx = r["ctx_utts_text"]
            new_recs.append({
                "sample_id": f"{conv}-{t}",
                "context_queries": ctx[0::2],
                "query": r["cur_utt_text"],
                "oracle_query": r["oracle_utt_text"],
                "last_response": ctx[-1] if ctx else "",
                "pos_docs": r["pos_docs_pids"],
            })
        with open(new_file, "w") as f:
            for r in new_recs:
                f.write(json.dumps(r) + "\n")

        probe_file = tmp_path / f"probes_{split}.json"
        ref_prj.create_label_rel_turn(str(new_file), str(probe_file))
        probes = [json.loads(l) for l in open(probe_file)]
        ours_probes = create_label_rel_turn(new_recs, dataset="qrecc")
        assert [p["id"] for p in ours_probes] == [p["id"] for p in probes]
        assert [p["query_pair"] for p in ours_probes] == [
            p["query_pair"] for p in probes
        ]

        # rebuild retrieval as the shared MRR oracle
        cfg = _our_cfg(dataset="qrecc", max_concat_length=64)
        examples = build_prj_probe_examples(cfg, tok, str(probe_file))
        q_emb = np.asarray(encode(
            params64, mcfg64,
            jnp.asarray(np.asarray([e["pair_query"] for e in examples])),
            jnp.asarray(np.asarray([e["pair_query_mask"] for e in examples])),
        ))
        searcher = BlockSearcher(top_k=len(pids), passage_chunk=8)
        s_, i_ = searcher.search(
            q_emb.astype(np.float32),
            [(corpus_emb.astype(np.float32), np.asarray(pids, np.int64))],
        )
        runs = {qid: {str(p): float(sc) for p, sc in zip(i_[qi], s_[qi]) if p >= 0}
                for qi, qid in enumerate(e2["sample_id"] for e2 in examples)}
        qrels = {p["id"]: {str(p["pos_docs_id"][0]): 1} for p in probes}
        _, per_q = trec_metrics(runs, qrels, qrels)
        mrr = {qid: met["recip_rank"] for qid, met in per_q.items()}

        scores_in_file_order = [mrr[p["id"]] for p in probes]
        ref_labels = ref_improve(
            str(probe_file), scores_in_file_order, str(new_file)
        )
        our_labels = improve_judge(
            probes, mrr, qrel_ids={r["sample_id"] for r in new_recs}
        )
        assert ref_labels == our_labels, split
        labels_by_split[split] = our_labels

    # -- stage C: label merge (reference vs rebuild on aligned inputs) ---
    merged = {}
    for split, fname in (("train", train_doc), ("test", test_l0)):
        labels = labels_by_split[split]
        rel_file = tmp_path / f"rel_{split}.json"
        recs = [json.loads(l) for l in open(fname)]
        with open(rel_file, "w") as f:
            for r in recs:
                conv, t = r["sample_id"].split("_")[-2:]
                if int(t) > 1:
                    f.write(json.dumps({
                        "id": f"{conv}-{t}",
                        "rel_label": labels.get(f"{conv}-{t}", []),
                    }) + "\n")
        ref_out = tmp_path / f"{split}_rel_ref.json"
        our_out = tmp_path / f"{split}_rel_our.json"
        ns["merge_rel_label_info"](str(rel_file), str(fname), str(ref_out))
        from haconvdr_tpu.preprocess import qrecc as ours_pre

        ours_pre.merge_rel_label_info(str(rel_file), str(fname), str(our_out))
        # aligned inputs: the reference's exhaustion defect never fires,
        # so the two merges must agree byte-for-byte at the record level
        assert [json.loads(l) for l in open(ref_out)] == [
            json.loads(l) for l in open(our_out)
        ], split
        merged[split] = ref_out

    # -- stage D: BM25 negatives through the reference merge + extract --
    from haconvdr_tpu.mine.bm25 import BM25Index

    idx = BM25Index()
    for pid in pids:
        idx.add(str(pid), docs[pid])
    idx.finalize()
    train_recs = [json.loads(l) for l in open(merged["train"])]
    d_, s_ = idx.batch_search([r["cur_utt_text"] for r in train_recs], k=6)
    bm25_run = tmp_path / "bm25_q.trec"
    with open(bm25_run, "w") as f:
        for qi, r in enumerate(train_recs):
            for rank in range(d_.shape[1]):
                if d_[qi, rank] < 0:
                    break
                f.write(
                    f"{r['sample_id']} Q0 {idx.doc_ids[d_[qi, rank]]} "
                    f"{rank + 1} {10 - rank} bm25\n"
                )
    with_negs = tmp_path / "train_negs.json"
    ns["merge_bm25_neg_info"](str(bm25_run), str(merged["train"]), str(with_negs))
    with_docs = tmp_path / "train_negs_doc.json"
    ns["extract_doc_content_of_bm25_hard_negs_for_train_file"](
        str(coll), str(with_negs), str(with_docs)
    )
    train_info = tmp_path / "train_with_info.json"
    # rebuild reformulate (the reference's data[i-idx] walk defect is
    # pinned in its own dedicated test; the chain wants the intended map)
    from haconvdr_tpu.preprocess import qrecc as ours_pre

    ours_pre.reformulate_dataset_info(str(with_docs), str(train_info))
    info_recs = [json.loads(l) for l in open(train_info)]
    assert any(r.get("bm25_hard_neg_docs") for r in info_recs)

    # -- stage E: 3 reference torch train steps vs the rebuild ----------
    args = _ref_args(is_train=True, use_PRL=True, max_concat_length=64)
    ref_ds = ref_data.Retrieval_qrecc(args, tok, str(train_info))
    collate = ref_data.Retrieval_qrecc.get_collate_fn(args)
    ref_batch = collate([ref_ds[i] for i in range(len(ref_ds))])

    config = transformers.RobertaConfig.from_pretrained(str(ckpt_dir))
    config.hidden_dropout_prob = 0.0
    config.attention_probs_dropout_prob = 0.0
    q_enc = ref_models.ANCE.from_pretrained(str(ckpt_dir), config=config).double()
    p_enc = ref_models.ANCE.from_pretrained(str(ckpt_dir), config=config).double()
    q_enc.train()
    p_enc.eval()
    opt_args = Namespace(learning_rate=5e-3, adam_epsilon=1e-8)
    optimizer = mq.get_optimizer(opt_args, q_enc, weight_decay=0.0)
    scheduler = transformers.get_linear_schedule_with_warmup(
        optimizer, num_warmup_steps=0, num_training_steps=3
    )
    mq.args = Namespace(hard_neg_type="bm25", device="cpu")
    tq = torch.tensor(np.asarray(ref_batch["bt_conv_qa"]))
    tqm = torch.tensor(np.asarray(ref_batch["bt_conv_qa_mask"]))
    tp = torch.tensor(np.asarray(ref_batch["bt_pos_docs"]))
    tpm = torch.tensor(np.asarray(ref_batch["bt_pos_docs_mask"]))
    tn = torch.tensor(np.asarray(ref_batch["bt_neg_docs"]))
    tnm = torch.tensor(np.asarray(ref_batch["bt_neg_docs_mask"]))
    ref_losses = []
    for _ in range(3):  # the hot loop, src/train_HAConvDR_qrecc.py:111-175
        q_enc.zero_grad()
        q_embs = q_enc.query_emb(tq, tqm)
        with torch.no_grad():
            pos_embs = p_enc.query_emb(tp, tpm).detach()
            neg_embs = p_enc.query_emb(tn, tnm).detach()
        loss = mq.cal_ranking_loss(q_embs, pos_embs, neg_embs)
        loss.backward()
        torch.nn.utils.clip_grad_norm_(q_enc.parameters(), 1.0)
        optimizer.step()
        scheduler.step()
        ref_losses.append(float(loss))

    from haconvdr_tpu.config import TrainConfig
    from haconvdr_tpu.data.loader import collate as our_collate
    from haconvdr_tpu.data.qrecc import build_qrecc_examples
    from haconvdr_tpu.models.encoder import stack_layer_params, unstack_layer_params
    from haconvdr_tpu.parallel.mesh import make_mesh
    from haconvdr_tpu.train.trainer import (
        init_train_state, make_optimizer, make_train_step,
    )

    our_cfg = _our_cfg(
        dataset="qrecc", is_train=True, use_PRL=True, max_concat_length=64
    )
    ours_ex = build_qrecc_examples(our_cfg, tok, str(train_info))
    assert len(ours_ex) == len(ref_ds)
    our_np = our_collate(ours_ex)
    for ok, rk in (("conv_qa", "bt_conv_qa"), ("pos_docs", "bt_pos_docs"),
                   ("neg_docs", "bt_neg_docs")):
        np.testing.assert_array_equal(
            np.asarray(our_np[ok]), np.asarray(ref_batch[rk]), err_msg=ok
        )
    batch = {k: jnp.asarray(v) for k, v in our_np.items()
             if isinstance(v, np.ndarray)}
    tcfg = TrainConfig(
        per_device_train_batch_size=len(ours_ex), learning_rate=5e-3,
        accumulation_steps=1, num_train_epochs=3, weight_decay=0.0,
    )
    mesh = make_mesh(dp=1, tp=1, devices=jax.devices()[:1])
    opt = make_optimizer(tcfg, 3)
    step_fn = make_train_step(
        mesh, mcfg64, tcfg, opt, loss_variant="ranking", query_key="conv_qa"
    )
    state = init_train_state(
        jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                               stack_layer_params(params0)),
        opt,
    )
    frozen = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64), stack_layer_params(params0)
    )
    our_losses = []
    for _ in range(3):
        state, loss = step_fn(state, frozen, batch)
        our_losses.append(float(loss))
    np.testing.assert_allclose(our_losses, ref_losses, rtol=1e-6, atol=1e-8)

    # -- stage F: embed -> search -> TREC -> metrics, both routes --------
    from haconvdr_tpu.eval.trec import (
        dedup_ranked_candidates, read_qrels, read_run, write_run,
    )

    # eval records need pos_docs_text (Retrieval_qrecc skips empty ones);
    # the reference repo ships no test-side extract, so inject the texts
    # identically for BOTH routes from the stage-A collection
    eval_file = tmp_path / "test_eval.json"
    with open(eval_file, "w") as f:
        for l in open(merged["test"]):
            r = json.loads(l)
            r["pos_docs_text"] = [docs[p] for p in r["pos_docs_pids"]]
            f.write(json.dumps(r) + "\n")

    eval_args = _ref_args(is_train=False, use_PRL=False, max_concat_length=64)
    ref_eval = ref_data.Retrieval_qrecc(eval_args, tok, str(eval_file))
    eval_collate = ref_data.Retrieval_qrecc.get_collate_fn(eval_args)
    ebatch = eval_collate([ref_eval[i] for i in range(len(ref_eval))])
    qids = list(ebatch["bt_sample_ids"])
    q_enc.eval()
    with torch.no_grad():
        ref_q = q_enc.query_emb(
            torch.tensor(np.asarray(ebatch["bt_conv_qa"])),
            torch.tensor(np.asarray(ebatch["bt_conv_qa_mask"])),
        ).numpy()

    our_eval = build_qrecc_examples(
        _our_cfg(dataset="qrecc", is_train=False, max_concat_length=64),
        tok, str(eval_file),
    )
    trained = unstack_layer_params(state.params)
    our_q = np.asarray(encode(
        trained, mcfg64,
        jnp.asarray(np.asarray([e["conv_qa"] for e in our_eval])),
        jnp.asarray(np.asarray([e["conv_qa_mask"] for e in our_eval])),
    ))
    assert [e["sample_id"] for e in our_eval] == qids
    np.testing.assert_allclose(our_q, ref_q, rtol=1e-5, atol=1e-5)

    run_files = {}
    for name, q_emb in (("ref", ref_q), ("ours", our_q)):
        searcher = BlockSearcher(top_k=len(pids), passage_chunk=8)
        s_, i_ = searcher.search(
            q_emb.astype(np.float32),
            [(corpus_emb.astype(np.float32), np.asarray(pids, np.int64))],
        )
        ranked = dedup_ranked_candidates(qids, s_, i_, None, len(pids))
        run_path = tmp_path / f"run_q_{name}.trec"
        write_run(ranked, str(run_path))
        run_files[name] = run_path

    la = open(run_files["ref"]).read().splitlines()
    lb = open(run_files["ours"]).read().splitlines()
    assert len(la) == len(lb)
    for a, b in zip(la, lb):
        fa, fb = a.split(), b.split()
        assert (fa[0], fa[2], fa[3]) == (fb[0], fb[2], fb[3]), (a, b)

    qrels, qrels_ndcg = read_qrels(str(qrel_file), 1)
    met_ref, _ = trec_metrics(read_run(str(run_files["ref"])), qrels, qrels_ndcg)
    met_ours, _ = trec_metrics(read_run(str(run_files["ours"])), qrels, qrels_ndcg)
    assert met_ref == met_ours
    assert met_ref["MRR"] > 0
