"""Integration: the full offline data chain and the BM25 CLI.

L0 preprocess -> PRJ probes -> (labels) -> BM25 mining CLI -> negative
merges -> reformulate -> training dataset builder, all on a synthetic
TopiOCQA-shaped dump — the reference README's pipeline order
(/root/reference/README.md:15-98) end to end, minus the device passes covered
by test_e2e.
"""

import json
import os

import pytest

from haconvdr_tpu.cli.bm25_search import main as bm25_main
from haconvdr_tpu.config import DataConfig
from haconvdr_tpu.data.topiocqa import build_topiocqa_train_examples
from haconvdr_tpu.mine.analysis import format_nl_query, is_nl_query
from haconvdr_tpu.mine.prj import convert_gold_to_trec, create_label_rel_turn
from haconvdr_tpu.preprocess import topiocqa as pt
from haconvdr_tpu.utils.io import read_jsonl_list, write_jsonl
from haconvdr_tpu.utils.testing import FakeTokenizer


def _collection(tmp, n=30):
    path = tmp / "coll.tsv"
    with open(path, "w") as f:
        f.write("id\ttext\ttitle\n")
        for pid in range(1, n + 1):
            f.write(f"{pid}\tcontent about topic{pid} item{pid}\tTitle [SEP] {pid}\n")
    return str(path)


def test_full_offline_chain(tmp_path):
    coll = _collection(tmp_path)
    qid2passage = {
        pid: f"Title {pid} content about topic{pid} item{pid}" for pid in range(1, 31)
    }

    # L0: raw gold dumps -> train.json
    gold = [
        {"conv_id": 1, "turn_id": 1, "question": "what is topic3", "answers": ["a1"],
         "positive_ctxs": [{"passage_id": "3", "title": "T", "text": "content about topic3 item3"}]},
        {"conv_id": 1, "turn_id": 2, "question": "tell me more", "answers": ["a2"],
         "positive_ctxs": [{"passage_id": "7", "title": "T", "text": "content about topic7 item7"}]},
    ]
    (tmp_path / "gold_train.json").write_text(json.dumps(gold))
    (tmp_path / "gold_dev.json").write_text(json.dumps(gold))
    pt.gen_train_test_files(
        str(tmp_path / "gold_train.json"), str(tmp_path / "gold_dev.json"),
        str(tmp_path / "train.json"), str(tmp_path / "test.json"),
        qid2passage=qid2passage, num_passages=30,
    )

    # PRJ probes + gold trec from the combined layout
    combined = [
        {"id": "1-1", "conv_id": 1, "turn_id": 1, "query": "what is topic3",
         "rewrite": "what is topic3", "history_query": [], "history_rewrite": [],
         "history_answer": [], "last_response": "", "topic": "t", "sub_topic": "s",
         "pos_docs": [qid2passage[3]], "pos_docs_id": [3]},
        {"id": "1-2", "conv_id": 1, "turn_id": 2, "query": "tell me more",
         "rewrite": "more about topic7", "history_query": ["what is topic3"],
         "history_rewrite": ["what is topic3"], "history_answer": ["a1"],
         "last_response": qid2passage[3], "topic": "t", "sub_topic": "s",
         "pos_docs": [qid2passage[7]], "pos_docs_id": [7]},
    ]
    probes = create_label_rel_turn(combined)
    assert [p["id"] for p in probes] == ["1-2-0", "1-2-1"]
    assert len(convert_gold_to_trec(probes)) == 2

    # PRJ labels (as the dense pass would emit them)
    write_jsonl(
        [
            {"id": "1-1", "rel_label": []},
            {"id": "1-2", "rel_label": [1]},
        ],
        str(tmp_path / "rel.json"),
    )
    pt.merge_rel_label_info(
        str(tmp_path / "rel.json"), str(tmp_path / "train.json"),
        str(tmp_path / "train_rel.json"),
    )

    # BM25 CLI: index the collection, mine negatives with convq queries
    idx_dir = str(tmp_path / "bm25_idx")
    bm25_main(["index", f"data.collection_path={coll}",
               f"bm25.index_dir_path={idx_dir}"])
    query_file = str(tmp_path / "queries.json")
    write_jsonl(
        [
            {"sample_id": "TopiOCQA-Train_1_1", "query": "content about topic3",
             "history_query": [], "history_answer": []},
            {"sample_id": "TopiOCQA-Train_1_2", "query": "content about topic7",
             "history_query": ["content about topic3"], "history_answer": ["a1"]},
        ],
        query_file,
    )
    run_path = str(tmp_path / "bm25.trec")
    bm25_main([
        "search", f"bm25.index_dir_path={idx_dir}",
        f"data.test_file_path={query_file}", "query_type=raw",
        f"output_trec={run_path}", "bm25.top_k=5",
    ])
    lines = open(run_path).read().splitlines()
    assert lines, "bm25 run empty"
    # the exact-match passage must rank first for query 1
    first = [l for l in lines if l.startswith("TopiOCQA-Train_1_1 ")][0]
    assert first.split()[2] == "3"

    # merge bm25 negatives + extract doc text + reformulate
    pt.merge_bm25_neg_info(run_path, str(tmp_path / "train_rel.json"),
                           str(tmp_path / "train_negs.json"))
    pt.extract_doc_content_of_bm25_hard_negs_for_train_file(
        "", str(tmp_path / "train_negs.json"), str(tmp_path / "train_negs.json"),
        qid2passage=qid2passage,
    )
    pt.reformulate_dataset_info(str(tmp_path / "train_negs.json"),
                                str(tmp_path / "train_info.json"))
    final = read_jsonl_list(str(tmp_path / "train_info.json"))
    assert final[1]["rel_label"] == [1]
    assert final[1]["pseudo_prepos_docs_pids"] == [3]
    assert len(final[1]["bm25_hard_neg_docs"]) >= 1

    # and the training dataset builder consumes it
    cfg = DataConfig(max_query_length=12, max_doc_length=16,
                     max_response_length=12, max_concat_length=48,
                     use_PRL=True, is_train=True)
    examples = build_topiocqa_train_examples(cfg, FakeTokenizer(),
                                             str(tmp_path / "train_info.json"))
    assert len(examples) == 2
    assert examples[1]["has_pseudo_prepos"] == 1


def test_nl_query_format():
    assert is_nl_query("what is this")
    assert not is_nl_query("tell me about x")
    assert format_nl_query("what is this?") == "What is this?"
    assert format_nl_query("tell me") == "Tell me."


def test_bm25_decode_mode_cli(tmp_path):
    """decode query mode through the CLI: the query comes from
    oracle_utt_text / the second decoding file's answer_utt_text
    (bm25/bm25_topiocqa.py:135-142, :28-29)."""
    coll = _collection(tmp_path)
    idx_dir = str(tmp_path / "bm25_idx2")
    bm25_main(["index", f"data.collection_path={coll}",
               f"bm25.index_dir_path={idx_dir}"])
    query_file = str(tmp_path / "dec_queries.json")
    write_jsonl(
        [{"sample_id": "1_1", "oracle_utt_text": "content about topic5",
          "query": "ignored"}],
        query_file,
    )
    decode_file = str(tmp_path / "dec2.json")
    write_jsonl([{"answer_utt_text": "content about topic9"}], decode_file)

    run = str(tmp_path / "dec.trec")
    bm25_main([
        "search", f"bm25.index_dir_path={idx_dir}",
        f"data.test_file_path={query_file}", "query_type=decode",
        f"output_trec={run}", "bm25.top_k=3",
    ])
    assert open(run).read().splitlines()[0].split()[2] == "5"  # oracle text

    bm25_main([
        "search", f"bm25.index_dir_path={idx_dir}",
        f"data.test_file_path={query_file}", "query_type=decode",
        "eval_type=answer", f"decode_file={decode_file}",
        f"output_trec={run}", "bm25.top_k=3",
    ])
    assert open(run).read().splitlines()[0].split()[2] == "9"  # answer text

    bm25_main([
        "search", f"bm25.index_dir_path={idx_dir}",
        f"data.test_file_path={query_file}", "query_type=decode",
        "eval_type=oracle+answer", f"decode_file={decode_file}",
        f"output_trec={run}", "bm25.top_k=3",
    ])
    top2 = {l.split()[2] for l in open(run).read().splitlines()[:2]}
    assert top2 == {"5", "9"}  # both texts contribute
