"""PRJ mining and BM25 engine tests."""

import os

import numpy as np
import pytest

from haconvdr_tpu.mine.analysis import LUCENE_STOPWORDS, analyze, porter_stem
from haconvdr_tpu.mine.bm25 import BM25Index, _lib
from haconvdr_tpu.mine.prj import (
    convert_gold_to_trec,
    create_label_rel_token,
    create_label_rel_turn,
    create_prj_triples,
    create_topic_rel_turn,
    improve_judge,
    judge_stats,
    rel_label_records,
)


# ---------------------------------------------------------------------------
# PRJ
# ---------------------------------------------------------------------------

def _conv_records():
    return [
        {"id": "1-1", "conv_id": 1, "turn_id": 1, "query": "q1",
         "history_query": [], "history_rewrite": [], "history_answer": [],
         "last_response": "", "topic": "A", "sub_topic": "a",
         "pos_docs": ["d1"], "pos_docs_id": [11], "rewrite": "r1"},
        {"id": "1-2", "conv_id": 1, "turn_id": 2, "query": "q2",
         "history_query": ["q1"], "history_rewrite": ["r1"], "history_answer": ["a1"],
         "last_response": "d1", "topic": "A", "sub_topic": "b",
         "pos_docs": ["d2"], "pos_docs_id": [22], "rewrite": "r2"},
        {"id": "1-3", "conv_id": 1, "turn_id": 3, "query": "q3",
         "history_query": ["q1", "q2"], "history_rewrite": ["r1", "r2"],
         "history_answer": ["a1", "a2"], "last_response": "d2", "topic": "B",
         "sub_topic": "b", "pos_docs": ["d3"], "pos_docs_id": [33], "rewrite": "r3"},
    ]


def test_create_label_rel_turn():
    probes = create_label_rel_turn(_conv_records())
    ids = [p["id"] for p in probes]
    # turn 2 -> probes 0,1; turn 3 -> probes 0,1,2 (preprocess/PRJ_topiocqa.py:260-299)
    assert ids == ["1-2-0", "1-2-1", "1-3-0", "1-3-1", "1-3-2"]
    assert probes[1]["query_pair"] == "q1"
    assert probes[4]["query_pair"] == "q2"
    assert probes[0]["query_pair"] == ""
    assert probes[3]["rewrite_query_pair"] == "r1"


def test_create_label_rel_token():
    recs = [
        {"conv_id": 1, "turn_id": 2, "query": "q2",
         "history_query": ["alpha beta", "gamma"], "pos_docs_id": [5]},
    ]
    probes = create_label_rel_token(recs)
    assert [p["query_pair"] for p in probes] == ["", "alpha", "beta", "gamma"]


def test_create_topic_rel_turn():
    out = create_topic_rel_turn(_conv_records(), mode="topic")
    assert out[0]["rel_label"] == []
    assert out[1]["rel_label"] == [1]       # turn2 vs turn1: topic A == A
    assert out[2]["rel_label"] == [0, 0]    # turn3 topic B vs A, A


def test_convert_gold_to_trec():
    lines = convert_gold_to_trec(create_label_rel_turn(_conv_records()))
    assert lines[0] == "1-2-0 Q0 22 1"
    assert len(lines) == 5


def test_improve_judge_mrr_diff():
    probes = create_label_rel_turn(_conv_records())
    # turn 2: base 0.5, probe1 0.8 -> label 1
    # turn 3: base 0.5, probe1 0.5 (not strictly greater -> 0), probe2 0.9 -> 1
    mrr = {"1-2-0": 0.5, "1-2-1": 0.8, "1-3-0": 0.5, "1-3-1": 0.5, "1-3-2": 0.9}
    rel = improve_judge(probes, mrr)
    assert rel["1-1"] == []
    assert rel["1-2"] == [1]
    assert rel["1-3"] == [0, 1]
    ones, zeros = judge_stats(rel)
    # "1-2" has len==1 -> one; "1-3" [0,1] has a 1 beyond index 0 -> one
    assert (ones, zeros) == (2, 0)
    recs = rel_label_records(rel)
    assert {r["id"] for r in recs} == {"1-1", "1-2", "1-3"}


def test_improve_judge_conv_boundary_with_same_turn_id():
    """Flush on conversation change even when turn ids collide
    (src/test_PRJ_qrecc.py:441 boundary condition)."""
    probes = [
        {"id": "1-2-0"}, {"id": "1-2-1"},
        {"id": "2-2-0"}, {"id": "2-2-1"},
    ]
    mrr = {"1-2-0": 0.1, "1-2-1": 0.9, "2-2-0": 0.9, "2-2-1": 0.1}
    rel = improve_judge(probes, mrr)
    assert rel["1-2"] == [1]
    assert rel["2-2"] == [0]


def test_improve_judge_qrel_filter():
    probes = [{"id": "1-2-0"}, {"id": "1-2-1"}]
    mrr = {"1-2-0": 0.5, "1-2-1": 0.6}
    rel = improve_judge(probes, mrr, qrel_ids={"9-1"})
    assert "1-1" not in rel  # conv 1 turn 1 absent from original qrels
    assert rel["1-2"] == [1]


def test_create_prj_triples():
    labels = [
        {"id": "1-2", "rel_label": [1]},
        {"id": "1-3", "rel_label": [0, 1]},
    ]
    queries = [
        {"query": "q2", "history_query": ["q1"]},
        {"query": "q3", "history_query": ["q1", "q2"]},
    ]
    triples = create_prj_triples(labels, queries)
    assert len(triples) == 3
    assert triples[0] == {"id": "1-2-1", "query": "q2", "rel_query": "q1", "rel_label": 1}
    assert triples[2]["rel_label"] == 1


# ---------------------------------------------------------------------------
# Analysis
# ---------------------------------------------------------------------------

def test_porter_stem_classic_cases():
    cases = {
        "caresses": "caress", "ponies": "poni", "cats": "cat",
        "feed": "feed", "agreed": "agre", "plastered": "plaster",
        "motoring": "motor", "sing": "sing", "conflated": "conflat",
        "troubling": "troubl", "sized": "size", "hopping": "hop",
        "falling": "fall", "happy": "happi", "relational": "relat",
        "conditional": "condit", "vietnamization": "vietnam",
        "triplicate": "triplic", "formative": "form", "electrical": "electr",
        "hopefulness": "hope", "revival": "reviv", "allowance": "allow",
        "inference": "infer", "probate": "probat", "rate": "rate",
        "controlling": "control",
    }
    for word, stem in cases.items():
        assert porter_stem(word) == stem, (word, porter_stem(word), stem)


def test_analyze_chain():
    toks = analyze("The Quick brown foxes are JUMPING, over 2 lazy dogs!")
    assert "the" not in toks and "are" not in toks  # stopwords
    assert "jump" in toks and "fox" in toks  # stemming
    assert "2" in toks


# ---------------------------------------------------------------------------
# BM25
# ---------------------------------------------------------------------------

_DOCS = [
    ("doc0", "the cat sat on the mat"),
    ("doc1", "dogs and cats living together"),
    ("doc2", "a quantum theory of gravitation"),
    ("doc3", "cat cat cat cat"),
    ("doc4", "the dog chased the cat up a tree"),
]


def _build(native_ok=True):
    idx = BM25Index(stemming=True)
    idx.add_many(_DOCS)
    idx.finalize()
    return idx


def _bm25_manual(idx, query, k1=0.9, b=0.4):
    """Independent brute-force BM25 for cross-checking."""
    from haconvdr_tpu.mine.analysis import analyze as an

    N = len(idx.doc_ids)
    scores = np.zeros(N)
    doc_tokens = [an(t) for _, t in _DOCS]
    dls = np.array([len(t) for t in doc_tokens], float)
    avgdl = dls.mean()
    for t in an(query):
        df = sum(1 for toks in doc_tokens if t in toks)
        if df == 0:
            continue
        idf = np.log(1 + (N - df + 0.5) / (df + 0.5))
        for d, toks in enumerate(doc_tokens):
            tf = toks.count(t)
            if tf:
                scores[d] += idf * tf / (tf + k1 * (1 - b + b * dls[d] / avgdl))
    return scores


def test_bm25_scores_match_bruteforce():
    idx = _build()
    for query in ("cat", "cat dog", "quantum gravitation theory", "missing term"):
        expect = _bm25_manual(idx, query)
        hits = idx.search(query, k=5)
        got = {d: s for d, s in hits}
        for d in range(len(_DOCS)):
            if expect[d] > 0:
                assert abs(got[f"doc{d}"] - expect[d]) < 1e-5, (query, d)


def test_bm25_native_and_fallback_agree(monkeypatch):
    idx = _build()
    docs_n, scores_n = idx.batch_search(["cat dog", "quantum"], k=3)
    if _lib() is None:
        pytest.skip("native library unavailable")
    import haconvdr_tpu.mine.bm25 as m

    monkeypatch.setattr(m, "_LIB", False)  # force numpy fallback
    idx2 = _build()
    docs_p, scores_p = idx2.batch_search(["cat dog", "quantum"], k=3)
    np.testing.assert_array_equal(docs_n, docs_p)
    np.testing.assert_allclose(scores_n, scores_p, rtol=1e-5)


def test_bm25_native_library_keyed_on_source_and_host(monkeypatch, tmp_path):
    """The library is built from the committed source into build/, under
    a name keyed on the source, the flags and the host: a library built
    elsewhere, or from another source, is never loaded."""
    import haconvdr_tpu.mine.bm25 as m

    so = m._so_path()
    assert os.path.dirname(so) == m._BUILD_DIR
    with monkeypatch.context() as mp:
        src = tmp_path / "bm25.cpp"
        src.write_bytes(open(m._SRC_PATH, "rb").read() + b"\n// changed\n")
        mp.setattr(m, "_SRC_PATH", str(src))
        assert m._so_path() != so
    with monkeypatch.context() as mp:
        mp.setattr(m.platform, "uname", lambda: ("Linux", "other", "6", "", "x86_64", ""))
        assert m._so_path() != so
    assert m._so_path() == so


def test_bm25_save_load(tmp_path):
    idx = _build()
    idx.save(str(tmp_path / "bm25"))
    idx2 = BM25Index.load(str(tmp_path / "bm25"))
    h1 = idx.search("cat dog", k=4)
    h2 = idx2.search("cat dog", k=4)
    assert h1 == h2


def test_bm25_topk_padding():
    idx = _build()
    docs, scores = idx.batch_search(["quantum"], k=10)
    assert (docs[0] >= 0).sum() == 1  # only one match
    assert docs[0][0] == 2
    assert (docs[0][1:] == -1).all()


def test_metrics_logger(tmp_path):
    import json as _json

    from haconvdr_tpu.utils.telemetry import MetricsLogger, Timer

    path = str(tmp_path / "m.jsonl")
    m = MetricsLogger(path, flush_every=1)
    m.log("train_step", loss=1.5, step=3)
    with Timer(m, "search", block=0):
        pass
    m.close()
    recs = [_json.loads(l) for l in open(path)]
    assert recs[0]["event"] == "train_step" and recs[0]["loss"] == 1.5
    assert recs[1]["event"] == "search" and "seconds" in recs[1]
    # disabled sink is a no-op
    m2 = MetricsLogger("")
    m2.log("x")
    m2.close()
