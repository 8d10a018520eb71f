"""Config system tests: TOML loading (sectioned + flat), overrides, bools."""

import pytest

from haconvdr_tpu.config import config_from_argv, load_config, parse_bool


def test_sectioned_toml(tmp_path):
    p = tmp_path / "cfg.toml"
    p.write_text(
        """
[data]
dataset = "qrecc"
use_PRL = false
max_concat_length = 256

[train]
learning_rate = 3e-5
accumulation_steps = 4

[search]
top_k = 50
"""
    )
    cfg = load_config(str(p))
    assert cfg.data.dataset == "qrecc"
    assert cfg.data.use_PRL is False
    assert cfg.data.max_concat_length == 256
    assert cfg.train.learning_rate == 3e-5
    assert cfg.search.top_k == 50
    # untouched defaults
    assert cfg.search.rel_threshold == 1


def test_flat_toml_routes_to_all_sections(tmp_path):
    """The reference's flat Config/*.toml style: keys land wherever they
    are declared (gen_tokenized_doc.py:352-368)."""
    p = tmp_path / "flat.toml"
    p.write_text('max_seq_length = 128\nseed = 7\nmodel_type = "BERT"\n')
    cfg = load_config(str(p))
    assert cfg.index.max_seq_length == 128
    assert cfg.data.seed == 7 and cfg.train.seed == 7
    assert cfg.model.model_type == "BERT"


def test_overrides():
    cfg = load_config(None, ["train.learning_rate=1e-4", "top_k=7", "use_PRL=false"])
    assert cfg.train.learning_rate == 1e-4
    assert cfg.search.top_k == 7 and cfg.bm25.top_k == 7
    assert cfg.data.use_PRL is False
    with pytest.raises(ValueError):
        load_config(None, ["no_such_key=1"])


def test_remat_union_override():
    # model.remat is bool|str: booleans parse strictly, "mlp" passes through
    assert load_config(None, ["model.remat=true"]).model.remat is True
    assert load_config(None, ["model.remat=false"]).model.remat is False
    assert load_config(None, ["model.remat=mlp"]).model.remat == "mlp"
    # strict-bool fields still reject arbitrary strings
    with pytest.raises(ValueError):
        load_config(None, ["train.is_prepos_neg=mlp"])


def test_config_from_argv():
    cfg = config_from_argv(["--search.top_k=9", "data.mode=convqa"])
    assert cfg.search.top_k == 9
    assert cfg.data.mode == "convqa"


def test_parse_bool_strict():
    assert parse_bool("true") and parse_bool("1") and parse_bool("YES")
    assert not parse_bool("false") and not parse_bool("0")
    # the reference argparse type=bool footgun must NOT exist here:
    # arbitrary non-empty strings are errors, not True
    with pytest.raises(ValueError):
        parse_bool("False-ish")
