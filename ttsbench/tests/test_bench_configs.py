"""The configuration files hold the published widths, and BENCHMARK.json
names only what the harness can find."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
HERE = ROOT / "ttsbench"

WIDTHS = {
    "mistral7b-tts": dict(hidden_size=4096, intermediate_size=14336,
                          num_hidden_layers=32, num_attention_heads=32,
                          num_key_value_heads=8, head_dim=128,
                          rope_theta=1000000.0, rms_norm_eps=1e-5,
                          tie_word_embeddings=False,
                          torch_dtype="bfloat16", vocab_size=156940),
    "smollm2-1.7b-tts": dict(hidden_size=2048, intermediate_size=8192,
                             num_hidden_layers=24, num_attention_heads=32,
                             num_key_value_heads=32, head_dim=64,
                             rope_theta=130000.0, rms_norm_eps=1e-5,
                             tie_word_embeddings=True,
                             torch_dtype="bfloat16", vocab_size=156940),
}


@pytest.mark.parametrize("name", sorted(WIDTHS))
def test_config_holds_published_widths(name):
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    for k, v in WIDTHS[name].items():
        assert cfg[k] == v, k
    assert cfg["reduced"] == ["vocab_size"]
    entry = next(c for c in BENCH["configs"] if c["name"] == name)
    assert entry["file"] == f"ttsbench/configs/{name}.json"
    assert entry["source"] == cfg["source"]
    assert entry["reduced"] == cfg["reduced"]
    assert {"logit_gap_mean", "pcm_rms_lsb"} <= set(cfg["check"]) <= {
        "logit_gap_max", "logit_gap_mean", "pcm_rms_lsb"}


def test_every_cell_finds_its_files_and_metrics():
    from ttsbench import run

    names = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    for w in BENCH["workloads"]:
        assert names.match(w["name"]) and w["chips"] == 1
        cell, model, mix, ends, layers = run.load_cell(w["name"])
        assert "setup_s" in ends and len(ends) >= 2 and layers
        for m in layers:
            assert callable(run.reader(m))
    for m in BENCH["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").exists()
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    assert BENCH["command"][:3] == ["python3", "-m", "ttsbench.run"]


def _model_and_mix(cell):
    from ttsbench import run

    _, model, mix, _, _ = run.load_cell(cell)
    return model, mix


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_engine_blocks_reach_the_port(cell):
    from ttsbench.serve import port_config

    model, mix = _model_and_mix(cell)
    ec = port_config(model, mix).engine
    for block in (model["engine"], mix["engine"]):
        for k, v in block.items():
            if k != "kv_cache":
                want = tuple(v) if isinstance(v, list) else v
                assert getattr(ec, k) == want, k


@pytest.mark.parametrize("change", [
    {"rope_scaling": {"rope_type": "llama3", "factor": 8.0}},
    {"sliding_window": 4096},
    {"attention_bias": True},
    {"hidden_act": "gelu"},
    {"engine": {"max_batch_size": 4, "kv_cache": "dense bfloat16",
                "speculative": True}},
    {"engine": {"max_batch_size": 4, "kv_cache": "paged int8"}},
    {"snac": {"dtype": "float32", "width": 3}},
])
def test_port_config_refuses_what_it_cannot_run(change):
    from ttsbench.serve import port_config
    from ttsbench.tests.tiny import TINY_MODEL, TINY_OPEN

    with pytest.raises(ValueError):
        port_config(dict(TINY_MODEL, **change), TINY_OPEN)


def test_reference_refuses_rope_scaling():
    from ttsbench.reference import llama
    from ttsbench.tests.tiny import TINY_MODEL

    with pytest.raises(ValueError):
        llama.logits({"embed": None},
                     dict(TINY_MODEL, rope_scaling={"factor": 8.0}),
                     [1, 2], 0, 0, 2)


@pytest.mark.parametrize("mix", sorted(
    p.stem for p in (HERE / "traffic").glob("*.json")))
def test_traffic_names_its_sources(mix):
    d = json.loads((HERE / "traffic" / f"{mix}.json").read_text())
    assert d["arrivals"] and d["source"]["audio_s"]
    assert d["source"]["text_bytes"] and d["source"]["greedy_share"]
    if d["loop"] == "open":
        assert "Poisson process" in d["arrivals"] and d["rate_source"]
