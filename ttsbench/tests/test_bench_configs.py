"""The configuration files hold the published widths, and BENCHMARK.json
names only what the harness can find."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
HERE = ROOT / "ttsbench"

PUBLISHED = HERE / "tests" / "published"


@pytest.mark.parametrize("name", sorted(c["name"] for c in BENCH["configs"]))
def test_config_holds_published_widths(name):
    """`tests/published/<config>.json`: the published values the file has
    to hold, and its `reduced`."""
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    want = json.loads((PUBLISHED / f"{name}.json").read_text())
    for k, v in want.items():
        assert cfg[k] == v, k
    entry = next(c for c in BENCH["configs"] if c["name"] == name)
    assert entry["file"] == f"ttsbench/configs/{name}.json"
    assert entry["source"] == cfg["source"]
    assert entry["reduced"] == cfg["reduced"]
    assert {"logit_gap_mean", "pcm_rms_lsb"} <= set(cfg["check"]) <= {
        "logit_gap_max", "logit_gap_mean", "pcm_rms_lsb"}


def test_every_cell_finds_its_files_and_metrics():
    from ttsbench import families, run

    names = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    for w in BENCH["workloads"]:
        assert names.match(w["name"]) and w["chips"] == 1
        cell, model, mix, ends, layers = run.load_cell(w["name"])
        assert families.of(model).MODEL_TYPES
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
    from ttsbench import families

    model, mix = _model_and_mix(cell)
    ec = families.of(model).port_config(model, mix).engine
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
    from ttsbench import families
    from ttsbench.tests.tiny import TINY_MODEL, TINY_OPEN

    model = dict(TINY_MODEL, **change)
    with pytest.raises(ValueError):
        families.of(model).port_config(model, TINY_OPEN)


def test_reference_refuses_rope_scaling():
    from ttsbench import families
    from ttsbench.tests.tiny import TINY_MODEL

    model = dict(TINY_MODEL, rope_scaling={"factor": 8.0})
    with pytest.raises(ValueError):
        families.of(model).logits({"embed": None}, model, [1, 2], 0, 0, 2)


@pytest.mark.parametrize("mix", sorted(
    p.stem for p in (HERE / "traffic").glob("*.json")))
def test_traffic_names_its_sources(mix):
    d = json.loads((HERE / "traffic" / f"{mix}.json").read_text())
    assert d["arrivals"] and d["source"]["audio_s"]
    assert d["source"]["text_bytes"] and d["source"]["greedy_share"]
    if d["loop"] == "open":
        assert "Poisson process" in d["arrivals"] and d["rate_source"]
