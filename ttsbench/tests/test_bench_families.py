"""A configuration's block family, found by its `model_type`: the Llama
family reproduces what the harness made before families were files, a
configuration no family serves is refused before any weights are made,
and a new family is a new file that the whole run reaches."""

import hashlib
import json
from pathlib import Path

import pytest

from ttsbench import families, readers, run, weights
from ttsbench.reference import protocol as P
from ttsbench.tests.tiny import TINY_CLOSED, TINY_MODEL

HERE = Path(__file__).resolve().parent
TOY_DIR = HERE / "toy_families"
MIX = dict(TINY_CLOSED, clients=4, greedy_share=0.75,
           check={"greedy": 16, "sampled": 16})
SEED = 2**31 + 7
LLAMA = families.of(TINY_MODEL)

# Recorded from the harness before families were files (the same
# functions, called directly): `weights.make_llama` of the tiny model at
# seed 5 on the CPU, `reference.llama.logits` of fixed ids, and
# `roofline.decode_launch` of a fixed record at each real configuration.
WEIGHTS_SHA256 = {
    True: "92748d3878c1597697a15ba81cabba0a6fd9346d4631f5f3c45c1dd6932dcd61",
    False: "1085718a9ea768a67e6e368de7b606aaff670b03bf8e8e87089de842a6d95f7b",
}
LOGITS = {"shape": (53, 28672), "sum": -659.8356798451439,
          "abs_sum": 194063.2970717399, (0, 0): 0.000575085636228323,
          (-1, -1): -0.013089031912386417, (7, 12345): -0.1496562510728836}
RECORD = {"n": 7, "lengths": [0, 100, 1000, 2559, 37],
          "active": [True, True, False, True, True]}
DECODE_LAUNCH = {
    "mistral7b-tts": {"flops": 407433248768.0,
                      "k1_bound_s": 0.0007471495259701493},
    "smollm2-1.7b-tts": {"flops": 97245790208.0,
                         "k1_bound_s": 0.0011157944167164177},
}


def _digest(tree) -> str:
    h = hashlib.sha256()

    def walk(path, x):
        if isinstance(x, dict):
            for k in sorted(x):
                walk(path + (k,), x[k])
        elif isinstance(x, list):
            for i, v in enumerate(x):
                walk(path + (i,), v)
        else:
            h.update(repr((path, str(x.dtype), tuple(x.shape))).encode())
            h.update(x.detach().contiguous().cpu().numpy().tobytes())

    walk((), tree)
    return h.hexdigest()


def _config(name):
    return json.loads((run.HERE / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("model_type", ["llama", "mistral"])
def test_llama_and_mistral_find_the_llama_family(model_type):
    fam = families.of({"model_type": model_type})
    assert Path(fam.__file__) == run.HERE / "families" / "llama.py"


@pytest.mark.parametrize("name", sorted(DECODE_LAUNCH))
def test_real_configurations_find_the_llama_family(name):
    assert families.of(_config(name)) is LLAMA


@pytest.mark.parametrize("model", [
    dict(TINY_MODEL, model_type="mellum"),
    {k: v for k, v in TINY_MODEL.items() if k != "model_type"},
], ids=["unknown", "missing"])
def test_no_family_is_refused_before_weights(model, monkeypatch):
    def made(*a, **k):
        raise AssertionError("weights made")

    monkeypatch.setattr(weights, "make_llama", made)
    monkeypatch.setattr(weights, "make_snac", made)
    with pytest.raises(LookupError) as err:
        run.run_cell(model, MIX, SEED, 1.0, False, "cpu")
    msg = str(err.value)
    assert repr(model.get("model_type")) in msg
    assert str(run.HERE / "families" / "llama.py") in msg


def test_no_family_exits_before_the_card_and_prints_nothing(monkeypatch,
                                                           capsys):
    cell, model, mix, ends, layers = run.load_cell("smollm2-agent")
    model = dict(model, model_type="mellum")
    monkeypatch.setattr(run, "load_cell",
                        lambda name: (cell, model, mix, ends, layers))
    monkeypatch.setattr(run, "cache_dirs", lambda: None)
    with pytest.raises(LookupError, match="'mellum'"):
        run.main(["--workload", "smollm2-agent", "--seed", "1",
                  "--seconds", "1"])
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("tied", [True, False])
def test_llama_weights_as_recorded(tied):
    model = dict(TINY_MODEL, tie_word_embeddings=tied)
    assert _digest(LLAMA.make_weights(model, 5, "cpu")) == \
        WEIGHTS_SHA256[tied]


def test_llama_reference_logits_as_recorded():
    params = LLAMA.make_weights(TINY_MODEL, 5, "cpu")
    ids = P.prompt_ids("a short line", "tara") + list(
        range(P.AUDIO_BASE, P.AUDIO_BASE + 40 * 97, 97))
    lo, hi = P.AUDIO_RANGE
    lg = LLAMA.logits(params, TINY_MODEL, ids, 10, lo, hi)
    assert tuple(lg.shape) == LOGITS["shape"]
    # float32 sums: the same function to the last bits on one machine;
    # room for another thread count's order of summation
    assert lg.double().sum().item() == pytest.approx(LOGITS["sum"],
                                                     abs=1e-2)
    assert lg.abs().double().sum().item() == pytest.approx(
        LOGITS["abs_sum"], rel=1e-6)
    for at in ((0, 0), (-1, -1), (7, 12345)):
        assert lg[at].item() == pytest.approx(LOGITS[at], rel=1e-5,
                                              abs=1e-7)


@pytest.mark.parametrize("name", sorted(DECODE_LAUNCH))
def test_llama_decode_launch_as_recorded(name):
    assert LLAMA.decode_launch(_config(name), RECORD) == DECODE_LAUNCH[name]


@pytest.fixture
def toy(monkeypatch):
    monkeypatch.setattr(families, "__path__",
                        [*families.__path__, str(TOY_DIR)])
    fam = families.of({"model_type": "toy-llama"})
    fam.CALLS.clear()
    return fam


def _decode_run(model):
    """A traced stretch [0, 1000) ns with one decode graph and its span."""
    ops = [(100, 300, "attention_mma_64_32", 1), (400, 200, "gemm", 1)]
    group = {"ops": ops, "kind": "decode", "t": 90, "dur_ns": 500}

    class Log:
        spans = [dict(RECORD, t=50, kind="decode", window=2560, row=0)]

    return {"model": model, "log": Log(),
            "trace": {"spans": [(0, 1000)], "ops": ops, "groups": [group],
                      "linked": 2}}


def test_a_new_family_is_a_new_file(toy):
    """The toy family, a file outside `families/`, serves the whole tiny
    cell on the CPU, and its functions are the ones called: weights, the
    port's configuration and the reference in a run; the int8 control
    when it is asked for; decode FLOPs and the K1 bound in the readers."""
    model = dict(TINY_MODEL, model_type="toy-llama")
    assert families.of(model) is toy
    assert str(TOY_DIR / "toy_llama.py") in map(str, families.files())
    greedy = dict(MIX, greedy_share=1.0)    # every compared request
    res = run.run_cell(model, greedy, SEED, 6.0, False, "cpu")
    assert res["correct"], res["checks"]
    calls = dict(toy.CALLS)
    assert calls["make_weights"] == 1 and calls["port_config"] >= 1
    assert calls["logits"] >= 1 and "control_params" not in calls
    assert "decode_launch" not in calls
    run.run_cell(model, MIX, SEED, 2.0, False, "cpu",
                 control={"quantize": True})
    assert toy.CALLS["control_params"] == 1
    mistral = _config("mistral7b-tts")
    traced = _decode_run(dict(mistral, model_type="toy-llama"))
    mfu, k1 = readers.step_mfu(traced), readers.k1_roofline(traced)
    assert toy.CALLS["decode_launch"] == 2
    assert mfu == readers.step_mfu(_decode_run(mistral))
    assert k1 == readers.k1_roofline(_decode_run(mistral))
    assert k1 == pytest.approx(
        100.0 * DECODE_LAUNCH["mistral7b-tts"]["k1_bound_s"] / 300e-9)
