"""The check catches a broken timed path: a whole run on the CPU at a
tiny size (the harness's look for a card skipped), with the port broken
underneath, reads `correct` false; unbroken, true. The faults a served
one-card cell can have: a decode step that leaves its state (the KV cache)
unchanged, half of the batch's rows left out (served the other half's
tokens), a token altered where it is sampled, the audio altered where
it is produced. A cell on one card has no exchange between cards."""

import numpy as np
import pytest
import torch

from ttsbench import run
from ttsbench.tests.tiny import TINY_CLOSED, TINY_MODEL

MIX = dict(TINY_CLOSED, clients=4, greedy_share=0.75,
           check={"greedy": 16, "sampled": 16})
SEED = 2**31 + 99


def _run():
    return run.run_cell(TINY_MODEL, MIX, SEED, 6.0, False, "cpu")


def test_sound_run_is_correct():
    res = _run()
    assert res["correct"], res["checks"]
    assert res["checks"]["requests_compared"]["value"] >= 3


def _wrap_sample(monkeypatch, change):
    from tts_inference_tpu_torch.ops import sampling

    orig = sampling.sample

    def sample(*a, **k):
        tok, st = orig(*a, **k)
        return change(tok), st

    monkeypatch.setattr(sampling, "sample", sample)


def test_state_left_unchanged(monkeypatch):
    from tts_inference_tpu_torch.models import llama

    monkeypatch.setattr(llama, "_write_cache", lambda *a, **k: None)
    assert not _run()["correct"]


def test_half_the_batch_left_out(monkeypatch):
    def half(tok):
        # each half's rows left out in turn, served the other half's
        h = tok.shape[0] // 2
        return torch.cat([tok[h:], tok[:h]])

    _wrap_sample(monkeypatch, half)
    assert not _run()["correct"]


def test_token_altered(monkeypatch):
    lo, hi = 128266, 128266 + 7 * 4096

    def bump(tok):
        inside = (tok >= lo) & (tok < hi - 1)
        return torch.where(inside, tok + 1, tok)

    _wrap_sample(monkeypatch, bump)
    res = _run()
    assert not res["correct"]
    assert res["checks"]["logit_gap_max"]["value"] > \
        res["checks"]["logit_gap_max"]["limit"]


def test_audio_altered(monkeypatch):
    from tts_inference_tpu_torch.engine import scheduler

    orig = scheduler.pcm16_bytes

    def louder(a):
        b = np.frombuffer(orig(a), np.int16).astype(np.int32) + 8
        return np.clip(b, -32768, 32767).astype(np.int16).tobytes()

    monkeypatch.setattr(scheduler, "pcm16_bytes", louder)
    res = _run()
    assert not res["correct"]
    assert res["checks"]["pcm_rms_lsb"]["value"] > \
        res["checks"]["pcm_rms_lsb"]["limit"]


@pytest.mark.card
@pytest.mark.parametrize("config, mix", [
    ("smollm2-1.7b-tts", "agent-1.6rps"), ("mistral7b-tts", "agent-1.0rps")])
def test_control_fails_on_the_card(card, config, mix):
    """The controls, on the card: the port's int8-weight path and the
    TF32 reference vocoder in the port's place, on each configuration with
    an 8-second window of agent traffic, against its limits."""
    import json

    model = json.loads((run.HERE / "configs" / f"{config}.json").read_text())
    mix = json.loads((run.HERE / "traffic" / f"{mix}.json").read_text())
    mix = dict(mix, ramp_s=2.0)
    for control, key in (({"quantize": True}, "logit_gap_mean"),
                         ({"tf32_vocoder": True}, "pcm_rms_lsb")):
        res = run.run_cell(model, mix, 5, 8.0, False, "cuda",
                           control=control)
        assert not res["correct"], (control, res["checks"])
        assert res["checks"][key]["value"] > res["checks"][key]["limit"]
