"""PyTorch port, the scheduler surface ``bench.py`` drives, on the CPU:

- ``pipeline_depth`` 1 and 2 give the same tokens and PCM, and depth 1
  never holds more than one launch in flight (depth 2 does hold two);
- ``tick_profile`` is None until ``enable_tick_profile()``, then has
  exactly the JAX package's six keys, with ticks > 0 and every value >= 0.
"""

import collections

import pytest
import torch

from tts_inference_tpu.config import SamplingConfig, StreamConfig, tiny_config
from tts_inference_tpu.engine import scheduler as JS
from tts_inference_tpu_torch.engine import scheduler as TS
from tts_inference_tpu_torch.runtime import Runtime

from tests.torch_port_helpers import (AUDIO_RANGE, numpy_llama_tree,
                                      numpy_snac_tree, port_config)

SCFG = StreamConfig(frames_per_chunk=2, lookahead_frames=3,
                    left_context_frames=4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: the suite runs it beside
    other files' CPU-bound workers and servers, which wait on starved
    OpenMP threads when every worker takes all the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rt():
    cfg = tiny_config()
    return Runtime.create(port_config(cfg), device="cpu",
                          llama_tree=numpy_llama_tree(cfg.model, seed=0),
                          snac_tree=numpy_snac_tree(cfg.snac, seed=1))


class _Deepest(collections.deque):
    """The launch queue, keeping the most launches it ever held."""

    most = 0

    def append(self, x):
        super().append(x)
        self.most = max(self.most, len(self))


def _run(rt, depth=None, profile=False):
    """Three stochastic streams of different lengths, a fourth admitted
    beside them after six steps; returns (scheduler, [(PCM, tokens)])."""
    s = TS.Scheduler(rt.engine.core.params, rt.config, rt.vocoder,
                     rt.tokenizer)
    if depth is not None:
        s.pipeline_depth = depth
    if profile:
        s.enable_tick_profile()
    s._inflight = _Deepest()
    reqs = [TS.TTSRequest(text=f"depth {i}", sampling=port_config(
        SamplingConfig(max_tokens=21 + 14 * i, seed=40 + i,
                       repetition_penalty=1.1, token_range=AUDIO_RANGE)),
        stream_cfg=port_config(SCFG), force_speech=True) for i in range(4)]
    for r in reqs[:3]:
        s.submit(r)
    for k in range(4000):
        if k == 6:
            s.submit(reqs[3])
        if not s.step() and k > 6 and s.n_queued == 0 and not s.n_active:
            break
    s.drain_vocoder()
    out = []
    for r in reqs:
        chunks = []
        while True:
            kind, payload = r.events.get(timeout=120)
            if kind == "chunk":
                chunks.append(payload.pcm)
            elif kind == "done":
                out.append((b"".join(chunks), payload.tokens))
                break
            else:
                raise AssertionError(payload)
    s.stop()
    return s, out


def test_pipeline_depth_one_and_two_give_the_same_streams(rt):
    s1, one = _run(rt, depth=1)
    s2, two = _run(rt)
    assert s2.pipeline_depth == 2
    assert one == two
    assert [t for _, t in one] == [21, 35, 49, 63]
    assert s1._inflight.most == 1 and s2._inflight.most == 2


def test_tick_profile_keys(rt):
    jax_keys = {"fetch_s", "host_tokens_s", "fused_pcm_s", "vocode_plan_s",
                "admit_launch_s", "ticks"}
    plain = TS.Scheduler(rt.engine.core.params, rt.config, rt.vocoder,
                         rt.tokenizer)
    assert plain.tick_profile is None
    s, _ = _run(rt, profile=True)
    prof = s.tick_profile
    assert set(prof) == jax_keys
    assert prof["ticks"] > 0 and all(v >= 0 for v in prof.values())
    assert prof["fetch_s"] > 0 and prof["admit_launch_s"] > 0
    # a copy: the caller's edits leave the scheduler's alone
    prof["ticks"] = -1
    assert s.tick_profile["ticks"] > 0
    # the JAX scheduler's profile has the same keys
    js = JS.Scheduler.__new__(JS.Scheduler)
    js._prof = None
    JS.Scheduler.enable_tick_profile(js)
    assert set(js.tick_profile) == jax_keys
