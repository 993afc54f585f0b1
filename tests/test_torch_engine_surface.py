"""PyTorch port, the JAX engine's host surface, against the JAX package on
the CPU: ``EngineCore.decode_steps`` (a blocking ``decode_steps_launch``
with host arrays out), ``reset_slots`` and ``seed_slots``;
``TTSRequest.iter_chunks``, ``Scheduler.synthesize_request`` and
``engine.BACKENDS``; the three core methods mirrored under lockstep
(``parallel/lockstep.MIRRORED``), once on a gloo pair. Same numpy weights
on both sides; greedy tokens must be equal."""

import dataclasses
import os
import queue
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tts_inference_tpu.config import (EngineConfig, SamplingConfig,
                                      StreamConfig, tiny_config)
from tts_inference_tpu.engine import scheduler as JS
from tts_inference_tpu.engine.engine import EngineCore as JCore
from tts_inference_tpu.ops import sampling as jS
from tts_inference_tpu_torch import weights as W
from tts_inference_tpu_torch.engine import scheduler as TS
from tts_inference_tpu_torch.engine.engine import EngineCore as TCore
from tts_inference_tpu_torch.ops import sampling as tS
from tts_inference_tpu_torch.runtime import Runtime

from tests import torch_mesh_work as MW
from tests.torch_gloo_pool import GlooPool, free_port
from tests.torch_port_helpers import (AUDIO_RANGE, numpy_llama_tree,
                                      numpy_snac_tree, port_config, to_jax)

LM = tiny_config().model            # vocab 512
DENSE = EngineConfig(
    max_batch_size=4, max_input_len=32, max_output_len=96,
    prefill_buckets=(8, 16, 32), kv_buckets=(32, 64),
    decode_steps_per_call=4)
PAGED = dataclasses.replace(DENSE, paged_kv=True, kv_block_size=16)
ACTIVE = np.array([True, True, False, False])
PROMPTS = ([[7, 8, 9], [10, 11]], [[12, 13], [14, 15, 16, 17]])
SAMPLED = SamplingConfig(temperature=1.0, top_p=1.0)
SCFG = StreamConfig(frames_per_chunk=2, lookahead_frames=3,
                    left_context_frames=4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs, as its gloo workers run:
    the CPU's products round by their thread split."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cores(ecfg):
    tree = numpy_llama_tree(LM, seed=3)
    return (JCore(to_jax(tree), LM, ecfg, eos_id=5),
            TCore(W.llama_params_from_jax(tree), port_config(LM),
                  port_config(ecfg), eos_id=5, device="cpu"))


def _params(mod, sampling):
    return mod.SamplingParams.from_config(
        sampling if mod is jS else port_config(sampling), 4)


@pytest.mark.parametrize("ecfg", [DENSE, PAGED], ids=["dense", "paged"])
def test_decode_steps_and_reset_slots_match_jax(ecfg):
    """prefill_slots → decode_steps → reset_slots → prefill_slots into the
    same slots → decode_steps: greedy tokens equal the JAX core's, every
    output a host array of the JAX dtype and shape, and the reset leaves
    the slots' lengths, bounds and (paged) blocks as the JAX core's."""
    jc, tc = _cores(ecfg)
    outs = []
    for core, mod in ((jc, jS), (tc, tS)):
        sp = _params(mod, SamplingConfig(greedy=True))
        first = core.prefill_slots(PROMPTS[0], [0, 1], sp)
        t1 = core.decode_steps(sp, first, ACTIVE, n=5)
        core.reset_slots([0, 1])
        reset = (np.asarray(core.cache.lengths).tolist(),
                 core._len_bounds.tolist(), core.free_tokens())
        second = core.prefill_slots(PROMPTS[1], [0, 1], sp)
        t2 = core.decode_steps(sp, second, ACTIVE)
        outs.append((first, t1, reset, second, t2))
    (jf, j1, jr, js, j2), (tf, t1, tr, ts, t2) = outs
    for got, want in zip((tf, *t1, ts, *t2), (jf, *j1, js, *j2)):
        assert isinstance(got, np.ndarray)
        assert got.shape == np.shape(want) and got.dtype == want.dtype
        np.testing.assert_array_equal(got[:2], want[:2])
    # the slots nobody admitted or decoded: EOS from decode_steps (the
    # prefill's first tokens there are 0 on the port, a masked sample in
    # the JAX package)
    for got, want in zip((*t1, *t2), (*j1, *j2)):
        np.testing.assert_array_equal(got[2:], want[2:])
    assert t1[0].shape == (4, 5) and t2[0].shape == (4, 4)
    assert tr == jr and tr[0][:2] == [0, 0] and tr[1][:2] == [0, 0]
    # the count of decode steps launched is still read as an int
    assert tc.decode_steps == 9 and tc.steps_launched == 9


def _seeded_run(core, mod, seeds, in_launch=False):
    """Reset slots 0-1, seed them (or give the seeds to the prefill
    launch), prefill, 6 sampled decode steps; the slots' tokens."""
    sp = _params(mod, SAMPLED)
    core.reset_slots([0, 1])
    if not in_launch:
        core.seed_slots([0, 1], seeds)
    first = core.prefill_slots(PROMPTS[0], [0, 1], sp,
                               seeds=seeds if in_launch else None)
    toks, _, _ = core.decode_steps(sp, first, ACTIVE, n=6)
    return np.concatenate([first[:2, None], toks[:2]], axis=1)


@pytest.mark.parametrize("ecfg", [DENSE, PAGED], ids=["dense", "paged"])
def test_seed_slots_reproduces_tokens_as_jax_does(ecfg):
    """seed_slots then sampled decode_steps gives the same tokens for the
    same seeds and others for other seeds, on the JAX core and the port's
    alike; the port writes the same counter-hash seeds as an admission's
    reseed (prefill_slots(seeds=)), and nothing else of the slots."""
    for core, mod in zip(_cores(ecfg), (jS, tS)):
        a = _seeded_run(core, mod, [5, 9])
        np.testing.assert_array_equal(_seeded_run(core, mod, [5, 9]), a)
        assert (_seeded_run(core, mod, [6, 10]) != a).any()
        np.testing.assert_array_equal(
            _seeded_run(core, mod, [5, 9], in_launch=True), a)
    tc = core
    before = [t.clone() for t in tc.sampling_state]
    lengths = tc.cache.lengths.clone()
    tc.seed_slots([1], [77])
    after = tc.sampling_state
    assert int(after.seed[1]) == 77 and int(after.step[1]) == 0
    for name in ("presence", "in_speech", "frame_pos"):
        i = tS.SamplingState._fields.index(name)
        assert torch.equal(after[i], before[i]), name
    for i in (1, 2):       # seed, step of the other slots
        assert torch.equal(after[i][[0, 2, 3]], before[i][[0, 2, 3]])
    assert torch.equal(tc.cache.lengths, lengths)


@pytest.mark.parametrize("events,want", [
    ([("chunk", "a"), ("chunk", "b"), ("done", "m")], ["a", "b"]),
    ([("done", "m")], []),
    ([("chunk", "a"), ("error", "engine down: boom")],
     RuntimeError("engine down: boom")),
    ([], queue.Empty()),
])
def test_iter_chunks_matches_jax(events, want):
    """The chunks up to done; an error event raises RuntimeError with its
    message; no event within the timeout raises queue.Empty — as the JAX
    package's TTSRequest does."""
    for mod in (JS, TS):
        req = mod.TTSRequest(text="x")
        for ev in events:
            req.events.put(ev)
        if isinstance(want, Exception):
            got = []
            with pytest.raises(type(want)) as exc:
                for c in req.iter_chunks(timeout=0.05):
                    got.append(c)
            assert str(exc.value) == str(want) and got == ["a"][:len(got)]
        else:
            assert list(req.iter_chunks(timeout=0.05)) == want


def test_synthesize_request_yields_the_events_loop_pcm():
    """A running scheduler: synthesize_request's chunks are the PCM a hand
    events loop drains for the same request; on a scheduler that lost its
    engine, the iterator raises "engine down"."""
    cfg = tiny_config()
    rt = Runtime.create(port_config(cfg), device="cpu",
                        llama_tree=numpy_llama_tree(cfg.model, seed=0),
                        snac_tree=numpy_snac_tree(cfg.snac, seed=1))
    s = TS.Scheduler(rt.engine.core.params, rt.config, rt.vocoder,
                     rt.tokenizer)

    def request():
        return TS.TTSRequest(
            text="surface", sampling=port_config(SamplingConfig(
                greedy=True, max_tokens=35, token_range=AUDIO_RANGE)),
            stream_cfg=port_config(SCFG), force_speech=True)

    s.start()
    try:
        pcm = b"".join(c.pcm for c in s.synthesize_request(request()))
        req = s.submit(request())
        parts = []
        while True:
            kind, payload = req.events.get(timeout=120)
            if kind == "chunk":
                parts.append(payload.pcm)
            elif kind == "done":
                break
            else:
                raise AssertionError(payload)
    finally:
        s.stop()
    assert pcm == b"".join(parts) and len(pcm) == 5 * 2048 * 2
    s.fatal = "boom"
    with pytest.raises(RuntimeError, match="engine down: boom"):
        list(s.synthesize_request(request()))


def test_backends_match_jax():
    from tts_inference_tpu import engine as JE
    from tts_inference_tpu_torch import engine as TE

    assert list(TE.BACKENDS) == list(JE.BACKENDS) == ["single", "scheduler"]
    for k, cls in TE.BACKENDS.items():
        assert cls.__name__ == JE.BACKENDS[k].__name__
        assert cls.__module__.replace("_torch", "") == JE.BACKENDS[k].__module__


def test_pipeline_imports_first_where_the_jax_package_cannot():
    """``engine/__init__`` imports the scheduler (for BACKENDS), which
    imports the streaming pipeline, which imports the engine: the port's
    pipeline names the engine only in annotations, so importing it first
    works; the JAX package's raises ImportError there (a circular
    import)."""
    def first(module):
        return subprocess.run(
            [sys.executable, "-c", f"import {module}"],
            cwd=Path(__file__).resolve().parents[1], capture_output=True,
            text=True, env=dict(os.environ, JAX_PLATFORMS="cpu"),
            timeout=300)

    port = first("tts_inference_tpu_torch.streaming.pipeline")
    assert port.returncode == 0, port.stderr
    jax_side = first("tts_inference_tpu.streaming.pipeline")
    assert jax_side.returncode != 0 and "circular import" in jax_side.stderr


def test_mirrored_names_match_jax():
    from tts_inference_tpu.parallel import lockstep as JL
    from tts_inference_tpu_torch.parallel import lockstep as TL

    assert sorted(TL.MIRRORED) == sorted(JL.MIRRORED)
    assert {"decode_steps", "reset_slots", "seed_slots"} <= set(TL.MIRRORED)


@pytest.fixture(scope="module")
def pair():
    p = GlooPool(2)
    yield p
    p.close()


def test_surface_mirrored_on_a_gloo_pair(pair):
    """tp 2 on a gloo pair, rank 0's core mirrored to rank 1: seed_slots,
    a fused admission, decode_steps, reset_slots, prefill_slots and
    decode_steps. Rank 1 replays all six calls; both ranks end with the
    same noise seeds, steps and length bounds; the tokens equal the
    unsharded core's and the JAX core's."""
    kw = dict(cfg=port_config(LM), ecfg=port_config(DENSE))
    lead, follower = pair.run("mirrored_surface", dp=1, tp=2,
                              lport=free_port(), **kw)
    plain = MW.mirrored_surface(**kw)
    assert follower["replayed"] == 6
    for k in ("seed", "step", "len_bounds"):
        np.testing.assert_array_equal(follower[k], lead[k])
        np.testing.assert_array_equal(plain[k], lead[k])
    np.testing.assert_array_equal(lead["tokens"], plain["tokens"])
    jc = JCore(to_jax(numpy_llama_tree(LM, seed=0)), LM, DENSE, eos_id=5)
    np.testing.assert_array_equal(
        MW._surface(jc, _params(jS, SamplingConfig(greedy=True))),
        plain["tokens"])
