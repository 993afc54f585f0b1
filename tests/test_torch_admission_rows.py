"""PyTorch port, an admission that prefills only the rows it admits, on the
CPU (where the launch bodies run eagerly):

- an admission of 1 row (row bucket 1) or 3 rows (padded with a live slot
  to row bucket 4) into 8 slots beside live mid-generation streams gives
  the first tokens, the admitted rows' cache bytes, lengths and sampling
  state of the whole-batch admission graph, and leaves every other slot's
  cache bytes, length, sampling state, last token and active flag as they
  were: dense bf16, dense int8 and paged int8 caches, each without and
  with the prefix cache;
- greedy streams admitted by row graphs beside live streams equal the JAX
  core's, which prefills the whole batch at every admission;
- a scheduler serving admissions of 1, 2 and all 4 rows after its warmup
  captures nothing more (its census stays, ``late_captures`` 0), and
  ``prefilled_rows`` counts the row buckets.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tts_inference_tpu import protocol as P
from tts_inference_tpu.config import SamplingConfig, StreamConfig, tiny_config
from tts_inference_tpu.engine.engine import EngineCore as JCore
from tts_inference_tpu.ops import sampling as jS
from tts_inference_tpu_torch import weights as W
from tts_inference_tpu_torch.engine.engine import EngineCore as TCore
from tts_inference_tpu_torch.ops import sampling as tS
from tts_inference_tpu_torch.utils import to_numpy

from tests.test_torch_checkpoint import _one_thread  # noqa: F401
from tests.torch_port_helpers import (AUDIO_RANGE, for_side, numpy_llama_tree,
                                      port_config, to_jax)

CFG = tiny_config()
ENGINE = dataclasses.replace(CFG.engine, max_batch_size=8, kv_block_size=32,
                             kv_pool_tokens=8 * 320)
LAYOUTS = {"dense_bf16": {}, "dense_int8": dict(kv_cache_int8=True),
           "paged_int8": dict(paged_kv=True, kv_cache_int8=True)}
LIVE = [0, 2, 5]
ADMIT = {1: [4], 3: [1, 3, 6]}       # row buckets 1 and 4 (padded by 0)


def _prompt(start, n):
    return [P.TOKEN_SOS] + list(range(start, start + n))


LIVE_PROMPTS = [_prompt(300, 40), _prompt(400, 12), _prompt(500, 25)]
PROMPTS = [_prompt(600, 20), _prompt(700, 9), [101, 102, 103, 104, 7, 8]]


@pytest.fixture(scope="module")
def tree():
    return numpy_llama_tree(CFG.model, seed=0)


def _bf16(tree):
    if isinstance(tree, torch.Tensor):
        return tree.to(torch.bfloat16)
    if isinstance(tree, dict):
        return {k: _bf16(v) for k, v in tree.items()}
    return [_bf16(v) for v in tree]


def _port_core(tree, layout, prefix, dtype="float32") -> TCore:
    ecfg = dataclasses.replace(ENGINE, prefix_cache=prefix,
                               **LAYOUTS[layout])
    params = W.llama_params_from_jax(tree)
    if dtype == "bfloat16":
        params = _bf16(params)
    mcfg = dataclasses.replace(CFG.model, dtype=dtype)
    return TCore(params, port_config(mcfg), port_config(ecfg), eos_id=5,
                 device="cpu")


def _state(core) -> dict:
    c = core.cache
    return {"cache": [t.clone() for name in ("k", "v", "k_scale", "v_scale")
                      for t in getattr(c, name)],
            "lengths": c.lengths.clone(),
            "ss": [t.clone() for t in core.sampling_state]}


def _admitted(core, slots, whole: bool) -> dict:
    """Live streams in LIVE (admitted by the whole-batch graph, then a
    decode launch), then an admission of PROMPTS[:len(slots)] into `slots`
    (with the whole-batch graph if `whole`): its key, its outputs, the
    state just before and just after its launch, and its last_tok / active
    inputs."""
    sp = tS.SamplingParams.from_config(port_config(SamplingConfig(
        token_range=AUDIO_RANGE, repetition_penalty=1.2, temperature=0.9)),
        core.batch)
    core.row_buckets = lambda: [core.batch]
    z_tok, z_act = np.zeros(core.batch, np.int32), np.zeros(core.batch, bool)
    _, tok, act = core.prefill_decode_launch(
        LIVE_PROMPTS, LIVE, sp, z_tok, z_act, n=3, seeds=[11, 12, 13])
    _, tok, act = core.decode_steps_launch(sp, tok, act)
    if not whole:
        del core.row_buckets
    got = {"last_tok": tok.clone(), "active": act.clone()}
    launch = core._launch

    def spy(key, kind=None, **inputs):
        if key[0].startswith("admit"):
            got.update(key=key, before=_state(core))
        out = launch(key, kind, **inputs)
        if key[0].startswith("admit"):
            got.update(out=[t.clone() for t in out], after=_state(core))
        return out

    core._launch = spy
    core.prefill_decode_launch(PROMPTS[:len(slots)], slots, sp, tok, act,
                               n=3, seeds=[21, 22, 23][:len(slots)])
    return got


def _blocks(core, slots) -> set:
    return {b for sl in slots for b in core._slot_blocks.get(sl, [])}


@pytest.mark.parametrize("n", sorted(ADMIT), ids=["1row", "3rows"])
@pytest.mark.parametrize("prefix", [False, True],
                         ids=["plain", "prefix_cache"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_row_admission_equals_the_whole_batch_graph(tree, layout, prefix, n):
    dtype = "bfloat16" if layout == "dense_bf16" else "float32"
    rows_core = _port_core(tree, layout, prefix, dtype)
    whole_core = _port_core(tree, layout, prefix, dtype)
    slots = ADMIT[n]
    a = _admitted(rows_core, slots, whole=False)
    b = _admitted(whole_core, slots, whole=True)
    kind = "admit_prefix" if prefix else "admit"
    assert a["key"][0] == b["key"][0] == kind
    assert (a["key"][2], b["key"][2]) == (rows_core.row_bucket(n), 8)
    assert a["key"][2] == {1: 1, 3: 4}[n]
    others = [s for s in range(8) if s not in slots]
    # the first tokens and active flags of the whole-batch graph; the other
    # slots keep their inputs
    for x, y in zip(a["out"], b["out"]):
        assert torch.equal(x, y)
    tok0, act0 = a["out"]
    assert torch.equal(tok0[others], a["last_tok"][others])
    assert torch.equal(act0[others], a["active"][others])
    assert bool(a["active"][LIVE].all())
    # lengths and sampling state: the whole-batch graph's, the others' kept
    for x, y, z in zip([a["after"]["lengths"]] + a["after"]["ss"],
                       [b["after"]["lengths"]] + b["after"]["ss"],
                       [a["before"]["lengths"]] + a["before"]["ss"]):
        assert torch.equal(x, y)
        assert torch.equal(x[others], z[others])
    assert [int(x) for x in a["after"]["lengths"][slots]] == [
        len(p) for p in PROMPTS[:n]]
    # cache bytes: the admitted rows as the whole-batch graph writes them,
    # every other slot's as they were
    if layout.startswith("paged"):
        assert _blocks(rows_core, slots) == _blocks(whole_core, slots)
        kept = sorted(_blocks(rows_core, others) - {0})
        assert kept and not _blocks(rows_core, slots) & set(kept)
        for x, y, z in zip(a["after"]["cache"], b["after"]["cache"],
                           a["before"]["cache"]):
            assert torch.equal(x[1:], y[1:])       # all but the trash block
            assert torch.equal(x[kept], z[kept])
    else:
        for x, y, z in zip(a["after"]["cache"], b["after"]["cache"],
                           a["before"]["cache"]):
            assert torch.equal(x, y)
            assert torch.equal(x[others], z[others])


def _greedy_run(core) -> np.ndarray:
    """Three waves of admissions beside live streams (3 rows, then 1, then
    2: row buckets 4, 1 and 2 of 8 slots), each followed by a decode
    launch; greedy. Either package's core; the token matrix."""
    mod = tS if isinstance(core, TCore) else jS
    sp = mod.SamplingParams.from_config(for_side(mod, SamplingConfig(
        greedy=True, token_range=AUDIO_RANGE)), core.batch)
    tok = np.zeros(core.batch, np.int32)
    act = np.zeros(core.batch, bool)
    out = []
    for prompts, slots in ((LIVE_PROMPTS, LIVE), (PROMPTS[:1], [4]),
                           (PROMPTS[1:], [1, 6])):
        t, tok, act = core.prefill_decode_launch(prompts, slots, sp, tok,
                                                 act, n=3)
        out.append(np.asarray(to_numpy(t)))
        t, tok, act = core.decode_steps_launch(sp, tok, act)
        out.append(np.asarray(to_numpy(t)))
    return np.concatenate(out, axis=1)


@pytest.mark.parametrize("layout", ["dense", "dense_int8", "paged_int8"])
def test_row_admissions_match_the_jax_core(tree, layout):
    """f32, greedy: the port's row-graph admissions (row buckets 4, 1, 2)
    give the JAX core's tokens, slot for slot, across the live streams."""
    over = {"dense": {}, "dense_int8": dict(kv_cache_int8=True),
            "paged_int8": dict(paged_kv=True, kv_cache_int8=True)}[layout]
    ecfg = dataclasses.replace(ENGINE, **over)
    tcore = TCore(W.llama_params_from_jax(tree), port_config(CFG.model),
                  port_config(ecfg), eos_id=5, device="cpu")
    keys = []
    launch = tcore._launch

    def spy(key, kind=None, **inputs):
        keys.append(key)
        return launch(key, kind, **inputs)

    tcore._launch = spy
    got = _greedy_run(tcore)
    assert [k[2] for k in keys if k[0] == "admit"] == [4, 1, 2]
    want = _greedy_run(JCore(to_jax(tree), CFG.model, ecfg, eos_id=5))
    np.testing.assert_array_equal(got, want)


def test_scheduler_row_admissions_capture_nothing_late(tree):
    """A 4-slot scheduler, warmed up, serves an admission of 1 request,
    then of 2, then of all 4: every admission launch is a warmed key (row
    buckets 1, 2 and 4), the census does not grow, nothing is captured
    late, and prefilled_rows is 1 + 2 + 4."""
    from tts_inference_tpu_torch.engine.scheduler import (Scheduler,
                                                          TTSRequest)
    from tts_inference_tpu_torch.models.snac import SnacDecoder
    from tts_inference_tpu_torch.utils.tokenizer import ByteTokenizer

    tcfg = port_config(CFG)
    vocoder = SnacDecoder(W.init_snac_params(tcfg.snac, 1, "cpu"), tcfg.snac)
    s = Scheduler(W.llama_params_from_jax(tree), tcfg, vocoder,
                  ByteTokenizer(), device="cpu")
    census = set(s.warmup()["graph_census_ms"])
    keys = []
    launch = s.core._launch

    def spy(key, kind=None, **inputs):
        keys.append(key)
        return launch(key, kind, **inputs)

    s.core._launch = spy
    scfg = port_config(StreamConfig(frames_per_chunk=2, lookahead_frames=3,
                                    left_context_frames=4))
    for wave in (1, 2, 4):
        reqs = [s.submit(TTSRequest(
            text=f"wave {wave} request {i}", stream_cfg=scfg,
            force_speech=True, sampling=port_config(SamplingConfig(
                max_tokens=14, seed=i, token_range=AUDIO_RANGE))))
            for i in range(wave)]
        for _ in range(400):
            if not s.step() and s.n_queued == 0 and not s.n_active:
                break
        for r in reqs:
            while True:
                kind, payload = r.events.get(timeout=60)
                if kind in ("done", "error"):
                    assert kind == "done", payload
                    break
    s.stop()
    admits = [k for k in keys if k[0] == "admit"]
    assert [k[2] for k in admits] == [1, 2, 4]
    assert set(s.core.graph_census_ms) == census
    assert s.core.late_captures == 0
    c = s.counters
    assert (c["admissions"], c["admitted_rows"], c["prefilled_rows"]) == (
        3, 7, 7)
