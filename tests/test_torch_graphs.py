"""PyTorch port, the launches that a CUDA device replays as CUDA graphs, on
the CPU (where the same launch bodies run eagerly):

- the census of ``warmup_graphs`` against the JAX package's: every graph
  the JAX core compiles has its counterpart among the port's captures —
  a fused (bucket, steps, window) admission becomes the admission graphs of
  the bucket (one per row bucket) plus the decode graph of (steps,
  window), a decode graph of a
  window the decode graph of (decode_steps_per_call, window) — at 8 slots
  with the scheduler's admission step counts and at 1 slot with the
  single-stream first bursts;
- the engine's state keeps its addresses through every launch kind and a
  preempt → resume (a graph reads and writes the tensors it captured);
- successive launches return distinct outputs that later launches leave
  alone (a replay overwrites the graph's own output tensors);
- launch counts recorded for a capture leave other threads' counts alone.

The JAX side stubs its launches: only its enumeration runs, nothing
compiles. Tokens against the JAX package stay the business of the existing
parity tests, which run these same launch bodies.
"""

import dataclasses
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tts_inference_tpu import protocol as P
from tts_inference_tpu.config import SamplingConfig, tiny_config
from tts_inference_tpu.engine.engine import EngineCore as JCore
from tts_inference_tpu_torch import weights as W
from tts_inference_tpu_torch.engine.engine import EngineCore as TCore
from tts_inference_tpu_torch.ops import _build
from tts_inference_tpu_torch.ops import sampling as tS
from tts_inference_tpu_torch.utils import to_numpy

from tests.torch_port_helpers import (AUDIO_RANGE, numpy_llama_tree,
                                      port_config, to_jax)

JAX_KEYS = {"warmed_windows", "warmed_buckets", "graphs_compiled",
            "graph_census_ms"}



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
def trees():
    tree = numpy_llama_tree(tiny_config().model, seed=0)
    return to_jax(tree), W.llama_params_from_jax(tree)


def _stub_launches(core: JCore) -> None:
    """Replace the JAX core's launches with host stubs of the same return
    shapes: warmup_graphs then runs its enumeration and compiles nothing."""
    b = core.batch

    def prefill_decode_launch(prompts, slots, sp, last_tok, active, n=None,
                              **kw):
        return np.zeros((b, (n or 1) + 1), np.int32), last_tok, active

    def decode_steps_launch(sp, last_tok, active, n=None):
        return np.zeros((b, n or 1), np.int32), last_tok, active

    core.prefill_slots = lambda *a, **kw: np.zeros(b, np.int32)
    core.prefill_decode_launch = prefill_decode_launch
    core.decode_steps_launch = decode_steps_launch
    core.reset_slots = lambda *a, **kw: None


def _expected_captures(jax_census: dict, n: int, prefix: bool, batch: int,
                       mesh: bool = False) -> set:
    """The port's capture names for the JAX package's compile names: a
    fused admission of a bucket maps onto the bucket's admission graph of
    every row bucket (the powers of two below the slot batch, named with
    their row count, and the batch, the JAX package's whole-batch graph;
    under a mesh that one alone) and the decode graph; with the prefix
    cache the admissions are prefix admissions of the suffix bucket, and
    the build has its own graph (the JAX package compiles it inside its
    first probe)."""
    admit = "capture_prefill_prefix_" if prefix else "capture_prefill_"
    rows = [] if mesh else [f"_r{1 << i}" for i in range(batch.bit_length())
                            if 1 << i < batch]
    out = {"capture_prefix_build"} if prefix else set()
    for name in jax_census:
        parts = name.split("_")
        if name.startswith("compile_prefill_decode_"):
            b, nn, w = parts[3], parts[4][1:], parts[5][1:]
            out |= {admit + b + r for r in rows + [""]}
            out.add(f"capture_decode_n{nn}_w{w}")
        elif name.startswith("compile_decode_w"):
            out.add(f"capture_decode_n{n}_w{name[len('compile_decode_w'):]}")
    return out


@pytest.mark.parametrize("slots,prefix", [(8, False), (1, False),
                                          (8, True), (1, True)],
                         ids=["8", "1", "8-prefix_cache", "1-prefix_cache"])
def test_warmup_census_covers_the_jax_graphs(trees, slots, prefix):
    """8 slots: the scheduler's warmup (admission_ns = [admission_steps,
    decode_steps_per_call]); 1 slot: the single-stream engine's (its first
    bursts); each without and with the prefix cache (probes padded by
    prefix_len). The port's census holds exactly the counterparts of the
    JAX core's graphs, one admission graph per (prompt bucket, row
    bucket), and JAX's four result keys."""
    from tts_inference_tpu_torch.engine.engine import GenerationEngine
    from tts_inference_tpu_torch.engine.scheduler import Scheduler
    from tts_inference_tpu_torch.models.snac import SnacDecoder
    from tts_inference_tpu_torch.utils.tokenizer import ByteTokenizer

    jp, tp = trees
    cfg = tiny_config()
    cfg = dataclasses.replace(cfg, engine=dataclasses.replace(
        cfg.engine, max_batch_size=slots, prefix_cache=prefix))
    tcfg = port_config(cfg)
    n = cfg.engine.decode_steps_per_call
    jcore = JCore(jp, cfg.model, cfg.engine, batch_size=slots)
    _stub_launches(jcore)
    if slots == 1:
        bursts = [(cfg.stream.first_chunk_frames + cfg.stream.lookahead_frames)
                  * P.FRAME_SIZE]
        jinfo = jcore.warmup_graphs(first_bursts=bursts)
        eng = GenerationEngine(tp, tcfg.model, tcfg.engine, device="cpu",
                               first_bursts=bursts)
        info, core = eng.warmup(), eng.core
    else:
        vocoder = SnacDecoder(W.init_snac_params(tcfg.snac, 1, "cpu"),
                              tcfg.snac)
        sched = Scheduler(tp, tcfg, vocoder, ByteTokenizer(), device="cpu")
        jinfo = jcore.warmup_graphs(
            admission_ns=[sched.admission_steps, n])
        info, core = sched.warmup(), sched.core
    assert JAX_KEYS <= set(info)
    want = _expected_captures(jinfo["graph_census_ms"], n, prefix, slots)
    assert set(info["graph_census_ms"]) == want
    assert info["graphs_compiled"] == len(want)
    assert info["warmed_windows"] == jinfo["warmed_windows"]
    assert info["warmed_buckets"] == jinfo["warmed_buckets"]
    # every bucket has its admission graph of every row bucket, the
    # whole batch's among them; decode at every window
    admit = "capture_prefill_prefix_" if prefix else "capture_prefill_"
    assert {f"{admit}{b}" for b in cfg.engine.prefill_buckets} <= want
    assert {f"{admit}{b}_r{r}" for b in cfg.engine.prefill_buckets
            for r in core.row_buckets()[:-1]} <= want
    assert core.row_buckets() == ([1, 2, 4, 8] if slots == 8 else [1])
    assert {f"capture_decode_n{n}_w{w}" for w in jinfo["warmed_windows"]} \
        <= want
    # the decode graphs are shared by the buckets: fewer captures than
    # the JAX core compiles
    assert len(want) < len(jinfo["graph_census_ms"])
    # the CPU is eager: nothing captured, nothing late, pool free again
    assert not core.use_graphs and core.late_captures == 0
    assert core.replays == {} and core.launches["admission"] >= len(
        cfg.engine.prefill_buckets)
    assert not core._len_bounds.any()
    # the probes share one prefix: one build, then hits
    assert (core.prefix_misses, core.launches["prefix_build"]) == (
        (1, 1) if prefix else (0, 0))


def _core(tp, kind: str) -> TCore:
    cfg = tiny_config()
    over = {"dense": {},
            "paged_int8": dict(paged_kv=True, kv_cache_int8=True,
                               kv_block_size=32, kv_on_demand=True,
                               kv_pool_tokens=12 * 32,
                               resume_buckets=(128, 256)),
            "paged_int4": dict(paged_kv=True, kv_cache_int4=True,
                               kv_block_size=32, kv_on_demand=True,
                               kv_pool_tokens=12 * 32,
                               resume_buckets=(128, 256))}[kind]
    ecfg = dataclasses.replace(cfg.engine, **over)
    return TCore(tp, port_config(cfg.model), port_config(ecfg),
                 device="cpu")


def _addresses(core: TCore) -> dict:
    c = core.cache
    out = {f"state.{f}": t.data_ptr()
           for f, t in zip(tS.SamplingState._fields, core.sampling_state)}
    for name in ("k", "v", "k_scale", "v_scale"):
        for i, t in enumerate(getattr(c, name)):
            out[f"cache.{name}{i}"] = t.data_ptr()
    out["cache.lengths"] = c.lengths.data_ptr()
    if hasattr(c, "block_table"):
        out["cache.block_table"] = c.block_table.data_ptr()
    return out


def _sp(core: TCore, **kw):
    return tS.SamplingParams.from_config(port_config(SamplingConfig(
        token_range=AUDIO_RANGE, **kw)), core.batch)


@pytest.mark.parametrize("kind", ["dense", "paged_int8", "paged_int4"])
def test_state_keeps_its_addresses(trees, kind):
    """Every sampling-state field, every cache tensor and the block table
    keep their data_ptr through reset_and_seed, prefill_slots, the fused
    admission, decode launches, restore_slot and a preempt → resume."""
    _, tp = trees
    core = _core(tp, kind)
    sp = _sp(core, repetition_penalty=1.2)
    addr = _addresses(core)
    prompt = [P.TOKEN_SOS, 5, 6, 7]
    core.reset_and_seed([0, 1], seeds=[3, None])
    assert _addresses(core) == addr
    tok = core.prefill_slots([prompt], [2], sp, seeds=[9])
    assert _addresses(core) == addr
    act = np.zeros(core.batch, bool)
    act[2] = True
    toks, lt, act = core.prefill_decode_launch(
        [prompt, prompt[:2]], [0, 1], sp, tok, act, n=5, seeds=[1, 2])
    assert _addresses(core) == addr
    for _ in range(3):
        toks, lt, act = core.decode_steps_launch(sp, lt, act)
        assert _addresses(core) == addr
    # preempt slot 0 → resume it by re-prefill and a restore
    to_numpy(toks)
    snap = core.snapshot_slot(0)
    core.preempt_slot(0)
    core.prefill_slots([prompt + [P.TOKEN_AUDIO_BASE] * 20], [0], sp,
                       seeds=[None],
                       bucket=core.resume_bucket_len(len(prompt) + 20))
    core.restore_slot(0, snap)
    assert core.snapshot_slot(0)["step"] == snap["step"]
    toks, lt, act = core.decode_steps_launch(sp, lt, act)
    assert _addresses(core) == addr
    # prefill_slots launches count as resumes, apart from admissions
    assert core.launches == {"admission": 1, "resume": 2, "decode": 5}


@pytest.mark.parametrize("kind", ["dense", "paged_int8"])
def test_successive_launches_do_not_alias(trees, kind):
    """Two launches return distinct tensors, and the second leaves the
    first's values alone; neither output is one of the launches' input
    tensors."""
    _, tp = trees
    core = _core(tp, kind)
    sp = _sp(core)
    act = np.zeros(core.batch, bool)
    first = core.prefill_decode_launch(
        [[P.TOKEN_SOS, 5, 6]] * 2, [0, 1], sp,
        np.zeros(core.batch, np.int32), act, n=3, seeds=[4, 5])
    kept = [t.clone() for t in first]
    second = core.decode_steps_launch(sp, first[1], first[2], n=3)
    third = core.decode_steps_launch(sp, second[1], second[2], n=3)
    inputs = {t.data_ptr() for t in (core._static_inputs()["last_tok"],
                                     core._static_inputs()["active"])}
    ptrs = [t.data_ptr() for out in (first, second, third) for t in out]
    assert len(set(ptrs)) == len(ptrs) and not inputs & set(ptrs)
    for was, now in zip(kept, first):
        assert torch.equal(was, now)
    assert not torch.equal(second[0], third[0])   # the stream moved on


def test_recorded_launches_leave_other_threads_alone():
    """What a capture records is one replay's launches; another thread's
    launches meanwhile count as always."""
    c = _build.LaunchCounter()
    c.add()
    with _build.record_launches() as rec:
        c.add()
        c.add(2)
        t = threading.Thread(target=c.add)
        t.start()
        t.join()
    assert rec == {c: 3} and c.count == 2
    for _ in range(2):      # two replays
        for counter, k in rec.items():
            counter.add(k)
    assert c.count == 8


def test_graphs_need_a_cuda_device(trees):
    """A CPU core runs the eager launches whatever `graphs` says, and its
    launches hand back the same tokens with graphs on or off."""
    _, tp = trees
    outs = []
    for graphs in (True, False):
        core = TCore(tp, port_config(tiny_config().model),
                     port_config(tiny_config().engine), device="cpu",
                     graphs=graphs)
        assert not core.use_graphs
        sp = _sp(core, greedy=True)
        toks, lt, act = core.prefill_decode_launch(
            [[P.TOKEN_SOS, 5]], [0], sp, np.zeros(core.batch, np.int32),
            np.zeros(core.batch, bool), n=4)
        outs.append(to_numpy(core.decode_steps_launch(sp, lt, act)[0]))
    np.testing.assert_array_equal(*outs)


def test_warmup_fits_a_small_on_demand_pool(trees):
    """An on-demand pool of 9 blocks of 32 (the resume tier's 256-token
    prefill fits): the JAX core's decode probes grow the last probe's
    blocks to the whole window and exhaust the pool (its jitted launches
    stubbed, the host bookkeeping real); the port releases the probe's
    blocks first and leaves the pool free."""
    jp, tp = trees
    cfg = tiny_config()
    ecfg = dataclasses.replace(cfg.engine, paged_kv=True, kv_on_demand=True,
                               kv_block_size=32, kv_pool_tokens=9 * 32,
                               resume_buckets=(128, 256))
    jcore = JCore(jp, cfg.model, ecfg)
    b = jcore.batch

    def prefill_decode(n, w, params, tokens, lens, cache, ss, sp, mask, lt,
                       act, seeds, reseed):
        return jnp.zeros((b, n + 1), jnp.int32), lt, act, cache, ss

    def decode(n, w, params, cache, ss, sp, lt, act):
        return jnp.zeros((b, n), jnp.int32), lt, act, cache, ss

    jcore._prefill_decode, jcore._decode = prefill_decode, decode
    jcore._prefill = lambda w, params, tokens, lens, cache, ss, sp, mask: (
        jnp.zeros(b, jnp.int32), cache, ss)
    jcore._reset_seed = lambda cache, ss, *a: (cache, ss)
    with pytest.raises(RuntimeError, match="KV pool exhausted growing"):
        jcore.warmup_graphs(admission_ns=[27, 7])
    core = TCore(tp, port_config(cfg.model), port_config(ecfg), device="cpu")
    info = core.warmup_graphs(admission_ns=[27, 7])
    assert info["graphs_compiled"] > 0
    assert core.free_tokens() == 9 * 32 and not core._slot_blocks


def test_workspace_outlives_the_graphs_that_read_it(monkeypatch):
    """The attention / K4 workspace raises when a capture would make it
    grow, and a growth after a capture has read it keeps the old buffers
    alive (a graph keeps the addresses it captured)."""
    from tts_inference_tpu_torch.ops.decode_attention import _Workspace

    capturing = {"on": False}
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing["on"])
    ws = _Workspace.__new__(_Workspace)
    ws.device, ws.captured, ws.retired = "cpu", False, []
    ws.counters = torch.zeros(4, dtype=torch.int32)
    ws.scratch = torch.empty(8)
    first = ws.reserve(4, 8)
    ws.reserve(100, 8)                 # no capture has read them: replaced
    assert not ws.retired and ws.counters.numel() == 200
    capturing["on"] = True
    read = ws.reserve(3, 8)            # a capture reads the buffers
    with pytest.raises(RuntimeError, match="inside a CUDA graph capture"):
        ws.reserve(3, 1000)
    capturing["on"] = False
    grown = ws.reserve(3, 1000)        # eager growth after the capture
    assert [t.data_ptr() for t in ws.retired[0]] == \
        [t.data_ptr() for t in read]
    assert grown[1].numel() == 2000 and not ws.captured
    assert first[0].data_ptr() != read[0].data_ptr()


@pytest.mark.parametrize("kind", ["dense", "paged_int4"])
def test_prefix_pools_keep_their_addresses(trees, kind):
    """The prefix pools, the build's scratch cache and the launch inputs keep
    their data_ptr through a miss, a hit and an LRU eviction (the admission
    graphs read the pools where they captured them, and the build writes
    its row in place); every build is a launch of its own kind."""
    _, tp = trees
    base = _core(tp, kind)
    ecfg = dataclasses.replace(base.engine_cfg, prefix_cache=True,
                               prefix_len=8, prefix_entries=2)
    core = TCore(tp, base.model_cfg, ecfg, device="cpu")
    sp = _sp(core, greedy=True)

    def ptrs():
        out = {f"pool{i}.{j}": t.data_ptr()
               for i, part in enumerate(core._pool) for j, t in
               enumerate(part)}
        out.update({f"build.{i}": t.data_ptr() for i, t in enumerate(
            core._build_cache.k + core._build_cache.v)})
        out.update({name: t.data_ptr() for name, t in
                    core._static_inputs().items()
                    if isinstance(t, torch.Tensor)})
        return {**out, **_addresses(core)}

    act = np.zeros(core.batch, bool)
    header = [P.TOKEN_SOS] + list(range(300, 309))
    addr = None
    for i, text in enumerate([[5, 6], [7], [8, 9]]):    # miss, hit, miss
        first = list(range(400 + 10 * i, 409 + 10 * i)) if i == 2 else header
        toks, lt, act = core.prefill_decode_launch(
            [first + text], [0], sp, np.zeros(core.batch, np.int32), act,
            n=3)
        to_numpy(toks)
        addr = addr or ptrs()
        assert ptrs() == addr
        core.reset_and_seed([0])
    assert (core.prefix_misses, core.prefix_hits) == (2, 1)
    assert core.launches == {"admission": 3, "decode": 3, "prefix_build": 2}
    # a third prefix evicts the least recently used entry
    core.prefill_decode_launch([[1, 2, 3, 4, 5, 6, 7, 8, 9, 10]], [0], sp,
                               np.zeros(core.batch, np.int32), act, n=3)
    assert len(core._prefix_map) == 2 and ptrs() == addr
