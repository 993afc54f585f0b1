"""PyTorch port, the whole slice on the CPU: GenerationEngine, TTSPipeline
and the continuous-batching Scheduler against the JAX package on
``tiny_config()`` with the same numpy weights; isolation under churn; the
port's server and CLI; and the port importing with jax and the JAX package
poisoned."""

import asyncio
import importlib
import json
import os
import pkgutil
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from tts_inference_tpu import protocol as P
from tts_inference_tpu.config import SamplingConfig, StreamConfig, tiny_config
from tts_inference_tpu.engine import scheduler as JS
from tts_inference_tpu.engine.engine import GenerationEngine as JEngine
from tts_inference_tpu.models.snac import SnacDecoder as JSnac
from tts_inference_tpu.streaming.pipeline import TTSPipeline as JPipeline
from tts_inference_tpu.utils.tokenizer import ByteTokenizer
import tts_inference_tpu_torch
from tts_inference_tpu_torch import cli
from tts_inference_tpu_torch.engine import scheduler as TS
from tts_inference_tpu_torch.runtime import Runtime

from tests.torch_port_helpers import (AUDIO_RANGE, for_side, numpy_llama_tree,
                                      numpy_snac_tree, port_config, to_jax)

REPO = Path(__file__).resolve().parents[1]
CFG = tiny_config()
TCFG = port_config(CFG)      # the port's own copy of the same config
SCFG = StreamConfig(frames_per_chunk=2, lookahead_frames=3,
                    left_context_frames=4)


def greedy(max_tokens):
    return SamplingConfig(greedy=True, max_tokens=max_tokens,
                          token_range=AUDIO_RANGE)


@pytest.fixture(scope="module")
def pair():
    """(JAX runtime parts, port Runtime) over the same numpy weights."""
    ltree = numpy_llama_tree(CFG.model, seed=0)
    stree = numpy_snac_tree(CFG.snac, seed=1)
    s = CFG.stream
    bursts = [(s.first_chunk_frames + s.lookahead_frames) * P.FRAME_SIZE]
    jparams = to_jax(ltree)
    jeng = JEngine(jparams, CFG.model, CFG.engine, first_bursts=bursts)
    jvoc = JSnac(to_jax(stree), CFG.snac)
    jpipe = JPipeline(jeng, jvoc, ByteTokenizer(), CFG)
    rt = Runtime.create(TCFG, device="cpu", llama_tree=ltree, snac_tree=stree)
    return {"params": jparams, "engine": jeng, "vocoder": jvoc,
            "pipeline": jpipe}, rt


def assert_pcm_close(a: bytes, b: bytes):
    x = np.frombuffer(a, np.int16).astype(np.int32)
    y = np.frombuffer(b, np.int16).astype(np.int32)
    assert x.shape == y.shape and x.size > 0
    assert np.abs(x - y).max() <= 1
    assert (x == y).mean() >= 0.999


def test_engine_stream_matches_jax(pair):
    j, rt = pair
    prompt = rt.pipeline.build_prompt("engine parity", force_speech=True)
    sp = greedy(70)
    want = list(j["engine"].stream(prompt, sp))
    got = list(rt.engine.stream(prompt, sp))
    assert got == want
    assert sum(len(c) for c in got) == 70


def test_core_prefill_slots_matches_jax(pair):
    """Masked prefill of slots 0 and 2 of a 4-slot core: same first tokens
    and lengths as the JAX EngineCore; slots 1 and 3 stay empty."""
    from tts_inference_tpu.engine.engine import EngineCore as JCore
    from tts_inference_tpu.ops import sampling as jS
    from tts_inference_tpu_torch.engine.engine import EngineCore as TCore
    from tts_inference_tpu_torch.ops import sampling as tS

    j, rt = pair
    jc = JCore(j["params"], CFG.model, CFG.engine)
    tc = TCore(rt.engine.core.params, TCFG.model, TCFG.engine)
    prompts = [P.format_prompt_ids([300 + i] * (5 + 9 * i), force_speech=True)
               for i in range(2)]
    sp = greedy(10)
    want = np.asarray(jc.prefill_slots(
        prompts, [0, 2], jS.SamplingParams.from_config(sp, jc.batch)))
    got = tc.prefill_slots(prompts, [0, 2],
                           tS.SamplingParams.from_config(port_config(sp),
                                                         tc.batch))
    np.testing.assert_array_equal(got[[0, 2]], want[[0, 2]])
    np.testing.assert_array_equal(tc.cache.lengths.numpy(),
                                  np.asarray(jc.cache.lengths))
    assert tc.cache.lengths.tolist() == [10, 0, 19, 0]   # prompt lengths
    assert not tc.cache.k[0][1].any() and not tc.cache.k[0][3].any()


def test_pipeline_stream_matches_jax(pair):
    j, rt = pair
    sp = greedy(63)
    want = list(j["pipeline"].stream("pipeline parity", sampling=sp,
                                     force_speech=True))
    got = list(rt.pipeline.stream("pipeline parity", sampling=sp,
                                  force_speech=True))
    assert [c.samples for c in got] == [c.samples for c in want]
    assert_pcm_close(b"".join(c.pcm for c in got),
                     b"".join(c.pcm for c in want))
    assert rt.pipeline.last_metrics.tokens == 63
    assert rt.pipeline.last_metrics.frames == 9


def _run_scheduler(mod, sched, reqs):
    for r in reqs:
        sched.submit(r)
    for _ in range(3000):
        if not sched.step() and sched.n_queued == 0 and not sched.n_active:
            break
    sched.drain_vocoder()
    outs = []
    for r in reqs:
        pcm = []
        while True:
            kind, payload = r.events.get(timeout=60)
            if kind == "chunk":
                pcm.append(payload.pcm)
            elif kind == "done":
                outs.append((b"".join(pcm), payload))
                break
            else:
                raise AssertionError(payload)
    sched.stop()
    return outs


def test_scheduler_matches_jax(pair):
    """4 slots, 3 concurrent greedy requests of different lengths."""
    j, rt = pair

    def reqs(mod):
        return [mod.TTSRequest(text=f"request {i}",
                               sampling=for_side(mod, greedy(21 + 7 * i)),
                               stream_cfg=for_side(mod, SCFG),
                               force_speech=True)
                for i in range(3)]

    want = _run_scheduler(JS, JS.Scheduler(j["params"], CFG, j["vocoder"],
                                           ByteTokenizer()), reqs(JS))
    sched = TS.Scheduler(rt.engine.core.params, TCFG, rt.vocoder,
                         rt.tokenizer)
    assert sched.core.batch == 4
    got = _run_scheduler(TS, sched, reqs(TS))
    for (gp, gm), (wp, wm) in zip(got, want):
        assert gm.tokens == wm.tokens and gm.frames == wm.frames
        assert_pcm_close(gp, wp)


def test_isolation_under_churn(pair):
    """A sampled request's audio is the same alone or while neighbours are
    admitted and evicted around it (masked writes, restored rows, and noise
    keyed by the request's own seed, not its slot)."""
    _, rt = pair

    def req(text, seed, n):
        return TS.TTSRequest(text=text, sampling=port_config(SamplingConfig(
            max_tokens=n, seed=seed, token_range=AUDIO_RANGE)),
            stream_cfg=port_config(SCFG), force_speech=True)

    mk = lambda: TS.Scheduler(rt.engine.core.params, TCFG, rt.vocoder,  # noqa: E731
                              rt.tokenizer)
    [(alone, _)] = _run_scheduler(TS, mk(), [req("probe", 42, 42)])
    noise = [req(f"noise {i}", 7 + i, 14 + 7 * (i % 3)) for i in range(6)]
    probe = req("probe", 42, 42)
    outs = _run_scheduler(TS, mk(), [noise[0], probe] + noise[1:])
    a = np.frombuffer(outs[1][0], np.int16).astype(np.int32)
    b = np.frombuffer(alone, np.int16).astype(np.int32)
    assert a.shape == b.shape and a.size == 6 * 2048
    assert np.abs(a - b).max() <= 1


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_server_ws_tts_tiny_cpu():
    """`cli serve --tiny --device cpu` on a free port: one /ws/tts request
    gets its PCM bytes and the done JSON."""
    import aiohttp

    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.Popen(
        [sys.executable, "-m", "tts_inference_tpu_torch.cli", "serve",
         "--tiny", "--device", "cpu", "--host", "127.0.0.1",
         "--port", str(port)],
        cwd=REPO, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)

    async def go():
        base = f"http://127.0.0.1:{port}"
        async with aiohttp.ClientSession() as sess:
            deadline = time.monotonic() + 120
            while True:
                try:
                    async with sess.get(base + "/health") as r:
                        if r.status == 200:
                            break
                except aiohttp.ClientError:
                    pass
                assert time.monotonic() < deadline, "server did not start"
                assert proc.poll() is None, "server exited"
                await asyncio.sleep(0.3)
            async with sess.ws_connect(base + "/ws/tts") as ws:
                await ws.send_json({"text": "hello", "force_speech": True,
                                    "audio_only": True, "max_tokens": 70,
                                    "seed": 3})
                nbytes, done = 0, None
                async for msg in ws:
                    if msg.type == aiohttp.WSMsgType.BINARY:
                        nbytes += len(msg.data)
                    else:
                        done = json.loads(msg.data)
                        break
            async with sess.get(base + "/metrics") as r:
                metrics = await r.json()
        return nbytes, done, metrics

    try:
        nbytes, done, metrics = asyncio.run(asyncio.wait_for(go(), 180))
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    assert done["done"] is True and done["bytes"] == nbytes
    assert nbytes == 10 * P.SAMPLES_PER_FRAME * 2      # 70 tokens, 10 frames
    assert metrics["service"] == "tts_inference_tpu_torch"
    assert metrics["mode"] == "scheduler"


def _reference_generate_keys(tmp_path, monkeypatch, capsys):
    """The keys of the JAX package's `cli generate` JSON line, from its own
    command over a stub runtime (one synthesized frame, finalized metrics):
    what it prints, without building a model."""
    from types import SimpleNamespace

    from tts_inference_tpu import cli as jcli
    from tts_inference_tpu.streaming.pipeline import StreamMetrics

    metrics = StreamMetrics(tokens=7, frames=1, generation_time_ms=50.0,
                            audio_duration_ms=85.3).finalize()
    pcm = np.zeros(P.SAMPLES_PER_FRAME, np.int16)
    stub = SimpleNamespace(pipeline=SimpleNamespace(
        synthesize=lambda *a, **k: (pcm, metrics)))
    monkeypatch.setattr(jcli, "_build_runtime", lambda args, *a: stub)
    assert jcli.main(["generate", "--text", "hi",
                      "--output", str(tmp_path / "ref.wav")]) == 0
    return set(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))


def test_cli_generate_tiny_cpu(tmp_path, monkeypatch, capsys):
    out = tmp_path / "out.wav"
    assert cli.main(["generate", "--tiny", "--device", "cpu", "--text", "hi",
                     "--force-speech", "--audio-only", "--max-tokens", "35",
                     "--output", str(out), "--no-warmup"]) == 0
    # 44-byte WAV header + 5 frames of PCM16
    assert out.stat().st_size == 44 + 5 * P.SAMPLES_PER_FRAME * 2
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    # the reference's keys, tokens_per_sec among them, plus the device
    assert set(line) == _reference_generate_keys(
        tmp_path, monkeypatch, capsys) | {"device"}
    assert line["device"] == "cpu" and line["tokens"] == 35
    assert line["tokens_per_sec"] > 0
    assert line["tokens_per_sec"] == round(line["tokens_per_sec"], 1)


def test_cli_prefix_cache_flag():
    """`--prefix-cache` is ported: it parses into EngineConfig(prefix_cache=
    True) and is no option the CLI rejects any more (the CLI has no table of
    refused options left)."""
    args = cli.build_parser().parse_args(
        ["serve", "--tiny", "--device", "cpu", "--prefix-cache"])
    cfg = cli._config(args)
    assert cfg.engine.prefix_cache and not hasattr(cli, "UNPORTED")
    assert not cli._config(cli.build_parser().parse_args(
        ["serve", "--tiny"])).engine.prefix_cache


@pytest.mark.parametrize("flag", ["--kv-int4", "--tp=3", "--dp=2,--tp=3"])
def test_cli_rejects_unported_configurations(flag):
    if flag == "--kv-int4":
        # ported, but only over a paged cache: the JAX package's message
        with pytest.raises(ValueError, match="kv_cache_int4 requires "
                                             "paged_kv"):
            cli.main(["serve", "--tiny", "--device", "cpu", "--no-warmup",
                      flag])
        return
    # --tp / --dp are ported (serve over a mesh of processes): a tp the
    # tiny model's 2 kv heads cannot split is refused by validate_tp, with
    # the JAX package's message, before any process starts
    with pytest.raises(ValueError, match="num_key_value_heads=2 not "
                                         "divisible by tp=3"):
        cli.main(["serve", "--tiny", "--device", "cpu", "--no-warmup",
                  *flag.split(",")])


@pytest.mark.parametrize("flags,linear,embed", [
    (["--quantize"], "QuantLinear", "QuantEmbed"),
    (["--quantize", "--weight-bits", "8"], "QuantLinear", "QuantEmbed"),
    (["--quantize", "--weight-bits", "4"], "QuantLinearI4", "QuantEmbed"),
    (["--weight-bits", "4"], "Tensor", "Tensor"),
])
def test_cli_quantize_flags(flags, linear, embed):
    """`serve --quantize [--weight-bits 4]` quantizes the LM at boot: int8
    or int4 layer linears, the embedding (the tied head) int8 in both;
    --weight-bits alone changes nothing."""
    args = cli.build_parser().parse_args(
        ["serve", "--tiny", "--device", "cpu", "--no-warmup", *flags])
    rt, sched = cli.build_serving(args)
    params = sched.core.params
    assert params is rt.engine.core.params
    for lp in params["layers"]:
        for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
            assert type(lp[k]).__name__ == linear
        assert type(lp["input_norm"]).__name__ == "Tensor"
    assert type(params["embed"]).__name__ == embed


def test_cli_native_protocol_flag():
    """`serve --native-protocol` parses and boots (warmup included) a
    scheduler whose streams extract tokens and de-interleave windows in the
    C++ runtime; without the flag the scheduler keeps the Python path."""
    from tts_inference_tpu_torch.utils.native import NativeExtractor

    args = cli.build_parser().parse_args(
        ["serve", "--tiny", "--device", "cpu", "--native-protocol"])
    rt, sched = cli.build_serving(args)
    assert sched.use_native and sched.core.params is rt.engine.core.params
    st = TS._SlotState(TS.TTSRequest(text="x", force_speech=True), sched)
    assert isinstance(st.extractor, NativeExtractor) and st.extractor.started
    assert st.lookahead.use_native
    assert not cli.build_parser().parse_args(
        ["serve", "--tiny"]).native_protocol


@pytest.mark.parametrize("flags", [
    ["--paged-kv", "--kv-int8", "--kv-on-demand"],
    ["--paged-kv", "--kv-int4"],
])
def test_cli_paged_kv_flags(flags):
    """`serve --paged-kv --kv-int8 --kv-on-demand` builds a scheduler over a
    paged int8 cache, `serve --paged-kv --kv-int4` over int4 pools packed by
    head pair with nibble-plane scale pools."""
    from tts_inference_tpu_torch.models.llama import PagedKVCache

    args = cli.build_parser().parse_args(
        ["serve", "--tiny", "--device", "cpu", "--no-warmup",
         "--kv-block-size", "16", "--kv-pool-tokens", "256", *flags])
    rt, sched = cli.build_serving(args)
    ecfg = sched.core.engine_cfg
    int4 = "--kv-int4" in flags
    assert ecfg.paged_kv and ecfg.kv_cache_int4 == int4
    assert ecfg.kv_cache_int8 == ecfg.kv_on_demand == (not int4)
    assert (ecfg.kv_block_size, ecfg.kv_pool_tokens) == (16, 256)
    hkv, d = rt.config.model.num_key_value_heads, rt.config.model.head_dim
    for core in (sched.core, rt.engine.core):
        assert isinstance(core.cache, PagedKVCache) and core.cache.quantized
        assert core.cache.int4 == int4
        assert core.free_tokens() == 256
        if int4:
            assert core.cache.k[0].shape == (17, hkv // 2, 16, d)
            assert core.cache.k[0].dtype == torch.int8
            assert core.cache.k_scale[0].shape == (17, 2, hkv // 2, 16)


def test_port_imports_without_jax():
    """Every module of the port, and chip_smoke, imports with both jax and
    the JAX package poisoned."""
    mods = [m.name for m in pkgutil.walk_packages(
        tts_inference_tpu_torch.__path__, "tts_inference_tpu_torch.")]
    assert "tts_inference_tpu_torch.engine.scheduler" in mods
    assert "tts_inference_tpu_torch.utils.host_copy" in mods
    mods.append("chip_smoke")
    code = ("import sys; sys.modules['jax'] = None\n"
            "sys.modules['tts_inference_tpu'] = None\n"
            "import importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = ('jax', 'tts_inference_tpu')\n"
            "assert not any(k in bad or k.startswith(tuple(b + '.' for b in"
            " bad)) for k, v in sys.modules.items() if v is not None)\n"
            "print('ok')")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=str(REPO)),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "ok" in res.stdout, res.stderr
    importlib.import_module("tts_inference_tpu_torch.cli")


def test_port_names_no_module_of_the_jax_package():
    """No import line of the port or of chip_smoke.py names the JAX package
    (docstrings may name a counterpart file)."""
    import re

    pat = re.compile(r"^\s*(from|import)\s+tts_inference_tpu(?!_torch)\b")
    files = sorted((REPO / "tts_inference_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    hits = [f"{f.relative_to(REPO)}:{i}: {line.strip()}"
            for f in files
            for i, line in enumerate(f.read_text().splitlines(), 1)
            if pat.search(line)]
    assert not hits, hits


def test_runtime_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    """Without a device the runtime runs on cuda and raises when there is
    none; the CPU is used only when the caller asks for it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Runtime.create(TCFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["generate", "--tiny", "--text", "hi", "--no-warmup"])
    rt = Runtime.create(TCFG, device="cpu")
    assert rt.device.type == "cpu"
    assert rt.engine.core.params["final_norm"].device.type == "cpu"
