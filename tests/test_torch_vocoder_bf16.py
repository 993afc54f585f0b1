"""PyTorch port, the bf16 vocoder (``--vocoder-bf16``) and the vocoder's
CUDA-graph keys, on the CPU: K6's plain version in bf16 against the JAX
package's Pallas kernel (interpret mode) and its XLA unit; the bf16 decode
against the JAX package's bf16 and f32 decodes; windowed against batch
decode in bf16; ``cli serve --vocoder-bf16`` answering a ``/ws/tts``; the
fidelity tool against the JAX tool; the warmup's vocoder keys against the
keys a scheduler run meets; a SNAC dir's ``config.json`` against the run's
dtype. Inputs are numpy from fixed seeds."""

import asyncio
import dataclasses
import json
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tts_inference_tpu import protocol as P
from tts_inference_tpu.config import SnacConfig, StreamConfig
from tts_inference_tpu.models import snac as js
from tts_inference_tpu.ops.pallas.vocoder import (
    fused_residual_unit as j_fused_unit)
from tts_inference_tpu_torch import weights as W
from tts_inference_tpu_torch.models import snac as ts
from tts_inference_tpu_torch.ops import vocoder as tvoc
from tts_inference_tpu_torch.streaming.lookahead import \
    LookaheadStreamingDecoder
from tts_inference_tpu_torch.tools import vocoder_dtype_fidelity as tvdf

from tests.test_torch_kernels import torch_unit, unit_params
from tests.torch_port_helpers import (interleaved_codes, numpy_snac_tree,
                                      port_config, random_codes, to_jax)

TINY_SNAC = SnacConfig.tiny()
BF16_SNAC = dataclasses.replace(TINY_SNAC, dtype="bfloat16")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: its runtimes run beside
    other files' servers, which wait on starved OpenMP threads when all
    cores are taken."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bf16_step(want: np.ndarray) -> float:
    """One bf16 step of the largest magnitude in `want`."""
    return 2.0 ** (math.floor(math.log2(float(np.abs(want).max()))) - 7)


def _bf16_tree(tree):
    if isinstance(tree, dict):
        return {k: _bf16_tree(v) for k, v in tree.items()}
    return tree.bfloat16()


# -- K6's plain version in bf16 ----------------------------------------------


@pytest.mark.parametrize("dil", [1, 3, 9])
def test_k6_bf16_plain_matches_jax(dil):
    """In bf16 the plain version (torch's bf16 operations, each rounding)
    is within one bf16 step of the largest output of the Pallas kernel in
    interpret mode and of the JAX package's XLA unit on the same bf16
    inputs (measured: 0.5–1 step; the bound is 2), with per-row valid
    lengths; rows past their length are zero."""
    rng = np.random.default_rng(dil)
    b, t, c = 2, 128, 64
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    valid = np.array([t, 77], np.int32)
    x[1, 77:] = 0.0
    p = unit_params(c, seed=10 + dil)
    x16 = jnp.asarray(x, jnp.bfloat16)
    jp = {k: (jnp.asarray(v, jnp.bfloat16) if not isinstance(v, dict)
              else {kk: jnp.asarray(vv, jnp.bfloat16) for kk, vv in v.items()})
          for k, v in p.items()}
    jv = jnp.asarray(valid)
    want_kernel = np.asarray(j_fused_unit(x16, jp, dil, valid=jv,
                                          interpret=True)).astype(np.float32)
    want_xla = np.asarray(js._residual_unit(x16, jp, dil, groups=c,
                                            valid=jv)).astype(np.float32)
    got = tvoc.fused_residual_unit(torch.from_numpy(x).bfloat16(),
                                   _bf16_tree(torch_unit(p)), dil,
                                   torch.from_numpy(valid))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    for want in (want_kernel, want_xla):
        assert np.abs(got - want).max() <= 2 * bf16_step(want)
    assert not got[1, 77:].any()


def test_k6_bf16_wrapper_checks_and_counts():
    """The wrapper takes f32, bf16 or float16 with parameters of the same
    dtype; on CPU tensors it runs the plain version and launches nothing
    (float16 too, which the 16-bit body's float16 instance carries on the
    card); a dtype the kernels lack raises."""
    p16 = _bf16_tree(torch_unit(unit_params(8, 1)))
    counters = (tvoc.launches, tvoc.launches_bf16, tvoc.launches_f16)
    before = [n.count for n in counters]
    out = tvoc.fused_residual_unit(torch.zeros(1, 16, 8, dtype=torch.bfloat16),
                                   p16, 3)
    assert out.dtype == torch.bfloat16 and out.shape == (1, 16, 8)
    with pytest.raises(ValueError, match="bfloat16"):   # f32 parameters
        tvoc.fused_residual_unit(torch.zeros(1, 16, 8, dtype=torch.bfloat16),
                                 torch_unit(unit_params(8, 1)), 3)
    ph = {k: ({kk: vv.half() for kk, vv in v.items()} if isinstance(v, dict)
              else v.half()) for k, v in torch_unit(unit_params(8, 1)).items()}
    out = tvoc.fused_residual_unit(torch.zeros(1, 16, 8, dtype=torch.float16),
                                   ph, 3)
    assert out.dtype == torch.float16 and out.shape == (1, 16, 8)
    assert [n.count for n in counters] == before
    with pytest.raises(TypeError, match="f32, bf16 and float16"):
        tvoc.fused_residual_unit(torch.zeros(1, 16, 8, dtype=torch.float64),
                                 {k: ({kk: vv.double() for kk, vv in v.items()}
                                      if isinstance(v, dict) else v.double())
                                  for k, v in p16.items()}, 3)


# -- the bf16 decode -----------------------------------------------------------


@pytest.fixture(scope="module")
def snac_pair():
    tree = numpy_snac_tree(TINY_SNAC, seed=1)
    return to_jax(tree), W.snac_params_from_jax(tree)


def test_snac_decoder_casts_once_and_keeps_f32_pcm(snac_pair):
    """As in the JAX package: every f32 leaf is cast once to the compute
    dtype (codebooks, projections and alphas too), the PCM stays f32; a
    dtype the JAX package lacks is refused."""
    dec = ts.SnacDecoder(snac_pair[1], port_config(BF16_SNAC))
    leaves = []

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
        elif t is not None:
            leaves.append(t)

    walk(dec.params)
    assert leaves and all(x.dtype == torch.bfloat16 for x in leaves)
    assert snac_pair[1]["quantizer"][0]["codebook"].dtype == torch.float32
    rng = np.random.default_rng(3)
    l1, l2, l3 = (c[0] for c in random_codes(rng, TINY_SNAC, 5))
    audio = dec.decode_frames(l1, l2, l3, noise_seed=2)
    assert audio.dtype == np.float32 and audio.shape == (5 * 2048,)
    with pytest.raises(ValueError, match="float64"):
        ts.SnacDecoder(snac_pair[1], dataclasses.replace(
            port_config(TINY_SNAC), dtype="float64"))


def test_decode_codes_bf16_matches_jax(snac_pair):
    """The port's bf16 decode against the JAX package's, on the same
    weights and codes. Both round every conv output to bf16, at different
    places (torch after each operation, XLA per fusion), so each is one
    realisation of bf16 rounding noise: the port's distance to the JAX
    bf16 decode is measured against JAX's own f32-vs-bf16 distance (1.13×
    it; bound 1.5×), and the port's distance to the JAX f32 decode must be
    no larger than JAX's own bf16 decode's (0.93×; bound 1.25×). The port's
    bf16 decode also passes the fidelity tool's four thresholds against
    the JAX f32 decode."""
    jp, tp = snac_pair
    rng = np.random.default_rng(5)
    codes = random_codes(rng, TINY_SNAC, 6, batch=2)
    kw_j = dict(noise_seed=jnp.asarray([3, 4], jnp.uint32),
                latent_offset=jnp.asarray([0, 8], jnp.uint32),
                valid_latent=jnp.asarray([24, 17], jnp.int32))
    kw_t = dict(noise_seed=torch.tensor([3, 4]),
                latent_offset=torch.tensor([0, 8]),
                valid_latent=torch.tensor([24, 17], dtype=torch.int32))
    jcodes = [jnp.asarray(c) for c in codes]
    j32 = np.asarray(js.decode_codes(jp, TINY_SNAC, jcodes, **kw_j))
    jdec = js.SnacDecoder(jp, BF16_SNAC)
    j16 = np.asarray(js.decode_codes(jdec.params, BF16_SNAC, jcodes, **kw_j))
    tdec = ts.SnacDecoder(tp, port_config(BF16_SNAC))
    t16 = ts.decode_codes(tdec.params, tdec.cfg,
                          [torch.from_numpy(c) for c in codes], **kw_t)
    assert t16.dtype == torch.float32
    t16 = t16.numpy()
    jax_own = np.linalg.norm(j16 - j32)
    assert jax_own > 0
    assert np.linalg.norm(t16 - j16) <= 1.5 * jax_own
    assert np.linalg.norm(t16 - j32) <= 1.25 * jax_own
    assert tvdf.fidelity(j32, t16)["pass"]


def test_windowed_decode_equals_batch_decode_bf16(snac_pair):
    """Inside the port's bf16 path, windowed streaming decode reproduces
    one batch decode on the CPU within 1 PCM16 LSB (the f32 path's CPU
    bound: oneDNN picks its algorithm per length)."""
    _, tp = snac_pair
    dec = ts.SnacDecoder(tp, port_config(BF16_SNAC),
                         frame_buckets=(8, 16, 32, 64))
    rng = np.random.default_rng(6)
    codes = interleaved_codes(rng, TINY_SNAC, 40)
    l1, l2, l3 = P.deinterleave_frames(np.asarray(codes, np.int32))
    full = dec.decode_frames(l1, l2, l3, noise_seed=7)
    la = LookaheadStreamingDecoder(dec, port_config(StreamConfig()),
                                   noise_seed=7)
    chunks = []
    for i in range(0, len(codes), P.FRAME_SIZE):
        la.feed(codes[i:i + P.FRAME_SIZE])
        out = la.poll()
        if out is not None:
            chunks.append(out)
    chunks.append(la.flush())
    got = np.concatenate([c for c in chunks if c is not None])
    assert got.shape == full.shape
    pcm = lambda a: ts.to_pcm16(torch.from_numpy(a)).numpy().astype(int)  # noqa: E731
    assert np.abs(pcm(got) - pcm(full)).max() <= 1
    # the whole-utterance decode (bucket 64) ran eagerly and was counted;
    # every window is a graph key of one row (the census names what the
    # card would capture)
    assert dec.eager_calls == 1
    assert set(dec.graph_census_ms) <= {
        ts._census_name(("decode", 1, nb)) for nb in (8, 16)}


# -- serving -----------------------------------------------------------------


def test_cli_serve_vocoder_bf16_answers_ws_tts():
    """`cli serve --tiny --device cpu --vocoder-bf16`: the runtime's
    vocoder computes in bf16, a /ws/tts request gets its PCM16 chunks (the
    f32 PCM contract: whole 2048-sample frames, int16 bytes) and /metrics
    reports the vocoder's graph keys beside the engine's."""
    from aiohttp import WSMsgType
    from aiohttp.test_utils import TestClient, TestServer

    from tts_inference_tpu_torch import cli
    from tts_inference_tpu_torch.serving.app import create_app

    args = cli.build_parser().parse_args(
        ["serve", "--tiny", "--device", "cpu", "--vocoder-bf16"])
    assert "vocoder_bf16" not in cli.UNPORTED
    rt, sched = cli.build_serving(args)
    assert rt.config.snac.dtype == "bfloat16"
    assert rt.load_timings["snac_dtype"] == "bfloat16"
    assert rt.vocoder.params["decoder"]["out_conv"]["w"].dtype == \
        torch.bfloat16
    # the CPU's warmup runs no vocoder call: its census fills as calls come
    assert rt.load_timings["vocoder_graphs_compiled"] == 0
    sched.start()
    loop = asyncio.new_event_loop()
    c = TestClient(TestServer(create_app(rt, scheduler=sched)), loop=loop)

    async def go():
        ws = await c.ws_connect("/ws/tts")
        await ws.send_json({"text": "Hello there.", "force_speech": True,
                            "audio_only": True, "max_tokens": 70,
                            "seed": 7, "benchmark": True})
        pcm, done = b"", None
        while True:
            msg = await ws.receive(timeout=180)
            if msg.type == WSMsgType.BINARY:
                pcm += msg.data
            else:
                done = json.loads(msg.data)
                assert "error" not in done, done
                if done.get("done"):
                    break
        await ws.close()
        return pcm, done, await (await c.get("/metrics")).json()

    try:
        loop.run_until_complete(c.start_server())
        pcm, done, metrics = loop.run_until_complete(go())
    finally:
        loop.run_until_complete(c.close())
        loop.close()
        sched.stop()
    assert done["bytes"] == len(pcm) == 10 * 2048 * 2
    samples = np.frombuffer(pcm, np.int16)
    assert samples.any()
    g = metrics["graphs"]
    assert g["vocoder_late_captures"] == 0 and g["vocoder_replays"] == {}
    assert g["vocoder_launches"]["decode"] >= 1
    assert g["vocoder_launches"]["first_chunk"] == 1
    assert g["vocoder_graphs_compiled"] >= 2   # a window key, the first chunk


def test_fidelity_tool_matches_the_jax_tool(capsys):
    """The port's tools/vocoder_dtype_fidelity.py prints the JAX tool's
    JSON keys, takes its flags, and on the same codes (the weights come
    from each package's own seeded init) lands near its metrics at --tiny:
    MSE and max |diff| within a factor 2, corr within 1e-4, std-ratio
    within 1e-3, both passing."""
    from tts_inference_tpu.tools import vocoder_dtype_fidelity as jvdf

    argv = ["--tiny", "--cpu", "--frames", "8", "--batch", "2"]
    assert jvdf.main(argv) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert tvdf.main(argv) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(got) == list(want)
    assert got["thresholds"] == want["thresholds"]
    assert got["pass"] is True and want["pass"] is True
    for k in ("mse", "max_diff"):
        assert 0.5 <= got[k] / want[k] <= 2.0, (k, got[k], want[k])
    assert abs(got["corr"] - want["corr"]) <= 1e-4
    assert abs(got["std_ratio"] - want["std_ratio"]) <= 1e-3


def test_warmup_keys_cover_what_a_scheduler_run_meets():
    """The scheduler's warmup captures the vocoder keys of every (row
    bucket, frame bucket) the vocode worker can meet and every first-chunk
    geometry it decodes: a tiny CPU run of 8 mixed requests (force_speech
    and not, greedy and seeded, 56 to 210 tokens, on 4 slots; graphs are off
    on the CPU, the decoder records the keys) meets none outside them."""
    from tts_inference_tpu_torch.config import SamplingConfig, tiny_config
    from tts_inference_tpu_torch.engine.scheduler import (Scheduler,
                                                          TTSRequest)
    from tts_inference_tpu_torch.runtime import Runtime

    cfg = dataclasses.replace(tiny_config(), snac=dataclasses.replace(
        tiny_config().snac, dtype="bfloat16"))
    rt = Runtime.create(cfg, seed=0, device="cpu")
    sched = Scheduler(rt.engine.core.params, rt.config, rt.vocoder,
                      rt.tokenizer, device="cpu")
    voc = rt.vocoder
    audio = (P.TOKEN_AUDIO_BASE, P.TOKEN_AUDIO_BASE + P.AUDIO_VOCAB)
    reqs = [TTSRequest(
        text=f"Mixed request {i}.", force_speech=i % 4 != 3,
        sampling=SamplingConfig(
            greedy=i % 2 == 0, seed=100 + i, max_tokens=56 + 22 * i,
            token_range=audio if i % 4 != 3 else None))
        for i in range(8)]
    sched.start()
    try:
        for r in reqs:
            sched.submit(r)
        for r in reqs:
            while True:
                kind, payload = r.events.get(timeout=120)
                assert kind != "error", payload
                if kind == "done":
                    break
        sched.drain_vocoder()
    finally:
        sched.stop()
    met = set(voc.graph_census_ms)      # the keys of the calls made
    warm = {ts._census_name(k) for k in voc.warmup_keys(sched.core.batch)}
    first = {ts._census_name(("first_chunk", sched.core.batch, *g))
             for g in sched.first_chunk_geometries()}
    assert first and first <= met
    assert met - first - {ts._census_name(("decode", 1, nb))
                          for nb in (8, 16)}, "rows of one only"
    assert met <= warm | first, met - warm - first
    assert voc.eager_calls == 0


# -- ROADMAP.md Queue 3: a SNAC dir's config.json and the run's dtype --------


def test_snac_path_with_config_keeps_the_runs_dtype(tmp_path):
    """`--vocoder-bf16 --snac-path D` where D holds a config.json: the
    checkpoint gives the geometry, the run gives the compute dtype. The
    JAX runtime lets the checkpoint's config replace the whole SnacConfig
    and serves f32 with no message (the JAX side is wrong); the port keeps
    bf16 (and ``use_pallas``)."""
    from tests.torch_snac_ref import TorchSnacRef
    from tts_inference_tpu.config import tiny_config as jtiny
    from tts_inference_tpu.runtime import Runtime as JRuntime
    from tts_inference_tpu_torch.runtime import Runtime

    torch.manual_seed(4)
    ref = TorchSnacRef(TINY_SNAC).eval()
    torch.save(ref.state_dict(), str(tmp_path / "pytorch_model.bin"))
    (tmp_path / "config.json").write_text(json.dumps({
        "sampling_rate": 24000, "latent_dim": 32, "decoder_dim": 64,
        "decoder_rates": [8, 8, 4, 2], "codebook_size": 4096,
        "codebook_dim": 4, "vq_strides": [4, 2, 1],
        "noise": True, "depthwise": True}))
    jcfg = dataclasses.replace(jtiny(), snac=dataclasses.replace(
        jtiny().snac, dtype="bfloat16", use_pallas=True))
    jrt = JRuntime.create(jcfg, snac_path=str(tmp_path))
    assert jrt.config.snac.dtype == "float32"           # the flag is lost
    assert jrt.config.snac.use_pallas is None
    trt = Runtime.create(port_config(jcfg), snac_path=str(tmp_path),
                         device="cpu")
    assert trt.config.snac.dtype == "bfloat16"
    assert trt.config.snac.use_pallas is True
    assert trt.vocoder.params["quantizer"][0]["codebook"].dtype == \
        torch.bfloat16
    assert trt.config.snac.latent_dim == jrt.config.snac.latent_dim == 32
