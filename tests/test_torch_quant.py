"""The port's weight quantization (``models/quant.py``, ``ops/int4_matmul.py``)
against the JAX package on the CPU: the packed bytes and scales of both
quantizers, the plain versions of K4 and K2 against the JAX kernel (Pallas
interpret mode) and its twin, the model and the scheduler over quantized
leaves carried across byte for byte. Inputs come from numpy seeds."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tts_inference_tpu.config import (SamplingConfig, StreamConfig,
                                      tiny_config)
from tts_inference_tpu.engine import scheduler as JS
from tts_inference_tpu.models import llama as jl
from tts_inference_tpu.models import quant as jq
from tts_inference_tpu.models.snac import SnacDecoder as JSnac
from tts_inference_tpu.ops.pallas import int4_matmul as jmm
from tts_inference_tpu.utils.tokenizer import ByteTokenizer
from tts_inference_tpu_torch import weights as W
from tts_inference_tpu_torch.engine import scheduler as TS
from tts_inference_tpu_torch.models import llama as tl
from tts_inference_tpu_torch.models import quant as tq
from tts_inference_tpu_torch.ops import int4_matmul as tmm
from tts_inference_tpu_torch.runtime import Runtime

from tests.torch_port_helpers import (AUDIO_RANGE, numpy_llama_tree,
                                      numpy_snac_tree, port_config, to_jax)

CFG = tiny_config()
TCFG = port_config(CFG)


def t(a, dtype=None):
    return W.tensor_from_numpy(np.asarray(a), dtype=dtype)


# -- the packed format ---------------------------------------------------------


@pytest.mark.parametrize("k,n", [(256, 128), (64, 64), (1024, 384)])
def test_pack_unpack_int4_bytes_equal_jax(k, n):
    q = np.random.default_rng(0).integers(-8, 8, size=(k, n)).astype(np.int32)
    packed = tmm.pack_int4(torch.from_numpy(q))
    assert packed.dtype == torch.int8 and packed.shape == (k // 2, n)
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jmm.pack_int4(jnp.asarray(q))))
    np.testing.assert_array_equal(tmm.unpack_int4(packed).numpy(), q)
    # the low nibble is offset-encoded, the high one two's complement
    assert int(tmm.pack_int4(torch.tensor([[-8], [-1]]))[0, 0]) == -16


@pytest.mark.parametrize("k", [64, 128, 192, 3072, 8192, 6, 1000])
@pytest.mark.parametrize("group", [512, 128])
def test_pick_group_matches_jax(k, group):
    g = tmm.pick_group(k, group)
    assert g == jmm.pick_group(k, group) and (k // 2) % g == 0


def _assert_quantized_equal(got, want, what):
    """Bytes from the two quantizers: ``w / scale`` in f32 may differ in the
    last bit between the frameworks, so an element may land one step apart
    where it sits on a rounding tie. States the count; none is expected at
    these sizes."""
    got, want = np.asarray(got, np.int32), np.asarray(want, np.int32)
    assert got.shape == want.shape, what
    differ = int((got != want).sum())
    assert np.abs(got - want).max() <= 1, what
    assert differ <= 1e-4 * got.size, f"{what}: {differ} of {got.size} differ"


@pytest.mark.parametrize("k,n", [(64, 96), (256, 64), (3072, 128)])
def test_quantize_linear_and_embed_match_jax(k, n):
    w = (np.random.default_rng(1).standard_normal((k, n)) * 0.05).astype(
        np.float32)
    for tfn, jfn in ((tq.quantize_linear, jq.quantize_linear),
                     (tq.quantize_embed, jq.quantize_embed)):
        got, want = tfn(torch.from_numpy(w)), jfn(jnp.asarray(w))
        assert type(got).__name__ == type(want).__name__
        assert got._fields == want._fields == ("w_i8", "scale")
        np.testing.assert_array_equal(got.scale.numpy(),
                                      np.asarray(want.scale))
        _assert_quantized_equal(got.w_i8.numpy(), want.w_i8, jfn.__name__)
        assert got.w_i8.dtype == torch.int8
        assert got.scale.dtype == torch.float32


@pytest.mark.parametrize("k,n,group", [(64, 64, 512), (128, 64, 512),
                                       (64, 32, 512), (1024, 512, 512),
                                       (1024, 384, 128), (3072, 200, 512)])
def test_quantize_linear_i4_matches_jax(k, n, group):
    """Packed bytes, scales, the group picked from the shapes and the
    128-column padding of the packed array."""
    w = (np.random.default_rng(2).standard_normal((k, n)) * 0.02).astype(
        np.float32)
    got = tq.quantize_linear_i4(torch.from_numpy(w), group)
    want = jq.quantize_linear_i4(jnp.asarray(w), group)
    assert got._fields == want._fields == ("w_p", "scale")
    assert got.w_p.shape == want.w_p.shape == (k // 2, -(-n // 128) * 128)
    assert got.scale.shape == want.scale.shape
    assert k // got.scale.shape[0] == jmm.pick_group(k, group)
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    _assert_quantized_equal(tmm.unpack_int4(got.w_p).numpy(),
                            jmm.unpack_int4(want.w_p), "quantize_linear_i4")
    assert not got.w_p[:, n:].ne(tmm.pack_int4(
        torch.zeros(k, 1, dtype=torch.int32))).any()     # padding = q 0


# -- K4: the plain version against the JAX kernel and its twin -----------------


@pytest.mark.parametrize("m,k,n", [(1, 1024, 512), (16, 256, 384),
                                   (5, 64, 64)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_int4_mm_matches_jax_kernel_and_twin(m, k, n, dtype):
    """The shapes of the JAX package's own kernel test. Against the twin
    (f32 throughout, one rounding to x.dtype): 1e-5 relative in f32, one
    bf16 step in bf16. Against the Pallas kernel in interpret mode (another
    summation order): 2e-2 relative, the JAX test's own bound."""
    rng = np.random.default_rng(1)
    w = rng.standard_normal((k, n), dtype=np.float32) * 0.02
    ql = jq.quantize_linear_i4(jnp.asarray(w))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    x = jnp.asarray(rng.standard_normal((m, k), dtype=np.float32) * 0.5, jdt)
    tx, wp, sc = t(x), t(ql.w_p), t(ql.scale)
    got = tmm.int4_mm(tx, wp, sc)                  # CPU: the plain version
    assert got.dtype == tx.dtype and got.shape == (m, n)
    assert torch.equal(got, tmm.int4_mm_reference(tx, wp, sc))
    twin = np.asarray(jmm.int4_mm_reference(x, ql.w_p, ql.scale), np.float32)
    kern = np.asarray(jmm.int4_mm(x, ql.w_p, ql.scale, interpret=True),
                      np.float32)
    top = np.abs(twin).max()
    tol = 2.0 ** -7 if dtype == "bfloat16" else 1e-5
    assert np.abs(got.float().numpy() - twin).max() <= tol * top
    assert np.abs(got.float().numpy() - kern).max() <= 2e-2 * top


def test_int4_mm_leading_dims_padding_and_checks():
    rng = np.random.default_rng(3)
    w = rng.standard_normal((64, 40), dtype=np.float32)
    ql = tq.quantize_linear_i4(torch.from_numpy(w))
    x = torch.from_numpy(rng.standard_normal((2, 3, 64), dtype=np.float32))
    y = tmm.int4_mm(x, ql.w_p, ql.scale)
    assert y.shape == (2, 3, 40)                   # padded columns dropped
    deq = (tmm.unpack_int4(ql.w_p)[:, :40].float().reshape(2, 32, 40)
           * ql.scale[:, None, :]).reshape(64, 40)
    np.testing.assert_allclose(y.numpy(), (x @ deq).numpy(), atol=1e-5)
    with pytest.raises(ValueError, match="packed weights"):
        tmm.int4_mm(x[..., :32], ql.w_p, ql.scale)
    with pytest.raises(ValueError, match="scales"):
        tmm.int4_mm(x, ql.w_p, ql.scale.double())
    with pytest.raises(TypeError, match="bf16 or f32"):
        tmm.int4_mm(x.half(), ql.w_p, ql.scale)
    with pytest.raises(ValueError, match="must divide"):
        tmm.int4_mm(x, ql.w_p, ql.scale[:1].contiguous())   # G 64 > K/2


# -- K2: the plain version against the JAX package's int8 products --------------


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_w8_mm_matches_jax_mm(dtype):
    """(in, out) int8 weights: ``quant.mm``'s QuantLinear branch. The same
    integers and scales on both sides; f32: 1e-5 relative, bf16: one bf16
    step of the largest output."""
    rng = np.random.default_rng(4)
    w = rng.standard_normal((128, 96), dtype=np.float32) * 0.05
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    x = jnp.asarray(rng.standard_normal((2, 5, 128), dtype=np.float32), jdt)
    jw = jq.quantize_linear(jnp.asarray(w))
    tw = tq.QuantLinear(t(jw.w_i8), t(jw.scale))
    want = np.asarray(jq.mm(x, jw), np.float32)
    got = tq.mm(t(x), tw)
    assert got.dtype == t(x).dtype and got.shape == (2, 5, 96)
    tol = 2.0 ** -7 if dtype == "bfloat16" else 1e-5
    assert np.abs(got.float().numpy() - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("base", [0, 7, 40])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_quantized_logits_match_jax(base, dtype):
    """``tied_logits`` over a row slice of the int8 embedding (a view, never
    a copy) and ``head_logits`` over a column slice of an int8 head: f32
    logits on both sides."""
    rng = np.random.default_rng(5)
    emb = rng.standard_normal((64, 32), dtype=np.float32) * 0.05
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    h = jnp.asarray(rng.standard_normal((3, 32), dtype=np.float32), jdt)
    je = jq.quantize_embed(jnp.asarray(emb))
    te = tq.QuantEmbed(t(je.w_i8), t(je.scale))
    got = tq.tied_logits(t(h), te, base)
    want = np.asarray(jq.tied_logits(h, je, base))
    assert got.dtype == torch.float32 and got.shape == (3, 64 - base)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert te.w_i8[base:].data_ptr() == te.w_i8.data_ptr() + base * 32
    jh = jq.quantize_linear(jnp.asarray(emb.T.copy()))
    th = tq.QuantLinear(t(jh.w_i8), t(jh.scale))
    got = tq.head_logits(t(h), th, base)
    want = np.asarray(jq.head_logits(h, jh, base))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    toks = rng.integers(0, 64, (2, 4)).astype(np.int32)
    np.testing.assert_array_equal(
        tq.embed_rows(te, torch.from_numpy(toks), t(h).dtype).float().numpy(),
        np.asarray(jq.embed_rows(je, jnp.asarray(toks), jdt), np.float32))


def test_w8_mm_checks():
    x = torch.zeros(2, 16)
    w = torch.zeros(16, 8, dtype=torch.int8)
    s = torch.ones(8)
    assert tmm.w8_mm(x, w, s).shape == (2, 8)
    assert tmm.w8_mm(x, w.t().contiguous(), s, rows=True,
                     out_dtype=torch.float32).dtype == torch.float32
    with pytest.raises(ValueError, match="int8 weights"):
        tmm.w8_mm(x, w.t(), s)                     # columns not contiguous
    with pytest.raises(ValueError, match="scale"):
        tmm.w8_mm(x, w, s[:4])
    with pytest.raises(ValueError, match="multiples of 4"):
        tmm.w8_mm(torch.zeros(2, 6), torch.zeros(8, 6, dtype=torch.int8), s,
                  rows=True)
    with pytest.raises(TypeError, match="bf16 or f32"):
        tmm.w8_mm(x, w, s, out_dtype=torch.float16)


# -- the parameter tree ---------------------------------------------------------


@pytest.fixture(scope="module")
def trees():
    return (numpy_llama_tree(CFG.model, seed=0),
            numpy_snac_tree(CFG.snac, seed=1))


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_llama_params_tree(trees, bits):
    """Layer linears int8 or int4, norms untouched, the embedding (the tied
    head) int8 in both; the same integers as the JAX package's tree."""
    tp = W.llama_params_from_jax(trees[0])
    got = tq.quantize_llama_params(tp, bits=bits)
    want = jq.quantize_llama_params(to_jax(trees[0]), bits=bits)
    lin = tq.QuantLinearI4 if bits == 4 else tq.QuantLinear
    assert isinstance(got["embed"], tq.QuantEmbed)
    assert isinstance(tp["embed"], torch.Tensor)   # the source is kept
    for glp, wlp in zip(got["layers"], want["layers"]):
        assert set(glp) == set(wlp)
        for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
            assert isinstance(glp[k], lin)
            assert type(wlp[k]).__name__ == lin.__name__
            np.testing.assert_array_equal(glp[k].scale.numpy(),
                                          np.asarray(wlp[k].scale))
            _assert_quantized_equal(glp[k][0].numpy(), wlp[k][0], k)
        assert isinstance(glp["input_norm"], torch.Tensor)
    if bits == 4:
        q = got["layers"][0]
        assert q["wq"].w_p.shape == (32, 128) and q["wq"].scale.shape == (2, 64)
        assert q["w_down"].w_p.shape == (64, 128)   # K 128: group 64
        assert q["w_down"].scale.shape == (2, 64)
    with pytest.raises(ValueError, match="bits"):
        tq.quantize_llama_params(tp, bits=2)


@pytest.mark.parametrize("env", [None, "128", "16"])
def test_quantize_llama_params_reads_int4_group_env(trees, env, monkeypatch):
    """With no explicit group both sides take TTS_INT4_GROUP at call time
    (default 512): the same scale shapes and packed bytes. At the tiny
    widths (K 64 / 128) 512 and 128 both shrink to the K-half; 16 does not,
    so it shows that the variable is read."""
    if env is None:
        monkeypatch.delenv("TTS_INT4_GROUP", raising=False)
    else:
        monkeypatch.setenv("TTS_INT4_GROUP", env)
    got = tq.quantize_llama_params(W.llama_params_from_jax(trees[0]), bits=4)
    want = jq.quantize_llama_params(to_jax(trees[0]), bits=4)
    for glp, wlp in zip(got["layers"], want["layers"]):
        for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
            assert tuple(glp[k].scale.shape) == wlp[k].scale.shape
            np.testing.assert_array_equal(glp[k].scale.numpy(),
                                          np.asarray(wlp[k].scale))
            np.testing.assert_array_equal(glp[k].w_p.numpy(),
                                          np.asarray(wlp[k].w_p))
    wq = got["layers"][0]["wq"]                 # K 64
    assert wq.scale.shape == ((4, 64) if env == "16" else (2, 64))


def test_quantize_llama_params_frees_its_source(trees):
    tp = W.llama_params_from_jax(trees[0])
    got = tq.quantize_llama_params(tp, bits=4, free_source=True)
    assert "embed" not in tp and "wq" not in tp["layers"][0]
    assert "input_norm" in tp["layers"][0]
    assert isinstance(got["layers"][1]["w_up"], tq.QuantLinearI4)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_leaves_are_carried_across_byte_for_byte(trees, bits):
    jqp = jq.quantize_llama_params(to_jax(trees[0]), bits=bits)
    tp = W.llama_params_from_jax(jqp)
    assert isinstance(tp["embed"], tq.QuantEmbed)
    lin = tq.QuantLinearI4 if bits == 4 else tq.QuantLinear
    for tlp, jlp in zip(tp["layers"], jqp["layers"]):
        for k in ("wq", "w_down"):
            assert isinstance(tlp[k], lin)
            for a, b in zip(tlp[k], jlp[k]):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(tp["embed"].w_i8.numpy(),
                                  np.asarray(jqp["embed"].w_i8))


@pytest.mark.parametrize("bits", [8, 4])
def test_forward_over_quantized_leaves_matches_jax(trees, bits):
    """Prefill and three decode steps of the tiny f32 model over the same
    quantized leaves: hidden states and logits within 2e-5 (f32 sums in
    another order)."""
    mcfg, tmcfg = CFG.model, TCFG.model
    jqp = jq.quantize_llama_params(to_jax(trees[0]), bits=bits)
    tp = W.llama_params_from_jax(jqp)
    rng = np.random.default_rng(6)
    toks = rng.integers(0, 1000, (2, 16)).astype(np.int32)
    lens = np.array([16, 9], np.int32)
    jc = jl.init_kv_cache(mcfg, 2, 64)
    tc = tl.init_kv_cache(tmcfg, 2, 64)
    jlog, jc = jl.prefill(jqp, mcfg, jnp.asarray(toks), jnp.asarray(lens), jc,
                          logits_base=128000)
    tlog, tc = tl.prefill(tp, tmcfg, torch.from_numpy(toks),
                          torch.from_numpy(lens), tc, logits_base=128000)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=2e-5)
    tok = np.array([5, 6], np.int32)
    for _ in range(3):
        jlog, jc = jl.decode_one(jqp, mcfg, jnp.asarray(tok), jc,
                                 kv_window=32)
        tlog, tc = tl.decode_one(tp, tmcfg, torch.from_numpy(tok), tc,
                                 kv_window=32)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=2e-5)
        tok = (tok * 7 + 3) % 1000
    assert tc.lengths.tolist() == [19, 12]


# -- the runtime and the scheduler ----------------------------------------------


def test_runtime_quantizes_after_import(trees):
    for bits, lin in ((8, tq.QuantLinear), (4, tq.QuantLinearI4)):
        rt = Runtime.create(TCFG, device="cpu", llama_tree=trees[0],
                            snac_tree=trees[1], quantize=True,
                            weight_bits=bits)
        p = rt.engine.core.params
        assert isinstance(p["layers"][0]["wo"], lin)
        assert isinstance(p["embed"], tq.QuantEmbed)
    plain = Runtime.create(TCFG, device="cpu", llama_tree=trees[0],
                           snac_tree=trees[1])
    assert isinstance(plain.engine.core.params["embed"], torch.Tensor)


SCFG = StreamConfig(frames_per_chunk=2, lookahead_frames=3,
                    left_context_frames=4)


def _run_scheduler(sched, reqs):
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


@pytest.mark.parametrize("bits", [8, 4])
def test_scheduler_pcm_with_quantized_weights_matches_jax(trees, bits):
    """`serve --quantize [--weight-bits 4]` at tiny width: three concurrent
    greedy requests through both schedulers over the same quantized leaves;
    the same token and frame counts, PCM within 1 LSB."""
    jqp = jq.quantize_llama_params(to_jax(trees[0]), bits=bits)
    jvoc = JSnac(to_jax(trees[1]), CFG.snac)

    def reqs(mod, scfg):
        return [mod.TTSRequest(
            text=f"request {i}", stream_cfg=scfg, force_speech=True,
            sampling=dataclasses.replace(
                port_config(SamplingConfig()) if mod is TS
                else SamplingConfig(), greedy=True, max_tokens=21 + 7 * i,
                token_range=AUDIO_RANGE)) for i in range(3)]

    want = _run_scheduler(JS.Scheduler(jqp, CFG, jvoc, ByteTokenizer()),
                          reqs(JS, SCFG))
    rt = Runtime.create(TCFG, device="cpu", snac_tree=trees[1],
                        llama_tree=jqp)
    sched = TS.Scheduler(rt.engine.core.params, TCFG, rt.vocoder,
                         rt.tokenizer)
    got = _run_scheduler(sched, reqs(TS, port_config(SCFG)))
    for (gp, gm), (wp, wm) in zip(got, want):
        assert gm.tokens == wm.tokens and gm.frames == wm.frames
        x = np.frombuffer(gp, np.int16).astype(np.int32)
        y = np.frombuffer(wp, np.int16).astype(np.int32)
        assert x.shape == y.shape and x.size > 0
        assert np.abs(x - y).max() <= 1 and (x == y).mean() >= 0.999
