"""PyTorch port, model modules against the JAX package on the CPU:
weights import, the llama decoder (tiny and one full-geometry layer), the
sampling chain, and the SNAC vocoder. Inputs are numpy from fixed seeds."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tts_inference_tpu import protocol as P
from tts_inference_tpu.config import ModelConfig, SnacConfig, StreamConfig
from tts_inference_tpu.models import llama as jl
from tts_inference_tpu.models import snac as js
from tts_inference_tpu.ops import sampling as jS
from tts_inference_tpu_torch import weights as W
from tts_inference_tpu_torch.models import llama as tl
from tts_inference_tpu_torch.models import snac as ts
from tts_inference_tpu_torch.ops import sampling as tS
from tts_inference_tpu_torch.streaming.lookahead import \
    LookaheadStreamingDecoder

from tests.torch_port_helpers import (AUDIO_RANGE, interleaved_codes,
                                      numpy_llama_tree, numpy_snac_tree,
                                      port_config, random_codes, to_jax)

TINY_LM = ModelConfig.tiny(vocab_size=512)
TINY_SNAC = SnacConfig.tiny()


# -- weights -----------------------------------------------------------------


def test_weights_from_jax_round_trip():
    tree = numpy_llama_tree(TINY_LM, seed=0)
    tp = W.llama_params_from_jax(tree)
    np.testing.assert_array_equal(tp["embed"].numpy(), tree["embed"])
    for lt, lj in zip(tp["layers"], tree["layers"]):
        for k, v in lj.items():
            np.testing.assert_array_equal(lt[k].numpy(), v)   # (in, out)
    # bf16 leaves (ml_dtypes) keep their bits
    bf = np.asarray(jnp.asarray(tree["embed"], jnp.bfloat16))
    t = W.tensor_from_numpy(bf)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), bf.astype(np.float32))
    # SNAC: every conv lands in torch's layout
    st = numpy_snac_tree(TINY_SNAC, seed=1)
    sp = W.snac_params_from_jax(st)
    blk, jblk = sp["decoder"]["blocks"][0], st["decoder"]["blocks"][0]
    np.testing.assert_array_equal(blk["up"]["w"].numpy(),
                                  jblk["up"]["w"].transpose(1, 2, 0))
    np.testing.assert_array_equal(blk["res"][1]["conv1"]["w"].numpy(),
                                  jblk["res"][1]["conv1"]["w"].transpose(2, 1, 0))


@pytest.mark.parametrize("rate", [2, 3, 4, 8])
def test_conv_layouts_match_jax(rate):
    """conv1d and the flipped, output-padded conv_transpose1d agree with
    the JAX functions through the weight conversion."""
    rng = np.random.default_rng(rate)
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    wt = rng.standard_normal((2 * rate, 6, 4)).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    kw = dict(stride=rate, padding=-(-rate // 2), output_padding=rate % 2)
    want = js.conv_transpose1d(jnp.asarray(x), jnp.asarray(wt),
                               jnp.asarray(b), **kw)
    got = ts.conv_transpose1d(torch.from_numpy(x),
                              W._convt_to_torch(torch.from_numpy(wt)),
                              torch.from_numpy(b), **kw)
    assert got.shape == (2, 9 * rate, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    wc = rng.standard_normal((7, 2, 6)).astype(np.float32)
    want = js.conv1d(jnp.asarray(x), jnp.asarray(wc), dilation=rate,
                     padding=3 * rate, groups=3)
    got = ts.conv1d(torch.from_numpy(x), W._conv_to_torch(
        torch.from_numpy(wc)), dilation=rate, padding=3 * rate, groups=3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


# -- llama -------------------------------------------------------------------


def _both_models(cfg, seed):
    tree = numpy_llama_tree(cfg, seed)
    return to_jax(tree), W.llama_params_from_jax(tree)


def test_llama_tiny_prefill_and_decode_match_jax():
    cfg = TINY_LM
    jp, tp = _both_models(cfg, seed=3)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    lens = np.array([16, 9], np.int32)
    jc = jl.init_kv_cache(cfg, 2, 64)
    tc = tl.init_kv_cache(port_config(cfg), 2, 64)
    jlog, jc = jl.prefill(jp, cfg, jnp.asarray(toks), jnp.asarray(lens), jc)
    tlog, tc = tl.prefill(tp, port_config(cfg), torch.from_numpy(toks),
                          torch.from_numpy(lens), tc)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4)
    tok = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
    np.testing.assert_array_equal(tok, tlog.argmax(-1).numpy())
    for step in range(6):
        # slot 1 freezes from step 3 on: its write goes to the trash row
        active = np.array([True, step < 3])
        jlog, jc = jl.decode_one(jp, cfg, jnp.asarray(tok), jc,
                                 jnp.asarray(active), kv_window=32)
        tlog, tc = tl.decode_one(tp, port_config(cfg),
                                 torch.from_numpy(tok), tc,
                                 torch.from_numpy(active), kv_window=32)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=1e-4)
        np.testing.assert_array_equal(tc.lengths.numpy(),
                                      np.asarray(jc.lengths))
        tok = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
        np.testing.assert_array_equal(tok, tlog.argmax(-1).numpy())
    for li in range(cfg.num_hidden_layers):
        np.testing.assert_allclose(tc.k[li].numpy(), np.asarray(jc.k[li]),
                                   atol=1e-5)   # includes the trash row
    assert np.abs(tc.k[0][1, 63].numpy()).max() > 0


def test_llama_full_geometry_layer_matches_jax():
    """One layer at the Orpheus-3B widths (hidden 3072, 24/8 heads, D 128,
    FFN 8192, llama3 rope) in f32; vocab cut to keep the test small."""
    cfg = ModelConfig(num_hidden_layers=1, vocab_size=1024, dtype="float32")
    jp, tp = _both_models(cfg, seed=4)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    lens = np.array([8, 5], np.int32)
    jc = jl.init_kv_cache(cfg, 2, 32)
    tc = tl.init_kv_cache(port_config(cfg), 2, 32)
    jlog, jc = jl.prefill(jp, cfg, jnp.asarray(toks), jnp.asarray(lens), jc)
    tlog, tc = tl.prefill(tp, port_config(cfg), torch.from_numpy(toks),
                          torch.from_numpy(lens), tc)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-3)
    tok = np.array([7, 9], np.int32)
    for _ in range(2):
        jlog, jc = jl.decode_one(jp, cfg, jnp.asarray(tok), jc, kv_window=16)
        tlog, tc = tl.decode_one(tp, port_config(cfg),
                                 torch.from_numpy(tok), tc,
                                 kv_window=16)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-3)
        tok = tlog.argmax(-1).numpy().astype(np.int32)


def test_rope_tables_match_jax():
    cfg = ModelConfig()
    pos = np.array([[0, 1, 4095, 4607]], np.int32)
    jc, jsn = jl.rope_tables(cfg, jnp.asarray(pos))
    tc, tsn = tl.rope_tables(port_config(cfg), torch.from_numpy(pos))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_allclose(tsn.numpy(), np.asarray(jsn), atol=1e-5)


# -- sampling ----------------------------------------------------------------

VOCAB = 156940
BASE = P.HEAD_SLICE_BASE


def _sampling_case(seed, batch=4):
    """Logits over the sliced head + a state exercising every mask."""
    rng = np.random.default_rng(seed)
    logits = (3 * rng.standard_normal((batch, VOCAB - BASE))).astype(
        np.float32)
    presence = rng.random((batch, VOCAB)) < 0.3
    in_speech = np.array([False, True, True, True])[:batch]
    frame_pos = np.array([0, 0, 3, 6], np.int32)[:batch]
    temp = np.array([0.6, 0.0, 1.0, 0.8], np.float32)[:batch]
    top_p = np.array([0.95, 0.9, 0.5, 1.0], np.float32)[:batch]
    top_k = np.array([0, 1, 50, 0], np.int32)[:batch]
    rep = np.array([1.1, 1.3, 1.0, 1.2], np.float32)[:batch]
    # row 0 starts before speech under the frame protocol (only SOS may
    # follow); a token_range there would leave no admissible token at all
    lo = np.array([0, 0, AUDIO_RANGE[0], 0], np.int32)[:batch]
    hi = np.array([0, 0, AUDIO_RANGE[1], 0], np.int32)[:batch]
    fp = np.array([True, True, False, True])[:batch]
    params = dict(temperature=temp, top_p=top_p, top_k=top_k,
                  repetition_penalty=rep, allowed_min=lo, allowed_max=hi,
                  frame_protocol=fp)
    return logits, presence, in_speech, frame_pos, params


def _states(presence, in_speech, frame_pos, key_seed):
    b = presence.shape[0]
    jstate = jS.SamplingState(
        presence=jnp.asarray(presence),
        key=jax.random.split(jax.random.PRNGKey(key_seed), b),
        in_speech=jnp.asarray(in_speech), frame_pos=jnp.asarray(frame_pos))
    tstate = tS.init_sampling_state(b, VOCAB)._replace(
        presence=torch.from_numpy(presence),
        in_speech=torch.from_numpy(in_speech),
        frame_pos=torch.from_numpy(frame_pos))
    return jstate, tstate


def _jax_uniforms(key, cap):
    """The uniforms jax.random.gumbel draws inside jS.sample."""
    step_key = jax.vmap(lambda k: jax.random.split(k, 2))(key)[:, 0]
    tiny = float(jnp.finfo(jnp.float32).tiny)
    return np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, (cap,), jnp.float32, minval=tiny, maxval=1.0))(step_key))


def test_penalty_and_filters_match_jax():
    logits, presence, _, _, params = _sampling_case(0)
    pen_j = jS.apply_repetition_penalty(
        jnp.asarray(logits), jnp.asarray(presence[:, BASE:]),
        jnp.asarray(params["repetition_penalty"]))
    pen_t = tS.apply_repetition_penalty(
        torch.from_numpy(logits), torch.from_numpy(presence[:, BASE:]),
        torch.from_numpy(params["repetition_penalty"]))
    np.testing.assert_array_equal(pen_t.numpy(), np.asarray(pen_j))
    small = logits[:, :300]
    k = jnp.asarray(params["top_k"])
    np.testing.assert_array_equal(
        tS.top_k_mask(torch.from_numpy(small), torch.from_numpy(
            params["top_k"])).numpy(), np.asarray(jS.top_k_mask(
                jnp.asarray(small), k)))
    np.testing.assert_array_equal(
        tS.top_p_mask(torch.from_numpy(small), torch.from_numpy(
            params["top_p"])).numpy(), np.asarray(jS.top_p_mask(
                jnp.asarray(small), jnp.asarray(params["top_p"]))))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_matches_jax_given_the_same_uniforms(seed):
    """Every mask (token_range, frame protocol before/inside speech, EOS at
    frame boundaries), the penalty on presence[:, base:], greedy rows and
    the capped top-k/top-p Gumbel draw: tokens and state match exactly,
    step after step."""
    logits, presence, in_speech, frame_pos, params = _sampling_case(seed)
    jstate, tstate = _states(presence, in_speech, frame_pos, seed)
    jp = jS.SamplingParams(**{k: jnp.asarray(v) for k, v in params.items()})
    tp = tS.SamplingParams(**{k: torch.from_numpy(v)
                              for k, v in params.items()})
    rng = np.random.default_rng(100 + seed)
    for _ in range(8):
        u = _jax_uniforms(jstate.key, 256)
        jt, jstate = jS.sample(jnp.asarray(logits), jp, jstate, base=BASE)
        tt, tstate = tS.sample(torch.from_numpy(logits), tp, tstate,
                               base=BASE, uniforms=torch.from_numpy(u.copy()))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(tstate.presence.numpy(),
                                      np.asarray(jstate.presence))
        np.testing.assert_array_equal(tstate.in_speech.numpy(),
                                      np.asarray(jstate.in_speech))
        np.testing.assert_array_equal(tstate.frame_pos.numpy(),
                                      np.asarray(jstate.frame_pos))
        logits = (3 * rng.standard_normal(logits.shape)).astype(np.float32)


def test_mark_prompt_matches_jax_with_duplicates():
    toks = np.array([[5, 5, 9, 0], [3, 3, 3, 3]], np.int32)
    lens = np.array([3, 1], np.int32)
    js_ = jS.init_sampling_state(2, 16)
    ts_ = tS.init_sampling_state(2, 16)
    want = jS.mark_prompt(js_, jnp.asarray(toks), jnp.asarray(lens))
    got = tS.mark_prompt(ts_, torch.from_numpy(toks), torch.from_numpy(lens))
    np.testing.assert_array_equal(got.presence.numpy(),
                                  np.asarray(want.presence))


def test_default_noise_depends_on_seed_and_step_only():
    st = tS.init_sampling_state(3, 32)
    st = st._replace(seed=torch.tensor([11, 11, 12]),
                     step=torch.tensor([4, 4, 4]))
    u = tS.noise_uniforms(st, 256)
    assert torch.equal(u[0], u[1]) and not torch.equal(u[0], u[2])
    assert float(u.min()) > 0 and float(u.max()) < 1
    u2 = tS.noise_uniforms(st._replace(step=st.step + 1), 256)
    assert not torch.equal(u[0], u2[0])


# -- snac --------------------------------------------------------------------


def test_mix32_and_noise_match_jax():
    edge = np.array([0, 1, 2, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE,
                     0xFFFFFFFF, 0x9E3779B9, 12345678], np.uint32)
    want = np.asarray(js._mix32(jnp.asarray(edge))).astype(np.int64)
    got = ts._mix32(torch.from_numpy(edge.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want)
    seeds = np.array([7, 0xFFFFFFFF], np.uint32)
    offs = np.array([5, 0xFFFFFFF0], np.uint32)   # wraps past 2^32
    for block in (0, 3):
        nj = js.position_noise(jnp.asarray(seeds), block, jnp.asarray(offs),
                               64, 2)
        nt = ts.position_noise(torch.from_numpy(seeds.astype(np.int64)),
                               block, torch.from_numpy(offs.astype(np.int64)),
                               64, 2)
        np.testing.assert_allclose(nt.numpy(), np.asarray(nj), atol=1e-6)


@pytest.fixture(scope="module")
def snac_pair():
    tree = numpy_snac_tree(TINY_SNAC, seed=1)
    return to_jax(tree), W.snac_params_from_jax(tree)


def test_decode_codes_matches_jax(snac_pair):
    jp, tp = snac_pair
    rng = np.random.default_rng(5)
    codes = random_codes(rng, TINY_SNAC, 6, batch=2)
    kw_j = dict(noise_seed=jnp.asarray([3, 4], jnp.uint32),
                latent_offset=jnp.asarray([0, 8], jnp.uint32),
                valid_latent=jnp.asarray([24, 17], jnp.int32))
    kw_t = dict(noise_seed=torch.tensor([3, 4]),
                latent_offset=torch.tensor([0, 8]),
                valid_latent=torch.tensor([24, 17], dtype=torch.int32))
    want = np.asarray(js.decode_codes(jp, TINY_SNAC,
                                      [jnp.asarray(c) for c in codes], **kw_j))
    got = ts.decode_codes(tp, TINY_SNAC, [torch.from_numpy(c) for c in codes],
                          **kw_t).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    pcm_j = np.asarray(js.to_pcm16(want)).astype(np.int32)
    pcm_t = ts.to_pcm16(torch.from_numpy(got)).numpy().astype(np.int32)
    assert np.abs(pcm_j - pcm_t).max() <= 1


@pytest.mark.parametrize("lookahead", [3, 5])
def test_windowed_decode_equals_batch_decode(snac_pair, lookahead):
    """Inside the port, windowed streaming decode reproduces one batch
    decode — to the JAX package's own bound for the same property
    (tests/test_lookahead.py: atol 2e-5 on the float audio)."""
    _, tp = snac_pair
    dec = ts.SnacDecoder(tp, port_config(TINY_SNAC),
                         frame_buckets=(8, 16, 32, 64))
    rng = np.random.default_rng(6)
    codes = interleaved_codes(rng, TINY_SNAC, 40)
    l1, l2, l3 = P.deinterleave_frames(np.asarray(codes, np.int32))
    full = dec.decode_frames(l1, l2, l3, noise_seed=7)
    la = LookaheadStreamingDecoder(dec, port_config(StreamConfig(
        frames_per_chunk=5, lookahead_frames=lookahead,
        left_context_frames=4)), noise_seed=7)
    chunks = []
    for i in range(0, len(codes), P.FRAME_SIZE):
        la.feed(codes[i:i + P.FRAME_SIZE])
        out = la.poll()
        if out is not None:
            chunks.append(out)
    chunks.append(la.flush())
    got = np.concatenate([c for c in chunks if c is not None])
    assert got.shape == full.shape
    np.testing.assert_allclose(got, full, atol=2e-5)
    pcm = lambda a: ts.to_pcm16(torch.from_numpy(a)).numpy().astype(int)  # noqa: E731
    assert np.abs(pcm(got) - pcm(full)).max() <= 1
    assert la.frames_decoded_total <= 4 * 40
