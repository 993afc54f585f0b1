"""PyTorch port, the long-audio engine class, against the JAX package on the
CPU (the twin of tests/test_long_audio.py).

The JAX package's long-audio geometry (``long_tiny_config``: max_seq
14,400, paged KV in blocks of 64, window buckets doubled past 4,096) and
the ``cli serve`` long geometry ``bench.py --mode long`` boots (max_seq
12,160 = 128 + 12,032) held against the JAX package: the window buckets,
the core's ``max_seq``, ``kv_bucket`` and ``kv_demand``; the paged decode
``forward`` at positions past 8,192 with Orpheus's llama3 rope scaling
(factor 32 over 8,192 original positions), over more than 64 blocks a
row; the SNAC position noise at sample offsets of a long stream; and
streams through the port's engine → extractor → windowed lookahead that
cross the 4,096 window bucket, with frame accounting and O(n) re-decode.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tts_inference_tpu import protocol as JP
from tts_inference_tpu.config import (EngineConfig, ModelConfig,
                                      extended_kv_buckets as j_extended)
from tts_inference_tpu.engine.engine import EngineCore as JCore
from tts_inference_tpu.models import llama as jl
from tts_inference_tpu.models import snac as jsnac
from tts_inference_tpu_torch import cli
from tts_inference_tpu_torch import protocol as P
from tts_inference_tpu_torch import weights as W
from tts_inference_tpu_torch.config import (SamplingConfig, StreamConfig,
                                            extended_kv_buckets)
from tts_inference_tpu_torch.engine.engine import EngineCore as TCore
from tts_inference_tpu_torch.models import llama as tl
from tts_inference_tpu_torch.models import snac as tsnac
from tts_inference_tpu_torch.runtime import Runtime

from tests.test_long_audio import MAX_TOKENS, TARGET_FRAMES, long_tiny_config
from tests.torch_port_helpers import numpy_llama_tree, port_config, to_jax

BASE = (256, 512, 1024, 2048, 4096)
# bench.py --mode long through `cli serve`: 4 slots, one prompt bucket of
# 128, a 12,032-token budget, paged bf16 KV over 4 x (128 + 12,032 + 16)
LONG_ARGV = ["serve", "--quantize", "--paged-kv", "--max-batch-size", "4",
             "--max-input-len", "128", "--prefill-buckets", "128",
             "--max-output-len", "12032", "--kv-pool-tokens", "48704"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: its streams run beside
    other files' servers, which wait on starved OpenMP threads when all
    cores are taken."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- geometry ---------------------------------------------------------------


@pytest.mark.parametrize("base", [BASE, (128, 1024), (64,), (8192,)])
@pytest.mark.parametrize("max_seq", [320, 4096, 4608, 8192, 8193, 12160,
                                     14400, 40000])
def test_extended_kv_buckets_equal_jax(base, max_seq):
    assert extended_kv_buckets(base, max_seq) == j_extended(base, max_seq)


def test_extended_kv_buckets_long_geometries():
    assert extended_kv_buckets(BASE, 12160) == BASE + (8192,)
    assert extended_kv_buckets(BASE, 14400) == BASE + (8192,)
    assert extended_kv_buckets(BASE, 4608) == BASE


def test_cli_long_flags_map_as_the_jax_cli_does():
    """`cli serve` at bench.py --mode long's flags: max_seq 12,160 (the
    port's default max_input_len is 512, so --max-input-len 128 makes it),
    window buckets to 8,192 with max_seq the last window, the pool and the
    paged bf16 cache."""
    args = cli.build_parser().parse_args(LONG_ARGV)
    eng = cli._config(args).engine
    assert eng.max_seq_len == 12160
    assert eng.kv_buckets == (256, 512, 1024, 2048, 4096, 8192)
    assert eng.prefill_buckets == (128,) and eng.max_batch_size == 4
    assert eng.kv_pool_tokens == 48704 == 4 * (128 + 12032 + 16)
    assert eng.paged_kv and eng.kv_block_size == 128
    assert not (eng.kv_cache_int8 or eng.kv_cache_int4 or eng.kv_on_demand)
    # the JAX CLI's mapping of the same flags, field by field
    want = dataclasses.replace(
        EngineConfig(), max_input_len=128, prefill_buckets=(128,),
        max_output_len=12032, max_batch_size=4, paged_kv=True,
        kv_pool_tokens=48704)
    want = dataclasses.replace(want, kv_buckets=j_extended(
        want.kv_buckets, want.max_seq_len))
    assert eng == port_config(want)


def _cores(cfg):
    """(JAX core, port core) of `cfg` over the same numpy weights."""
    tree = numpy_llama_tree(cfg.model, seed=0)
    return (JCore(to_jax(tree), cfg.model, cfg.engine),
            TCore(W.llama_params_from_jax(tree), port_config(cfg.model),
                  port_config(cfg.engine), device="cpu"))


@pytest.fixture(scope="module")
def long_cores():
    return _cores(long_tiny_config())


def test_core_geometry_equals_jax(long_cores):
    """max_seq, the window of every length and the tokens every request
    reserves, at the JAX package's long-audio geometry."""
    jc, tc = long_cores
    assert tc.max_seq == jc.max_seq == 14400
    for n in (1, 256, 257, 4096, 4097, 5000, 8192, 8193, 9000, 14399, 14400,
              20000):
        assert tc.kv_bucket(n) == jc.kv_bucket(n), n
    assert tc.kv_bucket(5000) == 8192 and tc.kv_bucket(9000) == 14400
    for plen in (1, 16, 17, 40, 64, 100):
        for budget in (1, 700, 8379, 12032, MAX_TOKENS, 20000):
            assert tc.kv_demand(plen, budget) == jc.kv_demand(plen, budget)
    demand = tc.kv_demand(40, MAX_TOKENS)
    assert demand >= MAX_TOKENS and demand % 64 == 0
    assert tc.free_tokens() == jc.free_tokens() == 2 * 14400


def test_long_serve_geometry_admits_four_streams():
    """At bench.py --mode long's geometry each 8,379-token stream reserves
    its worst case at admission, and the 48,704-token pool holds four; the
    core's numbers equal the JAX core's."""
    cfg = long_tiny_config()
    eng = dataclasses.replace(
        cfg.engine, max_input_len=128, prefill_buckets=(128,),
        max_output_len=12032, max_batch_size=4, kv_block_size=128,
        kv_pool_tokens=48704, kv_buckets=j_extended(BASE, 12160))
    jc, tc = _cores(dataclasses.replace(cfg, engine=eng))
    assert tc.max_seq == jc.max_seq == 12160
    assert [tc.kv_bucket(n) for n in (4000, 4100, 8000, 8300, 12160)] == \
        [jc.kv_bucket(n) for n in (4000, 4100, 8000, 8300, 12160)] == \
        [4096, 8192, 8192, 12160, 12160]
    demand = tc.kv_demand(20, 8379)
    assert demand == jc.kv_demand(20, 8379) == 8576
    assert 4 * demand <= tc.free_tokens() == jc.free_tokens() == 48640
    # the allocator hands each slot its blocks: 67 of the 95 a row
    tc._reserve_blocks([0, 1, 2, 3], [demand] * 4)
    assert [len(tc._slot_blocks[s]) for s in range(4)] == [67] * 4
    assert tc.free_tokens() == 48640 - 4 * demand


# ---- the decode forward past 8,192 positions ------------------------------------

ROPE_LM = dataclasses.replace(ModelConfig.tiny(vocab_size=512),
                              rope_scaling_factor=32.0,
                              rope_original_max_position=8192)
MAX_SEQ, BLOCK = 12160, 64          # 190 blocks a row


def test_rope_tables_past_8192_equal_jax():
    """Orpheus's llama3 scaling (factor 32 over 8,192 original positions)
    at positions 4,000-12,160: the f32 angle is positions x inv_freq on
    both sides; cos and sin of angles up to ~12,000 rad within 1e-6 (the
    two libraries' f32 cos / sin may differ by an ulp; 6e-8 measured)."""
    pos = np.arange(4000, 12161, dtype=np.int32)[None, :]
    jc, js = jl.rope_tables(ROPE_LM, jnp.asarray(pos))
    tc, ts = tl.rope_tables(port_config(ROPE_LM), torch.from_numpy(pos))
    np.testing.assert_array_equal(tl.rope_inv_freq(port_config(ROPE_LM)),
                                  jl.rope_inv_freq(ROPE_LM))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6, rtol=0)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6, rtol=0)


def test_paged_decode_forward_past_8192_matches_jax():
    """Three decode steps of two rows at positions 8,190-8,192 and
    12,100-12,102 over pools of random keys and values, each row's 190
    blocks a shuffled part of one pool, the window all of max_seq: hidden
    states within 2e-5 (f32; the attention sums 12,100 random keys, and
    the two libraries' cos, exp and summation orders differ by ulps: 4e-6
    measured, where the port without the rope scaling is off by 3.4), the
    pools written at the same rows and offsets."""
    cfg = ROPE_LM
    rng = np.random.default_rng(8)
    tree = numpy_llama_tree(cfg, seed=5)
    jp, tp = to_jax(tree), W.llama_params_from_jax(tree)
    nblk = MAX_SEQ // BLOCK
    num_blocks = 1 + 2 * nblk
    table = (1 + rng.permutation(2 * nblk)).reshape(2, nblk).astype(np.int32)
    shape = (num_blocks, cfg.num_key_value_heads, BLOCK, cfg.head_dim)
    pools = [[rng.standard_normal(shape).astype(np.float32)
              for _ in range(cfg.num_hidden_layers)] for _ in "kv"]
    lengths = np.array([8190, 12100], np.int32)
    jc = jl.init_paged_kv_cache(cfg, 2, MAX_SEQ, num_blocks=num_blocks,
                                block_size=BLOCK)
    jc = jc._replace(k=tuple(jnp.asarray(p) for p in pools[0]),
                     v=tuple(jnp.asarray(p) for p in pools[1]),
                     block_table=jnp.asarray(table),
                     lengths=jnp.asarray(lengths))
    tc = tl.init_paged_kv_cache(port_config(cfg), 2, MAX_SEQ,
                                num_blocks=num_blocks, block_size=BLOCK)
    for mine, src in zip((tc.k, tc.v), pools):
        for t, p in zip(mine, src):
            t.copy_(torch.from_numpy(p))
    tc.block_table.copy_(torch.from_numpy(table))
    tc.lengths.copy_(torch.from_numpy(lengths))
    tok = np.array([[7], [300]], np.int32)
    seg = np.ones(2, np.int32)
    for _ in range(3):
        wp = np.asarray(jc.lengths)
        jh, jc = jl.forward(jp, cfg, jnp.asarray(tok), jc, jnp.asarray(wp),
                            jnp.asarray(seg), kv_window=MAX_SEQ)
        th, tc = tl.forward(tp, port_config(cfg), torch.from_numpy(tok), tc,
                            tc.lengths.clone(), torch.from_numpy(seg),
                            kv_window=MAX_SEQ)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=2e-5,
                                   rtol=0)
        tok = (tok * 7 + 3) % cfg.vocab_size
    assert tc.lengths.tolist() == np.asarray(jc.lengths).tolist() == \
        [8193, 12103]
    for li in range(cfg.num_hidden_layers):
        for got, want in ((tc.k[li], jc.k[li]), (tc.v[li], jc.v[li])):
            # row 0 is the trash block; no row changed but the six written
            np.testing.assert_allclose(got.numpy()[1:],
                                       np.asarray(want)[1:], atol=1e-5,
                                       rtol=0)
    written = sorted({int(table[r, p // BLOCK]) for r, p in
                      ((0, 8190), (0, 8191), (0, 8192), (1, 12100))})
    assert len(written) == 3      # 8,192 opens the row's 129th block


@pytest.mark.parametrize("offset", [0, 2_047, 2_451_456, 2_451_456 * 4 - 7,
                                    2**32 - 100])
def test_position_noise_at_long_offsets_equals_jax(offset):
    """SNAC's position-addressed noise at the sample offsets of a long
    stream (2.45 M samples at 102 s, four streams' worth, the uint32 wrap):
    the hash's integers are exact on both sides, the Box-Muller floats
    within 1e-5."""
    for block in range(4):
        want = np.asarray(jsnac.position_noise(
            jnp.asarray([11, 12], jnp.uint32), block,
            jnp.asarray([offset, offset + 64], jnp.uint32), 640, 2))
        got = tsnac.position_noise(torch.tensor([11, 12]), block,
                                   torch.tensor([offset, offset + 64]), 640,
                                   2).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# ---- streams through the engine, the extractor and the windowed lookahead ----


@pytest.fixture(scope="module")
def rt():
    return Runtime.create(port_config(long_tiny_config()), seed=0,
                          device="cpu")


def _stream(rt, frames: int) -> dict:
    sampling = SamplingConfig(
        max_tokens=frames * P.FRAME_SIZE + 2, seed=11,
        token_range=(P.TOKEN_AUDIO_BASE, P.TOKEN_AUDIO_BASE + P.AUDIO_VOCAB))
    pcm = [c.pcm for c in rt.pipeline.stream(
        "long audio capacity", "tara", sampling,
        StreamConfig(frames_per_chunk=16), force_speech=True)]
    return {"m": rt.pipeline.last_metrics, "la": rt.pipeline.last_lookahead,
            "samples": sum(len(p) for p in pcm) // 2}


def _check_stream(rt, out: dict, frames: int) -> None:
    m, la = out["m"], out["la"]
    assert m.frames == frames, m.frames
    assert out["samples"] == m.frames * rt.vocoder.cfg.samples_per_frame
    overhead = (la.stream_cfg.left_context_frames
                + la.stream_cfg.lookahead_frames)
    assert la.frames_decoded_total <= m.frames + la.decode_calls * overhead
    assert la.frames_decoded_total < 3 * m.frames


def test_stream_crosses_the_4096_window(rt):
    """600 frames (4,202 tokens): the stream's decode launches move from
    the 4,096 window to the 8,192 one mid-stream; samples = frames x
    2,048 and the windowed decode stays O(n), the JAX test's bounds."""
    out = _stream(rt, 600)
    _check_stream(rt, out, 600)
    assert out["samples"] == 600 * 2048
    windows = {k for k in rt.engine.core.graph_census_ms if "decode" in k}
    assert {"capture_decode_n14_w4096",
            "capture_decode_n14_w8192"} <= windows


@pytest.mark.slow
def test_generate_2016_frames_end_to_end(rt):
    """The JAX package's bar: >= 2,000 frames (~172 s) through the
    streaming pipeline on one engine, past the 8,192 window into max_seq;
    audio length, frame accounting and O(n) windowed decode hold."""
    out = _stream(rt, TARGET_FRAMES)
    _check_stream(rt, out, TARGET_FRAMES)
    assert out["samples"] / JP.SAMPLE_RATE >= 100.0
    assert "capture_decode_n14_w14400" in rt.engine.core.graph_census_ms
