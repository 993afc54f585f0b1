"""PyTorch port, kernel modules: the plain versions of K1 and K6 (what the
wrappers run on CPU tensors, and what the kernels are held against on the
card by chip_smoke.py) against the JAX package's Pallas kernels in
interpret mode and their jnp twins. Inputs are numpy from a fixed seed;
comparisons in f32."""

import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as hst

import jax.numpy as jnp

from tts_inference_tpu.models import snac as jsnac
from tts_inference_tpu.ops.pallas import decode_attention as jda
from tts_inference_tpu.ops.pallas import paged_attention as jpa
from tts_inference_tpu.ops.pallas.vocoder import (
    fused_residual_unit as j_fused_unit)
from tts_inference_tpu_torch.ops import decode_attention as tda
from tts_inference_tpu_torch.ops import vocoder as tvoc
from tts_inference_tpu_torch.weights import _conv_to_torch

B, HKV, D = 2, 2, 16


def attn_inputs(g, w, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, HKV, g, D)).astype(np.float32)
    k = rng.standard_normal((B, w, HKV, D)).astype(np.float32)
    v = rng.standard_normal((B, w, HKV, D)).astype(np.float32)
    pos = np.array([0, w // 2 + 1], np.int32)   # masking past pos
    return q, k, v, pos


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("w", [16, 128])
@pytest.mark.parametrize("g", [1, 3, 4])
def test_decode_attention_matches_jax(g, w, dtype):
    q, k, v, pos = attn_inputs(g, w, seed=g * 1000 + w)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    want_kernel = jda.decode_attention(jq, jk, jv, jnp.asarray(pos),
                                       interpret=True)
    want_twin = jda.decode_attention_reference(jq, jk, jv, jnp.asarray(pos))
    # same rounded inputs on both sides
    tq, tk, tv = (torch.tensor(np.asarray(a, np.float32)).to(tdt)
                  for a in (jq, jk, jv))
    got = tda.decode_attention(tq, tk, tv, torch.from_numpy(pos))
    assert got.dtype == tdt and got.shape == (B, HKV, g, D)
    tol = 1e-5 if dtype == "float32" else 2e-2
    for want in (want_kernel, want_twin):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), atol=tol)


def test_decode_attention_ignores_keys_past_pos():
    q, k, v, pos = attn_inputs(3, 32, seed=5)
    got = tda.decode_attention_reference(*(torch.from_numpy(a)
                                           for a in (q, k, v, pos)))
    k2, v2 = k.copy(), v.copy()
    k2[1, pos[1] + 1:] = 1e3
    v2[1, pos[1] + 1:] = -1e3
    got2 = tda.decode_attention_reference(*(torch.from_numpy(a)
                                            for a in (q, k2, v2, pos)))
    np.testing.assert_array_equal(got.numpy(), got2.numpy())


def test_decode_attention_reads_cache_window_in_place():
    """The wrapper takes a window slice of the (B, max_seq, Hkv, D) cache
    (free batch stride) — the layout the decode step hands it."""
    q, k, v, pos = attn_inputs(3, 64, seed=6)
    kc, vc = torch.from_numpy(k), torch.from_numpy(v)
    got = tda.decode_attention(torch.from_numpy(q), kc[:, :32], vc[:, :32],
                               torch.from_numpy(pos))
    want = tda.decode_attention_reference(
        torch.from_numpy(q), kc[:, :32].contiguous(),
        vc[:, :32].contiguous(), torch.from_numpy(pos))
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("bad", ["head_dim", "groups", "pos_dtype"])
def test_decode_attention_rejects_what_the_kernel_cannot_take(bad):
    q, k, v, pos = (torch.from_numpy(a) for a in attn_inputs(3, 16, 7))
    if bad == "head_dim":
        q, k, v = q[..., :12].contiguous(), k[..., :12].contiguous(), \
            v[..., :12].contiguous()
    elif bad == "groups":
        q = torch.zeros(B, HKV, 9, D)
    else:
        pos = pos.long()
    with pytest.raises(ValueError):
        tda.decode_attention(q, k, v, pos)


SERVE = dict(b=8, hkv=8, g=3, d=128)     # cli serve: 8 slots of Orpheus-3B


@pytest.mark.parametrize("w", [256, 512, 1024, 2048, 4608])
def test_chunk_keys_fills_the_card_at_the_serve_shapes(w):
    """At every serve window the tensor-core body gets at least one block
    per SM, and the longest chunk that still gives each SM two."""
    chunk, nchunk, floats = tda.plan(w=w, dtype=torch.bfloat16, **SERVE)
    blocks = SERVE["b"] * SERVE["hkv"] * nchunk
    assert chunk in tda.MMA_CHUNKS and blocks >= tda.H100_SMS
    longer = [c for c in tda.MMA_CHUNKS if c > chunk]
    assert all(SERVE["b"] * SERVE["hkv"] * -(-w // c) < 2 * tda.H100_SMS
               for c in longer)
    assert floats == SERVE["b"] * SERVE["hkv"] * nchunk * SERVE["g"] * (
        SERVE["d"] + 2)


@settings(max_examples=200, deadline=None, derandomize=True, database=None)
@given(b=hst.integers(1, 64), units=hst.integers(1, 16), g=hst.integers(1, 8),
       d=hst.sampled_from([16, 64, 128, 256]), w=hst.integers(1, 20000),
       bf16=hst.booleans(), heads_per_block=hst.sampled_from([1, 2]),
       sms=hst.sampled_from([1, 16, 132, 144]))
def test_plan_partitions_the_window(b, units, g, d, w, bf16, heads_per_block,
                                    sms):
    """Every key j < W lies in exactly one chunk, the chunk count is the one
    the scratch is sized for (B·Hkv·S·G·(D + 2), whatever shares a block),
    and a bf16 query at D 64 / 128 gets the tensor-core body's chunk
    lengths, over bf16, int8 or int4 rows alike (K1, K3a, K3b; K5 counts
    its head pairs, one block each, when it fills the card)."""
    dtype = torch.bfloat16 if bf16 else torch.float32
    hkv = units * heads_per_block
    chunk, nchunk, floats = tda.plan(b, hkv, g, d, w, dtype, sms,
                                     heads_per_block=heads_per_block)
    if bf16 and d in (64, 128):
        assert chunk in tda.MMA_CHUNKS
        assert chunk == tda.chunk_keys(b, units, w, sms)
        assert chunk % 64 == 0     # four warps of whole 16-key steps
    else:
        assert chunk == tda.SIMPLE_CHUNK
    assert (nchunk - 1) * chunk < w <= nchunk * chunk
    assert floats == (b * hkv * nchunk * g * (d + 2) if nchunk > 1 else 0)


def chunked_attention(q, k, v, pos, chunk):
    """The arithmetic of the tensor-core body in plain f32 PyTorch: each of
    a chunk's four warps takes a quarter of the chunk's keys and forms
    (max, Σ exp, Σ exp·v) over its keys j <= pos; a block merges its warps;
    the chunks that hold keys are combined in chunk order."""
    b, hkv, g, d = q.shape
    w = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    out = torch.zeros_like(q)
    for bi in range(b):
        limit = min(int(pos[bi]) + 1, w)
        for h in range(hkv):
            parts = []
            for j0 in range(0, limit, chunk):
                j1 = min(j0 + chunk, limit)
                warps = []
                for wj0 in range(j0, j1, chunk // 4):
                    wj1 = min(wj0 + chunk // 4, j1)
                    s = q[bi, h] @ k[bi, wj0:wj1, h].T * scale     # (g, n)
                    m = s.max(dim=-1).values
                    p = torch.exp(s - m[:, None])
                    warps.append((m, p.sum(-1), p @ v[bi, wj0:wj1, h]))
                parts.append(_merge(warps))
            m, l, o = _merge(parts)
            out[bi, h] = o / l[:, None]
    return out


def _merge(parts):
    """Combine (max, denominator, accumulator) triples in their order."""
    m = torch.stack([p[0] for p in parts]).max(dim=0).values
    l = sum(torch.exp(pm - m) * pl for pm, pl, _ in parts)
    o = sum(torch.exp(pm - m)[:, None] * po for pm, _, po in parts)
    return m, l, o


@pytest.mark.parametrize("g,d,w,sms", [
    (3, 128, 256, 132), (3, 128, 512, 132), (3, 128, 2048, 132),
    (1, 128, 300, 132), (8, 64, 512, 132), (4, 64, 1000, 16),
    (3, 128, 640, 1), (2, 64, 64, 132)])
def test_chunked_online_softmax_equals_reference(g, d, w, sms):
    """The chunked online softmax with its combine step, at chunk_keys'
    chunk lengths, is the reference's attention (f32, within 1e-5): pos 0,
    W - 1, a chunk's last and first key, and a random one."""
    rng = np.random.default_rng(w + g)
    b, hkv = 6, 2
    chunk = tda.chunk_keys(8, 8, w, sms)
    q = torch.from_numpy(rng.standard_normal((b, hkv, g, d), np.float32))
    k = torch.from_numpy(rng.standard_normal((b, w, hkv, d), np.float32))
    v = torch.from_numpy(rng.standard_normal((b, w, hkv, d), np.float32))
    edge = min(chunk, w - 1)
    pos = torch.tensor([0, w - 1, edge - 1, edge, int(rng.integers(0, w)),
                        min(w - 1, chunk // 4)], dtype=torch.int32)
    got = chunked_attention(q, k, v, pos, chunk)
    want = tda.decode_attention_reference(q, k, v, pos)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


def bf16_round(x):
    return x.to(torch.bfloat16).float()


def chunked_scaled_attention(q, k_int, v_int, ks, vs, pos, chunk):
    """The arithmetic of the tensor-core body over integer rows with scales,
    in plain f32 PyTorch: the integers cast exactly; per warp (a quarter of a
    chunk) the scores q·k times 1/√D and the key's k scale, masked at pos;
    p = exp(s - max); the denominator sums the unscaled p; p·v multiplies
    x = p·vs as bf16(x) plus the bf16 remainder bf16(x - bf16(x)); warps
    merged per block, chunks in chunk order. q (B, H, G, D) bf16 values in
    f32; k_int, v_int (B, W, H, D) integers; ks, vs (B, W, H). Each head is
    its own chain (K5's pair: one warp per head on the same bytes), so the
    heads of one block give what they give alone."""
    b, hkv, g, d = q.shape
    w = k_int.shape[1]
    scale = 1.0 / math.sqrt(d)
    out = torch.zeros_like(q)
    for bi in range(b):
        limit = min(int(pos[bi]) + 1, w)
        for h in range(hkv):
            parts = []
            for j0 in range(0, limit, chunk):
                j1 = min(j0 + chunk, limit)
                warps = []
                for wj0 in range(j0, j1, chunk // 4):
                    sl = slice(wj0, min(wj0 + chunk // 4, j1))
                    s = (q[bi, h] @ k_int[bi, sl, h].float().T) * (
                        scale * ks[bi, sl, h])                     # (g, n)
                    m = s.max(dim=-1).values
                    p = torch.exp(s - m[:, None])
                    x = p * vs[bi, sl, h]
                    hi = bf16_round(x)
                    pv = (hi + bf16_round(x - hi)) @ v_int[bi, sl, h].float()
                    warps.append((m, p.sum(-1), pv))
                parts.append(_merge(warps))
            m, l, o = _merge(parts)
            out[bi, h] = o / l[:, None]
    return out


def scaled_attention_case(seed, b, hkv, g, d, bs, wb, chunk):
    """Inputs of a paged call with bf16 queries from a numpy seed, pos at
    0, W - 1, a chunk's last and first key and at random."""
    rng = np.random.default_rng(seed)
    w = wb * bs
    n = 1 + b * wb
    q = rng.standard_normal((b, hkv, g, d)).astype(np.float32)
    q = np.asarray(jnp.asarray(q, jnp.bfloat16), np.float32)
    table = (rng.permutation(n - 1)[:b * wb] + 1).reshape(b, wb).astype(
        np.int32)
    base = [0, w - 1, chunk - 1, chunk, int(rng.integers(0, w)),
            min(w - 1, 2 * chunk + chunk // 4)]
    pos = np.array((base * b)[:b], np.int32)
    return rng, q, table, pos, n


@pytest.mark.parametrize("bs,wb,g,d,chunk", [
    (16, 24, 3, 128, 64), (128, 3, 3, 128, 128), (16, 9, 8, 64, 64),
    (128, 2, 1, 64, 128)])
def test_chunked_scaled_attention_matches_jax_int8_reference(bs, wb, g, d,
                                                             chunk):
    """K3b's tensor-core arithmetic (chunked_scaled_attention, at both chunk
    lengths) against the JAX package's paged_decode_attention_int8_reference
    on int8 pools quantized from random rows: within K3_TOL (2e-2) on bf16
    outputs, as on the card."""
    b, hkv = 6, 2
    rng, q, table, pos, n = scaled_attention_case(bs + wb + g, b, hkv, g, d,
                                                  bs, wb, chunk)
    pools, scales = [], []
    for _ in range(2):
        x = rng.standard_normal((n, hkv, bs, d)).astype(np.float32)
        sc = np.maximum(np.abs(x).max(-1) / 127.0, 1e-8).astype(np.float32)
        pools.append(np.clip(np.round(x / sc[..., None]), -127, 127)
                     .astype(np.int8))
        scales.append(sc)
    want = np.asarray(jpa.paged_decode_attention_int8_reference(
        jnp.asarray(q, jnp.bfloat16), *map(jnp.asarray, pools),
        *map(jnp.asarray, scales), jnp.asarray(table), jnp.asarray(pos)),
        np.float32)
    k_int, v_int, ks, vs = (
        gather(torch.from_numpy(a), torch.from_numpy(table))
        for a in (*pools, *scales))
    got = chunked_scaled_attention(torch.from_numpy(q), k_int, v_int, ks,
                                   vs, torch.from_numpy(pos), chunk)
    np.testing.assert_allclose(bf16_round(got).numpy(), want, atol=2e-2,
                               rtol=0)


def gather(pool, table):
    """(N, H, bs, ...) pool, (B, WB) table → (B, WB·bs, H, ...)."""
    from tts_inference_tpu_torch.ops.paged_attention import gather_window
    return gather_window(pool, table)


def unit_params(c, seed):
    rng = np.random.default_rng(seed)
    return {
        "alpha1": rng.uniform(0.5, 1.5, c).astype(np.float32),
        "conv1": {"w": (0.1 * rng.standard_normal((7, 1, c))).astype(
            np.float32),
            "b": (0.1 * rng.standard_normal(c)).astype(np.float32)},
        "alpha2": rng.uniform(0.5, 1.5, c).astype(np.float32),
        "conv2": {"w": (0.1 * rng.standard_normal((1, c, c))).astype(
            np.float32),
            "b": (0.1 * rng.standard_normal(c)).astype(np.float32)},
    }


def torch_unit(p):
    return {
        "alpha1": torch.from_numpy(p["alpha1"]),
        "conv1": {"w": _conv_to_torch(torch.from_numpy(p["conv1"]["w"])),
                  "b": torch.from_numpy(p["conv1"]["b"])},
        "alpha2": torch.from_numpy(p["alpha2"]),
        "conv2": {"w": _conv_to_torch(torch.from_numpy(p["conv2"]["w"])),
                  "b": torch.from_numpy(p["conv2"]["b"])},
    }


@pytest.mark.parametrize("with_valid", [False, True])
@pytest.mark.parametrize("dil", [1, 3, 9])
def test_fused_residual_unit_matches_jax(dil, with_valid):
    rng = np.random.default_rng(dil)
    b, t, c = 2, 256, 32
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    valid = np.array([t, 181], np.int32) if with_valid else None
    if with_valid:
        x[1, 181:] = 0.0   # the decoder's tail is already zero
    p = unit_params(c, seed=10 + dil)
    jp = {k: (jnp.asarray(v) if not isinstance(v, dict)
              else {kk: jnp.asarray(vv) for kk, vv in v.items()})
          for k, v in p.items()}
    jv = None if valid is None else jnp.asarray(valid)
    want_kernel = j_fused_unit(jnp.asarray(x), jp, dil, valid=jv,
                               interpret=True)
    want_xla = jsnac._residual_unit(jnp.asarray(x), jp, dil, groups=c,
                                    valid=jv)
    tv = None if valid is None else torch.from_numpy(valid)
    tx = torch.from_numpy(x)
    for got in (tvoc.fused_residual_unit(tx, torch_unit(p), dil, tv),
                # channel-first storage viewed as (B, T, C), as the
                # port's decoder passes it
                tvoc.fused_residual_unit(
                    tx.transpose(1, 2).contiguous().transpose(1, 2),
                    torch_unit(p), dil, tv)):
        for want in (want_kernel, want_xla):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-5)
    if with_valid:
        assert not got[1, 181:].any()


def _fma32(a, b, c):
    """float32 fused multiply-add: one rounding (the products of float32
    values are exact in float64)."""
    return (a.astype(np.float64) * b.astype(np.float64)
            + c.astype(np.float64)).astype(np.float32)


def sin_squared_fast(t):
    """csrc/vocoder.cu::sin_squared_fast in numpy float32, operation for
    operation: sin² has period π, so t is reduced to r = t - jπ (three-step
    Cody-Waite) and sin r is the odd Taylor polynomial of degree 11."""
    f = np.float32
    t = t.astype(f)
    j = np.rint(t * f(0.318309886)).astype(f)
    r = _fma32(j, np.full_like(j, f(-3.140625)), t)
    r = _fma32(j, np.full_like(j, f(-9.67502593994140625e-4)), r)
    r = _fma32(j, np.full_like(j, f(-1.509957990978376e-7)), r)
    z = r * r
    p = np.full_like(z, f(-2.5052108e-8))
    for coef in (2.7557319e-6, -1.9841270e-4, 8.3333333e-3, -1.6666667e-1):
        p = _fma32(p, z, np.full_like(z, f(coef)))
    sn = _fma32(r * z, p, r)
    return sn * sn


@pytest.mark.parametrize("scale", [1.0, 30.0, 1000.0, 8192.0])
def test_sin_squared_reduction_matches_sin(scale):
    """The branch-free sin² the K6 kernel uses up to |t| = 8192 (sinf takes
    over beyond) stays within 5e-7 of sin² in f64 — far inside the unit's
    1e-4 tolerance on the card."""
    rng = np.random.default_rng(int(scale))
    t = np.concatenate([
        rng.uniform(-scale, scale, 200000),
        (np.arange(-40, 41) * (np.pi / 2)) * (scale / 64.0),   # poly's ends
        [0.0, scale, -scale]]).astype(np.float32)
    want = np.sin(t.astype(np.float64)) ** 2
    np.testing.assert_allclose(sin_squared_fast(t), want, atol=5e-7)


def test_fused_residual_unit_rejects_non_depthwise():
    p = torch_unit(unit_params(8, 0))
    p["conv1"]["w"] = torch.zeros(8, 8, 7)
    with pytest.raises(ValueError):
        tvoc.fused_residual_unit(torch.zeros(1, 16, 8), p, 1)


def test_fused_residual_unit_rejects_channels_beyond_the_widest_tile():
    c = tvoc.MAX_CHANNELS + 8
    p = {"alpha1": torch.ones(c),
         "conv1": {"w": torch.zeros(c, 1, 7), "b": torch.zeros(c)},
         "alpha2": torch.ones(c),
         "conv2": {"w": torch.zeros(c, c, 1), "b": torch.zeros(c)}}
    with pytest.raises(ValueError):
        tvoc.fused_residual_unit(torch.zeros(1, 8, c), p, 1)
    assert tvoc.MAX_CHANNELS == 512     # SNAC 24 kHz: 512, 256, 128, 64


def test_wrappers_count_only_kernel_launches():
    """On CPU tensors the wrappers run the plain versions and launch
    nothing, so the launch counters stay put."""
    n1, n6 = tda.launches.count, tvoc.launches.count
    q, k, v, pos = (torch.from_numpy(a) for a in attn_inputs(1, 16, 8))
    tda.decode_attention(q, k, v, pos)
    tvoc.fused_residual_unit(torch.zeros(1, 16, 8),
                             torch_unit(unit_params(8, 1)), 3)
    assert (tda.launches.count, tvoc.launches.count) == (n1, n6)
