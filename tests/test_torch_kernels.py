"""PyTorch port, kernel modules: the plain versions of K1 and K6 (what the
wrappers run on CPU tensors, and what the kernels are held against on the
card by chip_smoke.py) against the JAX package's Pallas kernels in
interpret mode and their jnp twins. Inputs are numpy from a fixed seed;
comparisons in f32."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tts_inference_tpu.models import snac as jsnac
from tts_inference_tpu.ops.pallas import decode_attention as jda
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


def test_fused_residual_unit_rejects_non_depthwise():
    p = torch_unit(unit_params(8, 0))
    p["conv1"]["w"] = torch.zeros(8, 8, 7)
    with pytest.raises(ValueError):
        tvoc.fused_residual_unit(torch.zeros(1, 16, 8), p, 1)


def test_wrappers_count_only_kernel_launches():
    """On CPU tensors the wrappers run the plain versions and launch
    nothing, so the launch counters stay put."""
    n1, n6 = tda.launches.count, tvoc.launches.count
    q, k, v, pos = (torch.from_numpy(a) for a in attn_inputs(1, 16, 8))
    tda.decode_attention(q, k, v, pos)
    tvoc.fused_residual_unit(torch.zeros(1, 16, 8),
                             torch_unit(unit_params(8, 1)), 3)
    assert (tda.launches.count, tvoc.launches.count) == (n1, n6)
