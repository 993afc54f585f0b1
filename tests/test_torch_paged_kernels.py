"""PyTorch port, paged-attention kernel modules: the plain versions of K3a
and K3b (what the wrappers run on CPU tensors, and what the kernels are held
against on the card by chip_smoke.py) against the JAX package's Pallas
kernels in interpret mode; the pool writes (``pool_scatter``) and the int8
KV quantizer against JAX. Inputs are numpy from fixed seeds; f32, within
the JAX package's own kernel bound (atol 2e-5, rtol 1e-4)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tts_inference_tpu.models import llama as jl
from tts_inference_tpu.ops.pallas import paged_attention as jpa
from tts_inference_tpu_torch.models import llama as tl
from tts_inference_tpu_torch.ops import paged_attention as tpa

B, HKV, D, BS = 2, 4, 32, 16
TOL = dict(atol=2e-5, rtol=1e-4)


def pools(rng, n, int8):
    if int8:
        kp = rng.integers(-127, 128, (n, HKV, BS, D)).astype(np.int8)
        vp = rng.integers(-127, 128, (n, HKV, BS, D)).astype(np.int8)
        ks = rng.uniform(0.005, 0.03, (n, HKV, BS)).astype(np.float32)
        vs = rng.uniform(0.005, 0.03, (n, HKV, BS)).astype(np.float32)
        return kp, vp, ks, vs
    return (rng.standard_normal((n, HKV, BS, D)).astype(np.float32),
            rng.standard_normal((n, HKV, BS, D)).astype(np.float32))


def run_both(q, pool_arrs, table, pos):
    """(port, JAX kernel in interpret mode) outputs as numpy."""
    t = [torch.from_numpy(a) for a in (q, *pool_arrs)]
    tt, tp = torch.from_numpy(table), torch.from_numpy(pos)
    j = [jnp.asarray(a) for a in (q, *pool_arrs, table, pos)]
    if len(pool_arrs) == 4:
        got = tpa.paged_decode_attention_int8(*t, tt, tp)
        want = jpa.paged_decode_attention_int8(*j, interpret=True)
    else:
        got = tpa.paged_decode_attention(*t, tt, tp)
        want = jpa.paged_decode_attention(*j, interpret=True)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("wb", [2, 4])
@pytest.mark.parametrize("g", [3, 8])
def test_paged_attention_matches_jax(g, wb, int8):
    rng = np.random.default_rng(100 * g + 10 * wb + int8)
    q = rng.standard_normal((B, HKV, g, D)).astype(np.float32)
    # non-contiguous, interleaved block tables
    table = np.array([[1, 3, 5, 7][:wb], [8, 2, 6, 4][:wb]], np.int32)
    pos = np.array([wb * BS // 3, wb * BS - 1], np.int32)
    got, want = run_both(q, pools(rng, 10, int8), table, pos)
    assert got.shape == (B, HKV, g, D)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("int8", [False, True])
def test_paged_attention_reads_a_sliced_table(int8):
    """The engine hands in table[:, :WB] of its wider table (a strided
    slice); zero entries past each slot's blocks are the trash block."""
    rng = np.random.default_rng(7 + int8)
    n, wb = 11, 3
    q = rng.standard_normal((B, HKV, 3, D)).astype(np.float32)
    arrs = pools(rng, n, int8)
    wide = np.zeros((B, 6), np.int32)
    wide[0, :3] = [4, 9, 2]
    wide[1, :2] = [10, 1]                      # slot 1: 2 blocks, then 0
    pos = np.array([3 * BS - 2, 2 * BS - 1], np.int32)
    sliced = torch.from_numpy(wide)[:, :wb]
    assert not sliced.is_contiguous()
    t = [torch.from_numpy(a) for a in (q, *arrs)]
    fn = tpa.paged_decode_attention_int8 if int8 \
        else tpa.paged_decode_attention
    got = fn(*t, sliced, torch.from_numpy(pos)).numpy()
    _, want = run_both(q, arrs, np.ascontiguousarray(wide[:, :wb]), pos)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("int8", [False, True])
def test_paged_attention_masks_past_pos(int8):
    """Blocks past pos (and the trash block) may hold anything."""
    rng = np.random.default_rng(21 + int8)
    q = rng.standard_normal((1, HKV, 3, D)).astype(np.float32)
    arrs = pools(rng, 6, int8)
    table = np.array([[1, 2, 3, 0]], np.int32)
    pos = np.array([20], np.int32)             # blocks 2.. (pos >= 32) unused
    got1, want = run_both(q, arrs, table, pos)
    junk = [a.copy() for a in arrs]
    for a in junk:
        a[3] = 99 if a.dtype == np.int8 else 99.0
        a[0] = -99 if a.dtype == np.int8 else -99.0
    got2, _ = run_both(q, junk, table, pos)
    np.testing.assert_array_equal(got1, got2)
    np.testing.assert_allclose(got1, want, **TOL)


def test_paged_attention_bf16_pools():
    rng = np.random.default_rng(5)
    q = rng.standard_normal((B, HKV, 3, D)).astype(np.float32)
    kp, vp = pools(rng, 10, False)
    table = np.array([[1, 3, 5], [8, 2, 6]], np.int32)
    pos = np.array([17, 47], np.int32)
    j = [jnp.asarray(a, jnp.bfloat16) for a in (q, kp, vp)]
    want = jpa.paged_decode_attention_reference(
        *j, jnp.asarray(table), jnp.asarray(pos))
    t = [torch.from_numpy(np.asarray(a, np.float32)).bfloat16() for a in j]
    got = tpa.paged_decode_attention(*t, torch.from_numpy(table),
                                     torch.from_numpy(pos))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2)


@pytest.mark.parametrize("bad", ["block_size", "pool_dtype", "table_dtype",
                                 "scale_shape"])
def test_paged_attention_rejects_what_the_kernel_cannot_take(bad):
    rng = np.random.default_rng(9)
    q = torch.from_numpy(rng.standard_normal((B, HKV, 3, D)).astype(
        np.float32))
    kp, vp, ks, vs = (torch.from_numpy(a) for a in pools(rng, 4, True))
    table = torch.ones(B, 2, dtype=torch.int32)
    pos = torch.zeros(B, dtype=torch.int32)
    if bad == "block_size":
        kp, vp = kp[:, :, :8].contiguous(), vp[:, :, :8].contiguous()
        ks, vs = ks[:, :, :8].contiguous(), vs[:, :, :8].contiguous()
    elif bad == "pool_dtype":
        kp = kp.float()     # K3b takes int8 pools, K3a pools of q's dtype
    elif bad == "table_dtype":
        table = table.long()
    else:
        ks = ks[:, :2].contiguous()
    with pytest.raises((ValueError, TypeError)):
        tpa.paged_decode_attention_int8(q, kp, vp, ks, vs, table, pos)
    if bad != "scale_shape":
        qa = q.bfloat16() if bad == "pool_dtype" else q
        with pytest.raises((ValueError, TypeError)):
            tpa.paged_decode_attention(qa, kp.float(), vp.float(), table, pos)


def test_paged_wrappers_count_only_kernel_launches():
    rng = np.random.default_rng(10)
    q = rng.standard_normal((B, HKV, 3, D)).astype(np.float32)
    table = np.array([[1, 2], [3, 1]], np.int32)
    pos = np.array([5, 20], np.int32)
    n3a, n3b = tpa.launches.count, tpa.launches_int8.count
    run_both(q, pools(rng, 4, False), table, pos)
    run_both(q, pools(rng, 4, True), table, pos)
    assert (tpa.launches.count, tpa.launches_int8.count) == (n3a, n3b)


# -- pool writes and the int8 quantizer ----------------------------------------


def test_quantize_kv_matches_jax_exactly():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 5, HKV, D)).astype(np.float32) * 3
    x[0, 0, 0] = 0.0                              # all-zero row: 1e-8 floor
    x[1, 2, 1, :4] = [127.0, -63.5, 0.5, -0.5]    # exact .5 quotients
    jq, js = jl._quantize_kv(jnp.asarray(x))
    tq, ts = tl._quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("scales", [False, True])
def test_pool_scatter_matches_jax(scales):
    """Writes of two slots into a pool, one slot masked into the trash block
    (row 0, where duplicate writes leave an unspecified survivor)."""
    rng = np.random.default_rng(12 + scales)
    n, s = 7, 5
    shape = (n, HKV, BS) if scales else (n, HKV, BS, D)
    pool = rng.standard_normal(shape).astype(np.float32)
    new = rng.standard_normal((B, s, HKV) + (() if scales else (D,))).astype(
        np.float32)
    pos = np.array([12, 3])[:, None] + np.arange(s)[None, :]
    table = np.array([[4, 2, 0], [6, 5, 0]], np.int32)
    rows = np.take_along_axis(table, pos // BS, axis=1)
    rows[1] = 0                                   # slot 1 masked → trash
    offs = (pos % BS).astype(np.int32)
    want = np.asarray(jl.pool_scatter(jnp.asarray(pool), jnp.asarray(rows),
                                      jnp.asarray(offs), jnp.asarray(new)))
    got = torch.from_numpy(pool.copy())
    out = tl.pool_scatter(got, torch.from_numpy(rows),
                          torch.from_numpy(offs), torch.from_numpy(new))
    assert out is got                             # in place
    np.testing.assert_array_equal(got.numpy()[1:], want[1:])
    # slot 0's positions 12..16 span rows 4 (offsets 12-15) and 2 (offset 0)
    np.testing.assert_array_equal(got.numpy()[2][:, 0], new[0, 4])
