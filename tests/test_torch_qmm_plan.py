"""The work plan of the port's quantized matmuls (``ops/int4_matmul.py::plan``):
the list of (tile, chunk) units a call is cut into, which block walks which
units, and in which order partial tiles are added up. The CUDA kernels get
the plan's numbers as arguments and repeat its integer arithmetic, so what
holds here holds on the card: every unit is walked exactly once, no chunk
crosses a scale group or the two halves of K, blocks differ by at most one
unit, and the order of summation is fixed. An emulation of that order in
f32 (per-chunk partial sums scaled per group, parts added in plan order,
one rounding) is held against the plain versions and, through them, against
the JAX kernel in interpret mode. Inputs come from numpy seeds."""

import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tts_inference_tpu.models import quant as jq
from tts_inference_tpu.ops.pallas import int4_matmul as jmm
from tts_inference_tpu_torch import weights as W
from tts_inference_tpu_torch.models import quant as tq
from tts_inference_tpu_torch.ops import int4_matmul as tmm

I4, I8, ROWS = tmm.FMT_I4, tmm.FMT_I8, tmm.FMT_I8_ROWS
LINEARS = ((3072, 3072), (3072, 1024), (3072, 8192), (8192, 3072))

# (fmt, m, k, n, group as quantized, tensor cores?)
SERVE_SHAPES = (
    [(I4, m, k, n, tmm.pick_group(k, g), True)
     for m in (1, 3, 8, 512) for k, n in LINEARS for g in (512, 128)]
    + [(I8, m, k, n, 0, True) for m in (1, 8, 512) for k, n in LINEARS]
    + [(ROWS, 8, 3072, 28940, 0, True),          # the tied head
       (ROWS, 8, 3072, 28940, 0, False),
       (I8, 8, 3072, 28940, 0, True),            # an untied head, sliced
       (I4, 4096, 3072, 3072, 512, True)]
    # the tiny configuration's f32 linears: the CUDA cores
    + [(I4, 4, 64, 64, 32, False), (I4, 4, 64, 32, 32, False),
       (I4, 4, 64, 128, 32, False), (I4, 4, 128, 64, 64, False),
       (I8, 4, 64, 64, 0, False), (I8, 9, 3072, 1024, 0, False),
       (I4, 9, 3072, 1024, 512, False), (ROWS, 4, 64, 2940, 0, False)]
)


def _id(shape):
    fmt, m, k, n, g, mma = shape
    return (f"{('K4', 'K2', 'K2rows')[fmt]}-M{m}-K{k}-N{n}-G{g}-"
            f"{'mma' if mma else 'cores'}")


@pytest.mark.parametrize("sms", [132, 6])
@pytest.mark.parametrize("shape", SERVE_SHAPES, ids=_id)
def test_plan_walks_every_unit_once(shape, sms):
    fmt, m, k, n, group, mma = shape
    p = tmm.plan(fmt, m, k, n, group, sms, mma)
    assert p == tmm.plan(fmt, m, k, n, group, sms, mma)      # a pure function
    assert p.col_tiles == -(-n // tmm.TILE_COLS)
    assert p.m_tiles == -(-m // p.rows) and p.blocks >= 1
    # the chunks tile each scale group of each half of K, and nothing else
    rows_total = k // 2 if fmt == I4 else k
    grows = group if fmt == I4 else rows_total
    seen = []
    for c in range(p.nchunks):
        gi, r0, nrows = tmm.chunk_at(fmt, k, group, p.chunk_rows, c)
        assert 1 <= nrows <= p.chunk_rows
        assert gi * grows <= r0 and r0 + nrows <= (gi + 1) * grows
        seen.append((r0, r0 + nrows))
    assert seen[0][0] == 0 and seen[-1][1] == rows_total
    assert all(a[1] == b[0] for a, b in zip(seen, seen[1:]))
    if not p.mma:
        # every tile: `blocks` K splits of whole groups of a block's warps
        parts = p.tile_parts(0)
        assert len(parts) == p.blocks
        assert list(itertools.chain(*parts)) == list(range(p.nchunks))
        assert all(len(r) == p.cpb for r in parts[:-1]) and len(parts[-1])
        assert p.counters == (p.tiles if p.blocks > 1 else 0)
        assert p.scratch_floats(m, n) == (p.blocks * m * n
                                          if p.blocks > 1 else 0)
        return
    assert p.rows == (16 if m <= 16 else 64) and p.chunk_rows == 64
    assert p.blocks <= max(p.units, 1)
    assert p.blocks <= sms * (2 if m <= 16 else 1)
    # the blocks' runs: consecutive, non-empty, equal up to one unit
    runs = [p.block_units(b) for b in range(p.blocks)]
    assert runs[0].start == 0 and runs[-1].stop == p.units
    assert all(a.stop == b.start for a, b in zip(runs, runs[1:]))
    sizes = {len(r) for r in runs}
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    if p.cluster > 1:
        # a cluster's blocks share one tile and nothing else
        assert m <= 16 and p.blocks == p.tiles * p.cluster
        assert p.cluster in (2, 4, 8) and p.cluster <= p.nchunks
        assert all(r.start // p.nchunks == (r.stop - 1) // p.nchunks
                   for r in runs)
        assert p.counters == 0 and p.scratch_floats(m, n) == 0
    else:
        assert p.counters == (p.tiles if p.blocks > 1 else 0)
        assert p.scratch_floats(m, n) == (
            p.blocks * 2 * p.rows * 128 if p.blocks > 1 else 0)
    # which blocks walk a tile, and in which order their parts are added
    step = max(1, p.tiles // 7)
    for tile in sorted({0, p.tiles - 1, *range(0, p.tiles, step)}):
        blocks = p.tile_blocks(tile)
        want = [b for b, r in enumerate(runs)
                if r.start < (tile + 1) * p.nchunks
                and r.stop > tile * p.nchunks]
        assert list(blocks) == want
        parts = p.tile_parts(tile)
        assert list(itertools.chain(*parts)) == list(range(p.nchunks))
        assert all(len(r) for r in parts)
        if p.cluster > 1:
            assert len(parts) == p.cluster
        # a block leaves at most two partial tiles: its run's first tile
        # and its last one
    partial = [sum(1 for t in {r.start // p.nchunks, (r.stop - 1) // p.nchunks}
                   if len(p.tile_blocks(t)) > 1) for r in runs[:64]]
    assert max(partial) <= 2


@pytest.mark.parametrize("k,group,ldw,nw,dtype,ptr,want", [
    (3072, 512, 3072, 3072, torch.bfloat16, 0, True),
    (3072, 512, 3072, 3072, torch.float32, 0, False),     # f32 x
    (3072, 512, 3072, 3072, torch.bfloat16, 4, False),    # unaligned weights
    (1000, 500, 128, 128, torch.bfloat16, 0, False),      # group % 8
    (1040, 8, 256, 256, torch.bfloat16, 0, True),
    (1028, 2, 256, 256, torch.bfloat16, 0, False),
    (3072, 512, 3080, 3072, torch.bfloat16, 0, False),    # row stride % 16
])
def test_mma_takes(k, group, ldw, nw, dtype, ptr, want):
    assert tmm.mma_takes(I4, k, group, ldw, nw, dtype, ptr) is want


def test_mma_takes_int8_views():
    bf16 = torch.bfloat16
    # a column slice of a wider head at an aligned offset, and at an odd one
    assert tmm.mma_takes(I8, 1000, 0, 1200, 1024, bf16, 176)
    assert not tmm.mma_takes(I8, 1000, 0, 1200, 200, bf16, 7)
    assert not tmm.mma_takes(I8, 3072, 0, 156940, 28940, bf16, 128000)
    # a row slice of the (V, H) embedding
    assert tmm.mma_takes(ROWS, 3072, 0, 3072, 28940, bf16, 128000 * 3072)
    assert not tmm.mma_takes(ROWS, 1004, 0, 1200, 993, bf16, 0)


# -- the order of summation ----------------------------------------------------


def _emulate(fmt, x, w, scale, group, p, out_dtype):
    """What the kernels add up, in their order, in f32: per tile, per part
    (a block's run inside the tile), per chunk the products of the integers
    scaled by the chunk's group scale (K4); the parts added in plan order;
    K2's per-channel scale applied to the sum; one rounding."""
    m, k = x.shape
    xf = x.float()
    if fmt == I4:
        q = tmm.unpack_int4(w).float()           # (K, Np)
        n = scale.shape[1]
    else:
        q = (w.t() if fmt == ROWS else w).float()
        n = q.shape[1]
    half = k // 2
    out = torch.zeros(m, n)
    for ct in range(p.col_tiles):
        cols = slice(ct * 128, min((ct + 1) * 128, n))
        total = None
        for part in p.tile_parts(ct * p.m_tiles):
            acc = torch.zeros(m, cols.stop - cols.start)
            for c in part:
                gi, r0, nrows = tmm.chunk_at(fmt, k, group, p.chunk_rows, c)
                rows = slice(r0, r0 + nrows)
                if fmt == I4:
                    ngh = half // group
                    lo = xf[:, rows] @ q[rows, cols]
                    hi_rows = slice(half + r0, half + r0 + nrows)
                    hi = xf[:, hi_rows] @ q[hi_rows, cols]
                    acc = acc + (scale[gi, cols] * lo
                                 + scale[ngh + gi, cols] * hi)
                else:
                    acc = acc + xf[:, rows] @ q[rows, cols]
            total = acc if total is None else total + acc
        if fmt != I4:
            total = total * scale[cols]
        out[:, cols] = total
    return out.to(out_dtype)


def _tol(want, dtype):
    top = want.float().abs().max().item()
    return 2.0 ** -7 * top if dtype == torch.bfloat16 else 1e-4 * max(1.0, top)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("m,k,n,group,sms", [
    (5, 1024, 384, 128, 8),     # a cluster of blocks per tile
    (3, 512, 200, 512, 132),    # N no multiple of 128 under a padded w_p
    (40, 1024, 384, 128, 3),    # persistent blocks whose runs cross tiles
    (16, 256, 384, 512, 132),
])
def test_int4_summation_order_matches_plain_version(m, k, n, group, sms, dtype):
    rng = np.random.default_rng(7)
    w = rng.standard_normal((k, n), dtype=np.float32) * 0.02
    x = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32)
                         * 0.5).to(dtype)
    ql = tq.quantize_linear_i4(torch.from_numpy(w), group)
    g = k // ql.scale.shape[0]
    mma = tmm.mma_takes(I4, k, g, ql.w_p.shape[1], ql.w_p.shape[1], dtype)
    assert mma == (dtype == torch.bfloat16)
    p = tmm.plan(I4, m, k, n, g, sms, mma)
    got = _emulate(I4, x, ql.w_p, ql.scale, g, p, dtype)
    want = tmm.int4_mm_reference(x, ql.w_p, ql.scale)
    assert got.dtype == want.dtype and got.shape == want.shape == (m, n)
    assert (got.float() - want.float()).abs().max() <= _tol(want, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("rows", [False, True], ids=["in_out", "rows"])
@pytest.mark.parametrize("m,k,n,sms", [(8, 1024, 328, 8), (33, 512, 1000, 2)])
def test_w8_summation_order_matches_plain_version(m, k, n, sms, rows, dtype):
    rng = np.random.default_rng(8)
    w = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8))
    scale = torch.from_numpy(rng.random(n, dtype=np.float32) * 1e-2 + 1e-3)
    x = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32)
                         ).to(dtype)
    fmt = ROWS if rows else I8
    wv = w.t().contiguous() if rows else w
    mma = tmm.mma_takes(fmt, k, 0, wv.stride(0), n, dtype)
    p = tmm.plan(fmt, m, k, n, 0, sms, mma)
    got = _emulate(fmt, x, wv, scale, 0, p, torch.float32)
    want = tmm.w8_mm_reference(x, wv, scale, rows=rows,
                               out_dtype=torch.float32)
    assert (got - want).abs().max() <= _tol(want, torch.float32)
    assert torch.equal(want, tmm.w8_mm(x, wv, scale, rows=rows,
                                       out_dtype=torch.float32))


@pytest.mark.parametrize("m,k,n", [(1, 1024, 512), (16, 256, 384)])
def test_int4_summation_order_matches_jax_kernel(m, k, n):
    """Through the plain version to the JAX kernel in interpret mode, at the
    shapes of the JAX package's own kernel test: 2e-2 relative, its bound."""
    rng = np.random.default_rng(1)
    w = rng.standard_normal((k, n), dtype=np.float32) * 0.02
    ql = jq.quantize_linear_i4(jnp.asarray(w))
    x = jnp.asarray(rng.standard_normal((m, k), dtype=np.float32) * 0.5,
                    jnp.bfloat16)
    tx = W.tensor_from_numpy(np.asarray(x))
    wp = W.tensor_from_numpy(np.asarray(ql.w_p))
    sc = W.tensor_from_numpy(np.asarray(ql.scale))
    g = k // sc.shape[0]
    p = tmm.plan(I4, m, k, n, g, 132, True)
    got = _emulate(I4, tx, wp, sc, g, p, torch.bfloat16).float().numpy()
    kern = np.asarray(jmm.int4_mm(x, ql.w_p, ql.scale, interpret=True),
                      np.float32)
    assert np.abs(got - kern).max() <= 2e-2 * np.abs(kern).max()
