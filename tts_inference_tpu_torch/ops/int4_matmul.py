"""K4 / K2: weight-only quantized matmuls (int4 packed, and its int8 twin).

K4 is the port of ``tts_inference_tpu/ops/pallas/int4_matmul.py``::

    int4_mm(x, w_p, scales)      y = x @ dequant(w_p, scales)

K2 has no TPU kernel (the JAX package's ``models/quant.py`` left the int8
convert to its compiler); it is K4's body with another unpack::

    w8_mm(x, w_i8, scale)               y = (x @ w_i8) * scale, w_i8 (K, N)
    w8_mm(x, w_i8, scale, rows=True)    the same with w_i8 (N, K): the tied
                                        head over a row slice of the (V, H)
                                        int8 embedding, read in place

Both kernels are hand-written CUDA C++ for Hopper (``csrc/quant_matmul.cu``)
and every call is ONE launch. bf16 activations go through the tensor cores
(``qmm_stream``: ``mma.sync`` on the weights as they are stored; a producer
warp hands boxes of the weights and of x to the copy engine (TMA), which
fills a ring of shared-memory stages that eight consumer warps multiply),
f32 activations and what that path refuses (K or a group no multiple of 8, a
row stride or a pointer off 16 bytes) through f32 FMAs on the CUDA cores.
``plan`` below is the work list of a call, a pure function of the shapes and
the SM count: the kernels get its numbers as arguments and repeat its
integer arithmetic, and the CPU tests check it (every unit once, equal runs,
a fixed order of summation). Where several blocks share an output tile, they
are one thread-block cluster whose warps push their partial sums into the
shared memory of the block that owns a slice of the tile, which adds them in
rank order (a decode step), or each leaves its partial tile in a per-device
scratch and the block that arrives last adds them in plan order (prefill,
the tied head): no float atomics, two runs give the same bits.

Beside them ``int4_mm_reference`` and ``w8_mm_reference`` are the plain
PyTorch versions (unpack, dequantize, f32 product). The wrappers take the
plain versions only for tensors on the CPU; a CUDA tensor launches the
kernel or raises. Unlike the JAX package, the kernel also takes the tiny
configuration's shapes (K 64 and 128, groups 32 and 64): there is no switch
to the plain version by shape.

The packed format is the JAX package's, bit for bit — *global split-half*
along K: packed row i holds q[i] in the low nibble, offset-encoded (bits =
q + 8), and q[K/2 + i] in the high nibble, two's complement.

Shapes:
    x:      (..., K)      activations, bf16 or f32
    w_p:    (K//2, Np)    packed int8; Np >= N (the JAX package pads the out
                          dimension to a multiple of 128 in the packed array)
    scales: (K//G, N)     f32 per-(group, out channel); G | K/2
    w_i8:   (K, N) int8, any row stride, or with rows=True (N, K)
    scale:  (N,) f32
    out:    (..., N)      x.dtype, or ``out_dtype`` (f32 logits)
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from tts_inference_tpu_torch.ops import _build
from tts_inference_tpu_torch.ops.decode_attention import H100_SMS, workspace

launches = _build.LaunchCounter()      # K4
launches_w8 = _build.LaunchCounter()   # K2

GROUP = 512          # quantization group along K (G | K/2)

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
FMT_I4, FMT_I8, FMT_I8_ROWS = 0, 1, 2

TILE_COLS = 128      # out columns of a tile
STAGE_ROWS = 64      # weight rows (k) of a unit on the tensor cores
CORE_ROWS = 32       # weight rows of a chunk on the CUDA cores
CORE_M = 8           # rows of x per block on the CUDA cores
CORE_WARPS = 8       # warps of a block, each walking its own chunks

_plans: dict = {}    # launch arguments → Plan


def pick_group(k: int, group: int = GROUP) -> int:
    """Largest usable group <= `group` for a K of `k` (groups must tile each
    packed half: G | K/2)."""
    g = min(group, max(1, k // 2))
    while k // 2 % g:
        g //= 2
    return g


@dataclasses.dataclass(frozen=True)
class Plan:
    """The work list of one call. A tile is `rows` rows of x by TILE_COLS out
    columns; a chunk is `chunk_rows` weight rows (K4: packed rows, i.e. that
    many k of each half of K) inside one scale group; a unit is one chunk of
    one tile. Units are ordered by tile, then chunk; tile = column tile ·
    m_tiles + m tile.

    mma (tensor cores): `blocks` blocks, block b walks units [b·U/B,
    (b+1)·U/B). With `cluster` > 1 that is `cluster` blocks per tile (a
    thread-block cluster, which adds its partial sums up through
    distributed shared memory); with 1 the blocks are persistent, their
    runs cross tiles, and partial tiles meet in a scratch. Otherwise (CUDA
    cores): every tile is cut into `blocks` K splits of `cpb` chunks each,
    one block per split."""
    mma: bool
    rows: int
    chunk_rows: int
    nchunks: int       # chunks per tile
    col_tiles: int
    m_tiles: int
    blocks: int
    cpb: int = 0
    cluster: int = 1

    @property
    def tiles(self) -> int:
        return self.col_tiles * self.m_tiles

    @property
    def units(self) -> int:
        return self.tiles * self.nchunks

    def block_units(self, b: int) -> range:
        """mma: the units block b walks, in order."""
        return range(b * self.units // self.blocks,
                     (b + 1) * self.units // self.blocks)

    def tile_blocks(self, tile: int) -> range:
        """mma: the blocks that walk a part of `tile`, in the order their
        partial tiles are added."""
        first, last = tile * self.nchunks, (tile + 1) * self.nchunks - 1
        return range(((first + 1) * self.blocks - 1) // self.units,
                     ((last + 1) * self.blocks - 1) // self.units + 1)

    def tile_parts(self, tile: int) -> List[range]:
        """The chunks of `tile` by the block that sums them, in the order
        the parts are added up."""
        if not self.mma:
            return [range(s * self.cpb, min((s + 1) * self.cpb, self.nchunks))
                    for s in range(self.blocks)]
        base = tile * self.nchunks
        parts = []
        for b in self.tile_blocks(tile):
            r = self.block_units(b)
            parts.append(range(max(r.start, base) - base,
                               min(r.stop, base + self.nchunks) - base))
        return parts

    def scratch_floats(self, m: int, n: int) -> int:
        """f32 elements of scratch for the partial tiles: two slots per
        persistent block (the tile its run starts in, the tile it ends in),
        or one (m, n) partial per K split."""
        if self.blocks == 1 or self.cluster > 1:
            return 0
        return (self.blocks * 2 * self.rows * TILE_COLS if self.mma
                else self.blocks * m * n)

    @property
    def counters(self) -> int:
        return self.tiles if self.blocks > 1 and self.cluster == 1 else 0


def chunk_at(fmt: int, k: int, group: int, chunk_rows: int,
             c: int) -> Tuple[int, int, int]:
    """(scale group, first weight row, rows) of chunk c of a tile: chunks
    tile each group of the K4 half (or all of K for int8) and never cross
    one."""
    rows_total = k // 2 if fmt == FMT_I4 else k
    grows = group if fmt == FMT_I4 else rows_total
    spg = -(-grows // chunk_rows)
    gi = c // spg
    r0 = gi * grows + (c % spg) * chunk_rows
    return gi, r0, min(chunk_rows, (gi + 1) * grows - r0)


def mma_takes(fmt: int, k: int, group: int, ldw: int, nw: int, x_dtype,
              w_ptr: int = 0) -> bool:
    """Whether the tensor-core kernel takes the call: bf16 x, 16-byte
    requests for weights and x, chunks that start on a multiple of 8 k."""
    if x_dtype != torch.bfloat16 or w_ptr % 16 or ldw % 16 or k % 8:
        return False
    if fmt == FMT_I4 and (group % 8 or (k // 2) % 8):
        return False
    return fmt == FMT_I8_ROWS or nw % 16 == 0


def plan(fmt: int, m: int, k: int, n: int, group: int, sms: int = H100_SMS,
         mma: bool = True) -> Plan:
    """The work list of x (m, k) times weights of format `fmt` to (m, n) on
    a card of `sms` SMs; `mma` as `mma_takes` says."""
    rows_total = k // 2 if fmt == FMT_I4 else k
    grows = group if fmt == FMT_I4 else rows_total
    col_tiles = -(-n // TILE_COLS)
    if mma:
        # up to 16 rows: two blocks share an SM; above: one block of 64 rows
        rows, resident = (16, 2) if m <= 16 else (64, 1)
        nchunks = (rows_total // grows) * -(-grows // STAGE_ROWS)
        m_tiles = -(-m // rows)
        tiles = col_tiles * m_tiles
        # a decode step's few tiles: the largest cluster per tile that the
        # card holds at once (clusters do not pack the SMs to the last
        # block: three quarters of the places is what was seen to fit)
        for cluster in (8, 4, 2):
            if m <= 16 and cluster <= nchunks \
                    and tiles * cluster <= sms * resident * 3 // 4:
                return Plan(True, rows, STAGE_ROWS, nchunks, col_tiles,
                            m_tiles, tiles * cluster, cluster=cluster)
        return Plan(True, rows, STAGE_ROWS, nchunks, col_tiles, m_tiles,
                    min(tiles * nchunks, sms * resident))
    m_tiles = -(-m // CORE_M)
    if fmt == FMT_I8_ROWS:     # a warp owns 8 out channels and all of K
        return Plan(False, CORE_M, k, 1, col_tiles, m_tiles, 1, 1)
    # enough K splits to fill the card, and a multiple of the block's warps
    # in chunks, so that every warp of a block walks the same number
    nchunks = (rows_total // grows) * -(-grows // CORE_ROWS)
    want = -(-2 * sms // (col_tiles * m_tiles))
    want = max(1, min(want, -(-nchunks // CORE_WARPS)))
    cpb = -(-nchunks // want)
    cpb = CORE_WARPS if cpb < CORE_WARPS else cpb // CORE_WARPS * CORE_WARPS
    return Plan(False, CORE_M, CORE_ROWS, nchunks, col_tiles, m_tiles,
                -(-nchunks // cpb), cpb)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """(K, N) integers in [-8, 7] → (K//2, N) int8, global split-half: low
    half of K → offset-encoded low nibbles (bits = q + 8), high half →
    two's-complement high nibbles."""
    k = q.shape[0]
    if k % 2:
        raise ValueError(f"pack_int4: K {k} must be even")
    h = k // 2
    # read as a signed byte, (hi << 4) | (lo + 8) is hi·16 + lo + 8: the high
    # nibble's multiple of 16 leaves the low four bits to the offset value
    return (q[h:].to(torch.int32) * 16 + q[:h].to(torch.int32) + 8).to(
        torch.int8)


def unpack_int4(w_p: torch.Tensor) -> torch.Tensor:
    """(K//2, N) int8 → (K, N) int32 in [-8, 7] (inverse of pack_int4)."""
    p = w_p.to(torch.int32)
    hi = p >> 4                         # arithmetic: the signed high nibble
    lo = (p - (hi << 4)) - 8            # the unsigned low bits, offset-decoded
    return torch.cat([lo, hi], dim=0)


def int4_mm_reference(x: torch.Tensor, w_p: torch.Tensor,
                      scales: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K4: unpack, dequantize, matmul, all in f32;
    the result is rounded once to x.dtype."""
    k = x.shape[-1]
    n = scales.shape[1]
    group = k // scales.shape[0]
    q = unpack_int4(w_p)[:, :n].float()
    w = (q.reshape(k // group, group, n)
         * scales.float()[:, None, :]).reshape(k, n)
    out = x.float().reshape(-1, k) @ w
    return out.to(x.dtype).reshape(*x.shape[:-1], n)


def w8_mm_reference(x: torch.Tensor, w_i8: torch.Tensor, scale: torch.Tensor,
                    *, rows: bool = False,
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain PyTorch version of K2: f32 product of x and the integers, scaled
    once per out channel, rounded once to `out_dtype` (default x.dtype)."""
    w = w_i8.float()
    if rows:
        w = w.t()
    k, n = w.shape
    out = (x.float().reshape(-1, k) @ w) * scale.float()
    return out.to(out_dtype or x.dtype).reshape(*x.shape[:-1], n)


def _check_x(name: str, x: torch.Tensor, out_dtype) -> None:
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: x is {x.dtype}; the kernel takes bf16 or "
                        "f32")
    if out_dtype not in _DTYPES:
        raise TypeError(f"{name}: out dtype {out_dtype}; the kernel writes "
                        "bf16 or f32")
    if x.dim() < 1 or x.numel() == 0:
        raise ValueError(f"{name}: x {tuple(x.shape)} is empty")


def _launch(name, counter, fmt, x, w, scale, n, nw, ldw, group, out_dtype):
    """Launch the kernel of format `fmt` over x flattened to (M, K)."""
    k = x.shape[-1]
    x2 = x.reshape(-1, k)
    if not x2.is_contiguous():
        x2 = x2.contiguous()
    m = x2.shape[0]
    if x2.data_ptr() % 16 or scale.data_ptr() % 4:
        raise ValueError(f"{name}: x must be 16-byte aligned")
    if {x.device, w.device, scale.device} != {x.device} \
            or x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for tensors on {x.device}, "
                         f"{w.device}, {scale.device}")
    lib = _build.load()
    ws = workspace(x.device)
    # the plan depends on the shape, the types and the weights' alignment
    key = (w.data_ptr() % 16, fmt, m, k, n, ldw, nw, group, x.dtype)
    p = _plans.get(key)
    if p is None:
        p = _plans[key] = plan(
            fmt, m, k, n, group, ws.sms,
            mma_takes(fmt, k, group, ldw, nw, x.dtype, w.data_ptr()))
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    # where blocks share a tile: their partial tiles and the tile's counter
    counters, scratch = ws.reserve(p.counters, p.scratch_floats(m, n))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.tts_quant_matmul(
        x2.data_ptr(), w.data_ptr(), scale.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), counters.data_ptr(), fmt, m, k, n, ldw, nw,
        group, _DTYPES[x.dtype], _DTYPES[out_dtype], int(p.mma),
        p.rows if p.mma else p.blocks, p.blocks if p.mma else p.cpb,
        p.cluster, stream)
    _build.check(err, name)
    counter.add()
    return out.reshape(*x.shape[:-1], n)


def int4_mm(x: torch.Tensor, w_p: torch.Tensor,
            scales: torch.Tensor) -> torch.Tensor:
    """K4: x (..., K) @ int4-packed weights (K//2, Np) → (..., N) in x.dtype;
    kernel on CUDA, plain version on the CPU. The group is K //
    scales.shape[0]; columns of w_p past N = scales.shape[1] are padding and
    are never written to the output."""
    k = x.shape[-1]
    _check_x("int4_mm", x, x.dtype)
    if w_p.dim() != 2 or w_p.dtype != torch.int8 or k % 2 \
            or w_p.shape[0] * 2 != k:
        raise ValueError(f"int4_mm: x (..., {k}) vs packed weights "
                         f"{tuple(w_p.shape)} {w_p.dtype}; expected "
                         f"({k // 2}, Np) int8")
    if scales.dim() != 2 or scales.dtype != torch.float32 \
            or scales.shape[0] < 1 or k % scales.shape[0]:
        raise ValueError(f"int4_mm: scales {tuple(scales.shape)} "
                         f"{scales.dtype}; expected (K/G, N) f32")
    n = scales.shape[1]
    group = k // scales.shape[0]
    if (k // 2) % group or not 1 <= n <= w_p.shape[1]:
        raise ValueError(f"int4_mm: group {group} must divide K/2 = {k // 2} "
                         f"and N {n} must fit the packed width "
                         f"{w_p.shape[1]}")
    if not (w_p.is_contiguous() and scales.is_contiguous()):
        raise ValueError("int4_mm: w_p and scales must be contiguous")
    if x.device.type == "cpu":
        return int4_mm_reference(x, w_p, scales)
    return _launch("int4_mm", launches, FMT_I4, x, w_p, scales, n,
                   w_p.shape[1], w_p.shape[1], group, x.dtype)


def w8_mm(x: torch.Tensor, w_i8: torch.Tensor, scale: torch.Tensor, *,
          rows: bool = False,
          out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """K2: (x (..., K) @ int8 weights) * scale → (..., N) in `out_dtype`
    (default x.dtype); kernel on CUDA, plain version on the CPU. w_i8 is
    (K, N), or (N, K) with rows=True; either may be a view with a larger row
    stride (a column or row slice), which is read in place."""
    k = x.shape[-1]
    out_dtype = out_dtype or x.dtype
    _check_x("w8_mm", x, out_dtype)
    if w_i8.dim() != 2 or w_i8.dtype != torch.int8 or w_i8.stride(1) != 1 \
            or w_i8.shape[1 if rows else 0] != k:
        raise ValueError(f"w8_mm: x (..., {k}) vs int8 weights "
                         f"{tuple(w_i8.shape)} {w_i8.dtype} strides "
                         f"{w_i8.stride()} (rows={rows})")
    n = w_i8.shape[0 if rows else 1]
    if scale.shape != (n,) or scale.dtype != torch.float32 \
            or not scale.is_contiguous() or n < 1:
        raise ValueError(f"w8_mm: scale {tuple(scale.shape)} {scale.dtype}; "
                         f"expected ({n},) f32")
    if rows and (k % 4 or w_i8.stride(0) % 4):
        raise ValueError(f"w8_mm: rows=True needs K {k} and the row stride "
                         f"{w_i8.stride(0)} to be multiples of 4")
    if x.device.type == "cpu":
        return w8_mm_reference(x, w_i8, scale, rows=rows,
                               out_dtype=out_dtype)
    if rows and w_i8.data_ptr() % 4:
        raise ValueError("w8_mm: rows=True needs 4-byte aligned weights")
    return _launch("w8_mm", launches_w8, FMT_I8_ROWS if rows else FMT_I8,
                   x, w_i8, scale, n, n, w_i8.stride(0), 0, out_dtype)
