// K4 / K2: weight-only quantized matmuls for Hopper (sm_90a).
//
//   K4  y = x @ dequant(w_p, scales)   int4 weights, two per byte, f32
//                                      per-(group, out channel) scales
//   K2  y = (x @ w_i8) * scale         int8 weights, f32 per-out-channel scale
//
// K4 replaces tts_inference_tpu/ops/pallas/int4_matmul.py::int4_mm (Pallas
// body `_kernel`, launched by `_pallas_int4_mm`). K2 has no TPU kernel: the
// JAX package left the int8 convert to the compiler (models/quant.py::mm,
// tied_logits, head_logits). Here it is K4's body with another unpack, so a
// dequantized copy of the weights is never written.
//
// The packed int4 format is the JAX package's, bit for bit: packed row i of
// w_p (K/2, Np) holds q[i] in the low nibble, offset-encoded (bits = q + 8),
// and q[K/2 + i] in the high nibble, two's complement. Groups of G rows tile
// each half of K; scales (K/G, N). The TPU kernel fed the packed byte to its
// matrix unit as it was and corrected for that afterwards; on this card a
// nibble is two integer operations in a register, so both are extracted.
//
// What bounds it on the H100: at a decode step (M <= 16) the weight bytes,
// read once (K·N/2 for K4, K·N for K2) at 2·M FLOPs per weight, far below
// the ~295 FLOP/byte ridge — but 2·8 f32 FMAs per weight on the CUDA cores
// already take longer than the bytes, so bf16 activations go through the
// tensor cores; at prefill (M in the hundreds or thousands) the operations.
//
// Design, (K rows, N columns) weights, bf16 x — `qmm_kn_mma`, mma.sync
// m16n8k16 with f32 accumulators (integers up to 127 are exact in bf16):
//  - x is the A operand (16 rows: a decode step's 8 slots fill half), the
//    weights the B operand. An mma sums over k and nothing orders its k
//    slots or its n slots, so both are permuted to fit coalesced loads of
//    the format as it is stored: lane (g, t) reads, for each of four weight
//    rows 4t..4t+3 of a 16-row k-tile, the 4-byte word at columns 4g..4g+3
//    (the warp reads 16 rows × 32 columns, whole 32-byte sectors). Byte j of
//    those words is the lane's B fragment of n-tile j: k slots 2t, 2t+1,
//    2t+8, 2t+9 stand for rows 4t..4t+3 and n slot g for column 4g + j. x
//    follows the same k permutation, which makes its fragment 4 consecutive
//    bf16 of a row: one 8-byte load;
//  - a nibble becomes bf16 without a convert: its 4 bits OR-ed into the
//    mantissa of 128.0 (0x4300) give 128 + bits exactly, and one bf16x2
//    subtract of 136 leaves q (the low nibble stores q + 8; the high one is
//    two's complement, so bits ^ 8 = q + 8). int8 weights take the convert;
//  - a warp walks chunks of 64 weight rows that never cross a scale group,
//    scales the chunk's two accumulator sets (low and high half of K) once
//    and adds them to its tile in shared memory; 4 column groups × 2 warps
//    along K make a block of 128 columns; K splits, partial tiles and the
//    second pass are those of the CUDA-core path below.
//
// Design, (K rows, N columns) weights, f32 x or shapes the tensor-core path
// refuses (a group or K that is no multiple of 4, unaligned weights) —
// `qmm_kn`, f32 FMAs on the CUDA cores:
//  - a block owns 128 output columns, 8 rows of x and a range of K; a warp
//    walks that range in chunks of 32 weight rows; each lane owns 4 adjacent
//    columns, so one weight row is one coalesced 128-byte read of the warp,
//    and 16 rows are requested before the first is used;
//  - the chunk's x values sit in shared memory as [k][8 rows], so a lane
//    fetches the 8 rows of one k with two 16-byte broadcast reads;
//  - a chunk never crosses a scale group: its integer partial sums (f32
//    accumulators; the integers enter exactly) are scaled once and added to
//    the warp's accumulator tile in shared memory; the warps' tiles are
//    summed at the end;
//  - K is split over blocks until the grid fills the card; the splits'
//    partial tiles go to an f32 scratch and a second pass sums them in a
//    fixed order (no atomics: the result does not change from run to run).
//    K2's scale is applied once per out channel, after that sum;
//  - M > 8 adds grid rows of 8; the weights are then re-read from L2.
// Design, (N rows, K columns) weights — the tied head over a row slice of the
// (V, H) int8 embedding, read in place: a warp owns 8 out channels, its lanes
// stride over K with 4-byte loads (a 128-byte read per channel), x comes from
// L1, and the 64 sums are reduced over the lanes once at the end.
// wgmma, TMA, larger M tiles for prefill and a fused reduce are later work.
//
// Layouts (elements): x (M, K) contiguous, bf16 or f32; out (M, N) contiguous,
// bf16 or f32; weights int8 with row stride ldw; partial (nsplit, M, N) f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMT = 8;            // rows of x per block
constexpr int kCols = 4;          // out columns per lane: one 32-bit load
constexpr int kBN = 32 * kCols;   // out columns per block
constexpr int kR = 32;            // weight rows per chunk: one x row per lane
constexpr int kFlight = 16;       // weight rows requested before use
constexpr int kRowsNK = 8;        // out channels per warp, (N, K) weights
constexpr int kTargetBlocks = 2 * 132;
// the tensor-core path
constexpr int kMTm = 16;                  // rows of x per block: one mma M
constexpr int kRm = 64;                   // weight rows per chunk: 4 k-tiles
constexpr int kLanes = 2;                 // warps of a block along K
constexpr int kGroups = kWarps / kLanes;  // column groups of 32 per block
constexpr int kPad = 33;                  // row stride of a warp's tile

enum Fmt { kI4 = 0, kI8 = 1, kI8Rows = 2 };

struct Args {
  const void* x;
  const int8_t* w;
  const float* scale;
  void* out;
  float* partial;
  int m, k, n;
  long long ldw;   // bytes between weight rows
  int nw;          // weight columns that may be read (>= n)
  int group;       // K4: rows of K per scale group
  int x_f32, out_f32;
  int nsplit, cpb; // K splits, chunks per split
};

// Whether the tensor-core path takes the call: bf16 x, whole 4-byte weight
// words, chunks and x fragments that start on multiples of 4.
inline bool mma_ok(int fmt, int k, int group, long long ldw, int nw, const void* w,
                   int x_dtype) {
  if (x_dtype != 0 || (fmt != kI4 && fmt != kI8)) return false;
  if (k % 4 || ldw % 4 || nw % 4 || reinterpret_cast<uintptr_t>(w) % 4) return false;
  return fmt != kI4 || (group % 4 == 0 && (k / 2) % 4 == 0);
}

__device__ inline float load_x(const void* x, int f32, size_t i) {
  return f32 ? static_cast<const float*>(x)[i]
             : __bfloat162float(static_cast<const __nv_bfloat16*>(x)[i]);
}

__device__ inline void store_out(void* out, int f32, size_t i, float v) {
  if (f32)
    static_cast<float*>(out)[i] = v;
  else
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16(v);
}

// the 4 weight bytes of one row at a lane's columns, little-endian in a word;
// columns past the weight's width read as 0
__device__ inline uint32_t load_w4(const int8_t* p, bool vec, int col0, int nw) {
  if (vec) return *reinterpret_cast<const uint32_t*>(p);
  uint32_t r = 0;
#pragma unroll
  for (int c = 0; c < kCols; ++c)
    if (col0 + c < nw) r |= static_cast<uint32_t>(static_cast<uint8_t>(p[c])) << (8 * c);
  return r;
}

inline int chunks_of(int fmt, int k, int group, int chunk_rows) {
  const int rows = fmt == kI4 ? k / 2 : k;
  const int grows = fmt == kI4 ? group : rows;
  return (rows / grows) * ((grows + chunk_rows - 1) / chunk_rows);
}

// The K splits of a launch, and through `cpb` the chunks each split's block
// walks: enough splits to fill the card, and a multiple of the block's warps
// along K, so that every warp of a block walks the same number of chunks.
inline int pick_splits(int fmt, bool mma, int m, int k, int n, int group,
                       int* cpb_out = nullptr) {
  if (fmt == kI8Rows) return 1;
  const int lanes = mma ? kLanes : kWarps;
  const int mt = mma ? kMTm : kMT;
  const int nchunks = chunks_of(fmt, k, group, mma ? kRm : kR);
  const int tiles = ((n + kBN - 1) / kBN) * ((m + mt - 1) / mt);
  int want = (kTargetBlocks + tiles - 1) / tiles;
  const int most = (nchunks + lanes - 1) / lanes;
  if (want > most) want = most;
  if (want < 1) want = 1;
  int cpb = (nchunks + want - 1) / want;
  cpb = cpb < lanes ? lanes : cpb / lanes * lanes;
  if (cpb_out != nullptr) *cpb_out = cpb;
  return (nchunks + cpb - 1) / cpb;
}

__device__ inline void mma_bf16(float c[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Byte J of the weight words of two consecutive rows → one B register: the
// two weights as bf16, row w0's in the low half. F == kI4 takes nibble H of
// the bytes (0: low, offset-encoded; 1: high, two's complement).
template <int F, int J, int H>
__device__ inline uint32_t weights_bf16x2(uint32_t w0, uint32_t w1) {
  if constexpr (F == kI4) {
    // bytes (w0[J], w0[J], w1[J], w1[J]); bytes 1 and 3 are masked off
    const uint32_t r = __byte_perm(w0, w1, J | (J << 4) | ((4 + J) << 8) | ((4 + J) << 12));
    // 128 + (q + 8) as bf16: the nibble in the mantissa of 128.0
    const uint32_t v = H == 0 ? (r & 0x000F000Fu) | 0x43004300u
                              : ((r >> 4) & 0x000F000Fu) ^ 0x43084308u;
    const uint32_t k136 = 0x43084308u;
    const __nv_bfloat162 q = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
                                     *reinterpret_cast<const __nv_bfloat162*>(&k136));
    return *reinterpret_cast<const uint32_t*>(&q);
  } else {
    const float lo = static_cast<float>(static_cast<int>(w0 << (24 - 8 * J)) >> 24);
    const float hi = static_cast<float>(static_cast<int>(w1 << (24 - 8 * J)) >> 24);
    const __nv_bfloat162 q = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&q);
  }
}

// The four n-tiles of one k-tile and one half of K: c[j] += x · weights.
template <int F, int H>
__device__ inline void mma_ktile(float c[4][4], const uint32_t wv[4], uint32_t a0,
                                 uint32_t a1, uint32_t a2, uint32_t a3) {
  mma_bf16(c[0], a0, a1, a2, a3, weights_bf16x2<F, 0, H>(wv[0], wv[1]),
           weights_bf16x2<F, 0, H>(wv[2], wv[3]));
  mma_bf16(c[1], a0, a1, a2, a3, weights_bf16x2<F, 1, H>(wv[0], wv[1]),
           weights_bf16x2<F, 1, H>(wv[2], wv[3]));
  mma_bf16(c[2], a0, a1, a2, a3, weights_bf16x2<F, 2, H>(wv[0], wv[1]),
           weights_bf16x2<F, 2, H>(wv[2], wv[3]));
  mma_bf16(c[3], a0, a1, a2, a3, weights_bf16x2<F, 3, H>(wv[0], wv[1]),
           weights_bf16x2<F, 3, H>(wv[2], wv[3]));
}

// Where chunk c of the tensor-core path lies: its scale group, first weight
// row and row count (a multiple of 4).
struct Chunk {
  int gi, r0, nrows;
};

__device__ inline Chunk chunk_at(int c, int spg, int grows) {
  const int gi = c / spg;
  const int r0 = gi * grows + (c % spg) * kRm;
  return {gi, r0, min(kRm, (gi + 1) * grows - r0)};
}

// Request every weight word of a chunk: lane (g, t) takes rows 4t..4t+3 of
// each 16-row k-tile at its 4 columns. Rows past the chunk read as 0; x is 0
// there.
__device__ inline void load_chunk(const Args& a, const Chunk& ch, int t, int colw,
                                  bool colok, uint32_t wv[kRm / 16][4]) {
#pragma unroll
  for (int kt = 0; kt < kRm / 16; ++kt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = kt * 16 + 4 * t + i;
      wv[kt][i] = colok && r < ch.nrows
                      ? *reinterpret_cast<const uint32_t*>(
                            a.w + static_cast<size_t>(ch.r0 + r) * a.ldw + colw)
                      : 0u;
    }
}

// (K rows, N columns) weights, bf16 x, on the tensor cores.
template <int F>
__global__ void __launch_bounds__(kThreads) qmm_kn_mma(const Args a) {
  constexpr int kHalves = F == kI4 ? 2 : 1;
  __shared__ float acc_all[kWarps][kMTm][kPad];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;          // mma row of A and C, n slot of B
  const int t = lane & 3;           // mma k-slot pair
  const int cg = warp % kGroups;    // column group of 32
  const int kl = warp / kGroups;    // lane along K
  const int col_g = blockIdx.x * kBN + cg * 32;  // the warp's first column
  const int colw = col_g + 4 * g;                // this lane's weight word
  const int m0 = blockIdx.z * kMTm;
  const int rows_total = F == kI4 ? a.k / 2 : a.k;
  const int grows = F == kI4 ? a.group : rows_total;
  const int spg = (grows + kRm - 1) / kRm;       // chunks per group
  const int nchunks = (rows_total / grows) * spg;
  const int c_begin = blockIdx.y * a.cpb;
  const int c_end = min(c_begin + a.cpb, nchunks);
  const bool colok = colw + 4 <= a.nw;           // nw % 4 == 0: wholly in or out
  const bool row_lo = m0 + g < a.m;
  const bool row_hi = m0 + g + 8 < a.m;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);
  const __nv_bfloat16* x_lo = x + static_cast<size_t>(m0 + g) * a.k;
  const __nv_bfloat16* x_hi = x + static_cast<size_t>(m0 + g + 8) * a.k;
  float(*acc)[kPad] = acc_all[warp];

  for (int i = lane; i < kMTm * kPad; i += 32) (&acc[0][0])[i] = 0.f;
  __syncwarp();

  for (int c = c_begin + kl; c < c_end; c += kLanes) {
    const Chunk ch = chunk_at(c, spg, grows);
    const int gi = ch.gi, r0 = ch.r0, nrows = ch.nrows;
    // every weight word of the chunk is requested before the first is used
    // (requesting the next chunk's too was measured slower: the registers
    // it takes cost more occupancy than the overlap gains)
    uint32_t wv[kRm / 16][4];
    load_chunk(a, ch, t, colw, colok, wv);
    float clo[4][4], chi[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) clo[j][i] = chi[j][i] = 0.f;

#pragma unroll
    for (int kt = 0; kt < kRm / 16; ++kt) {
      const int kk = r0 + kt * 16 + 4 * t;     // this lane's 4 consecutive k
      const bool kin = kt * 16 + 4 * t < nrows;
#pragma unroll
      for (int h = 0; h < kHalves; ++h) {
        const size_t at = static_cast<size_t>(h) * rows_total + kk;
        uint2 xa = make_uint2(0u, 0u), xb = make_uint2(0u, 0u);
        if (kin && row_lo) xa = __ldg(reinterpret_cast<const uint2*>(x_lo + at));
        if (kin && row_hi) xb = __ldg(reinterpret_cast<const uint2*>(x_hi + at));
        if (h == 0)
          mma_ktile<F, 0>(clo, wv[kt], xa.x, xb.x, xa.y, xb.y);
        else
          mma_ktile<F, 1>(chi, wv[kt], xa.x, xb.x, xa.y, xb.y);
      }
    }

    // scale the chunk's partial sums (K4) and add them to the warp's tile:
    // C register pair (0, 1) is row g, (2, 3) row g + 8; n slots 2t, 2t + 1
    // of n-tile j are columns 8t + j and 8t + 4 + j of the warp's 32
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cc = 8 * t + 4 * e + j;
        float slo = 1.f, shi = 0.f;
        if constexpr (F == kI4) {
          const int col = col_g + cc;
          const int ngh = rows_total / grows;  // groups per half of K
          slo = col < a.n ? a.scale[static_cast<size_t>(gi) * a.n + col] : 0.f;
          shi = col < a.n ? a.scale[static_cast<size_t>(ngh + gi) * a.n + col] : 0.f;
        }
        acc[g][cc] += slo * clo[j][e] + shi * chi[j][e];
        acc[g + 8][cc] += slo * clo[j][2 + e] + shi * chi[j][2 + e];
      }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < kMTm * kBN; i += kThreads) {
    const int row = i / kBN;
    const int cb = i % kBN;
    const int mrow = m0 + row;
    const int col = blockIdx.x * kBN + cb;
    if (mrow >= a.m || col >= a.n) continue;
    float s = 0.f;
#pragma unroll
    for (int l = 0; l < kLanes; ++l) s += acc_all[l * kGroups + cb / 32][row][cb % 32];
    if (a.nsplit == 1) {
      if constexpr (F == kI8) s *= a.scale[col];
      store_out(a.out, a.out_f32, static_cast<size_t>(mrow) * a.n + col, s);
    } else {
      a.partial[(static_cast<size_t>(blockIdx.y) * a.m + mrow) * a.n + col] = s;
    }
  }
}

// (K rows, N columns) weights on the CUDA cores: K4 (F == kI4) and the
// (in, out) K2 (F == kI8), for f32 x and what the tensor-core path refuses.
template <int F>
__global__ void __launch_bounds__(kThreads) qmm_kn(const Args a) {
  constexpr int kHalves = F == kI4 ? 2 : 1;
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* xs = smem + warp * (kHalves * kR * kMT);  // [half][row][m]
  float* acc_all = smem + kWarps * kHalves * kR * kMT;
  float* acc_s = acc_all + warp * (kMT * kBN);     // [m][column]

  const int col0 = blockIdx.x * kBN + lane * kCols;
  const int m0 = blockIdx.z * kMT;
  const int rows_total = F == kI4 ? a.k / 2 : a.k;
  const int grows = F == kI4 ? a.group : rows_total;
  const int spg = (grows + kR - 1) / kR;           // chunks per group
  const int nchunks = (rows_total / grows) * spg;
  const int c_begin = blockIdx.y * a.cpb;
  const int c_end = min(c_begin + a.cpb, nchunks);
  const bool vec = col0 + kCols <= a.nw && (a.ldw & 3) == 0 &&
                   ((reinterpret_cast<uintptr_t>(a.w) + col0) & 3) == 0;

  for (int i = lane; i < kMT * kBN; i += 32) acc_s[i] = 0.f;

  for (int c = c_begin + warp; c < c_end; c += kWarps) {
    const int g = c / spg;
    const int r0 = g * grows + (c % spg) * kR;
    const int nrows = min(kR, (g + 1) * grows - r0);
    // the first weight rows are requested before x is staged
    const int8_t* wr = a.w + static_cast<size_t>(r0) * a.ldw + col0;
    uint32_t wv[kFlight];
#pragma unroll
    for (int i = 0; i < kFlight; ++i)
      wv[i] = i < nrows ? load_w4(wr + static_cast<size_t>(i) * a.ldw, vec, col0, a.nw)
                        : 0u;  // x is 0 there
    __syncwarp();
    // this chunk's x: lane r holds weight row r0 + r (and K/2 + r0 + r)
#pragma unroll
    for (int h = 0; h < kHalves; ++h) {
      const size_t kk = static_cast<size_t>(h) * rows_total + r0 + lane;
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi) {
        float v = 0.f;
        if (lane < nrows && m0 + mi < a.m)
          v = load_x(a.x, a.x_f32, static_cast<size_t>(m0 + mi) * a.k + kk);
        xs[(h * kR + lane) * kMT + mi] = v;
      }
    }
    __syncwarp();

    float pl[kMT][kCols], ph[kMT][kCols];
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) pl[mi][cc] = ph[mi][cc] = 0.f;

#pragma unroll 1
    for (int rb = 0; rb < kR; rb += kFlight) {
      if (rb > 0) {
#pragma unroll
        for (int i = 0; i < kFlight; ++i)
          wv[i] = rb + i < nrows
                      ? load_w4(wr + static_cast<size_t>(rb + i) * a.ldw, vec, col0, a.nw)
                      : 0u;
      }
#pragma unroll
      for (int i = 0; i < kFlight; ++i) {
        const float4* xl = reinterpret_cast<const float4*>(xs + (rb + i) * kMT);
        const float4 l0 = xl[0], l1 = xl[1];
        const float xlo[kMT] = {l0.x, l0.y, l0.z, l0.w, l1.x, l1.y, l1.z, l1.w};
        float xhi[kMT];
        if constexpr (F == kI4) {
          const float4* xh = reinterpret_cast<const float4*>(xs + (kR + rb + i) * kMT);
          const float4 h0 = xh[0], h1 = xh[1];
          xhi[0] = h0.x; xhi[1] = h0.y; xhi[2] = h0.z; xhi[3] = h0.w;
          xhi[4] = h1.x; xhi[5] = h1.y; xhi[6] = h1.z; xhi[7] = h1.w;
        }
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc) {
          // the signed byte of column cc
          const int b = static_cast<int>(wv[i] << (24 - 8 * cc)) >> 24;
          if constexpr (F == kI4) {
            const float lo = static_cast<float>((b & 15) - 8);  // offset-encoded
            const float hi = static_cast<float>(b >> 4);        // arithmetic shift
#pragma unroll
            for (int mi = 0; mi < kMT; ++mi) {
              pl[mi][cc] += xlo[mi] * lo;
              ph[mi][cc] += xhi[mi] * hi;
            }
          } else {
            const float q = static_cast<float>(b);
#pragma unroll
            for (int mi = 0; mi < kMT; ++mi) pl[mi][cc] += xlo[mi] * q;
          }
        }
      }
    }

    // scale the chunk's partial sums (K4) and add them to the warp's tile
    float slo[kCols], shi[kCols];
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) {
      slo[cc] = 1.f;
      shi[cc] = 0.f;
      if constexpr (F == kI4) {
        const int col = col0 + cc;
        const int ngh = rows_total / grows;  // groups per half of K
        slo[cc] = col < a.n ? a.scale[static_cast<size_t>(g) * a.n + col] : 0.f;
        shi[cc] = col < a.n ? a.scale[static_cast<size_t>(ngh + g) * a.n + col] : 0.f;
      }
    }
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi) {
      float4* t = reinterpret_cast<float4*>(acc_s + mi * kBN + lane * kCols);
      float4 v = *t;
      if constexpr (F == kI4) {
        v.x += slo[0] * pl[mi][0] + shi[0] * ph[mi][0];
        v.y += slo[1] * pl[mi][1] + shi[1] * ph[mi][1];
        v.z += slo[2] * pl[mi][2] + shi[2] * ph[mi][2];
        v.w += slo[3] * pl[mi][3] + shi[3] * ph[mi][3];
      } else {
        v.x += pl[mi][0];
        v.y += pl[mi][1];
        v.z += pl[mi][2];
        v.w += pl[mi][3];
      }
      *t = v;
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < kMT * kBN; i += kThreads) {
    const int mrow = m0 + i / kBN;
    const int col = blockIdx.x * kBN + i % kBN;
    if (mrow >= a.m || col >= a.n) continue;
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) s += acc_all[wi * kMT * kBN + i];
    if (a.nsplit == 1) {
      if constexpr (F == kI8) s *= a.scale[col];
      store_out(a.out, a.out_f32, static_cast<size_t>(mrow) * a.n + col, s);
    } else {
      a.partial[(static_cast<size_t>(blockIdx.y) * a.m + mrow) * a.n + col] = s;
    }
  }
}

// Sum the K splits' partial tiles in order; K2 applies its scale here.
__global__ void __launch_bounds__(kThreads)
qmm_reduce(const float* __restrict__ partial, const float* __restrict__ scale, void* out,
           int out_f32, int m, int n, int nsplit) {
  const size_t total = static_cast<size_t>(m) * n;
  const size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  for (int sp = 0; sp < nsplit; ++sp) s += partial[sp * total + i];
  if (scale != nullptr) s *= scale[i % n];
  store_out(out, out_f32, i, s);
}

__device__ inline float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// (N rows, K columns) int8 weights (the tied head); K % 4 == 0.
__global__ void __launch_bounds__(kThreads) qmm_rows(const Args a) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n0 = (blockIdx.x * kWarps + warp) * kRowsNK;
  const int m0 = blockIdx.y * kMT;
  if (n0 >= a.n) return;
  float acc[kRowsNK][kMT];
#pragma unroll
  for (int r = 0; r < kRowsNK; ++r)
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi) acc[r][mi] = 0.f;

  for (int k0 = lane * 4; k0 < a.k; k0 += 128) {
    uint32_t wv[kRowsNK];
#pragma unroll
    for (int r = 0; r < kRowsNK; ++r)
      wv[r] = n0 + r < a.n ? *reinterpret_cast<const uint32_t*>(
                                 a.w + static_cast<size_t>(n0 + r) * a.ldw + k0)
                           : 0u;
    float xv[kMT][4];
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi) {
      const size_t at = static_cast<size_t>(m0 + mi) * a.k + k0;
      if (m0 + mi >= a.m) {
        xv[mi][0] = xv[mi][1] = xv[mi][2] = xv[mi][3] = 0.f;
      } else if (a.x_f32) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(a.x) + at));
        xv[mi][0] = v.x; xv[mi][1] = v.y; xv[mi][2] = v.z; xv[mi][3] = v.w;
      } else {
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(
            static_cast<const __nv_bfloat16*>(a.x) + at));
        const float2 p0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
        const float2 p1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
        xv[mi][0] = p0.x; xv[mi][1] = p0.y; xv[mi][2] = p1.x; xv[mi][3] = p1.y;
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsNK; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float q = static_cast<float>(static_cast<int>(wv[r] << (24 - 8 * j)) >> 24);
#pragma unroll
        for (int mi = 0; mi < kMT; ++mi) acc[r][mi] += xv[mi][j] * q;
      }
  }
#pragma unroll
  for (int r = 0; r < kRowsNK; ++r)
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi) {
      const float s = warp_sum(acc[r][mi]);
      // value r·8 + mi is written by lane (r·8 + mi) % 32
      if (((r * kMT + mi) & 31) == lane && n0 + r < a.n && m0 + mi < a.m)
        store_out(a.out, a.out_f32, static_cast<size_t>(m0 + mi) * a.n + n0 + r,
                  s * a.scale[n0 + r]);
    }
}

template <int F>
int launch_kn(const Args& a, bool mma, cudaStream_t s) {
  if (mma) {
    const dim3 grid((a.n + kBN - 1) / kBN, a.nsplit, (a.m + kMTm - 1) / kMTm);
    qmm_kn_mma<F><<<grid, kThreads, 0, s>>>(a);
  } else {
    constexpr int kHalves = F == kI4 ? 2 : 1;
    const size_t smem =
        static_cast<size_t>(kWarps) * (kHalves * kR * kMT + kMT * kBN) * sizeof(float);
    static bool configured = false;
    if (!configured) {
      const cudaError_t e = cudaFuncSetAttribute(
          qmm_kn<F>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
      configured = true;
    }
    const dim3 grid((a.n + kBN - 1) / kBN, a.nsplit, (a.m + kMT - 1) / kMT);
    qmm_kn<F><<<grid, kThreads, smem, s>>>(a);
  }
  if (a.nsplit > 1) {
    const size_t total = static_cast<size_t>(a.m) * a.n;
    qmm_reduce<<<static_cast<unsigned>((total + kThreads - 1) / kThreads), kThreads, 0, s>>>(
        a.partial, F == kI8 ? a.scale : nullptr, a.out, a.out_f32, a.m, a.n, a.nsplit);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K splits the launch with these arguments will use; the caller sizes
// `partial` (nsplit, M, N) f32 from it (none for 1). fmt: 0 = K4, 1 = K2
// (in, out), 2 = K2 (out, in) rows. 0 for shapes the kernels do not take.
extern "C" int tts_quant_matmul_splits(const void* w, int fmt, int m, int k, int n,
                                       long long ldw, int nw, int group, int x_dtype) {
  if (m < 1 || k < 2 || n < 1 || (fmt == kI4 && (group < 1 || (k / 2) % group))) return 0;
  return pick_splits(fmt, mma_ok(fmt, k, group, ldw, nw, w, x_dtype), m, k, n, group);
}

// x (M, K) · weights → out (M, N). fmt as above; ldw = bytes between weight
// rows; nw = weight columns that may be read (K4: Np; K2: n); group = K4's
// scale group; x_dtype / out_dtype: 0 = bfloat16, 1 = float32. Returns the
// launches' cudaError_t.
extern "C" int tts_quant_matmul(const void* x, const void* w, const void* scale, void* out,
                                void* partial, int fmt, int m, int k, int n, long long ldw,
                                int nw, int group, int x_dtype, int out_dtype,
                                void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (m < 1 || k < 2 || n < 1 || nw < n || x_dtype < 0 || x_dtype > 1 || out_dtype < 0 ||
      out_dtype > 1)
    return bad;
  Args a{x, static_cast<const int8_t*>(w), static_cast<const float*>(scale), out,
         static_cast<float*>(partial), m, k, n, ldw, nw, group, x_dtype, out_dtype, 1, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fmt == kI8Rows) {
    if (k % 4 || ldw % 4 || reinterpret_cast<uintptr_t>(w) % 4 ||
        reinterpret_cast<uintptr_t>(x) % 16)
      return bad;
    const dim3 grid((n + kWarps * kRowsNK - 1) / (kWarps * kRowsNK), (m + kMT - 1) / kMT);
    qmm_rows<<<grid, kThreads, 0, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  if (fmt == kI4) {
    if (k % 2 || group < 1 || (k / 2) % group) return bad;
  } else if (fmt != kI8) {
    return bad;
  }
  const bool mma = mma_ok(fmt, k, group, ldw, nw, w, x_dtype);
  a.nsplit = pick_splits(fmt, mma, m, k, n, group, &a.cpb);
  if (a.nsplit > 1 && partial == nullptr) return bad;
  return fmt == kI4 ? launch_kn<kI4>(a, mma, s) : launch_kn<kI8>(a, mma, s);
}
