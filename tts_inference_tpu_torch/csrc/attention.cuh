// Shared bodies of the decode-attention kernels, for Hopper (sm_90a): K1
// (decode_attention.cu, a dense KV window) and K3a/K3b/K5
// (paged_attention.cu, a block pool driven by a block table: bf16/f32, int8
// with scales, or int4 packed by head pair with scales).
//
// One decode query per (slot, kv head) attends to the keys j <= pos[b] of
// its window: q·kᵀ/√D → softmax → ·v, accumulated in f32, written in q's
// dtype. The kernels differ only in where key j of a slot lives and whether
// its row carries a scale, so each body is a template over a `Keys` type:
//
//   Keys::Elem            storage type of the K/V rows (bf16, f32 or int8:
//                         one byte per head-dim position, or per two heads)
//   Keys::kScaled         true when rows are integers with per-row f32 scales
//   Keys::kPlanes         kv heads that share a row: 1, or 2 for K5's pairs
//   keys.slot(b, h)       per-(slot, head) addressing, with
//     .key(j) / .value(j)         pointer to the row of key j
//     .read8(p, o) / .read4(p, o) 8 / 4 elements at p as f32 (K5 picks the
//                                 head's nibble of each byte here)
//     .key_scale(j) / .value_scale(j)   (kScaled only) the row's scale,
//     .ks_at(j) / .vs_at(j)             and its address
//
// Two bodies (flash-decoding both: the window is cut into chunks, one block
// per (slot, kv head, chunk), the chunks' (acc, max, denominator) combined
// afterwards; keys past pos[b] are never read; the G query heads of a kv
// head share every K/V load):
//
// `attention_mma` — bf16 queries at D 64 or 128 over bf16 rows (K1, K3a),
// int8 rows with scales (K3b) or int4 rows packed by head pair (K5, one
// block per head pair): every serve path. The bytes are few (4–70 MB at the
// serve shapes), so what bounds the kernel on this card is the latency of
// its load chains and of its launch, not the memory rate. What the design
// does about it:
//  - the chunk length comes from the shape (the wrapper picks 64 or 128 keys
//    so that every SM gets two to four blocks), and a block whose chunk
//    starts past pos[b] returns before it touches q;
//  - each of a block's four warps owns a quarter of the chunk and requests
//    all of its K rows (and their scales) and then all of its V rows at once
//    with cp.async (16 bytes per lane, neighbouring lanes on neighbouring
//    addresses) into shared memory: tens of KB per SM are in flight, and the
//    scores start when K has landed while V is still on its way. Rows are
//    padded by 16 bytes, so the ldmatrix reads that follow have no bank
//    conflicts;
//  - both products run on the tensor cores: mma.sync.m16n8k16 with the G
//    query heads in the first rows of A (the other rows are zeros, which
//    cost nothing where bytes and latency bound the kernel), K and V
//    fragments by ldmatrix (V transposed), f32 sums, the softmax on the
//    score fragments in registers with shuffles inside a quad. Integer rows
//    become bf16 in the fragments, exactly (int_frags), with the scales
//    applied to the score and probability fragments. A warp never waits for
//    another until the block merges its four partial results;
//  - one launch: a block writes its chunk's partial result to scratch and
//    counts itself on a per-(slot, head) counter; the block that arrives
//    last combines the chunks in a fixed order (no float atomics: runs
//    repeat bit for bit), with the chunks' loads in flight together, and
//    sets the counter back to 0 for the next launch.
//
// `attention_chunk` + `attention_combine` — every other case: f32 queries
// (the tiny configuration) and other head dims. CUDA cores, chunks of kSplit
// keys, the combine as a second launch. Scores: one thread per key, 8
// elements per load; p·v: one warp per key, each lane owns 4 head-dim
// elements, so a V row is one coalesced read.
//
// With scales (K3b, K5), the k scale multiplies the score column after the
// q·k dot and the v scale multiplies the probability row before p·v; the
// softmax denominator uses the unscaled probabilities. By linearity this is
// dequantize-then-attend, without ever writing dequantized rows.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = kThreads;  // keys per tile: one per thread for scores
constexpr int kSplit = 256;      // keys per block
constexpr int kMaxG = 8;         // query heads per kv head
constexpr int kMaxD = 256;       // head dim: each lane owns 4 dims per 128

inline int attention_splits(int w) { return (w + kSplit - 1) / kSplit; }

// The shapes every attention kernel takes; anything else is refused.
inline bool attention_shape_ok(int b, int hkv, int g, int d, int w) {
  return b >= 1 && hkv >= 1 && g >= 1 && g <= kMaxG && d >= 8 && d % 8 == 0 &&
         d <= kMaxD && w >= 1;
}

__device__ inline void load8(const __nv_bfloat16* p, float o[8]) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const unsigned int u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[i]));
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

__device__ inline void load8(const float* p, float o[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

// four int8 values packed in u (little-endian) → f32, sign-extended
__device__ inline void unpack4(unsigned int u, float o[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    o[i] = static_cast<float>(static_cast<int>(u << (24 - 8 * i)) >> 24);
}

__device__ inline void load8(const int8_t* p, float o[8]) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  unpack4(r.x, o);
  unpack4(r.y, o + 4);
}

__device__ inline void load4(const __nv_bfloat16* p, float o[4]) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.y));
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}

__device__ inline void load4(const float* p, float o[4]) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  o[0] = r.x; o[1] = r.y; o[2] = r.z; o[3] = r.w;
}

__device__ inline void load4(const int8_t* p, float o[4]) {
  unpack4(*reinterpret_cast<const unsigned int*>(p), o);
}

__device__ inline float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ inline float to_f32(float x) { return x; }
__device__ inline void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
__device__ inline void store(float* p, float x) { *p = x; }

__device__ inline float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ inline float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// One (slot, kv head, chunk): online softmax over the chunk's keys. With one
// chunk it writes the output; otherwise the chunk's (acc, max, denominator).
template <typename T, typename Keys>
__global__ void __launch_bounds__(kThreads)
attention_chunk(const T* __restrict__ q, const Keys keys, const int* __restrict__ pos,
                T* __restrict__ out, float* __restrict__ o_part,
                float* __restrict__ m_part, float* __restrict__ l_part, int hkv,
                int g, int d, int w, int nsplit, float scale) {
  using E = typename Keys::Elem;
  extern __shared__ float smem[];
  float* q_s = smem;               // (g, d) queries in f32
  float* p_s = q_s + g * d;        // (g, kTile) scores, then probabilities
  float* r_s = p_s + g * kTile;    // (kWarps, g, d) per-warp accumulators
  float* m_s = r_s + kWarps * g * d;  // (g) running max
  float* l_s = m_s + g;            // (g) running denominator
  float* a_s = l_s + g;            // (g) accumulator rescale for this tile

  const int bh = blockIdx.y;
  const int b = bh / hkv;
  const int h = bh % hkv;
  const int split = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const T* qb = q + static_cast<size_t>(bh) * g * d;
  for (int i = tid; i < g * d; i += kThreads) q_s[i] = to_f32(qb[i]);
  if (tid < g) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  float acc[kMaxG][2][4];
#pragma unroll
  for (int gi = 0; gi < kMaxG; ++gi)
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[gi][c][i] = 0.f;
  __syncthreads();

  int limit = pos[b] + 1;
  limit = limit > w ? w : (limit < 0 ? 0 : limit);
  const int j0 = split * kSplit;
  const int j1 = min(j0 + kSplit, limit);
  const auto kv = keys.slot(b, h);

  for (int t0 = j0; t0 < j1; t0 += kTile) {
    const int nt = min(kTile, j1 - t0);
    // scores: one thread per key, 8-element vectors along the head dim
    if (tid < nt) {
      const E* kr = kv.key(t0 + tid);
      float part[kMaxG];
#pragma unroll
      for (int gi = 0; gi < kMaxG; ++gi) part[gi] = 0.f;
#pragma unroll 4
      for (int c = 0; c < d; c += 8) {
        float kx[8];
        kv.read8(kr + c, kx);
#pragma unroll
        for (int gi = 0; gi < kMaxG; ++gi) {
          if (gi < g) {
            const float* qq = q_s + gi * d + c;
#pragma unroll
            for (int i = 0; i < 8; ++i) part[gi] += qq[i] * kx[i];
          }
        }
      }
      float col = scale;
      if constexpr (Keys::kScaled) col = scale * kv.key_scale(t0 + tid);
#pragma unroll
      for (int gi = 0; gi < kMaxG; ++gi)
        if (gi < g) p_s[gi * kTile + tid] = part[gi] * col;
    }
    __syncthreads();
    // online softmax: one warp per query head
    for (int gi = warp; gi < g; gi += kWarps) {
      float mx = -INFINITY;
      for (int jj = lane; jj < nt; jj += 32) mx = fmaxf(mx, p_s[gi * kTile + jj]);
      mx = warp_max(mx);
      const float m_old = m_s[gi];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int jj = lane; jj < nt; jj += 32) {
        const float e = expf(p_s[gi * kTile + jj] - m_new);
        p_s[gi * kTile + jj] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);  // 0 on the first tile
        a_s[gi] = alpha;
        l_s[gi] = l_s[gi] * alpha + sum;
        m_s[gi] = m_new;
      }
    }
    __syncthreads();
    // p·v: one warp per key, each lane owns dims lane*4 (+128)
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi) {
      if (gi < g) {
        const float a = a_s[gi];
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[gi][c][i] *= a;
      }
    }
#pragma unroll 4
    for (int jj = warp; jj < nt; jj += kWarps) {
      const E* vr = kv.value(t0 + jj);
      float row = 1.f;
      if constexpr (Keys::kScaled) row = kv.value_scale(t0 + jj);
      float p[kMaxG];
#pragma unroll
      for (int gi = 0; gi < kMaxG; ++gi) p[gi] = gi < g ? p_s[gi * kTile + jj] : 0.f;
      if constexpr (Keys::kScaled) {
#pragma unroll
        for (int gi = 0; gi < kMaxG; ++gi) p[gi] *= row;
      }
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int di = c * 128 + lane * 4;
        if (di < d) {
          float vv[4];
          kv.read4(vr + di, vv);
#pragma unroll
          for (int gi = 0; gi < kMaxG; ++gi)
            if (gi < g)
#pragma unroll
              for (int i = 0; i < 4; ++i) acc[gi][c][i] += p[gi] * vv[i];
        }
      }
    }
    __syncthreads();
  }

  // reduce the warps' accumulators
#pragma unroll
  for (int gi = 0; gi < kMaxG; ++gi) {
    if (gi < g) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int di = c * 128 + lane * 4;
        if (di < d)
#pragma unroll
          for (int i = 0; i < 4; ++i) r_s[(warp * g + gi) * d + di + i] = acc[gi][c][i];
      }
    }
  }
  __syncthreads();
  const size_t part_row = static_cast<size_t>(bh) * nsplit + split;
  for (int i = tid; i < g * d; i += kThreads) {
    float o = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) o += r_s[wi * g * d + i];
    if (nsplit == 1) {
      const float l = l_s[i / d];
      store(out + static_cast<size_t>(bh) * g * d + i, l > 0.f ? o / l : 0.f);
    } else {
      o_part[part_row * g * d + i] = o;
    }
  }
  if (nsplit > 1 && tid < g) {
    m_part[part_row * g + tid] = m_s[tid];
    l_part[part_row * g + tid] = l_s[tid];
  }
}

// Combine the chunks of one (slot, kv head): rescale by exp(m_s - max).
template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_combine(const float* __restrict__ o_part, const float* __restrict__ m_part,
                  const float* __restrict__ l_part, T* __restrict__ out, int g, int d,
                  int nsplit) {
  const int bh = blockIdx.x;
  for (int i = threadIdx.x; i < g * d; i += kThreads) {
    const int gi = i / d;
    float mx = -INFINITY;
    for (int s = 0; s < nsplit; ++s)
      mx = fmaxf(mx, m_part[(static_cast<size_t>(bh) * nsplit + s) * g + gi]);
    float num = 0.f, den = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const size_t pr = static_cast<size_t>(bh) * nsplit + s;
      const float m = m_part[pr * g + gi];
      if (m == -INFINITY) continue;  // chunk past pos: no keys
      const float e = expf(m - mx);
      num += e * o_part[pr * g * d + i];
      den += e * l_part[pr * g + gi];
    }
    store(out + static_cast<size_t>(bh) * g * d + i, den > 0.f ? num / den : 0.f);
  }
}

// Launch the chunk pass (and the combine pass when the window has more than
// one chunk); returns the launches' cudaError_t. Scratch for the partials:
// f32 (B·Hkv·S·G·D) + 2·(B·Hkv·S·G), S = attention_splits(w).
template <typename T, typename Keys>
int attention_launch(const void* q, const Keys& keys, const void* pos, void* out,
                     void* scratch, int b, int hkv, int g, int d, int w, float scale,
                     cudaStream_t s) {
  const int nsplit = attention_splits(w);
  if (nsplit > 1 && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      static_cast<size_t>(g * d + g * kTile + kWarps * g * d + 3 * g) * sizeof(float);
  const size_t parts = static_cast<size_t>(b) * hkv * nsplit * g;
  float* o_part = static_cast<float*>(scratch);
  float* m_part = o_part + parts * d;
  float* l_part = m_part + parts;
  attention_chunk<T, Keys><<<dim3(nsplit, b * hkv), kThreads, smem, s>>>(
      static_cast<const T*>(q), keys, static_cast<const int*>(pos), static_cast<T*>(out),
      o_part, m_part, l_part, hkv, g, d, w, nsplit, scale);
  if (nsplit > 1) {
    attention_combine<T><<<b * hkv, kThreads, 0, s>>>(o_part, m_part, l_part,
                                                       static_cast<T*>(out), g, d, nsplit);
  }
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// The tensor-core body: bf16 queries at D 64 or 128, over bf16 rows (K1,
// K3a), int8 rows with scales (K3b) or int4 rows packed by head pair with
// scales (K5).

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;

__device__ inline unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global → shared, asynchronously; zeros when !valid (src is not read)
__device__ inline void cp_async16(unsigned dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n)
               : "memory");
}

// the same for 4 bytes (a row's scale)
__device__ inline void cp_async4(unsigned dst, const void* src, bool valid) {
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(n)
               : "memory");
}

__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8×8 b16 matrices; lane i gives the row address of matrix i / 8, row i % 8
__device__ inline void ldmatrix_x4(unsigned addr, unsigned& r0, unsigned& r1, unsigned& r2,
                                   unsigned& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr)
               : "memory");
}

__device__ inline void ldmatrix_x4_trans(unsigned addr, unsigned& r0, unsigned& r1,
                                         unsigned& r2, unsigned& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr)
               : "memory");
}

// c += a · b, a (16 × 16) row-major with rows 8..15 zero, b (16 × 8), f32 sums
__device__ inline void mma_top_rows(float c[4], unsigned a_lo, unsigned a_hi, unsigned b0,
                                    unsigned b1) {
  const unsigned zero = 0u;
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a_lo), "r"(zero), "r"(a_hi), "r"(zero), "r"(b0), "r"(b1));
}

// Integer rows → bf16 B fragments, exactly (|q| ≤ 127 has at most 7
// significant bits). An ldmatrix of integer rows hands a lane a word of four
// elements e0..e3: four consecutive bytes of one row (K), or bytes
// (2n, 2n + 1) of two consecutive rows (V, transposed). `ev` gets (e0, e2)
// and `od` (e1, e3), each as a bf16 pair with the first in the low half.
//
// int8 (Int4 false): the byte, biased by 128, in the mantissa of 2^23 is
// 2^23 + byte as f32; minus 2^23 + 128 leaves the integer, whose f32 upper
// half is its bf16.
// int4 packed by head pair (Int4 true): the nibble plane starts at bit
// `shift` of each byte (0: the low nibble, offset-encoded, bits = q + 8; 4:
// the high nibble, two's complement, so bits ^ 8 = q + 8). The nibble XOR
// `magic` (bf16 128.0, or 128.0 with bit 3 set for the high plane) is
// 128 + q + 8 as bf16; minus 136 leaves q.
template <bool Int4>
__device__ __forceinline__ void int_frags(unsigned w, int shift, unsigned magic, unsigned& ev,
                                          unsigned& od) {
  if constexpr (!Int4) {
    const unsigned u = w ^ 0x80808080u;
    const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
    const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
    const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
    const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
    ev = __byte_perm(__float_as_uint(f0), __float_as_uint(f2), 0x7632);
    od = __byte_perm(__float_as_uint(f1), __float_as_uint(f3), 0x7632);
  } else {
    const unsigned ve = ((w >> shift) & 0x000F000Fu) ^ magic;        // e0, e2
    const unsigned vo = ((w >> (shift + 8)) & 0x000F000Fu) ^ magic;  // e1, e3
    const __nv_bfloat162 k136 = __floats2bfloat162_rn(136.f, 136.f);
    const __nv_bfloat162 e = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&ve), k136);
    const __nv_bfloat162 o = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&vo), k136);
    ev = *reinterpret_cast<const unsigned*>(&e);
    od = *reinterpret_cast<const unsigned*>(&o);
  }
}

// the warps of a K5 pair (same keys, one nibble plane each) meet at named
// barrier 1 + quarter (immediate ids: a register id reserves all 16)
__device__ inline void pair_sync(int quarter) {
  switch (quarter) {
    case 0: asm volatile("bar.sync 1, 64;\n" ::: "memory"); break;
    case 1: asm volatile("bar.sync 2, 64;\n" ::: "memory"); break;
    case 2: asm volatile("bar.sync 3, 64;\n" ::: "memory"); break;
    default: asm volatile("bar.sync 4, 64;\n" ::: "memory"); break;
  }
}

inline bool attention_mma_takes(int d, int chunk) {
  return (d == 64 || d == 128) && (chunk == 64 || chunk == 128);
}

// Bytes of dynamic shared memory of attention_mma<HD, KW, Keys>: the chunk's
// K and V rows (padded by 16 bytes) and, with integer rows, each warp's
// scales ([k | v][KW] f32); the warps' partials reuse them for the merge.
template <int HD, int KW, typename Keys>
constexpr int attention_mma_smem() {
  constexpr int row = (Keys::kScaled ? HD : 2 * HD) + 16;
  constexpr int rows = 2 * KW * kMmaWarps * row;
  constexpr int scales = Keys::kScaled ? Keys::kPlanes * kMmaWarps * 2 * KW * 4 : 0;
  constexpr int red = Keys::kPlanes * kMmaWarps * (8 * HD + 16) * 4;
  return rows + scales > red ? rows + scales : red;
}

// One (slot, chunk of 4·KW keys) and the Keys::kPlanes kv heads h0.. that
// share a row (1; 2 for K5's head pairs): 4·kPlanes warps, warp w on head
// h0 + w / 4 and keys [chunk start + (w % 4)·KW, + KW). In the fragments,
// lane = 4·row + column pair: row `gr` is the query head, `qc` the first of
// the lane's two columns.
//
// Integer rows (Keys::kScaled) reach the same mma.sync as bf16 rows: an
// ldmatrix of the int8 (or packed int4) rows gives each lane four elements
// per word, converted in registers by int_frags. In q·k the four are four
// consecutive head dims, and q's A fragments take its dims in the same order
// (a sum over D does not care which slot holds which dim); in p·v they are
// two keys of an even and an odd head dim, so one word feeds two n-tiles,
// one of even and one of odd dims, and the output dims are put back in order
// where the partials are stored. The k scale multiplies the score column
// (with 1/√D) before the mask and the max; the denominator sums the
// unscaled probabilities; p·v multiplies p·vs, split into a bf16 part and a
// bf16 remainder (two products; p·vs alone in bf16 put an output one bf16
// step off where p is 1): dequantize-then-attend, by linearity. A K5 block's
// two warps of a quarter read each packed byte once, from the rows they
// requested together, each taking its own nibble.
template <int HD, int KW, typename Keys>
__global__ void __launch_bounds__(kMmaThreads * Keys::kPlanes)
attention_mma(const __nv_bfloat16* __restrict__ q, const Keys keys,
              const int* __restrict__ pos, __nv_bfloat16* __restrict__ out,
              float* __restrict__ o_part, float* __restrict__ m_part,
              float* __restrict__ l_part, int* __restrict__ counters, int hkv, int g, int w,
              int nchunk, float scale) {
  constexpr bool kInt = Keys::kScaled;
  constexpr int kPlanes = Keys::kPlanes;
  static_assert(kInt ? sizeof(typename Keys::Elem) == 1
                     : sizeof(typename Keys::Elem) == 2 && kPlanes == 1,
                "bf16 rows, or integer rows with scales");
  constexpr int kThreads = kMmaThreads * kPlanes;
  constexpr int kChunk = KW * kMmaWarps;
  constexpr int kRowBytes = kInt ? HD : HD * 2;
  constexpr int kRowB = kRowBytes + 16;  // bytes of a padded row in shared memory
  constexpr int kPieces = kRowBytes / 16;  // 16-byte pieces of a row
  constexpr int kRows = 2 * kChunk * kRowB;
  constexpr int kScales = kInt ? 2 * KW : 0;  // floats of a warp's scales
  constexpr int kRed = 8 * HD + 16;  // floats of a warp's partial (acc, max, sum)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int last_s;

  const int units = hkv / kPlanes;
  const int b = blockIdx.y / units;
  const int h0 = (blockIdx.y % units) * kPlanes;
  const int bh0 = b * hkv + h0;  // the block's heads are bh0 .. bh0 + kPlanes - 1
  const int chunk = blockIdx.x;
  const int tid = threadIdx.x;
  int limit = pos[b] + 1;
  limit = limit > w ? w : (limit < 0 ? 0 : limit);
  const int j0 = chunk * kChunk;
  __nv_bfloat16* ob = out + static_cast<size_t>(bh0) * g * HD;
  if (j0 >= limit) {  // nothing to attend to: no load, no partial, no count
    if (limit == 0 && chunk == 0)
      for (int i = tid; i < kPlanes * g * HD; i += kThreads) ob[i] = __float2bfloat16(0.f);
    return;
  }
  const int nact = (limit + kChunk - 1) / kChunk;  // chunks that hold keys
  const int j1 = min(j0 + kChunk, limit);
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int pl = warp / kMmaWarps;       // the warp's head: h0 + pl (K5: nibble plane)
  const int quarter = warp % kMmaWarps;  // the warp's quarter of the chunk
  const int gr = lane >> 2;
  const int qc = (lane & 3) * 2;
  const auto kv = keys.slot(b, h0);  // K5: the pair's rows serve both heads
  unsigned char* k_s = smem_raw + static_cast<size_t>(quarter) * KW * kRowB;
  unsigned char* v_s = k_s + static_cast<size_t>(kChunk) * kRowB;
  float* sc_s = reinterpret_cast<float*>(smem_raw + kRows) + warp * kScales;
  const int wj0 = j0 + quarter * KW;
  const int nvalid = min(KW, j1 - wj0);
  const int nsteps = nvalid > 0 ? (nvalid + 15) / 16 : 0;  // 16-key steps of this warp

  // request the quarter's K rows (the warps of a K5 pair share the work)
  // and the warp's k and v scales, then the V rows; rows past j1 become zeros
  {
    const int cl = pl * 32 + lane;
    const int piece = cl % kPieces;
    for (int r = cl / kPieces; r < nsteps * 16; r += 32 * kPlanes / kPieces) {
      const bool ok = wj0 + r < j1;
      cp_async16(smem_addr(k_s + r * kRowB + piece * 16),
                 reinterpret_cast<const unsigned char*>(kv.key(ok ? wj0 + r : wj0)) + piece * 16,
                 ok);
    }
    if constexpr (kInt) {
      const auto kvp = keys.slot(b, h0 + pl);
      for (int i = lane; i < kScales; i += 32) {  // [k | v][key]
        const int r = i % KW;
        const bool ok = wj0 + r < j1;
        const int j = ok ? wj0 + r : wj0;
        cp_async4(smem_addr(sc_s + i), i < KW ? kvp.ks_at(j) : kvp.vs_at(j), ok);
      }
    }
    cp_async_commit();
    for (int r = cl / kPieces; r < nsteps * 16; r += 32 * kPlanes / kPieces) {
      const bool ok = wj0 + r < j1;
      cp_async16(smem_addr(v_s + r * kRowB + piece * 16),
                 reinterpret_cast<const unsigned char*>(kv.value(ok ? wj0 + r : wj0)) +
                     piece * 16,
                 ok);
    }
    cp_async_commit();
  }

  // q as A fragments: row gr; bf16 rows: columns 16·ks + qc (+1) and + 8;
  // integer rows: dims 16·ks + 2·qc + (0, 2) and (1, 3), as int_frags pairs them
  unsigned qa[HD / 16][2];
  {
    const __nv_bfloat16* qb = q + (static_cast<size_t>(bh0 + pl) * g + gr) * HD;
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      if constexpr (kInt) {
        const uint2 v = gr < g ? *reinterpret_cast<const uint2*>(qb + ks * 16 + 2 * qc)
                               : make_uint2(0u, 0u);
        qa[ks][0] = __byte_perm(v.x, v.y, 0x5410);
        qa[ks][1] = __byte_perm(v.x, v.y, 0x7632);
      } else {
        qa[ks][0] = gr < g ? *reinterpret_cast<const unsigned*>(qb + ks * 16 + qc) : 0u;
        qa[ks][1] = gr < g ? *reinterpret_cast<const unsigned*>(qb + ks * 16 + qc + 8) : 0u;
      }
    }
  }
  // K5: the warp's nibble plane
  const int shift = pl * 4;
  const unsigned magic = pl ? 0x43084308u : 0x43004300u;

  float acc[HD / 8][4];
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
  float mx = -INFINITY;
  float sum = 0.f;

  if (nsteps > 0) {
    // scores of 8 keys per tile: s[nt][e] is row gr, key 8·nt + qc + e
    float s[KW / 8][4];
#pragma unroll
    for (int nt = 0; nt < KW / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
    cp_async_wait<1>();  // K has landed
    if constexpr (kPlanes == 2) {
      pair_sync(quarter);  // ... the other warp's requests too
    } else {
      __syncwarp();
    }
#pragma unroll
    for (int nt = 0; nt < KW / 8; ++nt) {
      if (nt < 2 * nsteps) {
        if constexpr (kInt) {
#pragma unroll
          for (int kp = 0; kp < HD / 64; ++kp) {
            unsigned r[4];  // keys 8·nt.., bytes 64·kp + 16·(lane / 8)..
            ldmatrix_x4(smem_addr(k_s + (nt * 8 + (lane & 7)) * kRowB + kp * 64 +
                                  (lane >> 3) * 16),
                        r[0], r[1], r[2], r[3]);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              unsigned ev, od;
              int_frags<kPlanes == 2>(r[i], shift, magic, ev, od);
              mma_top_rows(s[nt], qa[4 * kp + i][0], qa[4 * kp + i][1], ev, od);
            }
          }
        } else {
#pragma unroll
          for (int kp = 0; kp < HD / 32; ++kp) {
            unsigned b0, b1, b2, b3;  // keys 8·nt.., dims 32·kp + 8·(lane / 8)..
            ldmatrix_x4(smem_addr(k_s + (nt * 8 + (lane & 7)) * kRowB +
                                  (kp * 32 + (lane >> 3) * 8) * 2),
                        b0, b1, b2, b3);
            mma_top_rows(s[nt], qa[2 * kp][0], qa[2 * kp][1], b0, b1);
            mma_top_rows(s[nt], qa[2 * kp + 1][0], qa[2 * kp + 1][1], b2, b3);
          }
        }
      }
    }
    // softmax over the warp's keys, on the fragments
#pragma unroll
    for (int nt = 0; nt < KW / 8; ++nt) {
      float col[2] = {scale, scale};
      if constexpr (kInt) {
        const float2 ks = *reinterpret_cast<const float2*>(sc_s + nt * 8 + qc);
        col[0] *= ks.x;
        col[1] *= ks.y;
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = nt < 2 * nsteps && wj0 + nt * 8 + qc + e < j1;
        s[nt][e] = ok ? s[nt][e] * col[e] : -INFINITY;
        mx = fmaxf(mx, s[nt][e]);
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));  // finite: key wj0 < j1
    unsigned pa[KW / 8];  // probabilities as A fragments of p·v
    unsigned pr[kInt ? KW / 8 : 1];  // integer rows: the bf16 remainder of p·vs
#pragma unroll
    for (int nt = 0; nt < KW / 8; ++nt) {
      const float p0 = expf(s[nt][0] - mx);
      const float p1 = expf(s[nt][1] - mx);
      if constexpr (kInt) {
        // the denominator sums the unscaled probabilities; p·v multiplies
        // p·vs as bf16 + bf16 remainder
        const float2 vs = *reinterpret_cast<const float2*>(sc_s + KW + nt * 8 + qc);
        const float x0 = p0 * vs.x, x1 = p1 * vs.y;
        const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
        const __nv_bfloat162 lo =
            __floats2bfloat162_rn(x0 - __low2float(hi), x1 - __high2float(hi));
        sum += p0 + p1;
        pa[nt] = *reinterpret_cast<const unsigned*>(&hi);
        pr[nt] = *reinterpret_cast<const unsigned*>(&lo);
      } else {
        // the denominator sums the rounded probabilities that p·v multiplies
        const __nv_bfloat162 p = __floats2bfloat162_rn(p0, p1);
        sum += __low2float(p) + __high2float(p);
        pa[nt] = *reinterpret_cast<const unsigned*>(&p);
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);

    cp_async_wait<0>();  // V has landed
    if constexpr (kPlanes == 2) {
      pair_sync(quarter);
    } else {
      __syncwarp();
    }
#pragma unroll
    for (int ks = 0; ks < KW / 16; ++ks) {
      if (ks < nsteps) {
        if constexpr (kInt) {
#pragma unroll
          for (int c2 = 0; c2 < HD / 32; ++c2) {
            unsigned r[4];  // keys 16·ks + 8·(lane / 8 % 2).., bytes 16·(2·c2 + lane / 16)..
            ldmatrix_x4_trans(
                smem_addr(v_s + (ks * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * kRowB +
                          (2 * c2 + (lane >> 4)) * 16),
                r[0], r[1], r[2], r[3]);
#pragma unroll
            for (int hb = 0; hb < 2; ++hb) {  // dims 16·(2·c2 + hb)..: even, odd n-tiles
              unsigned e0, o0, e1, o1;
              int_frags<kPlanes == 2>(r[2 * hb], shift, magic, e0, o0);      // keys 0..7
              int_frags<kPlanes == 2>(r[2 * hb + 1], shift, magic, e1, o1);  // keys 8..15
              float* ce = acc[4 * c2 + 2 * hb];
              float* co = acc[4 * c2 + 2 * hb + 1];
              mma_top_rows(ce, pa[2 * ks], pa[2 * ks + 1], e0, e1);
              mma_top_rows(ce, pr[2 * ks], pr[2 * ks + 1], e0, e1);
              mma_top_rows(co, pa[2 * ks], pa[2 * ks + 1], o0, o1);
              mma_top_rows(co, pr[2 * ks], pr[2 * ks + 1], o0, o1);
            }
          }
        } else {
#pragma unroll
          for (int np = 0; np < HD / 16; ++np) {
            unsigned b0, b1, b2, b3;  // keys 16·ks + 8·(lane / 8 % 2).., dims 16·np + 8·(lane / 16)..
            ldmatrix_x4_trans(
                smem_addr(v_s + (ks * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * kRowB +
                          (np * 16 + (lane >> 4) * 8) * 2),
                b0, b1, b2, b3);
            mma_top_rows(acc[2 * np], pa[2 * ks], pa[2 * ks + 1], b0, b1);
            mma_top_rows(acc[2 * np + 1], pa[2 * ks], pa[2 * ks + 1], b2, b3);
          }
        }
      }
    }
  } else {
    cp_async_wait<0>();
  }

  // merge the warps of each head: their partials go where K and V were
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem_raw);  // (kPlanes · kMmaWarps, kRed)
  {
    float* rw = red + warp * kRed;
    if (nsteps > 0 && gr < g) {
#pragma unroll
      for (int nt = 0; nt < HD / 16; ++nt) {
        if constexpr (kInt) {  // n-tiles 2·nt (even dims) and 2·nt + 1 (odd)
          *reinterpret_cast<float4*>(rw + gr * HD + nt * 16 + 2 * qc) =
              make_float4(acc[2 * nt][0], acc[2 * nt + 1][0], acc[2 * nt][1],
                          acc[2 * nt + 1][1]);
        } else {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            rw[gr * HD + (2 * nt + h) * 8 + qc] = acc[2 * nt + h][0];
            rw[gr * HD + (2 * nt + h) * 8 + qc + 1] = acc[2 * nt + h][1];
          }
        }
      }
      if ((lane & 3) == 0) {
        rw[8 * HD + gr] = mx;
        rw[8 * HD + 8 + gr] = sum;
      }
    } else if (nsteps == 0 && lane < 8) {
      rw[8 * HD + lane] = -INFINITY;
    }
  }
  __syncthreads();
  for (int i = tid; i < kPlanes * g * HD; i += kThreads) {
    const int hp = kPlanes == 1 ? 0 : i / (g * HD);  // head h0 + hp
    const int ii = i - hp * g * HD;
    const int gi = ii / HD;
    const float* rh = red + hp * kMmaWarps * kRed;
    float m = -INFINITY;
#pragma unroll
    for (int wi = 0; wi < kMmaWarps; ++wi) m = fmaxf(m, rh[wi * kRed + 8 * HD + gi]);
    float o = 0.f, l = 0.f;
#pragma unroll
    for (int wi = 0; wi < kMmaWarps; ++wi) {
      const float mw = rh[wi * kRed + 8 * HD + gi];
      if (mw == -INFINITY) continue;  // a warp past pos: no keys
      const float e = expf(mw - m);
      o += e * rh[wi * kRed + ii];
      l += e * rh[wi * kRed + 8 * HD + 8 + gi];
    }
    if (nact == 1) {
      ob[i] = __float2bfloat16(o / l);
    } else {
      const size_t part = static_cast<size_t>(bh0 + hp) * nchunk + chunk;
      o_part[part * g * HD + ii] = o;
      if (ii % HD == 0) {
        m_part[part * g + gi] = m;
        l_part[part * g + gi] = l;
      }
    }
  }
  if (nact == 1) return;

  // count this chunk in; the block that arrives last combines the chunks
  // (no float atomics: a fixed order of summation)
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int before = atomicAdd(counters + bh0, 1);
    last_s = before == nact - 1;
    if (last_s) counters[bh0] = 0;  // every chunk has counted: ready for the next launch
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  // each (head, query row): the chunks' max and 1 / denominator, one warp
  // per row with its lanes over the chunks (a running max and sum per lane,
  // then across the warp), so the chunks' loads are in flight together: a
  // loop over the chunks would make each an L2 trip of its own
  float* row_m = reinterpret_cast<float*>(smem_raw);  // (kPlanes · g)
  float* row_inv = row_m + kPlanes * kMaxG;
  for (int r = warp; r < kPlanes * g; r += kThreads / 32) {
    const int hp = kPlanes == 1 ? 0 : r / g;
    const int gi = r - hp * g;
    const size_t p0 = static_cast<size_t>(bh0 + hp) * nchunk;
    float m = -INFINITY, den = 0.f;
    for (int s = lane; s < nact; s += 32) {
      const float ms = __ldcg(m_part + (p0 + s) * g + gi);
      const float ls = __ldcg(l_part + (p0 + s) * g + gi);
      const float mn = fmaxf(m, ms);
      den = den * expf(m - mn) + ls * expf(ms - mn);
      m = mn;
    }
    const float mr = warp_max(m);
    den = warp_sum(den * expf(m - mr));  // a lane without chunks adds 0
    if (lane == 0) {
      row_m[r] = mr;
      row_inv[r] = 1.f / den;
    }
  }
  __syncthreads();
  for (int i = tid; i < kPlanes * g * HD; i += kThreads) {
    const int r = i / HD;  // (head, query row)
    const int hp = kPlanes == 1 ? 0 : r / g;
    const int gi = r - hp * g;
    const int ii = i - hp * g * HD;
    const size_t p0 = static_cast<size_t>(bh0 + hp) * nchunk;
    const float m = row_m[r];
    float num = 0.f;
#pragma unroll 8
    for (int s = 0; s < nact; ++s)
      num += expf(__ldcg(m_part + (p0 + s) * g + gi) - m) *
             __ldcg(o_part + (p0 + s) * g * HD + ii);
    ob[i] = __float2bfloat16(num * row_inv[r]);
  }
}

template <int HD, int KW, typename Keys>
int attention_mma_launch_as(const void* q, const Keys& keys, const void* pos, void* out,
                            void* scratch, void* counters, int b, int hkv, int g, int w,
                            float scale, cudaStream_t s) {
  constexpr int kChunk = KW * kMmaWarps;
  constexpr int kSmem = attention_mma_smem<HD, KW, Keys>();
  const int nchunk = (w + kChunk - 1) / kChunk;
  if (nchunk > 1 && (scratch == nullptr || counters == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (hkv % Keys::kPlanes) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = attention_mma<HD, KW, Keys>;
  if (kSmem > 48 * 1024) {  // once per device and process
    static bool allowed[64] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
    if (!allowed[dev]) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
      if (err != cudaSuccess) return static_cast<int>(err);
      allowed[dev] = true;
    }
  }
  const size_t parts = static_cast<size_t>(b) * hkv * nchunk * g;
  float* o_part = static_cast<float*>(scratch);
  float* m_part = o_part + parts * HD;
  float* l_part = m_part + parts;
  kernel<<<dim3(nchunk, b * (hkv / Keys::kPlanes)), kMmaThreads * Keys::kPlanes, kSmem, s>>>(
      static_cast<const __nv_bfloat16*>(q), keys, static_cast<const int*>(pos),
      static_cast<__nv_bfloat16*>(out), o_part, m_part, l_part, static_cast<int*>(counters),
      hkv, g, w, nchunk, scale);
  return static_cast<int>(cudaGetLastError());
}

// Launch the tensor-core body with chunks of `chunk` keys (64 or 128) over
// head dim d (64 or 128): see attention_mma_takes. One block per (slot,
// chunk) and Keys::kPlanes kv heads, 4·kPlanes warps. Scratch for the partials: f32
// B·Hkv·S·G·(D + 2), S = ceil(w / chunk); counters: B·Hkv ints that are 0
// before the launch and 0 again after it. Returns the launch's cudaError_t.
template <typename Keys>
int attention_mma_launch(const void* q, const Keys& keys, const void* pos, void* out,
                         void* scratch, void* counters, int b, int hkv, int g, int d, int w,
                         int chunk, float scale, cudaStream_t s) {
  if (d == 128 && chunk == 64)
    return attention_mma_launch_as<128, 16>(q, keys, pos, out, scratch, counters, b, hkv, g,
                                            w, scale, s);
  if (d == 128 && chunk == 128)
    return attention_mma_launch_as<128, 32>(q, keys, pos, out, scratch, counters, b, hkv, g,
                                            w, scale, s);
  if (d == 64 && chunk == 64)
    return attention_mma_launch_as<64, 16>(q, keys, pos, out, scratch, counters, b, hkv, g,
                                           w, scale, s);
  if (d == 64 && chunk == 128)
    return attention_mma_launch_as<64, 32>(q, keys, pos, out, scratch, counters, b, hkv, g,
                                           w, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
