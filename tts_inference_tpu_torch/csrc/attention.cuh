// Shared body of the decode-attention kernels, for Hopper (sm_90a): K1
// (decode_attention.cu, a dense KV window) and K3a/K3b/K5
// (paged_attention.cu, a block pool driven by a block table: bf16/f32, int8
// with scales, or int4 packed by head pair with scales).
//
// One decode query per (slot, kv head) attends to the keys j <= pos[b] of
// its window: q·kᵀ/√D → softmax → ·v, accumulated in f32, written in q's
// dtype. The kernels differ only in where key j of a slot lives and whether
// its row carries a scale, so the body is a template over a `Keys` type:
//
//   Keys::Elem            storage type of the K/V rows (bf16, f32 or int8:
//                         one element per head-dim position)
//   Keys::kScaled         true when rows are integers with per-row f32 scales
//   keys.slot(b, h)       per-(slot, head) addressing, with
//     .key(j) / .value(j)         pointer to the D elements of key j
//     .read8(p, o) / .read4(p, o) 8 / 4 elements at p as f32 (K5 picks the
//                                 head's nibble of each byte here)
//     .key_scale(j) / .value_scale(j)   (kScaled only) the row's scale
//
// Design (flash-decoding): the window is cut into chunks of kSplit keys;
// one block per (slot, kv head, chunk) streams its chunk's K/V rows once
// with an online softmax over tiles of kTile keys, and a second pass
// combines the chunks' (acc, max, denominator). Scores: one thread per key,
// 8 elements per load; p·v: one warp per key, each lane owns 4 head-dim
// elements, so a V row is one coalesced read. Keys past pos[b] are never
// read. The G query heads of a kv head share every K/V load.
//
// With scales (K3b), the k scale multiplies the score column after the
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

}  // namespace
