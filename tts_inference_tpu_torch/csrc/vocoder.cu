// K6: one fused SNAC residual unit, for Hopper (sm_90a): the f32 kernel, and
// at the end the bf16 entry of the 16-bit body (vocoder16.cuh, with its own
// note).
//
// Replaces tts_inference_tpu/ops/pallas/vocoder.py::fused_residual_unit
// (Pallas bodies `_unit_kernel` / `_unit_kernel_single`, launched by
// `_fused_unit` / `_fused_unit_single`):
//
//   out = x + (pw · snake2(dw ⊛_dil snake1(x) + dw_b) + pw_b),  rows t >= valid[b] -> 0
//
// with a depthwise k=7 convolution at dilation 1, 3 or 9 and a pointwise
// C×C product (C ∈ {512, 256, 128, 64} in the SNAC 24 kHz geometry).
//
// What bounds it on the H100: f32 arithmetic on the CUDA cores, that is,
// instruction issue. The pointwise product is 2·C FLOPs per element against
// 8 bytes of activation traffic (C/4 FLOP per byte: 128 at C=512), and the
// two snakes and seven taps of an element cost about as many instructions
// as the product does at C=128. TF32 is ruled out by the vocoder's f32
// parity, so the product cannot go to the tensor cores; the question is how
// close the FMA pipes come to their peak, which is decided by how many other
// instructions, shared-memory reads and barriers each FMA pays for. Only at
// C=64 do the bytes (x in, out) set the bound.
//
// What the design does about it:
//  - one block of 256 threads (512 at C=512) per (row, time tile); a tile
//    holds 16,384
//    values of y2 = snake2(dw ⊛ snake1(x) + dw_b) in shared memory for all
//    input channels (C padded to 64, 128, 256 or 512; 256, 128, 64 or 32
//    time steps), so 8 rows of 512 steps at C=512 are 128 blocks for 132
//    SMs, and below C=512 two blocks share an SM;
//  - stage 1 goes by channel groups, every warp on its own: x for the tile
//    and its ±3·dilation halo is read once (time is the fast index of the
//    decoder's channel-first storage, which is requested 16 bytes at a
//    time) by cp.async into the warp's ring of three staging buffers, two
//    groups ahead and with no block barrier;
//    snake1 is applied once per element in place, and the seven taps read
//    from there; halo columns outside [0, T) are zeros, which equals the
//    reference's zero padding since snake(0) == 0. The sines are a chain of
//    dependent operations, so a lane computes four (snake1) or all of its
//    group's outputs (snake2) at once in branch-free code that interleaves:
//    sin² has period π, so the argument is reduced to [−π/2, π/2] and sin
//    is a polynomial there (`sin_squared_fast`, within 4e-7 of sinf²; sinf
//    itself where an argument is beyond 8192);
//  - the pointwise product is a register-tiled f32 GEMM: every thread owns
//    8 output channels × 8 time steps (8 × 4 in the 512-thread block of
//    C=512): 64 FMAs for four 16-byte shared-memory reads per input channel.
//    Its channels are 8 apart and its time steps are groups of 4, and the
//    16-byte units of the weight rows are XOR-swizzled, so a warp's reads of
//    the weight and of y2 touch every bank once without padding. The weight
//    arrives in slices of 8 or 16 input channels by cp.async into a ring of
//    three buffers: the next two slices load while this one is multiplied,
//    one barrier per slice; the first are requested before stage 1;
//  - bias, residual and the valid-length mask are applied in the epilogue;
//    on whole tiles of channel-first storage with 16-byte loads and stores,
//    the residual of four channels requested before any of it is used;
//  - activations are addressed through explicit (b, t, c) strides, so the
//    channel-first tensors the port's decoder keeps for cuDNN are read and
//    written in place, and channel-last tensors are taken too.
// Each output's sum runs over the input channels 0..C-1 in that order in
// one FMA chain, whatever the tiling, so a windowed streaming decode equals
// a batch decode wherever the rest of the stack does. (Only where the
// argument of a sine is beyond 8192 do an element's neighbours in its warp
// decide which of the two sine evaluations, 4e-7 apart, it gets.)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTileElems = 16384;  // y2 values of a tile: 64 KB
constexpr int kMaxChannels = 512;
constexpr int kXStages = 3;        // staging buffers of a warp's x pipeline
// per-channel constants kept in shared memory: alpha1, 1/(alpha1 + 1e-9),
// alpha2, 1/(alpha2 + 1e-9), the depthwise bias and its seven taps
constexpr int kParams = 12;

// Per padded channel count CP: the block's threads, the time steps NT a
// thread owns in the product, the weight slice depth KC (8 or 16) and the
// ring's buffers NST, the channels R a warp stages per step of stage 1 and
// the floats XW of one of its staging buffers (R·(TT + 6·dilation + 6) must
// fit, the 6 for rows that start at a multiple of 4: dilation up to 9).
// Below CP 512 two blocks fit an SM (at most ~113 KB and 128 registers
// each); at CP 512 the one block has 16 warps.
template <int CP>
struct Tiling {
  static constexpr int kThreads = CP == 512 ? 512 : 256;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kNT = CP == 512 ? 4 : 8;
  static constexpr int kKC = CP == 256 ? 8 : 16;
  static constexpr int kStages = 3;
  static constexpr int kRows = CP == 512 ? 2 : 1;
  static constexpr int kXw = CP == 512 ? 192 : CP == 256 ? 128 : CP == 128 ? 192 : 320;
  static constexpr int kTT = kTileElems / CP;  // time steps of a tile
  static constexpr int kSmemFloats =
      kTileElems + kStages * CP * kKC + kWarps * kXStages * kXw + kParams * CP;
  static constexpr int kMaxDilation = (kXw / kRows - kTT - 6) / 6;
  static_assert((kWarps / (CP / 64)) * 4 * kNT == kTT, "the warps tile the time steps");
  static_assert(kRows == 1 || kRows == 2, "stage 1 tells a group's two rows apart by one comparison");
};

// A weight slice lies in shared memory as rows [co][KC] without padding; the
// 16-byte units of a row are swizzled by XOR with this function of co, so
// that the eight rows co..co+7 a warp reads together (the same unit of each)
// fall into eight different bank groups. It is the same for co and co + 8.
template <int KC>
__device__ inline int weight_swizzle(int co) {
  return KC == 16 ? (co >> 1) & 3 : (co >> 2) & 1;
}

// sin²(t) for |t| <= kSinFast without a branch, so that several of them
// interleave in one thread: sin² has period π, so t is reduced to
// r = t − jπ in [−π/2, π/2] (Cody–Waite in three steps: the error of r stays
// under 3e-7 for |t| <= kSinFast) and sin r is an odd polynomial of degree
// 11 (the Taylor terms: their error is under 6e-8 at |r| = π/2).
constexpr float kSinFast = 8192.f;

__device__ inline float sin_squared_fast(float t) {
  const float j = rintf(t * 0.318309886f);
  float r = fmaf(j, -3.140625f, t);
  r = fmaf(j, -9.67502593994140625e-4f, r);
  r = fmaf(j, -1.509957990978376e-7f, r);
  const float z = r * r;
  float p = -2.5052108e-8f;
  p = fmaf(p, z, 2.7557319e-6f);
  p = fmaf(p, z, -1.9841270e-4f);
  p = fmaf(p, z, 8.3333333e-3f);
  p = fmaf(p, z, -1.6666667e-1f);
  const float sn = fmaf(r * z, p, r);
  return sn * sn;
}

// v[k] ← snake(v[k]) = v[k] + sin²(a[k]·v[k]) · inv[k] for K values a lane,
// in straight-line code; sinf takes over for the whole warp where any
// argument is beyond kSinFast. Every lane of the warp calls it.
template <int K>
__device__ inline void snake_many(float (&v)[K], const float (&a)[K], const float (&inv)[K]) {
  float t[K], s2[K];
  bool big = false;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    t[k] = a[k] * v[k];
    big |= !(fabsf(t[k]) <= kSinFast);
    s2[k] = sin_squared_fast(t[k]);
  }
  if (__any_sync(0xffffffffu, big)) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float sn = sinf(t[k]);
      s2[k] = sn * sn;
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] += s2[k] * inv[k];
}

__device__ inline unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// N bytes (4 or 16) global → shared, asynchronously: the first `bytes` of
// them from src, zeros for the rest (src is not read when bytes is 0)
template <int N>
__device__ inline void cp_async(float* dst, const float* src, int bytes) {
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(bytes)
                 : "memory");
}

__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Request slice `sl` of the weight — pw[co][sl·KC .. + KC) for every co —
// into `buf` as swizzled rows of KC floats; entries outside the C×C weight
// are zeros.
template <int CP, int KC, int THREADS>
__device__ inline void request_weight_slice(float* buf, const float* __restrict__ pw, int c,
                                            int sl, bool vec, int tid) {
  if (vec) {  // c % 4 == 0 and pw 16-byte aligned
    for (int i = tid; i < CP * (KC / 4); i += THREADS) {
      const int co = i / (KC / 4);
      const int unit = i % (KC / 4);
      const int ci = sl * KC + unit * 4;
      const bool ok = co < c && ci < c;
      cp_async<16>(buf + co * KC + (unit ^ weight_swizzle<KC>(co)) * 4,
                   ok ? pw + static_cast<long long>(co) * c + ci : pw, ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < CP * KC; i += THREADS) {
      const int co = i / KC;
      const int cil = i % KC;
      const int ci = sl * KC + cil;
      const bool ok = co < c && ci < c;
      cp_async<4>(buf + co * KC + ((cil / 4) ^ weight_swizzle<KC>(co)) * 4 + cil % 4,
                  ok ? pw + static_cast<long long>(co) * c + ci : pw, ok ? 4 : 0);
    }
  }
}

template <int CP>
__global__ void __launch_bounds__(Tiling<CP>::kThreads, CP == 512 ? 1 : 2)
residual_unit_kernel(const float* __restrict__ x, const int* __restrict__ valid,
                     const float* __restrict__ alpha1, const float* __restrict__ dw,
                     const float* __restrict__ dwb, const float* __restrict__ alpha2,
                     const float* __restrict__ pw, const float* __restrict__ pwb,
                     float* __restrict__ out, int t_len, int c, int dil, long long sb,
                     long long st, long long sc, int vec_w, int vec_io) {
  using TL = Tiling<CP>;
  constexpr int THREADS = TL::kThreads;
  constexpr int WARPS = TL::kWarps;
  constexpr int TT = TL::kTT;
  constexpr int NT = TL::kNT;
  constexpr int KC = TL::kKC;
  constexpr int NST = TL::kStages;
  constexpr int R = TL::kRows;
  constexpr int XW = TL::kXw;
  extern __shared__ __align__(16) float smem[];
  float* y_s = smem;                  // (CP, TT): y2, channel-major
  float* w_s = y_s + kTileElems;      // NST × (CP, KC): weight slices [co][ci], swizzled
  float* x_s = w_s + NST * CP * KC;   // per warp kXStages × (R, TT + 6·dil): x, then snake1(x)
  float* a_s = x_s + WARPS * kXStages * XW;  // (kParams, CP): per-channel constants

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TT;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* xb = x + static_cast<long long>(b) * sb;
  float* ob = out + static_cast<long long>(b) * sb;
  const int nsl = (c + KC - 1) / KC;  // weight slices that hold channels

  // the first slices of the weight land while stage 1 runs
#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < nsl)
      request_weight_slice<CP, KC, THREADS>(w_s + s * CP * KC, pw, c, s, vec_w, tid);
    cp_async_commit();
  }

  // stage 1: y2 = snake2(depthwise(snake1(x)) + dw_b). Every warp walks its
  // own groups of R channels through its own ring of staging buffers, with
  // no block barrier: the x of the next two groups (the tile and its ±3·dil
  // halo) is on its way by cp.async while this group's snake1 is applied in
  // place and its taps are read from there.
  {
    const int halo = 3 * dil;
    const int cols = TT + 2 * halo;  // >= 32
    const int ngroups = nsl * KC / R;  // stage 2 reads no channel past nsl·KC
    float* xw = x_s + warp * kXStages * XW;
    // A staging row holds the columns from t_first on, `rs` floats a row
    // (R·rs <= XW, the host checks); the tile's first halo column lies at
    // `shift`. Channel-first storage is requested 16 bytes at a time, so its
    // rows start at a multiple of 4 (4-byte requests keep the LSU busy for
    // longer than the sines take).
    const int shift = vec_io ? (t0 - halo) & 3 : 0;
    const int t_first = t0 - halo - shift;
    const int rs = vec_io ? (shift + cols + 3) / 4 * 4 : cols;
    const auto request_x = [&](int group, float* buf) {
      if (vec_io) {
        const int units = rs / 4;
        for (int q = lane; q < R * units; q += 32) {
          const int r = R == 2 && q >= units ? 1 : 0;
          const int u = q - r * units;
          const int ch = group * R + r;
          const int t = t_first + 4 * u;
          const int bytes = ch < c && t >= 0 ? min(16, max(0, 4 * (t_len - t))) : 0;
          cp_async<16>(buf + r * rs + 4 * u,
                       bytes ? xb + static_cast<long long>(ch) * sc + t : xb, bytes);
        }
      } else {
        for (int i = lane; i < R * cols; i += 32) {
          const int r = R == 2 && i >= cols ? 1 : 0;
          const int ch = group * R + r;
          const int t = t_first + i - r * cols;
          const bool ok = ch < c && t >= 0 && t < t_len;
          cp_async<4>(buf + i, ok ? xb + t * st + ch * sc : xb, ok ? 4 : 0);
        }
      }
    };
#pragma unroll
    for (int s = 0; s < kXStages - 1; ++s) {
      if (warp + WARPS * s < ngroups) request_x(warp + WARPS * s, xw + s * XW);
      cp_async_commit();
    }
    // a padded channel gets alpha 1 and taps and bias 0, so its y2 is 0
    for (int ch = tid; ch < CP; ch += THREADS) {
      const bool live = ch < c;
      const float a1 = live ? alpha1[ch] : 1.f;
      const float a2 = live ? alpha2[ch] : 1.f;
      a_s[ch] = a1;
      a_s[CP + ch] = 1.f / (a1 + 1e-9f);
      a_s[2 * CP + ch] = a2;
      a_s[3 * CP + ch] = 1.f / (a2 + 1e-9f);
      a_s[4 * CP + ch] = live ? dwb[ch] : 0.f;
#pragma unroll
      for (int kk = 0; kk < 7; ++kk) a_s[(5 + kk) * CP + ch] = live ? dw[ch * 7 + kk] : 0.f;
    }
    __syncthreads();
    int k = 0;
    for (int group = warp; group < ngroups; group += WARPS, ++k) {
      const int ahead = group + WARPS * (kXStages - 1);
      if (ahead < ngroups) request_x(ahead, xw + (k + kXStages - 1) % kXStages * XW);
      cp_async_commit();
      cp_async_wait<kXStages - 1>();  // this group's x has landed: each lane's own requests,
      __syncwarp();                   // and behind the barrier the other lanes' too
      float* xs = xw + k % kXStages * XW;
      // snake1 in place, four elements a lane at a time; columns outside
      // [0, T) hold zeros and stay zeros
      float a1g[R], i1g[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        a1g[r] = a_s[group * R + r];
        i1g[r] = a_s[CP + group * R + r];
      }
      for (int base0 = 0; base0 < R * rs; base0 += 128) {  // uniform over the warp
        const int base = base0 + lane;
        float v[4], a1[4], i1[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = base + 32 * e;
          const int r = R == 2 && i >= rs ? 1 : 0;
          v[e] = i < R * rs ? xs[i] : 0.f;
          a1[e] = r ? a1g[R - 1] : a1g[0];
          i1[e] = r ? i1g[R - 1] : i1g[0];
        }
        snake_many<4>(v, a1, i1);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (base + 32 * e < R * rs) xs[base + 32 * e] = v[e];
      }
      __syncwarp();
      // the seven taps and snake2, lanes along time, the group's R·TT/32
      // outputs of a lane together
      {
        constexpr int M = TT / 32;
        float y2[R * M], a2[R * M], i2[R * M];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int ch = group * R + r;
          float tap[7];
#pragma unroll
          for (int kk = 0; kk < 7; ++kk) tap[kk] = a_s[(5 + kk) * CP + ch];
          const float bias = a_s[4 * CP + ch];
          const float a2r = a_s[2 * CP + ch];
          const float i2r = a_s[3 * CP + ch];
          const float* xr = xs + r * rs + shift + lane;
#pragma unroll
          for (int m = 0; m < M; ++m) {
            float acc = 0.f;
#pragma unroll
            for (int kk = 0; kk < 7; ++kk) acc += tap[kk] * xr[32 * m + kk * dil];
            y2[r * M + m] = acc + bias;
            a2[r * M + m] = a2r;
            i2[r * M + m] = i2r;
          }
        }
        snake_many<R * M>(y2, a2, i2);
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int m = 0; m < M; ++m)
            y_s[(group * R + r) * TT + 32 * m + lane] =
                t0 + 32 * m + lane < t_len ? y2[r * M + m] : 0.f;
      }
      __syncwarp();  // this buffer is requested again in the warp's next step
    }
  }

  // stage 2: out[co, t] = x[co, t] + (Σ_ci pw[co, ci] · y2[ci, t] + pw_b[co]).
  // A warp is 8 channel lanes × 4 time lanes; a thread owns channels
  // co_base + 8·j and time steps t_base + {0..3} (and t_base + 16 + {0..3}
  // where NT is 8).
  constexpr int kWarpsCo = CP / 64;
  const int co_base = (warp % kWarpsCo) * 64 + (lane & 7);
  const int t_base = (warp / kWarpsCo) * (4 * NT) + (lane >> 3) * 4;
  const int swz = weight_swizzle<KC>(co_base);
  float acc[8][NT];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < NT; ++e) acc[j][e] = 0.f;

  for (int sl = 0; sl < nsl; ++sl) {
    // slice sl has landed; behind the barrier every thread sees all of it
    // (and, the first time, all of y2), and nobody still multiplies slice
    // sl - 1, whose buffer is requested next
    cp_async_wait<NST - 2>();
    __syncthreads();
    if (sl + NST - 1 < nsl)
      request_weight_slice<CP, KC, THREADS>(w_s + ((sl + NST - 1) % NST) * CP * KC, pw, c,
                                            sl + NST - 1, vec_w, tid);
    cp_async_commit();
    const float* wr = w_s + (sl % NST) * CP * KC + co_base * KC;
    const float* yr = y_s + sl * KC * TT + t_base;
#pragma unroll
    for (int k4 = 0; k4 < KC; k4 += 4) {
      float4 a[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        a[j] = *reinterpret_cast<const float4*>(wr + j * 8 * KC + ((k4 / 4) ^ swz) * 4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float y[NT];
#pragma unroll
        for (int h = 0; h < NT / 4; ++h) {
          const float4 v = *reinterpret_cast<const float4*>(yr + (k4 + kk) * TT + 16 * h);
          y[4 * h] = v.x;
          y[4 * h + 1] = v.y;
          y[4 * h + 2] = v.z;
          y[4 * h + 3] = v.w;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float av = kk == 0 ? a[j].x : kk == 1 ? a[j].y : kk == 2 ? a[j].z : a[j].w;
#pragma unroll
          for (int e = 0; e < NT; ++e) acc[j][e] += av * y[e];
        }
      }
    }
  }

  // epilogue: bias, residual, valid-length mask
  const int vlen = valid[b];
  if (vec_io && c == CP && t0 + TT <= t_len) {
    // a whole tile of channel-first storage: four time steps are 16 bytes;
    // the residual of four channels is requested before any of it is used
#pragma unroll
    for (int j0 = 0; j0 < 8; j0 += 4) {
      float4 xv[4][NT / 4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < NT / 4; ++h)
          xv[j][h] = *reinterpret_cast<const float4*>(
              xb + static_cast<long long>(co_base + 8 * (j0 + j)) * sc + t0 + t_base + 16 * h);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int co = co_base + 8 * (j0 + j);
        const float bias = pwb[co];
#pragma unroll
        for (int h = 0; h < NT / 4; ++h) {
          const int t = t0 + t_base + 16 * h;
          const float* av = acc[j0 + j] + 4 * h;
          float4 r;
          r.x = t < vlen ? xv[j][h].x + (av[0] + bias) : 0.f;
          r.y = t + 1 < vlen ? xv[j][h].y + (av[1] + bias) : 0.f;
          r.z = t + 2 < vlen ? xv[j][h].z + (av[2] + bias) : 0.f;
          r.w = t + 3 < vlen ? xv[j][h].w + (av[3] + bias) : 0.f;
          *reinterpret_cast<float4*>(ob + static_cast<long long>(co) * sc + t) = r;
        }
      }
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int co = co_base + 8 * j;
    if (co >= c) continue;
    const float bias = pwb[co];
#pragma unroll
    for (int e = 0; e < NT; ++e) {
      const int t = t0 + t_base + 16 * (e / 4) + e % 4;
      if (t < t_len) {
        const long long off = t * st + co * sc;
        ob[off] = t < vlen ? xb[off] + (acc[j][e] + bias) : 0.f;
      }
    }
  }
}

template <int CP>
int launch_unit(const float* x, const int* valid, const float* alpha1, const float* dw,
                const float* dwb, const float* alpha2, const float* pw, const float* pwb,
                float* out, int b, int t_len, int c, int dil, long long sb, long long st,
                long long sc, cudaStream_t stream) {
  using TL = Tiling<CP>;
  constexpr int kSmem = TL::kSmemFloats * static_cast<int>(sizeof(float));
  static_assert(kSmem <= 232448 && (CP == 512 || 2 * (kSmem + 1024) <= 233472),
                "shared memory of one block at CP 512, of two on an SM below");
  if (dil > TL::kMaxDilation) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = residual_unit_kernel<CP>;
  {  // more than 48 KB of dynamic shared memory: allowed once per device and process
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
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int vec_w = c % 4 == 0 && aligned(pw);
  const int vec_io = st == 1 && sc % 4 == 0 && sb % 4 == 0 && aligned(x) && aligned(out);
  const dim3 grid((t_len + TL::kTT - 1) / TL::kTT, b);
  kernel<<<grid, TL::kThreads, kSmem, stream>>>(x, valid, alpha1, dw, dwb, alpha2, pw, pwb,
                                                out, t_len, c, dil, sb, st, sc, vec_w, vec_io);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The widest dilation a unit of c channels may have: a warp's staging buffer
// holds the tile and its halo.
extern "C" int tts_fused_residual_unit_max_dilation(int c) {
  return c <= 64    ? Tiling<64>::kMaxDilation
         : c <= 128 ? Tiling<128>::kMaxDilation
         : c <= 256 ? Tiling<256>::kMaxDilation
                    : Tiling<512>::kMaxDilation;
}

// Returns the launch's cudaError_t. Strides are in elements, shared by x and out.
extern "C" int tts_fused_residual_unit(const void* x, const void* valid, const void* alpha1,
                                       const void* dw, const void* dwb, const void* alpha2,
                                       const void* pw, const void* pwb, void* out, int b,
                                       int t_len, int c, int dil, long long sb, long long st,
                                       long long sc, void* stream) {
  if (b < 1 || t_len < 1 || c < 1 || c > kMaxChannels || dil < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto launch = [&](auto fn) {
    return fn(static_cast<const float*>(x), static_cast<const int*>(valid),
              static_cast<const float*>(alpha1), static_cast<const float*>(dw),
              static_cast<const float*>(dwb), static_cast<const float*>(alpha2),
              static_cast<const float*>(pw), static_cast<const float*>(pwb),
              static_cast<float*>(out), b, t_len, c, dil, sb, st, sc,
              static_cast<cudaStream_t>(stream));
  };
  if (c <= 64) return launch(launch_unit<64>);
  if (c <= 128) return launch(launch_unit<128>);
  if (c <= 256) return launch(launch_unit<256>);
  return launch(launch_unit<512>);
}

// ---------------------------------------------------------------------------
// K6 in bf16 (`--vocoder-bf16`): the 16-bit body of vocoder16.cuh, with its
// note; vocoder_f16.cu holds its float16 instance.

#include "vocoder16.cuh"

// The widest dilation the 16-bit body's ring holds; it is built for SNAC's
// dilations 1, 3 and 9 (a template parameter), and refuses the others.
extern "C" int tts_fused_residual_unit_bf16_max_dilation(int c) { return c > 0 ? 9 : 0; }

// bf16 x, parameters and output; strides in elements, shared by x and out;
// `seg`, `blocks`, `paths`: the wrapper's plan (ops/vocoder.py::plan16).
// Returns the launch's cudaError_t.
extern "C" int tts_fused_residual_unit_bf16(const void* x, const void* valid, const void* alpha1,
                                            const void* dw, const void* dwb, const void* alpha2,
                                            const void* pw, const void* pwb, void* out, int b,
                                            int t_len, int c, int dil, long long sb,
                                            long long st, long long sc, int seg, int blocks,
                                            int paths, void* stream) {
  return fused_residual_unit16<__nv_bfloat16>(x, valid, alpha1, dw, dwb, alpha2, pw, pwb, out, b,
                                              t_len, c, dil, sb, st, sc, seg, blocks, paths,
                                              stream);
}
