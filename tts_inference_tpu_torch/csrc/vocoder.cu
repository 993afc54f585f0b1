// K6: one fused SNAC residual unit in f32, for Hopper (sm_90a).
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
// What bounds it on the H100: f32 arithmetic. The pointwise product is
// 2·C FLOPs per element against 8 bytes of activation traffic (C/4 FLOP per
// byte: 128 at C=512), and the snake evaluations add 8 sines per element.
// TF32 is ruled out by the vocoder's f32 parity, so the product runs on the
// CUDA cores, not the tensor cores.
//
// What the design does about it:
//  - one block per (row, tile of kT time steps) reads its tile plus a
//    ±3·dilation halo straight from device memory; halo taps outside [0, T)
//    are skipped, which equals the reference's zero padding since
//    snake(0) == 0 (the TPU kernel fetched neighbour slivers of HALO_BLOCK);
//  - the snake → depthwise → snake intermediate stays in shared memory
//    (C × kT floats, channel-major so the product reads it without bank
//    conflicts) and never goes to device memory;
//  - the pointwise product is a shared-memory tiled f32 FMA loop over
//    kKC-wide slices of the weight, each thread holding a 2×4 register tile;
//    bias, residual and the valid-length mask are applied in the epilogue;
//  - activations are addressed through explicit (b, t, c) strides, so the
//    channel-first tensors the port's decoder keeps for cuDNN are read and
//    written in place (time is the fast index of every load and store).
// Every output depends only on its own inputs, whatever the tiling, so a
// windowed streaming decode equals a batch decode wherever the rest of the
// stack does.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kT = 32;    // time steps per block (2 per thread row pair)
constexpr int kNC = 64;   // output channels per pass
constexpr int kKC = 32;   // input channels per shared-memory weight slice

__device__ inline float snake(float x, float a) {
  const float s = sinf(a * x);
  return x + s * s / (a + 1e-9f);
}

__global__ void __launch_bounds__(kThreads)
residual_unit_kernel(const float* __restrict__ x, const int* __restrict__ valid,
                     const float* __restrict__ alpha1, const float* __restrict__ dw,
                     const float* __restrict__ dwb, const float* __restrict__ alpha2,
                     const float* __restrict__ pw, const float* __restrict__ pwb,
                     float* __restrict__ out, int t_len, int c, int cp, int dil,
                     long long sb, long long st, long long sc) {
  extern __shared__ float smem[];
  float* y_s = smem;             // (cp, kT): y2 for the tile, channel-major
  float* w_s = y_s + cp * kT;    // (kKC, kNC + 1): weight slice [ci][co]

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kT;
  const int tid = threadIdx.x;
  const float* xb = x + static_cast<long long>(b) * sb;
  float* ob = out + static_cast<long long>(b) * sb;

  // stage 1: y2 = snake2(depthwise(snake1(x)) + dw_b) for the tile
  for (int i = tid; i < cp * kT; i += kThreads) {
    const int tl = i % kT;
    const int ch = i / kT;
    const int t = t0 + tl;
    float y2 = 0.f;
    if (t < t_len && ch < c) {
      const float a1 = alpha1[ch];
      float acc = 0.f;
#pragma unroll
      for (int kk = 0; kk < 7; ++kk) {
        const int tt = t + (kk - 3) * dil;
        if (tt >= 0 && tt < t_len)
          acc += dw[ch * 7 + kk] * snake(xb[tt * st + ch * sc], a1);
      }
      y2 = snake(acc + dwb[ch], alpha2[ch]);
    }
    y_s[ch * kT + tl] = y2;
  }
  __syncthreads();

  // stage 2: out[t, co] = x[t, co] + (Σ_ci y2[t, ci] · pw[co, ci] + pw_b[co])
  const int tr = tid % 16;   // rows tr and tr + 16 of the tile
  const int tc = tid / 16;   // columns tc*4 .. tc*4+3 of the kNC pass
  const int vlen = valid[b];
  for (int co0 = 0; co0 < c; co0 += kNC) {
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int ci0 = 0; ci0 < cp; ci0 += kKC) {
      for (int i = tid; i < kKC * kNC; i += kThreads) {
        const int cil = i % kKC;
        const int col = i / kKC;
        const int co = co0 + col;
        const int ci = ci0 + cil;
        w_s[cil * (kNC + 1) + col] =
            (co < c && ci < c) ? pw[static_cast<long long>(co) * c + ci] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int cil = 0; cil < kKC; ++cil) {
        const float* yr = y_s + (ci0 + cil) * kT;
        const float y0 = yr[tr];
        const float y1 = yr[tr + 16];
        const float* wr = w_s + cil * (kNC + 1) + tc * 4;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[0][j] += y0 * wr[j];
          acc[1][j] += y1 * wr[j];
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = t0 + tr + 16 * r;
      if (t >= t_len) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int co = co0 + tc * 4 + j;
        if (co < c) {
          const long long off = t * st + co * sc;
          ob[off] = t < vlen ? xb[off] + (acc[r][j] + pwb[co]) : 0.f;
        }
      }
    }
  }
}

}  // namespace

// Returns the launch's cudaError_t. Strides are in elements, shared by x and out.
extern "C" int tts_fused_residual_unit(const void* x, const void* valid, const void* alpha1,
                                       const void* dw, const void* dwb, const void* alpha2,
                                       const void* pw, const void* pwb, void* out, int b,
                                       int t_len, int c, int dil, long long sb, long long st,
                                       long long sc, void* stream) {
  if (b < 1 || t_len < 1 || c < 1 || dil < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int cp = (c + kKC - 1) / kKC * kKC;
  const size_t smem = (static_cast<size_t>(cp) * kT + kKC * (kNC + 1)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      residual_unit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((t_len + kT - 1) / kT, b);
  residual_unit_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(valid),
      static_cast<const float*>(alpha1), static_cast<const float*>(dw),
      static_cast<const float*>(dwb), static_cast<const float*>(alpha2),
      static_cast<const float*>(pw), static_cast<const float*>(pwb), static_cast<float*>(out),
      t_len, c, cp, dil, sb, st, sc);
  return static_cast<int>(cudaGetLastError());
}
