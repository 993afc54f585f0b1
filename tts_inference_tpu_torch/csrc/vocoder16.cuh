// K6 in 16 bits: one fused SNAC residual unit over bf16 or float16
// activations and parameters, for Hopper (sm_90a). One body, two types:
// vocoder.cu instantiates it for bf16 (`--vocoder-bf16`, SnacConfig.dtype
// "bfloat16"), vocoder_f16.cu for float16 (SnacConfig.dtype "float16").
//
// Replaces tts_inference_tpu/ops/pallas/vocoder.py::fused_residual_unit in
// the dtype of x (Pallas bodies `_unit_kernel` / `_unit_kernel_single`:
// every elementwise step in the dtype of x, the pointwise product summed in
// f32, `preferred_element_type=f32`):
//
//   out = x + (pw · snake2(dw ⊛_dil snake1(x) + dw_b) + pw_b),  rows t >= valid[b] -> 0
//
// Arithmetic: x and the parameters are widened exactly; snake1, the seven
// taps with their bias and snake2 run in f32; y2 is rounded once to the
// 16-bit type, the operand of the tensor cores; the C×C product runs on the
// tensor cores (`wgmma` m64nNk16, f32 sums) onto an accumulator that starts
// at x + pw_b; the valid-length mask and one rounding on the way out.
//
// What bounds it on the H100: at C 64–256 the bytes (x in and out, 4 bytes
// an element: 10–20 µs a unit of an 8-row, 16-frame call) and, nearly as
// much, the instruction issue of stage 1 — two sines, seven taps and two
// snakes an element, ~28 f32 instructions and 2 SFU operations, 15 µs of
// issue at C 128; at C 512 the operations of the product (256 per byte,
// under the card's ~295) and the 512 KB weight, which every tile needs.
// The earlier bf16 body (one block per tile, mma.sync) reached 13% of that
// bound: stage 1 kept ~8–16 KB in flight an SM, its sines took ~11 f32
// instructions each, the product waited for stage 1 in every block, the
// weight came through L1 in fragments, one k-step ahead, and the epilogue
// read x again. The design:
//  - persistent blocks walk (row, tile) items; a tile is S segments of L
//    time steps (L chosen by the wrapper to fill the card), a block one SM;
//  - x comes by the copy engine (TMA, a 3-d map over (T, C, B), boxes of
//    32 time steps × up to 256 channels in the 64-byte swizzle) into a ring
//    of NS slots of 32 time steps for every segment (from 32 steps before
//    the segment: the halo, and a product step of J 4 chunks is one
//    slot), counted in on one mbarrier a slot; slots are requested as they
//    free up at the step barriers, two to four ahead of use, the next
//    item's while this one's last products run. A slot stays until the
//    residual of its time steps has been taken: x is read from device
//    memory once. At C 64 / 128 the epilogue then writes the outputs over
//    their x in the slot and the copy engine stores them (64-byte rows, as
//    they came), the slot kept one step longer;
//  - stage 1 runs lanes along channels: a lane owns one channel of one
//    segment and walks its time steps 8 at a time (one 16-byte shared load,
//    conflict-free in the swizzle), keeping snake1 of the window the taps
//    need (the chunk, ±3·dilation) in registers — a ring whose positions
//    are compile-time (the dilation is a template parameter: SNAC's 1, 3,
//    9), so no tap reads shared memory and snake1 is computed once per
//    element and halo;
//  - the sines go to the SFU: sin² has period π, so t is reduced to
//    r = t − jπ ∈ [−π/2, π/2] (j by the 1.5·2^23 rounding trick, r by the
//    same three-step Cody–Waite as the f32 kernel) and sin r is `__sinf`
//    (MUFU.SIN, ~4e-7 absolute): 7 f32 instructions and 1 SFU operation a
//    sine instead of ~11 f32. An argument beyond 8192 takes sinf for that
//    element alone, so every value depends on its own argument only;
//  - y2 goes to shared memory in the K-major 128-byte swizzle of `wgmma`
//    (rows = time steps, 64 channels a row; a warp's 32 lanes write 64
//    contiguous bytes); after J chunks of every segment the block meets
//    once, takes the residual into the accumulators (x + pw_b, from the
//    slot), and each warpgroup issues its `wgmma`s over the whole K, in
//    steps of 16 input channels ascending, the weight (A) and y2 (B) both
//    from shared memory, and goes on with the next step's stage 1 while the
//    tensor cores run; the epilogue (mask, round, store) follows one step
//    later. y2 is double-buffered; one block barrier a step;
//  - the weight: at C <= 256 it is loaded once per block (TMA boxes of 64
//    input channels × C rows in the 128-byte swizzle) and stays; at C 512
//    (512 KB) two blocks share a tile, each owning 256 output channels, and
//    its k-slices (64 input channels × 256 rows) stream through two
//    buffers by TMA, one block barrier a slice;
//  - what a tensor map cannot describe (channel-last x, a stride or a start
//    off 16 bytes, T no multiple of 8, fewer channels than the tile, and
//    the first and last 32 time steps of a row, which would reach outside
//    [0, T)) is gathered by the block's threads into the same slots with
//    zeros outside (snake(0) == 0: the reference's zero padding), and
//    counted in on the same mbarriers. (`cp.async` has no 2-byte request,
//    and these layouts give no aligned 4-byte pairs.)
// Each output's sum runs over the input channels in steps of 16 in one
// order, onto x + pw_b, whatever the tile or the length T, so a windowed
// decode equals a batch decode wherever the rest of the stack does.
//
// Measured (PERF.md, section 6): at C 64 / 128 the memory skeleton (loads,
// barriers, epilogue and stores: ~41–46 µs a unit) and stage 1 (~35 µs)
// still add up rather than overlap; at C 512 the weight's streaming per
// product step takes half the unit.
//
// Probe switches (tools/vocoder_probe.py; wrong results, the time of what
// is left): K6_NO_STAGE1 skips the snakes and taps, K6_NO_PRODUCT the
// `wgmma`s, K6_NO_EPILOGUE the outputs.

#pragma once

#include "hopper.cuh"

namespace {

constexpr int kMaxChannels16 = 512;

constexpr float kSinFast16 = 8192.f;

// Per padded channel count CP: the warps of a segment (32 channels each) and
// the segments S of a tile; J, the 8-step chunks of a segment per product
// step (Nq = S·8·J rows of y2); MB, the output channels of a block (C 512:
// two blocks share a tile); the x slots NS of the ring (enough for every
// dilation, segment length and item change: the ring never waits on itself).
// Registers: the ring holds (2·⌈3·dil/8⌉ + J)·8 floats, at most 96 (J 4,
// dil 9) for 8 warps of up to 255 registers, 80 at C 512 for 16 warps of 128.
template <int CP>
struct Cfg16 {
  static constexpr int kNC = CP / 32;
  static constexpr int kS = CP == 64 ? 4 : CP == 128 ? 2 : 1;
  static constexpr int kWarps = kNC * kS;   // 8, 8, 8, 16
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kJ = CP == 512 ? 2 : 4;
  static constexpr int kNq = kS * 8 * kJ;   // 128, 64, 32, 16
  static constexpr int kMB = CP == 512 ? 256 : CP;
  static constexpr int kSplit = CP / kMB;
  static constexpr bool kStream = CP == 512;
  static constexpr int kNK = CP / 64;       // k-slices of 64 input channels
  static constexpr int kWG = kWarps / 4;
  static constexpr int kMT = kMB / 64;      // m-tiles of 64 output channels
  static constexpr int kMTW = kMT >= kWG ? kMT / kWG : 1;          // of a warpgroup
  static constexpr int kNW = kMT >= kWG ? kNq : kNq * kMT / kWG;   // columns of a warpgroup
  static constexpr int kNS = CP >= 256 ? 4 : 6;
  // the epilogue writes a step's outputs over their x in the slot and the
  // copy engine stores them (a step is one slot: J 4), where the ring holds
  // the slot one step longer (NS 6)
  static constexpr bool kStoreTMA = kJ == 4 && kNS >= 6;
  static constexpr int kBoxC = CP < 256 ? CP : 256;  // channels of an x box
  static constexpr int kSlot = kS * CP * 64;         // 32 time steps of every segment
  static constexpr int kY2 = kNq * CP * 2;
  static constexpr int kWSlice = 64 * kMB * 2;
  static constexpr int kWS = kStream ? 2 : 1;   // weight buffers (C 512: k-slices in flight)
  static constexpr int kWBytes = kStream ? kWS * kWSlice : kNK * kWSlice;
  static constexpr int kSmem = kWBytes + 2 * kY2 + kNS * kSlot + 1024;  // 1024: alignment
  static_assert(kSmem <= 232448 - 256, "one block an SM");
  static_assert(!kStream || kMTW == 1, "a streamed slice feeds one m-tile a warpgroup");
  static_assert(kSlot % 1024 == 0 && kY2 % 1024 == 0 && kWSlice % 1024 == 0,
                "every region starts on 1024 bytes: the swizzles go by the address");
};

template <typename T>
struct Bits16;

template <>
struct Bits16<__nv_bfloat16> {
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  __device__ static float lo(uint32_t w) { return __uint_as_float(w << 16); }
  __device__ static float hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }
  __device__ static float one(unsigned short h) {
    return __uint_as_float(static_cast<uint32_t>(h) << 16);
  }
  __device__ static uint32_t pack(float a, float b) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
};

template <>
struct Bits16<__half> {
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  __device__ static float lo(uint32_t w) {
    return __half2float(__ushort_as_half(static_cast<unsigned short>(w & 0xffffu)));
  }
  __device__ static float hi(uint32_t w) {
    return __half2float(__ushort_as_half(static_cast<unsigned short>(w >> 16)));
  }
  __device__ static float one(unsigned short h) { return __half2float(__ushort_as_half(h)); }
  __device__ static uint32_t pack(float a, float b) {
    const __half2 v = __floats2half2_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
};

__device__ __noinline__ float sin2_exact(float t) {
  const float s = sinf(t);
  return s * s;
}

// sin²(t) for |t| <= kSinFast16 (see the note above)
__device__ inline float sin2_sfu(float t) {
  const float j = fmaf(t, 0.318309886f, 12582912.f) - 12582912.f;
  float r = fmaf(j, -3.140625f, t);
  r = fmaf(j, -9.67502593994140625e-4f, r);
  r = fmaf(j, -1.509957990978376e-7f, r);
  const float s = __sinf(r);
  return s * s;
}

// v[k] ← snake(v[k]) = v[k] + sin²(a·v[k]) · inv for the 8 values of a chunk
__device__ inline void snake8(float (&v)[8], float a, float inv) {
  float t[8], s2[8];
  bool big = false;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    t[k] = a * v[k];
    s2[k] = sin2_sfu(t[k]);
    big |= !(fabsf(t[k]) <= kSinFast16);
  }
  if (big) {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (!(fabsf(t[k]) <= kSinFast16)) s2[k] = sin2_exact(t[k]);
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = fmaf(s2[k], inv, v[k]);
}

struct Unit16 {
  const void* x;
  const int* valid;
  const void* alpha1;
  const void* dw;
  const void* dwb;
  const void* alpha2;
  const void* pw;
  const void* pwb;
  void* out;
  int b, t_len, c;
  long long sb, st, sc;   // elements, shared by x and out
  int seg;                // time steps of a segment (a multiple of 32)
  int nt;                 // tiles of a row
  int items;              // rows × tiles
  int x_tma, w_tma;       // x / the weight by the copy engine (else gathered)
  int out_tma;            // whole output blocks stored by the copy engine
  int vec_out;            // output pairs as 4-byte stores
};

template <typename T, int CP, int D>
__global__ void __launch_bounds__(Cfg16<CP>::kThreads, 1)
    unit16_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap wmap,
                  const __grid_constant__ CUtensorMap omap, const Unit16 a) {
  using C = Cfg16<CP>;
  using B16 = Bits16<T>;
  constexpr int HC = (3 * D + 7) / 8;   // chunks of halo on each side
  constexpr int J = C::kJ;
  constexpr int R = 2 * HC + J;         // chunks in the ring
  constexpr int S = C::kS;
  constexpr int NS = C::kNS;
  constexpr int THREADS = C::kThreads;
  constexpr int MB = C::kMB;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (shared_addr(smem_raw) & 1023)) & 1023);
  unsigned char* w_s = smem;                    // the weight (or two k-slices of it)
  unsigned char* y_s = w_s + C::kWBytes;        // two y2 buffers
  unsigned char* x_s = y_s + 2 * C::kY2;        // NS x slots
  __shared__ uint64_t xfull[NS];
  __shared__ uint64_t wfull[C::kWS];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int seg = warp / C::kNC;
  const int ch = (warp % C::kNC) * 32 + lane;   // the lane's channel in stage 1
  const int mpart = blockIdx.x % C::kSplit;
  const int bg = blockIdx.x / C::kSplit;
  const int nbg = gridDim.x / C::kSplit;
  const int L = a.seg;
  const int steps = L / (8 * J);
  const int nblk = L / 32 + 2;   // x blocks of 32 time steps an item reads, from t0 + s·L − 32
  const int nitems = bg < a.items ? (a.items - 1 - bg) / nbg + 1 : 0;
  const int nblocks = nitems * nblk;
  if (nitems == 0) return;
  const T* __restrict__ x = static_cast<const T*>(a.x);
  const T* __restrict__ pw = static_cast<const T*>(a.pw);
  T* __restrict__ out = static_cast<T*>(a.out);
  const auto ld16 = [](const T* p) { return __ldg(reinterpret_cast<const unsigned short*>(p)); };

  if (tid == 0) {
    for (int i = 0; i < NS; ++i) mbar_init(shared_addr(&xfull[i]), 1);
    for (int i = 0; i < C::kWS; ++i) mbar_init(shared_addr(&wfull[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The issue cursor: x block `issued` of this block's run is block cm of
  // item cg (row crow, tile start ct0); its 32 time steps start at
  // ct0 + s·L − 32 + 32·cm for segment s. Output chunk j of a segment is
  // load chunk j + 4: a product step of J 4 is one block.
  int issued = 0, cg = 0, cm = 0, crow = 0, ct0 = 0;
  const auto at_item = [&](int g) {
    const int item = bg + g * nbg;
    crow = item / a.nt;
    ct0 = (item % a.nt) * S * L;
  };
  at_item(0);
  const auto gather_x = [&](unsigned char* dst, int t_first) {   // every thread
    for (int i = tid; i < S * CP * 4; i += THREADS) {
      const int s = i / (CP * 4);
      const int r = (i >> 2) % CP;
      const int u = i & 3;
      const int t = t_first + s * L + 8 * u;
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (r < a.c) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int te = t + e;
          if (te >= 0 && te < a.t_len)
            w[e >> 1] |= static_cast<uint32_t>(ld16(x + crow * a.sb + te * a.st + r * a.sc))
                         << (16 * (e & 1));
        }
      }
      *reinterpret_cast<uint4*>(dst + s * CP * 64 + r * 64 + ((u ^ ((r >> 1) & 3)) << 4)) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
  };
  // Request the x blocks below `limit`: by the copy engine where all of the
  // block lies inside [0, T), else gathered by every thread (and then
  // counted in by thread 0 on the same barrier).
  const auto refill = [&](int limit) {
    const int end = min(nblocks, limit);
    unsigned gathered = 0;   // bit i: block issued + i
    for (int G = issued; G < end; ++G) {
      const int t_first = ct0 - 32 + 32 * cm;
      unsigned char* dst = x_s + (G % NS) * C::kSlot;
      if (a.x_tma && t_first >= 0 && t_first + (S - 1) * L + 32 <= a.t_len) {
        if (tid == 0) {
          const uint32_t bar = shared_addr(&xfull[G % NS]);
          mbar_expect_tx(bar, C::kSlot);
#pragma unroll
          for (int s = 0; s < S; ++s)
#pragma unroll
            for (int h = 0; h < CP / C::kBoxC; ++h)
              tma_box3(dst + s * CP * 64 + h * C::kBoxC * 64, &xmap, t_first + s * L,
                       h * C::kBoxC, crow, bar);
        }
      } else {
        gather_x(dst, t_first);
        gathered |= 1u << (G - issued);
      }
      if (++cm == nblk) {
        cm = 0;
        if (++cg < nitems) at_item(cg);
      }
    }
    if (gathered) {
      __syncthreads();
      if (tid == 0)
        for (int G = issued; G < end; ++G)
          if (gathered >> (G - issued) & 1) mbar_arrive(shared_addr(&xfull[G % NS]));
    }
    issued = end;
  };
  refill(NS);

  // the weight: rows mpart·MB + [0, MB), k-slices of 64 input channels
  const auto gather_w = [&](int kb, unsigned char* dst) {   // every thread
    for (int i = tid; i < MB * 8; i += THREADS) {
      const int r = i >> 3;
      const int u = i & 7;
      const int co = mpart * MB + r;
      const int ci0 = kb * 64 + 8 * u;
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (co < a.c) {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (ci0 + e < a.c)
            w[e >> 1] |= static_cast<uint32_t>(ld16(pw + static_cast<long long>(co) * a.c + ci0 + e))
                         << (16 * (e & 1));
      }
      *reinterpret_cast<uint4*>(dst + r * 128 + ((u ^ (r & 7)) << 4)) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
  };
  const int total_w = C::kStream ? C::kNK * steps * nitems : 0;   // k-slices streamed
  const auto request_w = [&](int sq) {   // streamed k-slice sq into buffer sq % kWS
    if (sq >= total_w) return;
    unsigned char* dst = w_s + (sq % C::kWS) * C::kWSlice;
    const uint32_t bar = shared_addr(&wfull[sq % C::kWS]);
    if (a.w_tma) {
      if (tid == 0) {
        mbar_expect_tx(bar, C::kWSlice);
        tma_box(dst, &wmap, (sq % C::kNK) * 64, mpart * MB, bar);
      }
    } else {
      gather_w(sq % C::kNK, dst);
      fence_proxy_async();
      __syncthreads();
      if (tid == 0) mbar_arrive(bar);
    }
  };
#ifndef K6_NO_PRODUCT   // (a probe build that multiplies nothing loads no weight)
  if constexpr (C::kStream) {
    for (int sq = 0; sq < C::kWS; ++sq) request_w(sq);
  } else if (a.w_tma) {
    if (tid == 0) {
      const uint32_t bar = shared_addr(&wfull[0]);
      mbar_expect_tx(bar, C::kWBytes);
#pragma unroll
      for (int kb = 0; kb < C::kNK; ++kb)
        tma_box(w_s + kb * C::kWSlice, &wmap, kb * 64, mpart * MB, bar);
    }
  } else {
#pragma unroll
    for (int kb = 0; kb < C::kNK; ++kb) gather_w(kb, w_s + kb * C::kWSlice);
    fence_proxy_async();
    __syncthreads();
    if (tid == 0) mbar_arrive(shared_addr(&wfull[0]));
  }
#endif

  // stage 1's constants of the lane's channel: a padded channel gets alpha 1
  // and taps and bias 0, so its y2 is 0
  float a1 = 1.f, a2 = 1.f, bias = 0.f, tap[7];
#pragma unroll
  for (int k = 0; k < 7; ++k) tap[k] = 0.f;
  if (ch < a.c) {
    a1 = B16::one(ld16(static_cast<const T*>(a.alpha1) + ch));
    a2 = B16::one(ld16(static_cast<const T*>(a.alpha2) + ch));
    bias = B16::one(ld16(static_cast<const T*>(a.dwb) + ch));
#pragma unroll
    for (int k = 0; k < 7; ++k) tap[k] = B16::one(ld16(static_cast<const T*>(a.dw) + ch * 7 + k));
  }
  const float i1 = 1.f / (a1 + 1e-9f);
  const float i2 = 1.f / (a2 + 1e-9f);

  // the product's fragments: warpgroup wg owns m-tiles mt0 + [0, kMTW) and
  // y2 columns n0w + [0, kNW); a thread holds rows 16·wq + g8 (+ 8) of an
  // m-tile and columns 8·j + 2·tg (+ 1)
  const int wg = warp >> 2;
  const int wq = warp & 3;
  const int g8 = lane >> 2;
  const int tg = lane & 3;
  constexpr int kPerMT = C::kMT >= C::kWG ? 1 : C::kWG / C::kMT;
  const int mt0 = C::kMT >= C::kWG ? wg * C::kMTW : wg / kPerMT;
  const int n0w = C::kMT >= C::kWG ? 0 : (wg % kPerMT) * C::kNW;
  float pbias[C::kMTW][2];
#pragma unroll
  for (int mt = 0; mt < C::kMTW; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int co = mpart * MB + (mt0 + mt) * 64 + wq * 16 + g8 + 8 * h;
      pbias[mt][h] = co < a.c ? B16::one(ld16(static_cast<const T*>(a.pwb) + co)) : 0.f;
    }

  float ring[R * 8];
  float acc[C::kMTW][C::kNW / 2];
  // the step whose epilogue is pending: its row, tile start, step, valid
  // length, and x block (its outputs' slot)
  int p_row = -1, p_t0 = 0, p_q = 0, p_vlen = 0, p_G = 0;
  bool p_slot = false;   // its outputs go to the slot and out by the copy engine
  int qg = 0;     // product steps so far: y2 buffer qg & 1
  int wseq = 0;   // streamed k-slices consumed

  // 8 values of load chunk k of this item (from G0) into v: widened, snake1
  const auto x_chunk = [&](int G0, int k, float (&v)[8]) {
    const int G = G0 + (k >> 2);
    const int slot = G % NS;
    if ((k & 3) == 0) mbar_wait(shared_addr(&xfull[slot]), (G / NS) & 1);
    const uint4 raw = *reinterpret_cast<const uint4*>(
        x_s + slot * C::kSlot + seg * CP * 64 + ch * 64 + (((k & 3) ^ ((ch >> 1) & 3)) << 4));
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = e & 1 ? B16::hi(w[e >> 1]) : B16::lo(w[e >> 1]);
#ifndef K6_NO_STAGE1
    snake8(v, a1, i1);
#endif
  };

  const auto epilogue = [&]() {
    const long long rowoff = static_cast<long long>(p_row) * a.sb;
    unsigned char* slot = x_s + (p_G % NS) * C::kSlot + 4 * tg;
#pragma unroll
    for (int mt = 0; mt < C::kMTW; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int co = mpart * MB + (mt0 + mt) * 64 + wq * 16 + g8 + 8 * h;
        if (co >= a.c) continue;
#pragma unroll
        for (int j = 0; j < C::kNW / 8; ++j) {
          const int n8 = n0w / 8 + j;
          const int t = p_t0 + (n8 / J) * L + (p_q * J + n8 % J) * 8 + 2 * tg;
          if (t >= a.t_len) continue;
          const float v0 = t < p_vlen ? acc[mt][4 * j + 2 * h] : 0.f;
          const float v1 = t + 1 < p_vlen ? acc[mt][4 * j + 2 * h + 1] : 0.f;
          const uint32_t pair = B16::pack(v0, v1);
          if (C::kStoreTMA && p_slot) {   // over the x it came from
            *reinterpret_cast<uint32_t*>(slot + (n8 / J) * CP * 64 + co * 64 +
                                         (((n8 % J) ^ ((co >> 1) & 3)) << 4)) = pair;
            continue;
          }
          T* o = out + rowoff + co * a.sc + t * a.st;
          if (a.vec_out && t + 1 < a.t_len) {
            *reinterpret_cast<uint32_t*>(o) = pair;
          } else {
            *reinterpret_cast<unsigned short*>(o) = static_cast<unsigned short>(pair & 0xffffu);
            if (t + 1 < a.t_len)
              *reinterpret_cast<unsigned short*>(o + a.st) = static_cast<unsigned short>(pair >> 16);
          }
        }
      }
  };

  // the pending step's output block by the copy engine (thread 0), and a
  // bulk group for it either way: the next step waits for all but the last
  const auto store_out = [&]() {
    if (tid != 0) return;
    if (p_slot) {
      const unsigned char* src = x_s + (p_G % NS) * C::kSlot;
#pragma unroll
      for (int s2 = 0; s2 < S; ++s2)
#pragma unroll
        for (int h = 0; h < CP / C::kBoxC; ++h)
          tma_store3(&omap, src + s2 * CP * 64 + h * C::kBoxC * 64, p_t0 + s2 * L + 32 * p_q,
                     h * C::kBoxC, p_row);
    }
    bulk_commit();
  };

  for (int g = 0; g < nitems; ++g) {
    const int item = bg + g * nbg;
    const int row = item / a.nt;
    const int t0 = (item % a.nt) * S * L;
    const int vlen = a.valid[row];
    const int G0 = g * nblk;
#pragma unroll
    for (int k = 0; k < 2 * HC; ++k) {   // load chunks 4 − HC .. 3 + HC
      float v[8];
      x_chunk(G0, 4 - HC + k, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) ring[8 * k + e] = v[e];
    }
    for (int q = 0; q < steps; ++q) {
#pragma unroll
      for (int jj = 0; jj < J; ++jj) {
        float v[8];
        x_chunk(G0, 4 + HC + q * J + jj, v);
#pragma unroll
        for (int e = 0; e < 8; ++e) ring[8 * (2 * HC + jj) + e] = v[e];
      }
      unsigned char* yb = y_s + (qg & 1) * C::kY2;
#ifndef K6_NO_STAGE1
      // the seven taps and snake2 of output chunks q·J + jj, into y2 rows
      // (seg·J + jj)·8 + e, column ch
#pragma unroll
      for (int jj = 0; jj < J; ++jj) {
        float y2[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float y = bias;
#pragma unroll
          for (int k = 0; k < 7; ++k) y = fmaf(tap[k], ring[(jj + HC) * 8 + e + (k - 3) * D], y);
          y2[e] = y;
        }
        snake8(y2, a2, i2);
        unsigned char* dst = yb + (ch >> 6) * (C::kNq * 128) + (seg * J + jj) * 8 * 128 + (ch & 7) * 2;
#pragma unroll
        for (int e = 0; e < 8; e += 2) {
          const uint32_t pair = B16::pack(y2[e], y2[e + 1]);
          *reinterpret_cast<unsigned short*>(dst + e * 128 + ((((ch & 63) >> 3) ^ e) << 4)) =
              static_cast<unsigned short>(pair & 0xffffu);
          *reinterpret_cast<unsigned short*>(dst + (e + 1) * 128 +
                                             ((((ch & 63) >> 3) ^ (e + 1)) << 4)) =
              static_cast<unsigned short>(pair >> 16);
        }
      }
#endif
#pragma unroll
      for (int i = 0; i < 2 * HC * 8; ++i) ring[i] = ring[i + J * 8];

      wgmma_wait0();   // the previous step's product (none before the first)
      reg_fence(acc);
#ifndef K6_NO_EPILOGUE
      if (p_row >= 0) epilogue();
#endif
      // the stores of earlier steps have read their slots
      if (C::kStoreTMA && tid == 0) bulk_wait_read0();
      fence_proxy_async();
      __syncthreads();
      if (C::kStoreTMA && p_row >= 0) store_out();
      {   // blocks before this step's residual are free; with the copy
          // engine's stores, only those before the block whose store just left
        int free = G0 + (q * J + (C::kStoreTMA ? 0 : 4)) / 4;
        if (C::kStoreTMA && p_row >= 0) free = min(free, p_G);
        refill(free + NS);
      }

      // the accumulators start at x + pw_b (the residual, from the slots)
#pragma unroll
      for (int j = 0; j < C::kNW / 8; ++j) {
        const int n8 = n0w / 8 + j;
        const int kx = q * J + n8 % J + 4;   // load chunk of these outputs
        const int G = G0 + (kx >> 2);
        const unsigned char* base = x_s + (G % NS) * C::kSlot + (n8 / J) * CP * 64 + 4 * tg;
#pragma unroll
        for (int mt = 0; mt < C::kMTW; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int co = mpart * MB + (mt0 + mt) * 64 + wq * 16 + g8 + 8 * h;
            const uint32_t w = *reinterpret_cast<const uint32_t*>(
                base + co * 64 + (((kx & 3) ^ ((co >> 1) & 3)) << 4));
            acc[mt][4 * j + 2 * h] = B16::lo(w) + pbias[mt][h];
            acc[mt][4 * j + 2 * h + 1] = B16::hi(w) + pbias[mt][h];
          }
      }
      reg_fence(acc);
#ifndef K6_NO_PRODUCT
      const uint32_t yaddr = shared_addr(yb) + n0w * 128;
      if constexpr (!C::kStream) {
        mbar_wait(shared_addr(&wfull[0]), 0);
        wgmma_fence();
#pragma unroll
        for (int kb = 0; kb < C::kNK; ++kb)
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
#pragma unroll
            for (int mt = 0; mt < C::kMTW; ++mt)
              wgmma_ss<C::kNW, T>(
                  acc[mt],
                  sw128_desc(shared_addr(w_s) + kb * C::kWSlice + (mt0 + mt) * 8192 + ks * 32),
                  sw128_desc(yaddr + kb * (C::kNq * 128) + ks * 32), 1);
        wgmma_commit();
      } else {
        for (int kb = 0; kb < C::kNK; ++kb, ++wseq) {
          mbar_wait(shared_addr(&wfull[wseq % C::kWS]), (wseq / C::kWS) & 1);
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
            wgmma_ss<C::kNW, T>(
                acc[0], sw128_desc(shared_addr(w_s) + (wseq % C::kWS) * C::kWSlice + mt0 * 8192 + ks * 32),
                sw128_desc(yaddr + kb * (C::kNq * 128) + ks * 32), 1);
          wgmma_commit();
          wgmma_wait0();
          reg_fence(acc);
          __syncthreads();   // every warpgroup is done with this buffer
          request_w(wseq + C::kWS);
        }
      }
#endif
      p_row = row;
      p_t0 = t0;
      p_q = q;
      p_vlen = vlen;
      p_G = G0 + q + 1;
      {   // all of the outputs' block lies inside [0, T)
        const int t_first = t0 + 32 * q;
        p_slot = a.out_tma && J == 4 && t_first >= 0 && t_first + (S - 1) * L + 32 <= a.t_len;
      }
      ++qg;
    }
    // every block of this item has been read (but the last step's, which
    // takes its outputs): the next item's may come
    __syncthreads();
    refill((C::kStoreTMA ? G0 + steps : G0 + nblk) + NS);
  }
  if (p_row >= 0) {
    wgmma_wait0();
    reg_fence(acc);
    epilogue();
    if (C::kStoreTMA) {
      fence_proxy_async();
      __syncthreads();
      store_out();
      if (tid == 0) bulk_wait0();
    }
  }
}

template <typename T, int CP, int D>
int launch_unit16(const Unit16& a, int blocks, cudaStream_t stream) {
  using C = Cfg16<CP>;
  auto kernel = unit16_kernel<T, CP, D>;
  {  // more than 48 KB of dynamic shared memory: allowed once per device and process
    static bool allowed[64] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
    if (!allowed[dev]) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
      if (err != cudaSuccess) return static_cast<int>(err);
      allowed[dev] = true;
    }
  }
  CUtensorMap xmap = {}, wmap = {}, omap = {};
  if (a.x_tma) {   // (T, C, B) of x, boxes of 32 time steps × kBoxC channels
    const long long dims[3] = {a.t_len, a.c, a.b};
    const long long pitches[2] = {2 * a.sc, 2 * a.sb};
    const int box[3] = {32, C::kBoxC, 1};
    if (!tensor_map(a.x, Bits16<T>::kMap, 3, dims, pitches, box, CU_TENSOR_MAP_SWIZZLE_64B, &xmap))
      return static_cast<int>(cudaErrorInvalidValue);
    if (a.out_tma && !tensor_map(a.out, Bits16<T>::kMap, 3, dims, pitches, box,
                                 CU_TENSOR_MAP_SWIZZLE_64B, &omap))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a.w_tma) {   // (C, C) of the weight, boxes of 64 input channels × MB rows
    const long long dims[2] = {a.c, a.c};
    const long long pitch = 2ll * a.c;
    const int box[2] = {64, C::kMB};
    if (!tensor_map(a.pw, Bits16<T>::kMap, 2, dims, &pitch, box, CU_TENSOR_MAP_SWIZZLE_128B,
                    &wmap))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  kernel<<<blocks, C::kThreads, C::kSmem, stream>>>(xmap, wmap, omap, a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int CP>
int launch_unit16_dil(const Unit16& a, int dil, int blocks, cudaStream_t stream) {
  if (dil == 1) return launch_unit16<T, CP, 1>(a, blocks, stream);
  if (dil == 3) return launch_unit16<T, CP, 3>(a, blocks, stream);
  if (dil == 9) return launch_unit16<T, CP, 9>(a, blocks, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The entry of both types. `seg`: time steps of a segment; `blocks`: the
// grid; `paths`: bit 0 x by TMA, bit 1 the weight by TMA (the wrapper's
// plan, ops/vocoder.py). Returns the launch's cudaError_t.
template <typename T>
int fused_residual_unit16(const void* x, const void* valid, const void* alpha1, const void* dw,
                          const void* dwb, const void* alpha2, const void* pw, const void* pwb,
                          void* out, int b, int t_len, int c, int dil, long long sb, long long st,
                          long long sc, int seg, int blocks, int paths, void* stream) {
  if (b < 1 || t_len < 1 || c < 1 || c > kMaxChannels16 || seg < 32 || seg % 32 != 0 ||
      blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int cp = c <= 64 ? 64 : c <= 128 ? 128 : c <= 256 ? 256 : 512;
  const int split = cp == 512 ? Cfg16<512>::kSplit : 1;
  const int span = (cp == 64    ? Cfg16<64>::kS
                    : cp == 128 ? Cfg16<128>::kS
                    : cp == 256 ? Cfg16<256>::kS
                                : Cfg16<512>::kS) * seg;   // time steps of a tile
  Unit16 a;
  a.x = x;
  a.valid = static_cast<const int*>(valid);
  a.alpha1 = alpha1;
  a.dw = dw;
  a.dwb = dwb;
  a.alpha2 = alpha2;
  a.pw = pw;
  a.pwb = pwb;
  a.out = out;
  a.b = b;
  a.t_len = t_len;
  a.c = c;
  a.sb = sb;
  a.st = st;
  a.sc = sc;
  a.seg = seg;
  a.nt = (t_len + span - 1) / span;
  a.items = b * a.nt;
  a.x_tma = paths & 1;
  a.w_tma = (paths >> 1) & 1;
  const auto aligned = [](const void* p, int n) { return reinterpret_cast<uintptr_t>(p) % n == 0; };
  a.vec_out = st == 1 && sc % 2 == 0 && sb % 2 == 0 && aligned(out, 4);
  a.out_tma = a.x_tma && aligned(out, 16);   // out has x's strides
  if (blocks % split != 0) return static_cast<int>(cudaErrorInvalidValue);
  blocks = min(blocks, a.items * split);   // a block per item at most
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cp == 64) return launch_unit16_dil<T, 64>(a, dil, blocks, s);
  if (cp == 128) return launch_unit16_dil<T, 128>(a, dil, blocks, s);
  if (cp == 256) return launch_unit16_dil<T, 256>(a, dil, blocks, s);
  return launch_unit16_dil<T, 512>(a, dil, blocks, s);
}

}  // namespace
