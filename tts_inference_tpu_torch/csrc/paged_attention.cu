// K3a / K3b / K5: paged GQA decode attention over a block pool, for Hopper
// (sm_90a); K3b reads int8 pools with per-row f32 scales, K5 int4 pools
// packed by head pair with per-row f32 scales in nibble planes.
//
// Replaces tts_inference_tpu/ops/pallas/paged_attention.py:
//   K3a paged_decode_attention      (pallas_call in _pallas_paged_attention,
//                                    body _make_kernel(m, quantized=False))
//   K3b paged_decode_attention_int8 (pallas_call in
//                                    _pallas_paged_attention_int8, body
//                                    _make_kernel(m, quantized=True))
// and tts_inference_tpu/ops/pallas/paged_attention_int4.py:
//   K5  paged_decode_attention_int4 (pallas_call in
//                                    _pallas_paged_attention_int4, body
//                                    _make_kernel(m))
// One decode query per slot attends to positions j <= pos[b] of its window;
// position j lives in pool row table[b, j / bs], offset j % bs. The TPU
// kernel walked the window in order with a grid of (slot, super-block of m
// pool blocks) and carried the running max / denominator in VMEM; here the
// blocks of a slot run in parallel and in no order, so the window is cut
// into chunks whose partial results are combined afterwards. Both bodies of
// attention.cuh are used: bf16 queries at D 64 or 128 run the tensor-core
// body `attention_mma` over all three pool kinds (as K1 does: it needs
// nothing of a key but a pointer to its row, which here goes through the
// block table, and, for integer rows, the row's scales; one launch); f32
// queries (the tiny configuration) and other head dims run the CUDA-core
// body `attention_chunk` + `attention_combine`, whose loads convert
// integers and apply scales.
//
// What bounds it on the H100: at long windows, device-memory bytes — each
// step reads the slot's K and V rows once (2·W·Hkv·D bytes at int8, half
// that at int4, twice that at bf16) at ~4·G FLOPs per byte, far below the
// ~295 FLOP/byte ridge; at short windows (W ≤ 512 at the serve shapes) the
// latency of those few loads and of the launch.
//
// What the design does about it:
//  - blocks of 64 or 128 positions, picked by the wrapper so that every SM
//    gets two to four (one block per slot, kv head or K5 head pair, and
//    chunk);
//  - each block reads its own table entries (the engine hands in
//    table[:, :WB], so the row stride is an argument); per block and head a
//    pool block `pool[row, h]` is one contiguous bs×D slab, so consecutive
//    keys are consecutive rows and every request is 16 bytes of a row;
//  - positions past pos[b] are never read, so chunks and pool blocks wholly
//    past pos cost nothing but an empty block. Unallocated table entries are
//    0 (the trash block) and lie past pos: masking is by position only;
//  - K3b's int8 rows go to the tensor cores as bf16, converted exactly in
//    the fragments; the k scale multiplies the score column after the q·k
//    dot and the v scale the probability row before p·v, as the TPU kernel
//    does — the int8 bytes are what move;
//  - K5 is a third key addressing: kv heads 2p and 2p+1 share pair slab p of
//    the (N, Hkv/2, bs, D) pools, head 2p in the low nibble (offset-encoded,
//    bits = q + 8), head 2p+1 in the high nibble (two's complement); their
//    scales lie in plane h % 2 of the (N, 2, Hkv/2, bs) scale pools. The
//    TPU kernel never extracted the low nibble and corrected its dots
//    afterwards; here one block per head pair reads each packed byte once
//    and takes both nibbles of it in registers, one chain of products per
//    head (the CUDA-core body takes a block per head and its nibble of each
//    byte).
// TMA, wgmma and fusing the table walk are later work.
//
// Layouts (elements): q, out (B, Hkv, G, D) contiguous; k, v pools
// (N, Hkv, bs, D) contiguous, K5 (N, Hkv/2, bs, D) int8; k, v scale pools
// (N, Hkv, bs) f32 contiguous, K5 (N, 2, Hkv/2, bs); table (B, ≥ WB) int32
// with row stride `table_stride`; pos (B,) int32.

#include "attention.cuh"

namespace {

template <typename E, bool Scaled>
struct PagedKeys {
  using Elem = E;
  static constexpr bool kScaled = Scaled;
  static constexpr int kPlanes = 1;
  struct Slot {
    const E* k;
    const E* v;
    const float* ks;
    const float* vs;
    const int* rows;  // the slot's table row
    int hkv, h, bs, d;
    // index of (pool row, head, offset) in the (N, Hkv, bs) row space
    __device__ size_t at(int j) const {
      return (static_cast<size_t>(rows[j / bs]) * hkv + h) * bs + (j % bs);
    }
    __device__ const E* key(int j) const { return k + at(j) * d; }
    __device__ const E* value(int j) const { return v + at(j) * d; }
    __device__ void read8(const E* p, float o[8]) const { load8(p, o); }
    __device__ void read4(const E* p, float o[4]) const { load4(p, o); }
    __device__ const float* ks_at(int j) const { return ks + at(j); }
    __device__ const float* vs_at(int j) const { return vs + at(j); }
    __device__ float key_scale(int j) const { return *ks_at(j); }
    __device__ float value_scale(int j) const { return *vs_at(j); }
  };
  const E* k;
  const E* v;
  const float* ks;
  const float* vs;
  const int* table;
  long long table_stride;
  int hkv, bs, d;
  __device__ Slot slot(int b, int h) const {
    return {k, v, ks, vs, table + static_cast<size_t>(b) * table_stride, hkv, h, bs, d};
  }
};

// K5: int4 pools packed by head pair. Head h reads pair slab h / 2 and the
// nibble h % 2 of each byte; its scales lie in plane h % 2.
struct PagedKeysInt4 {
  using Elem = int8_t;
  static constexpr bool kScaled = true;
  static constexpr int kPlanes = 2;  // the tensor-core body: one block per pair
  struct Slot {
    const int8_t* k;
    const int8_t* v;
    const float* ks;
    const float* vs;
    const int* rows;
    int p2, pair, plane, bs, d;
    int shift;  // 0: low nibble, 4: high nibble
    int flip;   // low: bits = q + 8; high: two's complement, so bits ^ 8 = q + 8
    // index of (pool row, pair, offset) in the (N, Hkv/2, bs) row space
    __device__ size_t at(int j) const {
      return (static_cast<size_t>(rows[j / bs]) * p2 + pair) * bs + (j % bs);
    }
    // index of (pool row, plane, pair, offset) in the scale pools
    __device__ size_t scale_at(int j) const {
      return ((static_cast<size_t>(rows[j / bs]) * 2 + plane) * p2 + pair) * bs + (j % bs);
    }
    __device__ const int8_t* key(int j) const { return k + at(j) * d; }
    __device__ const int8_t* value(int j) const { return v + at(j) * d; }
    __device__ void nibbles(unsigned int u, float o[4]) const {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        o[i] = static_cast<float>(static_cast<int>(((u >> (8 * i + shift)) & 15u) ^ flip) - 8);
    }
    __device__ void read8(const int8_t* p, float o[8]) const {
      const uint2 r = *reinterpret_cast<const uint2*>(p);
      nibbles(r.x, o);
      nibbles(r.y, o + 4);
    }
    __device__ void read4(const int8_t* p, float o[4]) const {
      nibbles(*reinterpret_cast<const unsigned int*>(p), o);
    }
    __device__ const float* ks_at(int j) const { return ks + scale_at(j); }
    __device__ const float* vs_at(int j) const { return vs + scale_at(j); }
    __device__ float key_scale(int j) const { return *ks_at(j); }
    __device__ float value_scale(int j) const { return *vs_at(j); }
  };
  const int8_t* k;
  const int8_t* v;
  const float* ks;
  const float* vs;
  const int* table;
  long long table_stride;
  int hkv, bs, d;
  __device__ Slot slot(int b, int h) const {
    const int hi = h & 1;
    return {k, v, ks, vs, table + static_cast<size_t>(b) * table_stride,
            hkv / 2, h / 2, hi, bs, d, hi ? 4 : 0, hi ? 8 : 0};
  }
};

template <typename T, typename E, bool Scaled>
int launch_paged(const void* q, const void* k, const void* v, const void* ks,
                 const void* vs, const void* table, long long table_stride,
                 const void* pos, void* out, void* scratch, int b, int hkv, int g, int d,
                 int bs, int wb, float scale, cudaStream_t s) {
  const PagedKeys<E, Scaled> keys{static_cast<const E*>(k),     static_cast<const E*>(v),
                                  static_cast<const float*>(ks), static_cast<const float*>(vs),
                                  static_cast<const int*>(table), table_stride,
                                  hkv, bs, d};
  return attention_launch<T>(q, keys, pos, out, scratch, b, hkv, g, d, wb * bs, scale, s);
}

}  // namespace

// All three entries: `chunk` is the wrapper's choice of keys per block
// (256 = the CUDA-core body; 64 or 128 = the tensor-core body, which all
// three take for bf16 queries at D 64 or 128); scratch: f32 B·Hkv·S·G·(D + 2)
// with S = ceil(wb·bs / chunk), needed when S > 1; counters: B·Hkv ints, 0
// before and after every launch (tensor-core body only).

// K3a. dtype of q, out and both pools: 0 = bfloat16, 1 = float32.
// Returns the launches' cudaError_t.
extern "C" int tts_paged_attention(const void* q, const void* k_pool, const void* v_pool,
                                   const void* table, long long table_stride,
                                   const void* pos, void* out, void* scratch,
                                   void* counters, int b, int hkv, int g, int d, int bs,
                                   int wb, int chunk, float scale, int dtype,
                                   void* stream) {
  if (!attention_shape_ok(b, hkv, g, d, wb * bs) || bs < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && attention_mma_takes(d, chunk)) {
    const PagedKeys<__nv_bfloat16, false> keys{static_cast<const __nv_bfloat16*>(k_pool),
                                               static_cast<const __nv_bfloat16*>(v_pool),
                                               nullptr,
                                               nullptr,
                                               static_cast<const int*>(table),
                                               table_stride,
                                               hkv,
                                               bs,
                                               d};
    return attention_mma_launch(q, keys, pos, out, scratch, counters, b, hkv, g, d, wb * bs,
                                chunk, scale, s);
  }
  if (chunk != kSplit) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch_paged<__nv_bfloat16, __nv_bfloat16, false>(
        q, k_pool, v_pool, nullptr, nullptr, table, table_stride, pos, out, scratch, b,
        hkv, g, d, bs, wb, scale, s);
  if (dtype == 1)
    return launch_paged<float, float, false>(q, k_pool, v_pool, nullptr, nullptr, table,
                                             table_stride, pos, out, scratch, b, hkv, g,
                                             d, bs, wb, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K3b: int8 pools with f32 scale pools. q_dtype of q and out: 0 = bfloat16,
// 1 = float32. Returns the launches' cudaError_t.
extern "C" int tts_paged_attention_int8(const void* q, const void* k_pool,
                                        const void* v_pool, const void* k_scale,
                                        const void* v_scale, const void* table,
                                        long long table_stride, const void* pos, void* out,
                                        void* scratch, void* counters, int b, int hkv, int g,
                                        int d, int bs, int wb, int chunk, float scale,
                                        int q_dtype, void* stream) {
  if (!attention_shape_ok(b, hkv, g, d, wb * bs) || bs < 1 || k_scale == nullptr ||
      v_scale == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && attention_mma_takes(d, chunk)) {
    const PagedKeys<int8_t, true> keys{static_cast<const int8_t*>(k_pool),
                                       static_cast<const int8_t*>(v_pool),
                                       static_cast<const float*>(k_scale),
                                       static_cast<const float*>(v_scale),
                                       static_cast<const int*>(table),
                                       table_stride,
                                       hkv,
                                       bs,
                                       d};
    return attention_mma_launch(q, keys, pos, out, scratch, counters, b, hkv, g, d, wb * bs,
                                chunk, scale, s);
  }
  if (chunk != kSplit) return static_cast<int>(cudaErrorInvalidValue);
  if (q_dtype == 0)
    return launch_paged<__nv_bfloat16, int8_t, true>(q, k_pool, v_pool, k_scale, v_scale,
                                                     table, table_stride, pos, out,
                                                     scratch, b, hkv, g, d, bs, wb, scale,
                                                     s);
  if (q_dtype == 1)
    return launch_paged<float, int8_t, true>(q, k_pool, v_pool, k_scale, v_scale, table,
                                             table_stride, pos, out, scratch, b, hkv, g, d,
                                             bs, wb, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K5: int4 pools (N, Hkv/2, bs, D) int8 with f32 scale pools (N, 2, Hkv/2, bs).
// q_dtype of q and out: 0 = bfloat16, 1 = float32. The tensor-core body runs
// one block per head pair; the CUDA-core body one per head. Returns the
// launches' cudaError_t.
extern "C" int tts_paged_attention_int4(const void* q, const void* k_pool,
                                        const void* v_pool, const void* k_scale,
                                        const void* v_scale, const void* table,
                                        long long table_stride, const void* pos, void* out,
                                        void* scratch, void* counters, int b, int hkv, int g,
                                        int d, int bs, int wb, int chunk, float scale,
                                        int q_dtype, void* stream) {
  if (!attention_shape_ok(b, hkv, g, d, wb * bs) || bs < 1 || hkv % 2 ||
      k_scale == nullptr || v_scale == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const PagedKeysInt4 keys{static_cast<const int8_t*>(k_pool),
                           static_cast<const int8_t*>(v_pool),
                           static_cast<const float*>(k_scale),
                           static_cast<const float*>(v_scale),
                           static_cast<const int*>(table), table_stride, hkv, bs, d};
  if (q_dtype == 0 && attention_mma_takes(d, chunk))
    return attention_mma_launch(q, keys, pos, out, scratch, counters, b, hkv, g, d, wb * bs,
                                chunk, scale, s);
  if (chunk != kSplit) return static_cast<int>(cudaErrorInvalidValue);
  if (q_dtype == 0)
    return attention_launch<__nv_bfloat16>(q, keys, pos, out, scratch, b, hkv, g, d,
                                           wb * bs, scale, s);
  if (q_dtype == 1)
    return attention_launch<float>(q, keys, pos, out, scratch, b, hkv, g, d, wb * bs, scale,
                                   s);
  return static_cast<int>(cudaErrorInvalidValue);
}
