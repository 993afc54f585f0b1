// K3a / K3b: paged GQA decode attention over a block pool, for Hopper
// (sm_90a); K3b reads int8 pools with per-row f32 scales.
//
// Replaces tts_inference_tpu/ops/pallas/paged_attention.py:
//   K3a paged_decode_attention      (pallas_call in _pallas_paged_attention,
//                                    body _make_kernel(m, quantized=False))
//   K3b paged_decode_attention_int8 (pallas_call in
//                                    _pallas_paged_attention_int8, body
//                                    _make_kernel(m, quantized=True))
// One decode query per slot attends to positions j <= pos[b] of its window;
// position j lives in pool row table[b, j / bs], offset j % bs. The TPU
// kernel walked the window in order with a grid of (slot, super-block of m
// pool blocks) and carried the running max / denominator in VMEM; here the
// blocks of a slot run in parallel and in no order, so the window is cut
// into chunks and a second pass combines them (the K1 design, attention.cuh).
//
// What bounds it on the H100: at long windows, device-memory bytes — each
// step reads the slot's K and V rows once (2·W·Hkv·D bytes at int8, twice
// that at bf16) at ~4·G FLOPs per byte, far below the ~295 FLOP/byte ridge;
// at short windows (W ≤ 512 at the serve shapes) the latency of those few
// loads and of the launch.
//
// What the design does about it:
//  - one block per (slot, kv head, chunk of kSplit positions) fills the SMs
//    at the long-audio shape (B 4 × Hkv 8 × 48 chunks at W 12,160) and at
//    the 64-slot shape (64 × 8 blocks at W 512);
//  - each block reads its own table entries (the engine hands in
//    table[:, :WB], so the row stride is an argument); per block and head a
//    pool block `pool[row, h]` is one contiguous bs×D slab, so consecutive
//    keys are consecutive D-element rows and every load is 16 bytes (bf16:
//    8 elements; int8: 8 bytes) per thread, coalesced across the tile;
//  - positions past pos[b] are never read, so chunks and pool blocks wholly
//    past pos cost nothing but an empty block. Unallocated table entries are
//    0 (the trash block) and lie past pos: masking is by position only;
//  - K3b converts int8 to f32 in registers and applies the k scale to the
//    score column after the q·k dot and the v scale to the probability row
//    before p·v, as the TPU kernel does — the int8 bytes are what move.
// TMA, wgmma, split heuristics and fusing the table walk are later work.
//
// Layouts (elements): q, out (B, Hkv, G, D) contiguous; k, v pools
// (N, Hkv, bs, D) contiguous; k, v scale pools (N, Hkv, bs) f32 contiguous;
// table (B, ≥ WB) int32 with row stride `table_stride`; pos (B,) int32.

#include "attention.cuh"

namespace {

template <typename E, bool Scaled>
struct PagedKeys {
  using Elem = E;
  static constexpr bool kScaled = Scaled;
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
    __device__ float key_scale(int j) const { return ks[at(j)]; }
    __device__ float value_scale(int j) const { return vs[at(j)]; }
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

// Chunks a window of wb blocks of bs positions is split into; the caller
// sizes the scratch from it.
extern "C" int tts_paged_attention_splits(int wb, int bs) {
  return attention_splits(wb * bs);
}

// K3a. dtype of q, out and both pools: 0 = bfloat16, 1 = float32.
// Returns the launches' cudaError_t.
extern "C" int tts_paged_attention(const void* q, const void* k_pool, const void* v_pool,
                                   const void* table, long long table_stride,
                                   const void* pos, void* out, void* scratch, int b,
                                   int hkv, int g, int d, int bs, int wb, float scale,
                                   int dtype, void* stream) {
  if (!attention_shape_ok(b, hkv, g, d, wb * bs) || bs < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
                                        void* scratch, int b, int hkv, int g, int d, int bs,
                                        int wb, float scale, int q_dtype, void* stream) {
  if (!attention_shape_ok(b, hkv, g, d, wb * bs) || bs < 1 || k_scale == nullptr ||
      v_scale == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
