// K1: fused GQA decode attention over a dense KV window, for Hopper (sm_90a).
//
// Replaces tts_inference_tpu/ops/pallas/decode_attention.py::decode_attention
// (Pallas body `_kernel`, launched by `_pallas_decode_attention`). One decode
// query per slot attends to the cache prefix j <= pos[b]: q·kᵀ/√D → mask →
// softmax → ·v, accumulated in f32, written in q's dtype.
//
// What bounds it on the H100: latency, then bytes. Each decode step reads the
// slot's K and V rows once (2·W·Hkv·D·2 bytes at bf16) at ~4·G FLOPs per
// byte, far below the card's ~295 FLOP/byte ridge; at the serve shapes
// (B·Hkv = 64 heads, W ≤ 4608) that is 4–70 MB, 1.5–21 µs at the memory rate,
// so a kernel is as fast as the loads it keeps in flight and as short as the
// chain from its launch to its last store.
//
// What the design does about it (bodies in attention.cuh):
//  - bf16 with D 64 or 128 (the serve path) runs `attention_mma`: chunks of
//    64 or 128 keys, picked by the wrapper from (B, Hkv, W) so that every SM
//    gets two to four blocks; a chunk's K and V rows are requested up front
//    with cp.async into padded shared-memory rows; q·kᵀ and p·v run on the
//    tensor cores (mma.sync m16n8k16, G query heads in the first rows of A)
//    with the softmax on the fragments in registers; the chunks are combined
//    by the block that finishes last, so a call is one launch at every W;
//  - f32 (the tiny configuration) and other head dims run the CUDA-core body
//    `attention_chunk` in chunks of 256 keys, with `attention_combine` as a
//    second launch from W 257 up;
//  - the G query heads of a kv head share every K/V load (GQA); G is not
//    padded to the TPU's 8-row sublane tile in memory;
//  - keys past pos[b] are never read: each chunk stops at min(W, pos+1),
//    where the TPU kernel read the whole window and masked it. Masked keys
//    contribute exp(-1e30 - m) == 0 exactly in the reference, so the result
//    is the same up to summation order.
//
// Layouts (elements): q, out (B, Hkv, G, D) contiguous; k, v (B, W, Hkv, D)
// with contiguous (W, Hkv, D) rows and a free batch stride, so a window
// slice of the (B, max_seq, Hkv, D) cache is read in place.

#include "attention.cuh"

namespace {

// Key j of slot b, head h: row j of the slot's (W, Hkv, D) window.
template <typename T>
struct DenseKeys {
  using Elem = T;
  static constexpr bool kScaled = false;
  static constexpr int kPlanes = 1;
  struct Slot {
    const T* kb;
    const T* vb;
    size_t row;  // elements between keys
    __device__ const T* key(int j) const { return kb + static_cast<size_t>(j) * row; }
    __device__ const T* value(int j) const { return vb + static_cast<size_t>(j) * row; }
    __device__ void read8(const T* p, float o[8]) const { load8(p, o); }
    __device__ void read4(const T* p, float o[4]) const { load4(p, o); }
  };
  const T* k;
  const T* v;
  long long k_bstride, v_bstride;
  int hkv, d;
  __device__ Slot slot(int b, int h) const {
    return {k + static_cast<size_t>(b) * k_bstride + static_cast<size_t>(h) * d,
            v + static_cast<size_t>(b) * v_bstride + static_cast<size_t>(h) * d,
            static_cast<size_t>(hkv) * d};
  }
};

template <typename T>
int launch_dense(const void* q, const void* k, const void* v, const void* pos, void* out,
                 void* scratch, int b, int hkv, int g, int d, int w, long long k_bstride,
                 long long v_bstride, float scale, cudaStream_t s) {
  const DenseKeys<T> keys{static_cast<const T*>(k), static_cast<const T*>(v), k_bstride,
                          v_bstride, hkv, d};
  return attention_launch<T>(q, keys, pos, out, scratch, b, hkv, g, d, w, scale, s);
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32. `chunk` is the wrapper's choice of keys
// per block: 64 or 128 selects the tensor-core body (bf16, D 64 or 128),
// 256 the CUDA-core body. scratch: f32 B·Hkv·S·G·(D + 2) with
// S = ceil(w / chunk), needed when S > 1; counters: B·Hkv ints, 0 before and
// after every launch (tensor-core body only). Returns the launches'
// cudaError_t.
extern "C" int tts_decode_attention(const void* q, const void* k, const void* v,
                                    const void* pos, void* out, void* scratch,
                                    void* counters, int b, int hkv, int g, int d, int w,
                                    int chunk, long long k_bstride, long long v_bstride,
                                    float scale, int dtype, void* stream) {
  if (!attention_shape_ok(b, hkv, g, d, w)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && attention_mma_takes(d, chunk)) {
    const DenseKeys<__nv_bfloat16> keys{static_cast<const __nv_bfloat16*>(k),
                                        static_cast<const __nv_bfloat16*>(v), k_bstride,
                                        v_bstride, hkv, d};
    return attention_mma_launch(q, keys, pos, out, scratch, counters, b, hkv, g, d, w, chunk,
                                scale, s);
  }
  if (chunk != kSplit) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch_dense<__nv_bfloat16>(q, k, v, pos, out, scratch, b, hkv, g, d, w,
                                       k_bstride, v_bstride, scale, s);
  if (dtype == 1)
    return launch_dense<float>(q, k, v, pos, out, scratch, b, hkv, g, d, w, k_bstride,
                               v_bstride, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
