// K1: fused GQA decode attention over a dense KV window, for Hopper (sm_90a).
//
// Replaces tts_inference_tpu/ops/pallas/decode_attention.py::decode_attention
// (Pallas body `_kernel`, launched by `_pallas_decode_attention`). One decode
// query per slot attends to the cache prefix j <= pos[b]: q·kᵀ/√D → mask →
// softmax → ·v, accumulated in f32, written in q's dtype.
//
// What bounds it on the H100: device-memory bytes and their latency. Each
// decode step reads the slot's K and V rows once (2·W·Hkv·D·2 bytes at bf16)
// and does ~4·G FLOPs per byte, far below the card's ~295 FLOP/byte ridge.
// At the serve shapes (B·Hkv = 64 heads, W ≤ 4608) the bytes are few, so what
// limits a simple kernel is how many loads it keeps in flight.
//
// What the design does about it (the body is shared with K3a/K3b, see
// attention.cuh):
//  - the window is split into chunks of kSplit keys; one block per (slot, kv
//    head, chunk) streams that chunk's K/V rows exactly once with an online
//    softmax over tiles of kTile keys, and a second pass combines the chunks
//    (flash-decoding). 64 heads × up to 18 chunks fill the 132 SMs where 64
//    blocks alone did not (a first version with one block per head measured
//    slower than the plain PyTorch version from W = 2048 up);
//  - scores: one thread per key reads its 256-byte K row as 16-byte vectors,
//    all of them issued back to back; p·v: one warp per key, each lane owns
//    4 head-dim elements, so a V row is one coalesced 256-byte read. No score
//    or probability vector goes to device memory;
//  - the G query heads of a kv head share every K/V load (GQA); G is not
//    padded to the TPU's 8-row sublane tile;
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

// Chunks the window is split into; the caller sizes the scratch from it.
extern "C" int tts_decode_attention_splits(int w) { return attention_splits(w); }

// dtype: 0 = bfloat16, 1 = float32. Returns the launches' cudaError_t.
extern "C" int tts_decode_attention(const void* q, const void* k, const void* v,
                                    const void* pos, void* out, void* scratch, int b,
                                    int hkv, int g, int d, int w, long long k_bstride,
                                    long long v_bstride, float scale, int dtype,
                                    void* stream) {
  if (!attention_shape_ok(b, hkv, g, d, w)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dense<__nv_bfloat16>(q, k, v, pos, out, scratch, b, hkv, g, d, w,
                                       k_bstride, v_bstride, scale, s);
  if (dtype == 1)
    return launch_dense<float>(q, k, v, pos, out, scratch, b, hkv, g, d, w, k_bstride,
                               v_bstride, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
