// Hopper building blocks shared by the port's kernels (sm_90a): mbarriers,
// the copy engine (TMA) and its tensor maps, and the warpgroup product
// (`wgmma`) from shared memory. K4 / K2 (quant_matmul.cu) and the 16-bit K6
// (vocoder16.cuh) include it; every file that does gets its own copy (an
// anonymous namespace), so nothing here is shared between two objects.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

namespace {

__device__ inline uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// mbarriers (shared-memory addresses): the producer's cp.async requests count
// in on a stage's `full` barrier as they land; consumers wait on its parity.
__device__ inline void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ inline void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ inline void cp_async_mbar_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// arrive, and tell the barrier that `bytes` of the copy engine will complete on it
__device__ inline void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// One box of a 2-d tensor map (inner coordinate c0, outer c1) to shared memory
// by the copy engine (TMA); its bytes complete on `bar`. What lies outside
// the tensor arrives as 0.
__device__ inline void tma_box(void* dst, const CUtensorMap* map, int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(shared_addr(dst)),
      "l"(map), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// The same for a 3-d tensor map (coordinates inner first).
__device__ inline void tma_box3(void* dst, const CUtensorMap* map, int c0, int c1, int c2,
                                uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(shared_addr(dst)),
      "l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// One box of shared memory to a 3-d tensor map by the copy engine (what lies
// outside the tensor is not written), in the thread's current bulk group;
// commit the group; wait until all groups (or all but the newest) have read
// their shared memory, or until all have completed.
__device__ inline void tma_store3(const CUtensorMap* map, const void* src, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(map),
      "r"(shared_addr(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ inline void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
__device__ inline void bulk_wait_read0() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ inline void bulk_wait0() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

__device__ inline void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Generic-proxy writes to shared memory (st.shared) made visible to the
// async proxy (wgmma, the copy engine) of the block: every writer fences,
// then the block meets.
__device__ inline void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The shared-memory descriptor of a K-major operand of `wgmma` in the
// 128-byte swizzle of the copy engine: rows of 64 16-bit values (128 bytes)
// whose 16-byte units are XOR-ed with the row index mod 8, 8-row atoms of
// 1024 bytes one after the other (stride 1024), the atoms' start 1024-aligned;
// a k-step of 16 values within the 64 is +32 bytes on the start address.
__device__ inline uint64_t sw128_desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ inline void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ inline void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ inline void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving a `wgmma` accumulator's reads or writes
// across this point (the registers belong to the tensor cores between the
// issue and the wait).
template <int N>
__device__ inline void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int M, int N>
__device__ inline void reg_fence(float (&d)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i) reg_fence(d[i]);
}

// d (64 × N, f32, the m64nNk16 fragment of the warpgroup) += A · B: A the
// 64 × 16 operand at descriptor da, B the N × 16 operand at db, both K-major
// in shared memory; `acc` 0 overwrites d.
template <int N, typename T>
__device__ inline void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int acc);

template <>
__device__ inline void wgmma_ss<16, __nv_bfloat16>(float (&d)[8], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ inline void wgmma_ss<32, __nv_bfloat16>(float (&d)[16], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ inline void wgmma_ss<64, __nv_bfloat16>(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ inline void wgmma_ss<16, __half>(float (&d)[8], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ inline void wgmma_ss<32, __half>(float (&d)[16], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ inline void wgmma_ss<64, __half>(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}


// The tensor map of an array for the copy engine (TMA): `rank` (2 or 3)
// dimensions of dims[i] elements, inner first, dimension i + 1 pitches[i]
// bytes apart, cut into boxes of box[i] elements; with a swizzle the engine
// XOR-swizzles the 16-byte units of a box's rows in shared memory. A map is
// made once per array and kept (encoding one costs microseconds); weights
// stay where they are, and the allocator hands activations the same few
// addresses again.
bool tensor_map(const void* base, CUtensorMapDataType type, int rank, const long long* dims,
                const long long* pitches, const int* box, CUtensorMapSwizzle swizzle,
                CUtensorMap* out) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  using Key = std::tuple<const void*, int, int, long long, long long, long long, long long,
                         long long, int, int, int, int>;
  static std::mutex mu;
  static std::map<Key, CUtensorMap> maps;
  static Encode encode = nullptr;
  if (rank < 2 || rank > 3) return false;
  std::lock_guard<std::mutex> lock(mu);
  if (encode == nullptr) {
    // the encoder lives in libcuda, which the CUDA runtime has loaded already
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    void* fn = lib == nullptr ? nullptr : dlsym(lib, "cuTensorMapEncodeTiled");
    if (fn == nullptr) return false;
    encode = reinterpret_cast<Encode>(fn);
  }
  const bool r3 = rank == 3;
  const Key key{base,      static_cast<int>(type), rank,   dims[0], dims[1], r3 ? dims[2] : 0,
                pitches[0], r3 ? pitches[1] : 0,    box[0], box[1], r3 ? box[2] : 0,
                static_cast<int>(swizzle)};
  auto it = maps.find(key);
  if (it != maps.end()) {
    *out = it->second;
    return true;
  }
  if (maps.size() >= 1 << 16) maps.clear();
  CUtensorMap map;
  cuuint64_t d[3], p[2];
  cuuint32_t b[3], steps[3] = {1, 1, 1};
  for (int i = 0; i < rank; ++i) {
    d[i] = static_cast<cuuint64_t>(dims[i]);
    b[i] = static_cast<cuuint32_t>(box[i]);
    if (i + 1 < rank) p[i] = static_cast<cuuint64_t>(pitches[i]);
  }
  const CUresult r = encode(&map, type, rank, const_cast<void*>(base), d, p, b, steps,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return false;
  maps.emplace(key, map);
  *out = map;
  return true;
}

// The 2-d map K4 / K2 use: inner length d0 elements, d1 rows `pitch` bytes
// apart, boxes of b0 × b1 elements whose inner side (128 or 64 bytes) sets
// the swizzle.
bool tensor_map(const void* base, CUtensorMapDataType type, long long d0, long long d1,
                long long pitch, int b0, int b1, CUtensorMap* out) {
  const int elem = type == CU_TENSOR_MAP_DATA_TYPE_FLOAT32 ? 4
                   : type == CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 || type == CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                       ? 2
                       : 1;
  const long long dims[2] = {d0, d1};
  const int box[2] = {b0, b1};
  return tensor_map(base, type, 2, dims, &pitch, box,
                    b0 * elem == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                    : b0 * elem == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                      : CU_TENSOR_MAP_SWIZZLE_NONE,
                    out);
}

}  // namespace
