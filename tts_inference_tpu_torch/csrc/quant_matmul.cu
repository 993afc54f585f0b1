// K4 / K2: weight-only quantized matmuls for Hopper (sm_90a).
//
//   K4  y = x @ dequant(w_p, scales)   int4 weights, two per byte, f32
//                                      per-(group, out channel) scales
//   K2  y = (x @ w_i8) * scale         int8 weights, f32 per-out-channel scale
//
// K4 replaces tts_inference_tpu/ops/pallas/int4_matmul.py::int4_mm (Pallas
// body `_kernel`, launched by `_pallas_int4_mm`). K2 has no TPU kernel: the
// JAX package left the int8 convert to the compiler (models/quant.py::mm,
// tied_logits, head_logits). Here it is K4's body with another unpack, so a
// dequantized copy of the weights is never written.
//
// The packed int4 format is the JAX package's, bit for bit: packed row i of
// w_p (K/2, Np) holds q[i] in the low nibble, offset-encoded (bits = q + 8),
// and q[K/2 + i] in the high nibble, two's complement. Groups of G rows tile
// each half of K; scales (K/G, N). The TPU kernel fed the packed byte to its
// matrix unit as it was and corrected for that afterwards; on this card a
// nibble is two integer operations in a register, so both are extracted.
//
// What bounds it on the H100: at a decode step (M <= 16) the weight bytes,
// read once (K·N/2 for K4, K·N for K2) at 2·M FLOPs per weight, far below
// the ~295 FLOP/byte ridge; a call moves 1.5 to 25 MB, which the card streams
// in 0.5 to 8 µs, so what decides is how many bytes are on their way from the
// first cycle on and how few dependent trips a block makes: to memory, and to
// the other blocks of its tile. At prefill (M in the hundreds or thousands)
// the operations: a weight tile must be dequantized once for many rows of x.
//
// Every call is ONE launch. Design of `qmm_stream<F, MT>` — bf16 x, all three
// weight formats (K4; K2 with (K, N) weights; K2 with (N, K) weights, the tied
// head), mma.sync m16n8k16 with f32 accumulators (the integers are exact in
// bf16):
//  - work is cut into units: (tile of 16·MT rows of x × 128 out columns) ×
//    (chunk of 64 weight rows — K4: 64 packed rows, i.e. 64 k of each half of
//    K — that never crosses a scale group). Block b of B takes units [b·U/B,
//    (b+1)·U/B) of the list ordered by tile, then chunk. The wrapper computes
//    that plan (ops/int4_matmul.py::plan) and passes its numbers; the kernel
//    repeats the two integer divisions. At a decode step B = tiles × c and the
//    c blocks of a tile are one thread-block cluster (c = 8, 4 or 2: as many
//    as the card holds at once); else B = SMs × resident blocks, persistent,
//    and the runs cross tiles (stream-K: blocks differ by at most one unit);
//  - a block is 8 consumer warps and a producer warp. The producer hands a
//    unit to the copy engine (TMA, `cp.async.bulk.tensor`): one box of the
//    weights' tensor map (64 rows × 128 bytes; (N, K): 128 channels × 64
//    bytes), one box of x's per half of K (16·MT rows, or a decode step's 8,
//    × 64 k) and, in the stage at which the consumers scale, K4's two scale
//    rows of the unit's group (one box each of the scales' map), into a ring
//    of 6 (MT 4: 4) shared-memory stages of 12 to 26 KB. The engine computes
//    the addresses, fills what lies outside the arrays with zeros,
//    XOR-swizzles the 16-byte units of each row so that the fragment loads
//    below meet no (weights: at most 2-way) bank conflict, takes no place in
//    the load/store queue that those loads go through, and counts the bytes
//    in on the stage's `full` mbarrier. All boxes of a stage leave in ONE
//    instruction of the warp, a lane per box, and lane 0's `expect_tx` is the
//    barrier's only arrival: a box costs the issuing lane some 220 cycles,
//    and 32 lanes arriving on one barrier several hundred, more than the
//    memory takes to deliver the stage. Where a chunk is not whole (a scale
//    group that is no multiple of 64 rows) or the scale rows do not start on
//    16 bytes, x and the scales go by `cp.async` of all lanes, which arrive
//    on the same barrier. Consumers wait on `full`, multiply, and arrive on
//    `empty`; the producer refills a stage when all eight warps have left it.
//    A tensor map costs microseconds to encode: they are kept per array;
//  - an mma sums over k and nothing orders its k slots or its n slots, so
//    both are permuted to fit the format as it is stored: lane (g, t) takes,
//    for each of four weight rows 4t..4t+3 of a 16-row k-tile, the 4-byte
//    word at columns 4g..4g+3. Byte j of those words is the lane's B fragment
//    of n-tile j: k slots 2t, 2t+1, 2t+8, 2t+9 stand for rows 4t..4t+3 and n
//    slot g for column 4g + j. x follows the same k permutation, which makes
//    its fragment 4 consecutive bf16 of a row (each mma register by a 4-byte
//    load of its own: a 64-bit load would need register moves after it);
//  - (N, K) weights ARE the `col` B operand: lane (g, t) takes the word at
//    k 4t..4t+3 of out channel g of an n-tile, two B registers;
//  - a nibble becomes bf16 without a convert: its 4 bits in the mantissa of
//    128.0 (0x4300) give 128 + bits exactly — a byte permute and ONE LOP3,
//    (r & mask) | 0x4300 with both constants in registers — and one bf16x2
//    subtract of 136 leaves q (the low nibble stores q + 8; the high one is
//    two's complement, so bits ^ 8 = q + 8). An int8 byte, biased by 128,
//    goes into the mantissa of 2^23 as f32, one subtract leaves the integer,
//    and two of them are packed to bf16x2 by one convert;
//  - 4 column groups × 2 warps along the stage's k-tiles make a block. K4 at
//    MT 1 keeps the chunk sums of both halves of K in registers through a
//    scale group and scales them once, when the run leaves the group; at MT 4
//    (four tiles of rows, every dequantized B fragment used four times) one
//    half after the other, scaled every stage;
//  - where a block's run leaves a tile: in a cluster, every warp pushes its
//    fragments from registers into the shared memory of the blocks that own
//    them (`st.async`: block r owns the r-th slice of the tile's values; a
//    slot per (rank, k warp)), the bytes count in on the owner's `mbarrier`,
//    and the owner adds the slots in their order, scales (K2), rounds once and
//    stores. No block reads another's memory, so none waits for another to
//    finish: the cluster's one meeting (the barriers stand) is begun at entry
//    and awaited only before the push. Meeting twice around a pull cost 1 to
//    1.5 µs more a call. Without a cluster the two k warps meet in shared
//    memory; a tile that one block walked alone is stored at once; otherwise
//    the partial tile goes to a per-device scratch (two slots per block), the
//    block counts itself on the tile's counter, and the block that arrives
//    last adds the partial tiles in block order (four vectors of four values
//    a thread in flight: value by value it was one trip to the L2 after the
//    other, 9 µs for a tile of 64 rows), scales, rounds and stores, and sets
//    the counter back to 0. No float atomics anywhere: two runs give the same
//    bits.
//
// `qmm_kn` — f32 x, or shapes and alignments `qmm_stream` refuses (K or a
// group that is no multiple of 8, a row stride or a pointer off 16 bytes):
// f32 FMAs on the CUDA cores over (K, N) weights:
//  - a block owns 128 output columns, 8 rows of x and a range of K; a warp
//    walks that range in chunks of 32 weight rows; each lane owns 4 adjacent
//    columns, so one weight row is one coalesced 128-byte read of the warp,
//    and 16 rows are requested before the first is used;
//  - the chunk's x values sit in shared memory as [k][8 rows], so a lane
//    fetches the 8 rows of one k with two 16-byte broadcast reads;
//  - a chunk never crosses a scale group: its integer partial sums (f32
//    accumulators; the integers enter exactly) are scaled once and added to
//    the warp's accumulator tile in shared memory; the warps' tiles are
//    summed at the end;
//  - K is split over blocks (the wrapper's plan) and the splits meet through
//    the scratch and a counter per tile, as above.
// `qmm_rows` — the same for (N, K) weights: a warp owns 8 out channels, its
// lanes stride over K with 4-byte loads, the 64 sums are reduced over the
// lanes once at the end.
//
// Layouts (elements): x (M, K) contiguous, bf16 or f32; out (M, N) contiguous,
// bf16 or f32; weights int8 with row stride ldw; scratch f32 and counters
// int32 as the wrapper's plan sizes them (counters are 0 between launches).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMT = 8;            // rows of x per block
constexpr int kCols = 4;          // out columns per lane: one 32-bit load
constexpr int kBN = 32 * kCols;   // out columns per block
constexpr int kR = 32;            // weight rows per chunk: one x row per lane
constexpr int kFlight = 16;       // weight rows requested before use
constexpr int kRowsNK = 8;        // out channels per warp, (N, K) weights
// the tensor-core path
constexpr int kStreamThreads = kThreads + 32;   // 8 consumer warps, then the producer
constexpr int kSR = 64;           // weight rows (k) per unit and stage: 4 k-tiles

enum Fmt { kI4 = 0, kI8 = 1, kI8Rows = 2 };

struct Args {
  const void* x;
  const int8_t* w;
  const float* scale;
  void* out;
  float* scratch;
  int* counters;
  int m, k, n;
  long long ldw;   // bytes between weight rows
  int nw;          // weight columns that may be read (>= n)
  int group;       // K4: rows of K per scale group
  int x_f32, out_f32;
  int cpb;         // qmm_kn: chunks per K split
  int nchunks;     // qmm_stream: chunks per tile
  int nmt;         // qmm_stream: tiles along M
  unsigned units;  // qmm_stream: tiles × chunks
  int csize;       // qmm_stream: blocks of a cluster, which share one tile; or 1
  int scale16;     // qmm_stream, K4: scale rows take 16-byte requests
  int bulk;        // qmm_stream: every stage is fed by the copy engine alone
};

__device__ inline float load_x(const void* x, int f32, size_t i) {
  return f32 ? static_cast<const float*>(x)[i]
             : __bfloat162float(static_cast<const __nv_bfloat16*>(x)[i]);
}

__device__ inline void store_out(void* out, int f32, size_t i, float v) {
  if (f32)
    static_cast<float*>(out)[i] = v;
  else
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16(v);
}

// the 4 weight bytes of one row at a lane's columns, little-endian in a word;
// columns past the weight's width read as 0
__device__ inline uint32_t load_w4(const int8_t* p, bool vec, int col0, int nw) {
  if (vec) return *reinterpret_cast<const uint32_t*>(p);
  uint32_t r = 0;
#pragma unroll
  for (int c = 0; c < kCols; ++c)
    if (col0 + c < nw) r |= static_cast<uint32_t>(static_cast<uint8_t>(p[c])) << (8 * c);
  return r;
}

// With -DQMM_TRACE (tools/qmm_probe.py builds such a copy) the first consumer
// thread and the first producer thread of every block of `qmm_stream` stamp
// the card's nanosecond timer at each phase: 0 entry, 1 everything requested
// (producer), 2 first stage landed, 3 last product done, 4 partial tile
// ready, 5 met the other blocks of the tile, 6 end.
#ifdef QMM_TRACE
constexpr int kTraceBlocks = 1024, kTraceStamps = 8;
__device__ unsigned long long qmm_trace_buf[kTraceBlocks * kTraceStamps];
__device__ inline void stamp(int i) {
  if ((threadIdx.x == 0 || threadIdx.x == kThreads) && blockIdx.x < kTraceBlocks) {
    unsigned long long now;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
    qmm_trace_buf[blockIdx.x * kTraceStamps + i] = now;
  }
}
// and, for the first 16 units of its run, the SM's cycle counter (cheap enough
// to read inside the loop; one SM's threads read one counter): when the
// producer had requested unit i (row 0), when the consumers saw it land (1)
// and had multiplied it (2)
constexpr int kTraceUnits = 16;
__device__ unsigned long long qmm_trace_units[kTraceBlocks * 3 * kTraceUnits];
__device__ inline void stamp_unit(int row, int i) {
  if ((threadIdx.x == 0 || threadIdx.x == kThreads) && blockIdx.x < kTraceBlocks &&
      i < kTraceUnits) {
    qmm_trace_units[(blockIdx.x * 3 + row) * kTraceUnits + i] =
        static_cast<unsigned long long>(clock64());
  }
}
#else
__device__ inline void stamp(int) {}
__device__ inline void stamp_unit(int, int) {}
#endif

// the consumer warps of `qmm_stream` meet (named barrier 1)
__device__ inline void consumer_sync() { asm volatile("bar.sync 1, 256;\n" ::: "memory"); }

// Count this block in on `counter`; true for the block that arrives last of
// `parts` (it sets the counter back to 0 for the next launch). The caller's
// partial results are visible to that block. kConsumersOnly: the 256
// consumer threads of `qmm_stream` call it, not the whole block.
template <bool kConsumersOnly>
__device__ inline bool arrive_last(int* counter, int parts) {
  __shared__ int last_s;
  __threadfence();
  if constexpr (kConsumersOnly)
    consumer_sync();
  else
    __syncthreads();
  if (threadIdx.x == 0) {
    const int before = atomicAdd(counter, 1);
    last_s = before == parts - 1;
    if (last_s) *counter = 0;
  }
  if constexpr (kConsumersOnly)
    consumer_sync();
  else
    __syncthreads();
  const bool last = last_s != 0;
  if (last) __threadfence();
  return last;
}

__device__ inline void mma_bf16(float c[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                uint32_t a3, uint32_t b0, uint32_t b1) {
#ifdef QMM_NO_MMA   // probe build: the operands are used, the product is not made
  c[0] += __uint_as_float((a0 ^ b0) & 1u);
  c[1] += __uint_as_float((a1 ^ b1) & 1u);
  c[2] += __uint_as_float(a2 & 1u);
  c[3] += __uint_as_float(a3 & 1u);
  return;
#endif
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// d = (a & b) | c, or (a & b) ^ c, in one LOP3: the mask and the magic number
// sit in registers (`I4Consts`), where two immediates would take two.
__device__ inline uint32_t and_or(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

__device__ inline uint32_t and_xor(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0x6A;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

struct I4Consts {
  uint32_t mask, lo, hi;   // 0x000F000F; bf16x2 128.0; bf16x2 136.0
};

__device__ inline I4Consts i4_consts() {
  I4Consts k;
  asm volatile("mov.b32 %0, 0x000F000F;\n" : "=r"(k.mask));
  asm volatile("mov.b32 %0, 0x43004300;\n" : "=r"(k.lo));
  asm volatile("mov.b32 %0, 0x43084308;\n" : "=r"(k.hi));
  return k;
}

// Nibble H (0: low, offset-encoded; 1: high, two's complement) of byte J of
// two weight words → one B register: the two weights as bf16, w0's in the low
// half. For H == 1 the caller hands the words shifted right by 4.
template <int J, int H>
__device__ inline uint32_t i4_bf16x2(uint32_t w0, uint32_t w1, const I4Consts& k) {
#ifdef QMM_NO_DEQUANT   // probe build: the words are used, nothing is unpacked
  return (w0 >> (8 * J + H)) ^ w1;
#endif
  // bytes (w0[J], w0[J], w1[J], w1[J]); bytes 1 and 3 are masked off
  const uint32_t r = __byte_perm(w0, w1, J | (J << 4) | ((4 + J) << 8) | ((4 + J) << 12));
  // 128 + (q + 8) as bf16: the nibble in the mantissa of 128.0 (the high
  // nibble is two's complement: bits ^ 8 = q + 8)
  const uint32_t v = H == 0 ? and_or(r, k.mask, k.lo) : and_xor(r, k.mask, k.hi);
  const __nv_bfloat162 q = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
                                   *reinterpret_cast<const __nv_bfloat162*>(&k.hi));
  return *reinterpret_cast<const uint32_t*>(&q);
}

// Byte JA of wa and byte JB of wb, both int8 biased by 128 (the word XOR
// 0x80808080) → one B register, wa's weight in the low half: the byte in the
// mantissa of 2^23 is 2^23 + byte as f32; minus 2^23 + 128 leaves the integer.
template <int JA, int JB>
__device__ inline uint32_t i8_bf16x2(uint32_t wa, uint32_t wb) {
#ifdef QMM_NO_DEQUANT
  return (wa >> (8 * JA)) ^ (wb << JB);
#endif
  const float lo = __uint_as_float(__byte_perm(wa, 0x4B000000u, 0x7540 | JA)) - 8388736.f;
  const float hi = __uint_as_float(__byte_perm(wb, 0x4B000000u, 0x7540 | JB)) - 8388736.f;
  const __nv_bfloat162 q = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&q);
}

// Asynchronous copies of 16 or 4 bytes to shared memory; the bytes past
// `bytes` are written as 0.
__device__ inline void cp_async16(void* dst, const void* src, int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}

__device__ inline void cp_async4(void* dst, const void* src, int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}

__device__ inline void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

// Thread-block clusters: every thread of every block arrives once and waits
// once; the address of a shared-memory word of block `rank` of the cluster;
// 16 or 8 bytes from registers into another block's shared memory, counted in
// on a barrier of that block when they have landed (`st.async`).
__device__ inline void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ inline void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ inline uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ inline uint32_t map_to_rank(uint32_t smem_addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(smem_addr), "r"(rank));
  return r;
}

__device__ inline void push4(uint32_t dst, uint32_t bar, float a, float b, float c, float d) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];\n" ::
          "r"(dst), "f"(a), "f"(b), "f"(c), "f"(d), "r"(bar)
      : "memory");
}

__device__ inline void push2(uint32_t dst, uint32_t bar, float a, float b) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];\n" ::
          "r"(dst), "f"(a), "f"(b), "r"(bar)
      : "memory");
}

// The shared memory of `qmm_stream<F, MT>`: a ring of stages (a box of the
// weights, a box of x for each half of K, K4's two scale rows) and the
// block's f32 tile.
template <int F, int MT>
struct Ring {
  static constexpr int kHalves = F == kI4 ? 2 : 1;
  static constexpr int kW = kSR * kBN;   // a box of the weights, swizzled by the copy engine
  static constexpr int kXHalf = MT * 16 * kSR * 2;   // 16·MT rows of 64 bf16, swizzled too
  // every box starts on 1024 bytes: the swizzle goes by the address
  static constexpr int kS = F == kI4 ? 2 * kBN * 4 : 0;   // after the boxes
  static constexpr int kStage = kW + kHalves * kXHalf + kS;
  static_assert(kW % 1024 == 0 && kXHalf % 1024 == 0 && kS % 1024 == 0,
                "boxes start on 1024 bytes");
#ifdef QMM_STAGES   // probe build: another depth of the ring at MT 1
  static constexpr int kStages = MT == 1 ? QMM_STAGES : 4;
#else
  static constexpr int kStages = MT == 1 ? 6 : 4;
#endif
  static constexpr int kTileStride = kBN + 4;   // floats
  // the block's tile; in a cluster, what the tile's blocks push to this one:
  // 2 k warps x 16 rows x 128 columns
  static constexpr int kTile = MT == 1 ? 2 * 16 * kBN * 4 : MT * 16 * kTileStride * 4;
  static_assert(kTile >= MT * 16 * kTileStride * 4, "the tile fits");
  static constexpr int kSmem = 1024 + kStages * kStage + kTile;   // 1024: to align the ring
};

// A block's place in the list of units: the tile, and the chunk as (scale
// group, chunk of the group). Stepping it costs no division.
struct Cursor {
  int tile, gi, ci;
  int ct, mt;   // the tile's column tile and M tile
};

// The geometry of the chunks: rows per group (all of K for int8), chunks per
// group, groups per tile (per half of K for K4).
struct Chunks {
  int rows_total, grows, spg, ngroups;
};

template <int F>
__device__ inline Chunks chunks_of(const Args& a) {
  const int rows_total = F == kI4 ? a.k / 2 : a.k;
  const int grows = F == kI4 ? a.group : rows_total;
  return {rows_total, grows, (grows + kSR - 1) / kSR, rows_total / grows};
}

__device__ inline Cursor cursor_at(unsigned u, const Args& a, const Chunks& ch) {
  const int tile = static_cast<int>(u / a.nchunks);
  const int c = static_cast<int>(u - static_cast<unsigned>(tile) * a.nchunks);
  return {tile, c / ch.spg, c % ch.spg, tile / a.nmt, tile % a.nmt};
}

__device__ inline void advance(Cursor& cur, const Args& a, const Chunks& ch) {
  if (++cur.ci < ch.spg) return;
  cur.ci = 0;
  if (++cur.gi < ch.ngroups) return;
  cur.gi = 0;
  ++cur.tile;
  if (++cur.mt < a.nmt) return;
  cur.mt = 0;
  ++cur.ct;
}

// Where a unit lies: its column tile and M tile, and its chunk's scale group,
// first weight row (k for int8) and row count (a multiple of 8).
struct Unit {
  int ct, mt, gi, r0, nrows;
};

__device__ inline Unit unit_at(const Cursor& cur, const Chunks& ch) {
  const int r0 = cur.gi * ch.grows + cur.ci * kSR;
  return {cur.ct, cur.mt, cur.gi, r0, min(kSR, ch.grows - cur.ci * kSR)};
}

// K4: the producer warp requests the scale rows of the unit's group, of the
// low and the high half of K, at the tile's 128 columns (0 past N).
template <int MT>
__device__ inline void request_scales(const Args& a, const Unit& un, unsigned char* st, int lane) {
  using R = Ring<kI4, MT>;
  const int ngh = a.k / 2 / a.group;   // groups per half of K
  const float* row_lo = a.scale + static_cast<size_t>(un.gi) * a.n;
  const float* row_hi = a.scale + static_cast<size_t>(ngh + un.gi) * a.n;
  unsigned char* dst = st + R::kW + R::kHalves * R::kXHalf;
  if (a.scale16) {
    const int col = un.ct * kBN + lane * 4;
    const int bytes = min(16, max(0, (a.n - col) * 4));
    cp_async16(dst + lane * 16, bytes > 0 ? row_lo + col : a.scale, bytes);
    cp_async16(dst + kBN * 4 + lane * 16, bytes > 0 ? row_hi + col : a.scale, bytes);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int cidx = lane + 32 * i;
      const int col = un.ct * kBN + cidx;
      const bool ok = col < a.n;
      cp_async4(dst + cidx * 4, ok ? row_lo + col : a.scale, ok ? 4 : 0);
      cp_async4(dst + (kBN + cidx) * 4, ok ? row_hi + col : a.scale, ok ? 4 : 0);
    }
  }
}

// x of a unit that is not whole (a chunk of fewer than 64 rows at the end of a
// small scale group: the weights' box then reaches into the next group, so x
// must be 0 there), by cp.async with zero fill, into the layout the copy
// engine would have written: 128-byte rows, their 16-byte units XOR-ed with
// the row's low 3 bits. Rows of x past M are not requested: a row of x only
// reaches its own row of the output, which is never stored.
template <int F, int MT>
__device__ inline void request_x(const Args& a, const Unit& un, int rows_total, unsigned char* st,
                               int lane) {
  using R = Ring<F, MT>;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);
  const int m0 = un.mt * MT * 16;
  const int rows = min(MT * 16, a.m - m0);
  const int unit = lane & 7, rsub = lane >> 3;   // rows rsub + 4 i
  const int bytes = unit * 8 < un.nrows ? 16 : 0;
#pragma unroll
  for (int h = 0; h < R::kHalves; ++h) {
    const __nv_bfloat16* src =
        x + static_cast<size_t>(m0 + rsub) * a.k + h * rows_total + un.r0 + unit * 8;
    unsigned char* dst = st + R::kW + h * R::kXHalf;
#pragma unroll
    for (int i = 0; i < MT * 4; ++i) {
      const int row = rsub + 4 * i;
      if (row < rows)
        cp_async16(dst + row * kSR * 2 + ((unit ^ (row & 7)) * 16), bytes ? src : x, bytes);
      src += 4 * static_cast<size_t>(a.k);
    }
  }
}

__device__ inline uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// What a consumer lane keeps for the whole run.
struct Lane {
  int cg, kl, g, t;   // column group of 32; pair of k-tiles; mma row / n slot; k-slot pair
  bool hi_rows;       // the block has rows of x past the first 8 of a tile
  I4Consts k4;
};

// One k-tile of a stage for a warp's 32 columns: the B fragments of its four
// n-tiles, dequantized once, times the A fragments of the block's MT tiles of
// 16 rows. H: K4's half of K.
template <int F, int MT, int H>
__device__ inline void mma_ktile(const unsigned char* st, int kt, const Lane& ln,
                                 float c[MT][4][4]) {
  using R = Ring<F, MT>;
  const int cg = ln.cg, g = ln.g, t = ln.t;
  uint32_t b[4][2];
  if constexpr (F == kI8Rows) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // 64-byte rows, their 16-byte units XOR-ed with bits 1..2 of the row
      const int row = cg * 32 + 8 * j + g;
      const uint32_t w = *reinterpret_cast<const uint32_t*>(
                             st + row * kSR + ((kt ^ ((row >> 1) & 3)) * 16) + 4 * t) ^
                         0x80808080u;
      b[j][0] = i8_bf16x2<0, 1>(w, w);
      b[j][1] = i8_bf16x2<2, 3>(w, w);
    }
  } else {
    uint32_t wv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // 128-byte rows, their 16-byte units XOR-ed with the row's low 3 bits
      const int row = kt * 16 + 4 * t + i;
      wv[i] = *reinterpret_cast<const uint32_t*>(
          st + row * kBN + (((cg * 2 + (g >> 2)) ^ (row & 7)) * 16) + (g & 3) * 4);
      if constexpr (F == kI8) wv[i] ^= 0x80808080u;
      if constexpr (F == kI4 && H == 1) wv[i] >>= 4;
    }
    if constexpr (F == kI4) {
      b[0][0] = i4_bf16x2<0, H>(wv[0], wv[1], ln.k4); b[0][1] = i4_bf16x2<0, H>(wv[2], wv[3], ln.k4);
      b[1][0] = i4_bf16x2<1, H>(wv[0], wv[1], ln.k4); b[1][1] = i4_bf16x2<1, H>(wv[2], wv[3], ln.k4);
      b[2][0] = i4_bf16x2<2, H>(wv[0], wv[1], ln.k4); b[2][1] = i4_bf16x2<2, H>(wv[2], wv[3], ln.k4);
      b[3][0] = i4_bf16x2<3, H>(wv[0], wv[1], ln.k4); b[3][1] = i4_bf16x2<3, H>(wv[2], wv[3], ln.k4);
    } else {
      b[0][0] = i8_bf16x2<0, 0>(wv[0], wv[1]); b[0][1] = i8_bf16x2<0, 0>(wv[2], wv[3]);
      b[1][0] = i8_bf16x2<1, 1>(wv[0], wv[1]); b[1][1] = i8_bf16x2<1, 1>(wv[2], wv[3]);
      b[2][0] = i8_bf16x2<2, 2>(wv[0], wv[1]); b[2][1] = i8_bf16x2<2, 2>(wv[2], wv[3]);
      b[3][0] = i8_bf16x2<3, 3>(wv[0], wv[1]); b[3][1] = i8_bf16x2<3, 3>(wv[2], wv[3]);
    }
  }
  // this lane's 4 consecutive k of rows g and g + 8 of each tile, each mma
  // register by a load of its own: a 64-bit load would put a row's two
  // registers side by side, where the mma wants the other row's between them
  // (x rows are 128 bytes, their 16-byte units XOR-ed with the row's low 3
  // bits, which are g for rows g and g + 8 of every tile)
  const uint32_t xs = static_cast<uint32_t>(__cvta_generic_to_shared(
      st + R::kW + H * R::kXHalf + g * (kSR * 2) + (((2 * kt + (t >> 1)) ^ g) * 16) + (t & 1) * 8));
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
    uint32_t af[4];
    af[0] = lds32(xs + mi * 16 * kSR * 2);
    af[2] = lds32(xs + mi * 16 * kSR * 2 + 4);
    af[1] = af[3] = 0u;
    if (MT > 1 || ln.hi_rows) {
      af[1] = lds32(xs + (mi * 16 + 8) * kSR * 2);
      af[3] = lds32(xs + (mi * 16 + 8) * kSR * 2 + 4);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) mma_bf16(c[mi][j], af[0], af[1], af[2], af[3], b[j][0], b[j][1]);
  }
}

// K4: scale the chunk sums of one half of K by the stage's scale row and add
// them to acc. C register pair (0, 1) is row g, (2, 3) row g + 8; n slots 2t,
// 2t + 1 of n-tile j are columns 8t + j and 8t + 4 + j of the warp's 32.
template <int MT, int H>
__device__ inline void i4_fold(const unsigned char* st, const Lane& ln, float c[MT][4][4],
                               float acc[MT][4][4]) {
  using R = Ring<kI4, MT>;
  const float* sc = reinterpret_cast<const float*>(st + R::kW + R::kHalves * R::kXHalf) +
                    H * kBN + ln.cg * 32 + 8 * ln.t;
  const float4 s0 = *reinterpret_cast<const float4*>(sc);       // e = 0, j = 0..3
  const float4 s1 = *reinterpret_cast<const float4*>(sc + 4);   // e = 1
  const float sv[2][4] = {{s0.x, s0.y, s0.z, s0.w}, {s1.x, s1.y, s1.z, s1.w}};
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        acc[mi][j][e] += sv[e][j] * c[mi][j][e];
        acc[mi][j][2 + e] += sv[e][j] * c[mi][j][2 + e];
        c[mi][j][e] = c[mi][j][2 + e] = 0.f;
      }
}

// K4, MT > 1: one half of K of a stage, scaled and added to acc at once (the
// chunk sums of four tiles and two halves would not fit the registers).
template <int MT, int H>
__device__ inline void i4_half(const unsigned char* st, const Lane& ln, float acc[MT][4][4]) {
  float c[MT][4][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) c[mi][j][i] = 0.f;
  mma_ktile<kI4, MT, H>(st, 2 * ln.kl, ln, c);
  mma_ktile<kI4, MT, H>(st, 2 * ln.kl + 1, ln, c);
  i4_fold<MT, H>(st, ln, c, acc);
}

// bf16 x on the tensor cores, all three weight formats; MT tiles of 16 rows
// of x per block. Warps 0..7 multiply; the warps after them are producers:
// they alone request the stages, so that a full request queue holds up no
// product.
template <int F, int MT>
__global__ void __launch_bounds__(kStreamThreads, MT == 1 ? 2 : 1)
qmm_stream(const Args a, const __grid_constant__ CUtensorMap wmap,
           const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap smap) {
  using R = Ring<F, MT>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ uint64_t bars[2 * R::kStages + 1];   // full, empty; the cluster's pushes
  unsigned char* ring = smem_raw + (1024 - (__cvta_generic_to_shared(smem_raw) & 1023)) % 1024;
  float* tile_s = reinterpret_cast<float*>(ring + R::kStages * R::kStage);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const uint32_t full = static_cast<uint32_t>(__cvta_generic_to_shared(bars));
  const uint32_t empty = full + 8 * R::kStages;
  const uint32_t pushed = empty + 8 * R::kStages;
  const unsigned grid = gridDim.x;
  const unsigned u0 = blockIdx.x * a.units / grid;
  const unsigned u1 = (blockIdx.x + 1) * a.units / grid;
  const int n_it = static_cast<int>(u1 - u0);
  const Chunks ch = chunks_of<F>(a);
  Cursor cur = cursor_at(u0, a, ch);
  stamp(0);

  const bool ln_hi_rows = a.m > 8;   // rows of x past the first 8 of a tile
  // The producer warp sets the barriers up and requests the first stage
  // before the block meets: the consumers need the barriers only then.
  if (tid == kThreads) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&wmap) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&xmap) : "memory");
    if (F == kI4 && a.bulk) asm volatile("prefetch.tensormap [%0];\n" ::"l"(&smap) : "memory");
    for (int s = 0; s < R::kStages; ++s) {
      // one arrival for the boxes; where lanes request by cp.async, theirs too
      // (32 arrivals on one barrier cost the warp hundreds of cycles a stage)
      mbar_init(full + 8 * s, a.bulk ? 1 : 33);
      mbar_init(empty + 8 * s, kWarps);   // one lane of every consumer warp
    }
    if (a.csize > 1) {
      // what the cluster pushes to this block: the tile's values (its slice
      // of them from every k warp of every block, its own too)
      mbar_init(pushed, 1);
      mbar_expect_tx(pushed, 2 * a.m * kBN * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the cluster's blocks tell each other that their barriers stand; they wait
  // for that only when they have their sums
  if (a.csize > 1) cluster_arrive();
  if (warp < kWarps) __syncthreads();

  if (warp == kWarps) {
    int slot = 0, phase = 1;   // the stages start empty
    __syncwarp();
    for (int it = 0; it < n_it; ++it) {
      if (it >= R::kStages) mbar_wait(empty + 8 * slot, phase);
      const Unit un = unit_at(cur, ch);
      unsigned char* st = ring + slot * R::kStage;
      const uint32_t bar = full + 8 * slot;
      // the unit's box of the weights: 64 rows × 128 columns, or for (N, K)
      // weights 128 channels × 64 k; and of x: 16·MT rows × 64 k per half (a
      // decode step's 8 rows: a box of 8)
      const int xbytes = MT == 1 && !ln_hi_rows ? R::kXHalf / 2 : R::kXHalf;
      unsigned char* sc = st + R::kW + R::kHalves * R::kXHalf;   // K4's scale rows
      if (a.bulk) {
        // Every box of the stage by ONE instruction of the warp, a lane per
        // box (lane 0 alone, box after box, spent ~220 cycles on each: more
        // than the memory takes to deliver a stage). K4's two scale rows (of
        // the low and the high half of K, at the tile's 128 columns, 0 past N)
        // come with the stage in which the consumers fold.
        const bool folds = MT > 1 || cur.ci == ch.spg - 1 || it + 1 == n_it;
        const int nbox = 1 + R::kHalves + (F == kI4 && folds ? 2 : 0);
        if (lane == 0)
          mbar_expect_tx(bar, R::kW + R::kHalves * xbytes + (nbox - 1 - R::kHalves) * kBN * 4);
        __syncwarp();
        if (lane < nbox) {
          const int h = lane <= R::kHalves ? lane - 1 : lane - 1 - R::kHalves;   // half of K
          const CUtensorMap* map = &wmap;
          unsigned char* dst = st;
          int c0 = F == kI8Rows ? un.r0 : un.ct * kBN;
          int c1 = F == kI8Rows ? un.ct * kBN : un.r0;
          if (lane > R::kHalves) {
            map = &smap;
            dst = sc + h * kBN * 4;
            c0 = un.ct * kBN;
            c1 = h * ch.ngroups + un.gi;
          } else if (lane > 0) {
            map = &xmap;
            dst = st + R::kW + h * R::kXHalf;
            c0 = h * ch.rows_total + un.r0;
            c1 = un.mt * MT * 16;
          }
          tma_box(dst, map, c0, c1, bar);
        }
      } else {
        const bool whole = un.nrows == kSR;   // x goes by the copy engine too
        if (lane == 0) {
          mbar_expect_tx(bar, R::kW + (whole ? R::kHalves * xbytes : 0));
          if constexpr (F == kI8Rows)
            tma_box(st, &wmap, un.r0, un.ct * kBN, bar);
          else
            tma_box(st, &wmap, un.ct * kBN, un.r0, bar);
          if (whole) {
#pragma unroll
            for (int h = 0; h < R::kHalves; ++h)
              tma_box(st + R::kW + h * R::kXHalf, &xmap, h * ch.rows_total + un.r0,
                      un.mt * MT * 16, bar);
          }
        }
        if (!whole) request_x<F, MT>(a, un, ch.rows_total, st, lane);
        if constexpr (F == kI4) request_scales<MT>(a, un, st, lane);
        if (whole && F != kI4)
          mbar_arrive(bar);
        else
          cp_async_mbar_arrive(bar);   // when this lane's cp.async have landed
      }
      stamp_unit(0, it);
      if (it == 0) __syncthreads();   // the consumers start
      advance(cur, a, ch);
      if (++slot == R::kStages) {
        slot = 0;
        phase ^= 1;
      }
    }
    stamp(1);
    cp_async_wait_all();
    if (a.csize > 1) cluster_wait();
    return;
  }

  const Lane ln = {warp & 3, warp >> 2, lane >> 2, lane & 3, ln_hi_rows, i4_consts()};
  const int g = ln.g, t = ln.t, cg = ln.cg, kl = ln.kl;
  // K4 with one tile of rows keeps a group's chunk sums of both halves of K
  // in registers and scales them once, when the run leaves the group
  constexpr bool kGroupFold = F == kI4 && MT == 1;
  constexpr int kSums = kGroupFold ? MT : 1;
  float acc[MT][4][4], clo[kSums][4][4], chi[kSums][4][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][j][i] = 0.f;
#pragma unroll
  for (int mi = 0; mi < kSums; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) clo[mi][j][i] = chi[mi][j][i] = 0.f;

  int slot = 0, phase = 0;
  int c = cur.gi * ch.spg + cur.ci;   // chunk of the tile
  int ci = cur.ci;                    // chunk of the group
  int tile = cur.tile;
  for (int it = 0; it < n_it; ++it) {
    mbar_wait(full + 8 * slot, phase);
    if (it == 0) stamp(2);
    stamp_unit(1, it);
    const unsigned char* st = ring + slot * R::kStage;
    const bool leaves = ++c == a.nchunks || it + 1 == n_it;   // the tile
#ifdef QMM_NO_CONSUME   // probe build: the stages are streamed and nothing is multiplied
    if (false) {
    } else
#endif
    if constexpr (kGroupFold) {
      mma_ktile<F, kSums, 0>(st, 2 * kl, ln, clo);
      mma_ktile<F, kSums, 1>(st, 2 * kl, ln, chi);
      mma_ktile<F, kSums, 0>(st, 2 * kl + 1, ln, clo);
      mma_ktile<F, kSums, 1>(st, 2 * kl + 1, ln, chi);
      if (++ci == ch.spg || leaves) {
        i4_fold<kSums, 0>(st, ln, clo, acc);
        i4_fold<kSums, 1>(st, ln, chi, acc);
        if (ci == ch.spg) ci = 0;
      }
    } else if constexpr (F == kI4) {
      i4_half<MT, 0>(st, ln, acc);
      i4_half<MT, 1>(st, ln, acc);
    } else {
      mma_ktile<F, MT, 0>(st, 2 * kl, ln, acc);
      mma_ktile<F, MT, 0>(st, 2 * kl + 1, ln, acc);
    }
    stamp_unit(2, it);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * slot);
    if (++slot == R::kStages) {
      slot = 0;
      phase ^= 1;
    }
    if (!leaves) continue;

    // the block's run leaves this tile
    stamp(3);
    const int ct = a.nmt == 1 ? tile : tile / a.nmt;
    const int m0 = a.nmt == 1 ? 0 : (tile % a.nmt) * MT * 16;
    const int rows = min(MT * 16, a.m - m0);
    if constexpr (MT == 1) {
      if (a.csize > 1) {
        // The blocks of a cluster hold the partial sums of one tile. Block r
        // owns columns [r·wide, (r + 1)·wide) of its rows: every warp of
        // every block pushes its fragments from registers into the owners'
        // shared memory, slot (rank, k warp), and the bytes count in on the
        // owner's barrier; the owner adds the slots up in their order,
        // scales, rounds and stores. No block reads another's memory, so
        // none has to wait for another to finish.
        const int wshift = 7 - (31 - __clz(a.csize));   // wide = 128 / csize, a power of two
        const int wide = 1 << wshift;
        const int per = rows << wshift;   // values a block owns
        const uint32_t me = cluster_rank();
        const uint32_t red = static_cast<uint32_t>(__cvta_generic_to_shared(tile_s));
        const uint32_t slot = (me * 2 + kl) * per;
        // every block's barrier stands (waiting for that earlier, after the
        // first stage, held the products up: 0.2 to 0.7 µs a call)
        cluster_wait();
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {   // rows g and g + 8
          const int row = g + 8 * hr;
          if (row >= rows) continue;
          if constexpr (F == kI8Rows) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int col = cg * 32 + 8 * j + 2 * t;
              const uint32_t owner = col >> wshift;
              push2(map_to_rank(red + (slot + row * wide + (col & (wide - 1))) * 4, owner),
                    map_to_rank(pushed, owner), acc[0][j][2 * hr], acc[0][j][2 * hr + 1]);
            }
          } else {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = cg * 32 + 8 * t + 4 * e;
              const uint32_t owner = col >> wshift;
              push4(map_to_rank(red + (slot + row * wide + (col & (wide - 1))) * 4, owner),
                    map_to_rank(pushed, owner), acc[0][0][2 * hr + e], acc[0][1][2 * hr + e],
                    acc[0][2][2 * hr + e], acc[0][3][2 * hr + e]);
            }
          }
        }
        stamp(4);
        mbar_wait(pushed, 0);
        stamp(5);
        for (int i = tid; i < per; i += kThreads) {
          const int row = i >> wshift, col = ct * kBN + me * wide + (i & (wide - 1));
          if (col >= a.n) continue;
          float s = tile_s[i];
          for (int q = 1; q < 2 * a.csize; ++q) s += tile_s[q * per + i];
          if constexpr (F != kI4) s *= a.scale[col];
          store_out(a.out, a.out_f32, static_cast<size_t>(m0 + row) * a.n + col, s);
        }
        break;   // a cluster's block walks one tile
      }
    }
    // the two k warps meet in tile_s
#pragma unroll
    for (int pass = 1; pass >= 0; --pass) {
      if (kl == pass) {
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int cc = cg * 32 + (F == kI8Rows ? 8 * j + 2 * t + e : 8 * t + 4 * e + j);
              float* lo = tile_s + (mi * 16 + g) * R::kTileStride + cc;
              float* hi = lo + 8 * R::kTileStride;
              if (pass == 1) {
                *lo = acc[mi][j][e];
                *hi = acc[mi][j][2 + e];
              } else {
                *lo += acc[mi][j][e];
                *hi += acc[mi][j][2 + e];
              }
              acc[mi][j][e] = acc[mi][j][2 + e] = 0.f;
            }
      }
      consumer_sync();
    }

    // the blocks that walk this tile: first, last
    const unsigned t0 = static_cast<unsigned>(tile) * a.nchunks;
    const int bf = static_cast<int>(((t0 + 1) * grid - 1) / a.units);
    const int bl = static_cast<int>(((t0 + a.nchunks) * grid - 1) / a.units);
    const int parts = bl - bf + 1;
    if (parts == 1) {
      for (int i = tid; i < rows * kBN; i += kThreads) {
        const int row = i / kBN, cb = i % kBN;
        const int col = ct * kBN + cb;
        if (col >= a.n) continue;
        float s = tile_s[row * R::kTileStride + cb];
        if constexpr (F != kI4) s *= a.scale[col];
        store_out(a.out, a.out_f32, static_cast<size_t>(m0 + row) * a.n + col, s);
      }
    } else {
      // slot 0: the partial tile of a run's start; slot 1: of a tile's start
      constexpr size_t kSlot = static_cast<size_t>(MT) * 16 * kBN;
      constexpr int kVecRow = kBN / 4;   // a thread moves four columns at a time
      const int nvec = rows * kVecRow;
      float4* mine = reinterpret_cast<float4*>(
          a.scratch + (static_cast<size_t>(blockIdx.x) * 2 + (u0 >= t0 ? 0 : 1)) * kSlot);
      for (int i = tid; i < nvec; i += kThreads)
        mine[i] = *reinterpret_cast<const float4*>(tile_s + (i / kVecRow) * R::kTileStride +
                                                   (i % kVecRow) * 4);
      stamp(4);
      const bool last = arrive_last<true>(a.counters + tile, parts);
      stamp(5);
      if (last) {
        // only block bf can have started before the tile. A thread requests
        // kUn vectors of a partial tile before it adds the first: one trip to
        // the L2 per partial tile, where a loop value by value made one per
        // value (32 in a row for a tile of 64 rows: 9 µs)
        constexpr int kUn = MT == 1 ? 1 : 4;
        const float4* first = reinterpret_cast<const float4*>(
            a.scratch + (static_cast<size_t>(bf) * 2 + (bf * a.units / grid >= t0 ? 0 : 1)) * kSlot);
        for (int i0 = tid; i0 < nvec; i0 += kThreads * kUn) {
          float4 sum[kUn];
#pragma unroll
          for (int u = 0; u < kUn; ++u) {
            const int i = i0 + u * kThreads;
            sum[u] = i < nvec ? __ldcg(first + i) : make_float4(0.f, 0.f, 0.f, 0.f);
          }
          for (int b = bf + 1; b <= bl; ++b) {
            const float4* part =
                reinterpret_cast<const float4*>(a.scratch + static_cast<size_t>(b) * 2 * kSlot);
            float4 v[kUn];
#pragma unroll
            for (int u = 0; u < kUn; ++u) {
              const int i = i0 + u * kThreads;
              v[u] = i < nvec ? __ldcg(part + i) : make_float4(0.f, 0.f, 0.f, 0.f);
            }
#pragma unroll
            for (int u = 0; u < kUn; ++u) {
              sum[u].x += v[u].x;
              sum[u].y += v[u].y;
              sum[u].z += v[u].z;
              sum[u].w += v[u].w;
            }
          }
#pragma unroll
          for (int u = 0; u < kUn; ++u) {
            const int i = i0 + u * kThreads;
            if (i >= nvec) continue;
            const int row = i / kVecRow, col = ct * kBN + (i % kVecRow) * 4;
            const float sv[4] = {sum[u].x, sum[u].y, sum[u].z, sum[u].w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if (col + e >= a.n) continue;
              float r = sv[e];
              if constexpr (F != kI4) r *= a.scale[col + e];
              store_out(a.out, a.out_f32, static_cast<size_t>(m0 + row) * a.n + col + e, r);
            }
          }
        }
      }
    }
    consumer_sync();   // tile_s is free for the next tile
    c = ci = 0;
    ++tile;
  }
  stamp(6);
}

// (K rows, N columns) weights on the CUDA cores: K4 (F == kI4) and the
// (in, out) K2 (F == kI8), for f32 x and what `qmm_stream` refuses. Grid:
// (column tiles, K splits, tiles of 8 rows).
template <int F>
__global__ void __launch_bounds__(kThreads) qmm_kn(const Args a) {
  constexpr int kHalves = F == kI4 ? 2 : 1;
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* xs = smem + warp * (kHalves * kR * kMT);  // [half][row][m]
  float* acc_all = smem + kWarps * kHalves * kR * kMT;
  float* acc_s = acc_all + warp * (kMT * kBN);     // [m][column]

  const int col0 = blockIdx.x * kBN + lane * kCols;
  const int m0 = blockIdx.z * kMT;
  const int rows_total = F == kI4 ? a.k / 2 : a.k;
  const int grows = F == kI4 ? a.group : rows_total;
  const int spg = (grows + kR - 1) / kR;           // chunks per group
  const int nchunks = (rows_total / grows) * spg;
  const int c_begin = blockIdx.y * a.cpb;
  const int c_end = min(c_begin + a.cpb, nchunks);
  const bool vec = col0 + kCols <= a.nw && (a.ldw & 3) == 0 &&
                   ((reinterpret_cast<uintptr_t>(a.w) + col0) & 3) == 0;

  for (int i = lane; i < kMT * kBN; i += 32) acc_s[i] = 0.f;

  for (int c = c_begin + warp; c < c_end; c += kWarps) {
    const int g = c / spg;
    const int r0 = g * grows + (c % spg) * kR;
    const int nrows = min(kR, (g + 1) * grows - r0);
    // the first weight rows are requested before x is staged
    const int8_t* wr = a.w + static_cast<size_t>(r0) * a.ldw + col0;
    uint32_t wv[kFlight];
#pragma unroll
    for (int i = 0; i < kFlight; ++i)
      wv[i] = i < nrows ? load_w4(wr + static_cast<size_t>(i) * a.ldw, vec, col0, a.nw)
                        : 0u;  // x is 0 there
    __syncwarp();
    // this chunk's x: lane r holds weight row r0 + r (and K/2 + r0 + r)
#pragma unroll
    for (int h = 0; h < kHalves; ++h) {
      const size_t kk = static_cast<size_t>(h) * rows_total + r0 + lane;
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi) {
        float v = 0.f;
        if (lane < nrows && m0 + mi < a.m)
          v = load_x(a.x, a.x_f32, static_cast<size_t>(m0 + mi) * a.k + kk);
        xs[(h * kR + lane) * kMT + mi] = v;
      }
    }
    __syncwarp();

    float pl[kMT][kCols], ph[kMT][kCols];
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) pl[mi][cc] = ph[mi][cc] = 0.f;

#pragma unroll 1
    for (int rb = 0; rb < kR; rb += kFlight) {
      if (rb > 0) {
#pragma unroll
        for (int i = 0; i < kFlight; ++i)
          wv[i] = rb + i < nrows
                      ? load_w4(wr + static_cast<size_t>(rb + i) * a.ldw, vec, col0, a.nw)
                      : 0u;
      }
#pragma unroll
      for (int i = 0; i < kFlight; ++i) {
        const float4* xl = reinterpret_cast<const float4*>(xs + (rb + i) * kMT);
        const float4 l0 = xl[0], l1 = xl[1];
        const float xlo[kMT] = {l0.x, l0.y, l0.z, l0.w, l1.x, l1.y, l1.z, l1.w};
        float xhi[kMT];
        if constexpr (F == kI4) {
          const float4* xh = reinterpret_cast<const float4*>(xs + (kR + rb + i) * kMT);
          const float4 h0 = xh[0], h1 = xh[1];
          xhi[0] = h0.x; xhi[1] = h0.y; xhi[2] = h0.z; xhi[3] = h0.w;
          xhi[4] = h1.x; xhi[5] = h1.y; xhi[6] = h1.z; xhi[7] = h1.w;
        }
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc) {
          // the signed byte of column cc
          const int b = static_cast<int>(wv[i] << (24 - 8 * cc)) >> 24;
          if constexpr (F == kI4) {
            const float lo = static_cast<float>((b & 15) - 8);  // offset-encoded
            const float hi = static_cast<float>(b >> 4);        // arithmetic shift
#pragma unroll
            for (int mi = 0; mi < kMT; ++mi) {
              pl[mi][cc] += xlo[mi] * lo;
              ph[mi][cc] += xhi[mi] * hi;
            }
          } else {
            const float q = static_cast<float>(b);
#pragma unroll
            for (int mi = 0; mi < kMT; ++mi) pl[mi][cc] += xlo[mi] * q;
          }
        }
      }
    }

    // scale the chunk's partial sums (K4) and add them to the warp's tile
    float slo[kCols], shi[kCols];
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) {
      slo[cc] = 1.f;
      shi[cc] = 0.f;
      if constexpr (F == kI4) {
        const int col = col0 + cc;
        const int ngh = rows_total / grows;  // groups per half of K
        slo[cc] = col < a.n ? a.scale[static_cast<size_t>(g) * a.n + col] : 0.f;
        shi[cc] = col < a.n ? a.scale[static_cast<size_t>(ngh + g) * a.n + col] : 0.f;
      }
    }
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi) {
      float4* t = reinterpret_cast<float4*>(acc_s + mi * kBN + lane * kCols);
      float4 v = *t;
      if constexpr (F == kI4) {
        v.x += slo[0] * pl[mi][0] + shi[0] * ph[mi][0];
        v.y += slo[1] * pl[mi][1] + shi[1] * ph[mi][1];
        v.z += slo[2] * pl[mi][2] + shi[2] * ph[mi][2];
        v.w += slo[3] * pl[mi][3] + shi[3] * ph[mi][3];
      } else {
        v.x += pl[mi][0];
        v.y += pl[mi][1];
        v.z += pl[mi][2];
        v.w += pl[mi][3];
      }
      *t = v;
    }
  }
  __syncthreads();

  const int nsplit = gridDim.y;
  for (int i = threadIdx.x; i < kMT * kBN; i += kThreads) {
    const int mrow = m0 + i / kBN;
    const int col = blockIdx.x * kBN + i % kBN;
    if (mrow >= a.m || col >= a.n) continue;
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) s += acc_all[wi * kMT * kBN + i];
    if (nsplit == 1) {
      if constexpr (F == kI8) s *= a.scale[col];
      store_out(a.out, a.out_f32, static_cast<size_t>(mrow) * a.n + col, s);
    } else {
      a.scratch[(static_cast<size_t>(blockIdx.y) * a.m + mrow) * a.n + col] = s;
    }
  }
  if (nsplit == 1) return;
  // the K splits of this tile meet: the last block to arrive sums them in order
  if (!arrive_last<false>(a.counters + blockIdx.z * gridDim.x + blockIdx.x, nsplit)) return;
  for (int i = threadIdx.x; i < kMT * kBN; i += kThreads) {
    const int mrow = m0 + i / kBN;
    const int col = blockIdx.x * kBN + i % kBN;
    if (mrow >= a.m || col >= a.n) continue;
    float s = 0.f;
    for (int sp = 0; sp < nsplit; ++sp)
      s += __ldcg(a.scratch + (static_cast<size_t>(sp) * a.m + mrow) * a.n + col);
    if constexpr (F == kI8) s *= a.scale[col];
    store_out(a.out, a.out_f32, static_cast<size_t>(mrow) * a.n + col, s);
  }
}

__device__ inline float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// (N rows, K columns) int8 weights on the CUDA cores, for f32 x and what
// `qmm_stream` refuses; K % 4 == 0.
__global__ void __launch_bounds__(kThreads) qmm_rows(const Args a) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n0 = (blockIdx.x * kWarps + warp) * kRowsNK;
  const int m0 = blockIdx.y * kMT;
  if (n0 >= a.n) return;
  float acc[kRowsNK][kMT];
#pragma unroll
  for (int r = 0; r < kRowsNK; ++r)
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi) acc[r][mi] = 0.f;

  for (int k0 = lane * 4; k0 < a.k; k0 += 128) {
    uint32_t wv[kRowsNK];
#pragma unroll
    for (int r = 0; r < kRowsNK; ++r)
      wv[r] = n0 + r < a.n ? *reinterpret_cast<const uint32_t*>(
                                 a.w + static_cast<size_t>(n0 + r) * a.ldw + k0)
                           : 0u;
    float xv[kMT][4];
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi) {
      const size_t at = static_cast<size_t>(m0 + mi) * a.k + k0;
      if (m0 + mi >= a.m) {
        xv[mi][0] = xv[mi][1] = xv[mi][2] = xv[mi][3] = 0.f;
      } else if (a.x_f32) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(a.x) + at));
        xv[mi][0] = v.x; xv[mi][1] = v.y; xv[mi][2] = v.z; xv[mi][3] = v.w;
      } else {
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(
            static_cast<const __nv_bfloat16*>(a.x) + at));
        const float2 p0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
        const float2 p1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
        xv[mi][0] = p0.x; xv[mi][1] = p0.y; xv[mi][2] = p1.x; xv[mi][3] = p1.y;
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsNK; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float q = static_cast<float>(static_cast<int>(wv[r] << (24 - 8 * j)) >> 24);
#pragma unroll
        for (int mi = 0; mi < kMT; ++mi) acc[r][mi] += xv[mi][j] * q;
      }
  }
#pragma unroll
  for (int r = 0; r < kRowsNK; ++r)
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi) {
      const float s = warp_sum(acc[r][mi]);
      // value r·8 + mi is written by lane (r·8 + mi) % 32
      if (((r * kMT + mi) & 31) == lane && n0 + r < a.n && m0 + mi < a.m)
        store_out(a.out, a.out_f32, static_cast<size_t>(m0 + mi) * a.n + n0 + r,
                  s * a.scale[n0 + r]);
    }
}

// Nothing: the time of a launch by itself, the floor under every call.
__global__ void empty_kernel() {}

template <int F, int MT>
int launch_stream(const Args& a, int blocks, cudaStream_t s) {
  using R = Ring<F, MT>;
  const int rows_total = F == kI4 ? a.k / 2 : a.k;
  CUtensorMap wmap, xmap, smap;
  bool made =
      (F == kI8Rows
           ? tensor_map(a.w, CU_TENSOR_MAP_DATA_TYPE_UINT8, a.k, a.n, a.ldw, kSR, kBN, &wmap)
           : tensor_map(a.w, CU_TENSOR_MAP_DATA_TYPE_UINT8, a.nw, rows_total, a.ldw, kBN, kSR,
                        &wmap)) &&
      // x (M, K) bf16 in boxes of 16·MT rows × 64 k (a decode step's 8 rows: 8)
      tensor_map(a.x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a.k, a.m, 2ll * a.k, kSR,
                 MT == 1 && a.m <= 8 ? 8 : MT * 16, &xmap);
  smap = wmap;
  if (made && F == kI4 && a.bulk)   // K4's scales (K/G, N) f32 in boxes of one row × 128 columns
    made = tensor_map(a.scale, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, a.n, a.k / a.group, 4ll * a.n, kBN,
                      1, &smap);
  if (!made) return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;   // once per process
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        qmm_stream<F, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, R::kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  if (a.csize == 1) {
    qmm_stream<F, MT><<<blocks, kStreamThreads, R::kSmem, s>>>(a, wmap, xmap, smap);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kStreamThreads);
  cfg.dynamicSmemBytes = R::kSmem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, qmm_stream<F, MT>, a, wmap, xmap, smap));
}

template <int F>
int launch_kn(const Args& a, int nsplit, cudaStream_t s) {
  constexpr int kHalves = F == kI4 ? 2 : 1;
  const size_t smem =
      static_cast<size_t>(kWarps) * (kHalves * kR * kMT + kMT * kBN) * sizeof(float);
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        qmm_kn<F>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid((a.n + kBN - 1) / kBN, nsplit, (a.m + kMT - 1) / kMT);
  qmm_kn<F><<<grid, kThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

inline bool aligned(const void* p, uintptr_t to) {
  return reinterpret_cast<uintptr_t>(p) % to == 0;
}

}  // namespace

#ifdef QMM_TRACE
// Copy the stamps of the last `qmm_stream` launch to `host` (1024 × 8 u64).
extern "C" int tts_qmm_trace(unsigned long long* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, qmm_trace_buf, sizeof(qmm_trace_buf)));
}

// The same for the stamps by unit (1024 × 3 × 16 u64).
extern "C" int tts_qmm_trace_units(unsigned long long* host) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(host, qmm_trace_units, sizeof(qmm_trace_units)));
}
#endif

// One launch of an empty kernel on `stream`.
extern "C" int tts_empty_kernel(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// x (M, K) · weights → out (M, N), one launch. fmt: 0 = K4, 1 = K2 (in, out),
// 2 = K2 (out, in) rows; ldw = bytes between weight rows; nw = weight columns
// that may be read (K4: Np; K2: n); group = K4's scale group; x_dtype /
// out_dtype: 0 = bfloat16, 1 = float32. The plan is the wrapper's
// (ops/int4_matmul.py::plan): path 1 = `qmm_stream` with p0 rows of x per
// block (16 or 64) on p1 blocks in clusters of p2 (1: none); path 0 = the CUDA
// cores with p0 K splits of p1 chunks ((N, K) weights: one split). scratch
// (f32) and counters (int32, all 0) as the plan sizes them; they may be null
// where it asks for none. Returns the launch's cudaError_t.
extern "C" int tts_quant_matmul(const void* x, const void* w, const void* scale, void* out,
                                void* scratch, void* counters, int fmt, int m, int k, int n,
                                long long ldw, int nw, int group, int x_dtype, int out_dtype,
                                int path, int p0, int p1, int p2, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (m < 1 || k < 2 || n < 1 || nw < n || x_dtype < 0 || x_dtype > 1 || out_dtype < 0 ||
      out_dtype > 1 || fmt < kI4 || fmt > kI8Rows || p0 < 1 || p1 < 1)
    return bad;
  if (fmt == kI4 && (k % 2 || group < 1 || (k / 2) % group)) return bad;
  Args a{x, static_cast<const int8_t*>(w), static_cast<const float*>(scale), out,
         static_cast<float*>(scratch), static_cast<int*>(counters), m, k, n, ldw, nw, group,
         x_dtype, out_dtype, 0, 0, 0, 0, 1, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == 1) {
    // 16-byte requests for the weights and x; chunks that start on 8 k
    if (x_dtype != 0 || !aligned(w, 16) || !aligned(x, 16) || ldw % 16 || k % 8) return bad;
    if (fmt == kI4 && (group % 8 || (k / 2) % 8)) return bad;
    if (fmt != kI8Rows && nw % 16) return bad;
    if (p0 != 16 && p0 != 64) return bad;
    const int rows_total = fmt == kI4 ? k / 2 : k;
    const int grows = fmt == kI4 ? group : rows_total;
    a.nchunks = (rows_total / grows) * ((grows + kSR - 1) / kSR);
    a.nmt = (m + p0 - 1) / p0;
    const long long units = static_cast<long long>((n + kBN - 1) / kBN) * a.nmt * a.nchunks;
    // the blocks' runs are cut in 32-bit arithmetic
    if (p1 > units || (units + 1) * p1 >= (1ll << 32)) return bad;
    a.units = static_cast<unsigned>(units);
    // a cluster's blocks share one tile: p1 = tiles × p2, p2 | 128 columns
    a.csize = p2;
    a.scale16 = fmt == kI4 && n % 4 == 0 && aligned(scale, 16);
    // every chunk whole (x by the copy engine) and K4's scale rows on 16 bytes
#ifndef QMM_NO_BULK   // probe build without: x and the scales by cp.async of all lanes
    a.bulk = grows % kSR == 0 && (fmt != kI4 || a.scale16);
#endif
    if (p2 < 1 || p2 > 8 || kBN % p2 || p2 > a.nchunks || (p2 > 1 && (m > 16 || p0 != 16)))
      return bad;
    if (p2 > 1 && static_cast<long long>(p1) * a.nchunks != units * p2) return bad;
    if (p2 == 1 && p1 > 1 && (scratch == nullptr || counters == nullptr)) return bad;
    if (p0 == 16) {
      if (fmt == kI4) return launch_stream<kI4, 1>(a, p1, s);
      if (fmt == kI8) return launch_stream<kI8, 1>(a, p1, s);
      return launch_stream<kI8Rows, 1>(a, p1, s);
    }
    if (fmt == kI4) return launch_stream<kI4, 4>(a, p1, s);
    if (fmt == kI8) return launch_stream<kI8, 4>(a, p1, s);
    return launch_stream<kI8Rows, 4>(a, p1, s);
  }
  if (path != 0) return bad;
  if (fmt == kI8Rows) {
    if (k % 4 || ldw % 4 || !aligned(w, 4) || !aligned(x, 16) || p0 != 1) return bad;
    const dim3 grid((n + kWarps * kRowsNK - 1) / (kWarps * kRowsNK), (m + kMT - 1) / kMT);
    qmm_rows<<<grid, kThreads, 0, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  if (p0 > 1 && (scratch == nullptr || counters == nullptr)) return bad;
  a.cpb = p1;
  return fmt == kI4 ? launch_kn<kI4>(a, p0, s) : launch_kn<kI8>(a, p0, s);
}
