// Shared device core of the two log-mel kernels: windowed DFT -> power -> mel
// -> sqrt(log10(x + 1)) on Hopper's tensor cores (wgmma), for one row tile of
// frames per block, with the projection never leaving the SM.
//
// Used by frame_mel.cu (K1: frames cut from a chunk buffer) and dft_mel.cu
// (K2: rows of a gathered frame matrix).  Each supplies a *loader*: how a
// block's frames get into shared memory, where an element of a frame lies
// there, and where a finished value goes.  The core is a template over the
// loader (which also fixes the output type) and the number of bf16 parts of
// the DFT product.
//
// The chain, per block (a tile of 128 or 64 frames):
//   1. proj = X @ W over one 64-bin slice at a time, W's slice laid out as
//      [re 64 | im 64] columns: wgmma m64n128k16, bf16 operands, float32
//      accumulators.  X stays in shared memory as float32 (the only form in
//      which a tile fits beside the W ring); each consumer thread loads its
//      A fragment, splits it into bf16 parts in registers (round to nearest
//      even on the float32 value, then on the remainder) and feeds the
//      register-A form of wgmma.  W comes from shared memory.
//      Parts and passes: NP = 1 is x_hi*w_hi ("default"); NP = 2 adds
//      x_lo*w_hi and x_hi*w_lo ("high", the terms of the TPU kernel's
//      _dft_dot_bf16); NP = 3 is the exact 8+8+8-bit split with the six
//      products of weight >= 2^-16 (hi*hi, mid*hi, lo*hi, hi*mid, mid*mid,
//      hi*lo: "highest" and K2).  In general part i of X meets part j of W
//      when i + j < NP.  This is 6 x bf16, not 3 x TF32.
//   2. power = re^2 + im^2 in float32 on the accumulator fragment: with the
//      [re | im] column layout a bin's two values are registers d[i] and
//      d[32 + i] of one thread.
//   3. mel += power @ fb[slice], again wgmma with register A: the power
//      fragment of one product is, register for register, the A fragment of
//      the next.  Always the six-pass split (float32 class) whatever NP is,
//      as the TPU kernel keeps this product at its highest precision.
//   4. sqrt(log10(mel + 1)) through a shared staging tile, stored with the
//      frame index fastest, 8 frames (32 or 16 bytes) a thread.
//
// Block shape: 384 threads.  Warpgroups 0 and 1 consume; warp 8 produces:
// one thread streams the tables through a ring of 16 KiB slots with bulk
// asynchronous copies (cp.async.bulk + mbarrier complete_tx).  The wrapper
// lays the tables out in exactly the order and the 128-byte-swizzled form in
// which the kernel consumes them (ops/mel_core.py), so a slot is one
// contiguous copy and no tensor map is needed.  A tile is 128 rows (output
// columns: [re | im] of a slice, or mel bands) by 64 values along the
// product's inner dimension, K-major, which is what the wgmma descriptor
// below describes.  Per slice the stream holds 8 k-chunks x NP parts of W,
// then 3 parts of fb.
//
// With 128-frame tiles (K1) each warpgroup owns 64 frames and both read
// every slot.  With 64-frame tiles (K2: 128 float32 rows do not fit) both
// warpgroups work on the same 64 frames and split the bin slices (even /
// odd); the stream then alternates between the two and their mel sums are
// added in the staging tile.
//
// What is left for later: a persistent block that stages the next tile's
// frames under the current tile's products; frames kept as bf16 in shared
// memory in the one-part form (its float32 A loads and the B tiles together
// ask for all of the shared memory's bandwidth); and multicast of the table
// stream across a cluster (K2's 64-frame tiles pull the tables through L2
// twice as often as K1's).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace mel_core {

constexpr int kWin = 512;                  // samples per frame
constexpr int kBins = 768;                 // DFT bins computed (mel weight is 0 above 743)
constexpr int kMels = 128;
constexpr int kSlice = 64;                 // bins per slice
constexpr int kSlices = kBins / kSlice;    // 12
constexpr int kChunk = 64;                 // inner-dimension values per tile
constexpr int kChunks = kWin / kChunk;     // 8 k-chunks per slice
constexpr int kSteps = kChunk / 16;        // wgmma k16 steps per tile
constexpr int kFbParts = 3;                // the mel product is always six-pass
constexpr int kTileBytes = 128 * kChunk * 2;
constexpr int kConsumerThreads = 256;
constexpr int kThreads = 384;
constexpr int kSmemMax = 232448;           // bytes a block may ask for on sm_90
constexpr int kBarrierBytes = 256;         // room for the ring's mbarriers

__host__ __device__ constexpr int tiles_per_slice(int np) { return kChunks * np + kFbParts; }

// ---------------------------------------------------------------- PTX ----
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// returns once the barrier's phase differs from `parity`
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
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
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// asynchronous global -> shared copies of one thread (4 or 16 bytes each):
// all of a thread's copies are in flight at once, which a loop of loads is not
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void consumer_sync() {  // the two consumer warpgroups
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerThreads) : "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Shared-memory descriptor of a K-major bf16 tile with 128-byte swizzle:
// rows of 128 bytes, 8-row groups 1024 bytes apart; the tile is 1024-byte
// aligned.  A k16 step further along the inner dimension is +32 bytes, i.e.
// +2 in the (address >> 4) field.
__device__ __forceinline__ uint64_t tile_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

// d (64 x 128 float32 fragment) = a (64 x 16 bf16, registers) @ B (16 x 128
// bf16, shared memory) + (accumulate ? d : 0)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// (x0, x1) -> NP packed bf16 pairs whose sum is (x0, x1) as far as NP parts
// reach: part 0 = bf16(x), part p = bf16(what parts < p left over).
template <int NP>
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t (&parts)[NP]) {
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);  // .x (low half) = x0
    parts[p] = *reinterpret_cast<const uint32_t*>(&h);
    if (p + 1 < NP) {
      x0 -= __low2float(h);   // exact in float32
      x1 -= __high2float(h);
    }
  }
}

// ------------------------------------------------------------ layout ----
// Dynamic shared memory of a block, from a 1024-byte aligned base:
//   ring    kSlots x 16 KiB table tiles
//   region  the tile's frames (float32), later the staging tile (128 mels x
//           (rows + 4) float32)
//   bars    kSlots "full" + kSlots "empty" mbarriers
template <class Loader>
struct Layout {
  static constexpr int kStageLd = Loader::kRows + 4;  // +4: conflict-free fragment writes
  static constexpr int kStageBytes = kMels * kStageLd * 4;
  static constexpr int kXBytes = Loader::kXFloats * 4;
  static constexpr int kRegionBytes =
      ((kXBytes > kStageBytes ? kXBytes : kStageBytes) + 15) / 16 * 16;
  static constexpr int kSlots = (kSmemMax - 1024 - kBarrierBytes - kRegionBytes) / kTileBytes;
  static constexpr int kBytes = 1024 + kSlots * kTileBytes + kRegionBytes + kBarrierBytes;
  static_assert(kSlots >= 3 && 2 * kSlots * 8 <= kBarrierBytes, "a ring of a few slots");
};

// A consumer's view of the ring: the slot it reads next.
template <int SLOTS, int STRIDE>
struct Ring {
  uint32_t tiles, full, empty;  // shared-memory addresses
  int slot, phase, prev;
  __device__ __forceinline__ void wait_full() const { mbar_wait(full + 8 * slot, phase); }
  __device__ __forceinline__ uint64_t desc() const { return tile_desc(tiles + slot * kTileBytes); }
  __device__ __forceinline__ void advance() {
    prev = slot;
    slot += STRIDE;
    if (slot >= SLOTS) { slot -= SLOTS; phase ^= 1; }
  }
  // hand the slot before the current one back to the producer (one arrival
  // a warp, after the warp's wgmma reads of it have completed)
  __device__ __forceinline__ void release_prev() const {
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty + 8 * prev);
  }
};

// d += sum over the parts i of A and j of B with i + j < NP of a[.][i] @ tile j,
// over the NP tiles that come next in the ring (part 0 first).  `zero` makes
// the first product overwrite d.  On return the last tile's products are
// still in flight: neither d nor a may be touched before product_finish.
template <int NP, class RingT>
__device__ __forceinline__ void product_issue(float (&d)[64], const uint32_t (&a)[kSteps][3][4],
                                              bool zero, RingT& ring) {
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    ring.wait_full();
    const uint64_t desc = ring.desc();
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks)
#pragma unroll
      for (int i = 0; i < NP - j; ++i)
        wgmma_m64n128k16(d, a[ks][i], desc + 2 * ks, !(zero && j == 0 && ks == 0 && i == 0));
    wgmma_commit();
    if (j > 0) {
      wgmma_wait<1>();
      ring.release_prev();
    }
    ring.advance();
  }
}
// Waits for the products in flight.  The empty asm statements then "use"
// every register the products read or wrote, so that the compiler keeps
// them untouched up to here: it does not know that a wgmma goes on reading
// its register operands after the statement that issued it.
template <int NP, class RingT>
__device__ __forceinline__ void product_finish(float (&d)[64], uint32_t (&a)[kSteps][3][4],
                                               const RingT& ring) {
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks)
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int h = 0; h < 4; ++h) asm volatile("" : "+r"(a[ks][p][h])::"memory");
  ring.release_prev();
}

// The A fragments of k-chunk kc for this thread's two rows (r0, r0 + 8), as
// NP bf16 parts: a[ks][p] is the m64k16 fragment of k16 step ks, part p.
template <class Loader, int NP>
__device__ __forceinline__ void load_fragments(const float* xs, int r0, int t, int kc,
                                               uint32_t (&a)[kSteps][3][4]) {
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
    const int k = kc * kChunk + ks * 16 + 2 * t;
    const float2 v[4] = {*reinterpret_cast<const float2*>(xs + Loader::xoff(r0, k)),
                         *reinterpret_cast<const float2*>(xs + Loader::xoff(r0 + 8, k)),
                         *reinterpret_cast<const float2*>(xs + Loader::xoff(r0, k + 8)),
                         *reinterpret_cast<const float2*>(xs + Loader::xoff(r0 + 8, k + 8))};
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      uint32_t parts[NP];
      split_pair<NP>(v[h].x, v[h].y, parts);
#pragma unroll
      for (int p = 0; p < NP; ++p) a[ks][p][h] = parts[p];
    }
  }
}

// One 64-bin slice for a warpgroup: proj over 8 k-chunks, power, mel.
// A warpgroup converts a chunk's fragments, issues the chunk's products and
// waits for them; the other warpgroup's products fill the tensor cores
// meanwhile.  (A second fragment set, converted under the warpgroup's own
// products, was tried with one and two parts and gained nothing: there the
// float32 A loads and the B tiles together already ask for the whole of the
// shared memory's bandwidth.)
template <class Loader, int NP, class RingT>
__device__ __forceinline__ void slice(const float* xs, int r0, int t, float (&acc)[64],
                                      float (&mel)[64], RingT& ring) {
  uint32_t a[kSteps][3][4];
#pragma unroll 1
  for (int kc = 0; kc < kChunks; ++kc) {
    load_fragments<Loader, NP>(xs, r0, t, kc, a);
    product_issue<NP>(acc, a, kc == 0, ring);
    product_finish<NP>(acc, a, ring);
  }
  // power on the accumulator fragment; its registers are the next A fragment
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks)
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int i = 8 * ks + 2 * h;
      uint32_t parts[3];
      split_pair<3>(acc[i] * acc[i] + acc[32 + i] * acc[32 + i],
                    acc[i + 1] * acc[i + 1] + acc[33 + i] * acc[33 + i], parts);
#pragma unroll
      for (int p = 0; p < 3; ++p) a[ks][p][h] = parts[p];
    }
  // mel += power @ fb[slice], six passes
  product_issue<3>(mel, a, false, ring);
  product_finish<3>(mel, a, ring);
}

// ------------------------------------------------------------ kernel ----
// Loader concept:
//   static constexpr int kRows        frames per tile: 128, or 64 (then the
//                                     warpgroups split the slices)
//   static constexpr int kXFloats     float32 values of a staged tile
//   bool stage(float* xs, int tile, int tid) const
//                                     fill xs with the 256 consumer threads;
//                                     false if the tile's output is NaN
//   static int xoff(int row, int k)   where frame `row`'s sample k (even)
//                                     lies in xs; k + 1 follows it
//   void store8(void* out, int tile, int mel, int row8, const float (&v)[8]) const
//                                     store rows row8..row8+7 of band `mel`
template <class Loader, int NP>
__global__ void __launch_bounds__(kThreads, 1)
mel_core_kernel(const Loader ld, const __nv_bfloat16* __restrict__ stream,
                void* __restrict__ out) {
  using L = Layout<Loader>;
  constexpr bool kSplit = Loader::kRows == 64;
  constexpr int kSlots = L::kSlots;
  constexpr int kTps = tiles_per_slice(NP);
  static_assert(Loader::kRows == 64 || Loader::kRows == 128, "one or two 64-row warpgroups");

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* sm = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  float* xs = reinterpret_cast<float*>(sm + kSlots * kTileBytes);
  const uint32_t tiles = smem_u32(sm);
  const uint32_t full = tiles + kSlots * kTileBytes + L::kRegionBytes;
  const uint32_t empty = full + 8 * kSlots;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kSplit ? 4 : 8);  // consumer warps that read a slot
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int tile = blockIdx.x;
  if (threadIdx.x >= kConsumerThreads) {
    // ================= producer: stream the tables through the ring ======
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == kConsumerThreads) {
      int slot = 0, phase = 0;
      for (int p = 0; p < kSlices * kTps; ++p) {
        // split: position p belongs to warpgroup p & 1, which walks the
        // slices of its own parity
        const int idx = kSplit ? (((p >> 1) / kTps * 2 + (p & 1)) * kTps + (p >> 1) % kTps) : p;
        mbar_wait(empty + 8 * slot, phase ^ 1);
        mbar_expect_tx(full + 8 * slot, kTileBytes);
        bulk_copy(tiles + slot * kTileBytes, stream + (size_t)idx * (kTileBytes / 2), kTileBytes,
                  full + 8 * slot);
        if (++slot == kSlots) { slot = 0; phase ^= 1; }
      }
    }
  } else {
    // ================= consumers =========================================
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int tid = threadIdx.x;
    // the warpgroup index through a shuffle, so that the compiler knows it
    // to be uniform in the warp (it steers the ring in the split form)
    const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
    const int lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    // this thread's fragment rows within the tile: r0 and r0 + 8
    const int r0 = (kSplit ? 0 : 64 * wg) + 16 * ((tid >> 5) & 3) + g;

    const bool in_range = ld.stage(xs, tile, tid);
    consumer_sync();

    Ring<kSlots, kSplit ? 2 : 1> ring{tiles, full, empty, kSplit ? wg : 0, 0, 0};
    float acc[64], mel[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) { acc[i] = 0.f; mel[i] = 0.f; }
    for (int s = 0; s < (kSplit ? kSlices / 2 : kSlices); ++s)
      slice<Loader, NP>(xs, r0, t, acc, mel, ring);

    // ---- staging tile (mel, row), then compression and the store ----
    consumer_sync();  // every warpgroup is done reading the frames
    float* st = xs;
    constexpr int kLd = L::kStageLd;
#pragma unroll
    for (int pass = 0; pass < (kSplit ? 2 : 1); ++pass) {
      if (!kSplit || wg == pass) {
#pragma unroll
        for (int c = 0; c < 16; ++c) {
          float* p0 = st + (8 * c + 2 * t) * kLd + r0;
          if (pass == 0) {
            p0[0] = mel[4 * c];
            p0[kLd] = mel[4 * c + 1];
            p0[8] = mel[4 * c + 2];
            p0[kLd + 8] = mel[4 * c + 3];
          } else {
            p0[0] += mel[4 * c];
            p0[kLd] += mel[4 * c + 1];
            p0[8] += mel[4 * c + 2];
            p0[kLd + 8] += mel[4 * c + 3];
          }
        }
      }
      consumer_sync();
    }
    constexpr int kGroups = Loader::kRows / 8;
    for (int item = tid; item < kMels * kGroups; item += kConsumerThreads) {
      const int m = item / kGroups, row8 = 8 * (item % kGroups);
      const float4 lo = *reinterpret_cast<const float4*>(st + m * kLd + row8);
      const float4 hi = *reinterpret_cast<const float4*>(st + m * kLd + row8 + 4);
      float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
        v[i] = in_range ? sqrtf(log10f(v[i] + 1.0f)) : __int_as_float(0x7fc00000);
      ld.store8(out, tile, m, row8, v);
    }
  }
}

// Launch one block per tile on the current device (the wrapper makes the
// tensors' device current).  The opt-in to more than 48 KiB of dynamic
// shared memory is made once per device and kernel instance: the flag is
// atomic because the detector's worker threads launch concurrently, and
// two threads that both find it unset both make the (idempotent) call.
template <class Loader, int NP>
cudaError_t launch(const Loader& ld, int n_tiles, const void* stream_tables, void* out,
                   cudaStream_t stream) {
  static std::atomic<bool> opted_in[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!opted_in[dev].load(std::memory_order_acquire)) {
    e = cudaFuncSetAttribute(mel_core_kernel<Loader, NP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<Loader>::kBytes);
    if (e != cudaSuccess) return e;
    opted_in[dev].store(true, std::memory_order_release);
  }
  mel_core_kernel<Loader, NP><<<n_tiles, kThreads, Layout<Loader>::kBytes, stream>>>(
      ld, static_cast<const __nv_bfloat16*>(stream_tables), out);
  return cudaGetLastError();
}

}  // namespace mel_core
