// IMA-ADPCM decode of the fused engine's adpcm4 upload wire (K3).
//
// Replaces: softspoken_tpu/ops/adpcm.py:175 decode_device, a lax.scan of 255
// steps over every block's (predictor, step index) state.  It was never a
// Pallas kernel; in eager PyTorch the scan would be thousands of tiny
// launches per chunk, so it is one kernel here.
//
// Wire format (ops/adpcm.py): blocks of 132 bytes, each 256 samples:
//   [0:2]   int16 little-endian first sample (the predictor's seed)
//   [2]     uint8 initial step index, clipped to 0..88 here as on the TPU
//   [3]     reserved
//   [4:132] 255 nibbles, low nibble first; the 256th nibble is padding
// Each nibble n updates the state exactly as the WAV IMA decoder does:
//   diff = (step >> 3) + (n & 1 ? step >> 2 : 0) + (n & 2 ? step >> 1 : 0)
//          + (n & 4 ? step : 0)
//   pred = clip(n & 8 ? pred - diff : pred + diff, -32768, 32767)
//   idx  = clip(idx + INDEX[n], 0, 88)
// and the output is pred * (1/32768) as float32, exact for an int16, so the
// kernel is bit-equal to the integer reference: out[b*256 + k] for the
// global sample index below n, the tail past n not written.
//
// Bound on an H100 SXM: the bytes, (wire + 4 n) / 3.35 TB/s: 3.4 us for a
// default chunk of the 16 kHz wire (9,762 blocks, n = 2,498,976: 1.29 MB in,
// 10.0 MB out).  A thread per block walking its 255 dependent steps (the
// first design) meets a chain of ~255 x 20 cycles per block instead, with
// 1 KB-strided stores.  This design takes the chain apart.  Both updates of
// a step are maps x -> min(max(x + a, lo), hi), and such maps compose into
// one of the same form:
//   (a1, lo1, hi1) then (a2, lo2, hi2)
//     = (a1 + a2, clip(lo1 + a2, lo2, hi2), clip(hi1 + a2, lo2, hi2)),
// exactly, in integers.  So each chain is a prefix scan:
//   - one warp per wire block; lane w loads word w of the block's nibbles
//     (the warp's 128 B in one coalesced request) and holds steps 8w..8w+7;
//   - index scan: each lane composes its 8 index maps, the warp scans the 32
//     maps with __shfl_up_sync (5 rounds), and each lane walks its 8 steps
//     from the index the previous lane's prefix gives, which yields every
//     step's table lookup and so its predictor map (+-diff, clip to int16);
//   - predictor scan: the same for the 8 predictor maps of each lane;
//   - lane w writes samples 8w..8w+7 (the previous lane's last predictor,
//     one shuffle, then 7 steps) as two aligned float4 stores: the warp
//     writes its 1 KB contiguous, scalar stores only at the ragged tail.
// The padding nibble 255 is the identity map (0, -2^30, 2^30): a block's
// summed predictor adds stay below 2^24, so its bounds never overflow int32.
// Work per lane: ~30 map compositions of ~7 integer operations and 32
// shuffles, ~400 instructions over 312k lanes: a few microseconds of issue
// across 132 SMs, of the order of the bytes' bound.  CUDA blocks of 4 warps
// (32 registers a thread, so 64 warps an SM): 4 and 8 warps, and stores
// staged through shared memory for whole 512 B rows, were within 4% of each
// other on the card, 4 warps the fastest (PERF.md §6).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int SPB = 256;
constexpr int BLOCK_WORDS = 33;  // 132 bytes
constexpr int WARPS = 4;         // wire blocks per CUDA block, one a warp
constexpr int THREADS = 32 * WARPS;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int32_t PRED_LO = -32768, PRED_HI = 32767, IDX_HI = 88;
constexpr int32_t OPEN = 1 << 30;  // the identity map's bounds

__constant__ int32_t kSteps[89] = {
    7, 8, 9, 10, 11, 12, 13, 14, 16, 17, 19, 21, 23, 25, 28, 31, 34, 37,
    41, 45, 50, 55, 60, 66, 73, 80, 88, 97, 107, 118, 130, 143, 157, 173,
    190, 209, 230, 253, 279, 307, 337, 371, 408, 449, 494, 544, 598, 658,
    724, 796, 876, 963, 1060, 1166, 1282, 1411, 1552, 1707, 1878, 2066,
    2272, 2499, 2749, 3024, 3327, 3660, 4026, 4428, 4871, 5358, 5894,
    6484, 7132, 7845, 8630, 9493, 10442, 11487, 12635, 13899, 15289,
    16818, 18500, 20350, 22385, 24623, 27086, 29794, 32767};

// x -> min(max(x + a, lo), hi), lo <= hi
struct ClampAdd {
  int32_t a, lo, hi;
};

__device__ __forceinline__ int32_t clip(int32_t x, int32_t lo, int32_t hi) {
  return min(max(x, lo), hi);
}

__device__ __forceinline__ int32_t apply(const ClampAdd& f, int32_t x) {
  return clip(x + f.a, f.lo, f.hi);
}

// f, then g
__device__ __forceinline__ ClampAdd then(const ClampAdd& f, const ClampAdd& g) {
  return {f.a + g.a, clip(f.lo + g.a, g.lo, g.hi), clip(f.hi + g.a, g.lo, g.hi)};
}

// lane w ends with the maps of lanes 0..w composed in order
__device__ __forceinline__ ClampAdd warp_inclusive_scan(ClampAdd f, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const ClampAdd e{__shfl_up_sync(FULL, f.a, off), __shfl_up_sync(FULL, f.lo, off),
                     __shfl_up_sync(FULL, f.hi, off)};
    if (lane >= off) f = then(e, f);
  }
  return f;
}

// INDEX[n] of the WAV IMA table: -1 for n & 7 < 4, else 2, 4, 6, 8
__device__ __forceinline__ int32_t index_add(int32_t nib) {
  const int32_t m = nib & 7;
  return m < 4 ? -1 : 2 * (m - 3);
}

__device__ __forceinline__ int32_t pred_add(int32_t step, int32_t nib) {
  int32_t diff = step >> 3;
  if (nib & 1) diff += step >> 2;
  if (nib & 2) diff += step >> 1;
  if (nib & 4) diff += step;
  return (nib & 8) ? -diff : diff;
}

__global__ void __launch_bounds__(THREADS)
adpcm_decode_kernel(const uint32_t* __restrict__ wire, long long nb,
                    float* __restrict__ out, long long n) {
  __shared__ int32_t steps[89];
  for (int i = threadIdx.x; i < 89; i += THREADS) steps[i] = kSteps[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const long long base = b * SPB;
  // whole warps leave: the blocks past the wire, and those past n (the
  // zero-padded tail, not written)
  if (b >= nb || base >= n) return;
  const uint32_t* blk = wire + b * BLOCK_WORDS;
  const uint32_t hdr = __ldg(blk);             // one address: a broadcast
  const uint32_t word = __ldg(blk + 1 + lane);  // nibbles 8 lane .. 8 lane + 7
  const int32_t pred0 = (int32_t)(int16_t)(hdr & 0xFFFFu);    // sign-extended seed
  const int32_t idx0 = min((int32_t)((hdr >> 16) & 0xFFu), IDX_HI);  // a uint8: >= 0
  const bool pad = lane == 31;  // this lane's last nibble (255) is padding
  const ClampAdd identity{0, -OPEN, OPEN};

  // 1. the index chain: compose, scan, then walk from the lane's prefix
  ClampAdd f{index_add(word & 0xFu), 0, IDX_HI};
#pragma unroll
  for (int j = 1; j < 8; ++j) {
    const ClampAdd g{index_add((word >> (4 * j)) & 0xFu), 0, IDX_HI};
    f = then(f, (pad && j == 7) ? identity : g);
  }
  f = warp_inclusive_scan(f, lane);
  int32_t idx = __shfl_up_sync(FULL, apply(f, idx0), 1);
  if (lane == 0) idx = idx0;
  int32_t add[8];  // each step's predictor add, from the index before it
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int32_t nib = (word >> (4 * j)) & 0xFu;
    add[j] = pred_add(steps[idx], nib);
    idx = clip(idx + index_add(nib), 0, IDX_HI);
  }

  // 2. the predictor chain, the same way
  ClampAdd g{add[0], PRED_LO, PRED_HI};
#pragma unroll
  for (int j = 1; j < 8; ++j) {
    const ClampAdd h{add[j], PRED_LO, PRED_HI};
    g = then(g, (pad && j == 7) ? identity : h);
  }
  g = warp_inclusive_scan(g, lane);
  int32_t pred = __shfl_up_sync(FULL, apply(g, pred0), 1);  // sample 8 lane
  if (lane == 0) pred = pred0;

  // 3. samples 8 lane .. 8 lane + 7
  const float scale = 1.0f / 32768.0f;
  float v[8];
  v[0] = (float)pred * scale;
#pragma unroll
  for (int j = 0; j < 7; ++j) {
    pred = clip(pred + add[j], PRED_LO, PRED_HI);
    v[j + 1] = (float)pred * scale;
  }
  const long long s0 = base + 8 * lane;
  float* dst = out + s0;
  if (s0 + 8 <= n) {
    reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (s0 + j < n) dst[j] = v[j];
  }
}

}  // namespace

// wire: nb * 132 bytes, 4-byte aligned; out: n floats, 16-byte aligned,
// n <= nb * 256.  Returns the launch's cudaError_t (0 = launched).
extern "C" int adpcm_decode_launch(const void* wire, long long nb, float* out,
                                   long long n, void* stream) {
  if (nb <= 0 || n <= 0) return 0;
  if (n > nb * SPB || nb > (1LL << 40)) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(wire) % 4 || reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorMisalignedAddress;
  const long long grid = (nb + WARPS - 1) / WARPS;
  if (grid > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  adpcm_decode_kernel<<<(unsigned)grid, THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint32_t*>(wire), nb, out, n);
  return (int)cudaGetLastError();
}
