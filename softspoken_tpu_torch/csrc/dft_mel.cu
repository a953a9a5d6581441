// Windowed DFT + power + mel + log compression over gathered frames (K2).
//
// Replaces: softspoken_tpu/ops/pallas_mel.py::log_mel_from_frames_pallas
// (the Pallas TPU kernel `_kernel`, one 256-row tile per grid step, and the
// XLA transpose that follows it).
//
// What it computes, for each frame row r = b*F + f of frames (B*F, 512):
//   proj  = frames[r] @ W, W = (512, 1536) Hann-folded [cos | sin] over the
//           first 768 DFT bins.  The mel weight is exactly 0 from bin 744
//           on; the TPU kernel computes 1024 bins, whose last 256 add zeros,
//           and the plain version (ops/dft_mel.py) skips them as this does
//   power = re^2 + im^2                                      (768 bins)
//   mel   = power @ fb, fb = (768, 128)
//   out[b, m, f] = sqrt(log10(mel + 1))                      float32
// Everything is float32 with FMA on the CUDA cores: no TF32, no bf16, as
// the TPU kernel's float32 operands and float32 accumulation.
//
// Bound on an H100 SXM at the host path's shapes (B = 128, F = 256, so
// 32,768 rows): 2*32768*512*1536 = 51.5 GFLOP of DFT and 2*32768*768*128 =
// 6.4 GFLOP of mel product, 58.0 GFLOP at the float32 non-tensor peak
// (67 TFLOP/s): 0.865 ms (the TPU kernel's 1024 bins would be 77.3 GFLOP,
// 1.154 ms).  The compulsory traffic is ~87 MB (frames 67.1 MB, W 3.1 MB,
// fb 0.4 MB, out 16.8 MB), 0.026 ms at 3.35 TB/s: it is bound by operations.
//
// Design.  One block of 256 threads (8 warps) owns 64 rows.  It stages
// their frames (64 x 512, 128 KiB) in shared memory once, then walks the
// bins in 12 slices of 64.  For each slice it streams W's slice (laid out
// by the wrapper as (12, 512, 128) = [re 64 | im 64] per slice) through
// shared memory in chunks of 32 rows, the next chunk prefetched into
// registers while the current one is used.  Warp w owns rows 8w..8w+7 and
// lane l bins l and l+32 of the slice, so each thread keeps re and im of 2
// bins for 8 rows in 32 registers; the frame values are warp-wide
// broadcasts and the W values conflict-free lane-consecutive reads.  At the
// end of a slice the squared magnitudes go to the warp's own rows of a
// shared buffer (only a warp barrier is needed), and each thread adds them
// times fb into its 8 rows x 4 mels of the (64 x 128) mel accumulator,
// which stays in registers for the whole block.  So the (rows, 1536)
// projection never reaches device memory, as on the TPU.  The epilogue
// writes each row's values straight into (B, 128, F): no transpose
// follows.  Tensor cores, TMA and a deeper pipeline are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWin = 512;                        // samples per frame
constexpr int kBins = 768;                       // DFT bins computed
constexpr int kMels = 128;
constexpr int kRows = 64;                        // frame rows per block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = kRows / kWarps;     // 8
constexpr int kSlice = 64;                       // bins per slice
constexpr int kSlices = kBins / kSlice;          // 12
constexpr int kCols = 2 * kSlice;                // W columns per slice
constexpr int kChunk = 32;                       // W rows per staged chunk
constexpr int kChunks = kWin / kChunk;           // 16 chunks per slice
constexpr int kChunkVec4 = kChunk * kCols / 4 / kThreads;  // float4 per thread: 4
constexpr int kMelsPerLane = kMels / 32;         // 4

constexpr int kSmemFrames = kRows * kWin;        // floats
constexpr int kSmemW = kChunk * kCols;
constexpr int kSmemPower = kRows * kSlice;
constexpr int kSmemBytes = (kSmemFrames + kSmemW + kSmemPower) * 4;  // 160 KiB

static_assert(kSlice == 64, "each lane owns bins lane and lane + 32");
static_assert(kChunk * kCols % (4 * kThreads) == 0, "W chunk splits into float4 per thread");
static_assert(kSmemBytes <= 227 * 1024, "shared memory per block");

__device__ __forceinline__ float get(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

__global__ void __launch_bounds__(kThreads, 1)
dft_mel_kernel(const float* __restrict__ frames,   // (rows, 512)
               const float* __restrict__ wsl,      // (12, 512, 128)
               const float* __restrict__ fb,       // (768, 128)
               float* __restrict__ out,            // (B, 128, F)
               int F) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                    // (64, 512) frames
  float* ws = xs + kSmemFrames;        // (32, 128) current W chunk
  float* ps = ws + kSmemW;             // (64, 64) power of the slice

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long row0 = (long long)blockIdx.x * kRows;

  // ---- stage the block's frames (contiguous 128 KiB) ----
  {
    const float4* src = reinterpret_cast<const float4*>(frames + row0 * kWin);
    float4* dst = reinterpret_cast<float4*>(xs);
    for (int i = tid; i < kSmemFrames / 4; i += kThreads) dst[i] = src[i];
  }

  const float4* wv = reinterpret_cast<const float4*>(wsl);
  constexpr int kChunkF4 = kSmemW / 4;           // float4 per chunk
  float4 pre[kChunkVec4];
#pragma unroll
  for (int v = 0; v < kChunkVec4; ++v) pre[v] = wv[tid + v * kThreads];

  float mel[kRowsPerWarp][kMelsPerLane];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
    for (int t = 0; t < kMelsPerLane; ++t) mel[i][t] = 0.f;

  const float* xw = xs + warp * kRowsPerWarp * kWin;   // the warp's 8 rows
  float* pw = ps + warp * kRowsPerWarp * kSlice;       // their power

  for (int s = 0; s < kSlices; ++s) {
    float re0[kRowsPerWarp], re1[kRowsPerWarp], im0[kRowsPerWarp], im1[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) { re0[i] = re1[i] = im0[i] = im1[i] = 0.f; }

    for (int kc = 0; kc < kChunks; ++kc) {
      const int c = s * kChunks + kc;
      __syncthreads();  // the previous chunk is consumed (and the frames staged)
      float4* wsv = reinterpret_cast<float4*>(ws);
#pragma unroll
      for (int v = 0; v < kChunkVec4; ++v) wsv[tid + v * kThreads] = pre[v];
      __syncthreads();
      if (c + 1 < kSlices * kChunks) {
        const float4* nx = wv + (size_t)(c + 1) * kChunkF4;
#pragma unroll
        for (int v = 0; v < kChunkVec4; ++v) pre[v] = nx[tid + v * kThreads];
      }

      const float* xk = xw + kc * kChunk;
#pragma unroll 2
      for (int kk = 0; kk < kChunk; kk += 4) {
        float4 x[kRowsPerWarp];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i)
          x[i] = *reinterpret_cast<const float4*>(xk + i * kWin + kk);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float* wr = ws + (kk + q) * kCols;
          const float wr0 = wr[lane], wr1 = wr[lane + 32];
          const float wi0 = wr[kSlice + lane], wi1 = wr[kSlice + lane + 32];
#pragma unroll
          for (int i = 0; i < kRowsPerWarp; ++i) {
            const float xv = get(x[i], q);
            re0[i] = fmaf(xv, wr0, re0[i]);
            re1[i] = fmaf(xv, wr1, re1[i]);
            im0[i] = fmaf(xv, wi0, im0[i]);
            im1[i] = fmaf(xv, wi1, im1[i]);
          }
        }
      }
    }

    // ---- power of the slice into the warp's own rows ----
    __syncwarp();  // the warp is done reading the previous slice's power
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      pw[i * kSlice + lane] = re0[i] * re0[i] + im0[i] * im0[i];
      pw[i * kSlice + lane + 32] = re1[i] * re1[i] + im1[i] * im1[i];
    }
    __syncwarp();

    // ---- mel += power(8 x 64) @ fb[slice](64 x 128), mels lane + 32t ----
    const float* fbs = fb + (size_t)s * kSlice * kMels;
#pragma unroll 2
    for (int j = 0; j < kSlice; j += 4) {
      float4 p[kRowsPerWarp];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i)
        p[i] = *reinterpret_cast<const float4*>(pw + i * kSlice + j);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float wf[kMelsPerLane];
#pragma unroll
        for (int t = 0; t < kMelsPerLane; ++t) wf[t] = __ldg(fbs + (j + q) * kMels + lane + 32 * t);
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          const float pv = get(p[i], q);
#pragma unroll
          for (int t = 0; t < kMelsPerLane; ++t) mel[i][t] = fmaf(pv, wf[t], mel[i][t]);
        }
      }
    }
  }

  // ---- compression, written straight into (B, 128, F) ----
  const long long r0 = row0 + warp * kRowsPerWarp;
  if ((F & 7) == 0) {
    // the warp's 8 rows are 8 consecutive frames of one window, 32-byte
    // aligned: two float4 stores per mel
    const long long b = r0 / F, f = r0 % F;
#pragma unroll
    for (int t = 0; t < kMelsPerLane; ++t) {
      float v[kRowsPerWarp];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) v[i] = sqrtf(log10f(mel[i][t] + 1.0f));
      float4* o = reinterpret_cast<float4*>(out + (b * kMels + lane + 32 * t) * F + f);
      o[0] = make_float4(v[0], v[1], v[2], v[3]);
      o[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const long long r = r0 + i, b = r / F, f = r % F;
#pragma unroll
      for (int t = 0; t < kMelsPerLane; ++t)
        out[(b * kMels + lane + 32 * t) * F + f] = sqrtf(log10f(mel[i][t] + 1.0f));
    }
  }
}

}  // namespace

// C entry point, bound with ctypes.  frames (rows, 512) float32 contiguous,
// w_slices (12, 512, 128) and fb (768, 128) float32, out (rows/F, 128, F)
// float32; rows a multiple of 64.  Returns the cudaError_t of the setup and
// the launch (0 on success).
extern "C" int dft_mel_launch(const float* frames, long long rows, int F,
                              const float* w_slices, const float* fb,
                              float* out, void* stream) {
  if (rows <= 0) return 0;
  if (rows % kRows != 0 || F <= 0 || rows / kRows > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      dft_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  dft_mel_kernel<<<(unsigned)(rows / kRows), kThreads, kSmemBytes,
                   reinterpret_cast<cudaStream_t>(stream)>>>(
      frames, w_slices, fb, out, F);
  return (int)cudaGetLastError();
}
