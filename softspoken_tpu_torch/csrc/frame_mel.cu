// Framing + windowed DFT + mel + log compression, straight from a chunk buffer.
//
// Replaces: softspoken_tpu/ops/pallas_frame_mel.py::log_mel_windows_fused
// (the Pallas TPU kernel `_kernel` plus its XLA-side `_frame0`).
//
// What it computes, for each window start s and frame f in [0, 256):
//   frame f = buf[s + (f-1)*256 + j], j in [0, 512)          (f >= 1)
//   frame 0 = buf[s + |j - 256|]                               (reflect pad)
//   proj    = frame @ W, W = (512, 1536) Hann-folded [cos | sin] over the
//             first 768 DFT bins (the mel weight is zero above bin 743)
//   power   = re^2 + im^2                                      (768 bins)
//   mel     = power @ fb, fb = (768, 128), always float32
//   out[b, m, f] = sqrt(log10(mel + 1))                        float32 or bf16
// DFT precision modes (template MODE):
//   0 "highest": float32 FMA on float32 operands
//   1 "high":    bf16x3 split, x_hi*w_hi + x_hi*w_lo + x_lo*w_hi (the JAX
//                kernel's _dft_dot_bf16 with passes=3)
//   2 "default": operands rounded to bf16, float32 accumulation
// Products of bf16-rounded operands are exact in float32, so the modes differ
// from a tensor-core product only in summation order.
//
// What dropped from the TPU kernel: the one-hot permutation matmuls that
// aligned a dynamic lane offset (a block here simply loads from buf + s), the
// double-buffered DMA (plain coalesced loads into shared memory), and the
// separate frame-0 pass (reflect indexing is done while staging).
//
// Bound on an H100 SXM (B = 128 windows, the fused engine's batch): the DFT is
// 2*128*256*512*1536 = 51.5 GFLOP and the mel product 2*128*256*768*128 =
// 6.4 GFLOP, against ~26 MB of compulsory traffic (13.8 MB chunk buffer,
// 3.1 MB + 0.4 MB tables, 8.4 MB bf16 or 16.8 MB f32 out; ~8 us).  It is
// compute-bound: ~58 us with every FLOP at the bf16 tensor-core peak
// (989 TFLOP/s), ~0.86 ms at the float32 non-tensor peak (67 TFLOP/s).
// Since the mel product stays exact float32, its 6.4 GFLOP at the non-tensor
// peak (~96 us) bounds the bf16 modes; chip_smoke.py prints all three.
//
// What this simple design leaves: it runs on the CUDA cores in every mode
// (no mma/wgmma, no TMA), and each block re-reads W from L2.  One block owns
// (window, 16-frame tile): it stages the tile's 16 x 512 frame matrix in
// shared memory, each of 256 threads accumulates re and im of 3 bins for the
// 16 frames in registers, the power goes back to shared memory, then each
// thread forms 8 of the tile's 16 x 128 mel values and the tile is stored
// transposed to (B, 128, 256).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWindow = 66150;   // samples per 3 s window at 22050 Hz
constexpr int kFrames = 256;
constexpr int kWin = 512;        // frame length
constexpr int kHop = 256;
constexpr int kBins = 768;       // DFT bins computed (mel support ends at 743)
constexpr int kCols = 2 * kBins; // [cos | sin]
constexpr int kMels = 128;
constexpr int kTile = 16;        // frames per block
constexpr int kThreads = 256;
constexpr int kBinsPerThread = kBins / kThreads;         // 3
constexpr int kMelsPerThread = kTile * kMels / kThreads;  // 8

static_assert(kBins % kThreads == 0, "bins must split evenly over threads");
static_assert(kTile * kBins * 4 <= 48 * 1024, "power tile must fit static smem");

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int MODE, bool OUT_BF16>
__global__ void __launch_bounds__(kThreads, 1)
frame_mel_kernel(const float* __restrict__ buf, long long buf_len,
                 const int* __restrict__ starts,
                 const float* __restrict__ w_hi,   // (512, 1536)
                 const float* __restrict__ w_lo,   // (512, 1536), MODE 1 only
                 const float* __restrict__ fb,     // (768, 128)
                 void* __restrict__ out) {         // (B, 128, 256)
  // one buffer, three lives: frames (16 x 512), power (16 x 768), out tile
  __shared__ __align__(16) float smem[kTile * kBins];
  const int tid = threadIdx.x;
  const int f0 = blockIdx.x * kTile;
  const int b = blockIdx.y;
  const long long s = starts[b];
  const bool in_range = s >= 0 && s + kWindow <= buf_len;

  // ---- stage the tile's frames (reflect for frame 0) ----
  float* xs = smem;
  for (int i = tid; i < kTile * kWin; i += kThreads) {
    const int f = f0 + i / kWin;
    const int j = i % kWin;
    const long long off = (f == 0) ? (long long)abs(j - kHop)
                                   : (long long)(f - 1) * kHop + j;
    float v = in_range ? buf[s + off] : 0.0f;
    if (MODE == 2) v = bf16_round(v);
    xs[i] = v;
  }
  __syncthreads();

  // ---- DFT: re/im of bins tid, tid+256, tid+512 for the 16 frames ----
  float acc_re[kBinsPerThread][kTile];
  float acc_im[kBinsPerThread][kTile];
#pragma unroll
  for (int c = 0; c < kBinsPerThread; ++c)
#pragma unroll
    for (int f = 0; f < kTile; ++f) { acc_re[c][f] = 0.f; acc_im[c][f] = 0.f; }

  for (int j = 0; j < kWin; j += 4) {
    float wr[4][kBinsPerThread], wi[4][kBinsPerThread];
    float wrl[4][kBinsPerThread], wil[4][kBinsPerThread];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int c = 0; c < kBinsPerThread; ++c) {
        const int k = tid + c * kThreads;
        const size_t row = (size_t)(j + q) * kCols;
        wr[q][c] = __ldg(w_hi + row + k);
        wi[q][c] = __ldg(w_hi + row + kBins + k);
        if (MODE == 1) {
          wrl[q][c] = __ldg(w_lo + row + k);
          wil[q][c] = __ldg(w_lo + row + kBins + k);
        }
      }
#pragma unroll
    for (int f = 0; f < kTile; ++f) {
      const float4 x4 = *reinterpret_cast<const float4*>(xs + f * kWin + j);
      const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (MODE == 1) {
          const float xh = bf16_round(xv[q]);
          const float xl = bf16_round(xv[q] - xh);
#pragma unroll
          for (int c = 0; c < kBinsPerThread; ++c) {
            acc_re[c][f] += xh * wr[q][c] + xh * wrl[q][c] + xl * wr[q][c];
            acc_im[c][f] += xh * wi[q][c] + xh * wil[q][c] + xl * wi[q][c];
          }
        } else {
#pragma unroll
          for (int c = 0; c < kBinsPerThread; ++c) {
            acc_re[c][f] = fmaf(xv[q], wr[q][c], acc_re[c][f]);
            acc_im[c][f] = fmaf(xv[q], wi[q][c], acc_im[c][f]);
          }
        }
      }
    }
  }
  __syncthreads();  // every thread is done reading the frames

  // ---- power into shared memory (16 x 768) ----
  float* ps = smem;
#pragma unroll
  for (int c = 0; c < kBinsPerThread; ++c)
#pragma unroll
    for (int f = 0; f < kTile; ++f) {
      const float re = acc_re[c][f], im = acc_im[c][f];
      ps[f * kBins + tid + c * kThreads] = re * re + im * im;
    }
  __syncthreads();

  // ---- mel product (float32) + compression: mel m, frames fr + 2i ----
  const int m = tid % kMels;
  const int fr = tid / kMels;  // 0 or 1
  float mel[kMelsPerThread];
#pragma unroll
  for (int i = 0; i < kMelsPerThread; ++i) mel[i] = 0.f;
  for (int k = 0; k < kBins; ++k) {
    const float wk = __ldg(fb + k * kMels + m);
#pragma unroll
    for (int i = 0; i < kMelsPerThread; ++i)
      mel[i] = fmaf(ps[(fr + 2 * i) * kBins + k], wk, mel[i]);
  }
  __syncthreads();  // every thread is done reading the power

  // ---- transpose through shared memory: tile (128 mels x 16 frames) ----
  float* os = smem;
#pragma unroll
  for (int i = 0; i < kMelsPerThread; ++i) {
    const float v = sqrtf(log10f(mel[i] + 1.0f));
    os[m * kTile + fr + 2 * i] = in_range ? v : __int_as_float(0x7fc00000);
  }
  __syncthreads();
  const size_t base = (size_t)b * kMels * kFrames + f0;
  for (int i = tid; i < kMels * kTile; i += kThreads) {
    const int mm = i / kTile, ff = i % kTile;
    const size_t o = base + (size_t)mm * kFrames + ff;
    if (OUT_BF16)
      reinterpret_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(os[i]);
    else
      reinterpret_cast<float*>(out)[o] = os[i];
  }
}

template <int MODE, bool OUT_BF16>
cudaError_t launch(const float* buf, long long buf_len, const int* starts, int B,
                   const float* w_hi, const float* w_lo, const float* fb,
                   void* out, cudaStream_t stream) {
  dim3 grid(kFrames / kTile, B);
  frame_mel_kernel<MODE, OUT_BF16><<<grid, kThreads, 0, stream>>>(
      buf, buf_len, starts, w_hi, w_lo, fb, out);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes.  Returns the cudaError_t of the launch
// (0 on success); a window whose start is outside [0, buf_len - 66150]
// comes out as NaN rather than as a read of the wrong samples.
extern "C" int frame_mel_launch(const float* buf, long long buf_len,
                                const int* starts, int B,
                                const float* w_hi, const float* w_lo,
                                const float* fb, void* out, int mode,
                                int out_bf16, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (B <= 0) return 0;
  if (B > 65535) return (int)cudaErrorInvalidValue;
  switch (mode * 2 + (out_bf16 ? 1 : 0)) {
    case 0: return (int)launch<0, false>(buf, buf_len, starts, B, w_hi, w_lo, fb, out, st);
    case 1: return (int)launch<0, true>(buf, buf_len, starts, B, w_hi, w_lo, fb, out, st);
    case 2: return (int)launch<1, false>(buf, buf_len, starts, B, w_hi, w_lo, fb, out, st);
    case 3: return (int)launch<1, true>(buf, buf_len, starts, B, w_hi, w_lo, fb, out, st);
    case 4: return (int)launch<2, false>(buf, buf_len, starts, B, w_hi, w_lo, fb, out, st);
    case 5: return (int)launch<2, true>(buf, buf_len, starts, B, w_hi, w_lo, fb, out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
