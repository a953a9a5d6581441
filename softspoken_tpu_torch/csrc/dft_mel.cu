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
// Float32 class throughout: both products are the six-pass bf16 split of
// mel_core.cuh (the exact 8+8+8-bit parts, products of weight >= 2^-16),
// which is how the TPU's matrix unit computes a float32 product too.
//
// Bound on an H100 SXM at the host path's shapes (B = 128, F = 256, so
// 32,768 rows): 58.0 GFLOP a pass (51.5 DFT + 6.4 mel).  Six bf16 passes at
// the tensor peak (989 TFLOP/s) are 0.351 ms; the same work as float32 FMA
// on the CUDA cores (67 TFLOP/s) would be 0.865 ms.  The compulsory traffic
// is ~87 MB (frames 67.1 MB, tables ~5 MB, out 16.8 MB), 0.026 ms at
// 3.35 TB/s: bound by operations.
//
// Design (the core is mel_core.cuh; this file is the loader).  A block owns
// 64 rows: 64 x 512 float32 are 128 KiB, and twice that does not fit beside
// the table ring.  The two consumer warpgroups share the rows and split the
// twelve bin slices.  Rows are copied with 16-byte asynchronous copies; inside a row the
// 8-float groups are XOR-swizzled by (row & 3), so that the eight rows a
// warp reads for its A fragment fall into distinct banks without padding.
// The epilogue writes each row's values straight into (B, 128, F): no
// transpose follows.

#include "mel_core.cuh"

namespace {

struct RowLoader {
  static constexpr int kRows = 64;
  static constexpr int kXFloats = kRows * mel_core::kWin;
  const float* frames;  // (rows, 512)
  int F;

  __device__ __forceinline__ bool stage(float* xs, int tile, int tid) const {
    const float* src = frames + (size_t)tile * kRows * mel_core::kWin;
    for (int i = tid; i < kXFloats / 4; i += mel_core::kConsumerThreads) {
      const int row = i >> 7, k = (i & 127) * 4;
      mel_core::cp_async16(xs + xoff(row, k), src + 4 * i);
    }
    mel_core::cp_async_wait_all();
    return true;
  }
  __device__ __forceinline__ static int xoff(int row, int k) {
    return row * mel_core::kWin + (k ^ ((row & 3) << 3));
  }
  __device__ __forceinline__ void store8(void* out, int tile, int mel, int row8,
                                         const float (&v)[8]) const {
    float* o = reinterpret_cast<float*>(out);
    const long long r = (long long)tile * kRows + row8;
    if ((F & 7) == 0) {
      // 8 consecutive frames of one window, 32-byte aligned
      float4* p = reinterpret_cast<float4*>(o + ((r / F) * mel_core::kMels + mel) * F + r % F);
      p[0] = make_float4(v[0], v[1], v[2], v[3]);
      p[1] = make_float4(v[4], v[5], v[6], v[7]);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        o[(((r + i) / F) * mel_core::kMels + mel) * F + (r + i) % F] = v[i];
    }
  }
};

}  // namespace

// C entry point, bound with ctypes.  frames (rows, 512) float32 contiguous
// and 16-byte aligned, rows a multiple of 64; `tables` the three-part bf16
// tile stream of ops/mel_core.py; out (rows/F, 128, F) float32.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int dft_mel_launch(const float* frames, long long rows, int F,
                              const void* tables, float* out, void* stream) {
  if (rows <= 0) return 0;
  if (rows % RowLoader::kRows != 0 || F <= 0 || rows % F != 0 ||
      rows / RowLoader::kRows > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const RowLoader ld{frames, F};
  return (int)mel_core::launch<RowLoader, 3>(ld, (int)(rows / RowLoader::kRows), tables, out,
                                             reinterpret_cast<cudaStream_t>(stream));
}
