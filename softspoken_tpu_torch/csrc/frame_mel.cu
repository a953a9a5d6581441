// Framing + windowed DFT + mel + log compression, straight from a chunk buffer (K1).
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
//   mel     = power @ fb, fb = (768, 128), float32 class in every mode
//   out[b, m, f] = sqrt(log10(mel + 1))                        float32 or bf16
// DFT precision modes = bf16 parts of the product (mel_core.cuh):
//   1 part  "default": operands rounded to bf16, one pass
//   2 parts "high":    x_hi*w_hi + x_lo*w_hi + x_hi*w_lo (the JAX kernel's
//                      _dft_dot_bf16 with passes=3)
//   3 parts "highest": six passes of the exact three-way split, float32 class
//                      (the TPU's Precision.HIGHEST is the same construction)
//
// Bound on an H100 SXM (B = 128 windows, the fused engine's batch): the DFT is
// 2*128*256*512*1536 = 51.5 GFLOP a pass and the mel product 6.4 GFLOP a
// pass, against ~26 MB of compulsory traffic (~8 us): bound by operations.
// "default" with the mel product's six passes at the bf16 tensor peak
// (989 TFLOP/s) is 0.091 ms; "highest" 6 x 58.0 GFLOP is 0.351 ms.
//
// Design (the core is mel_core.cuh; this file is the loader).  A block owns
// 128 consecutive frames of one window, and frames overlap by half, so the
// loader uses the hop-block identity instead of overlapping rows: with
// Blk[0] = reverse(w[1:257]) and Blk[1+i] = w[256*i : 256*(i+1)], frame f is
// Blk[f] followed by Blk[f+1], frame 0's reflect pad included.  A tile is
// 129 blocks of 256 samples: each sample is read from device memory once
// and stored once.  Block rows are padded to 264 floats so that the eight
// frames a warp reads for its A fragment fall into distinct banks.  The TPU
// kernel's one-hot permutation matmuls (a dynamic lane shift) have no
// counterpart: a block simply reads from buf + s, which is only 4-byte
// aligned, hence 4-byte asynchronous copies (cp.async) and not a bulk copy.

#include "mel_core.cuh"

namespace {

constexpr int kWindow = 66150;   // samples per 3 s window at 22050 Hz
constexpr int kFrames = 256;
constexpr int kHop = 256;
constexpr int kTileFrames = 128;
constexpr int kBlkLd = kHop + 8; // padded hop block

template <bool OUT_BF16>
struct WindowLoader {
  static constexpr int kRows = kTileFrames;
  static constexpr int kXFloats = (kTileFrames + 1) * kBlkLd;
  const float* buf;
  long long buf_len;
  const int* starts;

  __device__ __forceinline__ bool stage(float* xs, int tile, int tid) const {
    const long long s = starts[tile >> 1];
    const bool in_range = s >= 0 && s + kWindow <= buf_len;
    const int f0 = (tile & 1) * kTileFrames;
    const float* w = buf + (in_range ? s : 0);
    for (int i = tid; i < (kTileFrames + 1) * kHop; i += mel_core::kConsumerThreads) {
      const int blk = i >> 8, j = i & (kHop - 1);
      const int gb = f0 + blk;  // hop block of the window; 0 is the reflected one
      const int src = gb == 0 ? kHop - j : (gb - 1) * kHop + j;
      if (in_range) mel_core::cp_async4(xs + blk * kBlkLd + j, w + src);
      else xs[blk * kBlkLd + j] = 0.0f;
    }
    mel_core::cp_async_wait_all();
    return in_range;
  }
  __device__ __forceinline__ static int xoff(int row, int k) {
    return (row + (k >> 8)) * kBlkLd + (k & (kHop - 1));
  }
  __device__ __forceinline__ void store8(void* out, int tile, int mel, int row8,
                                         const float (&v)[8]) const {
    const size_t o = ((size_t)(tile >> 1) * mel_core::kMels + mel) * kFrames +
                     (tile & 1) * kTileFrames + row8;
    if (OUT_BF16) {
      __nv_bfloat162 h[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      *reinterpret_cast<uint4*>(reinterpret_cast<__nv_bfloat16*>(out) + o) =
          *reinterpret_cast<const uint4*>(h);
    } else {
      float4* p = reinterpret_cast<float4*>(reinterpret_cast<float*>(out) + o);
      p[0] = make_float4(v[0], v[1], v[2], v[3]);
      p[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
  }
};

template <int NP, bool OUT_BF16>
cudaError_t launch(const float* buf, long long buf_len, const int* starts, int B,
                   const void* tables, void* out, cudaStream_t stream) {
  const WindowLoader<OUT_BF16> ld{buf, buf_len, starts};
  return mel_core::launch<WindowLoader<OUT_BF16>, NP>(ld, 2 * B, tables, out, stream);
}

}  // namespace

// C entry point, bound with ctypes.  `tables` is the bf16 tile stream that
// ops/mel_core.py builds for `n_parts` (1, 2 or 3).  Returns the cudaError_t
// of the launch (0 on success); a window whose start is outside
// [0, buf_len - 66150] comes out as NaN rather than as a read of the wrong
// samples.
extern "C" int frame_mel_launch(const float* buf, long long buf_len,
                                const int* starts, int B, const void* tables,
                                void* out, int n_parts, int out_bf16, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (B <= 0) return 0;
  if (B > (1 << 29)) return (int)cudaErrorInvalidValue;
  switch (n_parts * 2 + (out_bf16 ? 1 : 0)) {
    case 2: return (int)launch<1, false>(buf, buf_len, starts, B, tables, out, st);
    case 3: return (int)launch<1, true>(buf, buf_len, starts, B, tables, out, st);
    case 4: return (int)launch<2, false>(buf, buf_len, starts, B, tables, out, st);
    case 5: return (int)launch<2, true>(buf, buf_len, starts, B, tables, out, st);
    case 6: return (int)launch<3, false>(buf, buf_len, starts, B, tables, out, st);
    case 7: return (int)launch<3, true>(buf, buf_len, starts, B, tables, out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
