// IMA-ADPCM decode of the fused engine's adpcm4 upload wire (K3).
//
// Replaces: softspoken_tpu/ops/adpcm.py::decode_device, a lax.scan of 255
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
// Bound on an H100 SXM: the bytes, (wire + 4 n) / 3.35 TB/s, ~3.6 us for a
// 150 s chunk of the 16 kHz wire (9,400 blocks: 1.24 MB in, 9.6 MB out).
// What a simple design meets instead is the dependent chain: 255 steps of a
// table lookup, a few integer operations and two clips, each waiting on the
// last.  Design: one thread per block (the blocks are independent, the
// samples inside one are not); both tables in shared memory, since the
// threads of a warp look up different indices and constant memory would
// serialize them; the block's 33 words read as aligned 32-bit loads (a
// block starts at a multiple of 132 bytes, and the wrapper checks that the
// wire is 4-byte aligned); one 32-thread CUDA block per 32 wire blocks, so
// that the ~9,400 chains of a chunk spread over every SM.  Each thread
// writes its 256 floats at a stride of one block: uncoalesced, and left so
// (staging through shared memory is later work).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int SPB = 256;
constexpr int BLOCK_WORDS = 33;  // 132 bytes
constexpr int THREADS = 32;

__constant__ int32_t kIndex[16] = {-1, -1, -1, -1, 2, 4, 6, 8,
                                   -1, -1, -1, -1, 2, 4, 6, 8};
__constant__ int32_t kSteps[89] = {
    7, 8, 9, 10, 11, 12, 13, 14, 16, 17, 19, 21, 23, 25, 28, 31, 34, 37,
    41, 45, 50, 55, 60, 66, 73, 80, 88, 97, 107, 118, 130, 143, 157, 173,
    190, 209, 230, 253, 279, 307, 337, 371, 408, 449, 494, 544, 598, 658,
    724, 796, 876, 963, 1060, 1166, 1282, 1411, 1552, 1707, 1878, 2066,
    2272, 2499, 2749, 3024, 3327, 3660, 4026, 4428, 4871, 5358, 5894,
    6484, 7132, 7845, 8630, 9493, 10442, 11487, 12635, 13899, 15289,
    16818, 18500, 20350, 22385, 24623, 27086, 29794, 32767};

__global__ void __launch_bounds__(THREADS)
adpcm_decode_kernel(const uint32_t* __restrict__ wire, long long nb,
                    float* __restrict__ out, long long n) {
  __shared__ int32_t steps[89];
  __shared__ int32_t index[16];
  for (int i = threadIdx.x; i < 89; i += THREADS) steps[i] = kSteps[i];
  if (threadIdx.x < 16) index[threadIdx.x] = kIndex[threadIdx.x];
  __syncthreads();

  const long long b = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (b >= nb) return;
  const uint32_t* blk = wire + b * BLOCK_WORDS;
  const uint32_t hdr = __ldg(blk);
  int32_t pred = (int32_t)(int16_t)(hdr & 0xFFFFu);     // sign-extended seed
  int32_t idx = min((int32_t)((hdr >> 16) & 0xFFu), 88);  // a uint8: >= 0
  const long long base = b * SPB;
  // samples at or past n are the zero-padded tail: not written
  const long long left = n - base;
  if (left <= 0) return;
  const int live = (int)min((long long)SPB, left);
  const float scale = 1.0f / 32768.0f;
  out[base] = (float)pred * scale;
  for (int w = 0; w < 32; ++w) {
    const uint32_t word = __ldg(blk + 1 + w);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = w * 8 + j;           // nibble k gives sample k + 1
      if (k == SPB - 1) break;           // the padding nibble
      const int32_t nib = (int32_t)((word >> (4 * j)) & 0xFu);
      const int32_t step = steps[idx];
      int32_t diff = step >> 3;
      if (nib & 1) diff += step >> 2;
      if (nib & 2) diff += step >> 1;
      if (nib & 4) diff += step;
      pred = (nib & 8) ? pred - diff : pred + diff;
      pred = max(-32768, min(32767, pred));
      idx = max(0, min(88, idx + index[nib]));
      if (k + 1 < live) out[base + k + 1] = (float)pred * scale;
    }
  }
}

}  // namespace

// wire: nb * 132 bytes, 4-byte aligned; out: n floats, n <= nb * 256.
// Returns the launch's cudaError_t (0 = launched).
extern "C" int adpcm_decode_launch(const void* wire, long long nb, float* out,
                                   long long n, void* stream) {
  if (nb <= 0 || n <= 0) return 0;
  if (n > nb * SPB || nb > (1LL << 40)) return (int)cudaErrorInvalidValue;
  const long long grid = (nb + THREADS - 1) / THREADS;
  if (grid > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  adpcm_decode_kernel<<<(unsigned)grid, THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint32_t*>(wire), nb, out, n);
  return (int)cudaGetLastError();
}
