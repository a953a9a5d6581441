// Training-mode BatchNorm with batch statistics, forward and backward
// (ops/batchnorm.py::batch_norm_train), on a contiguous float32 (N, C, S)
// tensor (S is H*W for a 2-D BatchNorm, L for a 1-D one) or a channels-last
// (N, C, H, W) one (the *_nhwc entry points, below).
//
//   forward:  mean, biased var over (N, S) per channel;
//             y = (x - mean) * rsqrt(var + eps) * w + b;
//             running_mean/var = (1 - momentum) * running + momentum * stat,
//             num_batches_tracked += 1 (Flax's update, biased variance)
//   backward: db = sum dy, dw = sum dy * xhat,
//             dx = w * rstd * (dy - db / M - xhat * dw / M),  M = N * S
//
// Replaces no TPU kernel: the JAX package left Flax's BatchNorm to XLA.  It
// replaces torch.var_mean + cuDNN's NCHW bn_fw/bn_bw in the training step,
// whose "1C11" kernels give each channel one block or a few: at 32 channels
// they fill at most a quarter of the card's 132 SMs.
//
// Bound: memory.  An exact batch-statistics BatchNorm whose tensor does not
// fit on chip reads x twice and writes y once in the forward, and reads x
// and dy twice and writes dx once in the backward: eight passes of 4 bytes
// an element.  At (128, 32, 128 x 256) that is 1.61 GB forward and 2.68 GB
// backward, 0.48 and 0.80 ms at 3.35 TB/s.  The design moves those passes
// with every SM busy whatever C is:
//   - each channel is cut into slabs of SLAB elements (a range of its flat
//     (n, s) index); one block takes one slab, so (128, 32, 32768) is 16,384
//     blocks and even C = 4 gives several blocks a channel.  A thread reads
//     16 bytes a load, neighbouring threads neighbouring addresses;
//   - stage 1 reduces a slab to a partial: the forward keeps the slab in
//     registers and writes (mean, M2) about the slab's own mean (no
//     E[x^2] - mean^2 cancellation); the backward writes (sum dy,
//     sum dy * (x - mean));
//   - stage 2, one block a channel, merges the partials in float64 in a
//     fixed order (Chan et al. for (count, mean, M2)), with no atomics, so
//     two runs give the same bits; the forward's merge also updates the
//     running statistics and writes mean and 1/sigma;
//   - stage 3 streams y (or dx) slab by slab, the slabs in the reverse of
//     stage 1's order, so that the first it reads are the ones stage 1 read
//     last, which may still be in the 50 MB L2.
// The flat index of a channel's element splits into (n, s) by a
// multiply-high (Granlund-Montgomery) instead of an integer division.
//
// Channels-last (bn_train_*_nhwc): a 4-D (N, C, H, W) tensor stored NHWC is
// an (R, C) matrix, R = N * H * W rows with the channels innermost, so one
// channel's elements lie 4 * C bytes apart and a slab of one channel would
// read 4 bytes of every 4 * C.  Its kernels take the same stages and the
// same eight passes a different way:
//   - one block takes a tile of rows across all C channels.  Thread t keeps
//     channels 4g .. 4g + 3 (g = t % G, G = ceil(C / 4)) of row t / G of
//     each pass of RPP = THREADS / G rows, so a pass reads RPP * C
//     neighbouring floats in 16-byte loads, and VECS passes make a tile
//     (8,192 elements at C = 32 or 128, 7,680 at C = 96);
//   - stage 1 sums each thread's rows, then the rows of a channel group
//     in shared memory in a fixed tree order, and writes a (tile, channel)
//     partial, channel-major, so that stage 2 is the NCHW merge unchanged
//     with a tile of rows in place of a slab;
//   - stage 3 streams y (or dx) tile by tile in reverse order, each thread
//     with its four channels' coefficients in registers.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int VECS = 8;                          // 16-byte loads a thread per slab
constexpr int SLAB = THREADS * VECS * 4;         // elements of one channel a block
constexpr int WARPS = THREADS / 32;
constexpr int MERGE_THREADS = 256;

struct Layout {
  uint32_t M;      // elements a channel, N * S (< 2^31)
  uint32_t S;
  uint32_t magic;  // n = (umulhi(i, magic) + i) >> shift  ==  i / S
  uint32_t shift;
  int C;
  int P;           // partials a channel: slabs (NCHW) or tiles (NHWC)
  uint32_t tile;   // elements of one channel a partial covers
  int G;           // NHWC: groups of 4 channels, ceil(C / 4)
  int rpp;         // NHWC: rows a pass, THREADS / G
  int half;        // NHWC: half the least power of two >= rpp (the tree's first step)
};

Layout make_layout(int N, int C, int S) {
  Layout L{};
  L.tile = SLAB;
  L.M = (uint32_t)N * (uint32_t)S;
  L.S = (uint32_t)S;
  uint32_t shift = 0;
  while ((1ull << shift) < (unsigned long long)S) ++shift;
  L.shift = shift;
  L.magic = (uint32_t)(((1ull << 32) * ((1ull << shift) - (unsigned long long)S)) / S + 1);
  L.C = C;
  L.P = (int)((L.M + SLAB - 1) / SLAB);
  return L;
}

// offset in the (N, C, S) tensor of element i of channel c's flat (n, s) index
__device__ __forceinline__ long long offset_of(uint32_t i, int c, const Layout& L) {
  const uint32_t n = (__umulhi(i, L.magic) + i) >> L.shift;
  return ((long long)n * L.C + c) * L.S + (i - n * L.S);
}

// elements i .. i + 3 of channel c, zero past the channel's end.  VEC: one
// 16-byte load (S % 4 == 0 and 16-byte aligned base, so the four share a row)
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* __restrict__ p, uint32_t i, int c,
                                        const Layout& L) {
  if (VEC) {
    return i < L.M ? *reinterpret_cast<const float4*>(p + offset_of(i, c, L))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = i + j < L.M ? p[offset_of(i + j, c, L)] : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

template <bool VEC>
__device__ __forceinline__ void store4(float* __restrict__ p, uint32_t i, int c,
                                       const Layout& L, float4 v) {
  if (VEC) {
    if (i < L.M) *reinterpret_cast<float4*>(p + offset_of(i, c, L)) = v;
    return;
  }
  const float a[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (i + j < L.M) p[offset_of(i + j, c, L)] = a[j];
}

// element index of a thread's k-th load in the slab starting at `start`
__device__ __forceinline__ uint32_t elem(uint32_t start, int k) {
  return start + 4u * (uint32_t)(k * THREADS + threadIdx.x);
}

// sum over the block, returned to every thread, in a fixed order.  `red`
// holds WARPS + 1 values; the trailing barrier lets the caller reuse it.
__device__ __forceinline__ float2 block_sum2(float2 v, float2* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
  }
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  if (l == 0) red[w] = v;
  __syncthreads();
  if (w == 0) {
    v = l < WARPS ? red[l] : make_float2(0.f, 0.f);
#pragma unroll
    for (int o = WARPS / 2; o > 0; o >>= 1) {
      v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
      v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
    }
    if (l == 0) red[WARPS] = v;
  }
  __syncthreads();
  v = red[WARPS];
  __syncthreads();
  return v;
}

__device__ __forceinline__ double slab_count(int p, const Layout& L) {
  return (double)min(L.tile, L.M - (uint32_t)p * L.tile);
}

// (n, mean, M2) += (nb, mb, m2b), Chan et al.
__device__ __forceinline__ void chan_merge(double& n, double& mean, double& m2, double nb,
                                           double mb, double m2b) {
  if (nb == 0.0) return;
  const double t = n + nb, d = mb - mean;
  mean += d * (nb / t);
  m2 += m2b + d * d * (n * nb / t);
  n = t;
}

// ---------------------------------------------------------------------------
// forward

// stage 1: a slab's (mean, M2) about its own mean, the slab held in registers
template <bool VEC>
__global__ void __launch_bounds__(THREADS) bn_train_fwd_stats(const float* __restrict__ x,
                                                              float2* __restrict__ part,
                                                              Layout L) {
  __shared__ float2 red[WARPS + 1];
  const int c = blockIdx.x / L.P, p = blockIdx.x % L.P;
  const uint32_t start = (uint32_t)p * SLAB;
  float4 v[VECS];
#pragma unroll
  for (int k = 0; k < VECS; ++k) v[k] = load4<VEC>(x, elem(start, k), c, L);
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < VECS; ++k) s += (v[k].x + v[k].y) + (v[k].z + v[k].w);
  const float cnt = (float)min((uint32_t)SLAB, L.M - start);
  const float mean = block_sum2(make_float2(s, 0.f), red).x / cnt;
  float q = 0.f;
#pragma unroll
  for (int k = 0; k < VECS; ++k) {
    const uint32_t i = elem(start, k);
    const float a[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float d = i + j < L.M ? a[j] - mean : 0.f;
      q = fmaf(d, d, q);
    }
  }
  q = block_sum2(make_float2(q, 0.f), red).x;
  if (threadIdx.x == 0) part[blockIdx.x] = make_float2(mean, q);
}

// stage 2: one block a channel merges its slabs, updates the running
// statistics and writes mean and 1/sigma
__global__ void __launch_bounds__(MERGE_THREADS) bn_train_fwd_merge(
    const float2* __restrict__ part, float* __restrict__ running_mean,
    float* __restrict__ running_var, long long* __restrict__ num_batches_tracked,
    float* __restrict__ mean_out, float* __restrict__ rstd_out, Layout L, float eps,
    float momentum) {
  __shared__ double sn[MERGE_THREADS], smean[MERGE_THREADS], sm2[MERGE_THREADS];
  const int c = blockIdx.x, t = threadIdx.x;
  double n = 0.0, mean = 0.0, m2 = 0.0;
  for (int p = t; p < L.P; p += MERGE_THREADS) {
    const float2 q = part[(long long)c * L.P + p];
    chan_merge(n, mean, m2, slab_count(p, L), q.x, q.y);
  }
  sn[t] = n;
  smean[t] = mean;
  sm2[t] = m2;
  __syncthreads();
  for (int h = MERGE_THREADS / 2; h > 0; h >>= 1) {
    if (t < h) {
      chan_merge(n, mean, m2, sn[t + h], smean[t + h], sm2[t + h]);
      sn[t] = n;
      smean[t] = mean;
      sm2[t] = m2;
    }
    __syncthreads();
  }
  if (t == 0) {
    const double var = m2 / n;
    const float mf = (float)mean, vf = (float)var;
    mean_out[c] = mf;
    rstd_out[c] = (float)(1.0 / sqrt(var + (double)eps));
    running_mean[c] = running_mean[c] * (1.f - momentum) + momentum * mf;
    running_var[c] = running_var[c] * (1.f - momentum) + momentum * vf;
    if (c == 0) *num_batches_tracked += 1;
  }
}

// stage 3: y = (x - mean) * (w * rstd) + b, the slabs in reverse order
template <bool VEC>
__global__ void __launch_bounds__(THREADS) bn_train_fwd_apply(
    const float* __restrict__ x, const float* __restrict__ mean_in,
    const float* __restrict__ rstd_in, const float* __restrict__ w,
    const float* __restrict__ b, float* __restrict__ y, Layout L) {
  const int g = gridDim.x - 1 - blockIdx.x;
  const int c = g / L.P, p = g % L.P;
  const uint32_t start = (uint32_t)p * SLAB;
  const float m = mean_in[c], a = w[c] * rstd_in[c], bc = b[c];
  float4 v[VECS];
#pragma unroll
  for (int k = 0; k < VECS; ++k) v[k] = load4<VEC>(x, elem(start, k), c, L);
#pragma unroll
  for (int k = 0; k < VECS; ++k) {
    const float4 o = make_float4(fmaf(v[k].x - m, a, bc), fmaf(v[k].y - m, a, bc),
                                 fmaf(v[k].z - m, a, bc), fmaf(v[k].w - m, a, bc));
    store4<VEC>(y, elem(start, k), c, L, o);
  }
}

// ---------------------------------------------------------------------------
// backward

// stage 1: a slab's (sum dy, sum dy * (x - mean)); past the channel's end
// dy reads 0 and adds nothing
template <bool VEC>
__global__ void __launch_bounds__(THREADS) bn_train_bwd_reduce(
    const float* __restrict__ x, const float* __restrict__ dy,
    const float* __restrict__ mean_in, float2* __restrict__ part, Layout L) {
  __shared__ float2 red[WARPS + 1];
  const int c = blockIdx.x / L.P, p = blockIdx.x % L.P;
  const uint32_t start = (uint32_t)p * SLAB;
  const float m = mean_in[c];
  float4 xv[VECS], gv[VECS];
#pragma unroll
  for (int k = 0; k < VECS; ++k) {
    xv[k] = load4<VEC>(x, elem(start, k), c, L);
    gv[k] = load4<VEC>(dy, elem(start, k), c, L);
  }
  float sg = 0.f, sgx = 0.f;
#pragma unroll
  for (int k = 0; k < VECS; ++k) {
    sg += (gv[k].x + gv[k].y) + (gv[k].z + gv[k].w);
    sgx = fmaf(gv[k].x, xv[k].x - m, sgx);
    sgx = fmaf(gv[k].y, xv[k].y - m, sgx);
    sgx = fmaf(gv[k].z, xv[k].z - m, sgx);
    sgx = fmaf(gv[k].w, xv[k].w - m, sgx);
  }
  const float2 r = block_sum2(make_float2(sg, sgx), red);
  if (threadIdx.x == 0) part[blockIdx.x] = r;
}

// stage 2: one block a channel sums its slabs; dw, db and the coefficients
// of dx = k1 * dy + k2 * (x - mean) + k3
__global__ void __launch_bounds__(MERGE_THREADS) bn_train_bwd_merge(
    const float2* __restrict__ part, const float* __restrict__ w,
    const float* __restrict__ rstd_in, float* __restrict__ dw, float* __restrict__ db,
    float* __restrict__ coef, Layout L) {
  __shared__ double sg_s[MERGE_THREADS], sgx_s[MERGE_THREADS];
  const int c = blockIdx.x, t = threadIdx.x;
  double sg = 0.0, sgx = 0.0;
  for (int p = t; p < L.P; p += MERGE_THREADS) {
    const float2 q = part[(long long)c * L.P + p];
    sg += q.x;
    sgx += q.y;
  }
  sg_s[t] = sg;
  sgx_s[t] = sgx;
  __syncthreads();
  for (int h = MERGE_THREADS / 2; h > 0; h >>= 1) {
    if (t < h) {
      sg_s[t] = sg_s[t] + sg_s[t + h];
      sgx_s[t] = sgx_s[t] + sgx_s[t + h];
    }
    __syncthreads();
  }
  if (t == 0) {
    const double r = rstd_in[c], a = (double)w[c] * r, M = (double)L.M;
    const double dwv = r * sgx_s[0], dbv = sg_s[0];
    dw[c] = (float)dwv;
    db[c] = (float)dbv;
    coef[c] = (float)a;
    coef[L.C + c] = (float)(-a * r * dwv / M);
    coef[2 * L.C + c] = (float)(-a * dbv / M);
  }
}

// stage 3: dx, the slabs in reverse order
template <bool VEC>
__global__ void __launch_bounds__(THREADS) bn_train_bwd_apply(
    const float* __restrict__ x, const float* __restrict__ dy,
    const float* __restrict__ mean_in, const float* __restrict__ coef,
    float* __restrict__ dx, Layout L) {
  const int g = gridDim.x - 1 - blockIdx.x;
  const int c = g / L.P, p = g % L.P;
  const uint32_t start = (uint32_t)p * SLAB;
  const float m = mean_in[c], k1 = coef[c], k2 = coef[L.C + c], k3 = coef[2 * L.C + c];
  float4 xv[VECS], gv[VECS];
#pragma unroll
  for (int k = 0; k < VECS; ++k) {
    xv[k] = load4<VEC>(x, elem(start, k), c, L);
    gv[k] = load4<VEC>(dy, elem(start, k), c, L);
  }
#pragma unroll
  for (int k = 0; k < VECS; ++k) {
    const float4 o = make_float4(fmaf(k2, xv[k].x - m, fmaf(k1, gv[k].x, k3)),
                                 fmaf(k2, xv[k].y - m, fmaf(k1, gv[k].y, k3)),
                                 fmaf(k2, xv[k].z - m, fmaf(k1, gv[k].z, k3)),
                                 fmaf(k2, xv[k].w - m, fmaf(k1, gv[k].w, k3)));
    store4<VEC>(dx, elem(start, k), c, L, o);
  }
}

// ---------------------------------------------------------------------------
// channels-last: (R, C) rows, a block a tile of rows across every channel

Layout make_layout_nhwc(int R, int C) {
  Layout L{};
  L.M = (uint32_t)R;
  L.C = C;
  L.G = (C + 3) / 4;
  L.rpp = THREADS / L.G;
  L.tile = (uint32_t)L.rpp * VECS;
  L.P = (int)((L.M + L.tile - 1) / L.tile);
  int h = 1;
  while (h < L.rpp) h <<= 1;
  L.half = h / 2;
  return L;
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// channels c0 .. c0 + 3 of `row`, zero past the last row or channel.  VEC:
// one 16-byte load (C % 4 == 0 and a 16-byte aligned base)
template <bool VEC>
__device__ __forceinline__ float4 load_row4(const float* __restrict__ p, uint32_t row, int c0,
                                            const Layout& L) {
  if (row >= L.M) return make_float4(0.f, 0.f, 0.f, 0.f);
  const float* q = p + (long long)row * L.C + c0;
  if (VEC) return *reinterpret_cast<const float4*>(q);
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = c0 + j < L.C ? q[j] : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

template <bool VEC>
__device__ __forceinline__ void store_row4(float* __restrict__ p, uint32_t row, int c0,
                                           const Layout& L, float4 v) {
  if (row >= L.M) return;
  float* q = p + (long long)row * L.C + c0;
  if (VEC) {
    *reinterpret_cast<float4*>(q) = v;
    return;
  }
  const float a[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (c0 + j < L.C) q[j] = a[j];
}

// row of a thread's k-th load in the tile starting at row0
__device__ __forceinline__ uint32_t tile_row(uint32_t row0, int k, int r, const Layout& L) {
  return row0 + (uint32_t)(k * L.rpp + r);
}

// the sum over a tile's pass rows of every thread's float4, for its channel
// group, in a fixed tree order; returned to every thread.  `red` holds
// THREADS values; the trailing barrier lets the caller reuse it.
__device__ __forceinline__ float4 group_sum(float4 v, float4* red, int r, const Layout& L) {
  const int t = threadIdx.x;
  red[t] = v;
  __syncthreads();
  for (int h = L.half; h > 0; h >>= 1) {
    if (r < h && r + h < L.rpp) red[t] = add4(red[t], red[t + h * L.G]);
    __syncthreads();
  }
  v = red[t % L.G];
  __syncthreads();
  return v;
}

// the four channels' partials of a tile, channel-major (stage 2 reads a
// channel's partials in a row)
__device__ __forceinline__ void put_partials(float2* __restrict__ part, int c0, float4 a,
                                             float4 b, const Layout& L) {
  const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (c0 + j < L.C) part[(long long)(c0 + j) * L.P + blockIdx.x] = make_float2(av[j], bv[j]);
}

// a (C,) vector's values at channels c0 .. c0 + 3, zero past C
__device__ __forceinline__ float4 channels4(const float* __restrict__ v, int c0, const Layout& L) {
  float a[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) a[j] = c0 + j < L.C ? v[c0 + j] : 0.f;
  return make_float4(a[0], a[1], a[2], a[3]);
}

// forward stage 1: a tile's (mean, M2) a channel about its own mean, the
// tile held in registers
template <bool VEC>
__global__ void __launch_bounds__(THREADS) bn_train_fwd_stats_nhwc(
    const float* __restrict__ x, float2* __restrict__ part, Layout L) {
  __shared__ float4 red[THREADS];
  const int r = threadIdx.x / L.G, c0 = 4 * (threadIdx.x % L.G);
  const bool active = r < L.rpp;
  const uint32_t row0 = (uint32_t)blockIdx.x * L.tile;
  float4 v[VECS];
#pragma unroll
  for (int k = 0; k < VECS; ++k)
    v[k] = active ? load_row4<VEC>(x, tile_row(row0, k, r, L), c0, L)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int k = 0; k < VECS; ++k) s = add4(s, v[k]);
  const float cnt = (float)min(L.tile, L.M - row0);
  s = group_sum(s, red, r, L);
  const float4 mean = make_float4(s.x / cnt, s.y / cnt, s.z / cnt, s.w / cnt);
  float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int k = 0; k < VECS; ++k) {
    if (active && tile_row(row0, k, r, L) < L.M) {
      const float4 d = make_float4(v[k].x - mean.x, v[k].y - mean.y, v[k].z - mean.z,
                                   v[k].w - mean.w);
      q = make_float4(fmaf(d.x, d.x, q.x), fmaf(d.y, d.y, q.y), fmaf(d.z, d.z, q.z),
                      fmaf(d.w, d.w, q.w));
    }
  }
  q = group_sum(q, red, r, L);
  if (active && r == 0) put_partials(part, c0, mean, q, L);
}

// forward stage 3: y = (x - mean) * (w * rstd) + b, the tiles in reverse order
template <bool VEC>
__global__ void __launch_bounds__(THREADS) bn_train_fwd_apply_nhwc(
    const float* __restrict__ x, const float* __restrict__ mean_in,
    const float* __restrict__ rstd_in, const float* __restrict__ w,
    const float* __restrict__ b, float* __restrict__ y, Layout L) {
  const int r = threadIdx.x / L.G, c0 = 4 * (threadIdx.x % L.G);
  if (r >= L.rpp) return;
  const uint32_t row0 = (uint32_t)(gridDim.x - 1 - blockIdx.x) * L.tile;
  const float4 m = channels4(mean_in, c0, L), ws = channels4(w, c0, L),
               rs = channels4(rstd_in, c0, L), bc = channels4(b, c0, L);
  const float4 a = make_float4(ws.x * rs.x, ws.y * rs.y, ws.z * rs.z, ws.w * rs.w);
  float4 v[VECS];
#pragma unroll
  for (int k = 0; k < VECS; ++k) v[k] = load_row4<VEC>(x, tile_row(row0, k, r, L), c0, L);
#pragma unroll
  for (int k = 0; k < VECS; ++k) {
    const float4 o = make_float4(fmaf(v[k].x - m.x, a.x, bc.x), fmaf(v[k].y - m.y, a.y, bc.y),
                                 fmaf(v[k].z - m.z, a.z, bc.z), fmaf(v[k].w - m.w, a.w, bc.w));
    store_row4<VEC>(y, tile_row(row0, k, r, L), c0, L, o);
  }
}

// backward stage 1: a tile's (sum dy, sum dy * (x - mean)) a channel; past
// the last row dy reads 0 and adds nothing
template <bool VEC>
__global__ void __launch_bounds__(THREADS) bn_train_bwd_reduce_nhwc(
    const float* __restrict__ x, const float* __restrict__ dy,
    const float* __restrict__ mean_in, float2* __restrict__ part, Layout L) {
  __shared__ float4 red[THREADS];
  const int r = threadIdx.x / L.G, c0 = 4 * (threadIdx.x % L.G);
  const bool active = r < L.rpp;
  const uint32_t row0 = (uint32_t)blockIdx.x * L.tile;
  const float4 m = channels4(mean_in, c0, L);
  float4 xv[VECS], gv[VECS];
#pragma unroll
  for (int k = 0; k < VECS; ++k) {
    const uint32_t row = active ? tile_row(row0, k, r, L) : L.M;
    xv[k] = load_row4<VEC>(x, row, c0, L);
    gv[k] = load_row4<VEC>(dy, row, c0, L);
  }
  float4 sg = make_float4(0.f, 0.f, 0.f, 0.f), sgx = sg;
#pragma unroll
  for (int k = 0; k < VECS; ++k) {
    sg = add4(sg, gv[k]);
    sgx = make_float4(fmaf(gv[k].x, xv[k].x - m.x, sgx.x), fmaf(gv[k].y, xv[k].y - m.y, sgx.y),
                      fmaf(gv[k].z, xv[k].z - m.z, sgx.z), fmaf(gv[k].w, xv[k].w - m.w, sgx.w));
  }
  sg = group_sum(sg, red, r, L);
  sgx = group_sum(sgx, red, r, L);
  if (active && r == 0) put_partials(part, c0, sg, sgx, L);
}

// backward stage 3: dx = k1 * dy + k2 * (x - mean) + k3, the tiles in
// reverse order
template <bool VEC>
__global__ void __launch_bounds__(THREADS) bn_train_bwd_apply_nhwc(
    const float* __restrict__ x, const float* __restrict__ dy,
    const float* __restrict__ mean_in, const float* __restrict__ coef,
    float* __restrict__ dx, Layout L) {
  const int r = threadIdx.x / L.G, c0 = 4 * (threadIdx.x % L.G);
  if (r >= L.rpp) return;
  const uint32_t row0 = (uint32_t)(gridDim.x - 1 - blockIdx.x) * L.tile;
  const float4 m = channels4(mean_in, c0, L), k1 = channels4(coef, c0, L),
               k2 = channels4(coef + L.C, c0, L), k3 = channels4(coef + 2 * L.C, c0, L);
  float4 xv[VECS], gv[VECS];
#pragma unroll
  for (int k = 0; k < VECS; ++k) {
    xv[k] = load_row4<VEC>(x, tile_row(row0, k, r, L), c0, L);
    gv[k] = load_row4<VEC>(dy, tile_row(row0, k, r, L), c0, L);
  }
#pragma unroll
  for (int k = 0; k < VECS; ++k) {
    const float4 o = make_float4(fmaf(k2.x, xv[k].x - m.x, fmaf(k1.x, gv[k].x, k3.x)),
                                 fmaf(k2.y, xv[k].y - m.y, fmaf(k1.y, gv[k].y, k3.y)),
                                 fmaf(k2.z, xv[k].z - m.z, fmaf(k1.z, gv[k].z, k3.z)),
                                 fmaf(k2.w, xv[k].w - m.w, fmaf(k1.w, gv[k].w, k3.w)));
    store_row4<VEC>(dx, tile_row(row0, k, r, L), c0, L, o);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

extern "C" {

// floats of scratch a forward or backward call needs: the slabs' partials
// (two floats each) and the backward's three coefficients a channel
long long bn_train_workspace_floats(int N, int C, int S) {
  const Layout L = make_layout(N, C, S);
  return 2LL * C * L.P + 3LL * C;
}

// Every pointer is a device pointer to contiguous float32 data ((N, C, S)
// tensors, (C,) vectors), num_batches_tracked an int64 scalar.  Returns the
// cudaError of the launches (0 on success).
int bn_train_forward(const float* x, const float* w, const float* b, float* y,
                     float* running_mean, float* running_var, long long* num_batches_tracked,
                     float* mean_out, float* rstd_out, float* work, int N, int C, int S,
                     float eps, float momentum, cudaStream_t stream) {
  const Layout L = make_layout(N, C, S);
  const int grid = C * L.P;
  float2* part = reinterpret_cast<float2*>(work);
  const bool vec = S % 4 == 0 && aligned16(x) && aligned16(y);
  if (vec)
    bn_train_fwd_stats<true><<<grid, THREADS, 0, stream>>>(x, part, L);
  else
    bn_train_fwd_stats<false><<<grid, THREADS, 0, stream>>>(x, part, L);
  bn_train_fwd_merge<<<C, MERGE_THREADS, 0, stream>>>(part, running_mean, running_var,
                                                     num_batches_tracked, mean_out, rstd_out,
                                                     L, eps, momentum);
  if (vec)
    bn_train_fwd_apply<true><<<grid, THREADS, 0, stream>>>(x, mean_out, rstd_out, w, b, y, L);
  else
    bn_train_fwd_apply<false><<<grid, THREADS, 0, stream>>>(x, mean_out, rstd_out, w, b, y, L);
  return (int)cudaGetLastError();
}

int bn_train_backward(const float* x, const float* dy, const float* w, const float* mean_in,
                      const float* rstd_in, float* dx, float* dw, float* db, float* work,
                      int N, int C, int S, cudaStream_t stream) {
  const Layout L = make_layout(N, C, S);
  const int grid = C * L.P;
  float2* part = reinterpret_cast<float2*>(work);
  float* coef = work + 2LL * C * L.P;
  const bool vec = S % 4 == 0 && aligned16(x) && aligned16(dy) && aligned16(dx);
  if (vec)
    bn_train_bwd_reduce<true><<<grid, THREADS, 0, stream>>>(x, dy, mean_in, part, L);
  else
    bn_train_bwd_reduce<false><<<grid, THREADS, 0, stream>>>(x, dy, mean_in, part, L);
  bn_train_bwd_merge<<<C, MERGE_THREADS, 0, stream>>>(part, w, rstd_in, dw, db, coef, L);
  if (vec)
    bn_train_bwd_apply<true><<<grid, THREADS, 0, stream>>>(x, dy, mean_in, coef, dx, L);
  else
    bn_train_bwd_apply<false><<<grid, THREADS, 0, stream>>>(x, dy, mean_in, coef, dx, L);
  return (int)cudaGetLastError();
}

// Channels-last: x, y, dy and dx are (R, C) row-major, R = N * H * W; C at
// most 4 * THREADS (1,024).  The same scratch, statistics and return codes.
long long bn_train_workspace_floats_nhwc(int R, int C) {
  const Layout L = make_layout_nhwc(R, C);
  return 2LL * C * L.P + 3LL * C;
}

int bn_train_forward_nhwc(const float* x, const float* w, const float* b, float* y,
                          float* running_mean, float* running_var,
                          long long* num_batches_tracked, float* mean_out, float* rstd_out,
                          float* work, int R, int C, float eps, float momentum,
                          cudaStream_t stream) {
  if (C < 1 || C > 4 * THREADS) return (int)cudaErrorInvalidValue;
  const Layout L = make_layout_nhwc(R, C);
  float2* part = reinterpret_cast<float2*>(work);
  const bool vec = C % 4 == 0 && aligned16(x) && aligned16(y);
  if (vec)
    bn_train_fwd_stats_nhwc<true><<<L.P, THREADS, 0, stream>>>(x, part, L);
  else
    bn_train_fwd_stats_nhwc<false><<<L.P, THREADS, 0, stream>>>(x, part, L);
  bn_train_fwd_merge<<<C, MERGE_THREADS, 0, stream>>>(part, running_mean, running_var,
                                                     num_batches_tracked, mean_out, rstd_out,
                                                     L, eps, momentum);
  if (vec)
    bn_train_fwd_apply_nhwc<true><<<L.P, THREADS, 0, stream>>>(x, mean_out, rstd_out, w, b, y,
                                                               L);
  else
    bn_train_fwd_apply_nhwc<false><<<L.P, THREADS, 0, stream>>>(x, mean_out, rstd_out, w, b,
                                                                y, L);
  return (int)cudaGetLastError();
}

int bn_train_backward_nhwc(const float* x, const float* dy, const float* w,
                           const float* mean_in, const float* rstd_in, float* dx, float* dw,
                           float* db, float* work, int R, int C, cudaStream_t stream) {
  if (C < 1 || C > 4 * THREADS) return (int)cudaErrorInvalidValue;
  const Layout L = make_layout_nhwc(R, C);
  float2* part = reinterpret_cast<float2*>(work);
  float* coef = work + 2LL * C * L.P;
  const bool vec = C % 4 == 0 && aligned16(x) && aligned16(dy) && aligned16(dx);
  if (vec)
    bn_train_bwd_reduce_nhwc<true><<<L.P, THREADS, 0, stream>>>(x, dy, mean_in, part, L);
  else
    bn_train_bwd_reduce_nhwc<false><<<L.P, THREADS, 0, stream>>>(x, dy, mean_in, part, L);
  bn_train_bwd_merge<<<C, MERGE_THREADS, 0, stream>>>(part, w, rstd_in, dw, db, coef, L);
  if (vec)
    bn_train_bwd_apply_nhwc<true><<<L.P, THREADS, 0, stream>>>(x, dy, mean_in, coef, dx, L);
  else
    bn_train_bwd_apply_nhwc<false><<<L.P, THREADS, 0, stream>>>(x, dy, mean_in, coef, dx, L);
  return (int)cudaGetLastError();
}

}  // extern "C"
