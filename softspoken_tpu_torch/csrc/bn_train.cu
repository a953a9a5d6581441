// Training-mode BatchNorm with batch statistics, forward and backward
// (ops/batchnorm.py::batch_norm_train), on a contiguous float32 (N, C, S)
// tensor; S is H*W for a 2-D BatchNorm, L for a 1-D one.
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
  int P;           // slabs a channel
};

Layout make_layout(int N, int C, int S) {
  Layout L;
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
  return (double)min((uint32_t)SLAB, L.M - (uint32_t)p * SLAB);
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

}  // extern "C"
