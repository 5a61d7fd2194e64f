// The integer mean/variance prepass, included by csrc/fused_all.cu.
//
// prepass_kernel, grid (chunks, songs), 256 threads: the exact sums of s
// and s^2 over each song's valid samples i < n[b], as int64 partial sums,
// one pair a block; the wrapper adds a song's partials in int64. Integer
// addition is exact, so the order of the sums does not matter and the card
// agrees with the CPU bit for bit. Each thread reads 16-byte words (8
// samples), PRE_UNROLL of them in flight, forms s^2 in int32 (<= 2^30) and
// accumulates both sums in int64; a shuffle tree and a block tree reduce
// them. One read of the int16 PCM, so the bytes bound it (kernels/bounds.py
// prepass_work). It replaces no Pallas kernel: the JAX package computes the
// mean and a float32 variance in XLA around its kernels
// (bliss_tpu/kernels/fused_all.py:385-396); the port takes the exact integer
// variance of the C reference (bl_variance) instead.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PRE_THREADS = 256;
constexpr int PRE_UNROLL = 4;  // 16-byte words a thread has in flight

__global__ void __launch_bounds__(PRE_THREADS) prepass_kernel(
    const int16_t* __restrict__ x, int L, const int* __restrict__ n_samples,
    int chunks, long long* __restrict__ part) {
  __shared__ long long red[2][PRE_THREADS / 32];
  const int b = blockIdx.y, t = threadIdx.x;
  const int n = min(max(n_samples[b], 0), L);
  const int4* xb = reinterpret_cast<const int4*>(x + (size_t)b * L);
  const int nw = (n + 7) >> 3;  // words that hold a valid sample
  const int stride = chunks * PRE_THREADS;
  long long s1 = 0, s2 = 0;
  for (int w0 = blockIdx.x * PRE_THREADS + t; w0 < nw; w0 += PRE_UNROLL * stride) {
    int4 v[PRE_UNROLL];
#pragma unroll
    for (int u = 0; u < PRE_UNROLL; ++u) {
      const int w = w0 + u * stride;
      v[u] = w < nw ? __ldg(xb + w) : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < PRE_UNROLL; ++u) {
      const int i0 = 8 * (w0 + u * stride);
      const int words[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
      int a = 0;
      long long q = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int w = words[j >> 1];
        int s = (j & 1) ? (w >> 16) : ((int)((unsigned)w << 16) >> 16);
        s = i0 + j < n ? s : 0;
        a += s;
        q += (long long)(s * s);
      }
      s1 += a;
      s2 += q;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    s2 += __shfl_xor_sync(0xffffffffu, s2, o);
  }
  if ((t & 31) == 0) {
    red[0][t >> 5] = s1;
    red[1][t >> 5] = s2;
  }
  __syncthreads();
  if (t < 2) {
    long long s = 0;
#pragma unroll
    for (int w = 0; w < PRE_THREADS / 32; ++w) s += red[t][w];
    part[((size_t)b * chunks + blockIdx.x) * 2 + t] = s;
  }
}

// Launches prepass_kernel; returns the launch's cudaError_t. x int16 [B, L],
// 16-byte aligned, L a multiple of 8; n_samples int [B]; part int64 [B,
// chunks, 2], rows (sum s, sum s^2).
int launch_prepass(const void* x, int B, int L, const void* n_samples,
                   void* part, int chunks, void* stream) {
  if (B < 1 || B > 65535 || L < 8 || L % 8 || chunks < 1 || chunks > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(chunks, B);
  prepass_kernel<<<grid, PRE_THREADS, 0, (cudaStream_t)stream>>>(
      (const int16_t*)x, L, (const int*)n_samples, chunks, (long long*)part);
  return (int)cudaGetLastError();
}

}  // namespace
