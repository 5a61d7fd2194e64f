// The sample-statistics kernel, shared by csrc/fused_all.cu (K1, K2) and
// csrc/ablate.cu (its stage ablation and the reductions it is built from).
//
// stats_kernel, grid (hop-block ranges, songs), 256 threads = one 256-sample
// hop block at a time. It stages the block's samples, normalized
// (xn = alpha*s + beta), behind a (taps-1)-sample history in shared memory.
// The history before sample 0 is alpha*halo0 + beta when the caller passes
// halo0 [B, taps-1] (a sequence shard's view of the previous shard's tail),
// else normalized zero. Per hop block it writes the amplitude weight sum
// sum T(1000 - |s+1|) (Clenshaw series of the smoothing CDF) and an
// any-nonzero flag, and per band the sums (of v, v^2 and (-1)^t v) of three
// pieces of the causal FIR: z over the block's tail t >= K (K = taps-1), z
// over its head t < K, and over the head the window-reset FIR y = z + delta,
// delta = M h (M the band's fir_warmup_correction, h the K samples before
// the block, halo0's for block 0). A window is blocks (w, w+1) with its FIR
// reset at w's start, so its sums are reset(w) + tail(w) + head(w+1) +
// tail(w+1): no term cancels another. (The TPU kernel sums z over whole
// blocks and adds delta corrections, which cancels the history's share of
// z^2 and leaves float32 noise relative to the loud history in windows that
// start just after a loud-to-silence edge.)
//
// Its template switches are the stages of the stage ablation (ablate.cu);
// the shipped kernel is stats_kernel<true, true, true, double>:
//   CHEB  amplitude weight T(1000 - |s+1|); off: the raw sample;
//   CONV  the causal FIR; off: z = xn;
//   WARM  the window-reset correction delta; off: delta = 0 (y = z);
//   FirT  the type of the FIR, the correction and their sums.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLK = 256;            // tempo hop: threads per stats block
constexpr int NWARP = BLK / 32;
constexpr int BLOCKS_PER_CTA = 8;   // hop blocks each stats block walks
constexpr int MAX_K = 128;          // taps - 1
constexpr int MAX_CHEB = 32;
constexpr int NSTAT = 9;            // (v, v^2, alt) x (tail, head, reset)

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sums v[i] over the 256 threads of the block and stores total i at
// out[i * stride]. Fixed order, so results do not vary run to run. Ends with
// a barrier, so shared memory read before the call may be rewritten after.
template <typename T, int N>
__device__ __forceinline__ void block_sums(const T (&v)[N], T (*red)[NWARP],
                                           T* out, size_t stride) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const T s = warp_sum(v[i]);
    if (lane == 0) red[i][warp] = s;
  }
  __syncthreads();
  if (threadIdx.x < N) {
    T s = 0;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) s += red[threadIdx.x][w];
    out[threadIdx.x * stride] = s;
  }
  __syncthreads();
}

// Smoothing-kernel CDF: Chebyshev series of the positive half, folded by
// symmetry (bliss_tpu/kernels/fused_stats.py::_cheb_T).
__device__ __forceinline__ float cheb_T(float m, const float* c, int n,
                                        float hw) {
  const bool neg = m < 0.f;
  const float mf = neg ? -m - 1.f : m;
  const float t = fminf(fmaxf((2.f * mf - hw) / hw, -1.f), 1.f);
  float b1 = 0.f, b2 = 0.f;
  for (int k = n - 1; k >= 1; --k) {
    const float nb1 = c[k] + 2.f * t * b1 - b2;
    b2 = b1;
    b1 = nb1;
  }
  float val = c[0] + t * b1 - b2;
  if (mf >= hw) val = 1.f;
  return neg ? 1.f - val : val;
}

template <bool CHEB, bool CONV, bool WARM, typename FirT>
__global__ void __launch_bounds__(BLK) stats_kernel(
    const int16_t* __restrict__ x, int L, int nbf,
    const float* __restrict__ alpha, const float* __restrict__ beta,
    const int16_t* __restrict__ halo0, const float* __restrict__ cheb,
    int ncheb, float halfwidth, const FirT* __restrict__ fir,
    const FirT* __restrict__ warm, int nb, int taps,
    float* __restrict__ wsum, float* __restrict__ rownz,
    FirT* __restrict__ stats) {
  __shared__ FirT ext[MAX_K + BLK];  // [history | block], normalized
  __shared__ float cs[MAX_CHEB];
  __shared__ float redf[1][NWARP];
  __shared__ FirT redd[NSTAT][NWARP];

  const int b = blockIdx.y, t = threadIdx.x, K = taps - 1;
  if (t < ncheb) cs[t] = cheb[t];
  const FirT a = alpha[b], be = beta[b];
  const int16_t* xb = x + (size_t)b * L;
  const int16_t* hb = halo0 ? halo0 + (size_t)b * K : nullptr;
  const int blk0 = blockIdx.x * BLOCKS_PER_CTA;
  const int blk1 = min(blk0 + BLOCKS_PER_CTA, nbf);
  const FirT sign = (t & 1) ? FirT(-1) : FirT(1);  // (-1)^t; blocks start even
  __syncthreads();

  for (int blk = blk0; blk < blk1; ++blk) {
    const long i0 = (long)blk * BLK;
    const float s = (float)xb[i0 + t];
    if (t < K) {
      const long h = i0 - K + t;
      // before sample 0: halo0's raw samples, else normalized zero
      ext[t] = h >= 0 ? fma_t(a, (FirT)xb[h], be)
                      : (hb ? fma_t(a, (FirT)hb[h + K], be) : FirT(0));
    }
    ext[K + t] = fma_t(a, (FirT)s, be);
    const float w = CHEB ? cheb_T(1000.f - fabsf(s + 1.f), cs, ncheb, halfwidth) : s;
    const int nz = __syncthreads_or(s != 0.f);  // also publishes ext
    if (t == 0) rownz[(size_t)b * nbf + blk] = nz ? 1.f : 0.f;
    {
      const float v[1] = {w};
      block_sums<float, 1>(v, redf, wsum + (size_t)b * nbf + blk, 0);
    }
    for (int band = 0; band < nb; ++band) {
      FirT z = ext[K + t];
      if (CONV) {
        const FirT* c = fir + (size_t)band * taps;
        z = FirT(0);
        for (int m = 0; m < taps; ++m) z = fma_t(__ldg(c + m), ext[K + t - m], z);
      }
      const bool head = t < K;
      FirT y = z;  // the window-reset FIR
      if (WARM && head) {
        const FirT* M = warm + ((size_t)band * K + t) * K;
        FirT delta = FirT(0);
        for (int k = 0; k < K; ++k) delta = fma_t(__ldg(M + k), ext[k], delta);
        y = z + delta;
      }
      const FirT zt = head ? FirT(0) : z, zh = head ? z : FirT(0),
                 yh = head ? y : FirT(0);
      const FirT v[NSTAT] = {zt, zt * zt, sign * zt,
                             zh, zh * zh, sign * zh,
                             yh, yh * yh, sign * yh};
      block_sums<FirT, NSTAT>(
          v, redd, stats + ((size_t)(b * nb + band) * NSTAT) * nbf + blk,
          (size_t)nbf);
    }
  }
}

// Launches stats_kernel<CHEB, CONV, WARM, FirT>; returns the launch's
// cudaError_t. L a multiple of 256.
template <bool CHEB, bool CONV, bool WARM, typename FirT>
int launch_stats(const void* x, int B, int L, const void* alpha,
                 const void* beta, const void* halo0, const void* cheb,
                 int ncheb, float halfwidth, const void* fir, const void* warm,
                 int nb, int taps, void* wsum, void* rownz, void* stats,
                 void* stream) {
  if (B < 1 || B > 65535 || L < BLK || L % BLK || nb < 1 || taps < 2 ||
      taps - 1 > MAX_K || ncheb < 1 || ncheb > MAX_CHEB)
    return (int)cudaErrorInvalidValue;
  const int nbf = L / BLK;
  const dim3 grid((nbf + BLOCKS_PER_CTA - 1) / BLOCKS_PER_CTA, B);
  stats_kernel<CHEB, CONV, WARM, FirT><<<grid, BLK, 0, (cudaStream_t)stream>>>(
      (const int16_t*)x, L, nbf, (const float*)alpha, (const float*)beta,
      (const int16_t*)halo0, (const float*)cheb, ncheb, halfwidth,
      (const FirT*)fir, (const FirT*)warm, nb, taps, (float*)wsum,
      (float*)rownz, (FirT*)stats);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* bliss_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
