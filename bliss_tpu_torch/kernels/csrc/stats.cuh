// The sample-statistics kernel, shared by csrc/fused_all.cu (K1, K2) and
// csrc/ablate.cu (its stage ablation A1).
//
// What it computes. Per 256-sample hop block of int16 [B, L]: the
// amplitude weight sum sum T(1000 - |s+1|) (Clenshaw series of the
// smoothing CDF), an any-nonzero flag and, per band, the sums (of v, v^2
// and (-1)^t v) of three pieces of the causal FIR of the normalized signal
// xn = alpha*s + beta: z over the block's tail t >= K (K = taps-1), z over
// its head t < K, and over the head the window-reset FIR y = z + delta,
// delta = M h (M the band's fir_warmup_correction, h the K samples before
// the block). The history before sample 0 is alpha*halo0 + beta when the
// caller passes halo0 [B, taps-1] (a sequence shard's view of the previous
// shard's tail), else normalized zero. A window is blocks (w, w+1) with its
// FIR reset at w's start, so its sums are reset(w) + tail(w) + head(w+1) +
// tail(w+1): no term cancels another. (The TPU kernel sums z over whole
// blocks and adds delta corrections, which cancels the history's share of
// z^2 and leaves float32 noise relative to the loud history in windows that
// start just after a loud-to-silence edge.)
//
// What bounds it: ~42 fp64 FLOP a sample (the 17-tap FIR, the sums, the
// correction) on the fp64 CUDA cores, against 2 bytes read
// (kernels/bounds.py stats_work, which counts the amplitude weight as the
// table below: its values once, then a lookup and an add a sample).
//
// The design: one warp a hop block, 8 consecutive samples a lane, and no
// block barrier in the hop-block loop. stats_kernel, a persistent grid of
// SWARPS-warp blocks, as many as fit on the card; each warp walks runs of
// RUN consecutive hop blocks of one song, run after run (the tables are
// set up once a block):
//   - lane l reads samples 8l .. 8l+7 of the block with one 16-byte load
//     (the next block's load is issued before this block's arithmetic);
//   - the amplitude weight is 1 or 0 but for the 2 ceil(halfwidth) values
//     of |s+1| around 1000 (400 for the shipped fit), so each block
//     evaluates the Clenshaw series once for each into a table and the
//     samples index it with |s+1|;
//   - the normalized samples go into a warp-private ring in shared memory
//     behind the K before them: the previous block's last K, carried in the
//     ring, or at the run's first block the K samples before it, read once
//     (so the PCM is read once plus K samples a run). One pad element every
//     8 keeps the lanes' stride-8 accesses on distinct banks;
//   - the FIR runs in registers on a sliding window of 8 samples a lane,
//     one ring read and 8 FMAs a tap;
//   - the sums run in registers over the lane's 8 samples, then over the
//     warp through a warp-private transpose in shared memory: 24 lanes sum
//     the tail's 3 pieces 4 lanes at a time, then 3 shuffle levels; 6 lanes
//     sum the head's and reset's 6 over the ceil(K/8) lanes that hold
//     t < K; wsum by shuffles, rownz by __any_sync; always in the same
//     order;
//   - delta's K x K MACs are shared by the 32 lanes (G lanes a row of M, G
//     the largest power of two with G*K <= 32), combined by shuffles and
//     handed to the head lanes through a warp-private row of K values;
//   - fir and M are staged in shared memory once a block where they fit,
//     M's rows padded to K+1, else read from global memory (on an H100
//     SXM at B=64, L=2^23, 17 taps, reading them through __ldg instead
//     made the kernel ~9% slower: chip_smoke.py, K2 and A1 "full").
// Only __syncwarp orders the warp-private shared memory; the one block
// barrier publishes the staged tables before the loop.
//
// Its template switches are the stages of the stage ablation (ablate.cu);
// the shipped kernel is stats_kernel<true, true, true, double>:
//   CHEB  amplitude weight T(1000 - |s+1|); off: the raw sample;
//   CONV  the causal FIR; off: z = xn;
//   WARM  the window-reset correction delta; off: delta = 0 (y = z);
//   FirT  the type of the FIR, the correction and their sums.
// kernels/fused_stats.stats_lane_steps runs the same lanes, windows,
// shuffle orders and delta split in PyTorch: change both together.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int HOP = 256;           // tempo hop: samples a hop block, 8 a lane
constexpr int SWARPS = 4;          // warps a stats block
constexpr int RUN = 8;             // consecutive hop blocks a warp walks
constexpr int MAX_K = 128;         // taps - 1
constexpr int MAX_CHEB = 32;
constexpr int MAX_WTAB = 1024;     // 2 ceil(halfwidth): the weight table
constexpr int NSTAT = 9;           // (v, v^2, alt) x (tail, head, reset)
constexpr int RING = 512;          // ring of normalized samples, >= HOP + MAX_K
constexpr int ROWS = RING / 8;     // ring rows of 8 samples, each padded to 9
constexpr int RING_PHYS = 9 * ROWS;
constexpr int RED = 33;            // a row of the pieces' transpose, padded
constexpr int WARP_SMEM = RING_PHYS + MAX_K + NSTAT * RED;  // ring, delta, pieces
constexpr int TABLE_SMEM_MAX = 64 * 1024;       // staged fir and M, bytes
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// physical index of ring element i (any int; the ring wraps at RING)
__device__ __forceinline__ int ring_at(int i) {
  return 9 * ((i >> 3) & (ROWS - 1)) + (i & 7);
}

// The positive half of the smoothing-kernel CDF at mf in [0, hw): its
// Chebyshev series by Clenshaw (bliss_tpu/kernels/fused_stats.py::_cheb_T).
__device__ __forceinline__ float cheb_half(float mf, const float* __restrict__ c,
                                           int n, float hw) {
  const float t = fminf(fmaxf((2.f * mf - hw) / hw, -1.f), 1.f);
  float b1 = 0.f, b2 = 0.f;
  for (int k = n - 1; k >= 1; --k) {
    const float nb1 = __ldg(c + k) + 2.f * t * b1 - b2;
    b2 = b1;
    b1 = nb1;
  }
  return __ldg(c) + t * b1 - b2;
}

// The amplitude weight T(1000 - |s+1|) of an int16 sample s, a = |s+1|:
// with m = 1000 - a, the CDF's positive half at mf = m (m >= 0) or 1 minus
// it at mf = -m - 1 (m < 0), and that half is 1 from mf >= hw on. So the
// weight is 1 for a < 1001 - nw, 0 for a >= 1001 + nw (nw = ceil(hw)), and
// wtab[a - (1001 - nw)] between, the 2 nw values the block evaluates once.
__device__ __forceinline__ float cheb_weight(int s, const float* wtab, int nw) {
  const int i = abs(s + 1) - (1001 - nw);
  return (unsigned)i < (unsigned)(2 * nw) ? wtab[i] : (i < 0 ? 1.f : 0.f);
}

template <bool CHEB, bool CONV, bool WARM, typename FirT>
__global__ void __launch_bounds__(SWARPS * 32, 4) stats_kernel(
    const int16_t* __restrict__ x, int B, int L, int nbf,
    const float* __restrict__ alpha, const float* __restrict__ beta,
    const int16_t* __restrict__ halo0, const float* __restrict__ cheb,
    int ncheb, float halfwidth, const FirT* __restrict__ fir,
    const FirT* __restrict__ warm, int nb, int taps, int staged,
    float* __restrict__ wsum, float* __restrict__ rownz,
    FirT* __restrict__ stats) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float wtab[MAX_WTAB];
  FirT* const smem = reinterpret_cast<FirT*>(smem_raw);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int K = taps - 1;

  // fir [nb, taps] and M [nb, K, K], staged with M's rows padded to K+1
  const FirT* firt = fir;
  const FirT* Mt = warm;
  int mstride = K;
  if (staged) {
    FirT* tab = smem + SWARPS * WARP_SMEM;
    const int nf = nb * taps;
    for (int i = threadIdx.x; i < nf; i += blockDim.x) tab[i] = fir[i];
    if (WARM)
      for (int i = threadIdx.x; i < nb * K * K; i += blockDim.x)
        tab[nf + i + i / K] = warm[i];  // row r = i / K lands at r * (K+1)
    firt = tab;
    Mt = tab + nf;
    mstride = K + 1;
  }
  const int nw = (int)ceilf(halfwidth);
  if (CHEB)
    for (int i = threadIdx.x; i < 2 * nw; i += blockDim.x) {
      const bool neg = i >= nw;  // a >= 1001: m < 0
      const float val = cheb_half((float)(neg ? i - nw : nw - 1 - i), cheb, ncheb, halfwidth);
      wtab[i] = neg ? 1.f - val : val;
    }
  __syncthreads();  // the tables; no block barrier after this one

  FirT* const ring = smem + warp * WARP_SMEM;
  FirT* const drow = ring + RING_PHYS;  // delta of the head, t < K
  FirT* const red = drow + MAX_K;       // the pieces' per-lane sums [9][RED]
  const int H = (K + 7) >> 3;  // lanes holding head samples
  int G = 1;                   // lanes sharing a row of M
  while (2 * G * K <= 32) G <<= 1;
  const int g = lane & (G - 1);
  const int kc = (K + G - 1) / G;  // each lane's run of k in a row
  const int k0 = min(g * kc, K), k1 = min(k0 + kc, K);
  const int rstep = 32 / G, nrow = (K + rstep - 1) / rstep;
  const FirT alt[2] = {FirT(1), FirT(-1)};  // (-1)^t, t = 8 lane + j

  // the grid is persistent: each warp walks runs of RUN hop blocks
  const int runs = (nbf + RUN - 1) / RUN;
  for (int run = blockIdx.x * SWARPS + warp; run < runs * B; run += gridDim.x * SWARPS) {
  const int b = run / runs, blk0 = (run - b * runs) * RUN, blk1 = min(blk0 + RUN, nbf);
  const FirT a = alpha[b], be = beta[b];
  const int16_t* xb = x + (size_t)b * L;
  const int4* xw4 = reinterpret_cast<const int4*>(xb);

  // the run's history: the K samples before its first block, normalized
  int base = MAX_K;  // ring index of the current block's sample 0
  __syncwarp();      // the previous run's reads of the ring are done
  for (int k = lane; k < K; k += 32) {
    const long h = (long)blk0 * HOP - K + k;
    ring[ring_at(base - K + k)] =
        h >= 0 ? fma_t(a, (FirT)xb[h], be)
               : (halo0 ? fma_t(a, (FirT)halo0[(size_t)b * K + h + K], be) : FirT(0));
  }

  int4 nxt = __ldg(xw4 + (size_t)blk0 * (HOP / 8) + lane);
  for (int blk = blk0; blk < blk1; ++blk, base += HOP) {
    const int4 cur = nxt;
    if (blk + 1 < blk1) nxt = __ldg(xw4 + (size_t)(blk + 1) * (HOP / 8) + lane);
    int s[8];
    {
      const int words[4] = {cur.x, cur.y, cur.z, cur.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        s[2 * q] = (int)((unsigned)words[q] << 16) >> 16;
        s[2 * q + 1] = words[q] >> 16;
      }
    }
    bool nz = false;
#pragma unroll
    for (int j = 0; j < 8; ++j) nz |= s[j] != 0;
    const bool nonzero = __any_sync(FULL, nz);
    float ws = CHEB ? cheb_weight(s[0], wtab, nw) : (float)s[0];
#pragma unroll
    for (int j = 1; j < 8; ++j) ws += CHEB ? cheb_weight(s[j], wtab, nw) : (float)s[j];
    ws = warp_sum(ws);
    if (lane == 0) {
      rownz[(size_t)b * nbf + blk] = nonzero ? 1.f : 0.f;
      wsum[(size_t)b * nbf + blk] = ws;
    }

    FirT xn[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) xn[j] = fma_t(a, (FirT)s[j], be);
    __syncwarp();  // every lane is done reading the previous block's ring
#pragma unroll
    for (int j = 0; j < 8; ++j) ring[ring_at(base + 8 * lane) + j] = xn[j];
    __syncwarp();

    for (int band = 0; band < nb; ++band) {
      FirT z[8];
      if (CONV) {
        // z[j] = sum_m fir[m] xn[8 lane + j - m], window v[j] = xn[8 lane + j - m]
        const FirT* f = firt + (size_t)band * taps;
        FirT v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          v[j] = xn[j];
          z[j] = FirT(0);
        }
        // taps m = 8a .. 8a+7 read ring row q0 - a backwards: one address a
        // row, and after 8 shifts each v[j] is back in its register
        const int q0 = (base >> 3) + lane - 1;
        int m = 0;
        for (int a = 0; m + 8 <= taps; ++a, m += 8) {
          const FirT* row = ring + 9 * ((q0 - a) & (ROWS - 1));
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const FirT fm = f[m + r];
#pragma unroll
            for (int j = 0; j < 8; ++j) z[j] = fma_t(fm, v[j], z[j]);
#pragma unroll
            for (int j = 7; j > 0; --j) v[j] = v[j - 1];
            v[0] = row[7 - r];
          }
        }
        for (; m < taps; ++m) {
          const FirT fm = f[m];
#pragma unroll
          for (int j = 0; j < 8; ++j) z[j] = fma_t(fm, v[j], z[j]);
#pragma unroll
          for (int j = 7; j > 0; --j) v[j] = v[j - 1];
          v[0] = ring[ring_at(base + 8 * lane - m - 1)];
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) z[j] = xn[j];
      }

      FirT tl[3] = {FirT(0), FirT(0), FirT(0)};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (8 * lane + j >= K) {
          tl[0] += z[j];
          tl[1] = fma_t(z[j], z[j], tl[1]);
          tl[2] = fma_t(alt[j & 1], z[j], tl[2]);
        }
      }

      if (WARM) {
        // delta[t] = sum_k M[t][k] h[k], h[k] = ring[base - K + k]: lane
        // (t mod rstep) * G + g sums k in [k0, k1) of row t, then the G
        // lanes of the row add their parts
        const FirT* M = Mt + (size_t)band * K * mstride;
        for (int r = 0; r < nrow; ++r) {
          const int t = r * rstep + lane / G;
          FirT d = FirT(0);
          if (t < K) {
            const FirT* Mr = M + t * mstride;
#pragma unroll 4
            for (int k = k0; k < k1; ++k) d = fma_t(Mr[k], ring[ring_at(base - K + k)], d);
          }
          for (int o = 1; o < G; o <<= 1) d += __shfl_xor_sync(FULL, d, o);
          if (t < K && g == 0) drow[t] = d;
        }
        __syncwarp();
      }

      FirT hd[6] = {FirT(0), FirT(0), FirT(0), FirT(0), FirT(0), FirT(0)};
      if (lane < H) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int t = 8 * lane + j;
          if (t < K) {
            const FirT zh = z[j], y = WARM ? zh + drow[t] : zh;
            hd[0] += zh;
            hd[1] = fma_t(zh, zh, hd[1]);
            hd[2] = fma_t(alt[j & 1], zh, hd[2]);
            hd[3] += y;
            hd[4] = fma_t(y, y, hd[4]);
            hd[5] = fma_t(alt[j & 1], y, hd[5]);
          }
        }
      }

      // the 9 pieces over the warp, through red: lane 8p + q sums tail
      // piece p over lanes 4q .. 4q+3, then the 8 lanes of p add theirs
      // (shuffles 1, 2, 4); lane 24 + p sums head piece p over lanes 0 .. H-1
#pragma unroll
      for (int p = 0; p < 3; ++p) red[p * RED + lane] = tl[p];
      if (lane < H) {
#pragma unroll
        for (int p = 0; p < 6; ++p) red[(3 + p) * RED + lane] = hd[p];
      }
      __syncwarp();
      FirT sum = FirT(0);
      if (lane < 24) {
        const FirT* r = red + (lane >> 3) * RED + 4 * (lane & 7);
        sum = r[0];
        sum += r[1];
        sum += r[2];
        sum += r[3];
      } else if (lane < 30) {
        const FirT* r = red + (lane - 21) * RED;
        sum = r[0];
        for (int i = 1; i < H; ++i) sum += r[i];
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) {
        const FirT u = __shfl_xor_sync(FULL, sum, o);
        if (lane < 24) sum += u;
      }
      const int piece = lane < 24 ? lane >> 3 : lane - 21;
      if (lane < 30 && (lane >= 24 || (lane & 7) == 0))
        stats[((size_t)(b * nb + band) * NSTAT + piece) * nbf + blk] = sum;
      __syncwarp();  // drow and red are read before the next band writes them
    }
  }
  }
}

// Launches stats_kernel<CHEB, CONV, WARM, FirT>; returns the launch's
// cudaError_t. L a multiple of 256, x 16-byte aligned.
template <bool CHEB, bool CONV, bool WARM, typename FirT>
int launch_stats(const void* x, int B, int L, const void* alpha,
                 const void* beta, const void* halo0, const void* cheb,
                 int ncheb, float halfwidth, const void* fir, const void* warm,
                 int nb, int taps, void* wsum, void* rownz, void* stats,
                 void* stream) {
  if (B < 1 || B > 65535 || L < HOP || L % HOP || nb < 1 || taps < 2 ||
      taps - 1 > MAX_K || ncheb < 1 || ncheb > MAX_CHEB ||
      !(halfwidth > 0.f && 2 * (int)ceilf(halfwidth) <= MAX_WTAB))
    return (int)cudaErrorInvalidValue;
  const int nbf = L / HOP, K = taps - 1;
  const size_t tables =
      ((size_t)nb * taps + (WARM ? (size_t)nb * K * (K + 1) : 0)) * sizeof(FirT);
  const int staged = tables <= (size_t)TABLE_SMEM_MAX;
  const size_t smem = SWARPS * WARP_SMEM * sizeof(FirT) + (staged ? tables : 0);
  auto kernel = stats_kernel<CHEB, CONV, WARM, FirT>;
  // the static weight table counts against the default 48 KB too, so opt in
  // to the dynamic size every time
  const cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != cudaSuccess) return (int)rc;
  // persistent: as many blocks as fit on the card at once, or fewer when
  // there are fewer runs
  const long long runs = (long long)B * ((nbf + RUN - 1) / RUN);
  if (runs > (1ll << 30)) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t st = cudaGetDevice(&dev);
  if (st == cudaSuccess) st = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (st == cudaSuccess)
    st = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, SWARPS * 32, smem);
  if (st != cudaSuccess) return (int)st;
  const long long wanted = (runs + SWARPS - 1) / SWARPS;
  const int grid = (int)std::min<long long>(wanted, (long long)std::max(per_sm, 1) * sms);
  kernel<<<grid, SWARPS * 32, smem, (cudaStream_t)stream>>>(
      (const int16_t*)x, B, L, nbf, (const float*)alpha, (const float*)beta,
      (const int16_t*)halo0, (const float*)cheb, ncheb, halfwidth,
      (const FirT*)fir, (const FirT*)warm, nb, taps, staged, (float*)wsum,
      (float*)rownz, (FirT*)stats);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* bliss_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
