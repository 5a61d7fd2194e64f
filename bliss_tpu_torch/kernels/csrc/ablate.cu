// Measurement kernels for the sample-statistics kernel (stats.cuh),
// hand-written for Hopper (sm_90a), bound through a plain C interface.
//
// Counterparts of the TPU measurement harnesses under scripts/:
//
//   A1 bliss_stats_ablate: stats_kernel with stages switched off
//      (scripts/ablate_fused.py make_kernel, run_variant);
//   A2 bliss_probe: read-and-reduce probes (scripts/ablate_fused.py
//      run_variant2's bodies, scripts/ablate_dma.py,
//      scripts/ablate_packread.py);
//   A3 bliss_matred_stats: the statistics with the FIR, the window-reset
//      correction and its inputs as fp64 tensor-core products
//      (scripts/proto_matred.py make_proto, proto_call).
//
// All three run on stats_kernel's geometry: a persistent grid of SWARPS-warp
// blocks, as many as fit on the card, one warp a 256-element row (a hop
// block), 16-byte loads with the next row's issued before this row's
// arithmetic, and no block barrier in the row loop. So each measures the
// floor of the geometry the main path runs.
//
// What bounds them on this card: A1 is stats_kernel itself (fp64 arithmetic
// on the CUDA cores, 34 TFLOP/s peak, over 2 bytes a sample). A2 reads each
// element once and does 0 to 11 float32 operations with it, so the bytes
// bound it (3.35 TB/s); a warp walks a stripe of PRUN consecutive rows of
// one chunk, sums each row in its lanes and then by shuffles, and lane k
// keeps row k's sums, so the stripe's outputs leave as coalesced rows of
// 32. A3 moves the FIR's ~34 fp64 FLOP a sample onto the fp64 tensor cores
// (67 TFLOP/s; mma.sync m16n8k8, a shape sm_90 adds for f64, four times the
// work of the m8n8k4 the first port used), so its bound
// (kernels/bounds.py matred_work) leaves the fp64 CUDA cores for its
// bytes, 2 read a sample and 64 written a hop block: the FIR of
// 32 segments of 8 outputs is a product of the ring of normalized samples,
// read in place as an im2col matrix, with the banded Toeplitz matrix of
// the taps, and the correction delta = M h of a run's 8 hop blocks is one
// product of M with their 8 histories.

#include <type_traits>

#include "stats.cuh"

namespace {

// ---- A2: read and reduce probes -------------------------------------------

constexpr int PRUN = 32;  // rows a warp walks: one 32-row stripe of output

// out[b, c, i, j] for row j of chunk c (rows of 256 elements, nblk rows a
// chunk), i = 0..7:
//   ZERO     0 (reads nothing);
//   SLICE    x[b, c*nblk + i, j] for j < 256, else 0 (8 rows of each chunk);
//   CONVERT  the chunk's first element;
//   SUM1     the row's sum;
//   SUM6     the row's sums of x, x^2, x+1, 2x, x-1, x/2, then x, x^2 again;
//   PACKED   int32 words: the row's sum of lo + hi, lo = (w << 16) >> 16,
//            hi = w >> 16 (two int16 samples a word, little-endian).
enum ProbeMode { ZERO = 0, SLICE = 1, CONVERT = 2, SUM1 = 3, SUM6 = 4, PACKED = 5 };

// A lane's 8 elements of a 256-element row, as its 16-byte loads read
// them: int16, elements 8l .. 8l+7 (one load); 4-byte types, 4l .. 4l+3 and
// 128+4l .. 128+4l+3 (two loads, each of them coalesced over the warp).
template <typename T>
struct LaneRow {
  static constexpr int NW = sizeof(T) == 2 ? 1 : 2;
  int4 w[NW];
  __device__ __forceinline__ void load(const int4* row, int lane) {
#pragma unroll
    for (int q = 0; q < NW; ++q) w[q] = __ldg(row + 32 * q + lane);
  }
};

// The lane's 8 elements as float32, in the order it sums them.
template <typename T, int MODE>
__device__ __forceinline__ void lane_values(const LaneRow<T>& r, float (&f)[8]) {
  if constexpr (sizeof(T) == 2) {
    const int words[4] = {r.w[0].x, r.w[0].y, r.w[0].z, r.w[0].w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      f[2 * q] = (float)((int)((unsigned)words[q] << 16) >> 16);
      f[2 * q + 1] = (float)(words[q] >> 16);
    }
  } else {
    const int words[8] = {r.w[0].x, r.w[0].y, r.w[0].z, r.w[0].w,
                          r.w[1].x, r.w[1].y, r.w[1].z, r.w[1].w};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if constexpr (MODE == PACKED)
        f[j] = (float)((int)((unsigned)words[j] << 16) >> 16) + (float)(words[j] >> 16);
      else if constexpr (std::is_same<T, float>::value)
        f[j] = __int_as_float(words[j]);
      else
        f[j] = (float)words[j];
    }
  }
}

// Persistent grid of SWARPS-warp blocks; each warp takes tasks (song b,
// chunk c, stripe of PRUN rows j0 ..) in turn and writes the stripe's
// [8, PRUN] outputs, lane l the row j0 + l. A sum mode reads each row with
// one or two 16-byte loads a lane, sums the lane's 8 terms in order, then
// over the warp with warp_sum (shuffle offsets 16, 8, 4, 2, 1), so every
// sum is taken in the same order on every run.
template <typename T, int MODE>
__global__ void __launch_bounds__(SWARPS * 32) probe_kernel(
    const T* __restrict__ x, int B, int rows, int nblk, float* __restrict__ out) {
  constexpr int NS = MODE == SUM6 ? 6 : 1;
  constexpr int W4 = HOP * (int)sizeof(T) / 16;  // 16-byte words a row
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nc = rows / nblk, stripes = (nblk + PRUN - 1) / PRUN;
  const long long tasks = (long long)B * nc * stripes;
  for (long long task = (long long)blockIdx.x * SWARPS + warp; task < tasks;
       task += (long long)gridDim.x * SWARPS) {
    const long long bc = task / stripes;  // b * nc + c
    const int j0 = (int)(task - bc * stripes) * PRUN, n = min(PRUN, nblk - j0);
    const T* xc = x + (size_t)bc * nblk * HOP;  // the chunk's first row
    float v[8];  // outputs i = 0..7 of row j0 + lane
    if constexpr (MODE == ZERO) {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = 0.f;
    } else if constexpr (MODE == SLICE) {
      const int j = j0 + lane;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        v[i] = (lane < n && j < HOP) ? (float)xc[(size_t)i * HOP + j] : 0.f;
    } else if constexpr (MODE == CONVERT) {
      const float f = (float)xc[0];  // one address for the whole warp
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = f;
    } else {
      const int4* r4 = reinterpret_cast<const int4*>(xc + (size_t)j0 * HOP);
      float mine[NS];
#pragma unroll
      for (int i = 0; i < NS; ++i) mine[i] = 0.f;
      LaneRow<T> nxt;
      nxt.load(r4, lane);
      for (int k = 0; k < n; ++k) {
        const LaneRow<T> cur = nxt;
        if (k + 1 < n) nxt.load(r4 + (size_t)(k + 1) * W4, lane);
        float f[8];
        lane_values<T, MODE>(cur, f);
        float s[NS];
        if constexpr (MODE == SUM6) {
#pragma unroll
          for (int i = 0; i < 6; ++i) s[i] = 0.f;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            s[0] += f[j];
            s[1] += __fmul_rn(f[j], f[j]);
            s[2] += f[j] + 1.f;
            s[3] += f[j] * 2.f;
            s[4] += f[j] - 1.f;
            s[5] += f[j] * 0.5f;
          }
        } else {
          s[0] = f[0];
#pragma unroll
          for (int j = 1; j < 8; ++j) s[0] += f[j];
        }
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          s[i] = warp_sum(s[i]);
          if (lane == k) mine[i] = s[i];
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = mine[i % NS];
    }
    if (lane < n) {
      float* o = out + (size_t)bc * 8 * nblk + j0 + lane;
#pragma unroll
      for (int i = 0; i < 8; ++i) o[(size_t)i * nblk] = v[i];
    }
  }
}

// The persistent grid of kernel: as many SWARPS-warp blocks as fit on the
// card at once (smem bytes of dynamic shared memory each), or fewer when
// there are fewer tasks; 0 if a query failed (rc says why).
template <typename K>
int persistent_grid(K kernel, long long tasks, size_t smem, cudaError_t& rc) {
  int dev = 0, sms = 0, per_sm = 0;
  rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, SWARPS * 32, smem);
  if (rc != cudaSuccess) return 0;
  const long long wanted = (tasks + SWARPS - 1) / SWARPS;
  return (int)std::min<long long>(wanted, (long long)std::max(per_sm, 1) * sms);
}

template <typename T, int MODE>
int launch_probe_mode(const void* x, int B, int rows, int nblk, void* out,
                      cudaStream_t st) {
  auto kernel = probe_kernel<T, MODE>;
  const long long tasks = (long long)B * (rows / nblk) * ((nblk + PRUN - 1) / PRUN);
  cudaError_t rc;
  const int grid = persistent_grid(kernel, tasks, 0, rc);
  if (rc != cudaSuccess) return (int)rc;
  kernel<<<grid, SWARPS * 32, 0, st>>>((const T*)x, B, rows, nblk, (float*)out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_probe(int mode, const void* x, int B, int rows, int nblk,
                 void* out, cudaStream_t st) {
  switch (mode) {
    case ZERO: return launch_probe_mode<T, ZERO>(x, B, rows, nblk, out, st);
    case SLICE: return launch_probe_mode<T, SLICE>(x, B, rows, nblk, out, st);
    case CONVERT: return launch_probe_mode<T, CONVERT>(x, B, rows, nblk, out, st);
    case SUM1: return launch_probe_mode<T, SUM1>(x, B, rows, nblk, out, st);
    case SUM6: return launch_probe_mode<T, SUM6>(x, B, rows, nblk, out, st);
    case PACKED:
      if constexpr (std::is_same<T, int32_t>::value)
        return launch_probe_mode<T, PACKED>(x, B, rows, nblk, out, st);
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaErrorInvalidValue;
}

// ---- A3: the FIR and the correction as fp64 tensor-core products ----------

// D += A B for one warp, A 16x8 row-major, B 8x8 column-major, fp64. With
// g = lane / 4 and q = lane % 4, lane l holds a[i] = A[g + 8 (i & 1)][q +
// 4 (i >> 1)], b[i] = B[q + 4 i][g] and d[i] = D[g + 8 (i >> 1)][2 q + (i &
// 1)] (PTX ISA, matrix fragments for mma.m16n8k8 with .f64; sm_90).
__device__ __forceinline__ void mma_f64(double (&d)[4], const double (&a)[4],
                                        const double (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

constexpr int MRING = 512;  // a warp's ring of normalized samples, >= HOP + MAX_K
constexpr int STAB_MAX = 2 * (1002 + MAX_WTAB / 2);  // the weight by sample value
static_assert(RUN == 8, "a run's 8 hop blocks are the 8 columns of delta's product");

// The ring holds fp64 pairs (elements 2P, 2P+1) in 16-byte slots; pair P
// sits at slot P ^ ((P >> 3) & 3). A lane's four 16-byte stores of its 8
// samples and the A fragments' 16-byte loads (8 consecutive pairs a
// quarter-warp, starting at a multiple of 4) then fall on 8 distinct slots of
// a 128-byte line, free of bank conflicts.
__device__ __forceinline__ int ring_slot(int P) {
  P &= MRING / 2 - 1;
  return P ^ ((P >> 3) & 3);
}

// s as a double without a conversion instruction (the SM converts 16 a
// clock, against 64 fp64 adds): the low word of 2^52 + 2^31 + s is
// 2^31 + s, and one exact subtract leaves s.
__device__ __forceinline__ double int_to_double(int s) {
  return __hiloint2double(0x43300000, s ^ (int)0x80000000) - 4503601774854144.0;
}

// 16 bytes from global to shared memory without a register, or 16 zero
// bytes when !valid; completes at cp_async_wait.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// waits until at most one of this thread's groups is in flight
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Stages run's raw samples, [blk0 * 256 - KE, blk1 * 256) of song b (zero
// before sample 0), in raw, a warp's copies of 16 bytes a lane.
__device__ __forceinline__ void stage_run(int16_t* raw, const int16_t* x, int L,
                                          int runs, int nbf, int run, int KE, int lane) {
  const int b = run / runs, blk0 = (run - b * runs) * RUN, blk1 = min(blk0 + RUN, nbf);
  const long s0 = (long)blk0 * HOP - KE;
  const int16_t* xb = x + (size_t)b * L;
  const int nch = (KE + (blk1 - blk0) * HOP) / 8;
  for (int c = lane; c < nch; c += 32) {
    const long src = s0 + 8 * c;
    cp_async16(raw + 8 * c, xb + (src >= 0 ? src : 0), src >= 0);
  }
}

// grid: the persistent grid of SWARPS-warp blocks; each warp walks runs of
// RUN hop blocks of one song, as stats_kernel does. The raw samples of a
// run and the KE = K rounded up to 8 before it are staged into the warp's
// shared memory by asynchronous copies issued a run ahead (two buffers),
// so a warp has its next run's ~4 KB in flight while it computes this one
// and the PCM is read once plus KE samples a run. Per run: h_n, the K
// normalized samples before block n of the run (normalized zero before
// sample 0), and delta = M [h_0 .. h_7] as products (m16n8k8: 16 rows of M
// by 8 of its columns, the 8 blocks' h as the 8 columns), kept in the
// warp's rows of deltas; the KE samples before the run, normalized, into
// the warp's ring. Per block: lane l takes samples 8l .. 8l+7, adds their
// float32 amplitude weights in float64 (looked up by sample value in a table the
// block fills once from stats_kernel's table of the Clenshaw series),
// counts its nonzero samples, and stores them, normalized (2^52 + 2^31 + s
// less that constant in place of a conversion), to the ring behind the KE
// before them; then z = A T, A the im2col matrix [32
// segments of 8 outputs x KE + 8] read from the ring in place, T the banded
// Toeplitz matrix [KE + 8 x 8] of the taps, T[w][n] = fir[n + KE - w] where
// 0 <= n + KE - w < taps: two tiles of 16 segments, (KE + 8) / 8 k-steps of
// 8, with the ring's window offsets 2q and 2q+1 as the step's k = q and q+4
// so that each A fragment is two 16-byte loads. Each lane then sums its 8
// outputs (segments g, g+8, g+16, g+24, outputs 2q, 2q+1) and, where t < K,
// its deltas into the 8 columns (sum z, sum (-1)^t z, sum z^2, sum delta,
// sum 2 z delta + delta^2, sum (-1)^t delta, wsum, count), and the warp
// adds them by a reduce-scatter of shuffles (offsets 16, 8, 4 halve the
// columns a lane holds, 2 and 1 add the last): 9 fp64 shuffles a block,
// where selector products would spend 15 of 16 rows of every tile on
// nothing with one block a warp. A non-finite column makes all 8 NaN, as
// the plain version's selector products do. out: double [B, nbf, 8].
// NK: (KE + 8) / 8 k-steps of the FIR when it is 2 or 3 (up to 17 taps),
// with T's fragments then held in registers; 0 for any other length, with
// T read from shared memory a step. NK = 2 (taps 2..9) serves no script's
// band; it keeps a 2-tap run on the 17-tap run's code, one FIR k-step
// shorter, which is how chip_smoke.py's phase 7 timings price a k-step.
template <int NK>
__global__ void __launch_bounds__(SWARPS * 32, 4) matred_stats_kernel(
    const int16_t* __restrict__ x, int B, int L, int nbf,
    const float* __restrict__ alpha, const float* __restrict__ beta,
    const float* __restrict__ cheb, int ncheb, float halfwidth,
    const double* __restrict__ fir, const double* __restrict__ warm,
    int taps, double* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float wtab[MAX_WTAB];
  __shared__ float stab[STAB_MAX];  // the weight of sample s at s + 1002 + nw
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int K = taps - 1, KE = (K + 7) & ~7, nk = NK ? NK : KE / 8 + 1;
  const int KD = (K + 15) & ~15;  // rows of M, padded to whole tiles
  const int RAW = KE + RUN * HOP;  // a run's staged samples
  double2* const tfrag = reinterpret_cast<double2*>(smem_raw);  // [nk][32]
  double* const wbase = reinterpret_cast<double*>(tfrag + nk * 32) +
                        (size_t)warp * (MRING + RUN * KD + RAW / 2);
  double2* const ring = reinterpret_cast<double2*>(wbase);
  double* const drow = wbase + MRING;  // delta [RUN][KD] of the run's blocks
  int16_t* const raw0 = reinterpret_cast<int16_t*>(drow + RUN * KD);  // [2][RAW]

  // T's fragments: step kk, lane (g, q): T[8kk + 2q + e][g], e = 0, 1
  for (int i = threadIdx.x; i < nk * 32; i += blockDim.x) {
    const int kk = i >> 5, gg = (i & 31) >> 2, qq = i & 3;
    double te[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = gg + KE - (8 * kk + 2 * qq + e);
      te[e] = (m >= 0 && m < taps) ? fir[m] : 0.0;
    }
    tfrag[i] = make_double2(te[0], te[1]);
  }
  const int nw = (int)ceilf(halfwidth);
  for (int i = threadIdx.x; i < 2 * nw; i += blockDim.x) {
    const bool neg = i >= nw;  // a >= 1001: m < 0
    const float val = cheb_half((float)(neg ? i - nw : nw - 1 - i), cheb, ncheb, halfwidth);
    wtab[i] = neg ? 1.f - val : val;
  }
  __syncthreads();
  // the weight of every sample by its value: zero at both ends, where
  // |s + 1| >= 1001 + nw, so a sample's index clamps into the table
  const int soff = 1002 + nw, ns = 2 * soff;
  for (int i = threadIdx.x; i < ns; i += blockDim.x)
    stab[i] = (i == 0 || i == ns - 1) ? 0.f : cheb_weight(i - soff, wtab, nw);
  __syncthreads();  // the tables; no block barrier after this one
  double2 treg[NK ? NK : 1];
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) treg[kk] = tfrag[kk * 32 + lane];

  const int runs = (nbf + RUN - 1) / RUN, stride = gridDim.x * SWARPS;
  int run = blockIdx.x * SWARPS + warp, buf = 0;
  if (run < runs * B) stage_run(raw0, x, L, runs, nbf, run, KE, lane);
  cp_async_commit();
  for (; run < runs * B; run += stride, buf ^= 1) {
    const int b = run / runs, blk0 = (run - b * runs) * RUN, blk1 = min(blk0 + RUN, nbf);
    const double a = alpha[b], be = beta[b];
    const int16_t* const raw = raw0 + buf * RAW;  // raw[KE + i]: sample blk0 * 256 + i
    if (run + stride < runs * B)
      stage_run(raw0 + (buf ^ 1) * RAW, x, L, runs, nbf, run + stride, KE, lane);
    cp_async_commit();
    cp_async_wait_prior();  // this lane's copies of the run are done
    __syncwarp();  // and every lane's; the previous run's reads of ring and drow too

    // delta[t][n] = sum_k M[t][k] h_n[k]: A = M (rows t, columns k), B =
    // [h_0 .. h_7] (rows k, column n = block blk0 + n of the run)
    for (int mt = 0; mt < KD / 16; ++mt) {
      double d[4] = {0.0, 0.0, 0.0, 0.0};
      for (int kd = 0; kd < (K + 7) / 8; ++kd) {
        double am[4], bh[2];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = 16 * mt + g + 8 * (i & 1), k = 8 * kd + q + 4 * (i >> 1);
          am[i] = (t < K && k < K) ? __ldg(warm + (size_t)t * K + k) : 0.0;
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int k = 8 * kd + q + 4 * i, i0 = g * HOP - K + k;  // raw index - KE
          bh[i] = (k < K && blk0 + g < blk1 && (long)blk0 * HOP + i0 >= 0)
                      ? fma(a, int_to_double(raw[KE + i0]), be) : 0.0;
        }
        mma_f64(d, am, bh);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = 16 * mt + g + 8 * (i >> 1), n = 2 * q + (i & 1);
        drow[n * KD + t] = d[i];
      }
    }
    // the run's history: the KE samples before its first block
    int base = MRING / 2;  // ring index of the current block's sample 0
    double* const ring1 = reinterpret_cast<double*>(ring);
    for (int k = lane; k < KE; k += 32) {
      const int e = base - KE + k;
      ring1[2 * ring_slot(e >> 1) + (e & 1)] =
          (long)blk0 * HOP - KE + k >= 0 ? fma(a, int_to_double(raw[k]), be) : 0.0;
    }

    const int4* const raw4 = reinterpret_cast<const int4*>(raw + KE);
    for (int blk = blk0; blk < blk1; ++blk, base += HOP) {
      const int4 cur = raw4[(blk - blk0) * (HOP / 8) + lane];
      int s[8];
      {
        const int words[4] = {cur.x, cur.y, cur.z, cur.w};
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          s[2 * p] = (int)((unsigned)words[p] << 16) >> 16;
          s[2 * p + 1] = words[p] >> 16;
        }
      }
      // the lane's float32 weights added in float64, in order
      double ws = stab[min(max(s[0] + soff, 0), ns - 1)];
      int cnt = s[0] != 0;
#pragma unroll
      for (int j = 1; j < 8; ++j) {
        ws += (double)stab[min(max(s[j] + soff, 0), ns - 1)];
        cnt += s[j] != 0;
      }
      __syncwarp();  // every lane is done reading the previous block's ring
#pragma unroll
      for (int p = 0; p < 4; ++p)
        ring[ring_slot((base >> 1) + 4 * lane + p)] =
            make_double2(fma(a, int_to_double(s[2 * p]), be),
                         fma(a, int_to_double(s[2 * p + 1]), be));
      __syncwarp();

      // z = A T: tile u holds segments 16u + g (a0, a2) and 16u + g + 8
      // (a1, a3); their window offsets 8kk + 2q, 8kk + 2q + 1 are one pair
      double z[2][4] = {{0.0, 0.0, 0.0, 0.0}, {0.0, 0.0, 0.0, 0.0}};
      const int p0 = ((base - KE) >> 1) + 4 * g + q;
      auto step = [&](int kk, double2 tb) {
        const double bt[2] = {tb.x, tb.y};
        const int s0 = ring_slot(p0 + 4 * kk);  // + 32 j: rows 8 j further
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const double2 lo = ring[(s0 + 64 * u) & (MRING / 2 - 1)];
          const double2 hi = ring[(s0 + 64 * u + 32) & (MRING / 2 - 1)];
          const double av[4] = {lo.x, hi.x, lo.y, hi.y};
          mma_f64(z[u], av, bt);
        }
      };
      if constexpr (NK > 0) {
#pragma unroll
        for (int kk = 0; kk < NK; ++kk) step(kk, treg[kk]);
      } else {
        for (int kk = 0; kk < nk; ++kk) step(kk, tfrag[kk * 32 + lane]);
      }

      // this lane's columns: z[u][i] is output t = 8 (16u + g + 8 (i >> 1))
      // + 2q + (i & 1), (-1)^t = (-1)^i
      double v[8] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, ws, int_to_double(cnt)};
#pragma unroll
      for (int u = 0; u < 2; ++u) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const double zv = z[u][i];
          v[0] += zv;
          v[1] += (i & 1) ? -zv : zv;
          v[2] = fma(zv, zv, v[2]);
        }
      }
      // the head, t < K <= 128: tile 0's outputs only, its rows g + 8 (t >=
      // 64) only when K > 64
      const double* dl = drow + (blk - blk0) * KD;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i == 2 && K <= 64) break;
        const int t = 8 * (g + 8 * (i >> 1)) + 2 * q + (i & 1);
        if (t < K) {
          const double zv = z[0][i], dv = dl[t];
          v[3] += dv;
          v[4] = fma(2.0 * zv + dv, dv, v[4]);
          v[5] += (i & 1) ? -dv : dv;
        }
      }
      // reduce-scatter: offset 16 leaves columns 4h .. 4h+3 (h = bit 4 of
      // the lane), 8 two of them, 4 one, column (lane >> 2) & 7
      double r4[4], r2[2];
      const bool h16 = lane & 16, h8 = lane & 8, h4 = lane & 4;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        r4[i] = (h16 ? v[i + 4] : v[i]) + __shfl_xor_sync(FULL, h16 ? v[i] : v[i + 4], 16);
#pragma unroll
      for (int i = 0; i < 2; ++i)
        r2[i] = (h8 ? r4[i + 2] : r4[i]) + __shfl_xor_sync(FULL, h8 ? r4[i] : r4[i + 2], 8);
      double col = (h4 ? r2[1] : r2[0]) + __shfl_xor_sync(FULL, h4 ? r2[0] : r2[1], 4);
      col += __shfl_xor_sync(FULL, col, 2);
      col += __shfl_xor_sync(FULL, col, 1);
      if (__any_sync(FULL, !isfinite(col))) col = __longlong_as_double(0x7ff8000000000000ll);
      if (q == 0) out[((size_t)b * nbf + blk) * 8 + g] = col;
    }
    __syncwarp();  // every lane is done with raw before the next run refills it
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace

extern "C" {

// A1: stats_kernel's stage ablation. variant: 0 full <1,1,1,double>,
// 1 no_cheb <0,1,1,double>, 2 no_conv <1,0,1,double>, 3 no_warm
// <1,1,0,double>, 4 bare <0,0,0,double>, 5 fir_fp32 <1,1,1,float>; the
// other arguments as bliss_fused_stats (csrc/fused_all.cu), with fir, warm
// and stats float for fir_fp32.
int bliss_stats_ablate(int variant, const void* x, int B, int L,
                       const void* alpha, const void* beta, const void* halo0,
                       const void* cheb, int ncheb, float halfwidth,
                       const void* fir, const void* warm, int nb, int taps,
                       void* wsum, void* rownz, void* stats, void* stream) {
#define BLISS_STATS_ARGS                                                   \
  x, B, L, alpha, beta, halo0, cheb, ncheb, halfwidth, fir, warm, nb, taps, \
      wsum, rownz, stats, stream
  switch (variant) {
    case 0: return launch_stats<true, true, true, double>(BLISS_STATS_ARGS);
    case 1: return launch_stats<false, true, true, double>(BLISS_STATS_ARGS);
    case 2: return launch_stats<true, false, true, double>(BLISS_STATS_ARGS);
    case 3: return launch_stats<true, true, false, double>(BLISS_STATS_ARGS);
    case 4: return launch_stats<false, false, false, double>(BLISS_STATS_ARGS);
    case 5: return launch_stats<true, true, true, float>(BLISS_STATS_ARGS);
  }
#undef BLISS_STATS_ARGS
  return (int)cudaErrorInvalidValue;
}

// A2: x [B, rows, 256] of dtype 0 int16, 1 int32, 2 float (NULL for mode
// ZERO), 16-byte aligned; out float [B, rows / nblk, 8, nblk]; rows a
// multiple of nblk, nblk >= 8. PACKED takes int32 only.
int bliss_probe(int mode, int dtype, const void* x, int B, int rows, int nblk,
                void* out, void* stream) {
  if (B < 1 || B > 65535 || rows < 1 || nblk < 8 || rows % nblk)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch_probe<int16_t>(mode, x, B, rows, nblk, out, st);
    case 1: return launch_probe<int32_t>(mode, x, B, rows, nblk, out, st);
    case 2: return launch_probe<float>(mode, x, B, rows, nblk, out, st);
  }
  return (int)cudaErrorInvalidValue;
}

// A3: x int16 [B, L], 16-byte aligned, L a multiple of 256; alpha, beta
// float [B]; cheb float [ncheb]; fir double [taps] and warm double [taps-1,
// taps-1] (one band); out double [B, L/256, 8].
int bliss_matred_stats(const void* x, int B, int L, const void* alpha,
                       const void* beta, const void* cheb, int ncheb,
                       float halfwidth, const void* fir, const void* warm,
                       int taps, void* out, void* stream) {
  if (B < 1 || B > 65535 || L < HOP || L % HOP || taps < 2 ||
      taps - 1 > MAX_K || ncheb < 1 || ncheb > MAX_CHEB ||
      !(halfwidth > 0.f && 2 * (int)ceilf(halfwidth) <= MAX_WTAB))
    return (int)cudaErrorInvalidValue;
  const int nbf = L / HOP, K = taps - 1;
  const int KE = (K + 7) & ~7, nk = KE / 8 + 1, KD = (K + 15) & ~15;
  const size_t smem = (size_t)nk * 32 * sizeof(double2) +
                      (size_t)SWARPS * (MRING + RUN * KD + (KE + RUN * HOP) / 2) * sizeof(double);
  auto kernel = nk == 2 ? matred_stats_kernel<2>
                : nk == 3 ? matred_stats_kernel<3> : matred_stats_kernel<0>;
  // the static weight table counts against the default 48 KB too, so opt in
  // to the dynamic size every time
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != cudaSuccess) return (int)rc;
  const long long runs = (long long)B * ((nbf + RUN - 1) / RUN);
  const int grid = persistent_grid(kernel, runs, smem, rc);
  if (rc != cudaSuccess) return (int)rc;
  kernel<<<grid, SWARPS * 32, smem, (cudaStream_t)stream>>>(
      (const int16_t*)x, B, L, nbf, (const float*)alpha, (const float*)beta,
      (const float*)cheb, ncheb, halfwidth, (const double*)fir,
      (const double*)warm, taps, (double*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
