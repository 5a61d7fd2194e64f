// Measurement kernels for the sample-statistics kernel (stats.cuh),
// hand-written for Hopper (sm_90a), bound through a plain C interface.
//
// Counterparts of the TPU measurement harnesses under scripts/:
//
//   A1 bliss_stats_ablate: stats_kernel with stages switched off
//      (scripts/ablate_fused.py make_kernel, run_variant);
//   A2 bliss_probe: read-and-reduce probes with the launch geometry of
//      stats_kernel's first port (scripts/ablate_fused.py run_variant2's
//      bodies, scripts/ablate_dma.py, scripts/ablate_packread.py);
//   A3 bliss_matred_stats: the statistics with every reduction done as an
//      fp64 tensor-core product by selector matrices
//      (scripts/proto_matred.py make_proto, proto_call).
//
// What bounds them on this card: A1 is stats_kernel itself (fp64
// arithmetic on the CUDA cores, 34 TFLOP/s peak, over 2 bytes a sample),
// one warp a hop block. A2 keeps the geometry stats_kernel had before it
// became one warp a hop block: a 256-thread block walks 8 hop blocks, one
// element a thread, and sums each 256-wide row with block_sums (two block
// barriers a row); at full width its time is that geometry's floor for the
// read plus its per-row barriers, and with 1 to 6 adds an element it is
// bound by the bytes. A3 moves the block reductions of that geometry from
// warp shuffles and barriers to mma.sync m8n8k4 f64 (67 TFLOP/s fp64
// tensor-core peak), most of whose products are by the selectors' zeros.

#include <type_traits>

#include "stats.cuh"

namespace {

// ---- the geometry and reductions of A2 and A3 ------------------------------
// (stats_kernel's before it became one warp a hop block; kept as they were
// so that the probes and A3 measure what they measured)

constexpr int BLK = 256;            // tempo hop: threads per stats block
constexpr int NWARP = BLK / 32;
constexpr int BLOCKS_PER_CTA = 8;   // hop blocks each stats block walks

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

// ---- A2: read and reduce probes -------------------------------------------

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

template <typename T, int MODE>
__global__ void __launch_bounds__(BLK) probe_kernel(
    const T* __restrict__ x, int rows, int nblk, float* __restrict__ out) {
  constexpr int NS = MODE == SUM6 ? 6 : 1;
  __shared__ float red[NS][NWARP];
  __shared__ float res[NS];

  const int b = blockIdx.y, t = threadIdx.x, nc = rows / nblk;
  const int r0 = blockIdx.x * BLOCKS_PER_CTA;
  const int r1 = min(r0 + BLOCKS_PER_CTA, rows);
  const T* xb = MODE == ZERO ? nullptr : x + (size_t)b * rows * BLK;
  for (int r = r0; r < r1; ++r) {
    const int c = r / nblk, j = r - c * nblk;
    float* o = out + (size_t)(b * nc + c) * 8 * nblk + j;  // o[i * nblk]
    if (MODE == ZERO || MODE == SLICE || MODE == CONVERT) {
      if (t < 8) {
        float v = 0.f;
        if (MODE == SLICE && j < BLK) v = (float)xb[((size_t)c * nblk + t) * BLK + j];
        if (MODE == CONVERT) v = (float)xb[(size_t)c * nblk * BLK];
        o[(size_t)t * nblk] = v;
      }
      continue;
    }
    const T v = xb[(size_t)r * BLK + t];
    float f;
    if constexpr (MODE == PACKED) {
      const int w = (int)v;
      f = (float)((int)((unsigned)w << 16) >> 16) + (float)(w >> 16);
    } else {
      f = (float)v;
    }
    if constexpr (MODE == SUM6) {
      const float vals[6] = {f, f * f, f + 1.f, f * 2.f, f - 1.f, f * 0.5f};
      block_sums<float, 6>(vals, red, res, 1);
      if (t < 8) o[(size_t)t * nblk] = res[t % 6];
    } else {
      const float vals[1] = {f};
      block_sums<float, 1>(vals, red, res, 1);
      if (t < 8) o[(size_t)t * nblk] = res[0];
    }
  }
}

template <typename T>
int launch_probe(int mode, const void* x, int B, int rows, int nblk,
                 void* out, cudaStream_t st) {
  const dim3 grid((rows + BLOCKS_PER_CTA - 1) / BLOCKS_PER_CTA, B);
  const T* xt = (const T*)x;
  float* o = (float*)out;
  switch (mode) {
    case ZERO: probe_kernel<T, ZERO><<<grid, BLK, 0, st>>>(xt, rows, nblk, o); break;
    case SLICE: probe_kernel<T, SLICE><<<grid, BLK, 0, st>>>(xt, rows, nblk, o); break;
    case CONVERT: probe_kernel<T, CONVERT><<<grid, BLK, 0, st>>>(xt, rows, nblk, o); break;
    case SUM1: probe_kernel<T, SUM1><<<grid, BLK, 0, st>>>(xt, rows, nblk, o); break;
    case SUM6: probe_kernel<T, SUM6><<<grid, BLK, 0, st>>>(xt, rows, nblk, o); break;
    case PACKED:
      if constexpr (std::is_same<T, int32_t>::value) {
        probe_kernel<T, PACKED><<<grid, BLK, 0, st>>>(xt, rows, nblk, o);
        break;
      }
      return (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// ---- A3: reductions as fp64 tensor-core products --------------------------

// D = A B + D for one warp, A 8x4 row-major, B 4x8 column-major, fp64. Lane
// l holds A[l/4][l%4], B[l%4][l/4] and D[l/4][2*(l%4) + {0, 1}] (PTX ISA,
// matrix fragments for mma.m8n8k4 with .f64).
__device__ __forceinline__ void mma_f64(double& d0, double& d1, double a,
                                        double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1}, {%2}, {%3}, {%0, %1};\n"
      : "+d"(d0), "+d"(d1)
      : "d"(a), "d"(b));
}

struct MatredSmem {
  double ext[MAX_K + BLOCKS_PER_CTA * BLK];  // [history | 8 blocks], normalized
  double z[BLOCKS_PER_CTA][BLK];             // the causal FIR
  float w[BLOCKS_PER_CTA][BLK];              // amplitude weights
  float nz[BLOCKS_PER_CTA][BLK];             // 1 where the sample is nonzero
  double d[BLOCKS_PER_CTA][MAX_K];           // head: delta
  double e[BLOCKS_PER_CTA][MAX_K];           // head: 2 z delta + delta^2
  double c[NWARP][8][8];                     // each warp's partial product
  float cs[MAX_CHEB];
};

// grid (ranges of 8 hop blocks, songs), 256 threads. Stages the 8 blocks'
// samples, normalized, behind a (taps-1)-sample history (normalized zero
// before sample 0), then the pieces z, w, the nonzero flags and, over each
// block's head, delta and 2 z delta + delta^2, then sums them over each
// block as C[8 blocks x 8 columns] = sum over pieces of A_piece [8 x 256]
// times a selector R_piece [256 x 8] of ones, alternating signs and zeros:
// columns (sum z, sum (-1)^t z, sum z^2, sum delta, sum 2 z delta +
// delta^2, sum (-1)^t delta, sum w, count of nonzero samples). Warp v takes
// k in [32v, 32v + 32) in 8 steps of 4; the 8 partial C are summed in a
// fixed order. out: double [B, nbf, 8].
__global__ void __launch_bounds__(BLK) matred_stats_kernel(
    const int16_t* __restrict__ x, int L, int nbf,
    const float* __restrict__ alpha, const float* __restrict__ beta,
    const float* __restrict__ cheb, int ncheb, float halfwidth,
    const double* __restrict__ fir, const double* __restrict__ warm,
    int taps, double* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  MatredSmem& S = *reinterpret_cast<MatredSmem*>(smem_raw);

  const int b = blockIdx.y, t = threadIdx.x, K = taps - 1;
  const int lane = t & 31, warp = t >> 5;
  if (t < ncheb) S.cs[t] = cheb[t];
  const double a = alpha[b], be = beta[b];
  const int16_t* xb = x + (size_t)b * L;
  const int blk0 = blockIdx.x * BLOCKS_PER_CTA;
  const int nblk = min(BLOCKS_PER_CTA, nbf - blk0);
  const long i0 = (long)blk0 * BLK;
  for (int i = t; i < K + BLOCKS_PER_CTA * BLK; i += BLK) {
    const long h = i0 - K + i;
    S.ext[i] = (h >= 0 && i < K + nblk * BLK) ? fma(a, (double)xb[h], be) : 0.0;
  }
  __syncthreads();

  for (int j = 0; j < BLOCKS_PER_CTA; ++j) {
    double z = 0.0;
    float wv = 0.f, nzv = 0.f;
    if (j < nblk) {
      const float s = (float)xb[i0 + (long)j * BLK + t];
      wv = cheb_T(1000.f - fabsf(s + 1.f), S.cs, ncheb, halfwidth);
      nzv = s != 0.f ? 1.f : 0.f;
      const double* e = S.ext + K + j * BLK + t;
      for (int m = 0; m < taps; ++m) z = fma(__ldg(fir + m), e[-m], z);
    }
    if (t < K) {
      double delta = 0.0;
      if (j < nblk) {
        const double* M = warm + (size_t)t * K;
        const double* h = S.ext + j * BLK;  // the K samples before block j
        for (int k = 0; k < K; ++k) delta = fma(__ldg(M + k), h[k], delta);
      }
      S.d[j][t] = delta;
      S.e[j][t] = (2.0 * z + delta) * delta;
    }
    S.z[j][t] = z;
    S.w[j][t] = wv;
    S.nz[j][t] = nzv;
  }
  __syncthreads();

  // this lane's A row (hop block) and k offset, and its B entry: row k,
  // column col of each selector
  const int row = lane >> 2, q = lane & 3, col = lane >> 2;
  const double alt = (q & 1) ? -1.0 : 1.0;  // (-1)^k; k0 is a multiple of 4
  const double rz = col == 0 ? 1.0 : (col == 1 ? alt : 0.0);
  const double rzz = col == 2 ? 1.0 : 0.0;
  const double rd = col == 3 ? 1.0 : (col == 5 ? alt : 0.0);
  const double re = col == 4 ? 1.0 : 0.0;
  const double rw = col == 6 ? 1.0 : 0.0;
  const double rn = col == 7 ? 1.0 : 0.0;
  double c0 = 0.0, c1 = 0.0;
  const int kbeg = warp * (BLK / NWARP);
  for (int k0 = kbeg; k0 < kbeg + BLK / NWARP; k0 += 4) {
    const int k = k0 + q;
    const double zv = S.z[row][k];
    mma_f64(c0, c1, zv, rz);
    mma_f64(c0, c1, zv * zv, rzz);
    mma_f64(c0, c1, (double)S.w[row][k], rw);
    mma_f64(c0, c1, (double)S.nz[row][k], rn);
    if (k0 < K) {  // the head's pieces; the same for the whole warp
      mma_f64(c0, c1, k < K ? S.d[row][k] : 0.0, rd);
      mma_f64(c0, c1, k < K ? S.e[row][k] : 0.0, re);
    }
  }
  S.c[warp][row][2 * q] = c0;
  S.c[warp][row][2 * q + 1] = c1;
  __syncthreads();
  if (t < 64) {
    const int j = t >> 3, cc = t & 7;
    double s = 0.0;
#pragma unroll
    for (int v = 0; v < NWARP; ++v) s += S.c[v][j][cc];
    if (j < nblk) out[((size_t)b * nbf + blk0 + j) * 8 + cc] = s;
  }
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
// ZERO); out float [B, rows / nblk, 8, nblk]; rows a multiple of nblk,
// nblk >= 8. PACKED takes int32 only.
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

// A3: x int16 [B, L], L a multiple of 256; alpha, beta float [B]; cheb
// float [ncheb]; fir double [taps] and warm double [taps-1, taps-1] (one
// band); out double [B, L/256, 8].
int bliss_matred_stats(const void* x, int B, int L, const void* alpha,
                       const void* beta, const void* cheb, int ncheb,
                       float halfwidth, const void* fir, const void* warm,
                       int taps, void* out, void* stream) {
  if (B < 1 || B > 65535 || L < BLK || L % BLK || taps < 2 ||
      taps - 1 > MAX_K || ncheb < 1 || ncheb > MAX_CHEB)
    return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(MatredSmem);
  cudaError_t rc = cudaFuncSetAttribute(
      matred_stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return (int)rc;
  const int nbf = L / BLK;
  const dim3 grid((nbf + BLOCKS_PER_CTA - 1) / BLOCKS_PER_CTA, B);
  matred_stats_kernel<<<grid, BLK, smem, (cudaStream_t)stream>>>(
      (const int16_t*)x, L, nbf, (const float*)alpha, (const float*)beta,
      (const float*)cheb, ncheb, halfwidth, (const double*)fir,
      (const double*)warm, taps, (double*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
