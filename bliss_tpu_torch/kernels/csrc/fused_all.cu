// Sample statistics and summed power spectrum of an int16 PCM batch,
// hand-written for Hopper (sm_90a), bound through a plain C interface.
//
// Replaces three TPU kernels with two CUDA kernels and three entry points:
//
//   K1 bliss_tpu/kernels/fused_all.py::_kernel (fused_all_call)
//      -> bliss_fused_all: stats_kernel, then power_kernel;
//   K2 bliss_tpu/kernels/fused_stats.py::_kernel (fused_stats_call)
//      -> bliss_fused_stats: stats_kernel;
//   K3 bliss_tpu/kernels/pallas_stft.py::_kernel (stft_power)
//      -> bliss_stft_power: power_kernel.
//
// K1 is K2 and K3 in one pallas_call on the TPU; here it is the same two
// launches, one read of the PCM each, so the three wrappers share one
// source and one library. Each computes what its TPU wrapper returns, not
// the TPU kernel's layout: the TPU kernels split int16 samples and their
// tables into bf16 pieces for the MXU, fold the stereo downmix and its
// C-division correction into a duplicated-row DFT matrix and stack block
// pieces to fit (8, 128) tiles. Here the integer samples are read directly
// and every product is an FMA on the CUDA cores, with no split and no TF32:
// fp32 for the amplitude weights and the spectrum, fp64 for the tempo FIR
// and its sums. The tempo analyzer's peak detector compares envelope
// differences with eps = 1e-6, and on noisy music a few of its peaks per
// song sit within 1e-4 of that margin; two fp32 computations of the window
// energies that agree to ~4e-7 relative (this kernel against its plain
// version) still counted different beats on 3 of 64 three-minute songs. In
// fp64 the two agree to ~1e-15 and count the same beats.
//
//  * stats_kernel, grid (hop-block ranges, songs), 256 threads = one
//    256-sample hop block at a time. It stages the block's samples,
//    normalized (xn = alpha*s + beta), behind a (taps-1)-sample history in
//    shared memory. The history before sample 0 is alpha*halo0 + beta when
//    the caller passes halo0 [B, taps-1] (a sequence shard's view of the
//    previous shard's tail), else normalized zero. Per hop block it writes
//    the amplitude weight sum sum T(1000 - |s+1|) (Clenshaw series of the
//    smoothing CDF) and an any-nonzero flag, and per band the sums (of v,
//    v^2 and (-1)^t v) of three pieces of the causal FIR: z over the
//    block's tail t >= K (K = taps-1), z over its head t < K, and over the
//    head the window-reset FIR y = z + delta, delta = M h (M the band's
//    fir_warmup_correction, h the K samples before the block, halo0's for
//    block 0). A window is blocks (w, w+1) with its FIR reset at w's start,
//    so its sums are reset(w) + tail(w) + head(w+1) + tail(w+1): no term
//    cancels another. (The TPU kernel sums z over whole blocks and adds
//    delta corrections, which cancels the history's share of z^2 and
//    leaves float32 noise relative to the loud history in windows that
//    start just after a loud-to-silence edge.)
//  * power_kernel, grid (frame tiles, column tiles, songs). A tiled fp32
//    GEMM of the mono frames, mono = c_div(l + r, 2) in integers, with the
//    [512, 512] Hann-folded DFT table (re | im of bins 0..255). Local frame
//    f counts while offset + f < n_frames, offset the song's frame_offset
//    (a sequence shard's first global frame; 0 when none is passed); frames
//    that do not count are zero, and tiles wholly past the count exit. Each
//    tile writes sum over its frames of y^2 per column to a scratch
//    [B, tiles, 512] that the wrapper reduces with a deterministic sum.
//
// What bounds them on this card: the spectrum is ~2*512*512 FLOP per
// 512-sample frame, about 0.27 TFLOP at B=64, L=2^23, against a ~1 GiB PCM
// read, so power_kernel is compute-bound on the fp32 CUDA cores (67 TFLOP/s
// peak). The stats pass is ~60 FLOP per sample (fp64 for the FIR) and
// bound by the read. This first version is plain shared-memory tiling; a
// wgmma or FFT spectrum and fusing both passes into one read are later
// work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLK = 256;            // tempo hop: threads per stats block
constexpr int NWARP = BLK / 32;
constexpr int BLOCKS_PER_CTA = 8;   // hop blocks each stats block walks
constexpr int MAX_K = 128;          // taps - 1
constexpr int MAX_CHEB = 32;
constexpr int NSTAT = 9;            // (v, v^2, alt) x (tail, head, reset)

constexpr int WIN = 512;            // mono samples per frame
constexpr int NCOL = 512;           // re | im of bins 0..255
constexpr int PM = 64;              // frames per power tile
constexpr int PN = 64;              // DFT columns per power tile
constexpr int PK = 16;              // frame samples per shared-memory stage
constexpr int PTHREADS = 256;       // 16 x 16 threads, 4 x 4 outputs each

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

__global__ void __launch_bounds__(BLK) stats_kernel(
    const int16_t* __restrict__ x, int L, int nbf,
    const float* __restrict__ alpha, const float* __restrict__ beta,
    const int16_t* __restrict__ halo0, const float* __restrict__ cheb,
    int ncheb, float halfwidth, const double* __restrict__ fir,
    const double* __restrict__ warm, int nb, int taps,
    float* __restrict__ wsum, float* __restrict__ rownz,
    double* __restrict__ stats) {
  __shared__ double ext[MAX_K + BLK];  // [history | block], normalized
  __shared__ float cs[MAX_CHEB];
  __shared__ float redf[1][NWARP];
  __shared__ double redd[NSTAT][NWARP];

  const int b = blockIdx.y, t = threadIdx.x, K = taps - 1;
  if (t < ncheb) cs[t] = cheb[t];
  const double a = alpha[b], be = beta[b];
  const int16_t* xb = x + (size_t)b * L;
  const int16_t* hb = halo0 ? halo0 + (size_t)b * K : nullptr;
  const int blk0 = blockIdx.x * BLOCKS_PER_CTA;
  const int blk1 = min(blk0 + BLOCKS_PER_CTA, nbf);
  const double sign = (t & 1) ? -1.0 : 1.0;  // (-1)^t; blocks start even
  __syncthreads();

  for (int blk = blk0; blk < blk1; ++blk) {
    const long i0 = (long)blk * BLK;
    const float s = (float)xb[i0 + t];
    if (t < K) {
      const long h = i0 - K + t;
      // before sample 0: halo0's raw samples, else normalized zero
      ext[t] = h >= 0 ? fma(a, (double)xb[h], be)
                      : (hb ? fma(a, (double)hb[h + K], be) : 0.0);
    }
    ext[K + t] = fma(a, (double)s, be);
    const float w = cheb_T(1000.f - fabsf(s + 1.f), cs, ncheb, halfwidth);
    const int nz = __syncthreads_or(s != 0.f);  // also publishes ext
    if (t == 0) rownz[(size_t)b * nbf + blk] = nz ? 1.f : 0.f;
    {
      const float v[1] = {w};
      block_sums<float, 1>(v, redf, wsum + (size_t)b * nbf + blk, 0);
    }
    for (int band = 0; band < nb; ++band) {
      const double* c = fir + (size_t)band * taps;
      double z = 0.0;
      for (int m = 0; m < taps; ++m) z = fma(__ldg(c + m), ext[K + t - m], z);
      const bool head = t < K;
      double y = z;  // the window-reset FIR
      if (head) {
        const double* M = warm + ((size_t)band * K + t) * K;
        double delta = 0.0;
        for (int k = 0; k < K; ++k) delta = fma(__ldg(M + k), ext[k], delta);
        y = z + delta;
      }
      const double zt = head ? 0.0 : z, zh = head ? z : 0.0, yh = head ? y : 0.0;
      const double v[NSTAT] = {zt, zt * zt, sign * zt,
                               zh, zh * zh, sign * zh,
                               yh, yh * yh, sign * yh};
      block_sums<double, NSTAT>(
          v, redd, stats + ((size_t)(b * nb + band) * NSTAT) * nbf + blk,
          (size_t)nbf);
    }
  }
}

__global__ void __launch_bounds__(PTHREADS) power_kernel(
    const int16_t* __restrict__ x, int L, const int* __restrict__ n_frames,
    const int* __restrict__ frame_offset, const float* __restrict__ dft,
    float* __restrict__ part, int ntiles) {
  __shared__ float As[PK][PM + 4];  // mono frames, sample-major
  __shared__ float Bs[PK][PN];
  __shared__ float red[PM / 4][PN];

  const int tile = blockIdx.x, col0 = blockIdx.y * PN, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  // local frames that count: clamp(n_frames - offset, 0, L/1024), in 64
  // bits so that no offset wraps the count
  const long long cap = L / (2 * WIN);
  const long long left =
      (long long)n_frames[b] - (frame_offset ? frame_offset[b] : 0);
  const int nf = (int)(left < 0 ? 0 : (left > cap ? cap : left));
  const int f0 = tile * PM;
  float* out = part + ((size_t)b * ntiles + tile) * NCOL + col0;
  if (f0 >= nf) {
    if (tid < PN) out[tid] = 0.f;
    return;
  }
  // one short2 = one (left, right) sample pair; frame f is pairs
  // [f*512, f*512 + 512)
  const short2* xb = reinterpret_cast<const short2*>(x + (size_t)b * L);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < WIN; k0 += PK) {
    for (int i = tid; i < PM * PK; i += PTHREADS) {
      const int r = i / PK, kk = i % PK, f = f0 + r;
      float v = 0.f;
      if (f < nf) {
        const short2 p = xb[(size_t)f * WIN + k0 + kk];
        v = (float)(((int)p.x + (int)p.y) / 2);  // C truncating division
      }
      As[kk][r] = v;
    }
    for (int i = tid; i < PK * PN; i += PTHREADS) {
      const int kk = i / PN, c = i % PN;
      Bs[kk][c] = __ldg(dft + (size_t)(k0 + kk) * NCOL + col0 + c);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < PK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = As[kk][ty * 4 + i];
        bv[i] = Bs[kk][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) s = fmaf(acc[i][j], acc[i][j], s);
    red[ty][tx * 4 + j] = s;
  }
  __syncthreads();
  if (tid < PN) {
    float s = 0.f;
    for (int r = 0; r < PM / 4; ++r) s += red[r][tid];
    out[tid] = s;
  }
}

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
  stats_kernel<<<grid, BLK, 0, (cudaStream_t)stream>>>(
      (const int16_t*)x, L, nbf, (const float*)alpha, (const float*)beta,
      (const int16_t*)halo0, (const float*)cheb, ncheb, halfwidth,
      (const double*)fir, (const double*)warm, nb, taps, (float*)wsum,
      (float*)rownz, (double*)stats);
  return (int)cudaGetLastError();
}

int launch_power(const void* x, int B, int L, const void* n_frames,
                 const void* frame_offset, const void* dft, void* part,
                 int ntiles, void* stream) {
  const int nframes = L / (2 * WIN);
  if (B < 1 || B > 65535 || L % (2 * WIN) || nframes < 1 ||
      ntiles != (nframes + PM - 1) / PM)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(ntiles, NCOL / PN, B);
  power_kernel<<<grid, PTHREADS, 0, (cudaStream_t)stream>>>(
      (const int16_t*)x, L, (const int*)n_frames, (const int*)frame_offset,
      (const float*)dft, (float*)part, ntiles);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Frames per power tile: the wrappers size the scratch [B, tiles, 512].
int bliss_power_tile() { return PM; }

// Arguments shared by the entry points. x: int16 [B, L]; alpha, beta:
// float [B]; halo0: int16 [B, taps-1] or NULL; cheb: float [ncheb]; fir:
// double [nb, taps]; warm: double [nb, taps-1, taps-1]; wsum, rownz: float
// [B, L/256]; stats: double [B, nb, 9, L/256], rows (tail, head, reset) x
// (sum v, sum v^2, sum (-1)^t v); n_frames: int [B]; frame_offset: int [B]
// or NULL; dft: float [512, 512]; part: float [B, ntiles, 512] with
// ntiles = ceil((L/1024) / bliss_power_tile()). Each returns the launch's
// cudaError_t.

// K2: the sample statistics alone. L a multiple of 256.
int bliss_fused_stats(const void* x, int B, int L, const void* alpha,
                      const void* beta, const void* halo0, const void* cheb,
                      int ncheb, float halfwidth, const void* fir,
                      const void* warm, int nb, int taps, void* wsum,
                      void* rownz, void* stats, void* stream) {
  return launch_stats(x, B, L, alpha, beta, halo0, cheb, ncheb, halfwidth,
                      fir, warm, nb, taps, wsum, rownz, stats, stream);
}

// K3: the summed power spectrum alone. L a multiple of 1024.
int bliss_stft_power(const void* x, int B, int L, const void* n_frames,
                     const void* frame_offset, const void* dft, void* part,
                     int ntiles, void* stream) {
  return launch_power(x, B, L, n_frames, frame_offset, dft, part, ntiles,
                      stream);
}

// K1: both, with the whole song's frames (no frame offset). L a multiple
// of 1024.
int bliss_fused_all(const void* x, int B, int L, const void* alpha,
                    const void* beta, const void* halo0, const void* cheb,
                    int ncheb, float halfwidth, const void* fir,
                    const void* warm, int nb, int taps, void* wsum,
                    void* rownz, void* stats, const void* n_frames,
                    const void* dft, void* part, int ntiles, void* stream) {
  int rc = launch_stats(x, B, L, alpha, beta, halo0, cheb, ncheb, halfwidth,
                        fir, warm, nb, taps, wsum, rownz, stats, stream);
  if (rc == 0)
    rc = launch_power(x, B, L, n_frames, nullptr, dft, part, ntiles, stream);
  return rc;
}

const char* bliss_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
