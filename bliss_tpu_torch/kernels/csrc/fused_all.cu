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
//  * stats_kernel (csrc/stats.cuh, shared with the stage ablation of
//    csrc/ablate.cu; instantiated here as <true, true, true, double>): per
//    256-sample hop block the amplitude weight sum, an any-nonzero flag and
//    per band the fp64 sums of the FIR's tail, head and window-reset pieces.
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
// peak). The stats pass is ~50 fp64 FLOP per sample (the 17-tap FIR, the
// head's warm-up correction, squares and block sums) against 2 bytes read,
// so it too is bound by arithmetic, on the fp64 CUDA cores (34 TFLOP/s
// peak), not by the read (kernels/bounds.py counts both). This first version is plain shared-memory tiling; a
// wgmma or FFT spectrum and fusing both passes into one read are later
// work.

#include "stats.cuh"

namespace {

constexpr int WIN = 512;            // mono samples per frame
constexpr int NCOL = 512;           // re | im of bins 0..255
constexpr int PM = 64;              // frames per power tile
constexpr int PN = 64;              // DFT columns per power tile
constexpr int PK = 16;              // frame samples per shared-memory stage
constexpr int PTHREADS = 256;       // 16 x 16 threads, 4 x 4 outputs each

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
  return launch_stats<true, true, true, double>(
      x, B, L, alpha, beta, halo0, cheb, ncheb, halfwidth, fir, warm, nb,
      taps, wsum, rownz, stats, stream);
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
  int rc = launch_stats<true, true, true, double>(
      x, B, L, alpha, beta, halo0, cheb, ncheb, halfwidth, fir, warm, nb,
      taps, wsum, rownz, stats, stream);
  if (rc == 0)
    rc = launch_power(x, B, L, n_frames, nullptr, dft, part, ntiles, stream);
  return rc;
}

}  // extern "C"
