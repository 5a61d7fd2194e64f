// Sample statistics and summed power spectrum of an int16 PCM batch,
// hand-written for Hopper (sm_90a), bound through a plain C interface.
//
// Replaces three TPU kernels with two CUDA kernels and three entry points,
// and runs the prepass that feeds them (a fourth entry point):
//
//   K1 bliss_tpu/kernels/fused_all.py:52 _kernel (fused_all_call)
//      -> bliss_fused_all: stats_kernel, then power_kernel;
//   K2 bliss_tpu/kernels/fused_stats.py:71 _kernel (fused_stats_call)
//      -> bliss_fused_stats: stats_kernel;
//   K3 bliss_tpu/kernels/pallas_stft.py:75 _kernel (stft_power)
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
//    Its ~42 fp64 FLOP a sample bound it on the fp64 CUDA cores (34 TFLOP/s
//    peak), not on its 2-byte read (kernels/bounds.py). One warp takes a
//    hop block at a time, 8 samples a lane read as one 16-byte word, and
//    walks runs of consecutive blocks (a persistent grid) with the FIR's
//    history carried in a warp-private ring; the FIR runs in registers on a
//    sliding window, the sums through a warp-private transpose and
//    shuffles, and no block barrier sits in its loop.
//  * prepass_kernel (csrc/prepass.cuh): the exact int64 sums of s and s^2
//    over each song's valid samples, from which the wrappers form the C
//    reference's integer mean and variance; one read of the PCM in 16-byte
//    words, so the bytes bound it.
//  * power_kernel (csrc/power.cuh): the Hann-windowed power spectrum of
//    mono = c_div(l + r, 2), bins 0..255, summed over the frames that count
//    (local frame f counts while offset + f < n_frames, offset the song's
//    frame_offset, a sequence shard's first global frame; 0 when none is
//    passed). A 512-point real FFT a frame is ~12 kFLOP against the frame's
//    2048 bytes, so the function is bound by one read of its frames (0.281
//    ms at B=64, L=2^23 over 3.35 TB/s; its FFTs take ~0.1 ms at the fp32
//    peak). It replaces a dense product with the [512, 512] Hann-folded DFT
//    table, which did ~37x that arithmetic, read every frame once per 64
//    table columns and read the table too. Now each warp streams its frames
//    through a ring of 2048-byte bulk copies (cp.async.bulk on mbarriers),
//    so each frame is read once and the next copies run under the current
//    FFT, and does the FFT as a 256-point complex FFT in registers (radix 4,
//    8, 8, two exchanges through shared memory) plus the real-FFT split
//    step. Each block writes one row of 256 partial sums, which the wrapper
//    adds in a fixed order.

#include "prepass.cuh"
#include "stats.cuh"
#include "power.cuh"

extern "C" {

// Frames per power_kernel block: the wrappers size the scratch
// [B, tiles, 256].
int bliss_power_tile() { return PTILE; }

// Arguments shared by the entry points. x: int16 [B, L]; alpha, beta:
// float [B]; halo0: int16 [B, taps-1] or NULL; cheb: float [ncheb]; fir:
// double [nb, taps]; warm: double [nb, taps-1, taps-1]; wsum, rownz: float
// [B, L/256]; stats: double [B, nb, 9, L/256], rows (tail, head, reset) x
// (sum v, sum v^2, sum (-1)^t v); n_frames: int [B]; frame_offset: int [B]
// or NULL; twiddle: float [512, 2], W^k = exp(-2 pi i k / 512) as (re, im);
// hann: float [512]; part: float [B, ntiles, 256] with ntiles =
// ceil((L/1024) / bliss_power_tile()). x 16-byte aligned. Each returns the
// launch's cudaError_t.

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
                     const void* frame_offset, const void* twiddle,
                     const void* hann, void* part, int ntiles, void* stream) {
  return launch_power(x, B, L, n_frames, frame_offset, twiddle, hann, part,
                      ntiles, stream);
}

// K1: both, with the whole song's frames (no frame offset). L a multiple
// of 1024.
int bliss_fused_all(const void* x, int B, int L, const void* alpha,
                    const void* beta, const void* halo0, const void* cheb,
                    int ncheb, float halfwidth, const void* fir,
                    const void* warm, int nb, int taps, void* wsum,
                    void* rownz, void* stats, const void* n_frames,
                    const void* twiddle, const void* hann, void* part,
                    int ntiles, void* stream) {
  int rc = launch_stats<true, true, true, double>(
      x, B, L, alpha, beta, halo0, cheb, ncheb, halfwidth, fir, warm, nb,
      taps, wsum, rownz, stats, stream);
  if (rc == 0)
    rc = launch_power(x, B, L, n_frames, nullptr, twiddle, hann, part, ntiles,
                      stream);
  return rc;
}

// The prepass: exact int64 sums of s and s^2 over each song's first
// n_samples[b] samples. x int16 [B, L], 16-byte aligned, L a multiple of 8;
// n_samples: int [B]; part: int64 [B, chunks, 2], rows (sum s, sum s^2).
int bliss_prepass(const void* x, int B, int L, const void* n_samples,
                  void* part, int chunks, void* stream) {
  return launch_prepass(x, B, L, n_samples, part, chunks, stream);
}

}  // extern "C"
