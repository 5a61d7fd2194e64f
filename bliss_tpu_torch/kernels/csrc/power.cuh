// The spectrum kernel of csrc/fused_all.cu (K3, and K1's second launch): per
// song, the Hann-windowed 512-point power spectrum of the C-truncated mono
// downmix, bins 0..255, summed over the frames that count.
//
// power_kernel, grid (tiles of PTILE frames, songs), PWARPS warps a block.
// Each warp walks its tile's frames warp, warp + PWARPS, ... on its own:
//  * its lane 0 keeps PSTAGES frames in flight, each one 2048-byte
//    cp.async.bulk (TMA's 1-D copy) into the warp's ring in shared memory
//    that completes on the stage's mbarrier. A stage is refilled as soon as
//    the warp has read it into registers, so the next frames' copies run
//    under this frame's FFT, and each frame is read once;
//  * lane l reads 16 bytes a row (mono samples 128 m + 4 l + t, m, t =
//    0..3), forms mono = (l + r) / 2 in integers (C truncation) times the
//    window and packs z[n] = y[2n] + i y[2n+1], n = 64 m + 2 l + t / 2;
//  * a 256-point FFT of z in registers, 256 = 4 * 8 * 8: radix 4 over m with
//    twiddles W_256^(n1 k2) (n1 = 2 l + e); through the warp's exchange
//    buffer to lane 8 k2 + p1 holding n1 = p1 + 8 p2; radix 8 over p2 with
//    twiddles W_64^(p1 q2); through the buffer to lane 4 q2 + k2 holding p1 =
//    0..7; radix 8 over p1, which leaves Z[l + 32 q] in value q;
//  * the real-FFT split step X_k = (Z_k + conj Z_(256-k)) / 2 - i W^k (Z_k -
//    conj Z_(256-k)) / 2, Z_(256-k) from lane (32 - l) % 32 by a shuffle
//    (lane 0 holds its own), W = exp(-2 pi i / 512); bin 0 comes out as
//    Re Z_0 + Im Z_0. Each lane adds |2 X_k|^2 of its bins k = l + 32 q to
//    registers.
// The block then sums its warps' bins in a fixed order and writes one row of
// 256 partial sums to part [B, ntiles, 256]; the wrapper adds the rows.
// Frames that do not count are neither read nor summed; a tile wholly past
// the count writes zeros. Twiddles and the window are float32 tables built
// in float64 on the host (stft.fft_twiddles, tables.hann_window).
// stft.rfft512_power_steps is the same algorithm in PyTorch, for the tests.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WIN = 512;              // mono samples per frame
constexpr int NBIN = WIN / 2;         // bins 0..255 (the Nyquist bin is dropped)
constexpr int FRAME_BYTES = 4 * WIN;  // 512 (left, right) int16 pairs
constexpr int PWARPS = 4;             // warps a block
constexpr int PSTAGES = 3;            // frames in flight a warp
constexpr int PTILE = 128;            // frames a block
constexpr int XROW = 72;              // first exchange: 64 values + 8 of padding
constexpr int XSLOT = 9;              // second exchange: 8 values + 1 of padding

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
}
__device__ __forceinline__ float2 mul_minus_i(float2 a) {
  return make_float2(a.y, -a.x);
}

// In place: a_k = sum_n a_n W_4^(nk), W_4 = -i.
__device__ __forceinline__ void dft4(float2& a0, float2& a1, float2& a2,
                                     float2& a3) {
  const float2 t0 = cadd(a0, a2), t1 = csub(a0, a2), t2 = cadd(a1, a3),
               t3 = mul_minus_i(csub(a1, a3));
  a0 = cadd(t0, t2);
  a1 = cadd(t1, t3);
  a2 = csub(t0, t2);
  a3 = csub(t1, t3);
}

// In place: v_k = sum_n v_n W_8^(nk): 4-point DFTs of the even and the odd
// points, then one radix-2 step.
__device__ __forceinline__ void dft8(float2 (&v)[8]) {
  dft4(v[0], v[2], v[4], v[6]);
  dft4(v[1], v[3], v[5], v[7]);
  const float r = 0.70710678118654752f;  // W_8 = (1 - i) r
  const float2 e0 = v[0], e1 = v[2], e2 = v[4], e3 = v[6], o0 = v[1];
  const float2 o1 = make_float2(r * (v[3].x + v[3].y), r * (v[3].y - v[3].x));
  const float2 o2 = mul_minus_i(v[5]);
  const float2 o3 = make_float2(r * (v[7].y - v[7].x), -r * (v[7].x + v[7].y));
  v[0] = cadd(e0, o0);
  v[1] = cadd(e1, o1);
  v[2] = cadd(e2, o2);
  v[3] = cadd(e3, o3);
  v[4] = csub(e0, o0);
  v[5] = csub(e1, o1);
  v[6] = csub(e2, o2);
  v[7] = csub(e3, o3);
}

// (left + right) / 2 in integers, C truncation, of one little-endian
// (left, right) int16 pair
__device__ __forceinline__ int mono(int pair) {
  return ((int)(int16_t)(pair & 0xffff) + (pair >> 16)) / 2;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread: the next phase of bar completes when one frame has been
// copied from src to dst.
__device__ __forceinline__ void load_frame(void* dst, const void* src,
                                           uint64_t* bar) {
  // the warp's reads of dst (ordered by the caller's __syncwarp) before the
  // copy's writes
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(FRAME_BYTES) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_u32(dst)), "l"(src), "r"(FRAME_BYTES), "r"(smem_u32(bar))
      : "memory");
}

// Waits for the phase of bar with this parity to complete. Traps, and so
// fails the launch, rather than hang the card if a copy never lands.
__device__ __forceinline__ void wait_frame(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (done) return;
    if (polls == (1u << 22)) __trap();
  }
}

__global__ void __launch_bounds__(32 * PWARPS) power_kernel(
    const int16_t* __restrict__ x, int L, const int* __restrict__ n_frames,
    const int* __restrict__ frame_offset, const float2* __restrict__ twiddle,
    const float* __restrict__ hann, float* __restrict__ part, int ntiles) {
  __shared__ __align__(128) int4 ring[PWARPS][PSTAGES][FRAME_BYTES / 16];
  __shared__ __align__(16) float2 xch[PWARPS][4 * XROW];  // >= 32 * XSLOT
  __shared__ float red[PWARPS][NBIN];
  __shared__ __align__(8) uint64_t bar[PWARPS][PSTAGES];

  const int tile = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // local frames that count: clamp(n_frames - offset, 0, L/1024), in 64
  // bits so that no offset wraps the count
  const long long cap = L / (2 * WIN);
  const long long left =
      (long long)n_frames[b] - (frame_offset ? frame_offset[b] : 0);
  const int nf = (int)(left < 0 ? 0 : (left > cap ? cap : left));
  const int f0 = tile * PTILE;
  float* out = part + ((size_t)b * ntiles + tile) * NBIN;
  if (f0 >= nf) {
    for (int k = threadIdx.x; k < NBIN; k += blockDim.x) out[k] = 0.f;
    return;
  }
  // this warp's frames: f0 + warp + i * PWARPS, i < cnt
  const int here = min(PTILE, nf - f0);
  const int cnt = here > warp ? (here - warp + PWARPS - 1) / PWARPS : 0;
  const char* src = reinterpret_cast<const char*>(x + (size_t)b * L) +
                    (size_t)(f0 + warp) * FRAME_BYTES;
  const size_t step = (size_t)PWARPS * FRAME_BYTES;
  uint64_t* bars = bar[warp];
  if (lane == 0) {
    for (int s = 0; s < PSTAGES; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(smem_u32(&bars[s])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int s = 0; s < PSTAGES && s < cnt; ++s)
      load_frame(ring[warp][s], src + s * step, &bars[s]);
  }
  __syncwarp();

  // the lane's constants: window values, radix-4 and radix-8 twiddles and
  // the split step's W^k
  const int k2 = lane / 8, p1 = lane % 8;
  float win[4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int t = 0; t < 4; ++t) win[m][t] = __ldg(hann + 128 * m + 4 * lane + t);
  float2 w1[2][3], w2[7], w3[8];
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int k = 1; k < 4; ++k) w1[e][k - 1] = twiddle[2 * (2 * lane + e) * k];
#pragma unroll
  for (int q = 1; q < 8; ++q) w2[q - 1] = twiddle[8 * p1 * q];
#pragma unroll
  for (int q = 0; q < 8; ++q) w3[q] = twiddle[lane + 32 * q];
  float acc[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) acc[q] = 0.f;

  float2* xw = xch[warp];
  const int mate = (32 - lane) & 31;
  for (int i = 0; i < cnt; ++i) {
    const int s = i % PSTAGES;
    wait_frame(&bars[s], (uint32_t)(i / PSTAGES) & 1u);
    int4 raw[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) raw[m] = ring[warp][s][32 * m + lane];
    __syncwarp();
    if (lane == 0 && i + PSTAGES < cnt)
      load_frame(ring[warp][s], src + (i + PSTAGES) * step, &bars[s]);

    // a[e][m] = z[64 m + 2 lane + e]
    float2 a[2][4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int pair[4] = {raw[m].x, raw[m].y, raw[m].z, raw[m].w};
      float y[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) y[t] = (float)mono(pair[t]) * win[m][t];
      a[0][m] = make_float2(y[0], y[1]);
      a[1][m] = make_float2(y[2], y[3]);
    }
    // radix 4 over m, twiddles W_256^(n1 k2), then row k2 of the exchange
    // holds n1 = 0..63
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      dft4(a[e][0], a[e][1], a[e][2], a[e][3]);
#pragma unroll
      for (int k = 1; k < 4; ++k) a[e][k] = cmul(a[e][k], w1[e][k - 1]);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      *reinterpret_cast<float4*>(xw + k * XROW + 2 * lane) =
          make_float4(a[0][k].x, a[0][k].y, a[1][k].x, a[1][k].y);
    __syncwarp();
    // lane 8 k2 + p1: n1 = p1 + 8 p2; radix 8 over p2, twiddles W_64^(p1 q2)
    float2 v[8];
#pragma unroll
    for (int p2 = 0; p2 < 8; ++p2) v[p2] = xw[k2 * XROW + p1 + 8 * p2];
    __syncwarp();
    dft8(v);
#pragma unroll
    for (int q = 1; q < 8; ++q) v[q] = cmul(v[q], w2[q - 1]);
    // lane 4 q2 + k2 takes p1 = 0..7; radix 8 over p1 leaves Z[lane + 32 q]
#pragma unroll
    for (int q = 0; q < 8; ++q) xw[(4 * q + k2) * XSLOT + p1] = v[q];
    __syncwarp();
#pragma unroll
    for (int p = 0; p < 8; ++p) v[p] = xw[lane * XSLOT + p];
    __syncwarp();  // the next frame's first exchange rewrites xw
    dft8(v);
    // split step: 2 X_k = (Z_k + conj Zm) - i W^k (Z_k - conj Zm), Zm =
    // Z_(256-k) = value 7 - q of lane (32 - lane) % 32; lane 0: its own
    // value (8 - q) % 8
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      float2 zm;
      zm.x = __shfl_sync(0xffffffffu, v[7 - q].x, mate);
      zm.y = __shfl_sync(0xffffffffu, v[7 - q].y, mate);
      if (lane == 0) zm = v[(8 - q) & 7];
      const float2 sum = make_float2(v[q].x + zm.x, v[q].y - zm.y);
      const float2 wd = cmul(make_float2(v[q].x - zm.x, v[q].y + zm.y), w3[q]);
      const float re = sum.x + wd.y, im = sum.y - wd.x;
      acc[q] = fmaf(re, re, fmaf(im, im, acc[q]));
    }
  }

#pragma unroll
  for (int q = 0; q < 8; ++q) red[warp][lane + 32 * q] = 0.25f * acc[q];
  __syncthreads();
  for (int k = threadIdx.x; k < NBIN; k += blockDim.x) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < PWARPS; ++w) s += red[w][k];
    out[k] = s;
  }
}

int launch_power(const void* x, int B, int L, const void* n_frames,
                 const void* frame_offset, const void* twiddle,
                 const void* hann, void* part, int ntiles, void* stream) {
  const int nframes = L / (2 * WIN);
  if (B < 1 || B > 65535 || L % (2 * WIN) || nframes < 1 ||
      ntiles != (nframes + PTILE - 1) / PTILE ||
      reinterpret_cast<uintptr_t>(x) % 16)
    return (int)cudaErrorInvalidValue;
  power_kernel<<<dim3(ntiles, B), 32 * PWARPS, 0, (cudaStream_t)stream>>>(
      (const int16_t*)x, L, (const int*)n_frames, (const int*)frame_offset,
      (const float2*)twiddle, (const float*)hann, (float*)part, ntiles);
  return (int)cudaGetLastError();
}

}  // namespace
