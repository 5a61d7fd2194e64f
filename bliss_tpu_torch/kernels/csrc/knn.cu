// Every library row's k nearest other rows, in one pass over the rows, with
// nothing of size [queries, N] in device memory: bliss_knn_prep and
// bliss_knn_search behind bliss_tpu_torch/kernels/knn.py::knn_topk.
//
// What it replaces. The JAX package's sim/distance.py::_block_topk: a
// float64 matmul of a query block against every row, then jax.lax.top_k,
// both left to XLA; there is no Pallas counterpart. The port's plain
// version, sim/distance.py::_block_topk, stays the CPU route: per block of
// queries it writes the [block, N] float64 Gram matrix, then makes some ten
// passes over it (d^2, its float32 rounding, int64 keys, a radix select).
//
// The function, exactly as the plain version computes it. For query row q
// and row f (columns j = 0..N-1): g = q.f in float64 (the float32 rows
// widened exactly); d^2 = (-2 g + |q|^2) + |f|^2, each step rounded in
// float64; d^2 < 0 is set to 0 (a NaN stays NaN); d^2 is rounded to
// float32; the query's own column is +inf. The key is the float32's bits
// as a sign-extended int32, shifted up 32 bits, or'd with j; a query keeps
// its k smallest keys, ascending, and returns sqrt of each key's float32
// and its j. Equal d^2 so come out in index order, as jax.lax.top_k has
// them.
//
// Where a NaN sorts. A NaN d^2 orders by the sign bit of its float32, as
// the plain version's keys do: a negative NaN's key is below every
// number's, so it comes first; a positive NaN's is above +inf's, so it comes
// last, in index order among NaNs. On the card, as on an x86 CPU, the NaN
// that inf - inf makes has its sign bit set, and a NaN in the rows keeps its
// sign through the products and the rounding. So a row holding +inf, whose
// d^2 to most rows is inf - inf, is most queries' first neighbour, and a row
// holding a positive NaN comes after every number. On an H100 the kernel
// gave the CPU's indices for an inf, a NaN, a -inf and a negative NaN in one
// row (tests/test_torch_cuda.py).
//
// What bounds it on an H100 SXM. The products: 2 N^2 D float64 operations
// (D = 49, N = 100 000: 9.8e11, 14.6 ms at the fp64 tensor cores' 67
// TFLOP/s). The bytes are negligible: the rows once (19.6 MB) and the
// answers (N k 8 bytes). Beside the products each pair costs its d^2 (an
// FMA and an add in float64) and one compare: 3e10 float64 instructions at
// N = 100 000, 1.8 ms at the CUDA cores' 64 a clock an SM (1.98 GHz); at
// D = 4 that, not the products (1.2 ms), is the larger part.
//
// What the design does about it.
// - One block of 4 warps holds a tile of 64 (D > 32) or 128 query rows.
//   Their rows sit in registers as the A fragments of mma.sync m16n8k16 /
//   m16n8k8 / m16n8k4 f64 for the whole call: D is padded with zeros to a
//   multiple of 4 (exact zeros change no sum), and the k-steps follow D as
//   a template (KQ = D / 4 steps of 4, D <= 64; 16 at a time while they
//   last).
// - The block walks every row in tiles of 128 (D <= 16) or 64,
//   double-buffered in shared memory: each thread loads its share of the
//   next tile (16-byte loads of the padded float32 rows, which stay in L2)
//   while the block multiplies the current one, and widens it to float64
//   as it lands.
// - Each accumulator element's d^2 is formed in registers and compared
//   with one float64 threshold a (query row, lane): the midpoint between
//   the k-th float32 d^2 of the lane's list and the next float32 above it,
//   so that a d^2 above it rounds above the k-th and cannot enter. After
//   each tile the 4 lanes that share a row take the lowest of their
//   thresholds. Only the rare survivor (about 140 a query row at N = 100
//   000, k = 5) takes the exact path: the clamp, the float32 rounding, the
//   own-column test, the int64 key, and an insertion into the lane's
//   sorted list of k keys in shared memory. A lane takes its survivors one
//   a turn, all lanes at once.
// - At the end the 4 lanes that share a row merge their lists; one thread
//   a row writes the k distances and indices.
// - |f|^2 comes from a pre-pass (bliss_knn_prep) that also pads the rows,
//   once a call; |q|^2 is the same array.
// Every pair is computed: the symmetric half is not used. On an H100
// (700 W) at N = 100 000, k = 5: 25.9 ms at D = 49 (the products at 40
// TFLOP/s on the padded 52 columns), 5.9 ms at D = 4, where the per-pair
// d^2 and compare take most of it.
//
// A query's answer depends only on its row and the library: every element
// goes through the same k-steps in the same order wherever its row sits in
// a tile, so the rows that share a launch change nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int NT = 2;     // 8-row column tiles a step of a warp
constexpr int K_MAX = 32;
constexpr int KQ_MAX = 16;  // D <= 64
constexpr int PREP_THREADS = 256;

template <int KQ>
struct Shape {
  static constexpr int MT = KQ <= 8 ? 2 : 1;       // 16-row query tiles a warp
  static constexpr int BM = WARPS * 16 * MT;       // query rows a block
  static constexpr int BN = KQ <= 4 ? 128 : 64;    // library rows a tile
  static constexpr int S = KQ % 2 ? 4 * KQ : 4 * KQ + 4;  // a tile row's stride in doubles, 4 mod 8
  static constexpr int PER = (BN * KQ + THREADS - 1) / THREADS;  // float4 a thread a tile
  static constexpr int E = MT * NT * 4;            // accumulator elements a lane a step
  static_assert(BM <= THREADS && E <= 32, "a thread a row at the merge; a bit an element");
};

// D = A B (FIRST) or D += A B, A 16x8 row-major, B 8x8 column-major, fp64.
// With g = lane / 4 and t = lane % 4, lane l holds a[i] = A[g + 8 (i &
// 1)][t + 4 (i >> 1)], b[i] = B[t + 4 i][g] and d[i] = D[g + 8 (i >>
// 1)][2 t + (i & 1)] (PTX ISA, matrix fragments for mma.m16n8k8 with .f64;
// sm_90). The first step adds a zero register, so no accumulator is zeroed.
template <bool FIRST>
__device__ __forceinline__ void mma_k8(double (&d)[4], double a0, double a1, double a2,
                                       double a3, double b0, double b1) {
  if (FIRST)
    asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
        : "=d"(d[0]), "=d"(d[1]), "=d"(d[2]), "=d"(d[3])
        : "d"(a0), "d"(a1), "d"(a2), "d"(a3), "d"(b0), "d"(b1), "d"(0.0));
  else
    asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a0), "d"(a1), "d"(a2), "d"(a3), "d"(b0), "d"(b1));
}

// The same for A 16x4, B 4x8: a[i] = A[g + 8 i][t], b = B[t][g], d as above
// (mma.m16n8k4 with .f64; sm_90).
template <bool FIRST>
__device__ __forceinline__ void mma_k4(double (&d)[4], double a0, double a1, double b0) {
  if (FIRST)
    asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
        "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%7, %7, %7, %7};\n"
        : "=d"(d[0]), "=d"(d[1]), "=d"(d[2]), "=d"(d[3])
        : "d"(a0), "d"(a1), "d"(b0), "d"(0.0));
  else
    asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
        "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a0), "d"(a1), "d"(b0));
}

// The same for A 16x16, B 16x8: a[i] = A[g + 8 (i & 1)][t + 4 (i >> 1)],
// b[i] = B[t + 4 i][g] (mma.m16n8k16 with .f64; sm_90).
template <bool FIRST>
__device__ __forceinline__ void mma_k16(double (&d)[4], const double (&a)[8], const double (&b)[4]) {
  if (FIRST)
    asm("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, "
        "{%16, %16, %16, %16};\n"
        : "=d"(d[0]), "=d"(d[1]), "=d"(d[2]), "=d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]),
          "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]), "d"(0.0));
  else
    asm("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, "
        "{%0, %1, %2, %3};\n"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]),
          "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// c = the products of the warp's query rows (af: the A fragments of KQ
// steps of 4) with the 8-row column tiles j .. j + NT - 1 of tile T, from
// step S0 on: steps of 16 while 4 remain, then of 8, then of 4.
template <int KQ, int S0, int MT, int NT>
__device__ __forceinline__ void products(double (&c)[MT][NT][4], const double (&af)[MT][KQ][2],
                                         const double* T, int stride, int j, int g, int t) {
  constexpr int W = (S0 + 4 <= KQ) ? 4 : (S0 + 2 <= KQ ? 2 : 1);
  if constexpr (S0 < KQ) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const double* col = T + ((j + nt) * 8 + g) * stride + 4 * S0 + t;
      double b[4];
#pragma unroll
      for (int i = 0; i < W; ++i) b[i] = col[4 * i];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        double a[8];
#pragma unroll
        for (int i = 0; i < 2 * W; ++i) a[i] = af[m][S0 + (i >> 1)][i & 1];
        if constexpr (W == 4) {
          mma_k16<S0 == 0>(c[m][nt], a, b);
        } else if constexpr (W == 2) {
          mma_k8<S0 == 0>(c[m][nt], a[0], a[1], a[2], a[3], b[0], b[1]);
        } else {
          mma_k4<S0 == 0>(c[m][nt], a[0], a[1], b[0]);
        }
      }
    }
    products<KQ, S0 + W, MT, NT>(c, af, T, stride, j, g, t);
  }
}

// The least float64 that rounds (to float32) above the float32 whose bits
// are hi, exclusive: the midpoint up to the next float32. For +inf, a NaN
// or a negative value, +inf: nothing is filtered.
__device__ __forceinline__ double threshold(int hi) {
  if (hi < 0 || hi >= 0x7f800000) return __longlong_as_double(0x7ff0000000000000LL);
  return 0.5 * ((double)__int_as_float(hi) + (double)__int_as_float(hi + 1));
}

// The exact path for one survivor of d^2 d at column col: its key, and its
// insertion into the lane's sorted list L of k keys (cnt of them filled);
// thr becomes the lower of itself and the threshold of L's k-th key.
__device__ __forceinline__ void offer(long long* L, int k, int& cnt, double& thr, double d,
                                      int col, int self, int n) {
  if (col >= n) return;
  d = d < 0.0 ? 0.0 : d;  // keeps a NaN, as clamp_min_ does
  const int bits = col == self ? 0x7f800000 : __float_as_int(__double2float_rn(d));
  const long long key =
      (long long)(((unsigned long long)(unsigned)bits << 32) | (unsigned)col);
  int pos;
  if (cnt < k) {
    pos = cnt++;
  } else if (key < L[k - 1]) {
    pos = k - 1;
  } else {
    return;
  }
  while (pos > 0 && L[pos - 1] > key) {
    L[pos] = L[pos - 1];
    --pos;
  }
  L[pos] = key;
  if (cnt == k) thr = fmin(thr, threshold((int)(L[k - 1] >> 32)));
}

template <int KQ>
__global__ void __launch_bounds__(THREADS) knn_kernel(
    const float* __restrict__ xp, const double* __restrict__ norms, int n, int row0, int nq,
    int k, float* __restrict__ dist, int* __restrict__ idx) {
  using Sh = Shape<KQ>;
  constexpr int MT = Sh::MT, BM = Sh::BM, BN = Sh::BN, S = Sh::S, PER = Sh::PER, E = Sh::E;
  extern __shared__ __align__(16) unsigned char smem[];
  double* tiles = reinterpret_cast<double*>(smem);                // [2][BN][S]
  double* ffs = tiles + 2 * BN * S;                                // [2][BN]
  double* thrs = ffs + 2 * BN;                                     // [BM][4]
  long long* lists = reinterpret_cast<long long*>(thrs + BM * 4);  // [BM][4][k]
  int* cnts = reinterpret_cast<int*>(lists + BM * 4 * k);         // [BM][4]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BM, slot0 = warp * 16 * MT + g;  // slot: a row of the block
  const double inf = __longlong_as_double(0x7ff0000000000000LL);

  // the warp's query rows: A fragments, |q|^2 and the lane's thresholds,
  // kept in registers; each (row, lane) list's count and threshold also in
  // shared memory for the exact path
  double af[MT][KQ][2], qq[MT][2], thr[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int slot = slot0 + m * 16 + 8 * h, r = q0 + slot;
      const bool ok = r < nq;
      const long long gr = (long long)row0 + r;
      qq[m][h] = ok ? norms[gr] : 0.0;
      thr[m][h] = inf;
      thrs[slot * 4 + t] = inf;
      cnts[slot * 4 + t] = 0;
#pragma unroll
      for (int s = 0; s < KQ; ++s) af[m][s][h] = ok ? (double)xp[gr * (4 * KQ) + 4 * s + t] : 0.0;
    }
  }

  const int ntiles = (n + BN - 1) / BN;
  float4 pre[PER];
  double pff = inf;
  auto fetch = [&](int tile) {
    const float4* src = reinterpret_cast<const float4*>(xp) + (size_t)tile * BN * KQ;
    const int total = min(BN, n - tile * BN) * KQ;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = tid + i * THREADS;
      pre[i] = e < total ? src[e] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    // a column past the last row reads +inf: its d^2 is never below a threshold
    if (tid < BN) pff = tile * BN + tid < n ? norms[(size_t)tile * BN + tid] : inf;
  };
  auto store = [&](int buf) {
    double* T = tiles + buf * BN * S;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = tid + i * THREADS;
      if (e < BN * KQ) {
        double2* dst = reinterpret_cast<double2*>(T + (e / KQ) * S + 4 * (e % KQ));
        dst[0] = make_double2(pre[i].x, pre[i].y);
        dst[1] = make_double2(pre[i].z, pre[i].w);
      }
    }
    if (tid < BN) ffs[buf * BN + tid] = pff;
  };

  fetch(0);
#pragma unroll 1
  for (int tile = 0; tile < ntiles; ++tile) {
    const int buf = tile & 1;
    store(buf);  // buf was last read two tiles ago, before the last barrier
    __syncthreads();
    if (tile + 1 < ntiles) fetch(tile + 1);
    const double* T = tiles + buf * BN * S;
    const double* F = ffs + buf * BN;
#pragma unroll 1
    for (int j = 0; j < BN / 8; j += NT) {
      double c[MT][NT][4];
      products<KQ, 0, MT, NT>(c, af, T, S, j, g, t);
      // d^2 in place of each product; a bit e = (m NT + nt) 4 + i for each
      // that may enter
      unsigned need = 0;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const double2 f2 = *reinterpret_cast<const double2*>(F + (j + nt) * 8 + 2 * t);
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const double d = __dadd_rn(__fma_rn(-2.0, c[m][nt][i], qq[m][i >> 1]), i & 1 ? f2.y : f2.x);
            c[m][nt][i] = d;
            if (!(d > thr[m][i >> 1])) need |= 1u << ((m * NT + nt) * 4 + i);
          }
      }
      if (need) {
        // the lanes take their survivors together, one a turn
        double dv[E];
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) dv[(m * NT + nt) * 4 + i] = c[m][nt][i];
        const int col0 = tile * BN + j * 8 + 2 * t;
        do {
          const int e = __ffs(need) - 1;
          need &= need - 1;
          const int slot = slot0 + (e / (NT * 4)) * 16 + 8 * ((e >> 1) & 1), at = slot * 4 + t;
          offer(lists + at * k, k, cnts[at], thrs[at], dv[e], col0 + (e >> 2) % NT * 8 + (e & 1),
                row0 + q0 + slot, n);
        } while (need);
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h) thr[m][h] = thrs[(slot0 + m * 16 + 8 * h) * 4 + t];
      }
    }
    // A lane's k keys beat whatever rounds above its threshold, so each lane
    // of a quad may filter by the lowest of the quad's thresholds.
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        thr[m][h] = fmin(thr[m][h], __shfl_xor_sync(0xffffffffu, thr[m][h], 1));
        thr[m][h] = fmin(thr[m][h], __shfl_xor_sync(0xffffffffu, thr[m][h], 2));
        thrs[(slot0 + m * 16 + 8 * h) * 4 + t] = thr[m][h];
      }
  }

  // merge the 4 lists of each row (the lanes of a quad); a thread a row
  __syncthreads();
  if (tid < BM && q0 + tid < nq) {
    const long long* L = lists + tid * 4 * k;
    const int* C = cnts + tid * 4;
    int p[4] = {0, 0, 0, 0};
    const size_t out = (size_t)(q0 + tid) * k;
    for (int j = 0; j < k; ++j) {
      long long best = 0x7fffffffffffffffLL;
      int from = 0;
#pragma unroll
      for (int l = 0; l < 4; ++l)
        if (p[l] < C[l] && L[l * k + p[l]] < best) {
          best = L[l * k + p[l]];
          from = l;
        }
      ++p[from];
      dist[out + j] = __fsqrt_rn(__int_as_float((int)(best >> 32)));
      idx[out + j] = (int)(unsigned)best;
    }
  }
}

__global__ void knn_prep_kernel(const float* __restrict__ x, int n, int d, int dp,
                                float* __restrict__ xp, double* __restrict__ norms) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const float* src = x + (size_t)r * d;
  float* dst = xp + (size_t)r * dp;
  double s = 0.0;
  for (int j = 0; j < dp; ++j) {
    const float v = j < d ? src[j] : 0.f;
    dst[j] = v;
    s = __dadd_rn(s, __dmul_rn((double)v, (double)v));
  }
  norms[r] = s;
}

template <int KQ>
size_t smem_bytes(int k) {
  using Sh = Shape<KQ>;
  return (size_t)(2 * Sh::BN * Sh::S + 2 * Sh::BN + 4 * Sh::BM) * sizeof(double) +
         (size_t)Sh::BM * 4 * k * sizeof(long long) + (size_t)Sh::BM * 4 * sizeof(int);
}

template <int KQ>
int launch_search(const float* xp, const double* norms, int n, int row0, int nq, int k,
                  float* dist, int* idx, cudaStream_t st) {
  using Sh = Shape<KQ>;
  const size_t smem = smem_bytes<KQ>(k);
  cudaError_t rc = cudaFuncSetAttribute(knn_kernel<KQ>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != cudaSuccess) return (int)rc;
  const int grid = (nq + Sh::BM - 1) / Sh::BM;
  knn_kernel<KQ><<<grid, THREADS, smem, st>>>(xp, norms, n, row0, nq, k, dist, idx);
  return (int)cudaGetLastError();
}

template <int... KQ>
struct Table {
  using Fn = int (*)(const float*, const double*, int, int, int, int, float*, int*, cudaStream_t);
  static constexpr Fn fns[] = {launch_search<KQ>...};
};

}  // namespace

extern "C" {

const char* bliss_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// x float [n, d] contiguous -> xp float [n, dp] (x, then zeros; dp a
// multiple of 4, 16-byte aligned) and norms double [n] (sum of x^2 in
// float64, in column order).
int bliss_knn_prep(const void* x, int n, int d, int dp, void* xp, void* norms, void* stream) {
  if (n < 1 || d < 1 || dp < d || dp % 4) return (int)cudaErrorInvalidValue;
  const int grid = (n + PREP_THREADS - 1) / PREP_THREADS;
  knn_prep_kernel<<<grid, PREP_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, n, d, dp, (float*)xp, (double*)norms);
  return (int)cudaGetLastError();
}

// The k nearest other rows of rows row0 .. row0 + nq - 1 of xp [n, dp]
// (bliss_knn_prep's), 1 <= k <= min(32, n - 1), 4 <= dp <= 64: dist float
// [nq, k] ascending, idx int [nq, k].
int bliss_knn_search(const void* xp, const void* norms, int n, int dp, int row0, int nq, int k,
                     void* dist, void* idx, void* stream) {
  if (dp < 4 || dp > 4 * KQ_MAX || dp % 4 || k < 1 || k > K_MAX || k >= n || nq < 1 ||
      row0 < 0 || row0 > n - nq)
    return (int)cudaErrorInvalidValue;
  using T = Table<1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16>;
  return T::fns[dp / 4 - 1]((const float*)xp, (const double*)norms, n, row0, nq, k,
                            (float*)dist, (int*)idx, (cudaStream_t)stream);
}

}  // extern "C"
