// Eddington's Abel sums for the DFs, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's _abel_g_exact
// (cluster_generator_tpu/virial.py) is plain jnp, which XLA fuses.  In
// PyTorch the same function is a chain of about 36 elementwise passes over
// (entries, rows, N) float64 temporaries (two clamped square roots, A, k0,
// k2, two polynomials, their difference) and a sum over the last axis.  At
// an ensemble batch of 256 clusters on 512 knots each pass is 0.54 GB, and
// the chain streams ~100 GB through device memory a batch (DM and stars).
// This kernel computes each g(E_i) in registers and keeps nothing of size
// rows x N in device memory.  For row i of entry h, on the spline of the
// density (knots x_k, coefficients b, c, d of interval k, k = 0..N-2):
//
//     g(E_i) = sum_k [G_k(u_lo) - G_k(u_hi)],   k = 0..N-1,
//     G_k(u) = 2u (k0 + u^2 (k2/3 + u^2 k4/5)),
//     k0 = b + 2cA + 3dA^2,  k2 = -(2c + 6dA),  k4 = 3d,  A = E_i - xk,
//     u = sqrt(E_i - min(v, E_i)) clamped at 0, v = lo_k or hi_k,
//
// interval k >= 1 covering [x_{k-1}, x_k) with the coefficients of spline
// interval k - 1 about xk = x_{k-1}; interval 0 covering [0, x_0) with
// spline interval 0's polynomial extrapolated (xk = x_0).
//
// Bound.  Interval k adds nothing to row i once lo_k >= E_i (both u are
// 0), so a row of the ascending knots needs about N/2 terms; each term is
// one float64 square root and 26 float64 adds and multiplies.  At 256
// clusters x 512 knots, DM and stars, that is 2 x 256 x 512 x 513 / 2 =
// 67 M terms, ~2.2 GFLOP with the root as 6 operations: ~65 us at the
// card's 34 TFLOP/s float64 rate, while the inputs and g are ~5 MB
// (~1.6 us at 3.35 TB/s).  So it is bound by its float64 operations.
//
// Design.
//  * Each thread takes a pair of rows, i and rows - 1 - i, so that the two
//    triangles of the sum balance (about N + 1 terms a pair on the
//    ascending grid), and S lanes (1 to 32, a power of two, neighbouring
//    threads of one warp) share the pair's intervals.  A block is 256
//    threads, 256 / S pairs of one entry.  S adapts to the launch's shape
//    (the wrapper picks it from entries x pairs): few lanes at an ensemble
//    batch, which fills the card with pairs, 32 at one halo or two.
//  * The entry's knots and coefficients go to shared memory a group of 512
//    intervals at a time (2c, 3d, 6d and 3d/5 made once an interval), so any
//    N works.  A group is 32 pieces of 16 intervals; lane s takes the
//    pieces q = s, s + S, ..., so the lanes of a row stay within one piece
//    of each other whatever the row's length.  The slots are padded by one
//    every 16, so 32 lanes reading 32 pieces' starts hit distinct banks.
//  * Within a piece u_hi of interval k is u_lo of interval k + 1: 17 roots
//    a piece of 16 terms, not 32.  A row's loop ends at the first interval
//    whose lower end is >= E_i (a binary search over the knots); the block
//    reads the groups up to its rows' last such interval.
//  * A fixed summation order, whatever S, the tiling or the batch: each
//    piece is summed in order of k; the 32 pieces of a group by a fixed
//    binary tree (pieces q and q ^ 16 first, then ^ 8, ^ 4, ^ 2, ^ 1: a
//    lane combines its own pieces, taken in bit-reversed order, pairwise,
//    then the lanes butterfly by __shfl_xor_sync over the low bits); the
//    groups in order.  No atomics.  So a halo's g has the same bits in any
//    batch, in two launches and in a graph's replay.
//  * Every term is the plain version's (ops/abel.py), operation for
//    operation in float64: the _rn intrinsics keep each add, subtract,
//    multiply and the square root IEEE-rounded and stop any multiply-add
//    contraction; k2/3 and k4/5 are products with the rounded reciprocals
//    1/3 and 1/5, as PyTorch's CUDA division by a Python number computes
//    them.  Only the summation order differs from the plain version's
//    torch.sum.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPiece = 16;                 // intervals a piece, summed in order
constexpr int kPieces = 32;                // pieces a group, summed by a tree
constexpr int kGroup = kPiece * kPieces;   // intervals in shared memory at once
constexpr int kSlots = kGroup + kPieces;   // one pad slot per piece
constexpr double kThird = 1.0 / 3.0;
constexpr double kFifth = 1.0 / 5.0;

// the shared-memory slot of interval i of the group
__device__ __forceinline__ int slot(int i) { return i + (i >> 4); }

struct Group {
  double xk[kSlots];   // the expansion point of interval k
  double hi[kSlots];   // its upper end, x_k
  double b[kSlots];
  double c2[kSlots];   // 2c
  double d3[kSlots];   // 3d (= k4)
  double d6[kSlots];   // 6d
  double k45[kSlots];  // 3d / 5
};

// sqrt(e - min(v, e)) where positive, else 0 (the plain version's clamp:
// v >= e, or a NaN, gives 0)
__device__ __forceinline__ double root(double e, double v) {
  return v < e ? __dsqrt_rn(__dsub_rn(e, v)) : 0.0;
}

__device__ __forceinline__ double antiderivative(double u, double k0,
                                                 double k23, double k45) {
  const double u2 = __dmul_rn(u, u);
  return __dmul_rn(__dmul_rn(2.0, u),
                   __dadd_rn(k0, __dmul_rn(u2, __dadd_rn(
                                                   k23, __dmul_rn(u2, k45)))));
}

// interval k's term of the row at energy e; u_lo in, u_hi out as u_lo
__device__ __forceinline__ double term(const Group& g, int at, double e,
                                       double& u_lo) {
  const double a = __dsub_rn(e, g.xk[at]);
  const double k0 = __dadd_rn(__dadd_rn(g.b[at], __dmul_rn(g.c2[at], a)),
                              __dmul_rn(__dmul_rn(g.d3[at], a), a));
  const double k23 =
      __dmul_rn(-__dadd_rn(g.c2[at], __dmul_rn(g.d6[at], a)), kThird);
  const double u_hi = root(e, g.hi[at]);
  const double t = __dsub_rn(antiderivative(u_lo, k0, k23, g.k45[at]),
                             antiderivative(u_hi, k0, k23, g.k45[at]));
  u_lo = u_hi;
  return t;
}

// The intervals a row needs: the first k whose lower end (0 for k = 0,
// else x_{k-1}) is >= e, or n; x ascending.  A NaN e needs all n.
__device__ int row_span(const double* x, int n, double e) {
  if (0.0 >= e) return 0;
  int lo = 1, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (x[mid - 1] >= e) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

template <int LOG_S>
__global__ void __launch_bounds__(kThreads)
abel_g_rows_kernel(const double* __restrict__ x, const double* __restrict__ b,
                   const double* __restrict__ c, const double* __restrict__ d,
                   const double* __restrict__ ee, double* __restrict__ out,
                   int n, int rows, int tiles) {
  constexpr int S = 1 << LOG_S;        // lanes of a pair
  constexpr int LOG_L = 5 - LOG_S;     // log2 of a lane's pieces a group
  constexpr int L = 1 << LOG_L;
  __shared__ Group sm;
  __shared__ int warp_span[kThreads / 32];

  const int entry = blockIdx.x / tiles;
  const int pair = (blockIdx.x - entry * tiles) * (kThreads / S)
                   + (threadIdx.x >> LOG_S);
  const int lane = threadIdx.x & (S - 1);
  const int row_lo = pair;
  const int row_hi = rows - 1 - pair;  // row_lo for the middle row
  const bool live = row_lo <= row_hi;
  const double* xe = x + static_cast<long long>(entry) * n;
  const long long coef0 = static_cast<long long>(entry) * (n - 1);
  const double* ee_h = ee + static_cast<long long>(entry) * rows;

  double e_lo = 0.0, e_hi = 0.0;
  int span_lo = 0, span_hi = 0;
  if (live) {
    e_lo = ee_h[row_lo];
    span_lo = row_span(xe, n, e_lo);
    if (row_hi != row_lo) {
      e_hi = ee_h[row_hi];
      span_hi = row_span(xe, n, e_hi);
    }
  }
  int span = max(span_lo, span_hi);
  for (int o = 16; o > 0; o >>= 1) {
    span = max(span, __shfl_xor_sync(0xffffffffu, span, o));
  }
  if ((threadIdx.x & 31) == 0) warp_span[threadIdx.x >> 5] = span;
  __syncthreads();
  for (int w = 0; w < kThreads / 32; ++w) span = max(span, warp_span[w]);
  const int groups = (span + kGroup - 1) / kGroup;

  double tot_lo = 0.0, tot_hi = 0.0;
  for (int grp = 0; grp < groups; ++grp) {
    const int base = grp * kGroup;
    if (grp > 0) __syncthreads();  // the last group's reads are done
    for (int i = threadIdx.x; i < kGroup && base + i < n; i += kThreads) {
      const int k = base + i;
      const int ci = k > 0 ? k - 1 : 0;  // the spline interval of k
      const double dk = d[coef0 + ci];
      const double d3 = __dmul_rn(3.0, dk);
      const int at = slot(i);
      sm.xk[at] = xe[ci];
      sm.hi[at] = xe[k];
      sm.b[at] = b[coef0 + ci];
      sm.c2[at] = __dmul_rn(2.0, c[coef0 + ci]);
      sm.d3[at] = d3;
      sm.d6[at] = __dmul_rn(6.0, dk);
      sm.k45[at] = __dmul_rn(d3, kFifth);
    }
    __syncthreads();

    // this lane's pieces q = lane + S j, j in bit-reversed order, combined
    // pairwise: the top bit of q first
    double st_lo[LOG_L > 0 ? LOG_L : 1], st_hi[LOG_L > 0 ? LOG_L : 1];
    double v_lo = 0.0, v_hi = 0.0;
#pragma unroll 1
    for (int jp = 0; jp < L; ++jp) {
      int j = 0;
      if constexpr (LOG_L > 0) j = static_cast<int>(__brev(jp) >> (32 - LOG_L));
      const int i0 = (lane + (j << LOG_S)) * kPiece;
      const int k0 = base + i0;
      const int n_lo = min(kPiece, span_lo - k0);
      const int n_hi = min(kPiece, span_hi - k0);
      double s_lo = 0.0, s_hi = 0.0;
      const int cnt = max(n_lo, n_hi);
      if (cnt > 0) {
        const double lo = k0 == 0 ? 0.0 : sm.xk[slot(i0)];
        double u_lo = root(e_lo, lo), u_hi = root(e_hi, lo);
        for (int t = 0; t < cnt; ++t) {
          const int at = slot(i0 + t);
          if (t < n_lo) s_lo = __dadd_rn(s_lo, term(sm, at, e_lo, u_lo));
          if (t < n_hi) s_hi = __dadd_rn(s_hi, term(sm, at, e_hi, u_hi));
        }
      }
#pragma unroll
      for (int l = 0; l < LOG_L; ++l) {
        if (((jp >> l) & 1) == 0) {
          st_lo[l] = s_lo;
          st_hi[l] = s_hi;
          break;
        }
        s_lo = __dadd_rn(st_lo[l], s_lo);
        s_hi = __dadd_rn(st_hi[l], s_hi);
      }
      v_lo = s_lo;  // the lane's whole tree after its last piece
      v_hi = s_hi;
    }
#pragma unroll
    for (int o = S / 2; o > 0; o >>= 1) {
      v_lo = __dadd_rn(v_lo, __shfl_xor_sync(0xffffffffu, v_lo, o));
      v_hi = __dadd_rn(v_hi, __shfl_xor_sync(0xffffffffu, v_hi, o));
    }
    tot_lo = __dadd_rn(tot_lo, v_lo);
    tot_hi = __dadd_rn(tot_hi, v_hi);
  }
  if (live && lane == 0) {
    out[static_cast<long long>(entry) * rows + row_lo] = tot_lo;
    if (row_hi != row_lo) {
      out[static_cast<long long>(entry) * rows + row_hi] = tot_hi;
    }
  }
}

template <int LOG_S>
cudaError_t launch_lanes(const double* x, const double* b, const double* c,
                         const double* d, const double* ee, double* out,
                         int entries, int n, int rows, cudaStream_t stream) {
  const int pairs = (rows + 1) / 2;
  const int per_block = kThreads >> LOG_S;
  const int tiles = (pairs + per_block - 1) / per_block;
  const long long blocks = static_cast<long long>(tiles) * entries;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  abel_g_rows_kernel<LOG_S><<<static_cast<int>(blocks), kThreads, 0, stream>>>(
      x, b, c, d, ee, out, n, rows, tiles);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` of the current device; returns the cudaError_t of
// the launch (0 = success).  `entries` entries, each n knots x (n - 1
// coefficients each of b, c, d) and `rows` row energies ee; out (entries,
// rows); 2^log_s lanes a row pair, log_s in [0, 5].
extern "C" int cg_abel_g_rows(const double* x, const double* b,
                              const double* c, const double* d,
                              const double* ee, double* out, int entries,
                              int n, int rows, int log_s, void* stream) {
  if (entries == 0 || rows == 0) return 0;
  if (entries < 0 || rows < 0 || n < 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (log_s) {
    case 0: err = launch_lanes<0>(x, b, c, d, ee, out, entries, n, rows, st); break;
    case 1: err = launch_lanes<1>(x, b, c, d, ee, out, entries, n, rows, st); break;
    case 2: err = launch_lanes<2>(x, b, c, d, ee, out, entries, n, rows, st); break;
    case 3: err = launch_lanes<3>(x, b, c, d, ee, out, entries, n, rows, st); break;
    case 4: err = launch_lanes<4>(x, b, c, d, ee, out, entries, n, rows, st); break;
    case 5: err = launch_lanes<5>(x, b, c, d, ee, out, entries, n, rows, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
