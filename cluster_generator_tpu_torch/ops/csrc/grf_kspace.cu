// The constant-rms random field's k-space stage, in place on its three half
// spectra, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's _grf_core_fused
// (cluster_generator_tpu/fields/grf.py) does this arithmetic as plain jnp,
// which XLA fuses.  In PyTorch the same stage was eager slab arithmetic
// over the three (nx, ny, nz/2 + 1) half spectra: the shaping, a power
// sum, the rms scale, a second power sum, the projection with its
// temporaries copied back, a third power sum, the rescale and, for a
// vector potential, three more complex temporaries copied back.  At 512^3
// in float64 (3.23 GB of spectra) that is about twenty reads and writes of
// every spectrum, 41-58 ms a field on an H100.  This kernel makes two
// passes and keeps every temporary in registers.
//
// The maths.  Each entry k of the noise's spectra W = (Wx, Wy, Wz) becomes
//
//     f T(sigma W),  f = g_rms N / sqrt(q),  q = sum_k wz |P(sigma W)|^2,
//
// with N = nx ny nz the cells, wz the Parseval weight of the kz plane (1
// for the self-conjugate kz = 0 and kz = nz/2 planes, else 2),
//
//     sigma = (1 + (k/k1)^2)^(alpha/4) exp(-(k/k0)^2 / 2)   (0 at k = 0),
//     P g   = g - e (e . g),  e = kd / |kd|   (0 at kd = 0),
//     T g   = i k' x P g / k^2 for a vector potential (0 at k = 0), else P g,
//
// kd = sin(k d) / d the finite-difference wavenumbers and k' the
// wavenumbers with their Nyquist entries 0 (fields/grf._odd_waves); P is
// the identity where the field is not divergence-cleaned.  This is the
// slab code's result in another order: its rms scale g_rms N / sqrt(p)
// (p the shaped power) times its projection's power-preserving rescale
// sqrt(p / q) is f.  sigma is written as exp(alpha/4 log1p(k^2/k1^2) -
// k^2/(2 k0^2)), one exp and one log1p for the slab code's pow and exp.
// Float64 fields load complex128, float32 fields complex64; either way the
// arithmetic, the power sum and the scale are float64, and the result is
// rounded to the field's type once.
//
// Bound.  q is the only dependence across the grid, so two passes: the
// first reads the spectra (3.23 GB at 512^3 float64), the second reads
// and writes them (6.47 GB), 9.70 GB or 2.90 ms at 3.35 TB/s.  The
// benchmark's yardstick counts the spectra read once and written once,
// 6.47 GB or 1.93 ms, so this design reaches at most 66.7% of it.  The
// float64 work is about 120 instructions an entry a pass (the log1p and
// the exp ~60 as libdevice writes them, the squares, the projection and
// the power ~45, the potential and the scale ~15 in the second pass):
// 67.4 M entries x 2 passes x ~120 = ~16 G, ~1.0 ms at the card's 16.7 T
// float64 instructions a second (132 SMs x 64 lanes x 1.98 GHz), under the
// bytes' time in each pass.
//
// Design.
//  * Both passes walk the spectra's flat (x, y, z) order grid-stride: 256
//    threads a block, neighbouring threads on neighbouring z, each entry's
//    three components loaded and stored 16 bytes (complex64: 8) a thread.
//    A thread finds its first (x, y, z) by division once and then steps by
//    the stride with carries.  The wavenumbers of x, y and z are read from
//    the wave vector the program already holds (kilobytes, in L1).
//  * Pass 1 writes nothing but one float64 partial sum a block: each
//    thread sums its entries in order, a warp by __shfl_down_sync, the
//    warps in order.  Its grid is the card's resident blocks (SMs x blocks
//    an SM, capped by the entries and the partials' room), so one wave.
//  * Pass 2: every block first sums all the partials in one fixed order
//    (thread t takes t, t + 256, ..., then the block as in pass 1), so
//    every block holds the same q, then recomputes sigma and P and, for a
//    vector potential, the cross product, multiplies by f and stores each
//    entry in place.
//  * No atomics, so a launch's bits are fixed by the shape and the card:
//    two replays of a program, and the eager body beside its replay, give
//    the same field.
//  * The field's type and the two switches (divergence cleaning, vector
//    potential) are template parameters, the program's own key.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// the wave vector of fields/grf._wave_vector on the device: k, kd, k' of
// the x axis, the y axis and the kept half of z, and the planes' weights
struct Grid {
  const double* k[3];
  const double* kd[3];
  const double* ko[3];
  const double* wz;
  int ny, nzh;
  long long n;  // entries of one half spectrum, nx ny nzh
};

// the float inputs: 0-d float64 tensors on the device
struct Scalars {
  const double* k0;
  const double* k1;
  const double* alpha;
  const double* g_rms;
};

// the shaping's constants, read once a thread
struct Shaping {
  double a, ik0sq, ik1sq;
};

__device__ __forceinline__ Shaping shaping(const Scalars& s) {
  const double k0 = __ldg(s.k0), k1 = __ldg(s.k1);
  return {0.25 * __ldg(s.alpha), 1.0 / (k0 * k0), 1.0 / (k1 * k1)};
}

// an entry of complex128 (double2) or complex64 (float2) spectra, its
// parts as float64: loaded, loaded through the read-only cache, stored
template <typename C>
__device__ __forceinline__ void load(const C* p, long long i, double& re,
                                     double& im) {
  const C v = p[i];
  re = v.x;
  im = v.y;
}
template <typename C>
__device__ __forceinline__ void load_ro(const C* p, long long i, double& re,
                                        double& im) {
  const C v = __ldg(p + i);
  re = v.x;
  im = v.y;
}
template <typename C>
__device__ __forceinline__ void store(C* p, long long i, double re,
                                      double im) {
  using R = decltype(C::x);
  p[i] = C{static_cast<R>(re), static_cast<R>(im)};
}

// A thread's grid-stride walk over the flat (x, y, z) order of a half
// spectrum: the flat index e and its (x, y, z), stepped with carries.
struct Walk {
  long long e, stride;
  int x, y, z, sx, sy, sz;

  __device__ Walk(const Grid& g) {
    stride = static_cast<long long>(gridDim.x) * kThreads;
    e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    const long long row = e / g.nzh, srow = stride / g.nzh;
    z = static_cast<int>(e - row * g.nzh);
    y = static_cast<int>(row % g.ny);
    x = static_cast<int>(row / g.ny);
    sz = static_cast<int>(stride - srow * g.nzh);
    sy = static_cast<int>(srow % g.ny);
    sx = static_cast<int>(srow / g.ny);
  }

  __device__ __forceinline__ void next(const Grid& g) {
    e += stride;
    z += sz;
    int carry = z >= g.nzh;
    z -= carry ? g.nzh : 0;
    y += sy + carry;
    carry = y >= g.ny;
    y -= carry ? g.ny : 0;
    x += sx + carry;
  }
};

// sigma at (x, y, z), with k^2 there, and the projection P of (re, im) in
// place where DIV
template <bool DIV>
__device__ __forceinline__ double shape_project(const Grid& g,
                                                const Shaping& sh,
                                                const Walk& w, double re[3],
                                                double im[3], double& kk2) {
  const double kx = __ldg(g.k[0] + w.x), ky = __ldg(g.k[1] + w.y),
               kz = __ldg(g.k[2] + w.z);
  kk2 = kx * kx + ky * ky + kz * kz;
  const double sigma =
      kk2 > 0.0 ? exp(sh.a * log1p(kk2 * sh.ik1sq) - 0.5 * kk2 * sh.ik0sq)
                : 0.0;
  if (DIV) {
    const double dx = __ldg(g.kd[0] + w.x), dy = __ldg(g.kd[1] + w.y),
                 dz = __ldg(g.kd[2] + w.z);
    const double d2 = dx * dx + dy * dy + dz * dz;
    const double inv = d2 > 0.0 ? rsqrt(d2) : 0.0;
    const double e[3] = {dx * inv, dy * inv, dz * inv};
    const double br = e[0] * re[0] + e[1] * re[1] + e[2] * re[2];
    const double bi = e[0] * im[0] + e[1] * im[1] + e[2] * im[2];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      re[c] -= e[c] * br;
      im[c] -= e[c] * bi;
    }
  }
  return sigma;
}

// the block's sum of each thread's v, in a fixed order; valid in thread 0
__device__ __forceinline__ double block_sum(double v, double* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  double t = 0.0;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kWarps; ++i) t += red[i];
  }
  return t;
}

// Pass 1: one partial of q = sum wz |P(sigma W)|^2 a block.
template <typename C, bool DIV>
__global__ void __launch_bounds__(kThreads)
    grf_kspace_power_kernel(const C* __restrict__ w0,
                            const C* __restrict__ w1,
                            const C* __restrict__ w2, Grid g, Scalars s,
                            double* __restrict__ partials) {
  __shared__ double red[kWarps];
  const Shaping sh = shaping(s);
  const C* w[3] = {w0, w1, w2};
  double acc = 0.0;
  for (Walk it(g); it.e < g.n; it.next(g)) {
    double re[3], im[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) load_ro(w[c], it.e, re[c], im[c]);
    double kk2;
    const double sigma = shape_project<DIV>(g, sh, it, re, im, kk2);
    const double p = re[0] * re[0] + im[0] * im[0] + re[1] * re[1] +
                     im[1] * im[1] + re[2] * re[2] + im[2] * im[2];
    acc += __ldg(g.wz + it.z) * (sigma * sigma) * p;
  }
  const double t = block_sum(acc, red);
  if (threadIdx.x == 0) partials[blockIdx.x] = t;
}

// Pass 2: f T(sigma W) in place, f from the partials of pass 1.
template <typename C, bool DIV, bool VEC>
__global__ void __launch_bounds__(kThreads)
    grf_kspace_apply_kernel(C* __restrict__ w0, C* __restrict__ w1,
                            C* __restrict__ w2, Grid g, Scalars s,
                            const double* __restrict__ partials,
                            int n_partials, double n_cells_sq) {
  __shared__ double red[kWarps];
  __shared__ double f_shared;
  double v = 0.0;
  for (int i = threadIdx.x; i < n_partials; i += kThreads) v += partials[i];
  const double q = block_sum(v, red);
  // mean_x(sum_c g_c^2) = sum_{c,k} wz |W_c|^2 / N^2
  if (threadIdx.x == 0) f_shared = __ldg(s.g_rms) / sqrt(q / n_cells_sq);
  __syncthreads();
  const double f = f_shared;
  const Shaping sh = shaping(s);
  C* w[3] = {w0, w1, w2};
  for (Walk it(g); it.e < g.n; it.next(g)) {
    double re[3], im[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) load(w[c], it.e, re[c], im[c]);
    double kk2;
    double scale = f * shape_project<DIV>(g, sh, it, re, im, kk2);
    if (VEC) {
      const double kx = __ldg(g.ko[0] + it.x), ky = __ldg(g.ko[1] + it.y),
                   kz = __ldg(g.ko[2] + it.z);
      scale = kk2 > 0.0 ? scale / kk2 : 0.0;
      // i (k' x g): the cross product's real part becomes the imaginary
      // part, its imaginary part the negated real part
      const double cr[3] = {ky * re[2] - kz * re[1], kz * re[0] - kx * re[2],
                            kx * re[1] - ky * re[0]};
      const double ci[3] = {ky * im[2] - kz * im[1], kz * im[0] - kx * im[2],
                            kx * im[1] - ky * im[0]};
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        re[c] = -ci[c];
        im[c] = cr[c];
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) store(w[c], it.e, scale * re[c], scale * im[c]);
  }
}

// blocks of `kernel` the card holds at once, at most `cap` and no more
// than the entries need
template <typename K>
cudaError_t resident_blocks(K kernel, int sms, long long n, long long cap,
                            int& blocks) {
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  long long want = (n + kThreads - 1) / kThreads;
  const long long resident = static_cast<long long>(sms) * per_sm;
  if (want > resident) want = resident;
  if (want > cap) want = cap;
  blocks = static_cast<int>(want);
  return cudaSuccess;
}

template <typename C, bool DIV, bool VEC>
cudaError_t run(void* const w[3], const Grid& g, const Scalars& s,
                double* partials, int max_partials, double n_cells_sq,
                int sms, cudaStream_t st) {
  C* w0 = static_cast<C*>(w[0]);
  C* w1 = static_cast<C*>(w[1]);
  C* w2 = static_cast<C*>(w[2]);
  int blocks = 0;
  cudaError_t err = resident_blocks(grf_kspace_power_kernel<C, DIV>, sms,
                                    g.n, max_partials, blocks);
  if (err != cudaSuccess) return err;
  grf_kspace_power_kernel<C, DIV>
      <<<blocks, kThreads, 0, st>>>(w0, w1, w2, g, s, partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n_partials = blocks;
  err = resident_blocks(grf_kspace_apply_kernel<C, DIV, VEC>, sms, g.n,
                        LLONG_MAX, blocks);
  if (err != cudaSuccess) return err;
  grf_kspace_apply_kernel<C, DIV, VEC><<<blocks, kThreads, 0, st>>>(
      w0, w1, w2, g, s, partials, n_partials, n_cells_sq);
  return cudaGetLastError();
}

template <typename C>
cudaError_t run_switches(void* const w[3], const Grid& g, const Scalars& s,
                         double* partials, int max_partials,
                         double n_cells_sq, int div_clean, int vec_pot,
                         int sms, cudaStream_t st) {
  if (div_clean && vec_pot) {
    return run<C, true, true>(w, g, s, partials, max_partials, n_cells_sq,
                              sms, st);
  }
  if (div_clean) {
    return run<C, true, false>(w, g, s, partials, max_partials, n_cells_sq,
                               sms, st);
  }
  if (vec_pot) {
    return run<C, false, true>(w, g, s, partials, max_partials, n_cells_sq,
                               sms, st);
  }
  return run<C, false, false>(w, g, s, partials, max_partials, n_cells_sq,
                              sms, st);
}

}  // namespace

// Launches both passes on `stream` of the current device; returns the
// cudaError_t of the set-up or of either launch (0 = success).  w0, w1, w2:
// the three (nx, ny, nz/2 + 1) half spectra, complex128 (f32 = 0) or
// complex64 (f32 = 1), contiguous; waves: fields/grf._wave_vector's float64
// array; k0, k1, alpha, g_rms: one float64 each; partials: room for
// max_partials float64 sums.
extern "C" int cg_grf_kspace(void* w0, void* w1, void* w2,
                             const double* waves, const double* k0,
                             const double* k1, const double* alpha,
                             const double* g_rms, double* partials,
                             int max_partials, int nx, int ny, int nz,
                             int f32, int div_clean, int vec_pot,
                             void* stream) {
  if (nx < 1 || ny < 1 || nz < 1 || max_partials < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nzh = nz / 2 + 1;
  const int s = nx + ny + nzh;
  const int off[3] = {0, nx, nx + ny};
  Grid g;
  for (int a = 0; a < 3; ++a) {
    g.k[a] = waves + off[a];
    g.kd[a] = waves + s + off[a];
    g.ko[a] = waves + 2 * s + off[a];
  }
  g.wz = waves + 3 * s;
  g.ny = ny;
  g.nzh = nzh;
  g.n = static_cast<long long>(nx) * ny * nzh;
  const Scalars sc = {k0, k1, alpha, g_rms};
  const double n_cells =
      static_cast<double>(static_cast<long long>(nx) * ny * nz);
  void* const w[3] = {w0, w1, w2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = f32 ? run_switches<float2>(w, g, sc, partials, max_partials,
                                   n_cells * n_cells, div_clean, vec_pot,
                                   sms, st)
            : run_switches<double2>(w, g, sc, partials, max_partials,
                                    n_cells * n_cells, div_clean, vec_pot,
                                    sms, st);
  return static_cast<int>(err);
}
