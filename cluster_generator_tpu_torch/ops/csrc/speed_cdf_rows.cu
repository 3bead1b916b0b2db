// Speed-CDF rows from the float32 f(E) node table, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's speed_cdf_rows
// (cluster_generator_tpu/virial.py) is plain jnp, which XLA fuses.  In
// PyTorch the same float32-table branch is a chain of whole-tensor
// operations over (halos, rows, n_s): E in float64 and its float32 cast,
// two segment indices with their int64 casts and clamps, two gathers, the
// lerp, the pdf and its row maximum, the trapezoid increments cast to
// float64, log2(n_s) rounds of the float64 scan (each a cat and an add
// over the whole tensor), the cast back and three normalisations.  At an
// ensemble batch of 256 clusters (256 x 128 x 512 and 256 x 64 x 256,
// 21 M elements) those temporaries stream ~17 GB through device memory a
// batch.  This kernel builds each row in one pass and keeps every
// intermediate on chip.  Row i of halo h, with E_k = psi_i (1 - s_k^2):
//
//     pdf_k = s_k^2 lerp(fu_h, E_k) / max(max_k pdf_k, 1e-30)
//     cdf_k = float32(sum_{j<k} double(0.5 (pdf_j + pdf_{j+1}) ds))
//     out_k = (cdf_k / T + ramp_k) / (cdf_last / T + ramp_last),
//     T = cdf_last if cdf_last > 0 else 1,
//
// the node table fu holding NF1 uniform nodes over [0, b) and NF2 over
// [b, e_max] (b = 0.9 e_max, both per halo), the ramp i * 1e-7.
//
// Bound.  The function must read the node table (4 (NF1 + NF2) bytes per
// halo: 8.4 MB a species at 256 clusters of 4096 + 4096 nodes) and the row
// energies, and write each float32 output once: 67.1 MB (DM) + 16.8 MB
// (stars) at that batch, ~0.10 GB, ~30 us at 3.35 TB/s.  Its float64 work
// (E and log2(n_s) scan adds per element, ~0.3 GFLOP) takes ~10 us at the
// card's float64 rate.  So it is bound by the bytes it writes.
//
// Design.
//  * One block per (halo, row), up to 256 threads each striding over the
//    row's n_s entries; the grid adapts to any shape (rows of 32 to
//    MAX_N_S entries, one halo or thousands).
//  * The pdf row lives in shared memory; its maximum is a warp-shuffle
//    and shared-memory block reduction.
//  * The float64 scan is the same log-depth (Hillis-Steele) scan as
//    core.quadrature.cumsum: round k adds entry i - k to entry i for every
//    i >= k, k = 1, 2, 4, ... < n_s - 1, ping-ponging between two float64
//    rows of shared memory (the pdf row shares the second).  Each entry
//    gets the same additions in the same order as the plain version's, so
//    its float64 sum is bit for bit the same.
//  * Bit identity with the plain version (ops/speed_cdf.py).  Every
//    operation is the plain version's, in its order and precision: the
//    _rn intrinsics for every float32 and float64 add, multiply and
//    divide, so no multiply-add is contracted and every division is IEEE;
//    float64 to float32 by __double2float_rn as torch's cast; float to int
//    by truncation as torch's cast to int64; the clamps as torch's
//    (NaN passes through, then max, then min, their bounds the float32
//    values torch casts its Python scalars to, passed in by the wrapper);
//    s and the ramp read from the tensors the plain version uses.  The
//    row maximum is exact in any order.
//  * Dynamic shared memory (16 n_s bytes) is opted in up to the card's
//    limit (227 KB per block), which bounds n_s.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxDevices = 64;

// torch's maximum: a NaN wins
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// torch.clamp(v, lo, hi) with scalar bounds
__device__ __forceinline__ float clamp_like_torch(float v, float lo,
                                                  float hi) {
  if (v != v) return v;
  return fminf(fmaxf(v, lo), hi);
}

__global__ void __launch_bounds__(kMaxThreads)
speed_cdf_rows_kernel(const double* __restrict__ row_ee,
                      const double* __restrict__ s,
                      const float* __restrict__ eps,
                      const float* __restrict__ fu,
                      const double* __restrict__ b_halo,
                      const double* __restrict__ e_max_halo,
                      float* __restrict__ out, int rows, int n_s, int nf1,
                      int nf2, float nf1f, float nf2m1f, float hi1,
                      float hi2) {
  extern __shared__ __align__(16) double smem[];
  __shared__ float warp_max[kMaxThreads / 32];
  double* buf_a = smem;
  double* buf_b = smem + n_s;
  float* pdf = reinterpret_cast<float*>(buf_b);  // until the scan's round 1

  const long long row = blockIdx.x;
  const int halo = static_cast<int>(row / rows);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const double psi = row_ee[row];
  const float b = __double2float_rn(b_halo[halo]);
  const float span = __fsub_rn(__double2float_rn(e_max_halo[halo]), b);
  const float* f = fu + static_cast<long long>(halo) * (nf1 + nf2);

  // E, its node and weight, the lerp of f and the pdf
  float local_max = 0.0f;
  for (int i = tid; i < n_s; i += nt) {
    const double sd = s[i];
    const double e = __dmul_rn(psi, __dsub_rn(1.0, __dmul_rn(sd, sd)));
    const float ef = __double2float_rn(e);
    const float x1 =
        clamp_like_torch(__fmul_rn(__fdiv_rn(ef, b), nf1f), 0.0f, hi1);
    const int k1 = min(max(static_cast<int>(x1), 0), nf1 - 1);
    const float w1 = __fsub_rn(x1, static_cast<float>(k1));
    const float x2 = clamp_like_torch(
        __fmul_rn(__fdiv_rn(__fsub_rn(ef, b), span), nf2m1f), 0.0f, hi2);
    const int k2 = min(max(static_cast<int>(x2), 0), nf2 - 2);
    const float w2 = __fsub_rn(x2, static_cast<float>(k2));
    const bool in1 = ef < b;
    const int k = in1 ? k1 : nf1 + k2;
    const float w = in1 ? w1 : w2;
    const float f_e = __fadd_rn(__fmul_rn(__fsub_rn(1.0f, w), f[k]),
                                __fmul_rn(w, f[k + 1]));
    const float s32 = __double2float_rn(sd);
    const float p = __fmul_rn(__fmul_rn(s32, s32), f_e);
    pdf[i] = p;
    local_max = max_nan(local_max, p);
  }

  // the row maximum: every pdf value is >= 0, so 0 is the identity
  for (int off = 16; off > 0; off >>= 1) {
    local_max =
        max_nan(local_max, __shfl_xor_sync(0xffffffffu, local_max, off));
  }
  if ((tid & 31) == 0) warp_max[tid >> 5] = local_max;
  __syncthreads();  // also publishes the pdf row
  float row_max = warp_max[0];
  for (int wi = 1; wi < (nt + 31) / 32; ++wi) {
    row_max = max_nan(row_max, warp_max[wi]);
  }
  const float den = (row_max != row_max) ? row_max : fmaxf(row_max, 1e-30f);

  // the trapezoid increments, normalised pdf and all, in float64
  const int n = n_s - 1;
  const float s1 = __double2float_rn(s[1]);
  const float s0 = __double2float_rn(s[0]);
  const float ds = __fsub_rn(s1, s0);
  for (int i = tid; i < n; i += nt) {
    const float hi = __fdiv_rn(pdf[i + 1], den);
    const float lo = __fdiv_rn(pdf[i], den);
    buf_a[i] = static_cast<double>(
        __fmul_rn(__fmul_rn(0.5f, __fadd_rn(hi, lo)), ds));
  }
  __syncthreads();

  // core.quadrature.cumsum: x[i] += x[i - k] for i >= k, k = 1, 2, 4, ...
  double* cur = buf_a;
  double* nxt = buf_b;
  for (int k = 1; k < n; k <<= 1) {
    for (int i = tid; i < n; i += nt) {
      nxt[i] = i >= k ? __dadd_rn(cur[i], cur[i - k]) : cur[i];
    }
    __syncthreads();
    double* t = cur;
    cur = nxt;
    nxt = t;
  }

  // round to float32, normalise, ramp, normalise by the last entry
  const float total = __double2float_rn(cur[n - 1]);
  const float div = total > 0.0f ? total : 1.0f;
  const float last = __fadd_rn(__fdiv_rn(total, div), eps[n]);
  float* dst = out + row * n_s;
  for (int i = tid; i < n_s; i += nt) {
    const float c = i == 0 ? 0.0f : __double2float_rn(cur[i - 1]);
    dst[i] = __fdiv_rn(__fadd_rn(__fdiv_rn(c, div), eps[i]), last);
  }
}

// Whether dynamic shared memory is opted in on each device, and the limit.
struct DeviceInfo {
  bool known = false;
  int max_smem = 0;
};

DeviceInfo g_devices[kMaxDevices];

}  // namespace

// Launches on `stream` of the current device; returns the cudaError_t of the
// set-up or the launch (0 = success).  `n_rows` rows of `n_s` entries, the
// rows of one halo consecutive, `rows` a halo.
extern "C" int cg_speed_cdf_rows(const double* row_ee, const double* s,
                                 const float* eps, const float* fu,
                                 const double* b, const double* e_max,
                                 float* out,
                                 int n_rows, int rows, int n_s, int nf1,
                                 int nf2, float nf1f, float nf2m1f, float hi1,
                                 float hi2, void* stream) {
  if (n_rows == 0) return 0;
  if (rows < 1 || n_s < 2 || nf1 < 2 || nf2 < 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  DeviceInfo& info = g_devices[dev];
  if (!info.known) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    // the static warp maxima share the block's limit
    const int max_smem = optin - static_cast<int>(sizeof(float)) *
                                     (kMaxThreads / 32);
    err = cudaFuncSetAttribute(speed_cdf_rows_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               max_smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    info.max_smem = max_smem;
    info.known = true;
  }
  const size_t smem = 2 * sizeof(double) * static_cast<size_t>(n_s);
  if (smem > static_cast<size_t>(info.max_smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = n_s < kMaxThreads ? ((n_s + 31) & ~31) : kMaxThreads;
  speed_cdf_rows_kernel<<<n_rows, threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      row_ee, s, eps, fu, b, e_max, out, rows, n_s, nf1, nf2, nf1f, nf2m1f,
      hi1, hi2);
  return static_cast<int>(cudaGetLastError());
}
