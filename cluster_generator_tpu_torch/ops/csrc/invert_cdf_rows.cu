// Inverse of monotone CDF rows at uniform quantiles, for Hopper (sm_90a).
//
// Replaces the TPU kernel cluster_generator_tpu/ops/pallas_kernels.py::
// invert_cdf_rows (body _invert_kernel_matshaped).  Each row of `cdf`
// (n_rows x n_s, float32) samples a non-decreasing CDF on the uniform grid
// s_k = k ds, ds = 1/(n_s-1).  Output row m holds
//
//     s_inv[m] = sum_k [c_k <= q_m < c_{k+1}] (s_k + (q_m - c_k) ds / max(c_{k+1} - c_k, 1e-30))
//
// at q_m = m dq, dq = 1/(n_q-1), with the last bin (k = n_s-2) right-closed.
// For a non-decreasing row at most one bin matches, so the masked sum is the
// lerp in the bin k = (last index with c_k <= q_m), clamped to n_s-2; a flat
// bin (c_k == c_{k+1}) is never that bin for q < 1.  When no c_k <= q_m the
// sum is empty and the result is 0.
//
// Bound.  The function reads every CDF value once and writes every quantile
// once: 4 (n_s + n_q) bytes per row against ~10 float32 operations per
// output.  At the ensemble batch shapes (32768 x 512 -> 512: 128 MiB, and
// 16384 x 256 -> 256: 32 MiB) it is bound by HBM bytes; at the merger
// shapes (512 x 512, 128 x 256: 2 MiB and less, resident in L2) by the
// latency of one launch.
//
// Design.
//  * Bin-major, no search.  Quantiles and CDF values are both sorted, so bin
//    k owns the contiguous quantile run [M(c_k), M(c_{k+1})), where
//    M(c) = #{m : q_m < c} is COMPUTED from c / dq and corrected by exact
//    float32 comparisons against q_m = m dq.  That is O(n_s + n_q) work per
//    row with no dependent chain of shared-memory reads, and it picks
//    exactly the bin of the masked sum: last k with c_k <= q_m, a flat bin
//    owns an empty run, the last bin runs to n_q (right-closed, and the
//    clamp to n_s-2), quantiles below c_0 keep the 0 of the empty sum.
//  * A team of lanes per row: one warp (many rows) or the whole 128-thread
//    block (few rows, so that a merger-sized call still spreads over the
//    card and has a short critical path).  A warp takes 32 consecutive CDF
//    values at a time, 31 bins: every lane computes M of one value, and its
//    bin's upper value and M come from the next lane by shuffle, so M is
//    computed once per value.  Neighbouring lanes hold neighbouring bins,
//    whose runs have similar lengths on a smooth CDF, so the lanes of one
//    step stay balanced, and their shared-memory reads are conflict-free.
//  * Bytes at full rate.  Rows enter shared memory by 16-byte cp.async into
//    a two-stage ring: a persistent team strides over its rows and has row
//    r+1 in flight while it works on row r.  Results are gathered in a
//    shared-memory row and leave as 16-byte coalesced stores.  Rows that are
//    not 16-byte aligned (n_s or n_q not a multiple of 4) take 4-byte
//    accesses in the same structure.
//  * Dynamic shared memory is opted in up to the card's limit (227 KB per
//    block), which bounds 2 n_s + n_q.
//  * The arithmetic uses the _rn intrinsics, in the order of the plain
//    float32 version in cdf_inverse.py, so no multiply-add is contracted:
//    the result is bit-identical to it.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxDevices = 64;

template <int TEAM>
__device__ __forceinline__ void team_sync() {
  if (TEAM == 32) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// M(c): the number of quantiles q_m = m dq, m in [0, n_q), strictly below c.
// The estimate ceil(c (n_q-1)) is corrected by exact comparisons; q_m is
// non-decreasing in m, so both loops stop at the one right answer.  The
// counter stays a float (exact for these small integers), which saves a
// conversion per comparison.  A NaN compares false everywhere and gives 0.
__device__ __forceinline__ int count_below(float c, float n_qf, float dq) {
  float m = fminf(fmaxf(ceilf(c * (n_qf - 1.0f)), 0.0f), n_qf);
  while (m > 0.0f && __fmul_rn(m - 1.0f, dq) >= c) m -= 1.0f;
  while (m < n_qf && __fmul_rn(m, dq) < c) m += 1.0f;
  return static_cast<int>(m);
}

template <int TEAM>
__device__ __forceinline__ void load_row(float* dst, const float* src,
                                         int n_s, int lane, bool vec) {
  if (vec) {
    for (int i = lane; i < (n_s >> 2); i += TEAM) {
      __pipeline_memcpy_async(dst + 4 * i, src + 4 * i, 16);
    }
  } else {
    for (int i = lane; i < n_s; i += TEAM) dst[i] = src[i];
  }
}

template <int TEAM>
__global__ void __launch_bounds__(kThreads)
invert_cdf_rows_kernel(const float* __restrict__ cdf, float* __restrict__ out,
                       int n_rows, int n_s, int n_q, float ds, float dq,
                       int vec_in, int vec_out) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kTeams = kThreads / TEAM;
  const int team = threadIdx.x / TEAM;
  const int lane = threadIdx.x % TEAM;
  const int n_s_pad = (n_s + 3) & ~3;
  const int n_q_pad = (n_q + 3) & ~3;
  float* in0 = smem + static_cast<size_t>(team) * (2 * n_s_pad + n_q_pad);
  float* in1 = in0 + n_s_pad;
  float* orow = in1 + n_s_pad;
  const float n_qf = static_cast<float>(n_q);
  // A warp takes 32 consecutive CDF values, that is 31 bins: each lane
  // computes M of its own value once and gets its bin's upper value and M
  // from the next lane by shuffle.
  constexpr int kBinsPerWarp = 31;
  const int warp_lane = threadIdx.x & 31;
  const int warp_in_team = lane >> 5;

  const long long stride = static_cast<long long>(gridDim.x) * kTeams;
  long long row = static_cast<long long>(blockIdx.x) * kTeams + team;
  // With TEAM == kThreads every thread of the block walks the same rows, so
  // the block-wide barriers below are reached uniformly.
  if (row < n_rows) load_row<TEAM>(in0, cdf + row * n_s, n_s, lane, vec_in);
  __pipeline_commit();

  for (int stage = 0; row < n_rows; row += stride, stage ^= 1) {
    const float* cur = stage ? in1 : in0;
    float* nxt = stage ? in0 : in1;
    const long long next = row + stride;
    if (next < n_rows) {
      load_row<TEAM>(nxt, cdf + next * n_s, n_s, lane, vec_in);
    }
    __pipeline_commit();  // one group per step, empty or not
    // the empty sum: quantiles that no bin owns stay 0
    float4* o4 = reinterpret_cast<float4*>(orow);
    for (int i = lane; i < (n_q_pad >> 2); i += TEAM) {
      o4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    __pipeline_wait_prior(1);  // everything but the row just requested
    team_sync<TEAM>();

    for (int p0 = warp_in_team * kBinsPerWarp; p0 < n_s - 1;
         p0 += kBinsPerWarp * (TEAM / 32)) {
      const int k = p0 + warp_lane;
      const float c_lo = cur[min(k, n_s - 1)];
      // the last value closes the last bin on the right: it owns up to n_q
      const int m_lo = (k >= n_s - 1) ? n_q : count_below(c_lo, n_qf, dq);
      const float c_hi = __shfl_down_sync(0xffffffffu, c_lo, 1);
      const int m_hi = __shfl_down_sync(0xffffffffu, m_lo, 1);
      if (warp_lane < kBinsPerWarp && k < n_s - 1 && m_lo < m_hi) {
        const float inv_dc = __frcp_rn(fmaxf(__fsub_rn(c_hi, c_lo), 1e-30f));
        const float s_lo = __fmul_rn(static_cast<float>(k), ds);
        float mf = static_cast<float>(m_lo);
        for (int m = m_lo; m < m_hi; ++m, mf += 1.0f) {
          const float q = __fmul_rn(mf, dq);
          orow[m] = __fadd_rn(
              s_lo, __fmul_rn(__fmul_rn(__fsub_rn(q, c_lo), inv_dc), ds));
        }
      }
    }
    team_sync<TEAM>();

    float* dst = out + row * n_q;
    if (vec_out) {
      float4* d4 = reinterpret_cast<float4*>(dst);
      for (int i = lane; i < (n_q >> 2); i += TEAM) d4[i] = o4[i];
    } else {
      for (int m = lane; m < n_q; m += TEAM) dst[m] = orow[m];
    }
    team_sync<TEAM>();  // orow and cur may be overwritten from here on
  }
}

// What the launcher has learned about one device and one instantiation of
// the kernel: whether dynamic shared memory is opted in, and the resident
// blocks per SM for the last few shared-memory sizes asked for.
struct KernelInfo {
  static constexpr int kSizes = 4;
  bool opted_in = false;
  int n_known = 0;
  size_t smem[kSizes] = {};
  int blocks_per_sm[kSizes] = {};
};

struct DeviceInfo {
  bool known = false;
  int sms = 0;
  int max_smem = 0;
  KernelInfo kernels[2];
};

DeviceInfo g_devices[kMaxDevices];

template <int TEAM>
cudaError_t launch(const DeviceInfo& dev, KernelInfo& info, const float* cdf,
                   float* out, int n_rows, int n_s, int n_q, float ds,
                   float dq, int vec_in, int vec_out, size_t smem,
                   cudaStream_t stream) {
  auto kernel = invert_cdf_rows_kernel<TEAM>;
  if (!info.opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dev.max_smem);
    if (err != cudaSuccess) return err;
    info.opted_in = true;
  }
  int per_sm = 0;
  for (int i = 0; i < info.n_known; ++i) {
    if (info.smem[i] == smem) per_sm = info.blocks_per_sm[i];
  }
  if (per_sm == 0) {
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kThreads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidValue;
    const int slot = info.n_known < KernelInfo::kSizes
                         ? info.n_known++
                         : static_cast<int>(smem / 16) % KernelInfo::kSizes;
    info.smem[slot] = smem;
    info.blocks_per_sm[slot] = per_sm;
  }
  // persistent: no more blocks than the card holds at once
  constexpr int kTeams = kThreads / TEAM;
  const long long wanted =
      (static_cast<long long>(n_rows) + kTeams - 1) / kTeams;
  const long long resident = static_cast<long long>(dev.sms) * per_sm;
  const int grid = static_cast<int>(wanted < resident ? wanted : resident);
  kernel<<<grid, kThreads, smem, stream>>>(cdf, out, n_rows, n_s, n_q, ds, dq,
                                           vec_in, vec_out);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` of the current device; returns the cudaError_t of the
// set-up or the launch (0 = success).
extern "C" int cg_invert_cdf_rows(const float* cdf, float* out, int n_rows,
                                  int n_s, int n_q, float ds, float dq,
                                  void* stream) {
  if (n_rows == 0) return 0;
  if (n_s < 2 || n_q < 2) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  DeviceInfo& info = g_devices[dev];
  if (!info.known) {
    err = cudaDeviceGetAttribute(&info.sms, cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&info.max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    info.known = true;
  }
  const size_t team_bytes =
      sizeof(float) * (2 * static_cast<size_t>((n_s + 3) & ~3) +
                       static_cast<size_t>((n_q + 3) & ~3));
  if (team_bytes > static_cast<size_t>(info.max_smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int vec_in =
      (n_s % 4 == 0) && (reinterpret_cast<size_t>(cdf) % 16 == 0);
  const int vec_out =
      (n_q % 4 == 0) && (reinterpret_cast<size_t>(out) % 16 == 0);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // One warp per row once there are rows enough to fill the card several
  // times over and four rows fit a block's shared memory; else the whole
  // block works on one row.
  constexpr int kWarpTeams = kThreads / 32;
  const bool warp_rows =
      n_rows > 8 * info.sms &&
      kWarpTeams * team_bytes <= static_cast<size_t>(info.max_smem);
  if (warp_rows) {
    err = launch<32>(info, info.kernels[0], cdf, out, n_rows, n_s, n_q, ds,
                     dq, vec_in, vec_out, kWarpTeams * team_bytes, s);
  } else {
    err = launch<kThreads>(info, info.kernels[1], cdf, out, n_rows, n_s, n_q,
                           ds, dq, vec_in, vec_out, team_bytes, s);
  }
  return static_cast<int>(err);
}
