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
// Design.  One block per row, 128 threads.  The row (n_s <= 12288 floats,
// 4 KB at n_s = 1024) is staged in shared memory with coalesced loads; each
// thread then takes quantiles m = tid, tid + 128, ..., binary-searches the
// staged row (log2 n_s shared-memory reads instead of the TPU's O(n_s) masked
// stream) and stores its result coalesced.  The arithmetic uses the _rn
// intrinsics so no multiply-add is contracted: the result is bit-identical
// to the plain float32 version in cdf_inverse.py.
//
// Bound.  At the pipeline's DM shape (2 halos x 256 rows, n_s = n_q = 512)
// one call reads 1 MiB and writes 1 MiB: 2 MiB, ~0.6 us of HBM traffic at
// 3.35 TB/s, and ~5e6 compare/lerp operations, ~0.07 us at the FP32 peak.
// Both are far below the cost of launching it (a call through the wrapper
// measured ~0.03 ms on an H100, chip_smoke.py), so the kernel is bound by
// launch latency, not by bytes or operations.  The design answers that with
// one launch per species covering all halos and all rows (2 launches per
// merger IC), not with a faster inner loop.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
invert_cdf_rows_kernel(const float* __restrict__ cdf, float* __restrict__ out,
                       int n_s, int n_q, float ds, float dq) {
  extern __shared__ float row[];
  const long long r = blockIdx.x;
  const float* src = cdf + r * n_s;
  for (int k = threadIdx.x; k < n_s; k += blockDim.x) row[k] = src[k];
  __syncthreads();

  float* dst = out + r * n_q;
  for (int m = threadIdx.x; m < n_q; m += blockDim.x) {
    const float q = __fmul_rn(static_cast<float>(m), dq);
    // upper bound: first index with row[i] > q
    int lo = 0, hi = n_s;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (row[mid] <= q) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    float v = 0.0f;
    if (lo > 0) {
      const int k = min(lo - 1, n_s - 2);
      const float c_lo = row[k];
      const float c_hi = row[k + 1];
      const float inv_dc = __fdiv_rn(1.0f, fmaxf(__fsub_rn(c_hi, c_lo), 1e-30f));
      const float s_lo = __fmul_rn(static_cast<float>(k), ds);
      v = __fadd_rn(s_lo, __fmul_rn(__fmul_rn(__fsub_rn(q, c_lo), inv_dc), ds));
    }
    dst[m] = v;
  }
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int cg_invert_cdf_rows(const float* cdf, float* out, int n_rows,
                                  int n_s, int n_q, float ds, float dq,
                                  void* stream) {
  if (n_rows == 0) return 0;
  const size_t smem = static_cast<size_t>(n_s) * sizeof(float);
  invert_cdf_rows_kernel<<<n_rows, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      cdf, out, n_s, n_q, ds, dq);
  return static_cast<int>(cudaGetLastError());
}
