// The ensemble datagen's particle draws, one launch a species, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package's draws (core/draws.py and
// virial.sample_speeds_joint of cluster_generator_tpu) are plain jnp, which
// XLA fuses.  In PyTorch the same rule is a chain of whole-tensor
// operations over (B, n): node_index (a multiply, a clamp, an int64 cast,
// an integer clamp, a cast back, a subtract), two gathers and four float
// operations a lerp, eight float operations and a torch.stack a direction
// (twice for a DM or star particle), the joint-table lookup (its own
// node_index, a Bernoulli compare and cast, int64 index arithmetic, two
// gathers, a lerp), the escape-speed lerp and minimum, and the two
// products that write the (B, n, 3) outputs: about 60 passes over every
// particle of an ensemble batch, many of them int64.  This kernel draws
// each particle in registers and writes its outputs once.
//
// Collisionless (DM, stars), per particle, from the uniforms (u_r, u_q,
// u_b, pos_dir, vel_dir) and the cluster's radius nodes r_q (RQ), escape
// speed v_esc (RQ) and joint absolute-speed table (RQ, n_q):
//
//     kq, wq = node_index(u_r (RQ - 1), RQ);  r = lerp(r_q, kq, wq)
//     rhat = isotropic(pos_dir)
//     m, wm = node_index(u_q (n_q - 1), n_q);  k = kq + (u_b < wq)
//     v = min(lerp(joint[k], m, wm), lerp(v_esc, kq, wq))
//     vdir = isotropic(vel_dir), mapped back from the Osipkov-Merritt
//            (v_r, gamma v_t) space when r_a is set
//     pos = r rhat,  vel = v vdir.
//
// Gas, from (u_r, dir), the radius nodes and the model's log-uniform grid
// x (N) with the float32 thermal energy e (N): the same radius and
// direction, and e lerped at the drawn radius (core.interp.loguniform_lerp:
// the interval from log r, the weight linear in r).
//
// Bound.  The kernel must read each particle's float32 uniforms (7 a DM or
// star particle, 3 a gas particle) and write its outputs (6, 4); the
// tables are kilobytes a cluster, and the joint table is read two adjacent
// floats a particle.  At an ensemble batch of 256 clusters of 5e4 DM, 1e4
// star and 4e4 gas particles that is ~1.09 GB, 0.32 ms at 3.35 TB/s; at
// 64 clusters of 5e5 / 1e5 / 4e5, ~2.71 GB, 0.81 ms.
//
// Design.
//  * Grid (chunks of n, B): a block serves one cluster, 256 threads each
//    taking the chunk's particles 256 apart, so every uniform is read
//    coalesced.  The chunk adapts to the launch (the wrapper picks it):
//    long at an ensemble batch, so that staging the tables is a small
//    part of a block's work, short at a few clusters, so that every SM has
//    blocks.
//  * The block stages its cluster's r_q and v_esc rows (gas: r_q, x and e)
//    in shared memory: 16 KB at RQ = 2048.  Blocks of one cluster are
//    neighbours in the grid's order, so they run side by side and that
//    cluster's joint slab (4 MB at 2048 x 512) stays in the 50 MB L2 while
//    its particles gather their two adjacent floats.
//  * Outputs go straight into the (B, n, 3) tensors; no index, direction
//    or temporary reaches device memory.
//  * Bit identity with the plain version (ops/draw_particles.py), the
//    parent chain.  Every float32 operation is the chain's, in its order:
//    the _rn intrinsics for every add, subtract, multiply, divide and
//    square root, so that no multiply-add is contracted; sinf, cosf and
//    logf from libdevice with no fast-math, as torch's own kernels call
//    them; float to int by truncation as torch's cast to int64, then the
//    integer clamp; the clamps and the minimum as torch's (a NaN passes
//    through), their bounds the float32 values torch casts its Python
//    scalars to (the wrapper passes them in); a division by a Python
//    number as torch's CUDA kernels compute it, a product with the
//    reciprocal rounded to float32 once; every product in the chain's
//    association, e.g. v (sin_t cos phi); the Osipkov-Merritt map's
//    three-term dot product in torch.sum's order on the card, (x + z) + y
//    (found by comparing the three orders with torch.sum's result on an
//    H100, PyTorch 2.11).  So both paths keep the chain's bits.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;
// torch's float32 of 2 pi, the Python scalar of core.draws.isotropic
constexpr float kTwoPi = static_cast<float>(6.283185307179586);

// torch.clamp(v, lo, hi) and torch.clamp_min(v, lo) with scalar bounds
__device__ __forceinline__ float clamp_like_torch(float v, float lo,
                                                  float hi) {
  if (v != v) return v;
  return fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float clamp_min_like_torch(float v, float lo) {
  if (v != v) return v;
  return fmaxf(v, lo);
}

// torch.minimum: a NaN wins
__device__ __forceinline__ float minimum_like_torch(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fminf(a, b);
}

// core.draws.node_index: the node j in [0, n - 2] below x, and w = x - j
__device__ __forceinline__ int node_index(float x, float hi, int n,
                                          float& w) {
  const float xc = clamp_like_torch(x, 0.0f, hi);
  const int j = min(static_cast<int>(xc), n - 2);
  w = __fsub_rn(xc, static_cast<float>(j));
  return j;
}

// (1 - w) a + w b, each operation rounded
__device__ __forceinline__ float lerp(float w, float a, float b) {
  return __fadd_rn(__fmul_rn(__fsub_rn(1.0f, w), a), __fmul_rn(w, b));
}

struct Vec {
  float x, y, z;
};

// core.draws.isotropic
__device__ __forceinline__ Vec isotropic(float cos_t, float u_phi) {
  const float phi = __fmul_rn(u_phi, kTwoPi);
  const float sin_t = __fsqrt_rn(clamp_min_like_torch(
      __fsub_rn(1.0f, __fmul_rn(cos_t, cos_t)), 0.0f));
  return {__fmul_rn(sin_t, cosf(phi)), __fmul_rn(sin_t, sinf(phi)), cos_t};
}

// core.draws.velocity_draw's Osipkov-Merritt map: mu rhat + (vdir - mu
// rhat) / gamma, gamma = sqrt(1 + (r / r_a)^2), r / r_a as r (1 / r_a)
__device__ __forceinline__ Vec om_map(Vec v, Vec rh, float radius,
                                      float inv_ra) {
  // torch.sum's order over the last axis of three on the card: the
  // first and last terms, then the middle one
  const float mu = __fadd_rn(__fadd_rn(__fmul_rn(v.x, rh.x),
                                       __fmul_rn(v.z, rh.z)),
                             __fmul_rn(v.y, rh.y));
  const float q = __fmul_rn(radius, inv_ra);
  const float gamma = __fsqrt_rn(__fadd_rn(__fmul_rn(q, q), 1.0f));
  const float ax = __fmul_rn(mu, rh.x), ay = __fmul_rn(mu, rh.y),
              az = __fmul_rn(mu, rh.z);
  return {__fadd_rn(ax, __fdiv_rn(__fsub_rn(v.x, ax), gamma)),
          __fadd_rn(ay, __fdiv_rn(__fsub_rn(v.y, ay), gamma)),
          __fadd_rn(az, __fdiv_rn(__fsub_rn(v.z, az), gamma))};
}

// The scalars the chain's Python numbers round to, and the table sizes.
struct Nodes {
  int rq;       // radius nodes
  float rq_m1;  // RQ - 1
  float rq_hi;  // float32(RQ - 1 - 1e-6)
};

template <bool kOM>
__global__ void __launch_bounds__(kThreads)
draw_collisionless_kernel(const float* __restrict__ u_r,
                          const float* __restrict__ u_q,
                          const float* __restrict__ u_b,
                          const float* __restrict__ pos_c,
                          const float* __restrict__ pos_p,
                          const float* __restrict__ vel_c,
                          const float* __restrict__ vel_p,
                          const float* __restrict__ r_q,
                          const float* __restrict__ v_esc,
                          const float* __restrict__ joint,
                          float* __restrict__ pos, float* __restrict__ vel,
                          long long n, long long chunk, Nodes nd, int n_q,
                          float nq_m1, float nq_hi, float inv_ra) {
  extern __shared__ float smem[];
  float* s_rq = smem;
  float* s_ve = smem + nd.rq;
  const long long b = blockIdx.y;
  for (int i = threadIdx.x; i < nd.rq; i += kThreads) {
    s_rq[i] = r_q[b * nd.rq + i];
    s_ve[i] = v_esc[b * nd.rq + i];
  }
  __syncthreads();
  const float* jt = joint + b * nd.rq * static_cast<long long>(n_q);
  const long long lo = blockIdx.x * chunk;
  const long long hi = min(n, lo + chunk);
  for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
    const long long p = b * n + i;
    float wq;
    const int kq = node_index(__fmul_rn(u_r[p], nd.rq_m1), nd.rq_hi, nd.rq,
                              wq);
    const float radius = lerp(wq, s_rq[kq], s_rq[kq + 1]);
    const Vec rh = isotropic(pos_c[p], pos_p[p]);
    float wm;
    const int m = node_index(__fmul_rn(u_q[p], nq_m1), nq_hi, n_q, wm);
    const int k_row = kq + (u_b[p] < wq ? 1 : 0);
    const float* row = jt + static_cast<long long>(k_row) * n_q + m;
    // the Bernoulli row pick can exceed the local escape speed by the
    // inter-node difference of v_esc: capped there
    const float speed = minimum_like_torch(
        lerp(wm, __ldg(row), __ldg(row + 1)),
        lerp(wq, s_ve[kq], s_ve[kq + 1]));
    Vec vd = isotropic(vel_c[p], vel_p[p]);
    if (kOM) vd = om_map(vd, rh, radius, inv_ra);
    float* po = pos + 3 * p;
    po[0] = __fmul_rn(radius, rh.x);
    po[1] = __fmul_rn(radius, rh.y);
    po[2] = __fmul_rn(radius, rh.z);
    float* vo = vel + 3 * p;
    vo[0] = __fmul_rn(speed, vd.x);
    vo[1] = __fmul_rn(speed, vd.y);
    vo[2] = __fmul_rn(speed, vd.z);
  }
}

__global__ void __launch_bounds__(kThreads)
draw_gas_kernel(const float* __restrict__ u_r,
                const float* __restrict__ dir_c,
                const float* __restrict__ dir_p,
                const float* __restrict__ r_q,
                const float* __restrict__ grid_r,
                const float* __restrict__ e_grid, float* __restrict__ pos,
                float* __restrict__ energy, long long n, long long chunk,
                Nodes nd, int n_grid, float grid_hi, float inv_grid_m1) {
  extern __shared__ float smem[];
  float* s_rq = smem;
  float* s_x = smem + nd.rq;
  float* s_e = s_x + n_grid;
  const long long b = blockIdx.y;
  for (int i = threadIdx.x; i < nd.rq; i += kThreads) {
    s_rq[i] = r_q[b * nd.rq + i];
  }
  for (int i = threadIdx.x; i < n_grid; i += kThreads) {
    s_x[i] = grid_r[b * n_grid + i];
    s_e[i] = e_grid[b * n_grid + i];
  }
  __syncthreads();
  // the grid's log step: (log x_last - log x_0) / (N - 1), a division by
  // a Python number
  const float lg0 = logf(s_x[0]);
  const float dlg = __fmul_rn(__fsub_rn(logf(s_x[n_grid - 1]), lg0),
                              inv_grid_m1);
  const long long lo = blockIdx.x * chunk;
  const long long hi = min(n, lo + chunk);
  for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
    const long long p = b * n + i;
    float wq;
    const int kq = node_index(__fmul_rn(u_r[p], nd.rq_m1), nd.rq_hi, nd.rq,
                              wq);
    const float radius = lerp(wq, s_rq[kq], s_rq[kq + 1]);
    const Vec rh = isotropic(dir_c[p], dir_p[p]);
    // thermal energy at the drawn radius on the log-uniform grid
    const float t = clamp_like_torch(
        __fdiv_rn(__fsub_rn(logf(radius), lg0), dlg), 0.0f, grid_hi);
    const int j = min(static_cast<int>(t), n_grid - 2);
    const float x0 = s_x[j], x1 = s_x[j + 1];
    const float w = clamp_like_torch(
        __fdiv_rn(__fsub_rn(radius, x0), __fsub_rn(x1, x0)), 0.0f, 1.0f);
    energy[p] = lerp(w, s_e[j], s_e[j + 1]);
    float* po = pos + 3 * p;
    po[0] = __fmul_rn(radius, rh.x);
    po[1] = __fmul_rn(radius, rh.y);
    po[2] = __fmul_rn(radius, rh.z);
  }
}

// Whether dynamic shared memory is opted in on each device, and the limit.
struct DeviceInfo {
  bool known = false;
  int max_smem = 0;
};

DeviceInfo g_devices[kMaxDevices];

// The current device's shared-memory limit a block, every kernel here
// opted in to it on the first call; -1 with `err` set on a failure.
int smem_limit(cudaError_t& err) {
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -1;
  if (dev < 0 || dev >= kMaxDevices) {
    err = cudaErrorInvalidDevice;
    return -1;
  }
  DeviceInfo& info = g_devices[dev];
  if (!info.known) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return -1;
    const cudaFuncAttribute attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
    err = cudaFuncSetAttribute(draw_collisionless_kernel<false>, attr, optin);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(draw_collisionless_kernel<true>, attr, optin);
    }
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(draw_gas_kernel, attr, optin);
    }
    if (err != cudaSuccess) return -1;
    info.max_smem = optin;
    info.known = true;
  }
  err = cudaSuccess;
  return info.max_smem;
}

// The grid of `batch` clusters of n particles in chunks, or an error.
cudaError_t grid_of(int batch, long long n, long long chunk, size_t smem,
                    dim3& grid) {
  cudaError_t err;
  const int limit = smem_limit(err);
  if (limit < 0) return err;
  if (smem > static_cast<size_t>(limit)) return cudaErrorInvalidValue;
  const long long chunks = (n + chunk - 1) / chunk;
  if (batch > 65535 || chunks > 0x7fffffffLL) return cudaErrorInvalidValue;
  grid = dim3(static_cast<unsigned>(chunks), static_cast<unsigned>(batch));
  return cudaSuccess;
}

}  // namespace

// Launches on `stream` of the current device; each returns the cudaError_t
// of the set-up or the launch (0 = success).  `batch` clusters of n
// particles; the uniforms (batch, n), pos and vel (batch, n, 3), energy
// (batch, n); r_q and v_esc (batch, rq), joint (batch, rq, n_q), grid_r and
// e_grid (batch, n_grid); a block takes `chunk` particles (a multiple of
// 256).  rq_hi, nq_hi and grid_hi are the clamps' upper ends, inv_ra 1 /
// r_a (om != 0) and inv_grid_m1 1 / (n_grid - 1), each rounded to float32.
extern "C" int cg_draw_collisionless(
    const float* u_r, const float* u_q, const float* u_b, const float* pos_c,
    const float* pos_p, const float* vel_c, const float* vel_p,
    const float* r_q, const float* v_esc, const float* joint, float* pos,
    float* vel, int batch, long long n, int rq, int n_q, long long chunk,
    int om, float rq_hi, float nq_hi, float inv_ra, void* stream) {
  if (batch == 0 || n == 0) return 0;
  if (batch < 0 || n < 0 || rq < 2 || n_q < 2 || chunk < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = 2 * sizeof(float) * static_cast<size_t>(rq);
  dim3 grid;
  cudaError_t err = grid_of(batch, n, chunk, smem, grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Nodes nd{rq, static_cast<float>(rq - 1), rq_hi};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (om) {
    draw_collisionless_kernel<true><<<grid, kThreads, smem, st>>>(
        u_r, u_q, u_b, pos_c, pos_p, vel_c, vel_p, r_q, v_esc, joint, pos,
        vel, n, chunk, nd, n_q, static_cast<float>(n_q - 1), nq_hi, inv_ra);
  } else {
    draw_collisionless_kernel<false><<<grid, kThreads, smem, st>>>(
        u_r, u_q, u_b, pos_c, pos_p, vel_c, vel_p, r_q, v_esc, joint, pos,
        vel, n, chunk, nd, n_q, static_cast<float>(n_q - 1), nq_hi, inv_ra);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cg_draw_gas(const float* u_r, const float* dir_c,
                           const float* dir_p, const float* r_q,
                           const float* grid_r, const float* e_grid,
                           float* pos, float* energy, int batch, long long n,
                           int rq, int n_grid, long long chunk, float rq_hi,
                           float grid_hi, float inv_grid_m1, void* stream) {
  if (batch == 0 || n == 0) return 0;
  if (batch < 0 || n < 0 || rq < 2 || n_grid < 2 || chunk < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(rq) + 2 * static_cast<size_t>(n_grid));
  dim3 grid;
  cudaError_t err = grid_of(batch, n, chunk, smem, grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Nodes nd{rq, static_cast<float>(rq - 1), rq_hi};
  draw_gas_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      u_r, dir_c, dir_p, r_q, grid_r, e_grid, pos, energy, n, chunk, nd,
      n_grid, grid_hi, inv_grid_m1);
  return static_cast<int>(cudaGetLastError());
}
