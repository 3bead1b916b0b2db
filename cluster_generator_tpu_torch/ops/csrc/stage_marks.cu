// Stage marks: empty one-thread kernels whose names carry a program stage.
//
// core/profiling.device_stage launches one of these on the current stream
// where a stage of a program body begins and where it hands back to the
// enclosing stage (or ends).  Inside a captured program the launch is
// recorded into the CUDA graph, so each replay runs the marks as kernel
// nodes in stream order with no host call, and a device trace of the
// replay shows where each stage's work begins: everything on the stream
// from one mark to the next belongs to the stage of the first.
//
// The kernels do no work and touch no memory; their names are unmangled
// (extern "C") so that a trace reads them as written here.

#include <cuda_runtime.h>

extern "C" __global__ void cg_stage_models() {}
extern "C" __global__ void cg_stage_dfs() {}
extern "C" __global__ void cg_stage_tables() {}
extern "C" __global__ void cg_stage_draws() {}
extern "C" __global__ void cg_stage_mix() {}
extern "C" __global__ void cg_stage_export() {}
extern "C" __global__ void cg_stage_end() {}
extern "C" __global__ void cg_stage_noise() {}
extern "C" __global__ void cg_stage_fft() {}
extern "C" __global__ void cg_stage_kspace() {}

// Launch the mark `which` (0 models, 1 dfs, 2 tables, 3 draws, 4 mix,
// 5 export, 6 end, 7 noise, 8 fft, 9 kspace; core/profiling.STAGES) on
// `stream` of the current device; returns the cudaError_t of the launch.
extern "C" int cg_stage_mark(int which, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (which) {
    case 0: cg_stage_models<<<1, 1, 0, s>>>(); break;
    case 1: cg_stage_dfs<<<1, 1, 0, s>>>(); break;
    case 2: cg_stage_tables<<<1, 1, 0, s>>>(); break;
    case 3: cg_stage_draws<<<1, 1, 0, s>>>(); break;
    case 4: cg_stage_mix<<<1, 1, 0, s>>>(); break;
    case 5: cg_stage_export<<<1, 1, 0, s>>>(); break;
    case 6: cg_stage_end<<<1, 1, 0, s>>>(); break;
    case 7: cg_stage_noise<<<1, 1, 0, s>>>(); break;
    case 8: cg_stage_fft<<<1, 1, 0, s>>>(); break;
    case 9: cg_stage_kspace<<<1, 1, 0, s>>>(); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
