// A host stand-in for the few CUDA runtime pieces that the sources under
// qsm_tpu_torch/csrc/ use, so that they compile with a plain C++ compiler
// and run on the CPU (tests/test_torch_dfs_host.py,
// tests/test_torch_stepper_host.py, tests/test_torch_draws_host.py).
// `host_launch` runs every block's threads one after another over a fresh
// shared-memory buffer: right for a kernel whose threads share nothing
// (dfs_chunk.cu, compact_carry.cu, threefry_draws.cu);
// a kernel whose threads meet at warp votes or barriers runs under
// cuda_warp.h's `host_launch_threads` instead.  The tests rewrite the
// CUDA-only lines of a source (an `extern __shared__` declaration, the
// `<<<...>>>` launch) to use `host_smem` and a host launch.
#pragma once
#include <algorithm>
#include <cstdint>
#include <vector>

#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)

typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
enum cudaDeviceAttr { cudaDevAttrMaxSharedMemoryPerBlockOptin };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };

inline cudaError_t cudaGetDevice(int* d) {
  *d = 0;
  return cudaSuccess;
}
inline cudaError_t cudaSetDevice(int) { return cudaSuccess; }
// the H100's opt-in limit per block
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 232448;
  return cudaSuccess;
}
template <class T>
cudaError_t cudaFuncSetAttribute(T*, cudaFuncAttribute, int) {
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

struct Dim3 {
  int x, y;
};
struct dim3 {
  dim3(unsigned x = 1, unsigned y = 1, unsigned z = 1) : x(x), y(y), z(z) {}
  unsigned x, y, z;
};
// per host thread, as each CUDA thread has its own
inline thread_local Dim3 threadIdx, blockIdx, blockDim, gridDim;
inline thread_local int32_t* host_smem;

inline int __ffs(int x) { return __builtin_ffs(x); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __clz(unsigned x) { return x == 0 ? 32 : __builtin_clz(x); }
inline unsigned __funnelshift_lc(unsigned lo, unsigned hi, unsigned shift) {
  const unsigned s = shift > 32 ? 32 : shift;
  const unsigned long long w = static_cast<unsigned long long>(hi) << 32 | lo;
  return static_cast<unsigned>((w << s) >> 32);
}
// the top word of (hi:lo) << (shift & 31), as on the card
inline unsigned __funnelshift_l(unsigned lo, unsigned hi, unsigned shift) {
  const unsigned long long w = static_cast<unsigned long long>(hi) << 32 | lo;
  return static_cast<unsigned>((w << (shift & 31)) >> 32);
}
struct uint4 {
  unsigned x, y, z, w;
};
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) {
  return uint4{x, y, z, w};
}
// the launches that use it run one thread at a time
inline int atomicMax(int* p, int v) {
  const int old = *p;
  *p = std::max(old, v);
  return old;
}
using std::max;
using std::min;

// kernel<<<grid, threads, smem_bytes>>>(args) over a 1-D or 2-D grid,
// one thread at a time; the shared buffer starts as garbage, as on the
// card
template <class K, class A>
void host_launch(K kernel, dim3 grid, int threads, int smem_bytes,
                 const A& args) {
  std::vector<int32_t> buf(smem_bytes / 4 + 1);
  gridDim.x = static_cast<int>(grid.x);
  gridDim.y = static_cast<int>(grid.y);
  blockDim.x = threads;
  for (int by = 0; by < gridDim.y; ++by) {
    for (int bx = 0; bx < gridDim.x; ++bx) {
      std::fill(buf.begin(), buf.end(), 0x5A5A5A5A);
      host_smem = buf.data();
      blockIdx.x = bx;
      blockIdx.y = by;
      for (int t = 0; t < threads; ++t) {
        threadIdx.x = t;
        kernel(args);
      }
    }
  }
}
