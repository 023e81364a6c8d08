// A host stand-in for the few CUDA runtime pieces that
// qsm_tpu_torch/csrc/dfs_chunk.cu uses, so that its source compiles with
// a plain C++ compiler and runs on the CPU (tests/test_torch_dfs_host.py).
// A launch runs every block's threads one after another over a fresh
// shared-memory buffer: the kernel shares nothing between threads, so any
// order gives the card's result.  The test rewrites the two CUDA-only
// lines of the source (the `extern __shared__` declaration and the
// `<<<...>>>` launch) to use `host_smem` and `host_launch`.
#pragma once
#include <algorithm>
#include <cstdint>
#include <vector>

#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)

typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
enum cudaDeviceAttr { cudaDevAttrMaxSharedMemoryPerBlockOptin };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };

inline cudaError_t cudaGetDevice(int* d) {
  *d = 0;
  return cudaSuccess;
}
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
  int x;
};
inline Dim3 threadIdx, blockIdx;
inline int32_t* host_smem;

inline int __ffs(int x) { return __builtin_ffs(x); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __clz(unsigned x) { return x == 0 ? 32 : __builtin_clz(x); }
inline unsigned __funnelshift_lc(unsigned lo, unsigned hi, unsigned shift) {
  const unsigned s = shift > 32 ? 32 : shift;
  const unsigned long long w = static_cast<unsigned long long>(hi) << 32 | lo;
  return static_cast<unsigned>((w << s) >> 32);
}
using std::max;
using std::min;

// kernel<<<grid, threads, smem_bytes>>>(args), one thread at a time; the
// shared buffer starts as garbage, as on the card
template <class K, class A>
void host_launch(K kernel, int grid, int threads, int smem_bytes,
                 const A& args) {
  std::vector<int32_t> buf(smem_bytes / 4 + 1);
  for (int bx = 0; bx < grid; ++bx) {
    std::fill(buf.begin(), buf.end(), 0x5A5A5A5A);
    host_smem = buf.data();
    blockIdx.x = bx;
    for (int t = 0; t < threads; ++t) {
      threadIdx.x = t;
      kernel(args);
    }
  }
}
