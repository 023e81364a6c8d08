// threefry_draws.cu — the generation plane's raw draw table.
//
// Replaces: qsm_tpu/gen/core.py::_raw_draws_jax (:88), a jitted XLA
// program: jax.random.split(jax.random.PRNGKey(seed), n_lanes), then
// jax.random.bits(key, (n_draws,), uint32) per lane under vmap, with JAX's
// partitionable threefry (jax/_src/prng.py: _threefry_split_foldlike,
// _threefry_random_bits_partitionable).  Bit for bit:
//   key k = (0, seed mod 2^32);
//   lane key (a, b) = threefry2x32(k, (lane >> 32, lane & 0xFFFFFFFF));
//   out[lane][j] = x0 ^ x1, (x0, x1) = threefry2x32((a, b),
//                                                  (j >> 32, j & 0xFFFFFFFF)).
// threefry2x32 is Random123's 20-round Threefry-2x32: five groups of four
// rounds (x0 += x1; x1 = rotl(x1, r); x1 ^= x0), rotations alternating
// (13, 15, 26, 6) and (17, 29, 16, 24), key schedule (k0, k1, k0 ^ k1 ^
// 0x1BD11BDA) injected before the first group and after each.
//
// What bounds it on an H100: about as much the bytes written (4 a word, at
// 3.35 TB/s) as the integer work (one 20-round threefry a word, ~76
// operations), so the design keeps both streams simple: one block a lane
// (a grid-stride loop over lanes past the grid's cap), each thread derives
// the lane key once and then walks the row with a stride of the block, so
// consecutive threads store consecutive words (coalesced 128-byte
// transactions) and nothing is shared between threads.  A row shorter than
// a block takes a block of fewer warps.  Words are stored as they come;
// the wrapper views the int32 output as uint32 on the host.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;       // threads a block, at most
constexpr int MAX_BLOCKS = 65536;  // blocks a launch, at most

struct Args {
  uint32_t* out;  // [n_lanes][n_draws]
  uint32_t seed;
  long long n_lanes, n_draws;
};

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ void rounds(uint32_t& x0, uint32_t& x1, int r0,
                                       int r1, int r2, int r3) {
  x0 += x1; x1 = rotl32(x1, r0); x1 ^= x0;
  x0 += x1; x1 = rotl32(x1, r1); x1 ^= x0;
  x0 += x1; x1 = rotl32(x1, r2); x1 ^= x0;
  x0 += x1; x1 = rotl32(x1, r3); x1 ^= x0;
}

// (x0, x1) <- threefry2x32((k0, k1), (x0, x1))
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0; x1 += k1;
  rounds(x0, x1, 13, 15, 26, 6);
  x0 += k1; x1 += k2 + 1u;
  rounds(x0, x1, 17, 29, 16, 24);
  x0 += k2; x1 += k0 + 2u;
  rounds(x0, x1, 13, 15, 26, 6);
  x0 += k0; x1 += k1 + 3u;
  rounds(x0, x1, 17, 29, 16, 24);
  x0 += k1; x1 += k2 + 4u;
  rounds(x0, x1, 13, 15, 26, 6);
  x0 += k2; x1 += k0 + 5u;
}

__global__ void __launch_bounds__(THREADS)
    threefry_draws_kernel(const Args a) {
  for (long long lane = blockIdx.x; lane < a.n_lanes; lane += gridDim.x) {
    const unsigned long long ul = static_cast<unsigned long long>(lane);
    uint32_t ka = static_cast<uint32_t>(ul >> 32);
    uint32_t kb = static_cast<uint32_t>(ul);
    threefry2x32(0u, a.seed, ka, kb);
    uint32_t* row = a.out + lane * a.n_draws;
    for (long long j = threadIdx.x; j < a.n_draws; j += blockDim.x) {
      const unsigned long long uj = static_cast<unsigned long long>(j);
      uint32_t x0 = static_cast<uint32_t>(uj >> 32);
      uint32_t x1 = static_cast<uint32_t>(uj);
      threefry2x32(ka, kb, x0, x1);
      row[j] = x0 ^ x1;
    }
  }
}

}  // namespace

// The table of (seed, n_lanes, n_draws) into `out` ([n_lanes][n_draws]
// words) on `stream`.  Returns 0 or the CUDA error of the launch.
extern "C" int threefry_draws_launch(uint32_t* out, uint32_t seed,
                                     long long n_lanes, long long n_draws,
                                     void* stream) {
  if (n_lanes < 0 || n_draws < 0 || (n_lanes > 0 && n_draws > 0 && !out))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_lanes == 0 || n_draws == 0) return 0;
  const int blocks = static_cast<int>(
      n_lanes < MAX_BLOCKS ? n_lanes : static_cast<long long>(MAX_BLOCKS));
  // a short row takes a block of whole warps just covering it
  const int threads = n_draws >= THREADS
                          ? THREADS
                          : static_cast<int>((n_draws + 31) / 32 * 32);
  const Args a{out, seed, n_lanes, n_draws};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  threefry_draws_kernel<<<blocks, threads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
