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
// What bounds it on an H100: the integer work, not the bytes.  A word is
// one threefry (20 x add, funnel-shift rotate, xor, and the key
// injections) against 4 bytes written.  In the 16-byte-store
// instantiation that is ~78 SASS instructions a word, ~52 of them on the
// ALU pipe (every rotate and xor; nvcc puts most adds on the IMAD pipe),
// which retires 64 a clock an SM: at 1980 MHz a floor ~2.5x the byte
// bound (3.35 TB/s).  So the design spends as few instructions a word as
// it can and keeps the stores wide:
//   * The work is flat: units of (lane, G = 16 words), walked by a
//     grid-stride loop over a grid of at most one block an SM, sized so
//     that every SM gets the same number of warps in every pass (no
//     ragged last pass, no block a lane).  A thread derives its lane's
//     key once a unit (1 threefry for 16 words).  The loop keeps (lane,
//     unit of the row) and adds the grid's stride, split on the host into
//     (lanes, units): no division on the card past the first unit.
//   * A unit's words are P = G / V pieces of V words; piece k of unit g is
//     piece g + k * U of its row (U units a row), so consecutive threads
//     store consecutive pieces and each store instruction of a warp
//     writes one contiguous run (512 bytes for 16-byte pieces).  A row
//     whose start is 16-byte aligned (n_draws % 4 == 0 and an aligned
//     table, as every _n_draws(n) = 24n + 48 gives) stores pieces of 4
//     words as one uint4; other rows store 4-byte pieces.
//   * Indices are 64-bit, but a word's counter is 32-bit work: a piece
//     starts at a multiple of V, so its V words share the counter's high
//     word (x0's input, 0 for every row under 2^32 words), taken once a
//     piece, and differ in the low word by a literal v.  Lane, unit and
//     address arithmetic is once a unit or a piece.
//   * The 16 words of a unit are 16 independent chains that the compiler
//     interleaves, so a few warps an SM keep the integer pipes busy;
//     rotations are __funnelshift_l (SHF.L.W), one instruction each.
// The host chooses the store width and the grid once a launch
// (threefry_draws_plan); nothing is decided per word.  Words are stored
// as they come; the wrapper views the int32 output as uint32 on the host.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int G = 16;           // words a unit: one lane-key derivation
constexpr int SM_WARPS = 32;    // warps an SM in one pass (its one block)
constexpr int MAX_THREADS = 32 * SM_WARPS;

struct Plan {
  long long vector, blocks, threads, passes, per_row;
};

struct Args {
  uint32_t* out;  // [n_lanes][n_draws]
  uint32_t seed;
  uint64_t n_lanes, n_draws;
  uint64_t n_pieces;  // pieces a row: n_draws / V
  uint64_t per_row;   // units a row, U = ceil(n_pieces / P)
  uint64_t step_lanes, step_units;  // the grid's threads T as (T / U, T % U)
};

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
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

template <int V>
__global__ void __launch_bounds__(MAX_THREADS, 1)
    threefry_draws_kernel(const Args a) {
  constexpr int P = G / V;  // pieces a unit
  const uint32_t tid = blockIdx.x * blockDim.x + threadIdx.x;
  uint64_t lane = tid / a.per_row;
  uint64_t g = tid % a.per_row;
  while (lane < a.n_lanes) {
    uint32_t ka = static_cast<uint32_t>(lane >> 32);
    uint32_t kb = static_cast<uint32_t>(lane);
    threefry2x32(0u, a.seed, ka, kb);
    uint32_t w[P][V];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      // V divides j0, so the piece's words share j0's high word
      const uint64_t j0 = (g + static_cast<uint64_t>(k) * a.per_row) * V;
      const uint32_t hi = static_cast<uint32_t>(j0 >> 32);
      const uint32_t lo = static_cast<uint32_t>(j0);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        uint32_t x0 = hi, x1 = lo + v;
        threefry2x32(ka, kb, x0, x1);
        w[k][v] = x0 ^ x1;
      }
    }
    uint32_t* row = a.out + lane * a.n_draws;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const uint64_t q = g + static_cast<uint64_t>(k) * a.per_row;
      if (q < a.n_pieces) {
        if constexpr (V == 4)
          reinterpret_cast<uint4*>(row)[q] =
              make_uint4(w[k][0], w[k][1], w[k][2], w[k][3]);
        else
          row[q] = w[k][0];
      }
    }
    g += a.step_units;
    lane += a.step_lanes;
    if (g >= a.per_row) {
      g -= a.per_row;
      ++lane;
    }
  }
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// The store width and grid of a launch; false for a shape it cannot
// take.  Every SM gets the same warps in every pass: the passes a launch
// needs at SM_WARPS warps an SM, then as few warps an SM as cover the
// units in that many passes, then as few blocks (of one SM's warps) as
// hold them.
bool make_plan(const void* out, long long n_lanes, long long n_draws,
               int sms, Plan* p) {
  if (n_lanes < 0 || n_draws < 0 || sms < 1) return false;
  const bool vec = n_draws % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long v = vec ? 4 : 1;
  p->vector = vec;
  p->per_row = ceil_div(n_draws / v, G / v);
  if (p->per_row > 0 && n_lanes > INT64_MAX / 2 / p->per_row) return false;
  const long long warps = ceil_div(n_lanes * p->per_row, 32);
  if (warps == 0) {
    p->blocks = p->threads = p->passes = 0;
    return true;
  }
  p->passes = ceil_div(warps, static_cast<long long>(sms) * SM_WARPS);
  const long long per_sm = ceil_div(warps, sms * p->passes);
  p->blocks = ceil_div(warps, per_sm * p->passes);
  p->threads = 32 * per_sm;
  return true;
}

template <int V>
int launch(uint32_t* out, uint32_t seed, long long n_lanes,
           long long n_draws, const Plan& p, cudaStream_t s) {
  const long long T = p.blocks * p.threads;
  const Args a{out,
               seed,
               static_cast<uint64_t>(n_lanes),
               static_cast<uint64_t>(n_draws),
               static_cast<uint64_t>(n_draws / V),
               static_cast<uint64_t>(p.per_row),
               static_cast<uint64_t>(T / p.per_row),
               static_cast<uint64_t>(T % p.per_row)};
  const int blocks = static_cast<int>(p.blocks);
  const int threads = static_cast<int>(p.threads);
  threefry_draws_kernel<V><<<blocks, threads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The plan of a launch into `out` on a card of `sms` SMs: plan[0..4] =
// the store width (1: 16-byte stores, 0: 4-byte), blocks, threads a
// block, passes of the grid-stride loop, units a row.
// Returns 0, or cudaErrorInvalidValue for a shape it cannot take.
extern "C" int threefry_draws_plan(const void* out, long long n_lanes,
                                   long long n_draws, int sms,
                                   long long* plan) {
  Plan p;
  if (!plan || !make_plan(out, n_lanes, n_draws, sms, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  plan[0] = p.vector;
  plan[1] = p.blocks;
  plan[2] = p.threads;
  plan[3] = p.passes;
  plan[4] = p.per_row;
  return 0;
}

// The table of (seed, n_lanes, n_draws) into `out` ([n_lanes][n_draws]
// words) on `stream`, on a card of `sms` SMs.  Returns 0 or the CUDA
// error of the launch.
extern "C" int threefry_draws_launch(uint32_t* out, uint32_t seed,
                                     long long n_lanes, long long n_draws,
                                     int sms, void* stream) {
  Plan p;
  if ((n_lanes > 0 && n_draws > 0 && !out) ||
      !make_plan(out, n_lanes, n_draws, sms, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.blocks == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return p.vector ? launch<4>(out, seed, n_lanes, n_draws, p, s)
                  : launch<1>(out, seed, n_lanes, n_draws, p, s);
}
