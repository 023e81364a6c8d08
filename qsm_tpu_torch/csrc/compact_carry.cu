// compact_carry.cu — lane compaction of the stepper's carry, with memo
// re-hash.
//
// Replaces: qsm_tpu/ops/jax_kernel.py::JaxTPU._compact_fn (:736-792), with
// the collision rule of its host reference _compact_carry_host
// (:1118-1163).  New lane i < m is the old lane lanes[i], every plane
// gathered (its table row included: the tables themselves never move);
// lanes at or past m are padding, all zero but status SUCCESS, with an
// empty memo.  The memo becomes `slots` slots a lane: copied when the slot
// count is unchanged, else every occupied old entry (occ == 1) is
// re-hashed into an empty table, a later old slot winning a collision;
// from a carry without a memo (old_slots = 0) the survivors get an empty
// table.  A table-regime carry holds its states lane-minor ([N+1][B],
// D = 0 here); a sweep-regime carry (ops/sweep_kernel.py) holds each
// lane's state stack lane-major ([B][N+1][D], D >= 1) and keys of
// W + D words.
//
// What bounds it on an H100: bytes.  It reads the surviving lanes' stacks
// and memo once and writes the new carry once, tens to hundreds of MB when
// the memo grows.  So the work is spread over the whole card, in passes of
// grid-stride loops, one thread an element, at most BLOCKS_PER_SM blocks
// an SM of the card (its SM count comes from the caller):
//   1. planes: one thread a (plane row, new lane), a coalesced write, the
//      lane along x and the row along y of the grid; a lane-major state
//      stack: one thread a (new lane, state word), the word along x and
//      the lane along y;
//   2. re-hash only: win[i][s] = -1, then one thread a (surviving lane,
//      old slot) hashes each occupied entry and atomicMax-es its old slot
//      into win[i][dest], so the later old slot wins (the plain version's
//      scatter_reduce(amax));
//   3. memo: one thread a (new lane, new slot) writes its key and
//      occupancy: the old slot's (memo kept), the winner's (re-hash), or 0.
// Slot counts are powers of two, so a (lane, slot) index splits by a
// shift and a mask: no 64-bit division on the card.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int SUCCESS = 1;
constexpr int THREADS = 256;          // threads a block
constexpr int BLOCKS_PER_SM = 16;    // blocks of a pass an SM, at most

struct Args {
  const int32_t *taken, *chosen, *states, *dsi, *keys, *occ, *row;
  const int32_t* lanes;
  int32_t *taken_o, *chosen_o, *states_o, *dsi_o, *keys_o, *occ_o, *row_o;
  int32_t* win;  // [m][slots] winning old slot of each new slot (re-hash)
  int B_old, B_new, m, N, D, kw, old_slots, slots;
  int log_old, log_slots;  // log2 of old_slots and slots (when not 0)
};

// the memo slot of a key of kw words (jax_kernel.py::make_hash_slot)
__device__ __forceinline__ uint32_t key_slot(const int32_t* key, int kw,
                                             uint32_t mask) {
  uint32_t h = 0x9E3779B9u;
  for (int i = 0; i < kw; ++i) {
    h ^= static_cast<uint32_t>(key[i]);
    h *= 0x85EBCA6Bu;
    h ^= h >> 16;
    h *= 0xC2B2AE35u;
    h ^= h >> 13;
  }
  return h & mask;
}

__device__ __forceinline__ size_t first_index() {
  return static_cast<size_t>(blockIdx.x) * THREADS + threadIdx.x;
}

__device__ __forceinline__ size_t grid_stride() {
  return static_cast<size_t>(gridDim.x) * THREADS;
}

// rows: taken N, chosen N + 1, states N + 1 (lane-minor states only),
// dsi 5, row 1; a thread's row is its grid row (y), its lane its column
// (x)
__global__ void __launch_bounds__(THREADS) planes_kernel(const Args a) {
  const int N = a.N;
  const size_t LN = static_cast<size_t>(a.B_new);
  const size_t LO = static_cast<size_t>(a.B_old);
  for (int k = blockIdx.y; k < 3 * N + 8; k += gridDim.y) {
    if (a.D > 0 && k >= 2 * N + 1 && k < 3 * N + 2) continue;
    const int32_t* in = a.row;
    int32_t* out = a.row_o;
    int rk = 0, pad = 0;
    if (k < N) {
      in = a.taken, out = a.taken_o, rk = k;
    } else if (k < 2 * N + 1) {
      in = a.chosen, out = a.chosen_o, rk = k - N;
    } else if (k < 3 * N + 2) {
      in = a.states, out = a.states_o, rk = k - 2 * N - 1;
    } else if (k < 3 * N + 7) {
      in = a.dsi, out = a.dsi_o, rk = k - 3 * N - 2;
      pad = rk == 1 ? SUCCESS : 0;
    }
    for (size_t i = first_index(); i < LN; i += grid_stride()) {
      const bool live = i < static_cast<size_t>(a.m);
      out[rk * LN + i] =
          live ? in[rk * LO + static_cast<size_t>(a.lanes[i])] : pad;
    }
  }
}

// lane-major state stacks: new lane i (grid row y) gets the (N+1) * D
// words of old lane lanes[i], one thread a word (x); padding lanes 0
__global__ void __launch_bounds__(THREADS) states_kernel(const Args a) {
  const size_t E = static_cast<size_t>(a.N + 1) * a.D;
  for (int i = blockIdx.y; i < a.B_new; i += gridDim.y) {
    const bool live = i < a.m;
    const int32_t* in =
        live ? a.states + static_cast<size_t>(a.lanes[i]) * E : nullptr;
    int32_t* out = a.states_o + static_cast<size_t>(i) * E;
    for (size_t e = first_index(); e < E; e += grid_stride())
      out[e] = live ? in[e] : 0;
  }
}

__global__ void __launch_bounds__(THREADS) win_fill_kernel(const Args a) {
  const size_t total = static_cast<size_t>(a.m) * a.slots;
  for (size_t x = first_index(); x < total; x += grid_stride()) a.win[x] = -1;
}

// one thread a (surviving lane, old slot): the later old slot wins
__global__ void __launch_bounds__(THREADS) win_scatter_kernel(const Args a) {
  const size_t olds = static_cast<size_t>(a.old_slots);
  const size_t total = static_cast<size_t>(a.m) * olds;
  const uint32_t mask = static_cast<uint32_t>(a.slots - 1);
  for (size_t x = first_index(); x < total; x += grid_stride()) {
    const size_t i = x >> a.log_old;
    const int s = static_cast<int>(x & (olds - 1));
    const size_t at = static_cast<size_t>(a.lanes[i]) * olds + s;
    if (a.occ[at] != 1) continue;
    const uint32_t dest = key_slot(a.keys + at * a.kw, a.kw, mask);
    atomicMax(a.win + i * a.slots + dest, s);
  }
}

// one thread a (new lane, new slot)
__global__ void __launch_bounds__(THREADS) memo_kernel(const Args a) {
  const size_t slots = static_cast<size_t>(a.slots);
  const size_t total = static_cast<size_t>(a.B_new) * slots;
  const int kw = a.kw;
  for (size_t x = first_index(); x < total; x += grid_stride()) {
    const size_t i = x >> a.log_slots;
    const size_t s = x & (slots - 1);
    const int32_t* from = nullptr;
    int32_t o = 0;
    if (i < static_cast<size_t>(a.m) && a.old_slots > 0) {
      const size_t src = static_cast<size_t>(a.lanes[i]);
      if (a.old_slots == a.slots) {  // kept: the slot as it is
        from = a.keys + (src * slots + s) * kw;
        o = a.occ[src * slots + s];
      } else {
        const int w = a.win[x];
        if (w >= 0) {
          from = a.keys + (src * a.old_slots + w) * kw;
          o = 1;
        }
      }
    }
    for (int q = 0; q < kw; ++q) a.keys_o[x * kw + q] = from ? from[q] : 0;
    a.occ_o[x] = o;
  }
}

// one pass on `stream` over `cols` elements along x and `rows` along y,
// in at most `cap` blocks
int launch(void (*kern)(Args), size_t cols, int rows, size_t cap,
           const Args& a, cudaStream_t stream) {
  const size_t bx = (cols + THREADS - 1) / THREADS;
  if (bx == 0 || rows == 0) return 0;
  const size_t gx = bx < cap ? bx : cap;
  const size_t gy = std::min(static_cast<size_t>(rows),
                             std::max<size_t>(1, cap / gx));
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  kern<<<grid, THREADS, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int log2_of(int pow2) { return pow2 > 0 ? __builtin_ctz(pow2) : 0; }

}  // namespace

// Makes `device` the current device of this library's CUDA runtime
// (built static, its own beside PyTorch's): the wrapper calls it
// before each launch, so that a launch for a shard on card i runs on
// card i.  Returns the cudaSetDevice error (0 = set).
extern "C" int set_launch_device(int device) {
  return static_cast<int>(cudaSetDevice(device));
}

// Launches one compaction on `stream` into the output planes (`win` is
// scratch of m * slots ints, read only when the memo is re-hashed; D = 0
// for a table-regime carry, else its state width), each
// pass in at most BLOCKS_PER_SM * sms blocks (sms: the card's SM count).
// Returns cudaErrorInvalidValue for arguments it does not take (nothing is
// launched), else the first cudaGetLastError() that is not 0 (0 = every
// pass was accepted).
extern "C" int compact_carry_launch(
    const int32_t* taken, const int32_t* chosen, const int32_t* states,
    const int32_t* dsi, const int32_t* keys, const int32_t* occ,
    const int32_t* row, const int32_t* lanes, int32_t* taken_o,
    int32_t* chosen_o, int32_t* states_o, int32_t* dsi_o, int32_t* keys_o,
    int32_t* occ_o, int32_t* row_o, int32_t* win, int B_old, int B_new,
    int m, int N, int D, int kw, int old_slots, int slots, int sms,
    void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (B_old < 0 || B_new < 0 || m < 0 || m > B_new || N < 1 || D < 0 ||
      kw != (N + 31) / 32 + (D > 0 ? D : 1) || old_slots < 0 ||
      (old_slots & (old_slots - 1)) != 0 || slots < 0 ||
      (slots & (slots - 1)) != 0 || sms < 1)
    return invalid;
  if (B_new == 0) return 0;
  const Args a{taken,   chosen,   states,   dsi,   keys,   occ,    row,
               lanes,   taken_o,  chosen_o, states_o, dsi_o, keys_o, occ_o,
               row_o,   win,      B_old,    B_new, m,      N,      D,
               kw,      old_slots, slots,   log2_of(old_slots),
               log2_of(slots)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t LN = static_cast<size_t>(B_new);
  const size_t cap = static_cast<size_t>(BLOCKS_PER_SM) * sms;
  int err = launch(planes_kernel, LN, 3 * N + 8, cap, a, s);
  if (err == 0 && D > 0)
    err = launch(states_kernel, static_cast<size_t>(N + 1) * D, B_new, cap,
                 a, s);
  if (err != 0 || slots == 0) return err;
  if (m > 0 && old_slots > 0 && old_slots != slots) {
    err = launch(win_fill_kernel, static_cast<size_t>(m) * slots, 1, cap, a,
                 s);
    if (err == 0)
      err = launch(win_scatter_kernel, static_cast<size_t>(m) * old_slots, 1,
                   cap, a, s);
    if (err != 0) return err;
  }
  return launch(memo_kernel, LN * slots, 1, cap, a, s);
}
