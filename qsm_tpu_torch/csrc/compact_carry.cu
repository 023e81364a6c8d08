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
// re-hashed into an empty table in old-slot order, so a later entry wins a
// collision; from a carry without a memo (old_slots = 0) the survivors get
// an empty table.
//
// What bounds it on an H100: bytes.  It reads the surviving lanes' stacks
// and memo once and writes the new carry once; one thread a new lane walks
// its own old table in order (which is what fixes the collision winner),
// one warp a block.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int SUCCESS = 1;
constexpr int LANES = 32;  // threads per block: one warp

struct Args {
  const int32_t *taken, *chosen, *states, *dsi, *keys, *occ, *row;
  const int32_t* lanes;
  int32_t *taken_o, *chosen_o, *states_o, *dsi_o, *keys_o, *occ_o, *row_o;
  int B_old, B_new, m, N, kw, old_slots, slots;
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

__global__ void __launch_bounds__(LANES) compact_carry_kernel(const Args a) {
  const int i = blockIdx.x * LANES + threadIdx.x;
  if (i >= a.B_new) return;
  const bool live = i < a.m;
  const size_t src = live ? static_cast<size_t>(a.lanes[i]) : 0;
  const size_t LO = static_cast<size_t>(a.B_old);
  const size_t LN = static_cast<size_t>(a.B_new);
  for (int j = 0; j < a.N; ++j)
    a.taken_o[j * LN + i] = live ? a.taken[j * LO + src] : 0;
  for (int k = 0; k <= a.N; ++k) {
    a.chosen_o[k * LN + i] = live ? a.chosen[k * LO + src] : 0;
    a.states_o[k * LN + i] = live ? a.states[k * LO + src] : 0;
  }
  for (int k = 0; k < 5; ++k)
    a.dsi_o[k * LN + i] = live ? a.dsi[k * LO + src] : (k == 1 ? SUCCESS : 0);
  a.row_o[i] = live ? a.row[src] : 0;
  if (a.slots == 0) return;

  const int kw = a.kw;
  int32_t* keys_o = a.keys_o + static_cast<size_t>(i) * a.slots * kw;
  int32_t* occ_o = a.occ_o + static_cast<size_t>(i) * a.slots;
  const int32_t* keys = a.keys + src * a.old_slots * kw;
  const int32_t* occ = a.occ + src * a.old_slots;
  if (live && a.old_slots == a.slots) {
    for (int s = 0; s < a.slots * kw; ++s) keys_o[s] = keys[s];
    for (int s = 0; s < a.slots; ++s) occ_o[s] = occ[s];
    return;
  }
  for (int s = 0; s < a.slots * kw; ++s) keys_o[s] = 0;
  for (int s = 0; s < a.slots; ++s) occ_o[s] = 0;
  if (!live) return;
  const uint32_t mask = static_cast<uint32_t>(a.slots - 1);
  for (int s = 0; s < a.old_slots; ++s) {
    if (occ[s] != 1) continue;
    const int32_t* key = keys + s * kw;
    const uint32_t dest = key_slot(key, kw, mask);
    for (int k = 0; k < kw; ++k) keys_o[dest * kw + k] = key[k];
    occ_o[dest] = 1;
  }
}

}  // namespace

// Launches one compaction on `stream` into the output planes.  Returns
// cudaErrorInvalidValue for arguments it does not take (nothing is
// launched), else cudaGetLastError() (0 = the launch was accepted).
extern "C" int compact_carry_launch(
    const int32_t* taken, const int32_t* chosen, const int32_t* states,
    const int32_t* dsi, const int32_t* keys, const int32_t* occ,
    const int32_t* row, const int32_t* lanes, int32_t* taken_o,
    int32_t* chosen_o, int32_t* states_o, int32_t* dsi_o, int32_t* keys_o,
    int32_t* occ_o, int32_t* row_o, int B_old, int B_new, int m, int N,
    int kw, int old_slots, int slots, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (B_old < 0 || B_new < 0 || m < 0 || m > B_new || N < 1 || kw < 2 ||
      old_slots < 0 || (old_slots & (old_slots - 1)) != 0 || slots < 0 ||
      (slots & (slots - 1)) != 0)
    return invalid;
  if (B_new == 0) return 0;
  const Args a{taken,   chosen,   states,   dsi,   keys,   occ,   row,
               lanes,   taken_o,  chosen_o, states_o, dsi_o, keys_o, occ_o,
               row_o,   B_old,    B_new,    m,     N,      kw,    old_slots,
               slots};
  const int grid = (B_new + LANES - 1) / LANES;
  const auto kern = compact_carry_kernel;
  kern<<<grid, LANES, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
