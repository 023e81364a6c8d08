// dfs_chunk.cu — one chunk of the per-lane Wing–Gong linearizability DFS.
//
// Replaces: qsm_tpu/ops/pallas_kernel.py::build_pallas_chunk (the Pallas
// kernel body at :140-246).  It computes exactly what that kernel computes:
// every lane (one history) advances its explicit-stack DFS by `chunk`
// iterations — candidate mask, first candidate, memo lookup, then descend,
// prune or backtrack, status and budget, memo insert on exhaustion — and
// lanes already decided do nothing.  The arrays keep the Pallas kernel's
// lane-minor layout ([rows, B], int32), so the wrapper and the tests
// compare like with like.
//
// Design (the simple, correct first version):
//   * one thread per lane, blocks of 128 threads, the ragged edge masked;
//   * `taken`, the valid mask, the candidate mask and the packed
//     predecessor words are uint32 bitmasks in registers (N <= 32), so the
//     candidate set is a handful of word ops and the first candidate is
//     one __ffs;
//   * the postcondition row of each model state is packed into one word
//     at launch (okw[s], S <= 64, local memory); the next-state entry is
//     gathered from global memory by index only when a candidate exists;
//   * the `chosen` / `states` stacks live in per-thread local memory;
//   * the memo planes (ck0, ck1, occ, [slots, B]) are read and written in
//     global memory: each lane copies its own column to the output once,
//     then looks up and inserts there (safe also when in == out).
//
// What bounds it on an H100: each lane's iterations form one serial chain
// of dependent integer ops and local/global loads, so a lane's chunk time
// is latency, not bandwidth: the bytes moved per launch (~3.9 KB a lane)
// take microseconds, the 1024 dependent iterations far longer.  At the
// headline 4096 lanes the grid is only 32 blocks of 128 threads, fewer
// blocks than the card has SMs; a later version spreads lanes thinner
// (smaller blocks, a warp per lane group) and keeps tables in shared
// memory.
//
// All word arithmetic is uint32 (the Pallas kernel's int32 wrap-around and
// logical shifts give the same bit patterns); words are stored as int32.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int RUNNING = 0;
constexpr int SUCCESS = 1;
constexpr int FAILURE = 2;
constexpr int BUDGET = 3;
constexpr int MAX_N = 32;   // one-word bitmasks
constexpr int MAX_S = 64;   // packed ok rows per lane
constexpr int THREADS = 128;

// The Pallas kernel's slot mixer over the (taken-word, state) key.
__device__ __forceinline__ uint32_t slot_hash(uint32_t word, uint32_t state,
                                              uint32_t mask) {
  uint32_t h = 0x9E3779B9u ^ word;
  h *= 0x85EBCA6Bu;
  h ^= h >> 16;
  h ^= state;
  h *= 0xC2B2AE35u;
  h ^= h >> 13;
  return h & mask;
}

__global__ void __launch_bounds__(THREADS) dfs_chunk_kernel(
    const int32_t* __restrict__ nxt, const int32_t* __restrict__ ok,
    const int32_t* __restrict__ prec, const int32_t* __restrict__ valid,
    const int32_t* __restrict__ nreq,
    const int32_t* taken_in, const int32_t* chosen_in,
    const int32_t* states_in, const int32_t* dsi_in,
    const int32_t* ck0_in, const int32_t* ck1_in, const int32_t* occ_in,
    int32_t* taken_out, int32_t* chosen_out, int32_t* states_out,
    int32_t* dsi_out, int32_t* ck0, int32_t* ck1, int32_t* occ,
    int B, int N, int S, int cs_rows, int cache_slots, int chunk,
    int budget) {
  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= B) return;
  const size_t LB = static_cast<size_t>(B);

  // lane constants: predecessor words, valid mask, packed ok rows
  uint32_t prec_w[MAX_N];
  uint32_t valid_w = 0;
  uint32_t taken_w = 0;
#pragma unroll
  for (int j = 0; j < MAX_N; ++j) {
    prec_w[j] = 0;
    if (j < N) {
      prec_w[j] = static_cast<uint32_t>(prec[j * LB + b]);
      valid_w |= (valid[j * LB + b] != 0 ? 1u : 0u) << j;
      taken_w |= (taken_in[j * LB + b] != 0 ? 1u : 0u) << j;
    }
  }
  uint32_t okw[MAX_S];
  for (int s = 0; s < S; ++s) {
    uint32_t w = 0;
    for (int j = 0; j < N; ++j)
      w |= (ok[(static_cast<size_t>(s) * N + j) * LB + b] == 1 ? 1u : 0u)
           << j;
    okw[s] = w;
  }
  const int n_req = nreq[b];

  int chosen_l[MAX_N + 1];
  int states_l[MAX_N + 1];
  for (int k = 0; k <= N; ++k) {
    chosen_l[k] = chosen_in[k * LB + b];
    states_l[k] = states_in[k * LB + b];
  }
  int d = dsi_in[b];
  int status = dsi_in[LB + b];
  int iters = dsi_in[2 * LB + b];

  // this lane's memo column, carried to the output planes
  if (ck0 != ck0_in) {
    for (int r = 0; r < cs_rows; ++r) {
      ck0[r * LB + b] = ck0_in[r * LB + b];
      ck1[r * LB + b] = ck1_in[r * LB + b];
      occ[r * LB + b] = occ_in[r * LB + b];
    }
  }
  const bool use_cache = cache_slots > 0;
  const uint32_t slot_mask = static_cast<uint32_t>(cache_slots - 1);

  // a decided lane does nothing for the rest of the chunk
  for (int it = 0; it < chunk && status == RUNNING; ++it) {
    const bool in_d = d >= 0 && d <= N;
    const int state = in_d ? states_l[d] : 0;
    const int cur = in_d ? chosen_l[d] : 0;
    const uint32_t tw = taken_w;
    const uint32_t uw = valid_w & ~tw;
    uint32_t unblocked = 0;
#pragma unroll
    for (int j = 0; j < MAX_N; ++j)
      unblocked |= ((prec_w[j] & uw) == 0 ? 1u : 0u) << j;
    // a state outside [0, S) has no table row: no candidate, never an
    // out-of-bounds read (the Pallas one-hot gather yields zeros there)
    const uint32_t okrow = (state >= 0 && state < S) ? okw[state] : 0u;
    const uint32_t above = cur < 0 ? 0xFFFFFFFFu
                           : cur >= 31 ? 0u : (0xFFFFFFFFu << (cur + 1));
    const uint32_t cand = uw & unblocked & okrow & above;
    const bool has = cand != 0;
    const int jstar = has ? __ffs(cand) - 1 : N;
    const int child =
        has ? nxt[(static_cast<size_t>(state) * N + jstar) * LB + b] : 0;
    const bool success = has && (d + 1 == n_req);

    bool prune = false;
    if (use_cache && has && !success) {
      const uint32_t child_word = tw | (1u << min(jstar, N - 1));
      const size_t sl =
          slot_hash(child_word, static_cast<uint32_t>(child), slot_mask) * LB +
          b;
      prune = occ[sl] == 1 && static_cast<uint32_t>(ck0[sl]) == child_word &&
              ck1[sl] == child;
    }
    const bool descend = has && !prune;
    const int d_back = max(d - 1, 0);

    if (descend) {
      // chosen[d] = j, chosen[d+1] = -1, states[d+1] = child
      taken_w |= 1u << jstar;
      if (in_d) chosen_l[d] = jstar;
      if (d + 1 >= 0 && d + 1 <= N) {
        chosen_l[d + 1] = -1;
        states_l[d + 1] = child;
      }
    } else if (prune) {
      // the cursor moves past j at the same depth
      if (in_d) chosen_l[d] = jstar;
    } else if (d > 0) {
      // backtrack: untake the op chosen one level up
      const int prev = max(d_back <= N ? chosen_l[d_back] : 0, 0);
      if (prev < N) taken_w &= ~(1u << prev);
    }
    const int d_old = d;
    d = descend ? d + 1 : (prune ? d : d_back);
    iters += 1;
    if (success)
      status = SUCCESS;
    else if (!has && d_old == 0)
      status = FAILURE;
    if (status == RUNNING && iters >= budget) status = BUDGET;
    if (use_cache && !has) {
      // exhausted: this configuration is proven non-linearizable-from
      const size_t sl =
          slot_hash(tw, static_cast<uint32_t>(state), slot_mask) * LB + b;
      ck0[sl] = static_cast<int32_t>(tw);
      ck1[sl] = state;
      occ[sl] = 1;
    }
  }

  for (int j = 0; j < N; ++j)
    taken_out[j * LB + b] = static_cast<int32_t>((taken_w >> j) & 1u);
  for (int k = 0; k <= N; ++k) {
    chosen_out[k * LB + b] = chosen_l[k];
    states_out[k * LB + b] = states_l[k];
  }
  dsi_out[b] = d;
  dsi_out[LB + b] = status;
  dsi_out[2 * LB + b] = iters;
}

}  // namespace

// Launches one chunk on `stream`.  Returns cudaGetLastError() (0 = the
// launch was accepted); a refused launch never runs.
extern "C" int dfs_chunk_launch(
    const int32_t* nxt, const int32_t* ok, const int32_t* prec,
    const int32_t* valid, const int32_t* nreq, const int32_t* taken_in,
    const int32_t* chosen_in, const int32_t* states_in, const int32_t* dsi_in,
    const int32_t* ck0_in, const int32_t* ck1_in, const int32_t* occ_in,
    int32_t* taken_out, int32_t* chosen_out, int32_t* states_out,
    int32_t* dsi_out, int32_t* ck0_out, int32_t* ck1_out, int32_t* occ_out,
    int B, int N, int S, int cs_rows, int cache_slots, int chunk, int budget,
    void* stream) {
  if (N < 1 || N > MAX_N || S < 1 || S > MAX_S || B < 0 || cs_rows < 1 ||
      (cache_slots > 0 && cache_slots != cs_rows))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const dim3 grid((B + THREADS - 1) / THREADS);
  dfs_chunk_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      nxt, ok, prec, valid, nreq, taken_in, chosen_in, states_in, dsi_in,
      ck0_in, ck1_in, occ_in, taken_out, chosen_out, states_out, dsi_out,
      ck0_out, ck1_out, occ_out, B, N, S, cs_rows, cache_slots, chunk,
      budget);
  return static_cast<int>(cudaGetLastError());
}
