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
// What bounds it on an H100: each lane's iterations form one serial chain
// of dependent integer ops and lookups, so a launch takes as long as its
// slowest lane's chain; the bytes it moves (~3.9 KB a lane) take
// microseconds.  The design therefore shortens the chain:
//
//   * one warp per block (32 lanes, one thread each), grid ceil(B/32): the
//     lanes spread over the SMs (128 blocks at 4096 lanes) and each warp
//     has a scheduler and its SM's shared memory mostly to itself;
//   * a lane's whole working set lives in shared memory for the chunk:
//     the packed postcondition words okw[s], the next-state table nxt
//     (when the launch plan stages it, else it is read from global memory),
//     the chosen/states stacks, the transposed predecessor words succ, and
//     the memo (ck0 and ck1 planes, occupancy as a bit plane; in global
//     memory only when the plan finds no room).  It is loaded once at
//     launch start and written back once at the end, so an iteration
//     touches only registers and shared memory.  Every plane is lane-minor,
//     [row][32] words: lane l always hits bank l whatever row it indexes,
//     so every per-lane gather is free of bank conflicts.  A thread touches
//     only its own lane's words, so no barrier is needed;
//   * the blocked-op test is an incremental word: cnt[j], the number of
//     untaken valid ops in prec[j], is held as 6 bit-sliced words (counts
//     0..32).  An iteration flips at most one bit i of uw = valid & ~taken,
//     and adds or subtracts succ[i] (bit j set iff i is in prec[j]) with a
//     ripple of 12 word ops; unblocked = ~(c0|c1|c2|c3|c4|c5), the same
//     word the 32-step sweep of prec[j] & uw gives;
//   * with one warp to a scheduler nothing hides a stall, so the iteration
//     is one straight run of instructions for every lane: the outcome is
//     selected, not branched on; what does not wait for the candidate (the
//     backtrack's reads and counters, the insert slot, the state's nxt row)
//     is computed beside the candidate chain; the memo probe is two
//     independent reads (an empty slot's staged key word is 0, which no
//     probe asks for); the top of the stack (state, cursor, ok row) and
//     the blocked-op word are carried in registers.
//
// The launch plan (lanes per block, grid, nxt staged or not, memo in
// shared or global memory, dynamic shared bytes) is made in Python
// (ops/dfs_kernel.py::launch_plan); the C entry re-checks it and refuses
// what it cannot launch.
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
constexpr int LANES = 32;   // lanes (threads) per block: one warp
constexpr int SLICES = 6;   // bit slices of the blocked-op counters
constexpr int STATIC_SMEM_MAX = 48 * 1024;  // above: opt in per kernel

// where the memo lives (ops/dfs_kernel.py: MEMO_OFF, MEMO_SHARED,
// MEMO_GLOBAL)
constexpr int MEMO_OFF = 0;
constexpr int MEMO_SHARED = 1;
constexpr int MEMO_GLOBAL = 2;

struct Args {
  const int32_t *nxt, *ok, *prec, *valid, *nreq;
  const int32_t *taken_in, *chosen_in, *states_in, *dsi_in;
  const int32_t *ck0_in, *ck1_in, *occ_in;
  int32_t *taken_out, *chosen_out, *states_out, *dsi_out;
  int32_t *ck0, *ck1, *occ;
  int B, N, S, cs_rows, cache_slots, chunk, budget;
};

// Shared words a lane needs, in rows of one word a lane (the same sum as
// ops/dfs_kernel.py::launch_plan).
int smem_rows(int N, int S, int cs_rows, bool stage_nxt, int memo) {
  int rows = 2 * (N + 1) + S + N;  // chosen, states, okw, succ
  if (stage_nxt) rows += S * N;
  if (memo == MEMO_SHARED) rows += 2 * cs_rows + (cs_rows + 31) / 32;
  return rows;
}

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

// cnt[j] += bit j of s (sub = 0) or cnt[j] -= bit j of s (sub = ~0), for
// all j at once: a bit-sliced ripple whose carry (borrow) out of slice k
// is (c_k ^ sub) & s, one 3-input logic op
__device__ __forceinline__ void slices_step(uint32_t (&c)[SLICES],
                                            uint32_t s, uint32_t sub) {
#pragma unroll
  for (int k = 0; k < SLICES; ++k) {
    const uint32_t t = (c[k] ^ sub) & s;
    c[k] ^= s;
    s = t;
  }
}

// the candidates strictly after the cursor `cur` (all ops for cur < 0):
// ~0 << (cur + 1), the shift clamped to [0, 32], in one funnel shift
__device__ __forceinline__ uint32_t after(int cur) {
  return __funnelshift_lc(0u, 0xFFFFFFFFu,
                          static_cast<unsigned>(max(cur, -1) + 1));
}

// the packed ok row of `state`; a state outside [0, S) has no table row
// (the Pallas one-hot gather yields zeros there)
__device__ __forceinline__ uint32_t ok_row(const uint32_t* okw_s, int state,
                                           int S) {
  return static_cast<unsigned>(state) < static_cast<unsigned>(S)
             ? okw_s[state * LANES]
             : 0u;
}

template <bool kNxtShared, int kMemo>
__global__ void __launch_bounds__(LANES) dfs_chunk_kernel(const Args a) {
  extern __shared__ int32_t smem[];
  const int lane = threadIdx.x;
  const int b = blockIdx.x * LANES + lane;
  if (b >= a.B) return;
  const size_t LB = static_cast<size_t>(a.B);
  const int N = a.N, S = a.S, cs = a.cs_rows;

  // this lane's rows: row r of a plane is p[r * LANES]
  int32_t* chosen_s = smem + lane;
  int32_t* states_s = chosen_s + (N + 1) * LANES;
  uint32_t* okw_s = reinterpret_cast<uint32_t*>(states_s + (N + 1) * LANES);
  uint32_t* succ_s = okw_s + S * LANES;
  int32_t* nxt_s = reinterpret_cast<int32_t*>(succ_s + N * LANES);
  int32_t* ck0_s = nxt_s + (kNxtShared ? S * N * LANES : 0);
  int32_t* ck1_s = ck0_s + cs * LANES;
  uint32_t* occ_s = reinterpret_cast<uint32_t*>(ck1_s + cs * LANES);

  // the carry (loops over rows are unrolled so that a thread has many
  // loads in flight: each one is a trip to device memory)
  uint32_t valid_w = 0, taken_w = 0;
#pragma unroll
  for (int j = 0; j < MAX_N; ++j) {
    if (j < N) {
      valid_w |= (a.valid[j * LB + b] != 0 ? 1u : 0u) << j;
      taken_w |= (a.taken_in[j * LB + b] != 0 ? 1u : 0u) << j;
    }
  }
#pragma unroll 8
  for (int k = 0; k <= N; ++k) {
    chosen_s[k * LANES] = a.chosen_in[k * LB + b];
    states_s[k * LANES] = a.states_in[k * LB + b];
  }
  int d = a.dsi_in[b];
  int status = a.dsi_in[LB + b];
  int iters = a.dsi_in[2 * LB + b];
  const int n_req = a.nreq[b];

  // this lane's memo column: staged, or carried to the output planes and
  // probed there
  if (kMemo == MEMO_SHARED) {
    for (int w = 0; w * 32 < cs; ++w) {
      uint32_t bits = 0;
#pragma unroll 8
      for (int r = w * 32; r < min(cs, w * 32 + 32); ++r) {
        // an empty slot's key word reads 0, which no probe asks for (a
        // child's word always holds the op just taken), so a probe needs
        // no occupancy read; the input word is restored at the end
        const bool occupied = a.occ_in[r * LB + b] == 1;
        ck0_s[r * LANES] = occupied ? a.ck0_in[r * LB + b] : 0;
        ck1_s[r * LANES] = a.ck1_in[r * LB + b];
        bits |= (occupied ? 1u : 0u) << (r & 31);
      }
      occ_s[w * LANES] = bits;
    }
  } else if (a.ck0 != a.ck0_in) {
    for (int r = 0; r < cs; ++r) {
      a.ck0[r * LB + b] = a.ck0_in[r * LB + b];
      a.ck1[r * LB + b] = a.ck1_in[r * LB + b];
      a.occ[r * LB + b] = a.occ_in[r * LB + b];
    }
  }

  // the tables and the blocked-op counters, for a running lane only
  uint32_t c[SLICES] = {0, 0, 0, 0, 0, 0};
  if (status == RUNNING) {
    for (int s = 0; s < S; ++s) {
      uint32_t w = 0;
#pragma unroll 8
      for (int j = 0; j < N; ++j) {
        const size_t idx = (static_cast<size_t>(s) * N + j) * LB + b;
        w |= (a.ok[idx] == 1 ? 1u : 0u) << j;
        if (kNxtShared) nxt_s[(s * N + j) * LANES] = a.nxt[idx];
      }
      okw_s[s * LANES] = w;
    }
    for (int i = 0; i < N; ++i) succ_s[i * LANES] = 0;
    uint32_t prec_w[MAX_N];
#pragma unroll
    for (int j = 0; j < MAX_N; ++j)
      prec_w[j] = j < N ? static_cast<uint32_t>(a.prec[j * LB + b]) : 0u;
    const uint32_t uw = valid_w & ~taken_w;
    const uint32_t nmask = N == 32 ? 0xFFFFFFFFu : (1u << N) - 1u;
#pragma unroll
    for (int j = 0; j < MAX_N; ++j) {
      const uint32_t n = __popc(prec_w[j] & uw);
#pragma unroll
      for (int k = 0; k < SLICES; ++k) c[k] |= ((n >> k) & 1u) << j;
      // transpose: bit j of succ[i] iff op i precedes op j (bits of p at
      // or above N are never in uw, so they never move a counter)
      for (uint32_t q = j < N ? prec_w[j] & nmask : 0u; q != 0; q &= q - 1)
        succ_s[(__ffs(q) - 1) * LANES] |= 1u << j;
    }
  }

  const uint32_t slot_mask = static_cast<uint32_t>(a.cache_slots - 1);
  // the top of the stack, mirrored in registers: states[d], the ops after
  // the cursor chosen[d], and the state's ok row (state 0 and cursor 0 for
  // a depth outside the stack, as the Pallas gather)
  const bool top_in = static_cast<unsigned>(d) <= static_cast<unsigned>(N);
  int state = top_in ? states_s[d * LANES] : 0;
  int cur = top_in ? chosen_s[d * LANES] : 0;
  uint32_t okrow = ok_row(okw_s, state, S);

  // The counters' blocked-op word, carried beside them.
  uint32_t unblocked = ~(c[0] | c[1] | c[2] | c[3] | c[4] | c[5]);

  // One iteration, the same instructions for every lane of the warp (see
  // the design notes above).  A decided lane does nothing for the rest of
  // the chunk.
  for (int it = 0; it < a.chunk && status == RUNNING; ++it) {
    const uint32_t tw = taken_w;
    const uint32_t uw = valid_w & ~tw;
    const bool in_d = static_cast<unsigned>(d) <= static_cast<unsigned>(N);
    const bool in_next =
        static_cast<unsigned>(d + 1) <= static_cast<unsigned>(N);

    // the backtrack: to d_back = max(d - 1, 0), untaking prev
    const int d_back = max(d - 1, 0);
    const bool in_back = d_back <= N;
    const int kb = in_back ? d_back : 0;
    const int back_cur_v = chosen_s[kb * LANES];
    const int back_state_v = states_s[kb * LANES];
    const int back_cur = in_back ? back_cur_v : 0;
    const int back_state = in_back ? back_state_v : 0;
    const uint32_t back_ok = ok_row(okw_s, back_state, S);
    const int prev = max(back_cur, 0);
    const bool untake = d > 0 && prev < N;
    const uint32_t prev_bit = untake ? 1u << prev : 0u;
    const uint32_t back_succ = succ_s[(untake ? prev : 0) * LANES];
    // uw gains prev only if it was taken and valid
    uint32_t c_back[SLICES];
#pragma unroll
    for (int k = 0; k < SLICES; ++k) c_back[k] = c[k];
    slices_step(c_back, (valid_w & tw & prev_bit) ? back_succ : 0u, 0u);
    // exhaustion's memo slot: the (taken word, state) key
    const uint32_t ins = slot_hash(tw, static_cast<uint32_t>(state),
                                   slot_mask);

    // the state's nxt row (row 0 for a state outside [0, S), which has no
    // candidate), ready before the candidate is
    const int srow =
        (static_cast<unsigned>(state) < static_cast<unsigned>(S) ? state
                                                                 : 0) * N;

    // the candidate chain: the lowest candidate bit and its index
    const uint32_t cand = uw & unblocked & okrow & after(cur);
    const bool has = cand != 0;
    const uint32_t jbit = cand & (0u - cand);
    const int jc = max(31 - __clz(jbit), 0);  // 0 when there is none
    const int jstar = has ? jc : N;
    const int nxt_v = kNxtShared
                          ? nxt_s[(srow + jc) * LANES]
                          : a.nxt[static_cast<size_t>(srow + jc) * LB + b];
    const int child = has ? nxt_v : 0;
    // uw loses j on a descend
    uint32_t c_desc[SLICES];
#pragma unroll
    for (int k = 0; k < SLICES; ++k) c_desc[k] = c[k];
    slices_step(c_desc, succ_s[jc * LANES], 0xFFFFFFFFu);
    const int next_state = in_next ? child : 0;
    const uint32_t next_ok = ok_row(okw_s, next_state, S);
    const bool success = has && (d + 1 == n_req);

    bool hit = false;
    if (kMemo != MEMO_OFF) {
      // the probe's reads are independent of each other (no short circuit)
      const uint32_t child_word = tw | jbit;
      const uint32_t sl =
          slot_hash(child_word, static_cast<uint32_t>(child), slot_mask);
      if (kMemo == MEMO_SHARED) {  // child_word != 0: never an empty slot
        hit = (static_cast<uint32_t>(ck0_s[sl * LANES]) == child_word) &
              (ck1_s[sl * LANES] == child);
      } else {
        const size_t g = sl * LB + b;
        hit = (a.occ[g] == 1) &
              (static_cast<uint32_t>(a.ck0[g]) == child_word) &
              (a.ck1[g] == child);
      }
    }
    const bool prune = has && !success && hit;
    const bool descend = has && !prune;

    // descend: chosen[d] = j, chosen[d+1] = -1, states[d+1] = child;
    // prune: the cursor moves past j at the same depth
    if (has && in_d) chosen_s[d * LANES] = jstar;
    if (descend && in_next) {
      chosen_s[(d + 1) * LANES] = -1;
      states_s[(d + 1) * LANES] = child;
    }
    // exhausted (no candidate): this configuration is proven
    // non-linearizable-from
    if (kMemo == MEMO_SHARED && !has) {
      ck0_s[ins * LANES] = static_cast<int32_t>(tw);
      ck1_s[ins * LANES] = state;
      occ_s[(ins >> 5) * LANES] |= 1u << (ins & 31);
    } else if (kMemo == MEMO_GLOBAL && !has) {
      const size_t g = ins * LB + b;
      a.ck0[g] = static_cast<int32_t>(tw);
      a.ck1[g] = state;
      a.occ[g] = 1;
    }

#pragma unroll
    for (int k = 0; k < SLICES; ++k)
      c[k] = descend ? c_desc[k] : (has ? c[k] : c_back[k]);
    unblocked = ~(c[0] | c[1] | c[2] | c[3] | c[4] | c[5]);
    taken_w = descend ? tw | jbit : (has ? tw : tw & ~prev_bit);
    cur = descend ? (in_next ? -1 : 0)
                  : (has ? (in_d ? jstar : cur) : back_cur);
    state = descend ? next_state : (has ? state : back_state);
    okrow = descend ? next_ok : (has ? okrow : back_ok);
    const int d_old = d;
    d = descend ? d + 1 : (has ? d : d_back);
    iters += 1;
    if (success)
      status = SUCCESS;
    else if (!has && d_old == 0)
      status = FAILURE;
    if (status == RUNNING && iters >= a.budget) status = BUDGET;
  }

  for (int j = 0; j < N; ++j)
    a.taken_out[j * LB + b] = static_cast<int32_t>((taken_w >> j) & 1u);
  for (int k = 0; k <= N; ++k) {
    a.chosen_out[k * LB + b] = chosen_s[k * LANES];
    a.states_out[k * LB + b] = states_s[k * LANES];
  }
  a.dsi_out[b] = d;
  a.dsi_out[LB + b] = status;
  a.dsi_out[2 * LB + b] = iters;
  if (kMemo == MEMO_SHARED) {
    // a slot occupied now reads 1 and its key; any other keeps its input
    // words (read before this lane writes them, so in == out is safe)
#pragma unroll 8
    for (int r = 0; r < cs; ++r) {
      const bool occupied = (occ_s[(r >> 5) * LANES] >> (r & 31)) & 1u;
      const int32_t k0 = occupied ? ck0_s[r * LANES] : a.ck0_in[r * LB + b];
      const int32_t o = occupied ? 1 : a.occ_in[r * LB + b];
      a.ck0[r * LB + b] = k0;
      a.ck1[r * LB + b] = ck1_s[r * LANES];
      a.occ[r * LB + b] = o;
    }
  }
}

using Kernel = void (*)(Args);

Kernel pick(bool stage_nxt, int memo) {
  static const Kernel table[2][3] = {
      {dfs_chunk_kernel<false, MEMO_OFF>, dfs_chunk_kernel<false, MEMO_SHARED>,
       dfs_chunk_kernel<false, MEMO_GLOBAL>},
      {dfs_chunk_kernel<true, MEMO_OFF>, dfs_chunk_kernel<true, MEMO_SHARED>,
       dfs_chunk_kernel<true, MEMO_GLOBAL>}};
  return table[stage_nxt ? 1 : 0][memo];
}

}  // namespace

// Launches one chunk on `stream` with the plan of
// ops/dfs_kernel.py::launch_plan.  Returns cudaErrorInvalidValue for
// arguments or a plan it does not take (nothing is launched), else
// cudaGetLastError() (0 = the launch was accepted).
extern "C" int dfs_chunk_launch(
    const int32_t* nxt, const int32_t* ok, const int32_t* prec,
    const int32_t* valid, const int32_t* nreq, const int32_t* taken_in,
    const int32_t* chosen_in, const int32_t* states_in, const int32_t* dsi_in,
    const int32_t* ck0_in, const int32_t* ck1_in, const int32_t* occ_in,
    int32_t* taken_out, int32_t* chosen_out, int32_t* states_out,
    int32_t* dsi_out, int32_t* ck0_out, int32_t* ck1_out, int32_t* occ_out,
    int B, int N, int S, int cs_rows, int cache_slots, int chunk, int budget,
    int lanes_per_block, int grid, int stage_nxt, int memo, int smem_bytes,
    void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (N < 1 || N > MAX_N || S < 1 || S > MAX_S || B < 0 || cs_rows < 1 ||
      (cache_slots > 0 && cache_slots != cs_rows))
    return invalid;
  // the plan: one warp per block over every lane, the memo where the plan
  // says (off exactly when there is none), the shared bytes that layout
  // needs, within what the device grants a block
  if (lanes_per_block != LANES || grid != (B + LANES - 1) / LANES ||
      memo < MEMO_OFF || memo > MEMO_GLOBAL ||
      (memo == MEMO_OFF) != (cache_slots == 0) ||
      smem_bytes !=
          smem_rows(N, S, cs_rows, stage_nxt != 0, memo) * LANES * 4)
    return invalid;
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem_bytes > limit) return invalid;
  if (B == 0) return 0;
  const Kernel kern = pick(stage_nxt != 0, memo);
  if (smem_bytes > STATIC_SMEM_MAX) {
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const Args a{nxt,       ok,        prec,       valid,      nreq,
               taken_in,  chosen_in, states_in,  dsi_in,     ck0_in,
               ck1_in,    occ_in,    taken_out,  chosen_out, states_out,
               dsi_out,   ck0_out,   ck1_out,    occ_out,    B,
               N,         S,         cs_rows,    cache_slots, chunk,
               budget};
  kern<<<grid, LANES, smem_bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
