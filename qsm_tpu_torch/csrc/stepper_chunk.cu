// stepper_chunk.cu — one chunk of the lane-compacting stepper's DFS.
//
// Replaces: qsm_tpu/ops/jax_kernel.py::build_stepper → run_one (the
// while-loop body at :281-401) in its table regime, with a static chunk.
// Every lane (one history) advances its explicit-stack Wing–Gong DFS until
// it decides, its cumulative iterations reach the budget, or it ran `chunk`
// iterations in this launch; lanes decided at entry are left untouched.
// One iteration: the candidate mask (untaken, valid, not blocked by an
// untaken predecessor, postcondition ok from the current state, after the
// sibling cursor), its lowest op, the memo probe of the child
// configuration, then descend, prune or backtrack, the status, and on
// exhaustion the memo insert of the current configuration.  A state
// outside [0, S) reads the table at the clipped state, takes the whole
// transition and then ends the lane as BUDGET, exactly as run_one does.
//
// Layouts (ops/stepper_kernel.py): tables are per table row, a lane finds
// its row in `row` (a compaction moves lanes, never tables); the stacks are
// lane-minor ([k][B]); the memo is lane-major ([B][slots][W+1]) so that a
// probe reads one contiguous key.  The carry is updated in place.
//
// What bounds it on an H100: each lane is one serial chain of dependent
// steps, and on the main path (the queue, S = 1280 packed states) a lane's
// nxt table is 245,760 bytes, ~1 GB at 4096 lanes against a 50 MB L2, so
// the chain waits on device memory: the ok row, then the nxt entry, then
// the memo slot, every iteration.  The bytes a launch needs take
// microseconds; the chain takes its latency times the iterations.  This
// first kernel is the simple one: one thread a lane, one warp a block (so
// the lanes spread over every SM), the taken/valid words in registers
// (templated on the word count W so they stay there), the stacks and the
// memo read and written in place in device memory.
//
// All word arithmetic is uint32; words are stored as int32.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int RUNNING = 0;
constexpr int SUCCESS = 1;
constexpr int FAILURE = 2;
constexpr int BUDGET = 3;
constexpr int MAX_W = 4;  // N <= 128
constexpr int LANES = 32;  // threads per block: one warp

struct Args {
  const int32_t *nxt, *okw, *prec, *valid, *nreq, *row;
  int32_t *taken, *chosen, *states, *dsi, *keys, *occ;
  int B, R, N, S, slots, chunk, budget;
};

// one round of the memo hash's word mixer (jax_kernel.py::make_hash_slot)
__device__ __forceinline__ uint32_t mix(uint32_t h, uint32_t k) {
  h ^= k;
  h *= 0x85EBCA6Bu;
  h ^= h >> 16;
  h *= 0xC2B2AE35u;
  h ^= h >> 13;
  return h;
}

// the memo slot of the key (taken words, state)
template <int W>
__device__ __forceinline__ uint32_t key_slot(const uint32_t (&tw)[W],
                                             uint32_t state, uint32_t mask) {
  uint32_t h = 0x9E3779B9u;
#pragma unroll
  for (int w = 0; w < W; ++w) h = mix(h, tw[w]);
  return mix(h, state) & mask;
}

// the ops of word w strictly after the cursor `cur` (j = 32 w + bit > cur)
__device__ __forceinline__ uint32_t after(int cur, int w) {
  const int lo = cur + 1 - 32 * w;  // the lowest allowed bit of this word
  return lo <= 0 ? 0xFFFFFFFFu : (lo >= 32 ? 0u : 0xFFFFFFFFu << lo);
}

template <int W, bool kMemo>
__global__ void __launch_bounds__(LANES) stepper_chunk_kernel(const Args a) {
  const int b = blockIdx.x * LANES + threadIdx.x;
  if (b >= a.B) return;
  const size_t LB = static_cast<size_t>(a.B);
  if (a.dsi[LB + b] != RUNNING) return;  // decided: nothing to do
  const int N = a.N, S = a.S;
  const size_t r = static_cast<size_t>(a.row[b]);
  const int32_t* nxt = a.nxt + r * S * N;
  const uint32_t* okw = reinterpret_cast<const uint32_t*>(a.okw) + r * S * W;
  const uint32_t* prec =
      reinterpret_cast<const uint32_t*>(a.prec) + r * W * N;
  const int n_req = a.nreq[r];
  uint32_t valid[W], tw[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    valid[w] = static_cast<uint32_t>(a.valid[r * W + w]);
    tw[w] = 0;
  }
  for (int j = 0; j < N; ++j) {
    const uint32_t bit = (a.taken[j * LB + b] != 0 ? 1u : 0u) << (j & 31);
#pragma unroll
    for (int w = 0; w < W; ++w) tw[w] |= w == (j >> 5) ? bit : 0u;
  }
  int32_t* chosen = a.chosen + b;  // row k at chosen[k * LB]
  int32_t* states = a.states + b;
  int32_t* keys = kMemo ? a.keys + static_cast<size_t>(b) * a.slots * (W + 1)
                        : nullptr;
  int32_t* occ = kMemo ? a.occ + static_cast<size_t>(b) * a.slots : nullptr;
  const uint32_t mask = static_cast<uint32_t>(a.slots - 1);

  int d = a.dsi[b];
  int status = RUNNING;
  int iters = a.dsi[2 * LB + b];
  int prunes = a.dsi[3 * LB + b];
  int inserts = a.dsi[4 * LB + b];
  const int start = iters;
  while (status == RUNNING && iters - start < a.chunk) {
    const int state = states[d * LB];
    const int cur = chosen[d * LB];
    uint32_t uw[W];
#pragma unroll
    for (int w = 0; w < W; ++w) uw[w] = valid[w] & ~tw[w];
    // the state's row, at the clipped state
    const bool oob = state < 0 || state >= S;
    const int s0 = state < 0 ? 0 : (state >= S ? S - 1 : state);
    // candidates: untaken, ok, after the cursor, and no untaken op
    // precedes them
    int j = -1;
#pragma unroll
    for (int wo = 0; wo < W; ++wo) {
      uint32_t c = uw[wo] & okw[s0 * W + wo] & after(cur, wo);
      for (int i = 0; i < 32; ++i) {
        const int jj = wo * 32 + i;
        if (jj >= N) break;
        uint32_t pre = 0;
#pragma unroll
        for (int w = 0; w < W; ++w) pre |= prec[w * N + jj] & uw[w];
        if (pre != 0) c &= ~(1u << i);
      }
      if (j < 0 && c != 0) j = wo * 32 + __ffs(static_cast<int>(c)) - 1;
    }
    const bool has = j >= 0;
    if (!has) j = 0;
    const int child = nxt[static_cast<size_t>(s0) * N + j];
    const bool success = has && d + 1 == n_req;

    bool prune = false;
    if (kMemo) {
      // the child configuration already proven failed?
      uint32_t kc[W];
#pragma unroll
      for (int w = 0; w < W; ++w)
        kc[w] = tw[w] | (w == (j >> 5) ? 1u << (j & 31) : 0u);
      const uint32_t sl = key_slot(kc, static_cast<uint32_t>(child), mask);
      const int32_t* k = keys + sl * (W + 1);
      bool hit = occ[sl] == 1;
#pragma unroll
      for (int w = 0; w < W; ++w) hit &= static_cast<uint32_t>(k[w]) == kc[w];
      hit &= k[W] == child;
      prune = has && hit && !success;
    }
    const bool descend = has && !prune;
    const int d_back = d > 0 ? d - 1 : 0;
    const int prev = max(chosen[d_back * LB], 0);

    if (kMemo && !has) {
      // exhausted: the current configuration (taken before this step, the
      // state as it is) is proven non-linearizable-from
      const uint32_t sl = key_slot(tw, static_cast<uint32_t>(state), mask);
      int32_t* k = keys + sl * (W + 1);
#pragma unroll
      for (int w = 0; w < W; ++w) k[w] = static_cast<int32_t>(tw[w]);
      k[W] = state;
      occ[sl] = 1;
      inserts += 1;
    }
    if (descend) {
      chosen[d * LB] = j;
      if (d + 1 <= N) {
        chosen[(d + 1) * LB] = -1;
        states[(d + 1) * LB] = child;
      }
#pragma unroll
      for (int w = 0; w < W; ++w)
        tw[w] |= w == (j >> 5) ? 1u << (j & 31) : 0u;
    } else if (prune) {
      chosen[d * LB] = j;
      prunes += 1;
    } else if (d > 0 && prev < N) {
#pragma unroll
      for (int w = 0; w < W; ++w)
        tw[w] &= w == (prev >> 5) ? ~(1u << (prev & 31)) : 0xFFFFFFFFu;
    }
    const int d_old = d;
    d = descend ? d + 1 : (prune ? d : d_back);
    iters += 1;
    int st = success ? SUCCESS : (!has && d_old == 0 ? FAILURE : RUNNING);
    if (st == RUNNING && iters >= a.budget) st = BUDGET;
    if (oob) st = BUDGET;
    status = st;
  }

  for (int j = 0; j < N; ++j) {
    uint32_t word = 0;
#pragma unroll
    for (int w = 0; w < W; ++w) word |= w == (j >> 5) ? tw[w] : 0u;
    a.taken[j * LB + b] = static_cast<int32_t>((word >> (j & 31)) & 1u);
  }
  a.dsi[b] = d;
  a.dsi[LB + b] = status;
  a.dsi[2 * LB + b] = iters;
  a.dsi[3 * LB + b] = prunes;
  a.dsi[4 * LB + b] = inserts;
}

using Kernel = void (*)(Args);

template <int W>
Kernel pick_memo(bool memo) {
  return memo ? stepper_chunk_kernel<W, true> : stepper_chunk_kernel<W, false>;
}

Kernel pick(int W, bool memo) {
  switch (W) {
    case 1: return pick_memo<1>(memo);
    case 2: return pick_memo<2>(memo);
    case 3: return pick_memo<3>(memo);
    default: return pick_memo<4>(memo);
  }
}

}  // namespace

// Launches one chunk on `stream`, updating the carry in place.  Returns
// cudaErrorInvalidValue for arguments it does not take (nothing is
// launched), else cudaGetLastError() (0 = the launch was accepted).
extern "C" int stepper_chunk_launch(
    const int32_t* nxt, const int32_t* okw, const int32_t* prec,
    const int32_t* valid, const int32_t* nreq, const int32_t* row,
    int32_t* taken, int32_t* chosen, int32_t* states, int32_t* dsi,
    int32_t* keys, int32_t* occ, int B, int R, int N, int S, int W,
    int slots, int chunk, int budget, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (N < 1 || N > 32 * MAX_W || W != (N + 31) / 32 || S < 1 || B < 0 ||
      R < 1 || slots < 0 || (slots & (slots - 1)) != 0 || chunk < 0)
    return invalid;
  if (B == 0) return 0;
  const Args a{nxt,   okw,   prec,  valid, nreq, row,   taken,
               chosen, states, dsi, keys,  occ,  B,     R,
               N,     S,     slots, chunk, budget};
  const int grid = (B + LANES - 1) / LANES;
  const Kernel kern = pick(W, slots > 0);
  kern<<<grid, LANES, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
