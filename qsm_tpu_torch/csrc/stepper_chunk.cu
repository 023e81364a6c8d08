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
// Layouts (ops/stepper_kernel.py): the step table is one [S][V] table for
// the whole batch over its vocabulary of distinct (cmd, arg, resp) triples
// (vnxt, and vok packed 32 entries a word); op j of a lane is entry
// vocab[row][j].  The per-history tables (vocab, prec, valid, nreq) are
// read through the lane's `row` (a compaction moves lanes, never tables);
// the carry's stacks are lane-minor ([k][B]); the memo is lane-major
// ([B][slots][W+1]) so that a probe reads one contiguous key.  The carry
// is updated in place.
//
// The design: one warp owns one lane.  Thread t owns ops t, t+32, t+64,
// t+96 and holds their vocabulary indices and predecessor words in
// registers, loaded once a launch; the taken words, depth and counters are
// warp-uniform and kept by every thread.  A block's warps share one copy of
// the step table in shared memory, staged once a launch, and each warp
// keeps its lane's chosen/states stacks in shared memory for the whole
// chunk (every thread writes the same value to a stack entry, so a thread
// always reads what it wrote itself).  When the table does not fit a
// block's shared memory beside the stacks, the same kernel reads it from
// device memory, where the one batch-wide table mostly stays in L2: the
// plan (ops/stepper_kernel.py::stepper_launch_plan) chooses by size and
// the C entry re-checks it.
//
// What bounds it on an H100: each lane is one serial chain of dependent
// steps, so latency, not bytes or operations.  An iteration is a
// shared-memory read of the stack top, the table reads of the thread's
// ops (shared memory, or L2), a ballot per bitmask word and a shuffle for
// the child, and with the memo one probe of the child's slot that may miss
// L2; on exhaustion one insert.  The probe reads the key's W+1 words and
// the occupancy word with W+2 threads at once, and is skipped when it
// cannot act (no candidate, or the child is the success).  One warp a lane
// puts 16-32 warps on every SM at the headline's 4096 lanes, so the SM
// hides one chain's stalls behind the others'.
//
// All word arithmetic is uint32; words are stored as int32.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int RUNNING = 0;
constexpr int SUCCESS = 1;
constexpr int FAILURE = 2;
constexpr int BUDGET = 3;
constexpr int MAX_W = 4;       // N <= 128
constexpr int WARP = 32;
constexpr int MAX_WARPS = 16;  // warps a block (stepper_kernel.py)
constexpr int STATIC_SMEM_MAX = 48 * 1024;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr uint32_t HASH_SEED = 0x9E3779B9u;

struct Args {
  const int32_t *vocab, *vnxt, *vok, *prec, *valid, *nreq, *row;
  int32_t *taken, *chosen, *states, *dsi, *keys, *occ;
  int B, N, S, V, VW, slots, chunk, budget, warps;
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

// x[i] of an array held in registers, without indexing it at run time
template <int W, class T>
__device__ __forceinline__ T pick(const T (&x)[W], int i) {
  T v = x[0];
#pragma unroll
  for (int k = 1; k < W; ++k) v = i == k ? x[k] : v;
  return v;
}

template <int W, bool kMemo, bool kStaged>
__global__ void __launch_bounds__(MAX_WARPS* WARP)
    stepper_chunk_kernel(const Args a) {
  extern __shared__ int32_t smem[];
  const int N = a.N, S = a.S, V = a.V, VW = a.VW;
  const int lane = threadIdx.x % WARP;
  const int warp = threadIdx.x / WARP;
  const int tab_words = kStaged ? S * (V + VW) : 0;
  if (kStaged) {
    // one copy of the batch's table for the block's warps
    for (int i = threadIdx.x; i < tab_words; i += a.warps * WARP)
      smem[i] = i < S * V ? a.vnxt[i] : a.vok[i - S * V];
    __syncthreads();
  }
  const int32_t* tnxt = kStaged ? smem : a.vnxt;
  const uint32_t* tok =
      reinterpret_cast<const uint32_t*>(kStaged ? smem + S * V : a.vok);

  const int b = blockIdx.x * a.warps + warp;
  if (b >= a.B) return;
  const size_t LB = static_cast<size_t>(a.B);
  if (a.dsi[LB + b] != RUNNING) return;  // decided: nothing to do
  const size_t r = static_cast<size_t>(a.row[b]);
  const uint32_t lbit = 1u << lane;

  // this thread's ops j = lane + 32 k: vocabulary index, predecessor words
  uint32_t valid[W], tw[W], prec[W][W];
  int voc[W];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const int j = lane + WARP * k;
    const bool in = j < N;
    valid[k] = static_cast<uint32_t>(a.valid[r * W + k]);
    voc[k] = in ? a.vocab[r * N + j] : 0;
#pragma unroll
    for (int w = 0; w < W; ++w)
      prec[k][w] =
          in ? static_cast<uint32_t>(a.prec[(r * W + w) * N + j]) : 0u;
    tw[k] = __ballot_sync(FULL, in && a.taken[j * LB + b] != 0);
  }
  // this lane's stacks, on chip for the whole chunk
  int32_t* chosen = smem + tab_words + warp * 2 * (N + 1);
  int32_t* states = chosen + (N + 1);
  for (int k = lane; k <= N; k += WARP) {
    chosen[k] = a.chosen[k * LB + b];
    states[k] = a.states[k * LB + b];
  }
  __syncwarp();

  int32_t* keys =
      kMemo ? a.keys + static_cast<size_t>(b) * a.slots * (W + 1) : nullptr;
  int32_t* occ = kMemo ? a.occ + static_cast<size_t>(b) * a.slots : nullptr;
  const uint32_t mask = static_cast<uint32_t>(a.slots - 1);
  const int n_req = a.nreq[r];
  int d = a.dsi[b];
  int status = RUNNING;
  int iters = a.dsi[2 * LB + b];
  int prunes = a.dsi[3 * LB + b];
  int inserts = a.dsi[4 * LB + b];
  const int start = iters;
  while (status == RUNNING && iters - start < a.chunk) {
    const int state = states[d];
    const int cur = chosen[d];
    // the state's row, at the clipped state
    const bool oob = state < 0 || state >= S;
    const int s0 = state < 0 ? 0 : (state >= S ? S - 1 : state);
    const size_t row_nxt = static_cast<size_t>(s0) * V;
    const size_t row_ok = static_cast<size_t>(s0) * VW;
    uint32_t uw[W];
#pragma unroll
    for (int w = 0; w < W; ++w) uw[w] = valid[w] & ~tw[w];
    // candidates: untaken, no untaken op precedes them, ok, after the
    // cursor; one ballot a word, and each op's child for the shuffle
    uint32_t cw[W];
    int kid[W];
#pragma unroll
    for (int k = 0; k < W; ++k) {
      uint32_t pre = 0;
#pragma unroll
      for (int w = 0; w < W; ++w) pre |= prec[k][w] & uw[w];
      const int v = voc[k];
      const bool ok = (tok[row_ok + (v >> 5)] >> (v & 31)) & 1u;
      kid[k] = tnxt[row_nxt + v];
      cw[k] = __ballot_sync(FULL, (uw[k] & lbit) != 0 && pre == 0 && ok &&
                                      lane + WARP * k > cur);
    }
    int j = -1;
#pragma unroll
    for (int k = 0; k < W; ++k)
      if (j < 0 && cw[k] != 0) j = WARP * k + __ffs(static_cast<int>(cw[k])) - 1;
    const bool has = j >= 0;
    if (!has) j = 0;
    const int jw = j >> 5;
    const uint32_t jbit = 1u << (j & 31);
    const int child = __shfl_sync(FULL, pick(kid, jw), j & 31);
    const bool success = has && d + 1 == n_req;

    bool prune = false;
    if (kMemo && has && !success) {
      // the child configuration already proven failed?  Thread t < W
      // compares key word t, thread W the state word, thread W + 1 the
      // occupancy: one read each, all at once
      uint32_t h = HASH_SEED;
#pragma unroll
      for (int w = 0; w < W; ++w) h = mix(h, tw[w] | (w == jw ? jbit : 0u));
      const uint32_t sl = mix(h, static_cast<uint32_t>(child)) & mask;
      bool eq = true;
      if (lane < W)
        eq = static_cast<uint32_t>(keys[sl * (W + 1) + lane]) ==
             (pick(tw, lane) | (lane == jw ? jbit : 0u));
      else if (lane == W)
        eq = keys[sl * (W + 1) + W] == child;
      else if (lane == W + 1)
        eq = occ[sl] == 1;
      prune = __ballot_sync(FULL, eq) == FULL;
    }
    const bool descend = has && !prune;
    const int d_back = d > 0 ? d - 1 : 0;
    const int prev = max(chosen[d_back], 0);

    if (kMemo && !has) {
      // exhausted: the current configuration (taken before this step, the
      // state as it is) is proven non-linearizable-from; each word is
      // written by the thread that compares it in a probe
      uint32_t h = HASH_SEED;
#pragma unroll
      for (int w = 0; w < W; ++w) h = mix(h, tw[w]);
      const uint32_t sl = mix(h, static_cast<uint32_t>(state)) & mask;
      if (lane < W)
        keys[sl * (W + 1) + lane] = static_cast<int32_t>(pick(tw, lane));
      else if (lane == W)
        keys[sl * (W + 1) + W] = state;
      else if (lane == W + 1)
        occ[sl] = 1;
      inserts += 1;
    }
    if (descend) {
      chosen[d] = j;
      if (d + 1 <= N) {
        chosen[d + 1] = -1;
        states[d + 1] = child;
      }
#pragma unroll
      for (int w = 0; w < W; ++w) tw[w] |= w == jw ? jbit : 0u;
    } else if (prune) {
      chosen[d] = j;
      prunes += 1;
    } else if (d > 0 && prev < N) {
#pragma unroll
      for (int w = 0; w < W; ++w)
        tw[w] &= w == (prev >> 5) ? ~(1u << (prev & 31)) : FULL;
    }
    const int d_old = d;
    d = descend ? d + 1 : (prune ? d : d_back);
    iters += 1;
    int st = success ? SUCCESS : (!has && d_old == 0 ? FAILURE : RUNNING);
    if (st == RUNNING && iters >= a.budget) st = BUDGET;
    if (oob) st = BUDGET;
    status = st;
  }

  __syncwarp();
  for (int k = lane; k <= N; k += WARP) {
    a.chosen[k * LB + b] = chosen[k];
    a.states[k * LB + b] = states[k];
  }
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const int j = lane + WARP * k;
    if (j < N) a.taken[j * LB + b] = static_cast<int32_t>((tw[k] >> lane) & 1u);
  }
  if (lane == 0) {
    a.dsi[b] = d;
    a.dsi[LB + b] = status;
    a.dsi[2 * LB + b] = iters;
    a.dsi[3 * LB + b] = prunes;
    a.dsi[4 * LB + b] = inserts;
  }
}

using Kernel = void (*)(Args);

template <int W, bool kMemo>
Kernel pick_stage(bool staged) {
  return staged ? stepper_chunk_kernel<W, kMemo, true>
                : stepper_chunk_kernel<W, kMemo, false>;
}

template <int W>
Kernel pick_memo(bool memo, bool staged) {
  return memo ? pick_stage<W, true>(staged) : pick_stage<W, false>(staged);
}

Kernel pick_kernel(int W, bool memo, bool staged) {
  switch (W) {
    case 1: return pick_memo<1>(memo, staged);
    case 2: return pick_memo<2>(memo, staged);
    case 3: return pick_memo<3>(memo, staged);
    default: return pick_memo<4>(memo, staged);
  }
}

}  // namespace

// Makes `device` the current device of this library's CUDA runtime
// (built static, its own beside PyTorch's): the wrapper calls it
// before each launch, so that a launch for a shard on card i runs on
// card i.  Returns the cudaSetDevice error (0 = set).
extern "C" int set_launch_device(int device) {
  return static_cast<int>(cudaSetDevice(device));
}

// Launches one chunk on `stream` with the plan of
// ops/stepper_kernel.py::stepper_launch_plan (warps a block, grid, table
// staged or not, shared bytes), updating the carry in place.  Returns
// cudaErrorInvalidValue for arguments or a plan it does not take (nothing
// is launched), else cudaGetLastError() (0 = the launch was accepted).
extern "C" int stepper_chunk_launch(
    const int32_t* vocab, const int32_t* vnxt, const int32_t* vok,
    const int32_t* prec, const int32_t* valid, const int32_t* nreq,
    const int32_t* row, int32_t* taken, int32_t* chosen, int32_t* states,
    int32_t* dsi, int32_t* keys, int32_t* occ, int B, int R, int N, int S,
    int V, int W, int slots, int chunk, int budget, int warps, int grid,
    int stage, int smem_bytes, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (N < 1 || N > 32 * MAX_W || W != (N + 31) / 32 || S < 1 || V < 1 ||
      B < 0 || R < 1 || slots < 0 || (slots & (slots - 1)) != 0 || chunk < 0)
    return invalid;
  const int VW = (V + 31) / 32;
  // the plan: a grid of `warps`-warp blocks over every lane, the shared
  // bytes of its layout (the table when staged, two stacks a warp), within
  // what the device grants a block
  const long long table = 4LL * S * (V + VW);
  const long long want = (stage != 0 ? table : 0) + 8LL * warps * (N + 1);
  if (warps < 1 || warps > MAX_WARPS || grid != (B + warps - 1) / warps ||
      smem_bytes != want)
    return invalid;
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem_bytes > limit) return invalid;
  if (B == 0) return 0;
  const Kernel kern = pick_kernel(W, slots > 0, stage != 0);
  if (smem_bytes > STATIC_SMEM_MAX) {
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const Args a{vocab, vnxt, vok,   prec,   valid, nreq,  row,   taken,
               chosen, states, dsi, keys,  occ,   B,     N,     S,
               V,     VW,    slots, chunk, budget, warps};
  kern<<<grid, warps * WARP, smem_bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
