// sweep_advance.cu — one DFS iteration of the lane-compacting stepper's
// sweep regime, given the step's results: the regime's generic route.
//
// Replaces: qsm_tpu/ops/jax_kernel.py::build_stepper → run_one in its
// sweep regime (:303-309: the vmapped step sweep over every op, with the
// choice after it) for a spec whose step is not code in stepper_sweep.cu
// (no Spec.sweep_kernel kind) or whose state is wider than that kernel
// holds (D > 28).  The reference evaluates the spec's own step_jax inside
// run_one; here the caller (ops/sweep_generic.py::stepper_sweep_generic)
// evaluates the spec's own step_torch on the card for every listed lane
// and op, as plain PyTorch, and hands this kernel the results: `nxt`
// [L][N][D] (op j's next state from the lane's current state) and `ok`
// [L][N] (its postcondition, one byte an op).  The kernel does the rest of
// one iteration: the candidate mask (untaken, no untaken predecessor, ok,
// after the sibling cursor), the first candidate j, its child nxt[j], the
// memo probe of (taken | bit j, child), the insert of the exhausted
// (taken, state), then descend, prune or backtrack, SUCCESS, FAILURE and
// BUDGET, and the iteration, prune and insert counters: one trip of
// ops/sweep_kernel.py::stepper_sweep_plain's loop after its step.
//
// Layouts as stepper_sweep.cu's: prec [R][W][N], valid [R][W], nreq [R],
// read through the lane's `row`; taken [N][B], chosen [N+1][B], dsi [5][B]
// lane-minor; states [B][N+1][D] and the memo ([B][slots][W+D] keys,
// [B][slots] occupancy) lane-major; the carry is updated in place.  `lanes`
// (L distinct lanes) names the lanes run: warp w runs carry lane lanes[w]
// with step row w of `nxt` and `ok`.  A lane that is not RUNNING is left
// as it is.  `state_out` [L][D] receives each run lane's state after the
// iteration, the next iteration's step input, so that the caller gathers
// it once a chunk.
//
// The memo slot is ops/stepper_kernel.py::hash_slot over all W + D words,
// the mixer compact_carry.cu's key_slot uses, so a compaction re-hashes
// this route's memo unchanged.
//
// The design, simple first: one warp a lane.  Thread t owns ops t, t+32,
// t+64, t+96: it reads their taken flags, ok bytes and predecessor words,
// and one ballot a mask word finds the candidates.  Key and state words
// are handled in strides of 32 threads, so any D works; every thread runs
// the same hash chain over the key words (uniform loads).  There is no
// shared memory.
//
// What bounds it on an H100: bytes.  A running lane reads its ok row, one
// nxt row, its predecessor and valid words, the carry words it touches
// (taken, chosen, dsi, one state row) and one memo key, and writes a few
// carry words, a state row and at most one key: a few hundred bytes to a
// few KB a lane.  At 4096 lanes that is a few MB, microseconds of the
// card's memory rate; the generic route's trip is bound by the host's
// launches of the spec's step_torch around it (PERF.md).
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
constexpr int MAX_WARPS = 8;   // warps a block (sweep_generic.py)
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr uint32_t HASH_SEED = 0x9E3779B9u;

struct Args {
  const int32_t *prec, *valid, *nreq, *row, *lanes, *nxt;
  const uint8_t* ok;
  int32_t *taken, *chosen, *states, *dsi, *keys, *occ, *state_out;
  int B, L, N, W, D, slots, budget, warps;
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
__device__ __forceinline__ uint32_t pick(const uint32_t (&x)[MAX_W], int i) {
  uint32_t v = x[0];
#pragma unroll
  for (int k = 1; k < MAX_W; ++k) v = i == k ? x[k] : v;
  return v;
}

// word q of a memo key: the W taken words `tw` with bit `jbit` of word
// `jw` set (jbit = 0: none), then the D state words at `s`
__device__ __forceinline__ uint32_t key_word(const uint32_t (&tw)[MAX_W],
                                             int W, int jw, uint32_t jbit,
                                             const int32_t* s, int q) {
  if (q < W) return pick(tw, q) | (q == jw ? jbit : 0u);
  return static_cast<uint32_t>(s[q - W]);
}

// the hash of that key, over all its words (every thread the same chain)
__device__ __forceinline__ uint32_t key_hash(const uint32_t (&tw)[MAX_W],
                                             int W, int jw, uint32_t jbit,
                                             const int32_t* s, int D) {
  uint32_t h = HASH_SEED;
#pragma unroll
  for (int w = 0; w < MAX_W; ++w)
    if (w < W) h = mix(h, tw[w] | (w == jw ? jbit : 0u));
  for (int i = 0; i < D; ++i) h = mix(h, static_cast<uint32_t>(s[i]));
  return h;
}

__global__ void __launch_bounds__(MAX_WARPS* WARP)
    sweep_advance_kernel(const Args a) {
  const int lane = threadIdx.x % WARP;
  const int w_id = blockIdx.x * a.warps + threadIdx.x / WARP;
  if (w_id >= a.L) return;
  const int b = a.lanes[w_id];
  const size_t LB = static_cast<size_t>(a.B);
  if (a.dsi[LB + b] != RUNNING) return;  // decided: nothing to do
  const int N = a.N, W = a.W, D = a.D, kw = W + D;
  const size_t r = static_cast<size_t>(a.row[b]);
  const int d = a.dsi[b];
  const int cur = a.chosen[d * LB + b];  // the sibling cursor
  const int d_back = d > 0 ? d - 1 : 0;
  const int ch_back = a.chosen[d_back * LB + b];
  int32_t* stack = a.states + static_cast<size_t>(b) * (N + 1) * D;
  const int32_t* state = stack + static_cast<size_t>(d) * D;
  const uint8_t* ok = a.ok + static_cast<size_t>(w_id) * N;

  // taken and untaken words, one ballot a word
  uint32_t tw[MAX_W], uw[MAX_W];
#pragma unroll
  for (int k = 0; k < MAX_W; ++k) {
    const int j = lane + WARP * k;
    tw[k] = __ballot_sync(FULL, j < N && a.taken[j * LB + b] != 0);
    uw[k] = k < W ? static_cast<uint32_t>(a.valid[r * W + k]) & ~tw[k] : 0u;
  }
  // candidates: untaken, no untaken op precedes them, ok from the current
  // state, after the cursor; the first one a word by a ballot
  int j = -1;
#pragma unroll
  for (int k = 0; k < MAX_W; ++k) {
    const int op = lane + WARP * k;
    bool live = op < N && ((uw[k] >> lane) & 1u) != 0 && op > cur &&
                ok[op] != 0;
    if (live) {
      uint32_t blocked = 0;
#pragma unroll
      for (int w = 0; w < MAX_W; ++w)
        if (w < W)
          blocked |= static_cast<uint32_t>(a.prec[(r * W + w) * N + op]) &
                     uw[w];
      live = blocked == 0;
    }
    const uint32_t cw = __ballot_sync(FULL, live);
    if (j < 0 && cw != 0) j = WARP * k + __ffs(static_cast<int>(cw)) - 1;
  }
  const bool has = j >= 0;
  if (!has) j = 0;
  const int jw = j >> 5;
  const uint32_t jbit = 1u << (j & 31);
  const bool success = has && d + 1 == a.nreq[r];
  const int32_t* child = a.nxt + (static_cast<size_t>(w_id) * N + j) * D;

  const bool memo = a.slots > 0;
  const uint32_t mask = static_cast<uint32_t>(a.slots - 1);
  int32_t* keys =
      memo ? a.keys + static_cast<size_t>(b) * a.slots * kw : nullptr;
  int32_t* occ = memo ? a.occ + static_cast<size_t>(b) * a.slots : nullptr;
  bool prune = false;
  if (memo && has && !success) {
    // the child configuration already proven failed?
    const uint32_t sl = key_hash(tw, W, jw, jbit, child, D) & mask;
    const int32_t* key = keys + static_cast<size_t>(sl) * kw;
    bool eq = true;
    for (int q = lane; q < kw; q += WARP)
      eq = eq && static_cast<uint32_t>(key[q]) ==
                     key_word(tw, W, jw, jbit, child, q);
    prune = __ballot_sync(FULL, eq) == FULL && occ[sl] == 1;
  }
  const bool descend = has && !prune;
  __syncwarp();  // every read of the carry above, before any write below

  int d_new = d;
  if (descend) {
    if (lane == 0) {
      a.taken[j * LB + b] = 1;
      a.chosen[d * LB + b] = j;
      if (d + 1 <= N) a.chosen[(d + 1) * LB + b] = -1;
    }
    if (d + 1 <= N)
      for (int q = lane; q < D; q += WARP)
        stack[static_cast<size_t>(d + 1) * D + q] = child[q];
    d_new = d + 1;
  } else if (prune) {
    if (lane == 0) a.chosen[d * LB + b] = j;
  } else {
    // exhausted: the current configuration (taken before this step, the
    // state as it is) is proven non-linearizable-from
    if (memo) {
      const uint32_t sl = key_hash(tw, W, 0, 0u, state, D) & mask;
      int32_t* key = keys + static_cast<size_t>(sl) * kw;
      for (int q = lane; q < kw; q += WARP)
        key[q] = static_cast<int32_t>(key_word(tw, W, 0, 0u, state, q));
      if (lane == 0) occ[sl] = 1;
    }
    const int prev = ch_back > 0 ? ch_back : 0;
    if (lane == 0 && d > 0 && prev < N) a.taken[prev * LB + b] = 0;
    d_new = d_back;
  }
  const int iters = a.dsi[2 * LB + b] + 1;
  int st = success ? SUCCESS : (!has && d == 0 ? FAILURE : RUNNING);
  if (st == RUNNING && iters >= a.budget) st = BUDGET;
  const int32_t* src =
      descend ? child : stack + static_cast<size_t>(d_new) * D;
  int32_t* out = a.state_out + static_cast<size_t>(w_id) * D;
  // not unrolled: unrolled, ptxas held the kernel at 40 registers and
  // spilled (-Xptxas -v on sm_90a)
#pragma unroll 1
  for (int q = lane; q < D; q += WARP) out[q] = src[q];
  if (lane == 0) {
    a.dsi[b] = d_new;
    a.dsi[LB + b] = st;
    a.dsi[2 * LB + b] = iters;
    a.dsi[3 * LB + b] += prune ? 1 : 0;
    a.dsi[4 * LB + b] += memo && !has ? 1 : 0;
  }
}

}  // namespace

// Makes `device` the current device of this library's CUDA runtime
// (built static, its own beside PyTorch's): the wrapper calls it before
// each launch, so that a launch for a shard on card i runs on card i.
// Returns the cudaSetDevice error (0 = set).
extern "C" int set_launch_device(int device) {
  return static_cast<int>(cudaSetDevice(device));
}

// Launches one iteration on `stream` with the plan of
// ops/sweep_generic.py::advance_launch_plan (warps a block, grid),
// updating the carry in place.  `lanes` (L distinct lanes in [0, B),
// checked by the caller) names the lanes run; `nxt` and `ok` hold one step
// row a run lane; `state_out` receives each run lane's state after the
// iteration.  Returns cudaErrorInvalidValue
// for arguments or a plan it does not take (nothing is launched), else
// cudaGetLastError() (0 = the launch was accepted).
extern "C" int sweep_advance_launch(
    const int32_t* prec, const int32_t* valid, const int32_t* nreq,
    const int32_t* row, const int32_t* lanes, const int32_t* nxt,
    const uint8_t* ok, int32_t* taken, int32_t* chosen, int32_t* states,
    int32_t* dsi, int32_t* keys, int32_t* occ, int32_t* state_out, int B,
    int R, int N, int W, int D, int slots, int budget, int L, int warps,
    int grid, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (N < 1 || N > WARP * MAX_W || W != (N + 31) / WARP || D < 1 ||
      B < 0 || R < 1 || slots < 0 || (slots & (slots - 1)) != 0 ||
      lanes == nullptr || state_out == nullptr || L < 0 || L > B ||
      warps < 1 || warps > MAX_WARPS || grid != (L + warps - 1) / warps)
    return invalid;
  if (L == 0) return 0;
  const Args a{prec,  valid, nreq,   row,   lanes, nxt,  ok,    taken,
               chosen, states, dsi,  keys,  occ,   state_out, B,  L,
               N,     W,     D,      slots, budget, warps};
  sweep_advance_kernel<<<grid, warps * WARP, 0,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
