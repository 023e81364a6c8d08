// stepper_sweep.cu — one chunk of the lane-compacting stepper's DFS in its
// sweep regime.
//
// Replaces: qsm_tpu/ops/jax_kernel.py::build_stepper → run_one (the
// while-loop body at :281-401) when the spec has no state bound (:190-193,
// :303-309): a vector spec whose packed domain is too large for a step
// table.  Every iteration evaluates every op's postcondition from the
// lane's current D-word state, takes the first candidate above the sibling
// cursor, computes its child state, probes the memo with the child
// configuration (the taken words with the op's bit, then the D child
// words), and descends, prunes or backtracks; on exhaustion it inserts the
// current configuration.  There is no out-of-bounds state here (run_one's
// oob is false in this regime).  As in run_one, the child of op 0 is
// computed even when no op is a candidate; it never acts.
//
// The model's step is code in this file, a template instantiation a kind
// (so an iteration carries no branch on the kind), with up to three
// integer parameters (ops/sweep_kernel.py, Spec.sweep_kernel): 1 queue and
// 3 stack (state [length, slot0..slot_{cap-1}], p0 = capacity, p1 =
// values; the queue pops slot 0, the stack slot length-1), 2 kv and
// multireg (one value per key, p1 = values), 4 multicas (p1 = values), 5
// txn (p1 = values; copy reads src and writes dst), 6 a random vector
// spec (p0..p2 = the tables' command, arg and resp extents; `data` holds
// the element bounds, the ok table over (element 0, op), then each
// element's transition table).  Each step is the JAX package's step_jax:
// // and % round toward minus infinity, and a dynamic index into the
// state counts a negative value from the end and is then clamped, as jnp
// indexing does.
//
// Layouts: cmd/arg/resp [R][N], prec [R][W][N], valid [R][W], nreq [R],
// read through the lane's `row`; taken [N][B], chosen [N+1][B], dsi [5][B]
// lane-minor; states [B][N+1][D] and the memo ([B][slots][W+D] keys,
// [B][slots] occupancy) lane-major.  The carry is updated in place.
//
// The design: one warp owns one lane.  Thread t owns ops t, t+32, t+64,
// t+96; their predecessor words and (cmd, arg, resp) sit in column t of
// the warp's shared memory ([W][W+3][32], loaded once a launch, read only
// by thread t: registers are left to the model's step, so that no
// instantiation spills); the taken words, depth and counters are
// warp-uniform and kept by every thread.  Each warp also keeps its lane's
// state stack [N+1][D], its chosen stack and a D-word child in shared
// memory for the whole chunk.  An iteration: every thread evaluates its
// ops' postconditions against the shared current state, one ballot a
// bitmask word finds the candidates, the thread that owns the chosen op
// writes the child into the shared child words, and after a warp barrier
// every thread hashes the key.  A memo probe compares word t of the key
// in thread t (kw = W + D <= 32), thread 0 also the occupancy; an insert
// writes each word from the thread that compares it, so a probe sees the
// lane's earlier inserts without a fence.  A descent copies the child
// into the stack, word i by thread i, and a warp barrier ends the
// iteration.  Stack entries of `chosen` are written by every thread with
// the same value.
//
// What bounds it on an H100: each lane is one serial chain of dependent
// steps, so latency, not bytes or operations: the shared-memory reads of
// the state per op, the ballots, the owner's serial child of D words, two
// warp barriers, and with the memo one probe in device memory.
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
constexpr int MAX_KW = 32;     // W + D key words, one a thread
constexpr int MAX_WARPS = 16;  // warps a block (sweep_kernel.py)
constexpr int STATIC_SMEM_MAX = 48 * 1024;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr uint32_t HASH_SEED = 0x9E3779B9u;

enum Kind { QUEUE = 1, KV = 2, STACK = 3, MULTICAS = 4, TXN = 5, RANDOM = 6 };

struct Args {
  const int32_t *cmd, *arg, *resp, *prec, *valid, *nreq, *data, *row;
  int32_t *taken, *chosen, *states, *dsi, *keys, *occ;
  int B, N, D, slots, chunk, budget, p0, p1, p2, warps;
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

// the element a dynamic index reads in an axis of n (jnp indexing)
__device__ __forceinline__ int jidx(int i, int n) {
  i = i < 0 ? i + n : i;
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// Python's // and % (toward minus infinity), as jnp's on int32
__device__ __forceinline__ int floor_div(int x, int d) {
  const int q = x / d;
  return (x % d != 0 && ((x < 0) != (d < 0))) ? q - 1 : q;
}

__device__ __forceinline__ int floor_mod(int x, int d) {
  const int r = x % d;
  return (r != 0 && ((r < 0) != (d < 0))) ? r + d : r;
}

// entry (s, c, a, r) of the random-vector table of `b` states that
// starts at word `at` of `data`
__device__ __forceinline__ int table_at(const Args& m, int at, int b, int s,
                                        int c, int a, int r) {
  return m.data[at + ((jidx(s, b) * m.p0 + jidx(c, m.p0)) * m.p1 +
                      jidx(a, m.p1)) * m.p2 + jidx(r, m.p2)];
}

// the postcondition of op (c, a, r) from the state `st` of D words, for
// the model kind K
template <int K>
__device__ __forceinline__ bool op_ok(const Args& m, const int32_t* st,
                                      int c, int a, int r) {
  const int D = m.D;
  if constexpr (K == QUEUE || K == STACK) {
    const int cap = m.p0, len = st[0];
    if (c == 0) return len == cap ? r == 1 : r == 0;
    if (len == 0) return r == m.p1;
    const int top = K == QUEUE ? 0 : jidx(len - 1 > 0 ? len - 1 : 0, cap);
    return r == st[1 + top];
  } else if constexpr (K == KV || K == TXN) {
    return c == 0 ? r == st[jidx(a, D)] : r == 0;
  } else if constexpr (K == MULTICAS) {
    const int nv = m.p1;
    const int cell = c == 0 ? a : floor_div(a, c == 1 ? nv : nv * nv);
    const int cur = st[jidx(cell, D)];
    if (c == 0) return r == cur;
    if (c == 1) return r == 0;
    return r == (cur == floor_mod(floor_div(a, nv), nv) ? 1 : 0);
  } else {  // RANDOM
    return table_at(m, D, m.data[0], st[0], c, a, r) != 0;
  }
}

// the child state of op (c, a, r) from `st`, written to `out` (D words)
template <int K>
__device__ __forceinline__ void op_child(const Args& m, const int32_t* st,
                                         int c, int a, int r, int32_t* out) {
  const int D = m.D;
  if constexpr (K == QUEUE || K == STACK) {
    const int cap = m.p0, len = st[0];
    const bool full = len == cap, empty = len == 0;
    if (c == 0) {
      out[0] = len + (full ? 0 : 1);
      for (int i = 0; i < cap; ++i)
        out[1 + i] = i == len && !full ? a : st[1 + i];
    } else if (K == QUEUE) {
      out[0] = len - (empty ? 0 : 1);
      for (int i = 0; i < cap; ++i)
        out[1 + i] = empty ? st[1 + i] : (i == cap - 1 ? 0 : st[2 + i]);
    } else {
      out[0] = len - (empty ? 0 : 1);
      for (int i = 0; i < cap; ++i)
        out[1 + i] = i == len - 1 && !empty ? 0 : st[1 + i];
    }
  } else if constexpr (K == KV) {
    const int key = c == 0 ? a : floor_div(a, m.p1);
    const int value = floor_mod(a, m.p1);
    for (int i = 0; i < D; ++i) out[i] = c != 0 && i == key ? value : st[i];
  } else if constexpr (K == MULTICAS) {
    const int nv = m.p1;
    const int cell = c == 0 ? a : floor_div(a, c == 1 ? nv : nv * nv);
    const int cur = st[jidx(cell, D)], val = floor_mod(a, nv);
    const bool succ = cur == floor_mod(floor_div(a, nv), nv);
    const bool write = c != 0 && (c == 1 || succ);
    const int target = c == 1 ? val : (succ ? val : cur);
    for (int i = 0; i < D; ++i) out[i] = write && i == cell ? target : st[i];
  } else if constexpr (K == TXN) {
    const int nv = m.p1, nc = D - 1;
    const int src = floor_div(a, nc), off = floor_mod(a, nc);
    const int dst = off >= src ? off + 1 : off;
    const int cell = c == 0 ? a : (c == 1 ? floor_div(a, nv) : dst);
    const int value = c == 1 ? floor_mod(a, nv) : st[jidx(src, D)];
    for (int i = 0; i < D; ++i) out[i] = c != 0 && i == cell ? value : st[i];
  } else {  // RANDOM: element i by its own table
    const int car = m.p0 * m.p1 * m.p2;
    int at = D + m.data[0] * car;
    for (int i = 0; i < D; ++i) {
      const int b = m.data[i];
      out[i] = table_at(m, at, b, st[i], c, a, r);
      at += b * car;
    }
  }
}

template <int W, bool kMemo, int K>
__global__ void __launch_bounds__(MAX_WARPS* WARP)
    stepper_sweep_kernel(const Args a) {
  extern __shared__ int32_t smem[];
  const int N = a.N, D = a.D, kw = W + D;
  const int lane = threadIdx.x % WARP;
  const int warp = threadIdx.x / WARP;
  const int b = blockIdx.x * a.warps + warp;
  if (b >= a.B) return;
  const size_t LB = static_cast<size_t>(a.B);
  if (a.dsi[LB + b] != RUNNING) return;  // decided: nothing to do
  const size_t r = static_cast<size_t>(a.row[b]);
  const uint32_t lbit = 1u << lane;

  // this lane's stacks and child, and this thread's ops j = lane + 32 k
  // (their predecessor words, cmd, arg and resp, F words an op) in the
  // thread's own column of the warp's shared memory, on chip for the
  // whole chunk
  constexpr int F = W + 3;
  const size_t stack_words = static_cast<size_t>(N + 1) * D;
  int32_t* states = smem + warp * ((N + 1) * (D + 1) + D + W * F * WARP);
  int32_t* chosen = states + stack_words;
  int32_t* child = chosen + (N + 1);
  int32_t* mine = child + D + lane;  // word f of op k: mine[(k*F + f)*WARP]
  int32_t* gstates = a.states + b * stack_words;
  for (int k = lane; k < static_cast<int>(stack_words); k += WARP)
    states[k] = gstates[k];
  for (int k = lane; k <= N; k += WARP) chosen[k] = a.chosen[k * LB + b];
  uint32_t valid[W], tw[W];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const int j = lane + WARP * k;
    const bool in = j < N;
    int32_t* op = mine + k * F * WARP;
#pragma unroll
    for (int w = 0; w < W; ++w)
      op[w * WARP] = in ? a.prec[(r * W + w) * N + j] : 0;
    op[W * WARP] = in ? a.cmd[r * N + j] : 0;
    op[(W + 1) * WARP] = in ? a.arg[r * N + j] : 0;
    op[(W + 2) * WARP] = in ? a.resp[r * N + j] : 0;
    valid[k] = static_cast<uint32_t>(a.valid[r * W + k]);
    tw[k] = __ballot_sync(FULL, in && a.taken[j * LB + b] != 0);
  }
  __syncwarp();

  int32_t* keys =
      kMemo ? a.keys + static_cast<size_t>(b) * a.slots * kw : nullptr;
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
    const int32_t* st = states + d * D;
    const int cur = chosen[d];
    uint32_t uw[W];
#pragma unroll
    for (int w = 0; w < W; ++w) uw[w] = valid[w] & ~tw[w];
    // candidates: untaken, no untaken op precedes them, ok from the
    // current state, after the cursor; one ballot a word
    uint32_t cw[W];
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const int32_t* op = mine + k * F * WARP;
      uint32_t pre = 0;
#pragma unroll
      for (int w = 0; w < W; ++w)
        pre |= static_cast<uint32_t>(op[w * WARP]) & uw[w];
      const bool live = (uw[k] & lbit) != 0 && pre == 0 &&
                        lane + WARP * k > cur;
      cw[k] = __ballot_sync(
          FULL, live && op_ok<K>(a, st, op[W * WARP], op[(W + 1) * WARP],
                                 op[(W + 2) * WARP]));
    }
    int j = -1;
#pragma unroll
    for (int k = 0; k < W; ++k)
      if (j < 0 && cw[k] != 0)
        j = WARP * k + __ffs(static_cast<int>(cw[k])) - 1;
    const bool has = j >= 0;
    if (!has) j = 0;
    const int jw = j >> 5;
    const uint32_t jbit = 1u << (j & 31);
    // the owner of op j writes its child, from its own column
    if (lane == (j & 31)) {
      const int32_t* op = mine + jw * F * WARP;
      op_child<K>(a, st, op[W * WARP], op[(W + 1) * WARP],
                  op[(W + 2) * WARP], child);
    }
    __syncwarp();
    const bool success = has && d + 1 == n_req;

    bool prune = false;
    if (kMemo && has && !success) {
      // the child configuration already proven failed?  Thread t < kw
      // compares key word t, thread 0 also the occupancy
      uint32_t h = HASH_SEED;
#pragma unroll
      for (int w = 0; w < W; ++w) h = mix(h, tw[w] | (w == jw ? jbit : 0u));
      for (int i = 0; i < D; ++i) h = mix(h, static_cast<uint32_t>(child[i]));
      const uint32_t sl = h & mask;
      bool eq = true;
      if (lane < kw) {
        const uint32_t want =
            lane < W ? (pick(tw, lane) | (lane == jw ? jbit : 0u))
                     : static_cast<uint32_t>(child[lane - W]);
        eq = static_cast<uint32_t>(keys[sl * kw + lane]) == want;
      }
      if (lane == 0) eq = eq && occ[sl] == 1;
      prune = __ballot_sync(FULL, eq) == FULL;
    }
    const bool descend = has && !prune;
    const int d_back = d > 0 ? d - 1 : 0;
    const int prev = max(chosen[d_back], 0);

    if (kMemo && !has) {
      // exhausted: the current configuration (taken before this step, the
      // state as it is) is proven non-linearizable-from
      uint32_t h = HASH_SEED;
#pragma unroll
      for (int w = 0; w < W; ++w) h = mix(h, tw[w]);
      for (int i = 0; i < D; ++i) h = mix(h, static_cast<uint32_t>(st[i]));
      const uint32_t sl = h & mask;
      if (lane < kw)
        keys[sl * kw + lane] = lane < W ? static_cast<int32_t>(pick(tw, lane))
                                        : st[lane - W];
      if (lane == 0) occ[sl] = 1;
      inserts += 1;
    }
    if (descend) {
      chosen[d] = j;
      if (d + 1 <= N) {
        chosen[d + 1] = -1;
        for (int i = lane; i < D; i += WARP) states[(d + 1) * D + i] = child[i];
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
    int s = success ? SUCCESS : (!has && d_old == 0 ? FAILURE : RUNNING);
    if (s == RUNNING && iters >= a.budget) s = BUDGET;
    status = s;
    __syncwarp();  // the child and the stack, before the next reads
  }

  for (int k = lane; k < static_cast<int>(stack_words); k += WARP)
    gstates[k] = states[k];
  for (int k = lane; k <= N; k += WARP) a.chosen[k * LB + b] = chosen[k];
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
Kernel pick_kind(int kind) {
  switch (kind) {
    case QUEUE: return stepper_sweep_kernel<W, kMemo, QUEUE>;
    case KV: return stepper_sweep_kernel<W, kMemo, KV>;
    case STACK: return stepper_sweep_kernel<W, kMemo, STACK>;
    case MULTICAS: return stepper_sweep_kernel<W, kMemo, MULTICAS>;
    case TXN: return stepper_sweep_kernel<W, kMemo, TXN>;
    default: return stepper_sweep_kernel<W, kMemo, RANDOM>;
  }
}

template <int W>
Kernel pick_memo(bool memo, int kind) {
  return memo ? pick_kind<W, true>(kind) : pick_kind<W, false>(kind);
}

// one instantiation a (taken words, memo on or off, model kind)
Kernel pick_kernel(int W, bool memo, int kind) {
  switch (W) {
    case 1: return pick_memo<1>(memo, kind);
    case 2: return pick_memo<2>(memo, kind);
    case 3: return pick_memo<3>(memo, kind);
    default: return pick_memo<4>(memo, kind);
  }
}

// the model's parameters against the state width
bool model_ok(int kind, int D, int p0, int p1, int p2) {
  switch (kind) {
    case QUEUE:
    case STACK: return p0 >= 1 && D == p0 + 1 && p1 >= 1;
    case KV:
    case MULTICAS: return D == p0 && p1 >= 1;
    case TXN: return D == p0 && D >= 2 && p1 >= 1;
    case RANDOM: return p0 >= 1 && p1 >= 1 && p2 >= 1;
    default: return false;
  }
}

}  // namespace

// Launches one chunk on `stream` with the plan of
// ops/sweep_kernel.py::sweep_launch_plan (warps a block, grid, shared
// bytes), updating the carry in place.  `data` is the random-vector
// model's tables (read only for kind 6).  Returns cudaErrorInvalidValue
// for arguments or a plan it does not take (nothing is launched), else
// cudaGetLastError() (0 = the launch was accepted).
extern "C" int stepper_sweep_launch(
    const int32_t* cmd, const int32_t* arg, const int32_t* resp,
    const int32_t* prec, const int32_t* valid, const int32_t* nreq,
    const int32_t* data, const int32_t* row, int32_t* taken, int32_t* chosen,
    int32_t* states, int32_t* dsi, int32_t* keys, int32_t* occ, int B, int R,
    int N, int W, int D, int slots, int chunk, int budget, int kind, int p0,
    int p1, int p2, int warps, int grid, int smem_bytes, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (N < 1 || N > 32 * MAX_W || W != (N + 31) / 32 || D < 1 ||
      W + D > MAX_KW || B < 0 || R < 1 || slots < 0 ||
      (slots & (slots - 1)) != 0 || chunk < 0 || !model_ok(kind, D, p0, p1, p2))
    return invalid;
  // the plan: a grid of `warps`-warp blocks over every lane, each warp's
  // state stack, chosen stack and child in shared memory, within what the
  // device grants a block
  const long long want =
      4LL * warps * ((N + 1LL) * (D + 1) + D + W * (W + 3) * WARP);
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
  const Kernel kern = pick_kernel(W, slots > 0, kind);
  if (smem_bytes > STATIC_SMEM_MAX) {
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const Args a{cmd,   arg,   resp,  prec,  valid, nreq,  data, row,
               taken, chosen, states, dsi, keys,  occ,   B,    N,
               D,     slots, chunk, budget, p0,   p1,    p2,   warps};
  kern<<<grid, warps * WARP, smem_bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
