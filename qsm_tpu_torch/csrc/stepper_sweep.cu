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
// oob is false in this regime).  As in run_one, when no op is a candidate
// the child of op 0 is computed and never acts; here it is not computed.
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
// [B][slots] occupancy) lane-major.  The carry is updated in place.  An
// optional list of L lanes (`lanes`, each at most once) names the lanes
// the launch runs, warp w running lane lanes[w]; without it warp w runs
// lane w of all B.  Lanes not RUNNING are left as they are either way.
//
// The design: one warp owns one lane, and the lane's current state lives
// in the warp's registers, thread i < D holding word i.  Thread t owns ops
// t, t+32, t+64, t+96 and keeps in registers, from launch entry, their
// predecessor words and what the kind makes of each op's (cmd, arg, resp)
// once: the lane that holds the state word it reads, what its
// postcondition compares, and the element and value it writes (every
// division by a run-time parameter happens here, once an op).  An
// iteration:
//  - each thread fetches its ops' state words with one __shfl_sync each
//    (a source lane per thread; the queue and stack fetch the length and
//    the top slot, the random spec word 0, as broadcasts), evaluates their
//    postconditions, and one ballot a bitmask word finds the candidates;
//  - the chosen op's write is broadcast from its owner by __shfl_sync and
//    thread i computes child word i itself (the queue's pop takes its
//    neighbour's word by __shfl_down_sync);
//  - the memo hash is make_hash_slot's chain round for round: the taken
//    words from registers, state word i by a broadcast __shfl_sync from
//    thread i, each group of four fetched while the previous four rounds
//    run.  The kernel is instantiated for the state widths of the
//    registry's sweep models (8, 9, 16), where the rounds unroll into one
//    straight chain; any other width hashes in a loop over the groups;
//  - the probe first reads a one-byte tag of the slot from shared memory
//    (bits of the hash that the slot index does not use; 0 = empty), built
//    at launch entry from the lane's keys and occupancy and updated on
//    every insert.  A tag that differs is a certain miss and skips device
//    memory; a tag that matches compares the key in device memory, key
//    word W + t in thread t, word t too in thread t < W.  The memo in
//    device memory stays the single truth (same slots, same overwrite);
//  - the hash of each level's configuration is kept in shared memory when
//    the level is entered (it is the probe's), so the insert on
//    exhaustion reuses it instead of hashing again (0: not known, as at
//    launch entry: hash);
//  - a descent stores thread i's child word in the lane's state stack in
//    shared memory and a backtrack loads it back (fetched at the top of
//    the iteration, off the chain).
// Thread t alone reads and writes state word t of the stack and key words
// t and W + t of the memo; every thread writes the same value to an entry
// of the chosen stack, a level's hash and a tag, and reads only its own
// write.  So the loop has no warp barrier, only the shuffles and ballots.
// The launch takes the running lanes alone when the caller lists them,
// spread evenly over the SMs (ops/sweep_kernel.py::sweep_launch_plan).
//
// What bounds it on an H100 (chip_smoke.py --ablate-sweep, kv16): the
// latency of one lane's chain, an iteration of ≈ 460 cycles memo off and
// ≈ 1,430 with the memo at one warp an SM.  The memo's part is the hash:
// W + D dependent rounds of multiply-xorshift that no layout shortens
// (one more hash a probe costs ≈ 430 cycles an iteration, the loop in
// place of the unrolled chain ≈ 170); a key compare in device memory
// after a matching tag costs little (one more dependent load ≈ 40: the
// keys a lane probes are mostly in L2).  With ≈ 15–16 running warps an
// SM the issue of those instructions binds as well (≈ 2,040 cycles an
// iteration with the memo, ≈ 930 without).
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
constexpr int MAX_KW = 32;     // W + D key words: state word i in thread i
constexpr int MAX_WARPS = 16;  // warps a block (sweep_kernel.py)
constexpr int STATIC_SMEM_MAX = 48 * 1024;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr uint32_t HASH_SEED = 0x9E3779B9u;

enum Kind { QUEUE = 1, KV = 2, STACK = 3, MULTICAS = 4, TXN = 5, RANDOM = 6 };

struct Args {
  const int32_t *cmd, *arg, *resp, *prec, *valid, *nreq, *data, *row,
      *lanes;
  int32_t *taken, *chosen, *states, *dsi, *keys, *occ;
  unsigned long long* stats;
  int B, L, N, D, slots, chunk, budget, p0, p1, p2, warps, warp_words;
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

// the memo filter's tag of a key of hash h: its top byte, 0 kept for an
// empty slot (the slot index takes the low bits)
__device__ __forceinline__ uint8_t tag_of(uint32_t h) {
  const uint32_t t = h >> 24;
  return static_cast<uint8_t>(t != 0 ? t : 1);
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

// The hash chain continued over the D state words that the warp holds one
// a thread (`x` in thread i is word i), each fetched by a broadcast
// shuffle: the shuffles of a group of four words are issued, whatever the
// group, while the previous group's four rounds run; the last D % 4 words
// come after the groups.  DH > 0: the kernel was instantiated for D = DH,
// and the rounds unroll into one straight chain; DH = 0: a loop over the
// groups.
template <int DH>
__device__ __forceinline__ uint32_t mix_words(uint32_t h, int32_t x, int D) {
  if constexpr (DH > 0) D = DH;
  const uint32_t u = static_cast<uint32_t>(x);
  uint32_t nx[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) nx[q] = __shfl_sync(FULL, u, q);
  int i = 0;
  for (; i + 4 <= D; i += 4) {
    uint32_t cw[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      cw[q] = nx[q];
      nx[q] = __shfl_sync(FULL, u, (i + 4 + q) & (WARP - 1));
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) h = mix(h, cw[q]);
  }
#pragma unroll
  for (int q = 0; q < 3; ++q)
    if (i + q < D) h = mix(h, nx[q]);
  return h;
}

// What the kind makes of one op at launch entry.  `rd`: the lane whose
// state word the op reads (KV, MULTICAS, TXN); `r`: its response; `mode`:
// which case of the step it is; `x`, `y`, `e`: what it writes or compares
// (by kind, below).
struct Op {
  int rd, r, mode, x, y, e;
};

// What every thread reads of the state in an iteration, the same for all
// ops: the length and the top slot (QUEUE, STACK), word 0 (RANDOM).
struct Uni {
  int len, top;
};

template <int K>
__device__ __forceinline__ Op make_op(const Args& m, int c, int a, int r) {
  const int D = m.D;
  Op o{0, r, c == 0 ? 0 : (c == 1 ? 1 : 2), -1, 0, 0};
  if constexpr (K == QUEUE || K == STACK) {
    o.x = c;  // the write is the command and the argument
    o.y = a;
  } else if constexpr (K == KV) {
    // GET reads its key; PUT writes floor_mod(a, p1) to floor_div(a, p1)
    o.rd = c == 0 ? jidx(a, D) : 0;
    o.x = c == 0 ? -1 : floor_div(a, m.p1);
    o.y = floor_mod(a, m.p1);
  } else if constexpr (K == MULTICAS) {
    // read, write (cell a // nv), cas (cell a // nv**2, expecting
    // (a // nv) % nv): the cell is read by every case
    const int nv = m.p1;
    const int cell = c == 0 ? a : floor_div(a, c == 1 ? nv : nv * nv);
    o.rd = jidx(cell, D);
    o.x = cell;
    o.y = floor_mod(a, nv);
    o.e = floor_mod(floor_div(a, nv), nv);
  } else if constexpr (K == TXN) {
    // read a; write (a // nv) := a % nv; copy src := dst, the value read
    const int nv = m.p1, nc = D - 1;
    const int src = floor_div(a, nc), off = floor_mod(a, nc);
    const int dst = off >= src ? off + 1 : off;
    o.rd = c == 0 ? jidx(a, D) : (c == 1 ? 0 : jidx(src, D));
    o.x = c == 0 ? -1 : (c == 1 ? floor_div(a, nv) : dst);
    o.y = floor_mod(a, nv);
  } else {  // RANDOM: the offset of (c, a, r) in a table over one element
    o.x = (jidx(c, m.p0) * m.p1 + jidx(a, m.p1)) * m.p2 + jidx(r, m.p2);
  }
  return o;
}

// the uniform reads of the state `s` (word i in thread i)
template <int K>
__device__ __forceinline__ Uni uniform_reads(const Args& m, int32_t s) {
  Uni u{0, 0};
  if constexpr (K == QUEUE || K == STACK || K == RANDOM)
    u.len = __shfl_sync(FULL, s, 0);
  if constexpr (K == QUEUE) {
    u.top = __shfl_sync(FULL, s, 1);
  } else if constexpr (K == STACK) {
    const int len = u.len;
    u.top = __shfl_sync(FULL, s, 1 + jidx(len - 1 > 0 ? len - 1 : 0, m.p0));
  }
  return u;
}

// the postcondition of op `o`, `v` the state word it read
template <int K>
__device__ __forceinline__ bool op_ok(const Args& m, const Op& o, int v,
                                      const Uni& u) {
  if constexpr (K == QUEUE || K == STACK) {
    if (o.mode == 0) return u.len == m.p0 ? o.r == 1 : o.r == 0;
    return u.len == 0 ? o.r == m.p1 : o.r == u.top;
  } else if constexpr (K == KV || K == TXN) {
    return o.mode == 0 ? o.r == v : o.r == 0;
  } else if constexpr (K == MULTICAS) {
    if (o.mode == 0) return o.r == v;
    if (o.mode == 1) return o.r == 0;
    return o.r == (v == o.e ? 1 : 0);
  } else {  // RANDOM: the ok table over (element 0, op)
    return m.data[m.D + jidx(u.len, m.data[0]) * (m.p0 * m.p1 * m.p2) +
                  o.x] != 0;
  }
}

// the write of op `o` that its owner broadcasts: (x, y) = (element,
// value), -1 = none; QUEUE, STACK: (command, argument); RANDOM: x alone
template <int K>
__device__ __forceinline__ void op_write(const Op& o, int v, int& x,
                                         int& y) {
  x = o.x;
  y = o.y;
  if constexpr (K == MULTICAS) {
    // a write always, a cas when the cell holds what it expects
    x = o.mode == 1 || (o.mode == 2 && v == o.e) ? o.x : -1;
  } else if constexpr (K == TXN) {
    if (o.mode == 2) y = v;  // the copy's value, read from src
  }
}

// child word `i` of state word `s` (and its neighbour `s_next`, word
// i + 1) under the chosen op's write (x, y)
template <int K>
__device__ __forceinline__ int32_t child_word(const Args& m, int i,
                                              int32_t s, int32_t s_next,
                                              const Uni& u, int x, int y,
                                              int at, int bound) {
  if constexpr (K == QUEUE || K == STACK) {
    const int cap = m.p0, len = u.len;
    const bool full = len == cap, empty = len == 0;
    if (x == 0) {  // push
      if (i == 0) return len + (full ? 0 : 1);
      return i - 1 == len && !full ? y : s;
    }
    if (i == 0) return len - (empty ? 0 : 1);
    if (K == QUEUE) return empty ? s : (i - 1 == cap - 1 ? 0 : s_next);
    return i - 1 == len - 1 && !empty ? 0 : s;
  } else if constexpr (K == RANDOM) {
    // element i by its own table, which starts at word `at` of `data`
    return m.data[at + jidx(s, bound) * (m.p0 * m.p1 * m.p2) + x];
  } else {
    return i == x ? y : s;
  }
}

template <int W, bool kMemo, int K, int DH>
__global__ void __launch_bounds__(MAX_WARPS* WARP, W <= 2 ? 2 : 1)
    stepper_sweep_kernel(const Args a) {
  extern __shared__ int32_t smem[];
  const int N = a.N, D = a.D, kw = W + D;
  const int lane = threadIdx.x % WARP;
  const int warp = threadIdx.x / WARP;
  const int w_id = blockIdx.x * a.warps + warp;
  if (w_id >= a.L) return;
  const int b = a.lanes != nullptr ? a.lanes[w_id] : w_id;
  const size_t LB = static_cast<size_t>(a.B);
  if (a.dsi[LB + b] != RUNNING) return;  // decided: nothing to do
  const size_t r = static_cast<size_t>(a.row[b]);
  const uint32_t lbit = 1u << lane;
  const bool holds = lane < D;  // this thread holds a state word

  // this lane's state stack, chosen stack, and with the memo the hash of
  // each level's configuration and the memo tags, in the warp's shared
  // memory for the whole chunk
  const int stack_words = (N + 1) * D;
  int32_t* states = smem + warp * a.warp_words;
  int32_t* chosen = states + stack_words;
  uint32_t* hlev = reinterpret_cast<uint32_t*>(chosen + N + 1);
  uint8_t* tags = reinterpret_cast<uint8_t*>(hlev + N + 1);
  int32_t* gstates = a.states + static_cast<size_t>(b) * stack_words;
  for (int k = lane; k < stack_words; k += WARP) states[k] = gstates[k];
  for (int k = lane; k <= N; k += WARP) chosen[k] = a.chosen[k * LB + b];

  // this thread's ops j = lane + 32 k, in registers
  uint32_t pre[W][W], valid[W], tw[W];
  Op op[W];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const int j = lane + WARP * k;
    const bool in = j < N;
#pragma unroll
    for (int w = 0; w < W; ++w)
      pre[k][w] = in ? static_cast<uint32_t>(a.prec[(r * W + w) * N + j]) : 0;
    op[k] = make_op<K>(a, in ? a.cmd[r * N + j] : 0,
                       in ? a.arg[r * N + j] : 0, in ? a.resp[r * N + j] : 0);
    valid[k] = static_cast<uint32_t>(a.valid[r * W + k]);
    tw[k] = __ballot_sync(FULL, in && a.taken[j * LB + b] != 0);
  }
  // RANDOM: where this thread's element's table starts, and its bound
  int at = 0, bound = 1;
  if constexpr (K == RANDOM) {
    const int car = a.p0 * a.p1 * a.p2;
    at = D + a.data[0] * car;
    for (int i = 0; i < lane && i < D; ++i) at += a.data[i] * car;
    bound = holds ? a.data[lane] : 1;
  }

  int32_t* keys =
      kMemo ? a.keys + static_cast<size_t>(b) * a.slots * kw : nullptr;
  int32_t* occ = kMemo ? a.occ + static_cast<size_t>(b) * a.slots : nullptr;
  const uint32_t mask = static_cast<uint32_t>(a.slots - 1);
  if constexpr (kMemo) {
    // no level's hash known yet (0: compute it)
    for (int k = lane; k <= N; k += WARP) hlev[k] = 0;
    // the filter of the memo as it enters: each occupied slot's tag
    for (int sl = lane; sl < a.slots; sl += WARP) {
      uint8_t t = 0;
      if (occ[sl] == 1) {
        const int32_t* key = keys + static_cast<size_t>(sl) * kw;
        uint32_t h = HASH_SEED;
        for (int w = 0; w < kw; ++w)
          h = mix(h, static_cast<uint32_t>(key[w]));
        t = tag_of(h);
      }
      tags[sl] = t;
    }
  }
  __syncwarp();

  const int n_req = a.nreq[r];
  int d = a.dsi[b];
  int status = RUNNING;
  int iters = a.dsi[2 * LB + b];
  int prunes = a.dsi[3 * LB + b];
  int inserts = a.dsi[4 * LB + b];
  unsigned long long probes = 0, passes = 0;
  const int start = iters;
  // the current state (a thread past D holds a copy of word D - 1)
  int32_t s = states[d * D + min(lane, D - 1)];
  int cur = chosen[d];  // the sibling cursor
  while (status == RUNNING && iters - start < a.chunk) {
    // what a backtrack restores, fetched ahead
    const int d_back = d > 0 ? d - 1 : 0;
    const int32_t s_back = states[d_back * D + min(lane, D - 1)];
    const int ch_back = chosen[d_back];
    const uint32_t h_cur = kMemo ? hlev[d] : 0u;

    const Uni u = uniform_reads<K>(a, s);
    uint32_t uw[W];
#pragma unroll
    for (int w = 0; w < W; ++w) uw[w] = valid[w] & ~tw[w];
    // candidates: untaken, no untaken op precedes them, ok from the
    // current state, after the cursor; one ballot a word
    int v[W];
    uint32_t cw[W];
#pragma unroll
    for (int k = 0; k < W; ++k) {
      v[k] = 0;
      if constexpr (K == KV || K == MULTICAS || K == TXN)
        v[k] = __shfl_sync(FULL, s, op[k].rd);
      uint32_t blocked = 0;
#pragma unroll
      for (int w = 0; w < W; ++w) blocked |= pre[k][w] & uw[w];
      const bool live = (uw[k] & lbit) != 0 && blocked == 0 &&
                        lane + WARP * k > cur;
      cw[k] = __ballot_sync(FULL, live && op_ok<K>(a, op[k], v[k], u));
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
    const bool success = has && d + 1 == n_req;

    int32_t child = s;
    bool prune = false;
    uint32_t h_child = 0;  // the child configuration's hash, if probed
    if (has) {
      // the chosen op's write from its owner; child word i in thread i
      int x, y;
      op_write<K>(pick(op, jw), pick(v, jw), x, y);
      x = __shfl_sync(FULL, x, j & 31);
      if constexpr (K != RANDOM) y = __shfl_sync(FULL, y, j & 31);
      int32_t s_next = s;
      if constexpr (K == QUEUE) s_next = __shfl_down_sync(FULL, s, 1);
      if (holds)
        child = child_word<K>(a, lane, s, s_next, u, x, y, at, bound);
      if (kMemo && !success) {
        // the child configuration already proven failed?
        uint32_t h = HASH_SEED;
#pragma unroll
        for (int w = 0; w < W; ++w)
          h = mix(h, tw[w] | (w == jw ? jbit : 0u));
        h = mix_words<DH>(h, child, D);
        h_child = h;
        const uint32_t sl = h & mask;
        probes += 1;
        if (tags[sl] == tag_of(h)) {
          passes += 1;
          const int32_t* key = keys + static_cast<size_t>(sl) * kw;
          bool eq = !holds || key[W + lane] == child;
          if (lane < W)
            eq = eq && static_cast<uint32_t>(key[lane]) ==
                           (pick(tw, lane) | (lane == jw ? jbit : 0u));
          prune = __ballot_sync(FULL, eq) == FULL;
        }
      }
    } else if (kMemo) {
      // exhausted: the current configuration (taken before this step, the
      // state as it is) is proven non-linearizable-from; its hash is the
      // probe's when this level was entered in this launch
      uint32_t h = h_cur;
      if (h == 0) {
        h = HASH_SEED;
#pragma unroll
        for (int w = 0; w < W; ++w) h = mix(h, tw[w]);
        h = mix_words<DH>(h, s, D);
      }
      const uint32_t sl = h & mask;
      int32_t* key = keys + static_cast<size_t>(sl) * kw;
      if (holds) key[W + lane] = s;
      if (lane < W) key[lane] = static_cast<int32_t>(pick(tw, lane));
      if (lane == 0) occ[sl] = 1;
      tags[sl] = tag_of(h);
      inserts += 1;
    }
    const bool descend = has && !prune;
    if (descend) {
      chosen[d] = j;
      if (d + 1 <= N) {
        chosen[d + 1] = -1;
        if (holds) states[(d + 1) * D + lane] = child;
        if (kMemo) hlev[d + 1] = h_child;
      }
#pragma unroll
      for (int w = 0; w < W; ++w) tw[w] |= w == jw ? jbit : 0u;
      s = child;
      cur = -1;
    } else if (prune) {
      chosen[d] = j;
      prunes += 1;
      cur = j;
    } else {
      const int prev = max(ch_back, 0);
      if (d > 0 && prev < N) {
#pragma unroll
        for (int w = 0; w < W; ++w)
          tw[w] &= w == (prev >> 5) ? ~(1u << (prev & 31)) : FULL;
      }
      s = s_back;
      cur = ch_back;
    }
    const int d_old = d;
    d = descend ? d + 1 : (prune ? d : d_back);
    iters += 1;
    int st = success ? SUCCESS : (!has && d_old == 0 ? FAILURE : RUNNING);
    if (st == RUNNING && iters >= a.budget) st = BUDGET;
    status = st;
  }

  __syncwarp();  // the stacks, before other threads copy them out
  for (int k = lane; k < stack_words; k += WARP) gstates[k] = states[k];
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
    if (a.stats != nullptr) {
      atomicAdd(a.stats, probes);
      atomicAdd(a.stats + 1, passes);
    }
  }
}

using Kernel = void (*)(Args);

// the state widths whose memo hash gets its own instantiation (the
// registry's sweep-regime models: txn(8, 8); queue, stack, multicas and
// a random spec of 8 or 9 elements; KV of 9 and 16 keys); any other D
// hashes in a loop
template <int W, int K>
Kernel pick_width(bool memo, int D) {
  if (!memo) return stepper_sweep_kernel<W, false, K, 0>;
  switch (D) {
    case 8: return stepper_sweep_kernel<W, true, K, 8>;
    case 9: return stepper_sweep_kernel<W, true, K, 9>;
    case 16: return stepper_sweep_kernel<W, true, K, 16>;
    default: return stepper_sweep_kernel<W, true, K, 0>;
  }
}

template <int W>
Kernel pick_kind(bool memo, int kind, int D) {
  switch (kind) {
    case QUEUE: return pick_width<W, QUEUE>(memo, D);
    case KV: return pick_width<W, KV>(memo, D);
    case STACK: return pick_width<W, STACK>(memo, D);
    case MULTICAS: return pick_width<W, MULTICAS>(memo, D);
    case TXN: return pick_width<W, TXN>(memo, D);
    default: return pick_width<W, RANDOM>(memo, D);
  }
}

// one instantiation a (taken words, model kind, memo off / on at a state
// width of its own / on at any other)
Kernel pick_kernel(int W, bool memo, int kind, int D) {
  switch (W) {
    case 1: return pick_kind<1>(memo, kind, D);
    case 2: return pick_kind<2>(memo, kind, D);
    case 3: return pick_kind<3>(memo, kind, D);
    default: return pick_kind<4>(memo, kind, D);
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

// Makes `device` the current device of this library's CUDA runtime
// (built static, its own beside PyTorch's): the wrapper calls it
// before each launch, so that a launch for a shard on card i runs on
// card i.  Returns the cudaSetDevice error (0 = set).
extern "C" int set_launch_device(int device) {
  return static_cast<int>(cudaSetDevice(device));
}

// Launches one chunk on `stream` with the plan of
// ops/sweep_kernel.py::sweep_launch_plan (warps a block, grid, shared
// bytes), updating the carry in place.  `data` is the random-vector
// model's tables (read only for kind 6).  `lanes` (L distinct lanes in
// [0, B), checked by the caller) or null (L == B: every lane) names the
// lanes run; `stats`, when not null, gains the launch's memo probes and
// the probes whose tag matched (two uint64).  Returns cudaErrorInvalidValue
// for arguments or a plan it does not take (nothing is launched), else
// cudaGetLastError() (0 = the launch was accepted).
extern "C" int stepper_sweep_launch(
    const int32_t* cmd, const int32_t* arg, const int32_t* resp,
    const int32_t* prec, const int32_t* valid, const int32_t* nreq,
    const int32_t* data, const int32_t* row, int32_t* taken, int32_t* chosen,
    int32_t* states, int32_t* dsi, int32_t* keys, int32_t* occ,
    const int32_t* lanes, unsigned long long* stats, int B, int R, int N,
    int W, int D, int slots, int chunk, int budget, int kind, int p0, int p1,
    int p2, int L, int warps, int grid, int smem_bytes, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (N < 1 || N > 32 * MAX_W || W != (N + 31) / 32 || D < 1 ||
      W + D > MAX_KW || B < 0 || R < 1 || slots < 0 ||
      (slots & (slots - 1)) != 0 || chunk < 0 ||
      !model_ok(kind, D, p0, p1, p2) ||
      (lanes == nullptr ? L != B : (L < 0 || L > B)))
    return invalid;
  // the plan: a grid of `warps`-warp blocks over the L lanes run, each
  // warp's state stack and chosen stack, and with the memo a hash a level
  // and one tag byte a slot, in shared memory, within what the device
  // grants a block
  const long long warp_words =
      (N + 1LL) * (D + 1) + (slots > 0 ? N + 1LL + (slots + 3) / 4 : 0);
  if (warps < 1 || warps > MAX_WARPS || grid != (L + warps - 1) / warps ||
      smem_bytes != 4LL * warps * warp_words)
    return invalid;
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem_bytes > limit) return invalid;
  if (L == 0) return 0;
  const Kernel kern = pick_kernel(W, slots > 0, kind, D);
  if (smem_bytes > STATIC_SMEM_MAX) {
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const Args a{cmd,   arg,    resp,   prec, valid, nreq,  data,  row,
               lanes, taken,  chosen, states, dsi, keys,  occ,   stats,
               B,     L,      N,      D,    slots, chunk, budget, p0,
               p1,    p2,     warps,  static_cast<int>(warp_words)};
  kern<<<grid, warps * WARP, smem_bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
