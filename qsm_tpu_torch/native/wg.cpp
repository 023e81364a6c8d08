// Native Wing–Gong lineariser: the C++ host checker of qsm_tpu_torch, the
// port's own copy of the JAX package's qsm_tpu/native/wg.cpp (the same
// search, kept line for line so both give the same verdicts).  It is host
// code: no GPU is involved.
//
// Faithful to qsm_tpu_torch/ops/wing_gong_cpu.py::WingGongCPU._check:
// identical candidate order (ops ascending, responses ascending), identical
// node budget accounting (one unit per step evaluation), identical memo
// semantics (configurations (taken-set, state) proven non-linearizable-
// from), identical pending-op treatment (a pending op may linearise with
// ANY response in its command's domain, or never).  Verdict codes match
// ops/backend.py::Verdict: 0 VIOLATION, 1 LINEARIZABLE, 2 BUDGET_EXCEEDED.
//
// Spec dispatch (SpecDesc.kind):
//   0 — scalar-state spec via the dense [S][C][A][R] domain table compiled
//       by core/spec.py::compile_step_table;
//   1 — bounded FIFO queue (models/queue.py semantics reimplemented:
//       state = [length, slot0..slotC-1], params = capacity, n_values);
//   2 — multi-key KV map (models/kv.py: state = value per key,
//       params = n_keys, n_values);
//   3 — bounded LIFO stack (models/stack.py: state = [length, slots...],
//       params = capacity, n_values; top is slots[length-1]).
// Vector kinds evaluate the step directly (total in the response, exactly
// like step_py), so only ARG domains need host-side routing; parity with
// the Python oracle is pinned by tests/test_torch_native.py.
//
// Histories are capped at 128 ops (the encoder's largest bucket): the
// taken set is an unsigned __int128 (GCC builtin; this library is built
// with g++ by native/__init__.py) and precedence is a per-op blocker
// bitmask of the same width, passed from Python as little-endian (lo, hi)
// uint64 pairs.

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_set>
#include <utility>
#include <vector>

namespace {

constexpr int MAX_STATE = 64;  // state vector length cap (router enforces)

using Mask = unsigned __int128;  // widest taken/blocker bitmask, ops <= 128

struct SpecDesc {
    int kind;        // 0 table, 1 queue, 2 kv, 3 stack
    int state_dim;
    int32_t p0, p1;  // queue: capacity, n_values; kv: n_keys, n_values
    const int32_t* trans;  // kind 0 only: [S][C][A][R]
    const uint8_t* ok;
    int S, C, A, R;
    // bit width of any state element (caller-provided domain bound).  When
    // state_dim * elem_bits <= 64 the whole vector packs into the fast
    // pair key — no per-node heap allocation on the memo path.
    int elem_bits;
};

// A kind-0 state outside the table: the caller must defer (never index).
static inline bool state_oob(const SpecDesc& sp, const int32_t* s) {
    return sp.kind == 0 && (s[0] < 0 || s[0] >= sp.S);
}

// Caller-supplied START states can be arbitrary (check_from / frontier
// threading); the step kernels preserve validity, so one root check per
// search restores the "never a misread" contract for vector kinds too:
// a queue length outside [0, cap] would index past the stack buffer, and
// any element past elem_bits would alias packed memo keys (an aliased
// "proven failed" entry is a WRONG verdict, not just a lost prune).
static inline bool start_state_invalid(const SpecDesc& sp,
                                       const int32_t* s) {
    switch (sp.kind) {
        case 0:
            return s[0] < 0 || s[0] >= sp.S;
        case 1:
        case 3: {  // queue/stack share the [length, slots...] layout
            if (s[0] < 0 || s[0] > sp.p0) return true;       // length
            for (int i = 1; i <= sp.p0; ++i)                 // slots
                if (s[i] < 0 || s[i] >= sp.p1) return true;
            return false;
        }
        case 2: {
            for (int i = 0; i < sp.state_dim; ++i)           // values
                if (s[i] < 0 || s[i] >= sp.p1) return true;
            return false;
        }
    }
    return true;
}

// step: writes the successor state into out[], returns the postcondition.
// Kind-0 callers must have checked state_oob() first.
static inline bool do_step(const SpecDesc& sp, const int32_t* s,
                           int32_t* out, int cmd, int arg, int resp) {
    switch (sp.kind) {
        case 0: {
            const int idx = ((s[0] * sp.C + cmd) * sp.A + arg) * sp.R + resp;
            out[0] = sp.trans[idx];
            return sp.ok[idx] != 0;
        }
        case 1: {  // bounded FIFO queue: s = [length, slots...]
            const int cap = sp.p0, n_values = sp.p1;
            const int length = s[0];
            std::memcpy(out, s, sizeof(int32_t) * (1 + cap));
            if (cmd == 0) {                       // ENQ(arg)
                if (length == cap) return resp == 1;   // FULL
                out[1 + length] = arg;
                out[0] = length + 1;
                return resp == 0;                      // OK
            }
            if (length == 0) return resp == n_values;  // DEQ on empty
            const int head = s[1];
            for (int i = 0; i < cap - 1; ++i) out[1 + i] = s[2 + i];
            out[cap] = 0;  // canonical form: vacated tail slot zeroed
            out[0] = length - 1;
            return resp == head;
        }
        case 2: {  // kv map: s = value per key
            const int n_values = sp.p1;
            std::memcpy(out, s, sizeof(int32_t) * sp.state_dim);
            if (cmd == 0) return resp == s[arg];       // GET(key)
            out[arg / n_values] = arg % n_values;      // PUT packs k*V+v
            return resp == 0;
        }
        case 3: {  // bounded LIFO stack: s = [length, slots...]
            const int cap = sp.p0, n_values = sp.p1;
            const int length = s[0];
            std::memcpy(out, s, sizeof(int32_t) * (1 + cap));
            if (cmd == 0) {                       // PUSH(arg)
                if (length == cap) return resp == 1;   // FULL
                out[1 + length] = arg;
                out[0] = length + 1;
                return resp == 0;                      // OK
            }
            if (length == 0) return resp == n_values;  // POP on empty
            out[length] = 0;  // canonical form: vacated top zeroed
            out[0] = length - 1;
            return resp == s[length];                  // top = slots[len-1]
        }
    }
    return false;
}

// Exact memo keys.  Scalar states use a (taken, state) pair set — the hot
// path; vector states serialize taken + the raw state bytes into a string
// set.  Both are exact (full-key storage), collisions impossible.
//
// The search is TEMPLATED on the mask type M: uint64_t for histories of
// <= 64 ops (the common case — one-word bit ops, 16-byte keys), Mask
// (unsigned __int128) for the 96/128-op long-context buckets.  Measured:
// running everything at 128 bits costs ~2x on the <= 64-op bench corpus
// (bigger hash keys dominate), so the width is chosen per history.

static inline uint64_t mix64(uint64_t x) {
    x += 0x9E3779B97F4A7C15ull;
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
    x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
    return x ^ (x >> 31);
}

template <typename M>
struct KeyHashT {
    size_t operator()(const std::pair<M, uint64_t>& k) const {
        uint64_t h = mix64(static_cast<uint64_t>(k.first));
        if (sizeof(M) > 8)
            h ^= mix64(static_cast<uint64_t>(
                     static_cast<Mask>(k.first) >> 64))
                 * 0xC2B2AE3D27D4EB4Full;
        return h ^ (mix64(k.second) * 0x9E3779B9ull);
    }
};

template <typename M>
struct CtxT {
    using Key = std::pair<M, uint64_t>;
    int n;
    const int32_t* cmd;
    const int32_t* arg;
    const int32_t* resp;
    const uint8_t* pending;
    const M* blockers;
    SpecDesc sp;
    const int32_t* n_resps;  // per command
    int n_required;
    long long budget;
    long long nodes;
    bool use_memo;
    std::unordered_set<Key, KeyHashT<M>>* seen;      // state_dim == 1
    std::unordered_set<std::string>* seen_vec;       // state_dim  > 1
};

template <typename M>
static inline std::pair<M, uint64_t> key_of(M taken, int state) {
    return {taken, static_cast<uint64_t>(static_cast<uint32_t>(state))};
}

// Packs a small-domain state vector into the pair key's second word; the
// caller guarantees every element fits elem_bits (spec domain bound).
template <typename M>
static inline std::pair<M, uint64_t> key_packed(
    M taken, const int32_t* state, int dim, int elem_bits) {
    uint64_t packed = 0;
    for (int i = 0; i < dim; ++i)
        packed |= static_cast<uint64_t>(static_cast<uint32_t>(state[i]))
                  << (i * elem_bits);
    return {taken, packed};
}

template <typename M>
static std::string vec_key(M taken, const int32_t* state, int dim) {
    std::string k(sizeof(taken) + sizeof(int32_t) * dim, '\0');
    std::memcpy(&k[0], &taken, sizeof(taken));
    std::memcpy(&k[sizeof(taken)], state, sizeof(int32_t) * dim);
    return k;
}

// returns Verdict {0, 1, 2}
template <typename M>
static int dfs(CtxT<M>& c, M taken, const int32_t* state,
               int got_required) {
    if (got_required == c.n_required) return 1;
    if (c.budget <= 0) return 2;
    // a state beyond the domain table (non-initial start past the bound,
    // or a broken bound contract): defer honestly instead of misreading
    if (state_oob(c.sp, state)) return 2;
    const bool scalar = c.sp.state_dim == 1;
    const bool packed = !scalar
        && c.sp.elem_bits > 0
        && c.sp.state_dim * c.sp.elem_bits <= 64;
    std::pair<M, uint64_t> key{};
    std::string vkey;
    if (c.use_memo) {
        if (scalar) {
            key = key_of(taken, state[0]);
            if (c.seen->count(key)) return 0;
        } else if (packed) {
            key = key_packed(taken, state, c.sp.state_dim, c.sp.elem_bits);
            if (c.seen->count(key)) return 0;
        } else {
            vkey = vec_key(taken, state, c.sp.state_dim);
            if (c.seen_vec->count(vkey)) return 0;
        }
    }
    bool saw_budget = false;
    int32_t child[MAX_STATE];
    for (int j = 0; j < c.n; ++j) {
        if (taken >> j & 1) continue;
        if (c.blockers[j] & ~taken) continue;  // an untaken op precedes j
        const int cm = c.cmd[j], a = c.arg[j];
        const bool pend = c.pending[j];
        const int r_lo = pend ? 0 : c.resp[j];
        const int r_hi = pend ? c.n_resps[cm] : c.resp[j] + 1;
        for (int r = r_lo; r < r_hi; ++r) {
            --c.budget;
            ++c.nodes;
            if (c.budget <= 0) return 2;
            if (!do_step(c.sp, state, child, cm, a, r)) continue;
            const int sub = dfs(c, static_cast<M>(taken | (static_cast<M>(1) << j)), child,
                                got_required + (pend ? 0 : 1));
            if (sub == 1) return 1;
            if (sub == 2) saw_budget = true;
        }
    }
    if (saw_budget) return 2;
    if (c.use_memo) {
        if (scalar || packed) c.seen->insert(key);
        else c.seen_vec->insert(std::move(vkey));
    }
    return 0;
}

// blockers2 (lo, hi) uint64 pairs -> per-op masks at width M: the ONE
// wire-format decode, shared by both entry paths.
template <typename M>
static std::vector<M> widen_blockers(int n, const uint64_t* blockers2) {
    std::vector<M> out(n);
    for (int j = 0; j < n; ++j) {
        M b = static_cast<M>(blockers2[2 * j]);
        if (sizeof(M) > 8)
            b |= static_cast<M>(
                static_cast<Mask>(blockers2[2 * j + 1]) << 64);
        out[j] = b;
    }
    return out;
}

// one complete history decided at mask width M
template <typename M>
static int check_one(int n, const int32_t* cmd, const int32_t* arg,
                     const int32_t* resp, const uint8_t* pending,
                     const uint64_t* blockers2, const SpecDesc& sp,
                     const int32_t* n_resps, const int32_t* init,
                     long long node_budget, bool use_memo,
                     long long* nodes_out) {
    int n_required = 0;
    for (int j = 0; j < n; ++j)
        if (!pending[j]) ++n_required;
    const std::vector<M> blockers = widen_blockers<M>(n, blockers2);
    std::unordered_set<std::pair<M, uint64_t>, KeyHashT<M>> seen;
    std::unordered_set<std::string> seen_vec;
    CtxT<M> c{n, cmd, arg, resp, pending, blockers.data(), sp, n_resps,
              n_required, node_budget, 0, use_memo, &seen, &seen_vec};
    const int v = dfs(c, static_cast<M>(0), init, 0);
    *nodes_out = c.nodes;
    return v;
}

// --- end-state enumeration (decrease-and-conquer middle segments) -------
// Explores EVERY valid complete linearization of a (pending-free) segment
// from one start state, collecting the set of distinct reachable end
// states — the native counterpart of ops/segdc.py::_end_states, same
// budget accounting (one unit per step evaluation) and same visited-set
// pruning semantics.

template <typename M>
struct EndCtxT {
    using Key = std::pair<M, uint64_t>;
    int n;
    const int32_t* cmd;
    const int32_t* arg;
    const int32_t* resp;
    const M* blockers;
    SpecDesc sp;
    long long budget;
    long long nodes;
    bool overflow;   // hit max_out (distinct from budget exhaustion)
    bool oob;        // kind-0 state escaped the table (caller must defer)
    std::unordered_set<Key, KeyHashT<M>>* visited;  // packed/scalar states
    std::unordered_set<std::string>* visited_vec;   // string-key states
    std::unordered_set<std::string>* ends;          // distinct end states
    int32_t* out;       // [max_out][state_dim]
    int max_out;
};

template <typename M>
static bool end_dfs(EndCtxT<M>& c, M taken, const int32_t* state) {
    const int dim = c.sp.state_dim;
    const M full = (c.n == static_cast<int>(sizeof(M) * 8))
                       ? ~static_cast<M>(0)
                       : ((static_cast<M>(1) << c.n) - 1);
    if (taken == full) {
        std::string k(reinterpret_cast<const char*>(state),
                      sizeof(int32_t) * dim);
        if (c.ends->count(k)) return true;
        if (static_cast<int>(c.ends->size()) >= c.max_out) {
            c.overflow = true;
            return false;
        }
        std::memcpy(c.out + c.ends->size() * dim, state,
                    sizeof(int32_t) * dim);
        c.ends->insert(std::move(k));
        return true;
    }
    if (state_oob(c.sp, state)) {
        c.oob = true;
        return false;
    }
    const bool scalar = dim == 1;
    const bool packed = !scalar && c.sp.elem_bits > 0
                        && dim * c.sp.elem_bits <= 64;
    if (scalar || packed) {
        auto key = scalar ? key_of(taken, state[0])
                          : key_packed(taken, state, dim, c.sp.elem_bits);
        if (!c.visited->insert(key).second) return true;
    } else {
        if (!c.visited_vec->insert(vec_key(taken, state, dim)).second)
            return true;
    }
    int32_t child[MAX_STATE];
    for (int j = 0; j < c.n; ++j) {
        if (taken >> j & 1) continue;
        if (c.blockers[j] & ~taken) continue;
        --c.budget;
        ++c.nodes;
        if (c.budget <= 0) return false;
        if (!do_step(c.sp, state, child, c.cmd[j], c.arg[j], c.resp[j]))
            continue;
        if (!end_dfs(c, static_cast<M>(taken | (static_cast<M>(1) << j)),
                     child))
            return false;
    }
    return true;
}

// all starts of one segment enumerated at mask width M; returns rc
// (0 ok, -1 budget, -2 overflow, -3 oob/invalid-start) and charges
// *nodes_used
template <typename M>
static long long end_states_run(
    int n, const int32_t* cmd, const int32_t* arg, const int32_t* resp,
    const uint64_t* blockers2, const SpecDesc& sp,
    const int32_t* init_states, int n_inits, long long node_budget,
    int32_t* out_states, int max_out,
    std::unordered_set<std::string>* ends, long long* nodes_used) {
    const std::vector<M> blockers = widen_blockers<M>(n, blockers2);
    EndCtxT<M> c{n, cmd, arg, resp, blockers.data(), sp, node_budget, 0,
                 false, false, nullptr, nullptr, ends, out_states, max_out};
    long long rc = 0;
    for (int i = 0; i < n_inits && rc == 0; ++i) {
        // fresh visited set per start, exactly like the Python version
        std::unordered_set<std::pair<M, uint64_t>, KeyHashT<M>> visited;
        std::unordered_set<std::string> visited_vec;
        c.visited = &visited;
        c.visited_vec = &visited_vec;
        const int32_t* init = init_states + i * sp.state_dim;
        if (start_state_invalid(sp, init)) {
            rc = -3;  // caller falls back to the exact Python walk
        } else if (!end_dfs(c, static_cast<M>(0), init)) {
            rc = c.oob ? -3 : (c.overflow ? -2 : -1);
        }
    }
    *nodes_used = c.nodes;
    return rc;
}

}  // namespace

extern "C" {

// Enumerate reachable end states of a complete segment from n_inits start
// states.  Returns the count written to out_states; on failure returns
// -1 (budget exhausted), -2 (more than max_out distinct end states), or
// -3 (a scalar state escaped the domain table — caller must defer).
// *nodes_used always reports step evaluations consumed, so the caller can
// charge its shared budget before falling back to the exact Python walk.
// ``blockers2`` is [n][2] uint64 little-endian (lo, hi) words per op.
long long wg_end_states(
    int n, const int32_t* cmd, const int32_t* arg, const int32_t* resp,
    const uint64_t* blockers2,
    int kind, int state_dim, int32_t p0, int32_t p1, int elem_bits,
    const int32_t* trans, const uint8_t* ok,
    int S, int C, int A, int R,
    const int32_t* init_states, int n_inits,
    long long node_budget, int32_t* out_states, int max_out,
    long long* nodes_used) {
    SpecDesc sp{kind, state_dim, p0, p1, trans, ok, S, C, A, R, elem_bits};
    std::unordered_set<std::string> ends;
    const long long rc =
        (n <= 64)
            ? end_states_run<uint64_t>(n, cmd, arg, resp, blockers2, sp,
                                       init_states, n_inits, node_budget,
                                       out_states, max_out, &ends,
                                       nodes_used)
            : end_states_run<Mask>(n, cmd, arg, resp, blockers2, sp,
                                   init_states, n_inits, node_budget,
                                   out_states, max_out, &ends, nodes_used);
    return rc == 0 ? static_cast<long long>(ends.size()) : rc;
}

// Decide a batch: per-history op arrays are concatenated, offsets[i] is
// the start of history i's ops, offsets[n_hist] the total.  init_states
// is [n_hist][state_dim] (per-lane start states — the segmentation
// combinator's route).  kind/p0/p1 select the spec semantics; trans/ok
// carry the scalar domain table for kind 0 (pass null otherwise).
// ``blockers2`` is [total][2] uint64 little-endian (lo, hi) words per op.
// Returns total nodes explored; verdicts land in out_verdicts.
long long wg_check_batch(
    int n_hist, const int64_t* offsets,
    const int32_t* cmd, const int32_t* arg, const int32_t* resp,
    const uint8_t* pending, const uint64_t* blockers2,
    int kind, int state_dim, int32_t p0, int32_t p1, int elem_bits,
    const int32_t* trans, const uint8_t* ok,
    int S, int C, int A, int R, const int32_t* n_resps,
    const int32_t* init_states, long long node_budget, int use_memo,
    int32_t* out_verdicts) {
    SpecDesc sp{kind, state_dim, p0, p1, trans, ok, S, C, A, R, elem_bits};
    long long total = 0;
    for (int i = 0; i < n_hist; ++i) {
        const int64_t lo = offsets[i];
        const int n = static_cast<int>(offsets[i + 1] - lo);
        const int32_t* init = init_states + i * state_dim;
        long long nodes = 0;
        if (n == 0) {
            out_verdicts[i] = 1;
        } else if (start_state_invalid(sp, init)) {
            out_verdicts[i] = 2;  // defer: the Python oracle is exact here
        } else if (n <= 64) {     // per-history mask width (see above)
            out_verdicts[i] = check_one<uint64_t>(
                n, cmd + lo, arg + lo, resp + lo, pending + lo,
                blockers2 + 2 * lo, sp, n_resps, init, node_budget,
                use_memo != 0, &nodes);
        } else {
            out_verdicts[i] = check_one<Mask>(
                n, cmd + lo, arg + lo, resp + lo, pending + lo,
                blockers2 + 2 * lo, sp, n_resps, init, node_budget,
                use_memo != 0, &nodes);
        }
        total += nodes;
    }
    return total;
}

}  // extern "C"
