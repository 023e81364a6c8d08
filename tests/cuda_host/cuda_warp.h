// Warp votes, shuffles and barriers on the host, for the sources whose
// threads cooperate (qsm_tpu_torch/csrc/stepper_chunk.cu,
// stepper_sweep.cu): a launch runs
// each block's threads as std::threads over one shared-memory buffer, and
// every __ballot_sync, __shfl_sync (a source lane per thread),
// __shfl_down_sync and __syncwarp of a warp, and every
// __syncthreads of a block, meets at a barrier of its threads, so that
// between two barriers the threads run in any order and interleaving, as
// on the card.  Blocks run one after another.  The test compiles a source
// with `-include cuda_warp.h` and rewrites its `<<<...>>>` launch to
// `host_launch_threads`.
#pragma once
#include <condition_variable>
#include <cstdint>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#include "cuda_runtime.h"

struct HostBarrier {
  explicit HostBarrier(int n) : n(n) {}
  void wait() {
    std::unique_lock<std::mutex> lock(m);
    const unsigned g = gen;
    if (++count == n) {
      count = 0;
      ++gen;
      cv.notify_all();
    } else {
      cv.wait(lock, [&] { return gen != g; });
    }
  }
  std::mutex m;
  std::condition_variable cv;
  const int n;
  int count = 0;
  unsigned gen = 0;
};

// one warp's meeting point; values pass through one of two buffers in
// turn, so a thread may write the next exchange's value while another
// still reads this one's
struct HostWarp {
  HostBarrier bar{32};
  uint32_t slots[2][32];
};

struct HostBlock {
  explicit HostBlock(int threads) : bar(threads), warps(threads / 32) {}
  HostBarrier bar;
  std::vector<HostWarp> warps;
};

inline thread_local HostBlock* host_block;
inline thread_local int host_turn;  // which buffer this thread uses next

// every thread of the warp deposits `v`; returns the 32 values
inline const uint32_t* host_exchange(uint32_t v) {
  HostWarp& w = host_block->warps[threadIdx.x / 32];
  uint32_t* buf = w.slots[host_turn];
  host_turn ^= 1;
  buf[threadIdx.x % 32] = v;
  w.bar.wait();
  return buf;
}

// every stand-in takes the full mask: the sources use no other
inline unsigned __ballot_sync(unsigned, int pred) {
  const uint32_t* all = host_exchange(pred != 0);
  unsigned out = 0;
  for (int i = 0; i < 32; ++i) out |= (all[i] & 1u) << i;
  return out;
}

inline int __shfl_sync(unsigned, int v, int src) {
  return static_cast<int>(
      host_exchange(static_cast<uint32_t>(v))[src & 31]);
}

inline unsigned __shfl_sync(unsigned, unsigned v, int src) {
  return host_exchange(v)[src & 31];
}

// the value of lane + delta; a lane past the warp keeps its own
inline int __shfl_down_sync(unsigned, int v, unsigned delta) {
  const int lane = threadIdx.x % 32;
  const int src = lane + static_cast<int>(delta);
  return static_cast<int>(
      host_exchange(static_cast<uint32_t>(v))[src < 32 ? src : lane]);
}

// threads of several warps run at once: an atomic add of the host
inline unsigned long long atomicAdd(unsigned long long* p,
                                    unsigned long long v) {
  return __atomic_fetch_add(p, v, __ATOMIC_RELAXED);
}

inline void __syncwarp(unsigned = 0xFFFFFFFFu) {
  host_block->warps[threadIdx.x / 32].bar.wait();
}

inline void __syncthreads() { host_block->bar.wait(); }

// kernel<<<grid, threads, smem_bytes>>>(args): `threads` (a multiple of
// 32) std::threads a block; the shared buffer starts as garbage, as on
// the card
template <class K, class A>
void host_launch_threads(K kernel, int grid, int threads, int smem_bytes,
                         const A& args) {
  std::vector<int32_t> buf(smem_bytes / 4 + 1);
  for (int bx = 0; bx < grid; ++bx) {
    std::fill(buf.begin(), buf.end(), 0x5A5A5A5A);
    HostBlock block(threads);
    std::vector<std::thread> pool;
    for (int t = 0; t < threads; ++t)
      pool.emplace_back([&, t] {
        threadIdx.x = t;
        blockIdx.x = bx;
        blockDim.x = threads;
        gridDim.x = grid;
        host_smem = buf.data();
        host_block = &block;
        host_turn = 0;
        kernel(args);
      });
    for (auto& th : pool) th.join();
  }
}
