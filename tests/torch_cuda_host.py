"""Build a csrc/*.cu kernel source for the CPU with real blocks and warps.

A CUDA kernel has no interpret mode, but the port's kernels are plain C++
inside CUDA qualifiers. `host_build` compiles one source with the host
C++ compiler against the stub `cuda_runtime.h` below and returns the
library (ctypes), whose C entry points the tests call on CPU tensors:

- every `kernel<<<blocks, threads, smem, stream>>>(args);` becomes a call
  of `cray_host::launch`, which runs each block's threads as
  `std::thread`s, a few blocks at a time (`WAVE`), with `threadIdx` and
  `blockIdx` thread-local;
- `__shared__` arrays (static and `extern` dynamic ones) become memory
  of the running block, shared by its threads and by no other block;
- `__syncthreads` (and `__syncthreads_or`) is a barrier of the block's
  threads, `__syncwarp` one of the warp's; `__ballot_sync`,
  `__any_sync`, `__shfl_sync` and `__shfl_xor_sync` exchange values over
  the warp's 32 lanes; `__popc`, `__ffs` and `atomicAdd` are the host's;
  a thread that returns leaves its block's and its warp's barriers, as
  on the card;
- `cudaOccupancyMaxActiveBlocksPerMultiprocessor` answers 1 block and
  the SM count is 2, so a persistent kernel runs 2 blocks and every
  thread takes many work items; the L2 size is `l2_bytes` (the H100's
  50 MB unless the build asks for another), so a test can make a kernel
  that chooses its code by whether a table fits the L2 take either
  choice;
- a barrier that waits longer than `CRAY_HOST_TIMEOUT_S` seconds gives
  up: every thread of the launch unwinds and the launch's
  cudaGetLastError() is cudaErrorLaunchTimeout (702), so a deadlock fails
  one test instead of hanging a worker.

Built with -ffp-contract=off, as the card build uses --fmad=false.
"""

import ctypes
import re
import shutil
import subprocess

import pytest

from craytracer_tpu_torch.cuda_build import CSRC

STUB = r"""#pragma once
#include <math.h>
#include <stdint.h>
#include <string.h>
#include <algorithm>
#include <chrono>
#include <condition_variable>
#include <functional>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorLaunchTimeout = 702 };
enum cudaDeviceAttr {
  cudaDevAttrMultiProcessorCount = 16,
  cudaDevAttrL2CacheSize = 38
};
struct float4 { float x, y, z, w; };
static inline float4 __ldg(const float4* p) { return *p; }
static inline float __ldg(const float* p) { return *p; }
struct host_dim3 { int x; };
static thread_local host_dim3 threadIdx, blockIdx;
static host_dim3 blockDim, gridDim;
using std::min;
using std::max;

namespace cray_host {

constexpr int WAVE = 2;         // blocks run at once
constexpr int SM_COUNT = 2;     // what cudaDeviceGetAttribute answers
constexpr int L2_BYTES = CRAY_HOST_L2_BYTES;
constexpr double TIMEOUT_S = CRAY_HOST_TIMEOUT_S;
static int last_error = 0;

struct Abort {};  // thrown out of a barrier that gave up

struct Warp {
  int live = 0, arrived = 0;
  unsigned gen = 0;
  uint32_t val[2][32];
  uint32_t present[2] = {0u, 0u};
  std::condition_variable cv;
};

struct Block {
  std::mutex mu;
  std::condition_variable cv;
  int live = 0, arrived = 0;
  unsigned gen = 0;
  int any[2] = {0, 0};  // __syncthreads_or's accumulator, per generation
  bool failed = false;
  std::vector<std::unique_ptr<Warp>> warps;
  std::vector<double> dyn;  // dynamic shared memory (8-byte aligned)
  std::map<std::string, std::vector<double>> stat;
};

static thread_local Block* cur = nullptr;
static std::mutex fail_mu;
static std::vector<Block*>* running = nullptr;

static void fail_all() {
  std::lock_guard<std::mutex> g(fail_mu);
  for (Block* b : *running) {
    std::lock_guard<std::mutex> lk(b->mu);
    b->failed = true;
    b->cv.notify_all();
    for (auto& w : b->warps) w->cv.notify_all();
  }
}

template <class Pred>
static void wait(std::unique_lock<std::mutex>& lk,
                 std::condition_variable& cv, Pred done) {
  const auto until = std::chrono::steady_clock::now()
                     + std::chrono::duration<double>(TIMEOUT_S);
  if (!cv.wait_until(lk, until, [&] { return done() || cur->failed; })) {
    lk.unlock();
    fail_all();
    throw Abort();
  }
  if (!done()) throw Abort();
}

// the block barrier; returns whether any thread passed a nonzero `p`
static int sync_block(int p) {
  Block* b = cur;
  std::unique_lock<std::mutex> lk(b->mu);
  if (b->failed) throw Abort();
  const unsigned g = b->gen;
  b->any[g & 1u] |= p != 0;
  if (++b->arrived == b->live) {
    b->arrived = 0;
    b->any[(g + 1u) & 1u] = 0;
    ++b->gen;
    b->cv.notify_all();
  } else {
    wait(lk, b->cv, [&] { return b->gen != g; });
  }
  return b->any[g & 1u];
}

// one warp-wide exchange: every live lane deposits `v`; returns the
// deposited words and, in `mask`, the lanes that deposited them
static const uint32_t* exchange(uint32_t v, uint32_t& mask) {
  Block* b = cur;
  Warp& w = *b->warps[threadIdx.x >> 5];
  const int lane = threadIdx.x & 31;
  std::unique_lock<std::mutex> lk(b->mu);
  if (b->failed) throw Abort();
  const unsigned g = w.gen;
  w.val[g & 1u][lane] = v;
  w.present[g & 1u] |= 1u << lane;
  if (++w.arrived == w.live) {
    w.arrived = 0;
    w.present[(g + 1u) & 1u] = 0u;
    ++w.gen;
    w.cv.notify_all();
  } else {
    wait(lk, w.cv, [&] { return w.gen != g; });
  }
  mask = w.present[g & 1u];
  return w.val[g & 1u];
}

static void thread_exit() {
  Block* b = cur;
  std::lock_guard<std::mutex> lk(b->mu);
  Warp& w = *b->warps[threadIdx.x >> 5];
  if (--b->live > 0 && b->arrived == b->live) {
    b->arrived = 0;
    b->any[(b->gen + 1u) & 1u] = 0;
    ++b->gen;
    b->cv.notify_all();
  }
  if (--w.live > 0 && w.arrived == w.live) {
    w.arrived = 0;
    w.present[(w.gen + 1u) & 1u] = 0u;
    ++w.gen;
    w.cv.notify_all();
  }
}

static void* dyn_shared() { return cur->dyn.data(); }

static void* static_shared(const char* name, size_t bytes) {
  std::lock_guard<std::mutex> lk(cur->mu);
  auto& v = cur->stat[name];
  if (v.empty()) v.assign((bytes + 7) / 8, 0.0);
  return v.data();
}

static void launch(const std::function<void()>& body, int blocks,
                   int threads, size_t smem = 0, cudaStream_t = nullptr) {
  blockDim.x = threads;
  gridDim.x = blocks;
  for (int b0 = 0; b0 < blocks; b0 += WAVE) {
    const int nb = std::min(WAVE, blocks - b0);
    std::vector<std::unique_ptr<Block>> bl;
    std::vector<Block*> ptrs;
    for (int i = 0; i < nb; ++i) {
      bl.emplace_back(new Block());
      Block* b = bl.back().get();
      b->live = threads;
      b->dyn.assign(smem / 8 + 1, 0.0);
      for (int t0 = 0; t0 < threads; t0 += 32) {
        b->warps.emplace_back(new Warp());
        b->warps.back()->live = std::min(32, threads - t0);
      }
      ptrs.push_back(b);
    }
    running = &ptrs;
    std::vector<std::thread> th;
    for (int i = 0; i < nb; ++i)
      for (int t = 0; t < threads; ++t)
        th.emplace_back([&, i, t] {
          cur = ptrs[i];
          blockIdx.x = b0 + i;
          threadIdx.x = t;
          try {
            body();
          } catch (const Abort&) {
          }
          thread_exit();
        });
    for (auto& x : th) x.join();
    for (Block* b : ptrs)
      if (b->failed) {
        last_error = cudaErrorLaunchTimeout;
        return;
      }
  }
}

}  // namespace cray_host

static inline void __syncthreads() { cray_host::sync_block(0); }
static inline int __syncthreads_or(int p) { return cray_host::sync_block(p); }
static inline void __syncwarp(unsigned = 0xffffffffu) {
  uint32_t m;
  cray_host::exchange(0u, m);
}
static inline unsigned __ballot_sync(unsigned, bool p) {
  uint32_t m, out = 0u;
  const uint32_t* v = cray_host::exchange(p ? 1u : 0u, m);
  for (int l = 0; l < 32; ++l)
    if ((m >> l & 1u) && v[l]) out |= 1u << l;
  return out;
}
static inline bool __any_sync(unsigned mask, bool p) {
  return __ballot_sync(mask, p) != 0u;
}
template <class T>
static inline T shfl_from(T x, int (*src)(int, int), int arg) {
  uint32_t bits, m;
  memcpy(&bits, &x, 4);
  const uint32_t* v = cray_host::exchange(bits, m);
  const int s = src(threadIdx.x & 31, arg);
  T out;
  memcpy(&out, &v[s], 4);
  return out;
}
static inline int src_lane(int, int l) { return l & 31; }
static inline int src_xor(int lane, int m) { return (lane ^ m) & 31; }
template <class T>
static inline T __shfl_sync(unsigned, T x, int l) {
  return shfl_from(x, src_lane, l);
}
template <class T>
static inline T __shfl_xor_sync(unsigned, T x, int m) {
  return shfl_from(x, src_xor, m);
}
static inline int __popc(unsigned x) { return __builtin_popcount(x); }
static inline int __ffs(int x) { return __builtin_ffs(x); }
static inline int __float_as_int(float x) {
  int i;
  memcpy(&i, &x, 4);
  return i;
}
static inline int atomicAdd(int* p, int v) {  // global or shared
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
static inline int cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  memset(p, v, n);
  return 0;
}
static inline int cudaGetDevice(int* d) {
  *d = 0;
  return 0;
}
static inline int cudaDeviceGetAttribute(int* v, cudaDeviceAttr a, int) {
  *v = a == cudaDevAttrL2CacheSize ? cray_host::L2_BYTES
                                   : cray_host::SM_COUNT;
  return 0;
}
template <class F>
static inline int cudaOccupancyMaxActiveBlocksPerMultiprocessor(
    int* n, F, int, size_t) {
  *n = 1;
  return 0;
}
static inline int cudaGetLastError() {
  const int e = cray_host::last_error;
  cray_host::last_error = 0;
  return e;
}
static inline const char* cudaGetErrorString(int e) {
  return e ? "host build: a barrier timed out" : "host build";
}
"""

_LAUNCH = re.compile(r"(\w+(?:<[\w\s,]*>)?)\s*<<<(.*?)>>>\((.*?)\);", re.S)
_DYN_SHARED = re.compile(r"extern\s+__shared__\s+(\w+)\s+(\w+)\[\];")
_SHARED = re.compile(r"__shared__\s+(\w+)\s+(\w+)((?:\[[^\]]+\])+);")


def host_source(text: str):
    """(the C++ text of a .cu source for the stub, the number of launches
    it rewrote)."""
    text, n = _LAUNCH.subn(
        r"cray_host::launch([&]() { \1(\3); }, \2);", text)
    text = _DYN_SHARED.sub(
        r"\1* const \2 = (\1*)cray_host::dyn_shared();", text)
    text = _SHARED.sub(
        r'\1 (&\2)\3 = *reinterpret_cast<\1 (*)\3>('
        r'cray_host::static_shared("\2", sizeof(\1\3)));', text)
    return text, n


def host_build(tmp_path_factory, stem: str, n_launches: int,
               timeout_s: float = 20.0, text: str = None,
               l2_bytes: int = 50 * 1024 * 1024, defines: dict = None):
    """csrc/`stem`.cu (or the source `text`) built for the CPU with the
    stub, whose device has an L2 of `l2_bytes`, and `defines` as -D flags;
    asserts that it has `n_launches` launches. Skips when no C++ compiler
    is on the PATH."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernel sources")
    flags = [f"-D{k}={v}" for k, v in (defines or {}).items()]
    d = tmp_path_factory.mktemp(f"{stem}_host")
    (d / "cuda_runtime.h").write_text(STUB)
    src, n = host_source(text or (CSRC / f"{stem}.cu").read_text())
    assert n == n_launches
    (d / f"{stem}.cpp").write_text(src)
    lib = d / f"lib{stem}_host.so"
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off",
                    "-fno-fast-math", "-shared", "-fPIC", "-pthread",
                    f"-DCRAY_HOST_TIMEOUT_S={timeout_s}",
                    f"-DCRAY_HOST_L2_BYTES={l2_bytes}", *flags, "-I",
                    str(d), "-I", str(CSRC), "-o", str(lib),
                    str(d / f"{stem}.cpp")],
                   check=True, capture_output=True, timeout=300)
    return ctypes.CDLL(str(lib))
