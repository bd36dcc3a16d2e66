// P1: the per-pop cost probe of the BVH4 packet walk, for Hopper (sm_90a).
//
// Replaces craytracer_tpu/profiling/ablate_pallas_pop.py:43 `make_kernel`
// (launched by `run` :160), K3's pop-cost microbenchmark. A packet walks a
// preloaded stack of `pops` node ids, the LCG (i * 1103515245 + 12345) mod
// m in int32 arithmetic, with no pushes, so the trip count is exactly
// `pops`, and each mode times one more piece of the loop body:
//   empty    pop and consume the node id
//   rowload  pop and read the row's first column
//   cols     read the 108 columns a walk uses (27 float4) and sum them
//   colsdir  the same sum from 108 scalar reads
//   box      the four child slab tests per lane and the packet vote per
//            child (nearest entry, any lane entered)
//   mt       the eight Moller-Trumbore slots per lane
//   full     box, mt and the far-to-near sorting network of the votes
//            (pushes masked off)
// The TPU's packet is a block of 256 lanes with a scalar stack in SMEM;
// here it is one warp of 32 lanes, its stack in shared memory (filled by
// its lanes together), the packet votes warp reductions (__shfl_xor_sync
// min, __any_sync). Every warp walks the same node sequence. Per lane the
// output is t = best_t + acc (acc the packet's int32 sum, as the TPU
// kernel writes it) and `sink`, an int32 sum of the box votes (each
// child's entered flag and the bits of its nearest entry), which keeps the
// compiler from dropping box mode's work (the TPU kernel's box mode
// consumes none of it). With --fmad=false both equal the plain version's
// (craytracer_tpu_torch/profiling/pop_probe.py `pop_probe`) bit for bit.
//
// What bounds it: one pop's dependent work per warp; the probe measures it
// (ns per pop from the slope over two pop counts), it does not optimise it.
// The Hopper form: the pop sequence is known before the loop, so each
// packet stages its rows in shared memory RING pops ahead of use, a ring
// of RING 512-byte rows filled by cp.async (16 bytes a lane: lane q copies
// float4 q of the row, and only the float4 the mode reads: rowload 0, box
// 0-6, mt 7-26, cols, colsdir and full 0-26), one commit group a pop; a
// pop waits for its own group, reads its columns from the staged row (all
// lanes one address, a broadcast), and hands its slot to the pop RING
// later. So the row loads, which a pop would otherwise issue per lane
// through L1 (27 float4, or 108 scalars in colsdir, all lanes one row),
// leave the pop's critical path, except where a pop is as small as
// rowload's and the ring's waits cost more than its one load (PERF.md).
// profiling/ab_p1.py times this form against an older checkout's, whose
// pops load their rows directly: the difference is a pop's load share.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float BIG = 3.0e38f;
constexpr int THREADS = 128;  // four packets of 32 lanes per block
constexpr int PACKET = 32;
constexpr int PACKETS = THREADS / PACKET;
constexpr int RING = 8;       // rows staged ahead, per packet
constexpr int ROW4 = 32;      // a 512-byte row = 32 float4
constexpr unsigned FULL_MASK = 0xffffffffu;

enum Mode { EMPTY = 0, ROWLOAD, COLS, COLSDIR, BOX, MT, FULLMODE };

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int off = PACKET / 2; off > 0; off /= 2)
    v = fminf(v, __shfl_xor_sync(FULL_MASK, v, off));
  return v;
}

// One 16-byte global -> shared copy in the lane's current commit group.
__device__ __forceinline__ void copy16(float4* dst, const float4* src) {
#ifdef __CUDA_ARCH__
  const unsigned a = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(a),
               "l"(src)
               : "memory");
#else
  *dst = *src;
#endif
}

__device__ __forceinline__ void commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;" ::: "memory");
#endif
}

// Wait until at most RING - 1 of the lane's groups are in flight: the
// oldest, the row of the pop about to run, has landed.
__device__ __forceinline__ void wait_oldest() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;" ::"n"(RING - 1) : "memory");
#endif
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
p1_kernel(const float* __restrict__ fat, int m, const float* __restrict__ o,
          const float* __restrict__ d, int n, int pops,
          float* __restrict__ t_out, int* __restrict__ sink_out) {
  extern __shared__ float4 smem[];  // the packets' rings, then their stacks
  const int packet = threadIdx.x / PACKET, lane = threadIdx.x % PACKET;
  float4* ring = smem + packet * RING * ROW4;
  int* stack = (int*)(smem + PACKETS * RING * ROW4) + packet * pops;
  for (int i = lane; i < pops; i += PACKET) {
    const int v = (int)((unsigned)i * 1103515245u + 12345u);
    const int r = v % m;
    stack[i] = r < 0 ? r + m : r;
  }
  __syncwarp();
  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  if (ray - lane >= n) return;  // n is a multiple of the packet
  const float ox = o[3 * ray], oy = o[3 * ray + 1], oz = o[3 * ray + 2];
  const float dx = d[3 * ray], dy = d[3 * ray + 1], dz = d[3 * ray + 2];
  const float ivx = 1.0f / dx, ivy = 1.0f / dy, ivz = 1.0f / dz;
  float best_t = BIG;
  unsigned acc = 0u, sink = 0u;
  // the float4 of a row this mode reads, [Q_LO, Q_HI): lane q stages q
  constexpr int Q_LO = MODE == MT ? 7 : 0;
  constexpr int Q_HI = MODE == ROWLOAD ? 1 : MODE == BOX ? 7 : 27;
  const bool stager = lane >= Q_LO && lane < Q_HI;
  const float4* fat4 = (const float4*)fat;
  // pop k reads the row of stack[pops - 1 - k] from ring slot k % RING
  auto stage = [&](int k) {
    if (stager && k < pops)
      copy16(ring + (k % RING) * ROW4 + lane,
             fat4 + (size_t)stack[pops - 1 - k] * ROW4 + lane);
    commit();
  };
  if (MODE != EMPTY)
    for (int k = 0; k < RING; ++k) stage(k);
  int sp = pops;
  for (int k = 0; sp > 0; ++k) {
    const int node = stack[sp - 1];
    sp -= 1;
    if (MODE == EMPTY) {
      acc += (unsigned)node;
      continue;
    }
    wait_oldest();
    __syncwarp();
    const float4* row4 = ring + (k % RING) * ROW4;
    const float* row = (const float*)row4;
    if (MODE == ROWLOAD) {
      acc += (unsigned)(int)row4[0].x;
    } else if (MODE == COLS || MODE == COLSDIR) {
      float c[108];
      if (MODE == COLS) {
#pragma unroll
        for (int q = 0; q < 27; ++q) {
          const float4 v = row4[q];
          c[4 * q] = v.x;
          c[4 * q + 1] = v.y;
          c[4 * q + 2] = v.z;
          c[4 * q + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 108; ++j) c[j] = row[j];
      }
      float s = c[0];
#pragma unroll
      for (int j = 1; j < 108; ++j) s = s + c[j];
      acc += (unsigned)(int)s;
    } else {
      float r[108];
#pragma unroll
      for (int q = 0; q < 27; ++q) {
        if ((MODE == BOX && q >= 7) || (MODE == MT && q < 7)) continue;
        const float4 v = row4[q];
        r[4 * q] = v.x;
        r[4 * q + 1] = v.y;
        r[4 * q + 2] = v.z;
        r[4 * q + 3] = v.w;
      }
      float key[4];
      int cval[4];
      if (MODE == BOX || MODE == FULLMODE) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float t0x = (r[c * 3] - ox) * ivx;
          const float t1x = (r[12 + c * 3] - ox) * ivx;
          const float t0y = (r[c * 3 + 1] - oy) * ivy;
          const float t1y = (r[12 + c * 3 + 1] - oy) * ivy;
          const float t0z = (r[c * 3 + 2] - oz) * ivz;
          const float t1z = (r[12 + c * 3 + 2] - oz) * ivz;
          const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                                 fminf(t0z, t1z));
          const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                                 fmaxf(t0z, t1z));
          const bool lane_hit = tn <= tf && tf > 0.0f && tn < best_t;
          const float tn_c = warp_min(lane_hit ? tn : BIG);
          const bool hit_any = __any_sync(FULL_MASK, lane_hit);
          const int child = (int)r[24 + c];
          sink += (unsigned)hit_any + (unsigned)__float_as_int(tn_c);
          key[c] = hit_any && child >= 0 ? tn_c : -BIG;
          cval[c] = hit_any && child >= 0 ? child : -1;
        }
      }
      if (MODE == MT || MODE == FULLMODE) {
#pragma unroll
        for (int k8 = 0; k8 < 8; ++k8) {
          const float* tr = r + 28 + 10 * k8;
          const int tid = (int)tr[9];
          const float e1x = tr[3], e1y = tr[4], e1z = tr[5];
          const float e2x = tr[6], e2y = tr[7], e2z = tr[8];
          const float px = dy * e2z - dz * e2y;
          const float py = dz * e2x - dx * e2z;
          const float pz = dx * e2y - dy * e2x;
          const float det = e1x * px + e1y * py + e1z * pz;
          const float inv_det = 1.0f / det;
          const float tx = ox - tr[0], ty = oy - tr[1], tz = oz - tr[2];
          const float beta = (tx * px + ty * py + tz * pz) * inv_det;
          const float qx = ty * e1z - tz * e1y;
          const float qy = tz * e1x - tx * e1z;
          const float qz = tx * e1y - ty * e1x;
          const float gamma = (dx * qx + dy * qy + dz * qz) * inv_det;
          const float tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
          const bool ok = tid >= 0 && beta >= 0.0f && gamma >= 0.0f
                          && beta + gamma <= 1.0f && tt > 1e-4f
                          && tt < best_t;
          if (ok) best_t = tt;
        }
      }
      if (MODE == FULLMODE) {
#define CRAY_SWAP(i, j)                                           \
  if (key[i] < key[j]) {                                          \
    const float tk = key[i]; key[i] = key[j]; key[j] = tk;        \
    const int tc = cval[i]; cval[i] = cval[j]; cval[j] = tc;      \
  }
        CRAY_SWAP(0, 1)
        CRAY_SWAP(2, 3)
        CRAY_SWAP(0, 2)
        CRAY_SWAP(1, 3)
        CRAY_SWAP(1, 2)
#undef CRAY_SWAP
        // the pushes stay masked off (sp < 0 never holds), so the trip
        // count stays `pops`
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (cval[q] >= 0 && sp < 0) stack[sp++] = cval[q];
        acc += (unsigned)cval[0];
      }
    }
    __syncwarp();  // every lane is done with the slot: refill it
    stage(k + RING);
  }
  t_out[ray] = best_t + (float)(int)acc;
  sink_out[ray] = (int)sink;
}

template <int MODE>
int launch(const float* fat, int m, const float* o, const float* d, int n,
           int pops, float* t_out, int* sink_out, cudaStream_t stream) {
  const int blocks = (n + THREADS - 1) / THREADS;
  const size_t smem = (size_t)PACKETS * (RING * ROW4 * sizeof(float4)
                                         + pops * sizeof(int));
  const int err = (int)cudaFuncSetAttribute(
      p1_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err) return err;
  p1_kernel<MODE><<<blocks, THREADS, smem, stream>>>(fat, m, o, d, n, pops,
                                                      t_out, sink_out);
  return (int)cudaGetLastError();
}

}  // namespace

// mode: 0 empty, 1 rowload, 2 cols, 3 colsdir, 4 box, 5 mt, 6 full. The
// wrapper checks n % 32 == 0 and pops <= 3072 (four packets' rings and
// stacks in 64 KB of shared memory, past the 48 KB default).
extern "C" int p1_launch(const float* fat, int m, const float* o,
                         const float* d, int n, int pops, int mode,
                         float* t_out, int* sink_out, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case EMPTY: return launch<EMPTY>(fat, m, o, d, n, pops, t_out, sink_out, s);
    case ROWLOAD:
      return launch<ROWLOAD>(fat, m, o, d, n, pops, t_out, sink_out, s);
    case COLS: return launch<COLS>(fat, m, o, d, n, pops, t_out, sink_out, s);
    case COLSDIR:
      return launch<COLSDIR>(fat, m, o, d, n, pops, t_out, sink_out, s);
    case BOX: return launch<BOX>(fat, m, o, d, n, pops, t_out, sink_out, s);
    case MT: return launch<MT>(fat, m, o, d, n, pops, t_out, sink_out, s);
    case FULLMODE:
      return launch<FULLMODE>(fat, m, o, d, n, pops, t_out, sink_out, s);
    default: return 1;  // cudaErrorInvalidValue
  }
}

extern "C" const char* cray_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
