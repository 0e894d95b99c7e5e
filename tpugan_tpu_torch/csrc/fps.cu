// Farthest point sampling over a padded batch.
//
// Replaces tpugan_tpu/ops/pallas/fps_kernel.py : fps_pallas and
// fps_pallas_batched (_fps_kernel, _fps_batched_kernel).
//
// Contract: pos [B,N,3] f32, penalty [B,N] f32 (0 valid, -1e10 invalid),
// start [B] int64 -> idx [B,m] int64. idx[:,0] = start; then each round
//   mind = min(mind, |p - p_sel|^2 + penalty)   (mind starts at the start's)
//   next = argmax(mind), the lowest index on a tie.
// The distance is the direct difference ((dx*dx + dy*dy) + dz*dz) in round-
// to-nearest f32 with no fused multiply-add, the order of the JAX package's
// fps (neighbors.py) and of the plain version, so the selections agree
// index for index.
//
// What bounds it on the H100: neither bytes nor operations but the latency
// of a round. The m rounds are sequential, and each is a pass over the row
// and an argmax over it: the train step's largest call (12 rows, 9,216 ->
// 1,024) does 113 M distance updates, about 10 us of the f32 rate, in
// 1,023 rounds. So the design cuts the cost of a round: the pass over the
// row spread over enough SMs that it takes few instructions a thread, and
// one synchronisation a round, with as few dependent warp-wide steps as the
// tie rule allows.
//
// Design: the wrapper (ops/kernels/fps.py : fps_plan) picks one of two
// kernels and its shape. Every owner is contiguous and ascending: block c
// of a row owns [c S, (c+1) S), S = threads * PPT, and thread t of it
// [c S + t PPT, c S + (t+1) PPT), keeping those points' (x, y, z, penalty,
// mind) in registers, PPT slots with no dead unrolled one. So a lower lane,
// warp, slot or block holds only lower indices, and "the lowest index on a
// tie" is "the first owner on a tie" at every level. A round:
// - each thread updates its mind and takes its argmax, a tree over its
//   slots in which the higher half wins only when strictly larger;
// - the warp's winner: __reduce_max_sync over an order-preserving 32-bit
//   key of the value, then the first lane holding that key
//   (__ballot_sync); its point's coordinates are read from the block's copy
//   of its slice in shared memory.
// - fps_warp: a row on one warp (up to 32 points a lane). The warp's
//   winner is the selection: no barrier at all.
// - fps_cluster: a row on a thread-block cluster of C blocks. Each warp's
//   winner (x, y, z, key, index) goes into slot c W + w of buffer r & 1 in
//   every block: st.async from one lane per block, each completing its
//   bytes on that block's mbarrier r & 1, on which the block then waits
//   (with C = 1 a plain store and a block barrier). Every warp reduces the
//   slots of its own block the same way (largest key, first slot holding
//   it) and reads the winner's coordinates from its slot: every thread
//   then holds the selection, with no second synchronisation and no read
//   of the row. Two buffers make one wait a round safe: a block stores into
//   buffer r & 1 again in round r + 2, after it has received every peer's
//   round r + 1 slots, which a peer's warp sends only after it has read
//   round r's buffer. A cluster barrier at the start (the mbarriers are
//   initialised and every block has started before a peer stores into it)
//   and one at the end (no block exits while a peer may still store into
//   it) close the launch. Not barrier.cluster in the loop: its release /
//   acquire round costs 0.39-0.46 us on the H100 against 0.15-0.19 us for
//   st.async and the mbarrier up to 8 blocks (tools/cluster_round_probe.cu,
//   PERF.md).
//
// Where trouble is likely:
// - The key keeps > exactly: -0.0 is mapped to +0.0 before the bits are
//   taken (fminf and > treat them as equal, the raw bit map does not); the
//   map sends the -1e10-penalty values (negative) below every valid
//   distance, in the order of their values, and an empty slot's -inf to
//   key 0, below every point's. No NaN arises: positions and penalties are
//   finite, and so is every distance.
// - Ties across blocks and warps: the first-owner rule is the lowest index
//   only because every owner's points are contiguous and ascending; a
//   layout that strides points over threads would need the index compared.
// - Exhaustion: when m exceeds the row's valid points, the argmax goes on
//   over the same values as the plain version's (selected valid points at
//   0, then the -1e10 points in the order of their values), through the
//   same key and owner rule.
// - Registers: chip_smoke.py checks every instance for spills (0 bytes);
//   fps_warp's launch bound (32 threads) leaves up to 255 registers for its
//   32 x 5, fps_cluster's (256 threads) as many for its 16 x 5.
#include "common.cuh"

#include <utility>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARP_PPT_MAX = 32;
constexpr int CLUSTER_PPT_MAX = 16;
constexpr int CLUSTER_THREADS_MAX = 256;
constexpr int CLUSTER_MAX = 16;           // above 8 a non-portable size
constexpr unsigned SLOT_BYTES = 20;       // what a slot's two st.async carry

// A warp's winner as it lands in a block's shared memory (32 bytes): the
// coordinates and the key in one 16-byte store, the index in another.
struct alignas(16) Slot {
  float x, y, z;
  unsigned key;
  int idx;
};

__device__ __forceinline__ float sqdist3(float px, float py, float pz,
                                         float sx, float sy, float sz) {
  const float dx = __fsub_rn(px, sx), dy = __fsub_rn(py, sy),
              dz = __fsub_rn(pz, sz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Order-preserving key: a > b (floats, not NaN) iff key(a) > key(b); -inf
// (no point) is 0, below every finite value's key.
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(__fadd_rn(v, 0.0f));   // -0 -> +0
  const unsigned key = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return v == -CUDART_INF_F ? 0u : key;
}

// Copy points [first, first + len) of a row into pts as (x, y, z, penalty),
// every thread of the block a share, coalesced.
__device__ __forceinline__ void stage_slice(const float* pb, const float* qb,
                                            int first, int len, float4* pts,
                                            int t, int T) {
  for (int i = t; i < len; i += T) {
    const int g = first + i;
    pts[i] = make_float4(pb[3 * g], pb[3 * g + 1], pb[3 * g + 2], qb[g]);
  }
}

// A thread's PPT contiguous points in registers (slot k is point
// base + k), or none (mind -inf: never the argmax) past the row's end.
template <int PPT>
struct Points {
  float x[PPT], y[PPT], z[PPT], q[PPT], d[PPT];

  // from the block's staged slice: local index `local` is point base
  __device__ __forceinline__ void load(const float4* pts, int local, int left) {
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const float4 p = k < left ? pts[local + k]
                                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      x[k] = p.x;
      y[k] = p.y;
      z[k] = p.z;
      q[k] = p.w;
      d[k] = k < left ? CUDART_INF_F : -CUDART_INF_F;  // the first update sets it
    }
  }

  // mind = min(mind, |p - s|^2 + penalty), then the thread's argmax of it:
  // a tree over the slots in which the higher half wins only when strictly
  // larger, so a tie keeps the lowest slot. Returns the key; `slot` its k.
  __device__ __forceinline__ unsigned update_argmax(float sx, float sy,
                                                    float sz, int& slot) {
    float v[PPT];
    int kk[PPT];
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      d[k] = fminf(d[k], __fadd_rn(sqdist3(x[k], y[k], z[k], sx, sy, sz), q[k]));
      v[k] = d[k];
      kk[k] = k;
    }
#pragma unroll
    for (int h = 1; h < PPT; h *= 2) {
#pragma unroll
      for (int k = 0; k + h < PPT; k += 2 * h) {
        if (v[k + h] > v[k]) {
          v[k] = v[k + h];
          kk[k] = kk[k + h];
        }
      }
    }
    slot = kk[0];
    return order_key(v[0]);
  }
};

// The warp's largest key on every lane, and the first lane holding it.
__device__ __forceinline__ int warp_first_max(unsigned& key) {
  const unsigned top = __reduce_max_sync(FULL, key);
  const int lane = __ffs(__ballot_sync(FULL, key == top)) - 1;
  key = top;
  return lane;
}

template <int PPT>
__global__ void __launch_bounds__(32)
fps_warp(const float* __restrict__ pos, const float* __restrict__ penalty,
         const long long* __restrict__ start, long long* __restrict__ out,
         int N, int m) {
  extern __shared__ float4 pts[];          // [N] the row
  const int b = blockIdx.x, lane = threadIdx.x;
  const float* pb = pos + (size_t)b * N * 3;
  long long* ob = out + (size_t)b * m;
  stage_slice(pb, penalty + (size_t)b * N, 0, N, pts, lane, 32);
  __syncwarp();
  Points<PPT> p;
  p.load(pts, lane * PPT, N - lane * PPT);
  const int s = (int)start[b];
  float4 sel = pts[s];
  if (lane == 0) ob[0] = s;
  for (int r = 1; r < m; ++r) {
    int slot;
    unsigned key = p.update_argmax(sel.x, sel.y, sel.z, slot);
    const int owner = warp_first_max(key);
    const int idx = owner * PPT + __shfl_sync(FULL, slot, owner);
    sel = pts[idx];
    if (lane == 0) ob[r] = idx;
  }
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_size() {
  unsigned n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(n));
  return n;
}

// Every thread of the cluster: once before the loop and once after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// The address of the same shared-memory object in block `rank`.
__device__ __forceinline__ unsigned peer_addr(unsigned local, unsigned rank) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote) : "r"(local), "r"(rank));
  return remote;
}

// Store a warp's winner into the peer's slot at `slot`; the two stores
// complete SLOT_BYTES on the peer's mbarrier at `bar` (both peer addresses).
__device__ __forceinline__ void send_slot(unsigned slot, unsigned bar,
                                          float4 p, unsigned key, int idx) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32"
      " [%0], {%1, %2, %3, %4}, [%5];"
      :: "r"(slot), "r"(__float_as_uint(p.x)), "r"(__float_as_uint(p.y)),
         "r"(__float_as_uint(p.z)), "r"(key), "r"(bar) : "memory");
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32"
      " [%0+16], %1, [%2];"
      :: "r"(slot), "r"(idx), "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{ .reg .pred p;"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;"
        " selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

template <int PPT>
__global__ void __launch_bounds__(CLUSTER_THREADS_MAX, 1)
fps_cluster(const float* __restrict__ pos, const float* __restrict__ penalty,
            const long long* __restrict__ start, long long* __restrict__ out,
            int N, int m) {
  // [2][C W] slots, then 2 mbarriers, then the block's slice of the row
  extern __shared__ __align__(16) unsigned char smem[];
  const unsigned C = cluster_size(), rank = cluster_rank();
  const int b = blockIdx.x / C;
  const int T = blockDim.x, W = T >> 5, t = threadIdx.x, w = t >> 5,
            lane = t & 31;
  const int nslot = C * W, per_lane = (nslot + 31) >> 5;
  Slot* slots = reinterpret_cast<Slot*>(smem);
  unsigned long long* mbar =
      reinterpret_cast<unsigned long long*>(slots + 2 * nslot);
  float4* pts = reinterpret_cast<float4*>(mbar + 2);
  const float* pb = pos + (size_t)b * N * 3;
  long long* ob = out + (size_t)b * m;
  const bool writer = rank == 0 && t == T - 1;   // not the mbarrier's thread
  const int first = rank * T * PPT;       // the block's slice starts here

  stage_slice(pb, penalty + (size_t)b * N, first,
              max(0, min(T * PPT, N - first)), pts, t, T);
  if (t == 0) {
    for (int i = 0; i < 2; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(smem_addr(&mbar[i])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  const int s = (int)start[b];
  float sx = pb[3 * s], sy = pb[3 * s + 1], sz = pb[3 * s + 2];
  if (writer) ob[0] = s;
  // lane c < C sends its warp's winner into block c: the peer addresses
  // of its slot and mbarrier in each buffer
  const unsigned to = lane < (int)C ? lane : rank,
                 to_slot0 = peer_addr(smem_addr(slots + rank * W + w), to),
                 to_slot1 = peer_addr(smem_addr(slots + nslot + rank * W + w), to),
                 to_bar0 = peer_addr(smem_addr(&mbar[0]), to),
                 to_bar1 = peer_addr(smem_addr(&mbar[1]), to);
  cluster_sync();
  Points<PPT> p;
  p.load(pts, t * PPT, N - first - t * PPT);

  for (int r = 1; r < m; ++r) {
    const int par = r & 1;
    int slot;
    unsigned key = p.update_argmax(sx, sy, sz, slot);
    const int owner = warp_first_max(key);
    const int local = (w * 32 + owner) * PPT + __shfl_sync(FULL, slot, owner);
    Slot* buf = slots + par * nslot;
    if (lane < (int)C) {
      const float4 pt = pts[local];   // the winner's, or past the slice's end
      if (C == 1) {                   // one block: a plain store, a barrier
        *reinterpret_cast<float4*>(buf + w) =
            make_float4(pt.x, pt.y, pt.z, __uint_as_float(key));
        buf[w].idx = first + local;
      } else {
        send_slot(par ? to_slot1 : to_slot0, par ? to_bar1 : to_bar0, pt, key,
                  first + local);
      }
    }
    if (C == 1) {
      __syncthreads();
    } else {
      if (t == 0)
        asm volatile(
            "mbarrier.arrive.expect_tx.release.cta.shared::cta.b64 _, [%0], %1;"
            :: "r"(smem_addr(&mbar[par])), "r"(nslot * SLOT_BYTES) : "memory");
      mbar_wait(smem_addr(&mbar[par]), ((r - 1) >> 1) & 1);  // its use count
    }
    // the cluster's winner: the largest key, the first slot holding it;
    // up to 32 slots one a lane (lanes past the last repeat it), more a
    // contiguous run of slots a lane
    unsigned bk = 0u;
    int bs = min(lane, nslot - 1);
    if (nslot <= 32) {
      bk = buf[bs].key;
    } else {
      for (int i = lane * per_lane, e = min(nslot, i + per_lane); i < e; ++i) {
        if (buf[i].key > bk) {
          bk = buf[i].key;
          bs = i;
        }
      }
    }
    const int from = warp_first_max(bk);
    const Slot& win = buf[nslot <= 32 ? from : __shfl_sync(FULL, bs, from)];
    sx = win.x;
    sy = win.y;
    sz = win.z;
    if (writer) ob[r] = win.idx;
  }
  cluster_sync();
}

using Launch = cudaError_t (*)(const float*, const float*, const long long*,
                               long long*, int, int, int, int, int,
                               cudaStream_t);

template <int PPT>
cudaError_t launch_warp(const float* pos, const float* penalty,
                        const long long* start, long long* out, int B, int N,
                        int m, int, int, cudaStream_t stream) {
  fps_warp<PPT><<<B, 32, (size_t)N * sizeof(float4), stream>>>(
      pos, penalty, start, out, N, m);
  return cudaGetLastError();
}

template <int PPT>
cudaError_t launch_cluster(const float* pos, const float* penalty,
                           const long long* start, long long* out, int B,
                           int N, int m, int C, int T, cudaStream_t stream) {
  auto kernel = fps_cluster<PPT>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * C);
  cfg.blockDim = dim3(T);
  cfg.dynamicSmemBytes = 2 * (size_t)C * (T / 32) * sizeof(Slot) +
                         2 * sizeof(unsigned long long) +
                         (size_t)T * PPT * sizeof(float4);
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)cfg.dynamicSmemBytes);
  if (e != cudaSuccess) return e;
  if (C > 8) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    int fits = 0;
    e = cudaOccupancyMaxActiveClusters(&fits, kernel, &cfg);
    if (e != cudaSuccess) return e;
    if (fits == 0) return cudaErrorInvalidConfiguration;
  }
  e = cudaLaunchKernelEx(&cfg, kernel, pos, penalty, start, out, N, m);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// The instance for ppt points a thread, of 1..sizeof...(P).
template <template <int> class Kind, int... P>
Launch pick(int ppt, std::integer_sequence<int, P...>) {
  static constexpr Launch table[] = {Kind<P + 1>::fn...};
  return table[ppt - 1];
}

template <int PPT> struct Warp { static constexpr Launch fn = launch_warp<PPT>; };
template <int PPT> struct Cluster { static constexpr Launch fn = launch_cluster<PPT>; };

}  // namespace

// variant 0: fps_warp (threads 32, cluster 1, ppt <= 32, 32 ppt >= N);
// variant 1: fps_cluster (cluster 1..16 blocks a row, threads a multiple of
// 32 up to 256, ppt <= 16, cluster * threads * ppt >= N). Other shapes
// return cudaErrorInvalidValue. The wrapper (ops/kernels/fps.py) admits
// 1 <= N, m >= 1, start in [0, N), all tensors contiguous on one device.
extern "C" int fps_f32(const void* pos, const void* penalty, const void* start,
                       void* idx, int B, int N, int m, int variant,
                       int cluster, int threads, int ppt, void* stream) {
  auto p = static_cast<const float*>(pos);
  auto q = static_cast<const float*>(penalty);
  auto s = static_cast<const long long*>(start);
  auto o = static_cast<long long*>(idx);
  auto st = static_cast<cudaStream_t>(stream);
  const long long covers = (long long)cluster * threads * ppt;
  if (variant == 0 && threads == 32 && cluster == 1 && ppt >= 1 &&
      ppt <= WARP_PPT_MAX && covers >= N)
    return static_cast<int>(
        pick<Warp>(ppt, std::make_integer_sequence<int, WARP_PPT_MAX>())(
            p, q, s, o, B, N, m, 1, 32, st));
  if (variant == 1 && cluster >= 1 && cluster <= CLUSTER_MAX &&
      threads % 32 == 0 && threads >= 32 && threads <= CLUSTER_THREADS_MAX &&
      ppt >= 1 && ppt <= CLUSTER_PPT_MAX && covers >= N)
    return static_cast<int>(
        pick<Cluster>(ppt, std::make_integer_sequence<int, CLUSTER_PPT_MAX>())(
            p, q, s, o, B, N, m, cluster, threads, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
