// Exact masked 1-NN correspondence for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the JAX package, which compute the
// same thing with two register layouts:
//   K1  icp_tpu/ops/fused_nn.py  _fused_nn_kernel  (wrapper fused_nearest_neighbors,
//       optionally returning the matched target coordinates)
//   K2  icp_tpu/ops/pallas_nn.py _nn_kernel        (wrapper nearest_neighbors_pallas,
//       (sq, idx) only)
// Here both are one template, with the coordinate output switched on (K1) or
// off (K2).
//
// Contract (the one icp_tpu/ops/nn.py defines and tests/test_fused_nn.py pins):
//   * sq[i]  = min over valid targets j of sum_d (q[i,d] - t[j,d])^2, summed in
//     coordinate order as ((d0*d0) + d1*d1) + d2*d2;
//   * idx[i] = the lowest such j on ties;
//   * coords[i] = t[idx[i]] (K1 only);
//   * a row with no valid target ends as (+inf, 0) and coordinates 0.
// The subtract, multiply and add are the round-to-nearest intrinsics, so nvcc
// cannot contract them into an FMA and sq is bit-equal to the plain PyTorch
// version, which runs them as separate elementwise kernels.  Inputs are finite
// (from_points drops non-finite rows; padding rows are 0).
//
// What bounds it on the card: instruction issue.  A pair needs D subtracts,
// D multiplies and D - 1 adds that may not fuse: 5 instructions at D = 2.  An
// SM issues one warp instruction per cycle on each of its 4 sub-partitions, so
// at (B, N, M, D) = (1024, 1024, 1024, 2) those 5 alone take 0.160 ms at
// 1.98 GHz on 132 SMs.  HBM traffic is O(B (N + M) D), ~35 MB, ~10 us.
//
// Design, per pair as few instructions beyond those 5 as possible:
//   1. Targets in shared memory.  A block stages its lanes' targets in dynamic
//      shared memory (above 48 KB after cudaFuncSetAttribute), a whole lane at
//      once when it fits in the stage budget, else in stages.  Each target is
//      padded to 2 or 4 coordinates; the loop reads 16-byte packs (two float2
//      targets per LDS.128 at D = 2), and every thread of a warp reads the
//      same pack, a broadcast without bank conflicts.
//   2. The mask is folded in while staging: a masked target, and the padding
//      up to a whole chunk, is +inf in every coordinate, so the loop has no
//      mask load and no test.  For a finite query q - inf = -inf, its square
//      +inf, and a sum of +inf and squares +inf: never NaN (there is no
//      inf - inf), and a strict '<' against a best that starts at +inf never
//      takes it.  A row with no valid target keeps (+inf, 0).
//   3. Each thread owns kQ queries in registers, so one pack load feeds
//      2 kQ pairs.  The threads of one lane are whole warps; where N is small,
//      one block holds several lanes so that the coarse level still fills
//      the card.
//   4. Chunk minimum, lazy index.  Over a chunk of kChunk targets the loop
//      keeps only the minimum, in two chains per query; in float, a chain
//      takes a pair of distances at a time with one VIMNMX3 (Hopper's DPX
//      three-way integer minimum, exact on the bit patterns of floats >= +0).  After the chunk, only a strict
//      improvement of the query's best records the chunk's start (one
//      compare and two predicated moves per query and chunk).
//      At the end of a stage the recorded chunk is scanned again for the
//      lowest index with that value.  This is the tie rule of the contract:
//      the recorded chunk is the first one that reached the final minimum
//      (later equal chunks fail the strict '<'), and the rescan takes its
//      lowest index.  The distances of the rescan are computed by the same
//      instructions, so they are bit-equal to the chunk's.
//   5. Coordinates are read once at the end: K1 loads t[idx] from device
//      memory for each query (0 where sq is +inf).  That equals carrying them
//      through the loop, since the carried values were copies of target rows.
//   At D = 2 in float, with kChunk = 8 and kQ = 4, the chunk loop is 6.25
//   instructions per pair: the 5 arithmetic ones, 0.625 for the minima,
//   0.375 for the chunk bookkeeping, 0.125 each for the shared-memory loads
//   and the loop.  Its measured time is about 1.25x what that count takes
//   at the sampled SM clock: ~80% of that issue rate, derived from the SASS
//   count and the sampled clock, not profiled (PERF.md).
//
// Not used, and why:
//   * Tensor cores.  wgmma needs the |q|^2 - 2 q.t + |t|^2 form, which cancels
//     in float32 and is not bit-equal to the plain version (icp_tpu/ops/nn.py,
//     pairwise_sq_dists), and D = 2 or 3 is far below its depth of 16.
//   * cp.async double buffering of the stages.  Staging costs nothing it
//     could win back: on an H100 (chip_smoke.py, PERF.md), the fine shape's
//     grid with two stages per lane, (1024, 1024, 8192, 2), runs 2% more
//     pairs per second than the one-stage fine shape.  Few lanes with many
//     targets, e.g. (2, 512, 40000, 2), are slow for another reason: one
//     block per lane leaves most SMs idle.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 128;  // threads per block at most, a multiple of 32
constexpr int kQ = 4;          // queries per thread
constexpr int kChunk = 8;      // targets per chunk minimum, a multiple of 4
// A stage may take this share of the SM's shared memory (less what CUDA
// reserves per block), so that four blocks stay resident on an SM.
constexpr int kBlocksPerSm = 4;
static_assert(kThreads % 32 == 0 && kThreads <= 1024, "whole warps");
static_assert(kChunk % 4 == 0, "a chunk holds whole packs, and pairs of pairs");

template <typename T>
struct Arith;

template <>
struct Arith<float> {
  static __device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float min(float a, float b) { return fminf(a, b); }
  // Squared distances are +0 or more (or +inf), and such floats order as
  // their bit patterns do as signed integers: one DPX three-way minimum.
  static __device__ __forceinline__ float min3(float a, float b, float c) {
    return __int_as_float(__vimin3_s32(__float_as_int(a), __float_as_int(b), __float_as_int(c)));
  }
};

template <>
struct Arith<double> {
  static __device__ __forceinline__ double inf() {
    return __longlong_as_double(0x7ff0000000000000LL);
  }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double min(double a, double b) { return fmin(a, b); }
  static __device__ __forceinline__ double min3(double a, double b, double c) {
    return fmin(fmin(a, b), c);
  }
};

// One target in shared memory, its D coordinates padded to W = 2 or 4.
template <typename T, int D>
struct Width {
  static constexpr int kW = D == 2 ? 2 : 4;
  static constexpr int kBytes = int(sizeof(T)) * kW;
  static constexpr int kAlign = kBytes < 16 ? kBytes : 16;
  // Targets per 16-byte pack (1 when a target is 16 bytes or more).
  static constexpr int kPer = kBytes < 16 ? 16 / kBytes : 1;
};

template <typename T, int D>
struct alignas(Width<T, D>::kAlign) Pt {
  T c[Width<T, D>::kW];
};

template <typename T, int D>
struct alignas(16) Pack {
  Pt<T, D> p[Width<T, D>::kPer];
};

// Squared distance in the contract's order, with no contraction.
template <typename T, int D>
__device__ __forceinline__ T sq_dist(const T (&q)[D], const T* t) {
  using A = Arith<T>;
  T diff = A::sub(q[0], t[0]);
  T acc = A::mul(diff, diff);
#pragma unroll
  for (int d = 1; d < D; ++d) {
    diff = A::sub(q[d], t[d]);
    acc = A::add(acc, A::mul(diff, diff));
  }
  return acc;
}

// Grid: blocks_per_lane blocks for each group of lanes_per_block lanes, one
// block per (group, query block).  A block runs lanes_per_block * lane_threads
// threads; thread t of a lane owns the queries q0 + t + s * lane_threads,
// s < kQ, so each of its loads and stores is coalesced across the warp.
// `stage` (a multiple of kChunk) targets of each lane sit in shared memory at
// a time.
template <typename T, int D, bool COORDS>
__global__ void __launch_bounds__(kThreads)
nn_kernel(const T* __restrict__ query,          // (B, N, D)
          const T* __restrict__ targets,        // (B, M, D)
          const uint8_t* __restrict__ mask,     // (B, M) or null (all valid)
          int batch, int n, int m,
          int lane_threads, int lanes_per_block, int blocks_per_lane, int stage,
          T* __restrict__ out_sq,               // (B, N)
          int32_t* __restrict__ out_idx,        // (B, N)
          T* __restrict__ out_coords) {         // (B, N, D) when COORDS
  using A = Arith<T>;
  using P = Pt<T, D>;
  using K = Pack<T, D>;
  constexpr int kW = Width<T, D>::kW;
  constexpr int kPer = Width<T, D>::kPer;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  P* const smem = reinterpret_cast<P*>(smem_raw);

  const int group = threadIdx.x / lane_threads;
  const int t = threadIdx.x - group * lane_threads;
  const int64_t lane0 = int64_t(blockIdx.x / blocks_per_lane) * lanes_per_block;
  const int64_t lane = lane0 + group;
  const int q0 = (blockIdx.x % blocks_per_lane) * lane_threads * kQ + t;
  const bool lane_live = lane < batch;

  T q[kQ][D];
  T best[kQ];
  int32_t best_j[kQ];
  int pend[kQ];  // start of the chunk that last improved best in this stage, or -1
#pragma unroll
  for (int s = 0; s < kQ; ++s) {
    const int i = q0 + s * lane_threads;
    const bool live = lane_live && i < n;
#pragma unroll
    for (int d = 0; d < D; ++d) q[s][d] = live ? query[(lane * n + i) * D + d] : T(0);
    best[s] = A::inf();
    best_j[s] = 0;
    pend[s] = -1;
  }

  const P* tile = smem + group * stage;
  const K* packs = reinterpret_cast<const K*>(tile);

  for (int base = 0; base < m; base += stage) {
    const int len = min(stage, m - base);
    const int padded = (len + kChunk - 1) / kChunk * kChunk;
    __syncthreads();  // the previous stage is no longer read
    // The mask and coordinate loads do not wait on each other, and the
    // unrolled iterations keep several of them in flight.
#pragma unroll 4
    for (int e = threadIdx.x; e < lanes_per_block * padded; e += blockDim.x) {
      const int g = e / padded;
      const int j = e - g * padded;
      const int64_t row = (lane0 + g) * m + base + j;
      P p;
#pragma unroll
      for (int d = 0; d < kW; ++d) p.c[d] = A::inf();
      if (lane0 + g < batch && j < len) {
        T v[D];
#pragma unroll
        for (int d = 0; d < D; ++d) v[d] = __ldg(targets + row * D + d);
        const bool valid = mask == nullptr || __ldg(mask + row) != 0;
#pragma unroll
        for (int d = 0; d < D; ++d) p.c[d] = valid ? v[d] : A::inf();
      }
      smem[g * stage + j] = p;
    }
    __syncthreads();

    for (int c0 = 0; c0 < padded; c0 += kChunk) {
      // The chunk's minimum in two chains per query (pairs of targets 0, 2, ...
      // and 1, 3, ...), each step a three-way minimum of the chain and a pair.
      T lo0[kQ], lo1[kQ], prev[kQ];
#pragma unroll
      for (int k = 0; k < kChunk / kPer; ++k) {
        const K pk = packs[c0 / kPer + k];
#pragma unroll
        for (int u = 0; u < kPer; ++u) {
          const int e = k * kPer + u;
#pragma unroll
          for (int s = 0; s < kQ; ++s) {
            const T dd = sq_dist<T, D>(q[s], pk.p[u].c);
            if (e & 1) {
              T& lo = (e & 2) ? lo1[s] : lo0[s];
              lo = e < 4 ? A::min(prev[s], dd) : A::min3(lo, prev[s], dd);
            } else {
              prev[s] = dd;
            }
          }
        }
      }
#pragma unroll
      for (int s = 0; s < kQ; ++s) {
        const T cm = A::min(lo0[s], lo1[s]);
        if (cm < best[s]) {
          best[s] = cm;
          pend[s] = c0;
        }
      }
    }

    // The lowest index of each recorded chunk that reaches best.
#pragma unroll
    for (int s = 0; s < kQ; ++s) {
      if (pend[s] >= 0) {
        int found = 0;
        for (int k = kChunk - 1; k >= 0; --k) {
          if (sq_dist<T, D>(q[s], tile[pend[s] + k].c) == best[s]) found = k;
        }
        best_j[s] = base + pend[s] + found;
        pend[s] = -1;
      }
    }
  }

  if (!lane_live) return;
#pragma unroll
  for (int s = 0; s < kQ; ++s) {
    const int i = q0 + s * lane_threads;
    if (i < n) {
      const int64_t row = lane * n + i;
      out_sq[row] = best[s];
      out_idx[row] = best_j[s];
      if (COORDS) {
        const bool none = !(best[s] < A::inf());
        const T* hit = targets + (lane * m + best_j[s]) * D;
#pragma unroll
        for (int d = 0; d < D; ++d) out_coords[row * D + d] = none ? T(0) : hit[d];
      }
    }
  }
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

template <typename T, int D, bool COORDS>
int launch(const void* query, const void* targets, const void* mask, void* out_sq,
           void* out_idx, void* out_coords, int batch, int n, int m, cudaStream_t stream) {
  using P = Pt<T, D>;
  // Threads per lane: whole warps, enough for N at kQ queries each, at most a
  // block.  Several lanes share a block where one needs fewer threads.
  const int lane_threads = std::min(kThreads, ceil_div(ceil_div(n, kQ), 32) * 32);
  const int lanes_per_block = kThreads / lane_threads;
  const int blocks_per_lane = ceil_div(n, lane_threads * kQ);
  const int64_t blocks = int64_t(ceil_div(batch, lanes_per_block)) * blocks_per_lane;
  if (blocks > 0x7fffffff) return int(cudaErrorInvalidConfiguration);

  int device = 0, optin = 0, per_sm = 0, reserved = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, device);
  }
  if (err != cudaSuccess) return int(err);
  // The whole padded lane if it fits in the budget, else the largest
  // multiple of kChunk that does.  On an H100: 233,472 / 4 - 1,024 = 57,344
  // bytes, 7,168 float2 targets.
  const int budget = std::min(optin, per_sm / kBlocksPerSm - reserved);
  const int cap = budget / (lanes_per_block * int(sizeof(P))) / kChunk * kChunk;
  const int stage = std::min(cap, ceil_div(std::max(m, 1), kChunk) * kChunk);
  if (stage <= 0) return int(cudaErrorInvalidValue);
  const size_t bytes = size_t(lanes_per_block) * stage * sizeof(P);
  if (bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(nn_kernel<T, D, COORDS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
    if (err != cudaSuccess) return int(err);
  }
  nn_kernel<T, D, COORDS><<<unsigned(blocks), lanes_per_block * lane_threads, bytes, stream>>>(
      static_cast<const T*>(query), static_cast<const T*>(targets),
      static_cast<const uint8_t*>(mask), batch, n, m, lane_threads, lanes_per_block,
      blocks_per_lane, stage, static_cast<T*>(out_sq), static_cast<int32_t*>(out_idx),
      static_cast<T*>(out_coords));
  return int(cudaGetLastError());
}

template <typename T, int D>
int launch_dim(const void* q, const void* t, const void* mk, void* sq, void* idx,
               void* coords, int batch, int n, int m, cudaStream_t s) {
  if (coords != nullptr) return launch<T, D, true>(q, t, mk, sq, idx, coords, batch, n, m, s);
  return launch<T, D, false>(q, t, mk, sq, idx, coords, batch, n, m, s);
}

template <typename T>
int launch_type(const void* q, const void* t, const void* mk, void* sq, void* idx,
                void* coords, int batch, int n, int m, int dim, cudaStream_t s) {
  if (dim == 2) return launch_dim<T, 2>(q, t, mk, sq, idx, coords, batch, n, m, s);
  if (dim == 3) return launch_dim<T, 3>(q, t, mk, sq, idx, coords, batch, n, m, s);
  return int(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry point, bound with ctypes.  Pointers are device pointers of
// contiguous tensors; mask and out_coords may be null.  Launches on `stream`
// without synchronising and returns the launch's error (0 on success).
extern "C" int icp_nn_launch(const void* query, const void* targets, const void* mask,
                             void* out_sq, void* out_idx, void* out_coords, int batch,
                             int n, int m, int dim, int is_double, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double) {
    return launch_type<double>(query, targets, mask, out_sq, out_idx, out_coords, batch, n,
                               m, dim, s);
  }
  return launch_type<float>(query, targets, mask, out_sq, out_idx, out_coords, batch, n, m,
                            dim, s);
}

extern "C" const char* icp_nn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
