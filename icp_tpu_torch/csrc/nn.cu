// Exact masked 1-NN correspondence for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the JAX package, which compute the
// same thing with two register layouts:
//   K1  icp_tpu/ops/fused_nn.py  _fused_nn_kernel  (wrapper fused_nearest_neighbors,
//       optionally carrying the matched target coordinates)
//   K2  icp_tpu/ops/pallas_nn.py _nn_kernel        (wrapper nearest_neighbors_pallas,
//       (sq, idx) only)
// Here both are one template, with the coordinate carry switched on (K1) or
// off (K2).
//
// Contract (the one icp_tpu/ops/nn.py defines and tests/test_fused_nn.py pins):
//   * sq[i]  = min over valid targets j of sum_d (q[i,d] - t[j,d])^2, summed in
//     coordinate order as ((d0*d0) + d1*d1) + d2*d2;
//   * idx[i] = the lowest such j on ties;
//   * coords[i] = t[idx[i]] (only with the carry on);
//   * a row with no valid target ends as (+inf, 0) and coordinates 0.
//
// Design.  Grid (ceil(N / 256), B), 256 threads, one query per thread.  Each
// block streams its lane's targets through shared memory in tiles of TILE
// targets (coordinates as structure of arrays, plus the mask).  Every thread
// scans the tile in index order and keeps (best_sq, best_idx, best_coords) in
// registers, replacing them only on strict '<': the first (lowest) index wins
// a tie with no extra fold, and a masked target never replaces the best.
// The subtract, multiply and add are written with the round-to-nearest
// intrinsics, so nvcc cannot contract them into an FMA and sq is bit-equal to
// the plain PyTorch version, which runs the same three operations as separate
// elementwise kernels.  No |q|^2 - 2 q.t + |t|^2 expansion: it cancels
// catastrophically in f32 (icp_tpu/ops/nn.py, pairwise_sq_dists).
//
// What bounds it on the card: FP32 ALU and shared-memory issue, not HBM.
// Each (query, target) pair costs ~3D flops plus a compare and selects, and
// D = 2 or 3 leaves no contraction deep enough for a tensor-core route.  HBM
// traffic is O(B (N + M) D).  All threads of a warp read the same tile entry,
// so every shared-memory load is a broadcast without bank conflicts.  Making
// it fast (several queries per thread in registers, vector loads of the tile,
// wider tiles) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;
constexpr int kMaxGridY = 65535;

template <typename T>
struct Arith;

template <>
struct Arith<float> {
  static __device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
};

template <>
struct Arith<double> {
  static __device__ __forceinline__ double inf() {
    return __longlong_as_double(0x7ff0000000000000LL);
  }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
};

template <typename T, int D, bool COORDS>
__global__ void __launch_bounds__(kThreads)
nn_kernel(const T* __restrict__ query,          // (B, N, D)
          const T* __restrict__ targets,        // (B, M, D)
          const uint8_t* __restrict__ mask,     // (B, M) or null (all valid)
          int n, int m,
          T* __restrict__ out_sq,               // (B, N)
          int32_t* __restrict__ out_idx,        // (B, N)
          T* __restrict__ out_coords) {         // (B, N, D) when COORDS
  using A = Arith<T>;
  __shared__ T tile[D][kTile];
  __shared__ uint8_t tile_mask[kTile];

  const int64_t lane = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < n;
  const T* t_lane = targets + lane * m * D;
  const uint8_t* m_lane = mask == nullptr ? nullptr : mask + lane * m;

  T q[D];
#pragma unroll
  for (int d = 0; d < D; ++d) q[d] = live ? query[(lane * n + i) * D + d] : T(0);

  T best = A::inf();
  int32_t best_idx = 0;
  T best_c[D];
#pragma unroll
  for (int d = 0; d < D; ++d) best_c[d] = T(0);

  for (int base = 0; base < m; base += kTile) {
    const int len = min(kTile, m - base);
    __syncthreads();  // the previous tile is no longer read
    // Coalesced copy of the (len, D) row-major slab into SoA shared memory.
    for (int e = threadIdx.x; e < len * D; e += kThreads) {
      tile[e % D][e / D] = t_lane[int64_t(base) * D + e];
    }
    for (int j = threadIdx.x; j < len; j += kThreads) {
      tile_mask[j] = m_lane == nullptr ? uint8_t(1) : m_lane[base + j];
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < len; ++j) {
      T diff = A::sub(q[0], tile[0][j]);
      T acc = A::mul(diff, diff);
#pragma unroll
      for (int d = 1; d < D; ++d) {
        diff = A::sub(q[d], tile[d][j]);
        acc = A::add(acc, A::mul(diff, diff));
      }
      if (tile_mask[j] != 0 && acc < best) {
        best = acc;
        best_idx = base + j;
        if (COORDS) {
#pragma unroll
          for (int d = 0; d < D; ++d) best_c[d] = tile[d][j];
        }
      }
    }
  }

  if (live) {
    const int64_t row = lane * n + i;
    out_sq[row] = best;
    out_idx[row] = best_idx;
    if (COORDS) {
#pragma unroll
      for (int d = 0; d < D; ++d) out_coords[row * D + d] = best_c[d];
    }
  }
}

template <typename T, int D, bool COORDS>
void launch(const void* query, const void* targets, const void* mask, void* out_sq,
            void* out_idx, void* out_coords, int batch, int n, int m, cudaStream_t stream) {
  const dim3 block(kThreads);
  const int blocks_x = (n + kThreads - 1) / kThreads;
  // gridDim.y is capped at 65535: larger batches go in slices of lanes.
  for (int b0 = 0; b0 < batch; b0 += kMaxGridY) {
    const int nb = min(kMaxGridY, batch - b0);
    const dim3 grid(blocks_x, nb);
    nn_kernel<T, D, COORDS><<<grid, block, 0, stream>>>(
        static_cast<const T*>(query) + int64_t(b0) * n * D,
        static_cast<const T*>(targets) + int64_t(b0) * m * D,
        mask == nullptr ? nullptr : static_cast<const uint8_t*>(mask) + int64_t(b0) * m,
        n, m,
        static_cast<T*>(out_sq) + int64_t(b0) * n,
        static_cast<int32_t*>(out_idx) + int64_t(b0) * n,
        COORDS ? static_cast<T*>(out_coords) + int64_t(b0) * n * D : nullptr);
  }
}

template <typename T, int D>
void launch_dim(const void* q, const void* t, const void* mk, void* sq, void* idx,
                void* coords, int batch, int n, int m, cudaStream_t s) {
  if (coords != nullptr) {
    launch<T, D, true>(q, t, mk, sq, idx, coords, batch, n, m, s);
  } else {
    launch<T, D, false>(q, t, mk, sq, idx, coords, batch, n, m, s);
  }
}

template <typename T>
int launch_type(const void* q, const void* t, const void* mk, void* sq, void* idx,
                void* coords, int batch, int n, int m, int dim, cudaStream_t s) {
  if (dim == 2) {
    launch_dim<T, 2>(q, t, mk, sq, idx, coords, batch, n, m, s);
  } else if (dim == 3) {
    launch_dim<T, 3>(q, t, mk, sq, idx, coords, batch, n, m, s);
  } else {
    return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

}  // namespace

// Plain C entry point, bound with ctypes.  Pointers are device pointers of
// contiguous tensors; mask and out_coords may be null.  Launches on `stream`
// without synchronising and returns cudaGetLastError() (0 on success).
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
