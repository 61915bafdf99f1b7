// Exact batched linear assignment (Jonker-Volgenant shortest augmenting
// path) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _lap_kernel / hungarian_lap_pallas of
// boosted_detr_tpu/ops/pallas_lap.py (:49-156, :159-191). For each problem
// b it takes cost [O, P] float32 and n = num_objects[b], and writes the 0/1
// float32 mask [O, P] of a least-cost assignment of rows 0..n-1 to distinct
// columns, zero on rows n..O-1.
//
// Columns: the P real ones, then one private dummy column per row (cost
// -BIG to its row when the row is inactive, +BIG otherwise), then a virtual
// start column: C = P + O + 1. Every other pair costs +BIG. An inactive row
// takes its dummy in one Dijkstra step, so inactive rows never move the
// potentials of the real ones.
//
// Bound on an H100 SXM at the flagship shape (B = 8, O = 32, P = 96): the
// bytes are 98 KB of cost in and 98 KB of mask out, about 0.06 us at
// 3.35 TB/s. That is not what limits it: the algorithm is a serial chain,
// O augmentations of up to i + 1 Dijkstra steps each, every step a
// dependent min over C columns. The TPU kernel advances all problems in
// lockstep on its vector lanes; on a GPU the problems are independent, so
// the design gives each its own warp and makes each step short:
//   - one warp (one block of 32 threads) per problem; column j lives in
//     lane j % 32, slot j / 32 (at most 8 slots: C <= 256), with its dual
//     v, its tentative distance minv, its predecessor way, its row match
//     and its used flag in registers;
//   - the problem's cost rows in shared memory (12 KB at O = 32, P = 96),
//     the row duals u beside them; the dummy and virtual costs are computed;
//   - a step is: each lane relaxes its columns against row i0, takes its
//     local minimum in column order, then a butterfly of warp shuffles
//     gives every lane the minimum, the lowest column index winning a tie
//     (as jnp.argmin and the plain version do); one lane's register is
//     read by a shuffle broadcast.
// The float32 arithmetic is the plain version's (ops/lap.py), operation for
// operation, so the two give the same mask. A step count cap of C per
// search and per augmentation cannot bind on finite costs (each step marks
// a new column used) and keeps NaN costs from hanging the card.

#include <cuda_runtime.h>

namespace {

constexpr int WARP = 32;
constexpr int SLOTS = 8;  // columns per lane
constexpr float BIG = 1e9f;
constexpr float INF = 1e30f;

__device__ __forceinline__ void warp_argmin(float& value, int& index) {
#pragma unroll
  for (int offset = WARP / 2; offset > 0; offset /= 2) {
    const float v = __shfl_xor_sync(0xffffffffu, value, offset);
    const int j = __shfl_xor_sync(0xffffffffu, index, offset);
    if (v < value || (v == value && j < index)) {
      value = v;
      index = j;
    }
  }
}

// Broadcast slot (j / 32) of lane (j % 32) to the whole warp. The slot
// index is uniform across the warp, so the register array is indexed with
// a loop of constant indices rather than dynamically (which would spill
// it to local memory).
template <typename T>
__device__ __forceinline__ T read_column(const T (&a)[SLOTS], int j) {
  const int slot = j / WARP;
  T mine = a[0];
#pragma unroll
  for (int s = 1; s < SLOTS; ++s)
    if (s == slot) mine = a[s];
  return __shfl_sync(0xffffffffu, mine, j % WARP);
}

__global__ void __launch_bounds__(WARP)
lap_kernel(const float* __restrict__ cost, const int* __restrict__ num_objects,
           float* __restrict__ out, int O, int P) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_cost = reinterpret_cast<float*>(smem);  // [O][P]
  float* s_u = s_cost + O * P;                     // [O]
  int* s_match = reinterpret_cast<int*>(s_u + O);  // [C]

  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  const int C = P + O + 1;
  const int virt = C - 1;
  const int free_row = O;
  const int n = num_objects[b];
  const float* src = cost + static_cast<long long>(b) * O * P;
  for (int e = lane; e < O * P; e += WARP) s_cost[e] = src[e];
  for (int r = lane; r < O; r += WARP) s_u[r] = 0.f;
  __syncwarp();

  float v[SLOTS], minv[SLOTS];
  int way[SLOTS], match[SLOTS];
  bool used[SLOTS];
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    v[s] = 0.f;
    match[s] = free_row;
  }

  for (int i = 0; i < O; ++i) {
    // the virtual column is owned by the row being inserted
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      if (s * WARP + lane == virt) match[s] = i;
      minv[s] = INF;
      way[s] = virt;
      used[s] = false;
    }
    int j0 = virt;
    for (int step = 0; step < C; ++step) {
      const int i0 = read_column(match, j0);
      if (i0 == free_row) break;  // j0 is free: the path ends there
      const float u_i0 = s_u[i0];
      const bool i0_inactive = i0 >= n;
      float best = INF;
      int best_j = 0x7fffffff;
#pragma unroll
      for (int s = 0; s < SLOTS; ++s) {
        const int j = s * WARP + lane;
        if (j >= C) continue;
        if (j == j0) used[s] = true;
        if (!used[s]) {
          float c;
          if (j < P)
            c = s_cost[i0 * P + j];
          else if (j < P + O)
            c = (j - P == i0 && i0_inactive) ? -BIG : BIG;
          else
            c = BIG;
          const float reduced = c - u_i0 - v[s];
          if (reduced < minv[s]) {
            minv[s] = reduced;
            way[s] = j0;
          }
        }
        const float masked = used[s] ? INF : minv[s];
        if (masked < best || (masked == best && j < best_j)) {
          best = masked;
          best_j = j;
        }
      }
      warp_argmin(best, best_j);
      const float delta = best;
      __syncwarp();  // every lane has read s_u[i0] before any lane writes
      // rows owning used columns gain delta (row i owns the virtual
      // column), used columns lose it, the others' distances shrink by it
#pragma unroll
      for (int s = 0; s < SLOTS; ++s) {
        const int j = s * WARP + lane;
        if (j >= C) continue;
        if (used[s]) {
          s_u[match[s]] = s_u[match[s]] + delta;  // owners are distinct
          v[s] = v[s] - delta;
        } else {
          minv[s] = minv[s] - delta;
        }
      }
      __syncwarp();
      j0 = best_j;
    }
    // augment along way back to the virtual column
    for (int step = 0; step < C && j0 != virt; ++step) {
      const int j1 = read_column(way, j0);
      const int m_j1 = read_column(match, j1);
#pragma unroll
      for (int s = 0; s < SLOTS; ++s)
        if (s * WARP + lane == j0) match[s] = m_j1;
      j0 = j1;
    }
  }

  // the mask, written row by row with neighbouring lanes on neighbouring
  // columns
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int j = s * WARP + lane;
    if (j < C) s_match[j] = match[s];
  }
  __syncwarp();
  float* dst = out + static_cast<long long>(b) * O * P;
  for (int e = lane; e < O * P; e += WARP) {
    const int r = e / P;
    const int j = e - r * P;
    dst[e] = (r < n && s_match[j] == r) ? 1.f : 0.f;
  }
}

}  // namespace

extern "C" {

// Shared memory one problem needs, in bytes: its cost rows, the row duals
// and the final column owners.
long long lap_smem_bytes(int O, int P) {
  return 4LL * (static_cast<long long>(O) * P + O + P + O + 1);
}

// Solves B problems on `stream` and returns cudaGetLastError() (0 = the
// launch was accepted). cost [B, O, P] float32, num_objects [B] int32 and
// out [B, O, P] float32 are device pointers of contiguous tensors.
int lap_solve(const void* cost, const void* num_objects, void* out, int B,
              int O, int P, void* stream) {
  if (B <= 0 || O <= 0 || P <= 0 || P + O + 1 > WARP * SLOTS)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = lap_smem_bytes(O, P);
  cudaError_t err = cudaFuncSetAttribute(
      lap_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  lap_kernel<<<B, WARP, static_cast<size_t>(smem),
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cost), static_cast<const int*>(num_objects),
      static_cast<float*>(out), O, P);
  return static_cast<int>(cudaGetLastError());
}

const char* lap_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
