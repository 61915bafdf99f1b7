// Exact batched linear assignment (Jonker-Volgenant shortest augmenting
// path) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _lap_kernel / hungarian_lap_pallas of
// boosted_detr_tpu/ops/pallas_lap.py (:49-156, :159-191). For each problem
// b it takes cost [O, P] float32 and n = num_objects[b], and writes the 0/1
// float32 mask [O, P] of a least-cost assignment of rows 0..n-1 to distinct
// columns, zero on rows n..O-1. It takes O <= 120 (the TPU kernel's limit)
// and any P, on one of two routes:
//   - lap_kernel<S, R> (the slots route) where C = P + O + 1 <= 1024 and the
//     problem's cost rows and two ints a column slot fit in the 227 KB of
//     shared memory a block may use: the flagship's [8, 32, 96] and every
//     shape up to C = 1024 at O * P <= ~57,000;
//   - lap_columns_kernel (the columns route) for every other shape, such as
//     DINO's 900 queries at 120 objects (C = 1021, but 432 KB of cost rows)
//     or P = 2000 (C = 2065): the cost rows stay in device memory and the
//     step reads row i0 from L2, and the column state (v, minv, way, used,
//     the owners) lives in shared memory, 17 bytes a column, or, past
//     ~13,600 columns, in a scratch buffer in device memory that the caller
//     allocates (generic pointers: the same code reads either).
//
// Columns: the P real ones, then one private dummy column per row (cost
// -BIG to its row when the row is inactive, +BIG otherwise), then a virtual
// start column: C = P + O + 1. Every other pair costs +BIG. An inactive row
// takes its dummy in one Dijkstra step, so inactive rows never move the
// potentials of the real ones.
//
// What bounds it. The bytes (cost in, mask out: 98 KB each at B = 8,
// O = 32, P = 96) take 0.06 us at 3.35 TB/s; the algorithm is a serial
// chain: O augmentations of up to i + 1 Dijkstra steps each, every step a
// dependent min over C columns, then a walk back. The TPU kernel advances
// all problems in lockstep on its vector lanes; here each problem has its
// own warp, and the slots route's design shortens that warp's dependent
// chain:
//   - one block of 8 warps per problem: all 256 threads copy its cost
//     rows into shared memory (16-byte cp.async, all in flight at once)
//     and write its mask (16-byte stores), warp 0 alone solves;
//   - column j lives in lane j % 32, slot j / 32, with its dual v, its
//     tentative distance minv, its predecessor way and its used flag in
//     registers; the slot count S (5 to 32) is a template argument fitted
//     to C, and the step is straight-line selects over the S slots;
//   - row r's dual u lives in lane r % 32, row slot r / 32 (R = 1 or 4),
//     with a flag `hit` set when the row's column is marked used (as the
//     TPU kernel's hit_): the dual update is u = hit ? u + delta : u in
//     registers, no shared-memory read-modify-write and no __syncwarp in
//     the step; u[i0] is one shuffle;
//   - the warp's argmin is two __reduce_min_sync (redux.sync): the min of an
//     order-preserving key of the lanes' minima, then the min of the column
//     index among the lanes at it, so the lowest column wins a tie (as
//     torch.min and jnp.argmin); -0.0 is made +0.0 before the key, as the
//     float compare holds them equal;
//   - the argmin runs over tags, a column's index above its owner's row,
//     so it gives the next column j0 and its row i0 = match[j0] at once:
//     the step reads nothing from shared memory but its cost row;
//   - the column owners (match) live in shared memory, and each lane
//     makes its columns' tags from them when a row's search starts; lane 0
//     walks back along way (copied to shared memory at the end of each
//     search), two loads and a store a step.
// The columns route keeps the same warp and the same arithmetic but loops:
// lane l takes columns l, l + 32, ... in each step, its minimum is the
// first of the smallest in column order, and the warp's argmin takes the
// lowest column among the lanes at the minimum; the next row is then one
// read of the owners. Its step costs ~C / 32 loop turns of shared-memory
// reads where the slots route's is straight-line registers: correct and
// simple, not fast (ROADMAP Queue 2).
// On both routes the float32 arithmetic is the plain version's
// (ops/lap.py), operation for operation and in its order, so the two give
// the same mask, ties included. A step count cap of C per search and per augmentation cannot
// bind on finite costs (each step marks a new column used) and keeps NaN
// costs from hanging the card.
//
// Built with -DLAP_PHASES (probes/lap_phases.py), the kernel stamps its
// phases with clock64() into the buffer given to lap_phase_buffer; the
// shipped build has none.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int WARP = 32;
constexpr int THREADS = 256;      // the block of one problem
constexpr int MAX_OBJECTS = 120;  // rows: 4 row slots a lane
// Columns a lane may hold; the kernel takes the fewest that hold C.
constexpr int SLOT_CHOICES[] = {5, 8, 12, 16, 24, 32};
constexpr int SMEM_LIMIT = 232448;  // the most a block may use on an H100
constexpr float BIG = 1e9f;
constexpr float INF = 1e30f;

#ifdef LAP_PHASES
__device__ long long* lap_phase_out;
#define LAP_ONLY(...) __VA_ARGS__
#else
#define LAP_ONLY(...)
#endif

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned at = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(at),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned at = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(at),
               "l"(src)
               : "memory");
}

// The minimum over the lanes of (value, index) in every lane, the lowest
// index winning a tie.
__device__ __forceinline__ void warp_argmin(float& value, unsigned& index) {
  // order-preserving key: -0.0 + 0.0 is +0.0, then negative floats
  // flipped whole and positive ones above them
  const unsigned bits = __float_as_uint(__fadd_rn(value, 0.f));
  const unsigned key = (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
  const unsigned least = __reduce_min_sync(0xffffffffu, key);
  index = __reduce_min_sync(0xffffffffu, key == least ? index : ~0u);
  value = __uint_as_float((least & 0x80000000u) ? (least & 0x7fffffffu)
                                                : ~least);
}

// The walk back from the free column j0 to the virtual one: each column
// on the path takes the owner of its predecessor (the path visits no
// column twice, so each owner is read before it is overwritten). Returns
// the steps taken (at most C).
__device__ __forceinline__ int walk_back(const int* __restrict__ way,
                                         int* __restrict__ match, int j0,
                                         int virt, int C) {
  int step = 0;
  for (; step < C && j0 != virt; ++step) {
    const int j1 = way[j0];
    match[j0] = match[j1];
    j0 = j1;
  }
  return step;
}

template <int S, int R>
__global__ void __launch_bounds__(THREADS)
lap_kernel(const float* __restrict__ cost, const int* __restrict__ num_objects,
           float* __restrict__ out, int O, int P, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_cost = reinterpret_cast<float*>(smem);     // [O][P]
  int* s_match = reinterpret_cast<int*>(s_cost + O * P);  // [32 S] owners
  int* s_way = s_match + WARP * S;                    // [32 S] predecessors
  LAP_ONLY(const long long t_entry = clock64();
           long long t_dj = 0, n_dj = 0, t_aug = 0, n_aug = 0,
           t_solved = 0;)

  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int OP = O * P;
  const long long base = static_cast<long long>(b) * OP;
  if (vec) {  // O * P % 4 == 0 and both tensors 16-byte aligned
    for (int e = tid; e < OP / 4; e += THREADS)
      cp_async16(s_cost + 4 * e, cost + base + 4 * e);
  } else {
    for (int e = tid; e < OP; e += THREADS)
      cp_async4(s_cost + e, cost + base + e);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  LAP_ONLY(const long long t_landed = clock64();)
  const int n = num_objects[b];

  if (tid < WARP) {
    const int lane = tid;
    const int C = P + O + 1;
    const int virt = C - 1;
    const int free_row = O;
    for (int j = lane; j < WARP * S; j += WARP) s_match[j] = free_row;
    __syncwarp();

    float v[S], minv[S];
    int way[S];
    bool used[S];
    float u[R];
    bool hit[R];
#pragma unroll
    for (int s = 0; s < S; ++s) v[s] = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) u[r] = 0.f;

    for (int i = 0; i < O; ++i) {
      s_match[virt] = i;  // the virtual column is owned by the row inserted
      // A column's tag is its index above its owner (a row, or O when
      // free: below 256), so the warp's argmin over tags gives the next
      // column and its row at once. Owners change only in the walk back.
      unsigned tag[S];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int j = s * WARP + lane;
        tag[s] = static_cast<unsigned>(j) << 8 |
                 static_cast<unsigned>(s_match[j]);
        minv[s] = INF;
        way[s] = virt;
        used[s] = j >= C;  // the columns past C: never taken
      }
#pragma unroll
      for (int r = 0; r < R; ++r) hit[r] = false;
      int j0 = virt;
      int i0 = i;
      LAP_ONLY(const long long t_search = clock64();)
      for (int step = 0; step < C; ++step) {
        LAP_ONLY(++n_dj;)
        if (i0 == free_row) break;  // j0 is free: the path ends there
        float mine = u[0];  // row slot i0 / 32, by compares: registers
#pragma unroll
        for (int r = 1; r < R; ++r) mine = i0 >= r * WARP ? u[r] : mine;
        const float u_i0 = __shfl_sync(0xffffffffu, mine, i0 & (WARP - 1));
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (r * WARP + lane == i0) hit[r] = true;
        const bool i0_inactive = i0 >= n;
        const float* row = s_cost + i0 * P;
        float masked[S];
        unsigned pick[S];
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const int j = s * WARP + lane;
          if (j == j0) used[s] = true;
          float c = (j == P + i0 && i0_inactive) ? -BIG : BIG;
          if (j < P) c = row[j];
          const float reduced = __fsub_rn(__fsub_rn(c, u_i0), v[s]);
          const bool better = !used[s] && reduced < minv[s];
          minv[s] = better ? reduced : minv[s];
          way[s] = better ? j0 : way[s];
          masked[s] = used[s] ? INF : minv[s];
          pick[s] = tag[s];
        }
        // the lane's minimum in column order, by halves: the lower slot
        // keeps a tie
#pragma unroll
        for (int w = 1; w < S; w *= 2)
#pragma unroll
          for (int s = 0; s + w < S; s += 2 * w)
            if (masked[s + w] < masked[s]) {
              masked[s] = masked[s + w];
              pick[s] = pick[s + w];
            }
        float delta = masked[0];
        unsigned next = pick[0];
        warp_argmin(delta, next);
        // rows owning used columns gain delta (row i owns the virtual
        // column), used columns lose it, the others' distances shrink by it
#pragma unroll
        for (int r = 0; r < R; ++r)
          u[r] = hit[r] ? __fadd_rn(u[r], delta) : u[r];
#pragma unroll
        for (int s = 0; s < S; ++s) {
          v[s] = used[s] ? __fsub_rn(v[s], delta) : v[s];
          minv[s] = used[s] ? minv[s] : __fsub_rn(minv[s], delta);
        }
        j0 = static_cast<int>(next >> 8);
        i0 = static_cast<int>(next & 0xffu);
      }
      LAP_ONLY(const long long t_searched = clock64();
               t_dj += t_searched - t_search;)
      // augment along way back to the virtual column; every lane walks the
      // same path and writes the same owners
#pragma unroll
      for (int s = 0; s < S; ++s) s_way[s * WARP + lane] = way[s];
      __syncwarp();
      if (lane == 0)  // one lane walks, the others wait at the __syncwarp
        LAP_ONLY(n_aug +=) walk_back(s_way, s_match, j0, virt, C);
      __syncwarp();  // the new owners, before any lane reads them
      LAP_ONLY(t_aug += clock64() - t_searched;)
    }
    LAP_ONLY(t_solved = clock64();)
  }
  __syncthreads();

  // the mask: row r takes column j where it owns it and is active
  float* dst = out + base;
  if (vec) {
    for (int e = tid; e < OP / 4; e += THREADS) {
      int r = 4 * e / P;
      int j = 4 * e - r * P;
      float m[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        m[k] = (r < n && s_match[j] == r) ? 1.f : 0.f;
        if (++j == P) {
          j = 0;
          ++r;
        }
      }
      reinterpret_cast<float4*>(dst)[e] = make_float4(m[0], m[1], m[2], m[3]);
    }
  } else {
    for (int e = tid; e < OP; e += THREADS) {
      const int r = e / P;
      dst[e] = (r < n && s_match[e - r * P] == r) ? 1.f : 0.f;
    }
  }
  LAP_ONLY(
      const long long t_end = clock64();
      if (tid == 0 && lap_phase_out != nullptr) {
        long long* rec = lap_phase_out + 8LL * b;
        rec[0] = t_landed - t_entry;
        rec[1] = t_dj;
        rec[2] = n_dj;
        rec[3] = t_aug;
        rec[4] = n_aug;
        rec[5] = t_end - t_solved;
        rec[6] = t_end - t_entry;
      })
}

// Lets `kernel` take up to SMEM_LIMIT bytes of dynamic shared memory on the
// current card: the attribute is set once per kernel and card (`raised`
// holds a bit a card).
template <typename Kernel>
cudaError_t allow_smem_once(Kernel* kernel, unsigned long long& raised) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= 64) return cudaErrorInvalidDevice;
  if (!(raised >> device & 1ull)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err != cudaSuccess) return err;
    raised |= 1ull << device;
  }
  return cudaSuccess;
}

int slots_for(int O, int P) {
  for (int s : SLOT_CHOICES)
    if (P + O + 1 <= WARP * s) return s;
  return 0;
}

template <int S, int R>
int launch(const float* cost, const int* num_objects, float* out, int B,
           int O, int P, int vec, long long smem, cudaStream_t stream) {
  static unsigned long long raised = 0;  // one per instantiation
  const cudaError_t err = allow_smem_once(lap_kernel<S, R>, raised);
  if (err != cudaSuccess) return static_cast<int>(err);
  lap_kernel<S, R><<<B, THREADS, static_cast<size_t>(smem), stream>>>(
      cost, num_objects, out, O, P, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int S>
int launch_rows(const float* cost, const int* num_objects, float* out, int B,
                int O, int P, int vec, long long smem, cudaStream_t stream) {
  return O <= WARP ? launch<S, 1>(cost, num_objects, out, B, O, P, vec, smem,
                                  stream)
                   : launch<S, 4>(cost, num_objects, out, B, O, P, vec, smem,
                                  stream);
}

// The columns route: one problem a block, warp 0 solves, every thread
// clears the column state and writes the mask. The cost rows are read
// from device memory; the column state sits at `scratch` + b * stride when
// the caller gives a scratch buffer, else in dynamic shared memory.
__global__ void __launch_bounds__(THREADS)
lap_columns_kernel(const float* __restrict__ cost,
                   const int* __restrict__ num_objects,
                   float* __restrict__ out, unsigned char* __restrict__ scratch,
                   long long stride, int O, int P) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int C = P + O + 1;
  const int virt = C - 1;
  const int free_row = O;
  unsigned char* state = scratch != nullptr ? scratch + b * stride : smem;
  float* v = reinterpret_cast<float*>(state);  // [C] each, then used [C]
  float* minv = v + C;
  int* way = reinterpret_cast<int*>(minv + C);
  int* match = way + C;
  unsigned char* used = reinterpret_cast<unsigned char*>(match + C);
  const long long base = static_cast<long long>(b) * O * P;
  const int n = num_objects[b];
  for (int j = tid; j < C; j += THREADS) {
    v[j] = 0.f;
    match[j] = free_row;
  }
  __syncthreads();

  if (tid < WARP) {
    constexpr int R = MAX_OBJECTS / WARP + 1;  // row slots a lane: 4
    const int lane = tid;
    float u[R];
    bool hit[R];
#pragma unroll
    for (int r = 0; r < R; ++r) u[r] = 0.f;

    for (int i = 0; i < O; ++i) {
      for (int j = lane; j < C; j += WARP) {
        minv[j] = INF;
        way[j] = virt;
        used[j] = 0;
      }
      if (lane == 0) match[virt] = i;  // owned by the row inserted
#pragma unroll
      for (int r = 0; r < R; ++r) hit[r] = false;
      __syncwarp();
      int j0 = virt;
      int i0 = i;
      for (int step = 0; step < C; ++step) {
        if (i0 == free_row) break;  // j0 is free: the path ends there
        float mine = u[0];
#pragma unroll
        for (int r = 1; r < R; ++r) mine = i0 >= r * WARP ? u[r] : mine;
        const float u_i0 = __shfl_sync(0xffffffffu, mine, i0 & (WARP - 1));
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (r * WARP + lane == i0) hit[r] = true;
        const bool i0_inactive = i0 >= n;
        const float* row = cost + base + static_cast<long long>(i0) * P;
        // the lane's minimum in column order: the first of the smallest
        float best = INF;
        unsigned pick = ~0u;
        for (int j = lane; j < C; j += WARP) {
          if (j == j0) used[j] = 1;
          float c = (j == P + i0 && i0_inactive) ? -BIG : BIG;
          if (j < P) c = __ldg(row + j);
          const bool taken = used[j];
          const float reduced = __fsub_rn(__fsub_rn(c, u_i0), v[j]);
          float dist = minv[j];
          if (!taken && reduced < dist) {
            dist = reduced;
            minv[j] = reduced;
            way[j] = j0;
          }
          const float masked = taken ? INF : dist;
          if (j == lane || masked < best) {
            best = masked;
            pick = static_cast<unsigned>(j);
          }
        }
        warp_argmin(best, pick);
        // as the slots route: rows owning used columns gain delta, used
        // columns lose it, the others' distances shrink by it
#pragma unroll
        for (int r = 0; r < R; ++r)
          u[r] = hit[r] ? __fadd_rn(u[r], best) : u[r];
        for (int j = lane; j < C; j += WARP) {
          if (used[j])
            v[j] = __fsub_rn(v[j], best);
          else
            minv[j] = __fsub_rn(minv[j], best);
        }
        j0 = static_cast<int>(pick);
        i0 = match[j0];  // owners change only in the walk back
      }
      __syncwarp();  // every lane's way, before lane 0 walks
      if (lane == 0) walk_back(way, match, j0, virt, C);
      __syncwarp();  // the new owners, before any lane reads them
    }
  }
  __syncthreads();

  float* dst = out + base;
  for (long long e = tid; e < static_cast<long long>(O) * P; e += THREADS) {
    const int r = static_cast<int>(e / P);
    dst[e] = (r < n && match[e - static_cast<long long>(r) * P] == r) ? 1.f
                                                                       : 0.f;
  }
}

// Bytes of one problem's column state on the columns route: v and minv
// (float32), way and the owners (int32), a used flag, for each of the C
// columns, rounded up to 16.
long long columns_bytes(int O, int P) {
  const long long C = static_cast<long long>(P) + O + 1;
  return (17 * C + 15) / 16 * 16;
}

}  // namespace

extern "C" {

// Shared memory one problem needs, in bytes: its cost rows and the owner
// and predecessor of each of the 32 * slots columns.
long long lap_smem_bytes(int O, int P) {
  return 4LL * (static_cast<long long>(O) * P + 2 * WARP * slots_for(O, P));
}

// Solves B problems on `stream` and returns cudaGetLastError() (0 = the
// launch was accepted). cost [B, O, P] float32, num_objects [B] int32 and
// out [B, O, P] float32 are device pointers of contiguous tensors.
int lap_solve(const void* cost, const void* num_objects, void* out, int B,
              int O, int P, void* stream) {
  const int slots = slots_for(O, P);
  if (B <= 0 || O <= 0 || P <= 0 || O > MAX_OBJECTS || slots == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = lap_smem_bytes(O, P);
  if (smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = (static_cast<long long>(O) * P % 4 == 0 &&
                   (reinterpret_cast<std::uintptr_t>(cost) |
                    reinterpret_cast<std::uintptr_t>(out)) % 16 == 0);
  const float* c = static_cast<const float*>(cost);
  const int* n = static_cast<const int*>(num_objects);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (slots) {
    case 5: return launch_rows<5>(c, n, o, B, O, P, vec, smem, st);
    case 8: return launch_rows<8>(c, n, o, B, O, P, vec, smem, st);
    case 12: return launch_rows<12>(c, n, o, B, O, P, vec, smem, st);
    case 16: return launch_rows<16>(c, n, o, B, O, P, vec, smem, st);
    case 24: return launch_rows<24>(c, n, o, B, O, P, vec, smem, st);
    default: return launch_rows<32>(c, n, o, B, O, P, vec, smem, st);
  }
}

// Bytes of one problem's column state on the columns route (in shared
// memory up to the 227 KB limit, else in the caller's scratch buffer).
long long lap_columns_bytes(int O, int P) { return columns_bytes(O, P); }

// Solves B problems by the columns route on `stream` and returns
// cudaGetLastError(). As lap_solve, plus `scratch`: null to keep the
// column state in shared memory (lap_columns_bytes(O, P) <= 232,448), else
// a device buffer of B * lap_columns_bytes(O, P) bytes.
int lap_solve_columns(const void* cost, const void* num_objects, void* out,
                      void* scratch, int B, int O, int P, void* stream) {
  if (B <= 0 || O <= 0 || P <= 0 || O > MAX_OBJECTS ||
      static_cast<long long>(P) + O + 1 > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long bytes = columns_bytes(O, P);
  const long long smem = scratch == nullptr ? bytes : 0;
  if (smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  static unsigned long long raised = 0;
  const cudaError_t err = allow_smem_once(lap_columns_kernel, raised);
  if (err != cudaSuccess) return static_cast<int>(err);
  lap_columns_kernel<<<B, THREADS, static_cast<size_t>(smem),
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cost), static_cast<const int*>(num_objects),
      static_cast<float*>(out), static_cast<unsigned char*>(scratch), bytes,
      O, P);
  return static_cast<int>(cudaGetLastError());
}

const char* lap_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#ifdef LAP_PHASES
// The device buffer [B, 8] int64 the stamped kernel writes its phases to
// (null: none).
int lap_phase_buffer(void* p) {
  return static_cast<int>(cudaMemcpyToSymbol(lap_phase_out, &p, sizeof(p)));
}
#endif

}  // extern "C"
