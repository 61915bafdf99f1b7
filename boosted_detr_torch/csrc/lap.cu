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
//   - lap_columns_kernel<K> (the columns route) for every other shape, such
//     as DINO's 900 queries at 120 objects (C = 1021, but 432 KB of cost
//     rows) or P = 2000 (C = 2065): the cost rows stay in device memory
//     (prefetched into L2) and every step reads row i0 from there; the
//     column state lives in K register slots a thread up to C = 4096, past
//     that in a scratch buffer in device memory that the caller allocates.
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
// own block, and the slots route's design shortens the dependent chain of
// the one warp that solves:
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
// The columns route cannot hold its cost rows in one block's shared
// memory, so a step waits on an L2 read; its design keeps that read the
// one long wait of the step and spreads the rest over the block:
//   - one block of 256 threads a problem, every thread in every step:
//     column j lives in thread j % 256, slot j / 256, with v, minv, way
//     and its tag in registers and its used flag in a bit mask (K slots,
//     3 to 16, a template argument fitted to C); at C = 1021 that is 4
//     columns a thread where the first design looped 32 times in one warp;
//   - the step is straight-line: all of a thread's cost reads of row i0
//     issued at once (coalesced across the warp; a search's first step,
//     on row i, reads registers filled during the last search's walk
//     back, since most searches take that one step alone), the last
//     step's dual update applied to each column at the top of the next
//     step's pass (the same operations on each column, in the same
//     order), the relaxation, the thread's first smallest by halves;
//   - the block's argmin in two levels: the warp's two redux.sync over the
//     order-preserving key and the tag (the owner in its low bits, so the
//     next row needs no load), each warp's pair to shared memory, one
//     __syncthreads (two rooms alternate by step), two redux.sync over the
//     8 pairs in every warp;
//   - row r's dual u lives in thread r with its `hit` flag; the duals of
//     rows not yet visited in a search do not change in it, so a step reads
//     u[i0] from shared memory, written at the end of each search;
//   - the problem's cost rows are prefetched into L2 at the start: most
//     searches are one step on a row read for the first time;
//   - the walk back stays serial: each thread writes its columns' way to
//     shared memory at the end of a search and thread 0 walks, while the
//     others write that search's row of the mask as zeros (one SM's store
//     rate would make the whole mask ~14 us at [120, 900]); the ones go in
//     after the last search;
//   - past 16 slots a thread the same block loops over its columns with
//     their state in device memory, and the next row is one read of the
//     owners.
// Measured against this design (probes/lap_phases.py --variants; PERF.md,
// PR 23) and not kept: the cost rows in the shared memory of a
// thread-block cluster of 2 or 4 blocks a problem, the argmin through
// distributed shared memory and a cluster barrier a step (2.3-3.0x
// slower: the cluster barrier costs more than the L2 read it saves); the
// step's barrier as an mbarrier phase; the cross-warp argmin as a tree in
// each thread; the largest L1 carveout.
// On both routes the float32 arithmetic is the plain version's
// (ops/lap.py), operation for operation and in its order, so the two give
// the same mask, ties included. A step count cap of C per search and per
// augmentation cannot bind on finite costs (each step marks a new column
// used) and keeps NaN costs from hanging the card.
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
// The columns route: the threads of one problem's block, and the column
// slots a thread may hold in registers (it takes the fewest that hold C).
constexpr int COLUMN_THREADS = 256;
constexpr int COLUMN_WARPS = COLUMN_THREADS / WARP;
constexpr int COLUMN_SLOT_CHOICES[] = {3, 4, 6, 8, 10, 12, 16};
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

// Asks L2 for the 128-byte line at `p`, without waiting for it.
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
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

// The order-preserving key of a float32 (-0.0 + 0.0 is +0.0, then
// negative floats flipped whole and positive ones above them), and back.
__device__ __forceinline__ unsigned order_key(float value) {
  const unsigned bits = __float_as_uint(__fadd_rn(value, 0.f));
  return (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// The least (key, tag) over the threads of a columns-route block, the
// lowest tag winning a tie, in every thread: two redux.sync in each warp,
// each warp's pair to `room`, one barrier, then two redux.sync over the
// warps' pairs. Steps alternate between two rooms, so that no thread
// writes one before every thread has read it.
__device__ __forceinline__ unsigned long long block_argmin(
    unsigned key, unsigned tag, unsigned long long* room) {
  const unsigned least = __reduce_min_sync(0xffffffffu, key);
  const unsigned first =
      __reduce_min_sync(0xffffffffu, key == least ? tag : ~0u);
  const int lane = threadIdx.x % WARP;
  if (lane == 0)
    room[threadIdx.x / WARP] =
        static_cast<unsigned long long>(least) << 32 | first;
  __syncthreads();
  const unsigned long long theirs = lane < COLUMN_WARPS ? room[lane] : ~0ull;
  const unsigned key_w = static_cast<unsigned>(theirs >> 32);
  const unsigned block_least = __reduce_min_sync(0xffffffffu, key_w);
  const unsigned block_first = __reduce_min_sync(
      0xffffffffu,
      key_w == block_least ? static_cast<unsigned>(theirs) : ~0u);
  return static_cast<unsigned long long>(block_least) << 32 | block_first;
}

// The cost of column j from row i0 (`row` = its costs): a real column's,
// or the dummies' -BIG for an inactive row's own and +BIG otherwise.
__device__ __forceinline__ float column_cost(const float* row, int j, int P,
                                             int i0, bool i0_inactive) {
  float c = (j == P + i0 && i0_inactive) ? -BIG : BIG;
  if (j < P) c = __ldg(row + j);
  return c;
}

// One column's part of a Dijkstra step from row i0 (dual u_i0, cost c to
// the column): its distance and predecessor, and what it offers the argmin
// (INF once used). The plain version's float32 operations, in its order.
__device__ __forceinline__ float relax(float c, float u_i0, float v,
                                      bool used, int j0, float& minv,
                                      int& way) {
  const float reduced = __fsub_rn(__fsub_rn(c, u_i0), v);
  const bool better = !used && reduced < minv;
  minv = better ? reduced : minv;
  way = better ? j0 : way;
  return used ? INF : minv;
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

// The columns route. One problem a block of COLUMN_THREADS threads, and
// every thread takes part in every Dijkstra step: column j belongs to
// thread j % COLUMN_THREADS, slot j / COLUMN_THREADS.
//   - K > 0 (C <= K * COLUMN_THREADS, K from COLUMN_SLOT_CHOICES): a
//     column's dual v, distance minv, predecessor way and tag live in
//     registers and its used flag in a bit mask; the owners (match) and the
//     predecessors of the walk back sit in shared memory;
//   - K == 0 (past the slots, C > 16 * COLUMN_THREADS): every column's
//     state sits at `scratch` + b * stride (17 bytes a column) and each
//     thread loops over its columns.
// A step reads row i0 of the cost from L2 (each thread its columns, all at
// once, coalesced; with K > 0 a search's first step reads row i from
// registers filled during the last walk back), applies the last step's
// dual update (fused: each column sees the plain version's operations in
// its order), relaxes, takes the thread's first smallest, then the
// block's argmin (block_argmin: one barrier). With K > 0 the argmin runs
// over tags, so it gives the next row too; with K == 0 the next row is one
// read of the owners. Thread r < O keeps row r's dual u in a register; the
// duals of the rows not yet visited in a search do not change in it, so a
// step reads u[i0] from shared memory (written at the end of each
// search). Search i writes row i of the mask as zeros during its walk
// back, and the ones go in after the last search.
template <int K>
__global__ void __launch_bounds__(COLUMN_THREADS, 1)
lap_columns_kernel(const float* __restrict__ cost,
                   const int* __restrict__ num_objects,
                   float* __restrict__ out, unsigned char* __restrict__ scratch,
                   long long stride, int O, int P, int vec) {
  constexpr int T = COLUMN_THREADS;
  constexpr int HELD = K > 0 ? K * T : 1;  // columns in registers
  __shared__ unsigned long long s_room[2][COLUMN_WARPS];
  __shared__ float s_u[MAX_OBJECTS];
  __shared__ int s_match[HELD];
  __shared__ int s_way[HELD];
  LAP_ONLY(const long long t_entry = clock64();
           long long t_dj = 0, n_dj = 0, t_aug = 0, n_aug = 0;)

  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int C = P + O + 1;
  const int virt = C - 1;
  const int free_row = O;
  const int n = num_objects[b];
  const long long base = static_cast<long long>(b) * O * P;
  int* match = s_match;
  int* way_at = s_way;
  float* v_at = nullptr;
  float* minv_at = nullptr;
  unsigned char* used_at = nullptr;
  if constexpr (K == 0) {  // v, minv [C] float; way, match [C] int; used [C]
    unsigned char* state = scratch + b * stride;
    v_at = reinterpret_cast<float*>(state);
    minv_at = v_at + C;
    way_at = reinterpret_cast<int*>(minv_at + C);
    match = way_at + C;
    used_at = reinterpret_cast<unsigned char*>(match + C);
  }
  // The problem's cost rows into L2, row 0 first, while the searches
  // start: search i's first step reads row i, most often for the first
  // time, and most searches take one step.
  const char* rows = reinterpret_cast<const char*>(cost + base);
  for (long long at = 128LL * tid; at < 4LL * O * P; at += 128LL * T)
    prefetch_l2(rows + at);
  for (int j = tid; j < (K > 0 ? HELD : C); j += T) {
    match[j] = free_row;
    if constexpr (K == 0) v_at[j] = 0.f;
  }
  if (tid < MAX_OBJECTS) s_u[tid] = 0.f;
  float v[K > 0 ? K : 1];
#pragma unroll
  for (int s = 0; s < K; ++s) v[s] = 0.f;
  // the costs of the next search's first step, row i's: read ahead, while
  // the last search walks back (most searches take that one step alone)
  float first[K > 0 ? K : 1];
#pragma unroll
  for (int s = 0; s < K; ++s)
    first[s] = column_cost(cost + base, s * T + tid, P, 0, 0 >= n);
  float u = 0.f;  // the dual of row tid (tid < O)
  int parity = 0;
  __syncthreads();
  LAP_ONLY(const long long t_landed = clock64();)

  for (int i = 0; i < O; ++i) {
    int j0 = virt;
    int i0 = i;
    float delta = 0.f;  // the last step's, applied in the next (x - 0 is x)
    bool hit = false;   // row tid owns a used column
    LAP_ONLY(const long long t_search = clock64();)
    if constexpr (K > 0) {
      // A column's tag is its index above its owner (the row inserted
      // owns the virtual column), as on the slots route.
      unsigned tag[K];
      float minv[K];
      int way[K];
      unsigned used = 0;  // bit s: slot s's column is used
#pragma unroll
      for (int s = 0; s < K; ++s) {
        const int j = s * T + tid;
        tag[s] = static_cast<unsigned>(j) << 8 |
                 static_cast<unsigned>(j == virt ? i : match[j]);
        minv[s] = INF;
        way[s] = virt;
        used |= (j >= C ? 1u : 0u) << s;  // the columns past C: never taken
      }
      for (int step = 0; step < C; ++step) {
        LAP_ONLY(++n_dj;)
        if (i0 == free_row) break;  // j0 is free: the path ends there
        const float* row = cost + base + static_cast<long long>(i0) * P;
        float c[K];
        if (step == 0) {  // a branch, so that no load waits in this step
#pragma unroll
          for (int s = 0; s < K; ++s) c[s] = first[s];
        } else {
#pragma unroll
          for (int s = 0; s < K; ++s)
            c[s] = column_cost(row, s * T + tid, P, i0, i0 >= n);
        }
        const float u_i0 = s_u[i0];
        // the last step's update: used columns lose delta, the others'
        // distances shrink by it, rows owning used columns gain it
#pragma unroll
        for (int s = 0; s < K; ++s) {
          const bool taken = used >> s & 1u;
          v[s] = taken ? __fsub_rn(v[s], delta) : v[s];
          minv[s] = taken ? minv[s] : __fsub_rn(minv[s], delta);
        }
        u = hit ? __fadd_rn(u, delta) : u;
        hit = hit || tid == i0;
        if ((j0 & (T - 1)) == tid) used |= 1u << (j0 / T);
        float masked[K];
        unsigned pick[K];
#pragma unroll
        for (int s = 0; s < K; ++s) {
          masked[s] = relax(c[s], u_i0, v[s], used >> s & 1u, j0, minv[s],
                            way[s]);
          pick[s] = tag[s];
        }
        // the thread's minimum in column order, by halves: the lower slot
        // keeps a tie
#pragma unroll
        for (int w = 1; w < K; w *= 2)
#pragma unroll
          for (int s = 0; s + w < K; s += 2 * w)
            if (masked[s + w] < masked[s]) {
              masked[s] = masked[s + w];
              pick[s] = pick[s + w];
            }
        const unsigned long long best =
            block_argmin(order_key(masked[0]), pick[0], s_room[parity]);
        parity ^= 1;
        delta = key_value(static_cast<unsigned>(best >> 32));
        j0 = static_cast<int>(static_cast<unsigned>(best) >> 8);
        i0 = static_cast<int>(best & 0xffu);
      }
#pragma unroll
      for (int s = 0; s < K; ++s) {
        if (used >> s & 1u) v[s] = __fsub_rn(v[s], delta);
        way_at[s * T + tid] = way[s];
      }
      if (i + 1 < O) {
        const float* next = cost + base + static_cast<long long>(i + 1) * P;
#pragma unroll
        for (int s = 0; s < K; ++s)
          first[s] = column_cost(next, s * T + tid, P, i + 1, i + 1 >= n);
      }
    } else {
      for (int j = tid; j < C; j += T) {
        minv_at[j] = INF;
        way_at[j] = virt;
        used_at[j] = 0;
      }
      for (int step = 0; step < C; ++step) {
        LAP_ONLY(++n_dj;)
        if (i0 == free_row) break;
        const float* row = cost + base + static_cast<long long>(i0) * P;
        const float u_i0 = s_u[i0];
        u = hit ? __fadd_rn(u, delta) : u;
        hit = hit || tid == i0;
        float low = INF;  // the thread's first smallest, in column order
        unsigned pick = ~0u;
        for (int j = tid; j < C; j += T) {
          const float c = column_cost(row, j, P, i0, i0 >= n);
          bool taken = used_at[j];
          float vj = v_at[j];
          float mj = minv_at[j];
          int wj = way_at[j];
          if (taken)
            vj = __fsub_rn(vj, delta);
          else
            mj = __fsub_rn(mj, delta);
          if (j == j0) {
            taken = true;
            used_at[j] = 1;
          }
          const float masked = relax(c, u_i0, vj, taken, j0, mj, wj);
          v_at[j] = vj;
          minv_at[j] = mj;
          way_at[j] = wj;
          if (pick == ~0u || masked < low) {
            low = masked;
            pick = static_cast<unsigned>(j);
          }
        }
        const unsigned long long best = block_argmin(
            pick == ~0u ? ~0u : order_key(low), pick, s_room[parity]);
        parity ^= 1;
        delta = key_value(static_cast<unsigned>(best >> 32));
        j0 = static_cast<int>(static_cast<unsigned>(best));
        i0 = match[j0];  // owners change only in the walk back
      }
      for (int j = tid; j < C; j += T)
        if (used_at[j]) v_at[j] = __fsub_rn(v_at[j], delta);
    }
    u = hit ? __fadd_rn(u, delta) : u;
    if (tid < O) s_u[tid] = u;
    LAP_ONLY(const long long t_searched = clock64();
             t_dj += t_searched - t_search;)
    __syncthreads();  // every column's predecessor, before the walk
    // row i of the mask to zeros while thread 0 walks: one SM writes the
    // whole mask of its problem, at a rate that would take ~14 us at
    // [120, 900] after the last search; 16-byte stores where `vec` (P % 4
    // == 0, `out` 16-byte aligned)
    float* dst = out + base + static_cast<long long>(i) * P;
    if (vec) {
      for (int q = tid; q < P / 4; q += T)
        reinterpret_cast<float4*>(dst)[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      for (int j = tid; j < P; j += T) dst[j] = 0.f;
    }
    if (tid == 0) {
      match[virt] = i;  // the virtual column is owned by the row inserted
      LAP_ONLY(n_aug +=) walk_back(way_at, match, j0, virt, C);
    }
    __syncthreads();  // the new owners, before any thread reads them
    LAP_ONLY(t_aug += clock64() - t_searched;)
  }
  LAP_ONLY(const long long t_solved = clock64();)

  // the mask's ones, after every row's zeros (the barrier above orders
  // them): column j goes to its owner where the owner is active
  for (int j = tid; j < P; j += T) {
    const int r = match[j];
    if (r < n) out[base + static_cast<long long>(r) * P + j] = 1.f;
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

// The register slots a thread of the columns route takes for O rows and P
// columns: the fewest of COLUMN_SLOT_CHOICES that hold C, else 0 (the
// column state in device memory).
int column_slots_for(int O, int P) {
  const long long C = static_cast<long long>(P) + O + 1;
  for (int k : COLUMN_SLOT_CHOICES)
    if (C <= static_cast<long long>(COLUMN_THREADS) * k) return k;
  return 0;
}

// Bytes of one problem's column state in device memory past the register
// slots: v and minv (float32), way and the owners (int32), a used flag, for
// each of the C columns, rounded up to 16.
long long columns_bytes(int O, int P) {
  const long long C = static_cast<long long>(P) + O + 1;
  return (17 * C + 15) / 16 * 16;
}

template <int K>
int launch_columns(const float* cost, const int* num_objects, float* out,
                   unsigned char* scratch, long long stride, int B, int O,
                   int P, int vec, cudaStream_t stream) {
  lap_columns_kernel<K><<<B, COLUMN_THREADS, 0, stream>>>(
      cost, num_objects, out, scratch, stride, O, P, vec);
  return static_cast<int>(cudaGetLastError());
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

// The register slots a thread of the columns route takes for O rows and P
// columns; 0 where C passes them and the column state is in device memory.
int lap_columns_slots(int O, int P) { return column_slots_for(O, P); }

// Bytes of device memory one problem's column state takes on the columns
// route: 0 where it fits the register slots, else the scratch a problem.
long long lap_columns_bytes(int O, int P) {
  return column_slots_for(O, P) ? 0 : columns_bytes(O, P);
}

// Solves B problems by the columns route on `stream` and returns
// cudaGetLastError(). As lap_solve, plus `scratch`: a device buffer of
// B * lap_columns_bytes(O, P) bytes, 16-byte aligned (null where that is
// 0).
int lap_solve_columns(const void* cost, const void* num_objects, void* out,
                      void* scratch, int B, int O, int P, void* stream) {
  if (B <= 0 || O <= 0 || P <= 0 || O > MAX_OBJECTS ||
      static_cast<long long>(P) + O + 1 > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int slots = column_slots_for(O, P);
  if (slots == 0 && scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec =
      P % 4 == 0 && reinterpret_cast<std::uintptr_t>(out) % 16 == 0;
  const float* c = static_cast<const float*>(cost);
  const int* n = static_cast<const int*>(num_objects);
  float* o = static_cast<float*>(out);
  unsigned char* state = static_cast<unsigned char*>(scratch);
  const long long stride = columns_bytes(O, P);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (slots) {
    case 3: return launch_columns<3>(c, n, o, state, stride, B, O, P, vec, st);
    case 4: return launch_columns<4>(c, n, o, state, stride, B, O, P, vec, st);
    case 6: return launch_columns<6>(c, n, o, state, stride, B, O, P, vec, st);
    case 8: return launch_columns<8>(c, n, o, state, stride, B, O, P, vec, st);
    case 10:
      return launch_columns<10>(c, n, o, state, stride, B, O, P, vec, st);
    case 12:
      return launch_columns<12>(c, n, o, state, stride, B, O, P, vec, st);
    case 16:
      return launch_columns<16>(c, n, o, state, stride, B, O, P, vec, st);
    default:
      return launch_columns<0>(c, n, o, state, stride, B, O, P, vec, st);
  }
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
