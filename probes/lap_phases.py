"""K2's time by phase on one card, in cycles of the SM's clock.

``boosted_detr_torch/csrc/lap.cu`` solves each problem in one block, a
serial chain of Dijkstra steps and augmentation steps, on two routes: the
slots route (``lap_kernel``, one warp solving) and the columns route
(``lap_columns_kernel``, the whole block on every step). This script builds
each source it is given with ``clock64()`` stamps (``-DLAP_PHASES``: the
shipped build has none) into ``build/probes/``, runs it on K2's cases of
``chip_smoke.py`` (``K2_CASES``) on every route the source takes for the
shape (the slots route where ``lap_solve`` accepts it, the columns route
where the source has ``lap_solve_columns``) and reports, for each problem,
the cycles of four phases as the first thread of the block sees them:

- prologue: from the kernel's entry until the problem's cost has landed in
  shared memory (slots route) or the column state is set (columns route);
- Dijkstra: the searches, and their count of steps (each loop iteration,
  the one that finds a free column included);
- augmentation: the walks back along ``way``, and their count of steps;
- epilogue: from the end of the last augmentation until the mask is
  written;

and what is left of the total (the setup of each row). A kernel without
stamps (the columns route before its redesign) reports its times alone.
Beside it, the same source built without stamps times the launch by
``chip_smoke.py``'s two methods (``ms``: from an idle card, L2 flushed;
``device_ms``: the launch enqueued ahead of a spin on the card), and its
ptxas report (registers, stack frame, spills). Every build's mask is held
to the plain version's.

Several sources are built and timed in one process, on one card, so that
a parent's kernel (``git archive`` of the parent, unpacked into a
directory that ``.gitignore`` lists) and this tree's compare within one
call. ``--variants`` builds each source once more for each variant named,
by exact edits (``VARIANTS``; a source that does not hold an edit's text
exactly once gets no such build, and the script says so):

- ``cluster``: design (b) of the columns route beside it (``CLUSTER_EDITS``),
  run on clusters of 2 and 4 blocks wherever their shared memory holds the
  cost rows;
- ``mbarrier``: the columns route's step barrier as an mbarrier phase;
- ``pairs``: the columns route's cross-warp argmin as a tree in each thread;
- ``noprefetch``: the columns route without its prefetch of the cost rows;
- ``carveout``: the columns route asking for the most L1 (the smallest
  shared-memory carveout);
- ``select``, ``noreadahead``: the columns route's first step of a search
  on the costs read ahead by a select in place of a branch, or without
  the read-ahead;
- ``shuffle``: the slots route's warp argmin (``__reduce_min_sync`` twice)
  swapped for the shuffle butterfly of the kernel's first design
  (``SHUFFLE_ARGMIN``).

A source without the ``LAP_PHASES`` hooks is taken to be that first design
(one warp copies the cost in, the row duals in shared memory, eight column
slots a lane) and is given the stamps by exact edits (``EDITS``); the
script raises if any edit does not match exactly once. Run on a card from
the root of a checkout:

    python3 probes/lap_phases.py [path/to/lap.cu ...]
        [--variants cluster mbarrier pairs noprefetch carveout select
         noreadahead shuffle]
        [--shapes B,O,P ...]

It prints the card's name, power limit and SM clocks, and one JSON line a
build, route and shape.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "boosted_detr_torch" / "csrc" / "lap.cu"
# a problem's record: the cycles of each phase and the steps
FIELDS = ("prologue", "dijkstra", "dijkstra_steps", "augmentation",
          "augmentation_steps", "epilogue", "total")

_BUFFER = """
extern "C" int lap_phase_buffer(void* p) {
  return static_cast<int>(cudaMemcpyToSymbol(lap_phase_out, &p, sizeof(p)));
}
"""

# The committed kernel's argmin, and the first design's five rounds of two
# shuffles and a compare-select in its place.
SHUFFLE_ARGMIN = (
    """  // order-preserving key: -0.0 + 0.0 is +0.0, then negative floats
  // flipped whole and positive ones above them
  const unsigned bits = __float_as_uint(__fadd_rn(value, 0.f));
  const unsigned key = (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
  const unsigned least = __reduce_min_sync(0xffffffffu, key);
  index = __reduce_min_sync(0xffffffffu, key == least ? index : ~0u);
  value = __uint_as_float((least & 0x80000000u) ? (least & 0x7fffffffu)
                                                : ~least);
""",
    """#pragma unroll
  for (int offset = WARP / 2; offset > 0; offset /= 2) {
    const float v = __shfl_xor_sync(0xffffffffu, value, offset);
    const unsigned j = __shfl_xor_sync(0xffffffffu, index, offset);
    if (v < value || (v == value && j < index)) {
      value = v;
      index = j;
    }
  }
""")

# The stamps, put into the kernel that has no hooks of its own.
EDITS = (
    ("#include <cuda_runtime.h>\n",
     "#include <cuda_runtime.h>\n\n__device__ long long* lap_phase_out;\n"),
    ("  const int lane = threadIdx.x;\n",
     "  const long long t_entry = clock64();\n"
     "  long long t_dj = 0, n_dj = 0, t_aug = 0, n_aug = 0;\n"
     "  const int lane = threadIdx.x;\n"),
    ("  for (int r = lane; r < O; r += WARP) s_u[r] = 0.f;\n  __syncwarp();\n",
     "  for (int r = lane; r < O; r += WARP) s_u[r] = 0.f;\n  __syncwarp();\n"
     "  const long long t_landed = clock64();\n"),
    ("    int j0 = virt;\n    for (int step = 0; step < C; ++step) {\n",
     "    int j0 = virt;\n    const long long t_search = clock64();\n"
     "    for (int step = 0; step < C; ++step) {\n      ++n_dj;\n"),
    ("      j0 = best_j;\n    }\n",
     "      j0 = best_j;\n    }\n"
     "    const long long t_searched = clock64();\n"
     "    t_dj += t_searched - t_search;\n"),
    ("    for (int step = 0; step < C && j0 != virt; ++step) {\n",
     "    for (int step = 0; step < C && j0 != virt; ++step) {\n"
     "      ++n_aug;\n"),
    ("      j0 = j1;\n    }\n  }\n",
     "      j0 = j1;\n    }\n    t_aug += clock64() - t_searched;\n  }\n"
     "  const long long t_solved = clock64();\n"),
    ("    dst[e] = (r < n && s_match[j] == r) ? 1.f : 0.f;\n  }\n}\n",
     "    dst[e] = (r < n && s_match[j] == r) ? 1.f : 0.f;\n  }\n"
     "  const long long t_end = clock64();\n"
     "  if (lane == 0 && lap_phase_out != nullptr) {\n"
     "    long long* rec = lap_phase_out + 8LL * b;\n"
     "    rec[0] = t_landed - t_entry; rec[1] = t_dj; rec[2] = n_dj;\n"
     "    rec[3] = t_aug; rec[4] = n_aug; rec[5] = t_end - t_solved;\n"
     "    rec[6] = t_end - t_entry;\n"
     "  }\n}\n"),
)


# Design (b) of the columns route, which the committed kernel (design (a):
# the cost rows read from L2) was measured against: the cost rows in the
# shared memory of a thread-block cluster of G blocks a problem. Block g
# holds the columns j = l * G + g (l = s * 256 + thread) and their part of
# every cost row, [O][ceil(P / G)]; a step reads row i0 from its own shared
# memory, each warp's (key, tag) goes to every block of the cluster through
# distributed shared memory, and one cluster barrier a step replaces the
# block's; each block keeps the owners and predecessors of all columns and
# walks back alone. ``--variants cluster`` adds it to a source that has the
# redesigned columns route, by exact edits.
CLUSTER_EDITS = (
    # (only a source with the redesigned columns route)
    ("int lap_columns_slots(int O, int P)",
     "int lap_columns_slots(int O, int P)"),
    ("#include <cstdint>\n",
     "#include <cstdint>\n\n#include <cooperative_groups.h>\n"),
    ("}  // namespace\n", r"""
namespace cg = cooperative_groups;

template <int K, int G>
__global__ void __launch_bounds__(COLUMN_THREADS, 1)
lap_cluster_kernel(const float* __restrict__ cost,
                   const int* __restrict__ num_objects,
                   float* __restrict__ out, int O, int P, int vec) {
  constexpr int T = COLUMN_THREADS;
  constexpr int HELD = K * T * G;
  constexpr int CW = G * COLUMN_WARPS;  // the warps of a cluster
  static_assert(CW <= WARP, "a lane for each warp's pair");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned long long s_room[2][CW];
  __shared__ float s_u[MAX_OBJECTS];
  __shared__ int s_match[HELD];
  __shared__ int s_way[HELD];
  LAP_ONLY(const long long t_entry = clock64();
           long long t_dj = 0, n_dj = 0, t_aug = 0, n_aug = 0;)
  cg::cluster_group cluster = cg::this_cluster();
  const int g = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int lane = tid % WARP;
  const int b = blockIdx.x / G;
  const int C = P + O + 1;
  const int virt = C - 1;
  const int free_row = O;
  const int Wd = (P + G - 1) / G;  // the block's part of a cost row
  const int n = num_objects[b];
  const long long base = static_cast<long long>(b) * O * P;
  float* s_cost = reinterpret_cast<float*>(smem);  // [O][Wd]
  for (int e = tid; e < O * Wd; e += T) {
    const int r = e / Wd;
    const int j = (e - r * Wd) * G + g;
    if (j < P)
      s_cost[e] = __ldg(cost + base + static_cast<long long>(r) * P + j);
  }
  for (int j = tid; j < HELD; j += T) s_match[j] = free_row;
  if (tid < MAX_OBJECTS) s_u[tid] = 0.f;
  float v[K];
#pragma unroll
  for (int s = 0; s < K; ++s) v[s] = 0.f;
  float u = 0.f;
  int parity = 0;
  cluster.sync();  // every block runs and has its rows, before a remote store
  LAP_ONLY(const long long t_landed = clock64();)
  for (int i = 0; i < O; ++i) {
    int j0 = virt;
    int i0 = i;
    float delta = 0.f;
    bool hit = false;
    LAP_ONLY(const long long t_search = clock64();)
    unsigned tag[K];
    float minv[K];
    int way[K];
    unsigned used = 0;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const int j = (s * T + tid) * G + g;
      tag[s] = static_cast<unsigned>(j) << 8 |
               static_cast<unsigned>(j == virt ? i : s_match[j]);
      minv[s] = INF;
      way[s] = virt;
      used |= (j >= C ? 1u : 0u) << s;
    }
    for (int step = 0; step < C; ++step) {
      LAP_ONLY(++n_dj;)
      if (i0 == free_row) break;
      const float* row = s_cost + i0 * Wd;
      const bool i0_inactive = i0 >= n;
      float c[K];
#pragma unroll
      for (int s = 0; s < K; ++s) {
        const int l = s * T + tid;
        const int j = l * G + g;
        c[s] = (j == P + i0 && i0_inactive) ? -BIG : BIG;
        if (j < P) c[s] = row[l];
      }
      const float u_i0 = s_u[i0];
#pragma unroll
      for (int s = 0; s < K; ++s) {
        const bool taken = used >> s & 1u;
        v[s] = taken ? __fsub_rn(v[s], delta) : v[s];
        minv[s] = taken ? minv[s] : __fsub_rn(minv[s], delta);
      }
      u = hit ? __fadd_rn(u, delta) : u;
      hit = hit || tid == i0;
      if (j0 % G == g && ((j0 / G) & (T - 1)) == tid)
        used |= 1u << (j0 / G / T);
      float masked[K];
      unsigned pick[K];
#pragma unroll
      for (int s = 0; s < K; ++s) {
        masked[s] = relax(c[s], u_i0, v[s], used >> s & 1u, j0, minv[s],
                          way[s]);
        pick[s] = tag[s];
      }
#pragma unroll
      for (int w = 1; w < K; w *= 2)
#pragma unroll
        for (int s = 0; s + w < K; s += 2 * w)
          if (masked[s + w] < masked[s]) {
            masked[s] = masked[s + w];
            pick[s] = pick[s + w];
          }
      const unsigned key = order_key(masked[0]);
      const unsigned least = __reduce_min_sync(0xffffffffu, key);
      const unsigned first =
          __reduce_min_sync(0xffffffffu, key == least ? pick[0] : ~0u);
      unsigned long long* room = s_room[parity];
      if (lane < G)  // each block of the cluster gets the warp's pair
        *cluster.map_shared_rank(room + g * COLUMN_WARPS + tid / WARP, lane) =
            static_cast<unsigned long long>(least) << 32 | first;
      cluster.sync();
      const unsigned long long theirs = lane < CW ? room[lane] : ~0ull;
      const unsigned key_w = static_cast<unsigned>(theirs >> 32);
      const unsigned cl_least = __reduce_min_sync(0xffffffffu, key_w);
      const unsigned cl_first = __reduce_min_sync(
          0xffffffffu,
          key_w == cl_least ? static_cast<unsigned>(theirs) : ~0u);
      parity ^= 1;
      delta = key_value(cl_least);
      j0 = static_cast<int>(cl_first >> 8);
      i0 = static_cast<int>(cl_first & 0xffu);
    }
#pragma unroll
    for (int s = 0; s < K; ++s) {
      if (used >> s & 1u) v[s] = __fsub_rn(v[s], delta);
      const int j = (s * T + tid) * G + g;
      for (int r = 0; r < G; ++r)
        *cluster.map_shared_rank(s_way + j, r) = way[s];
    }
    u = hit ? __fadd_rn(u, delta) : u;
    if (tid < O) s_u[tid] = u;
    LAP_ONLY(const long long t_searched = clock64();
             t_dj += t_searched - t_search;)
    cluster.sync();  // every column's predecessor in every block
    if (tid == 0) {
      s_match[virt] = i;
      LAP_ONLY(n_aug +=) walk_back(s_way, s_match, j0, virt, C);
    }
    __syncthreads();
    LAP_ONLY(t_aug += clock64() - t_searched;)
  }
  LAP_ONLY(const long long t_solved = clock64();)
  float* dst = out + base;
  const long long OP = static_cast<long long>(O) * P;
  for (long long e = g * T + tid; e < OP; e += T * G) {
    const int r = static_cast<int>(e / P);
    dst[e] = (r < n && s_match[e - static_cast<long long>(r) * P] == r) ? 1.f
                                                                       : 0.f;
  }
  LAP_ONLY(
      const long long t_end = clock64();
      if (g == 0 && tid == 0 && lap_phase_out != nullptr) {
        long long* rec = lap_phase_out + 8LL * b;
        rec[0] = t_landed - t_entry;
        rec[1] = t_dj;
        rec[2] = n_dj;
        rec[3] = t_aug;
        rec[4] = n_aug;
        rec[5] = t_end - t_solved;
        rec[6] = t_end - t_entry;
      })
  (void)vec;
}

template <int K, int G>
int launch_cluster(const float* cost, const int* num_objects, float* out,
                   int B, int O, int P, cudaStream_t stream) {
  const long long smem = 4LL * O * ((P + G - 1) / G);
  auto kernel = lap_cluster_kernel<K, G>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(B * G);
  config.blockDim = dim3(COLUMN_THREADS);
  config.dynamicSmemBytes = static_cast<size_t>(smem);
  config.stream = stream;
  cudaLaunchAttribute attribute[1];
  attribute[0].id = cudaLaunchAttributeClusterDimension;
  attribute[0].val.clusterDim.x = G;
  attribute[0].val.clusterDim.y = 1;
  attribute[0].val.clusterDim.z = 1;
  config.attrs = attribute;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, kernel, cost, num_objects, out, O, P, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int G>
int launch_cluster_slots(const float* cost, const int* num_objects,
                         float* out, int B, int O, int P, cudaStream_t st) {
  const long long C = static_cast<long long>(P) + O + 1;
  if (C <= 1LL * COLUMN_THREADS * G)
    return launch_cluster<1, G>(cost, num_objects, out, B, O, P, st);
  if (C <= 2LL * COLUMN_THREADS * G)
    return launch_cluster<2, G>(cost, num_objects, out, B, O, P, st);
  if (C <= 3LL * COLUMN_THREADS * G)
    return launch_cluster<3, G>(cost, num_objects, out, B, O, P, st);
  if (C <= 4LL * COLUMN_THREADS * G)
    return launch_cluster<4, G>(cost, num_objects, out, B, O, P, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
"""),
    ('}  // extern "C"', r"""// Design (b): B problems on clusters of G = 2 or 4 blocks.
int lap_solve_cluster(const void* cost, const void* num_objects, void* out,
                      int B, int O, int P, int G, void* stream) {
  if (B <= 0 || O <= 0 || P <= 0 || O > MAX_OBJECTS)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* c = static_cast<const float*>(cost);
  const int* n = static_cast<const int*>(num_objects);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G == 2) return launch_cluster_slots<2>(c, n, o, B, O, P, st);
  if (G == 4) return launch_cluster_slots<4>(c, n, o, B, O, P, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

""" + '}  // extern "C"'),
)


# The columns route's block argmin with an mbarrier phase in place of the
# block's named barrier (__syncthreads): each warp's first lane arrives
# after it writes its pair, every thread waits on the step's phase.
MBARRIER_EDITS = (
    (r"""__device__ __forceinline__ unsigned long long block_argmin(
    unsigned key, unsigned tag, unsigned long long* room) {""",
     r"""__shared__ unsigned long long lap_step_bar;

__device__ __forceinline__ unsigned long long block_argmin(
    unsigned key, unsigned tag, unsigned long long* room, unsigned phase) {"""),
    (r"""  if (lane == 0)
    room[threadIdx.x / WARP] =
        static_cast<unsigned long long>(least) << 32 | first;
  __syncthreads();
""", r"""  const unsigned bar =
      static_cast<unsigned>(__cvta_generic_to_shared(&lap_step_bar));
  if (lane == 0) {
    room[threadIdx.x / WARP] =
        static_cast<unsigned long long>(least) << 32 | first;
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
                 : "memory");
  }
  for (unsigned done = 0; !done;)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(phase) : "memory");
"""),
    ("block_argmin(order_key(masked[0]), pick[0], s_room[parity]);",
     "block_argmin(order_key(masked[0]), pick[0], s_room[parity], parity);"),
    ("pick == ~0u ? ~0u : order_key(low), pick, s_room[parity]);",
     "pick == ~0u ? ~0u : order_key(low), pick, s_room[parity], parity);"),
    ("  if (tid < MAX_OBJECTS) s_u[tid] = 0.f;\n  float v[K > 0 ? K : 1];",
     r"""  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
        static_cast<unsigned>(__cvta_generic_to_shared(&lap_step_bar))),
                 "r"(COLUMN_WARPS));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < MAX_OBJECTS) s_u[tid] = 0.f;
  float v[K > 0 ? K : 1];"""),
)

# The columns route's block argmin with each thread reducing the warps'
# pairs itself (a tree of 64-bit minima) in place of two redux.sync.
PAIRS_EDITS = (
    ("""  const unsigned long long theirs = lane < COLUMN_WARPS ? room[lane] : ~0ull;
  const unsigned key_w = static_cast<unsigned>(theirs >> 32);
  const unsigned block_least = __reduce_min_sync(0xffffffffu, key_w);
  const unsigned block_first = __reduce_min_sync(
      0xffffffffu,
      key_w == block_least ? static_cast<unsigned>(theirs) : ~0u);
  return static_cast<unsigned long long>(block_least) << 32 | block_first;
""", """  unsigned long long pair[COLUMN_WARPS];
#pragma unroll
  for (int w = 0; w < COLUMN_WARPS; ++w) pair[w] = room[w];
#pragma unroll
  for (int h = 1; h < COLUMN_WARPS; h *= 2)
#pragma unroll
    for (int w = 0; w + h < COLUMN_WARPS; w += 2 * h)
      pair[w] = pair[w + h] < pair[w] ? pair[w + h] : pair[w];
  return pair[0];
"""),
)

# The columns route without its prefetch of the cost rows into L2.
NOPREFETCH_EDITS = (
    ("""  for (long long at = 128LL * tid; at < 4LL * O * P; at += 128LL * T)
    prefetch_l2(rows + at);
""", ""),
)

# The columns route asking for the smallest shared-memory carveout (the
# most L1 for the cost rows it reads again).
CARVEOUT_EDITS = (
    ("  lap_columns_kernel<K><<<B, COLUMN_THREADS, 0, stream>>>(",
     "  cudaFuncSetAttribute(lap_columns_kernel<K>,\n"
     "                       cudaFuncAttributePreferredSharedMemoryCarveout,"
     " 0);\n"
     "  lap_columns_kernel<K><<<B, COLUMN_THREADS, 0, stream>>>("),
)

# The columns route's first step of a search taking the costs read ahead
# by a select after a predicated load, in place of a branch.
SELECT_EDITS = (
    ("""        float c[K];
        if (step == 0) {  // a branch, so that no load waits in this step
#pragma unroll
          for (int s = 0; s < K; ++s) c[s] = first[s];
        } else {
#pragma unroll
          for (int s = 0; s < K; ++s)
            c[s] = column_cost(row, s * T + tid, P, i0, i0 >= n);
        }
""", """        float c[K];
#pragma unroll
        for (int s = 0; s < K; ++s) {
          const int j = s * T + tid;
          c[s] = (j == P + i0 && i0 >= n) ? -BIG : BIG;
          if (step != 0 && j < P) c[s] = __ldg(row + j);
          c[s] = step == 0 ? first[s] : c[s];
        }
"""),
)

# The columns route without reading search i + 1's first row ahead.
NOREADAHEAD_EDITS = (
    ("""        float c[K];
        if (step == 0) {  // a branch, so that no load waits in this step
#pragma unroll
          for (int s = 0; s < K; ++s) c[s] = first[s];
        } else {
#pragma unroll
          for (int s = 0; s < K; ++s)
            c[s] = column_cost(row, s * T + tid, P, i0, i0 >= n);
        }
""", """        float c[K];
#pragma unroll
        for (int s = 0; s < K; ++s)
          c[s] = column_cost(row, s * T + tid, P, i0, i0 >= n);
"""),
    ("""      if (i + 1 < O) {
        const float* next = cost + base + static_cast<long long>(i + 1) * P;
#pragma unroll
        for (int s = 0; s < K; ++s)
          first[s] = column_cost(next, s * T + tid, P, i + 1, i + 1 >= n);
      }
""", ""),
)

# --variants: name -> exact edits of the committed source
VARIANTS = {"shuffle": (SHUFFLE_ARGMIN,), "cluster": CLUSTER_EDITS,
            "mbarrier": MBARRIER_EDITS, "pairs": PAIRS_EDITS,
            "noprefetch": NOPREFETCH_EDITS, "carveout": CARVEOUT_EDITS,
            "select": SELECT_EDITS, "noreadahead": NOREADAHEAD_EDITS}


def variant_source(src: str, name: str) -> str:
    """``src`` with the edits of variant ``name``, each of which must match
    exactly once."""
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: the source has {src.count(old)} "
                               f"matches of the edit starting {old[:50]!r}")
        src = src.replace(old, new)
    return src

def stamped_source(src: str) -> str:
    """``src`` with the stamps: as it is when it has the hooks, else with
    ``EDITS``, each of which must match exactly once."""
    if "LAP_PHASES" in src:
        return src
    for old, new in EDITS:
        if src.count(old) != 1:
            raise RuntimeError(f"the source has {src.count(old)} matches of "
                               f"the edit starting {old[:50]!r}")
        src = src.replace(old, new)
    return src + _BUFFER


def _build(text: str, tag: str, defines) -> tuple:
    from boosted_detr_torch.ops import build

    out_dir = build.BUILD_DIR.parent / "probes"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / f"lap_{tag}.cu"
    cu.write_text(text)
    lib = out_dir / f"liblap_{tag}.so"
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I",
                           str(build.CSRC), *(f"-D{d}" for d in defines),
                           "-o", str(lib), str(cu)],
                          capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {tag}:\n{proc.stderr}")
    report = [s.strip() for s in (proc.stdout + proc.stderr).splitlines()
              if "registers" in s or "spill" in s or "stack frame" in s
              or "Compiling entry" in s]
    dll = ctypes.CDLL(str(lib))
    dll.lap_solve.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                              + [ctypes.c_void_p])
    dll.lap_solve.restype = ctypes.c_int
    if "lap_solve_columns" in text:
        dll.lap_solve_columns.argtypes = ([ctypes.c_void_p] * 4
                                          + [ctypes.c_int] * 3
                                          + [ctypes.c_void_p])
        dll.lap_solve_columns.restype = ctypes.c_int
        dll.lap_columns_bytes.argtypes = [ctypes.c_int] * 2
        dll.lap_columns_bytes.restype = ctypes.c_longlong
    return dll, report


def _columns_scratch(lib, text, o, p):
    """The scratch bytes a problem of ``lib``'s columns route: the source
    states them in ``lap_columns_bytes``; before the redesign (no
    ``lap_columns_slots``) that function gave the column state's bytes,
    kept in shared memory up to the 227 KB a block may use."""
    from boosted_detr_torch.ops import lap as L

    need = int(lib.lap_columns_bytes(o, p))
    if "lap_columns_slots" in text:
        return need
    return need if need > L.SMEM_LIMIT else 0


def _phases(recs, steps_of):
    """The records of a launch, summed over its problems, and the slowest
    problem's."""
    tot = {f: int(recs[:, i].sum()) for i, f in enumerate(FIELDS)}
    slow = int(recs[:, 6].argmax())
    one = {f: int(recs[slow, i]) for i, f in enumerate(FIELDS)}
    one["rest"] = one["total"] - sum(one[f] for f in (
        "prologue", "dijkstra", "augmentation", "epilogue"))
    return {
        # the slowest problem's searches over its relaxing steps (the
        # plain version's count: the steps that find a free column and
        # stop cost their share too)
        "cycles_per_relaxing_step": one["dijkstra"] / max(1, steps_of[slow]),
        "cycles_per_dijkstra_step": tot["dijkstra"] / max(
            1, tot["dijkstra_steps"]),
        "cycles_per_augmentation_step": tot["augmentation"] / max(
            1, tot["augmentation_steps"]),
        "prologue_cycles_median": sorted(recs[:, 0].tolist())[len(recs) // 2],
        "epilogue_cycles_median": sorted(recs[:, 5].tolist())[len(recs) // 2],
        "slowest_problem": {"index": slow, **one,
                            "plain_version_steps": steps_of[slow]},
    }


def _launcher(lib, text, route, cost, n, out, b, o, p):
    """A launch of ``lib``'s ``route`` on these tensors, or None where
    the source does not take the shape on it."""
    import torch

    if route == "slots":
        def launch():
            rc = lib.lap_solve(cost.data_ptr(), n.data_ptr(), out.data_ptr(),
                               b, o, p,
                               torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"launch refused ({rc})")
        try:
            launch()
        except RuntimeError:
            return None
        return launch
    if route.startswith("cluster"):
        if "lap_solve_cluster" not in text:
            return None
        lib.lap_solve_cluster.argtypes = ([ctypes.c_void_p] * 3
                                          + [ctypes.c_int] * 4
                                          + [ctypes.c_void_p])

        def launch():
            rc = lib.lap_solve_cluster(
                cost.data_ptr(), n.data_ptr(), out.data_ptr(), b, o, p,
                int(route[len("cluster"):]),
                torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"launch refused ({rc})")
        try:
            launch()
        except RuntimeError:
            return None
        return launch
    if "lap_solve_columns" not in text:
        return None
    need = _columns_scratch(lib, text, o, p)
    scratch = (torch.empty(b * need, dtype=torch.uint8, device="cuda")
               if need else None)

    def launch():
        rc = lib.lap_solve_columns(
            cost.data_ptr(), n.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), b, o, p,
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch refused ({rc})")
    launch()
    return launch


def main(argv) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("sources", nargs="*", type=Path)
    parser.add_argument("--variants", nargs="*", default=[],
                        choices=sorted(VARIANTS),
                        help="builds of each source with these edits")
    parser.add_argument("--shapes", nargs="*", default=None,
                        help="B,O,P problems in place of K2_CASES")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("lap_phases: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from boosted_detr_torch.ops import lap as L

    cases = cs.K2_CASES
    if args.shapes:
        # K2_CASES' inputs where a case has the shape
        known = {(b, o, p): case for b, o, p, *case in cases}
        cases = []
        for k, shape in enumerate(args.shapes):
            b, o, p = map(int, shape.split(","))
            cases.append((b, o, p, *known.get((b, o, p), (90 + k, True))))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip(), flush=True)
    flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
    builds = []
    for source in args.sources or [SOURCE]:
        src = source.resolve().read_text()
        name = str(source.resolve().relative_to(ROOT)
                   if source.resolve().is_relative_to(ROOT) else source)
        builds.append((name, "as is", src))
        for variant in args.variants:
            try:
                builds.append((name, variant, variant_source(src, variant)))
            except RuntimeError as err:  # a source before or after them
                print(f"{name}: no {variant} build: {err}", flush=True)
    jobs = [(text, f"{k}_timed", ()) for k, (_, _, text) in enumerate(builds)]
    jobs += [(stamped_source(text), f"{k}_stamped", ("LAP_PHASES",))
             for k, (_, _, text) in enumerate(builds)]
    def build(job):
        try:
            return _build(*job)
        except RuntimeError as err:  # a variant that nvcc refuses
            return err

    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:  # nvcc at once
        built = list(pool.map(build, jobs))
    libs = []
    for k, (name, tag, text) in enumerate(builds):
        failed = [r for r in (built[k], built[len(builds) + k])
                  if isinstance(r, RuntimeError)]
        if failed:
            if tag == "as is":
                raise failed[0]
            print(f"{name} ({tag}): not built: {str(failed[0])[:2000]}",
                  flush=True)
            continue
        (timed, report), (stamped, _) = built[k], built[len(builds) + k]
        print(f"{name} ({tag}): ptxas (no stamps):", *report, flush=True)
        stamped.lap_phase_buffer.argtypes = [ctypes.c_void_p]
        libs.append((name, tag, text, timed, stamped))
    for b, o, p, seed, edges in cases:
        cost_np, n_np = cs._lap_inputs(b, o, p, seed, edges)
        cost = torch.from_numpy(cost_np).cuda()
        n = torch.from_numpy(n_np).cuda()
        out = torch.empty_like(cost)
        recs = torch.zeros((b, 8), dtype=torch.int64, device="cuda")
        want = L.hungarian_lap_reference(cost, n)
        steps = []
        for i in range(b):
            L.hungarian_lap_reference.relaxations = 0
            L.hungarian_lap_reference(cost[i:i + 1], n[i:i + 1])
            steps.append(L.hungarian_lap_reference.relaxations)
        for name, tag, text, timed, stamped in libs:
            routes = (("cluster2", "cluster4") if tag == "cluster"
                      else ("slots", "columns"))
            for route in routes:
                row = {"source": name, "build": tag, "route": route,
                       "shape": [b, o, p], "edges": edges,
                       "longest_steps": max(steps)}
                launch = _launcher(timed, text, route, cost, n, out, b, o, p)
                if launch is None:
                    continue
                torch.cuda.synchronize()
                if not torch.equal(out, want):
                    raise AssertionError(f"{name} {route} {row['shape']}: "
                                         f"the mask is not the plain "
                                         f"version's")
                row["ms"] = cs._time_ms(launch, flush)
                row["device_ms"] = cs._time_ms(launch, flush,
                                               spin_cycles=cs.SPIN_CYCLES)
                if stamped.lap_phase_buffer(recs.data_ptr()) != 0:
                    raise RuntimeError("lap_phase_buffer failed")
                recs.zero_()
                launch = _launcher(stamped, text, route, cost, n, out, b, o,
                                   p)
                for _ in range(3):  # the last launch's records stay
                    launch()
                torch.cuda.synchronize()
                if not torch.equal(out, want):
                    raise AssertionError(f"{name} {route} {row['shape']}: "
                                         f"the stamped build's mask is not "
                                         f"the plain version's")
                if int(recs[:, 6].sum()) > 0:
                    row.update(_phases(recs[:, :7].cpu().numpy(), steps))
                else:
                    row["stamps"] = "none in this kernel"
                stamped.lap_phase_buffer(None)
                print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
