// Fused attention (K3) for Hopper (sm_90a): the forward with its per-row
// log-sum-exp, and the two kernels of its gradient.
//
// Replaces the Pallas TPU kernels of boosted_detr_tpu/ops/pallas_attention.py:
//   attn_fwd_kernel, attn_fwd_mma_kernel, attn_fwd_wgmma_kernel
//   (attn_fwd_wide_*) <- _attention_kernel (:45-80), called by
//                       _fused_attention_fwd_impl (:97-135, call :112);
//   attn_dq_kernel, attn_dq_mma_kernel, attn_dq_wgmma_kernel
//   (attn_dq_wide_*) <- _dq_kernel (:138-163), called by
//                       _fused_attention_bwd_impl (:202-255, call :233);
//   attn_dkdv_kernel, attn_dkdv_mma_kernel, attn_dkdv_wgmma_kernel
//   (attn_dkdv_wide_*) <- _dkdv_kernel (:166-199), same function, call :257.
// q is [BH, Tq, D], k and v [BH, Tk, D], contiguous, all float32 or all
// bfloat16, with no mask; D is 32, 64, 80, 128 or a multiple of 128 (the
// wrapper pads any other D with zeros up to the next of those, as the TPU
// kernels pad D to a multiple of 128 lanes; ViT-Huge's D = 80 runs at its
// true width, which the TPU pads to 128; past 128 the wide kernels below
// take D in 128-wide chunks). The arithmetic is the TPU kernels':
//   - q, k and v are read in their dtype; products of bf16 values are exact
//     in float32;
//   - the logits are scale * q.k (scale = 1/sqrt(D)); the float32 kernels
//     form qs = q * scale before the dot, the bfloat16 kernels multiply the
//     exact bf16 q and k and scale the float32 logit (the two differ by
//     float32 rounding only);
//   - logits, the running max, exp, the denominator and the P.V sums are
//     float32; out = acc / max(denom, 1e-30) in q's dtype, and
//     lse = m + log(max(denom, 1e-30)) float32 [BH, Tq];
//   - p = exp(qs.k - lse), ds = p (dO.v - delta), dq = scale sum_k ds k,
//     dv = sum_q p dO, dk = sum_q ds qs, each cast to its input's dtype.
// delta = rowsum(dO * O) - g_lse [BH, Tq] float32 comes from the caller (one
// cheap pass that the JAX package leaves to XLA too).
//
// Bound on an H100 SXM at the 1280px encoder shape (BH = 64, T = 1600,
// D = 32, bfloat16): the forward is 4 BH T^2 D = 21.0 GFLOP, 21 us on the
// bf16 tensor cores (989 TFLOP/s), against 26.6 MB of q, k, v, out and lse,
// 8 us at 3.35 TB/s; dq (6 BH T^2 D) and dk/dv (8 BH T^2 D) are 32 and
// 42 us. Operations bound all three. (At D = 32 the special-function unit
// sets a higher floor than the tensor cores: one ex2 for each of the 164 M
// pairs of a query and a key, 16 a clock on each of 132 SMs, is about 45
// us.)
//
// Float32 inputs multiply in float32 on the CUDA cores, whose peak (67
// TFLOP/s) puts a floor ~15x above that bound (they stay there: tensor cores
// would make them TF32):
//   - a block owns 64 rows (query rows for the forward and dq, key rows for
//     dk/dv) and keeps their float32 slices in registers: each thread owns
//     DPT of the D dims of one row, TPR = D / DPT neighbouring lanes share a
//     row, and a dot product is summed over them with xor shuffles;
//   - the other operand streams through shared memory in tiles of 64 rows
//     (rows past the end zero-filled); all threads read the same staged row
//     at a time, in float4 chunks that the TPR threads of a row take side by
//     side, so the reads broadcast without bank conflicts;
//   - the forward takes keys 16 at a time: one max, one exp of the old max
//     and one rescale of the accumulator per chunk, as the TPU kernel does
//     per 512-key block; dq and dk/dv take 4 rows at a time (chunks of 8
//     spilled registers to local memory).
//
// bfloat16 inputs run on the tensor cores (at D <= 64 attn_fwd_mma_kernel,
// attn_dq_mma_kernel and attn_dkdv_mma_kernel; at D = 80 and 128 the
// forward, dq and dk/dv take the wgmma kernels of their own section
// below):
//   - every product is mma.sync.m16n8k16 on bf16 operands with float32
//     accumulators. A block of 4 warps owns 64 rows, 16 a warp, whose q
//     (forward), q and dO (dq) or k and v (dk/dv) sit in registers as A
//     fragments for the whole kernel; the other operand streams through
//     shared memory in 64-row bf16 tiles, which ldmatrix turns into B
//     fragments: plain where the contraction runs over the head dim
//     (S = Q K^T, dP = dO V^T and their transposes), .trans where it runs
//     over the tile's rows (acc += P V, dq += dS K, dv += P^T dO,
//     dk += dS^T Q);
//   - the 16 x 16 float32 accumulators of S and dP become p and ds in
//     registers, 16 rows of the tile at a time, and are repacked as the A
//     fragment of the second product (two m16n8 accumulators side by side
//     have the m16k16 A layout), so p and ds never touch shared or device
//     memory;
//   - p and ds stay float32 through the second products on the TPU. One
//     bf16 rounding of them (2^-9 relative a term) shows in the result
//     beyond one rounding of it, in the forward's output as in the
//     gradients, so each is split into two bf16 values, hi = bf16(x) and
//     lo = bf16(x - hi) (~16 mantissa bits), and the second product is
//     issued twice into one accumulator: the forward costs 3, dq 4 and
//     dk/dv 6 tensor-core passes per pair of tiles instead of 2, 3 and 4;
//   - the forward's online softmax works a 64-key tile at a time: S for the
//     whole tile, the rows' new max (over a thread's 16 keys, then two xor
//     shuffles over the 4 lanes of a row), one rescale of acc and denom, then
//     p = 2^(scale2 (s - max)); denom sums the float32 p (each thread its
//     own keys; the 4 lanes are summed once, at the end). The max is taken
//     of the unscaled products, so that lse = scale max + log(denom) carries
//     one rounding. Keys past Tk are masked to -1e30 in the last tile; every
//     tile starts at a real key, so the max is a real logit;
//   - the exponentials are one multiply-add and one ex2.approx of the
//     special-function unit (log2(e) folded into the scale and the lse;
//     relative error 2^-22, below the float32 rounding of the logit);
//   - tiles are staged two deep with cp.async (16 bytes a thread), so that
//     tile i + 1 loads while tile i multiplies, with one __syncthreads a
//     tile: after it every thread's copies of tile i have landed and every
//     thread is done with tile i - 1, whose stage the next copies then
//     overwrite. Staged rows are padded by 16 bytes (a pitch of 80 or 144
//     bytes, 272 in the chunked wide kernels): the eight 16-byte rows that
//     an ldmatrix phase reads then fall into eight different bank groups,
//     with or without .trans, so no read conflicts;
//   - dq and dk are multiplied by scale once, at the end;
//   - what holds them at 8-16% of their bounds at the 1600-token shapes
//     (PERF.md): mma.sync is not the card's fastest path (wgmma is), a third
//     or more of the passes are the lo halves, and the float32 work on p and
//     ds (mask, max, exp, sum, split) shares the issue slots with the MMAs.
//
// At D = 80 (ViT-Huge's; any D in (64, 80] padded to it) and 128 (any D
// in (80, 128]):
//   - the forward, dq and dk/dv in bf16 are attn_fwd_wgmma_kernel,
//     attn_dq_wgmma_kernel and attn_dkdv_wgmma_kernel (their section
//     below: warpgroup products, TMA, the block's rows resident in shared
//     memory, rows staged 128 wide with TMA's zeros past dim 80). Zero
//     columns add exact zeros to every sum, so D = 80 gives the bits it
//     gave padded to 128;
//   - every kernel takes its tiles from dynamic shared memory, sized at
//     launch, and a launch above 48 KB first opts its kernel in
//     (cudaFuncAttributeMaxDynamicSharedMemorySize; allow_smem): the
//     float32 kernels' k and v tiles are 64 KB at D = 128;
//   - the float32 kernels keep their layout, DPT dims a thread and TPR = 4
//     threads a row (256 threads), the row sums xor-shuffled over those
//     aligned lanes: 20 dims a thread at D = 80, 32 at 128; dk/dv takes one
//     query row a step (dkdv_dpt).
// ptxas -v's registers and spills of every instantiation are printed by
// chip_smoke.py's build phase and kept in PERF.md.
//
// Common to all:
//   - the gradient is two kernels, as on the TPU: dq streams over key tiles
//     and dk/dv over query tiles, so that every sum belongs to one thread
//     and runs in a fixed order, with no atomics: two launches on the same
//     inputs give the same bits (the forward's too);
//   - keys past Tk and query rows past Tq are masked (zero-filled when
//     staged, p = 0) where the TPU padded T to its 256/512 blocks and D to
//     128 lanes, and the lse is one float32 per row where the TPU kept a
//     lane-replicated [Tq_pad, 128] tile.

#include <type_traits>

#include "mma.cuh"

namespace {

constexpr int ROWS = 64;  // rows a block owns
constexpr int TILE = 64;  // rows of the other operand staged per step
constexpr float NEG = -1e30f;
constexpr float FLOOR = 1e-30f;
// dynamic shared memory a kernel may take without opting in
constexpr int DEFAULT_SMEM = 48 * 1024;

// Lets `kernel` take `bytes` of dynamic shared memory: above 48 KB a kernel
// must opt in before its launch (a host-side attribute, set again at each
// such launch so that it holds on whichever device is current).
template <typename Kernel>
cudaError_t allow_smem(Kernel* kernel, int bytes) {
  if (bytes <= DEFAULT_SMEM) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// The row dim of element e of the DPT-dim slice that thread h of a row
// owns: the slice is DPT / 4 chunks of 4 dims, and its chunk c is chunk
// c * TPR + h of the row.
template <int DPT, int TPR>
__device__ __forceinline__ int dim_of(int e, int h) {
  return 4 * ((e / 4) * TPR + h) + (e % 4);
}

// x = the slice of `row` times mul; zeros when !live.
template <int DPT, int TPR>
__device__ __forceinline__ void load_slice(const float* row, int h, bool live,
                                           float mul, float (&x)[DPT]) {
#pragma unroll
  for (int e = 0; e < DPT; ++e)
    x[e] = live ? row[dim_of<DPT, TPR>(e, h)] * mul : 0.f;
}

template <int DPT, int TPR>
__device__ __forceinline__ void store_slice(const float (&x)[DPT], float mul,
                                            int h, float* row) {
#pragma unroll
  for (int e = 0; e < DPT; ++e) row[dim_of<DPT, TPR>(e, h)] = x[e] * mul;
}

// The partial dot product of a slice with the same slice of a staged row.
template <int DPT, int TPR>
__device__ __forceinline__ float dot_slice(const float (&x)[DPT],
                                           const float* srow, int h) {
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < DPT / 4; ++c) {
    const float4 r = *reinterpret_cast<const float4*>(srow + 4 * (c * TPR + h));
    s = fmaf(x[4 * c], r.x, s);
    s = fmaf(x[4 * c + 1], r.y, s);
    s = fmaf(x[4 * c + 2], r.z, s);
    s = fmaf(x[4 * c + 3], r.w, s);
  }
  return s;
}

// y += a * (the slice of a staged row)
template <int DPT, int TPR>
__device__ __forceinline__ void axpy_slice(float a, const float* srow, int h,
                                           float (&y)[DPT]) {
#pragma unroll
  for (int c = 0; c < DPT / 4; ++c) {
    const float4 r = *reinterpret_cast<const float4*>(srow + 4 * (c * TPR + h));
    y[4 * c] = fmaf(a, r.x, y[4 * c]);
    y[4 * c + 1] = fmaf(a, r.y, y[4 * c + 1]);
    y[4 * c + 2] = fmaf(a, r.z, y[4 * c + 2]);
    y[4 * c + 3] = fmaf(a, r.w, y[4 * c + 3]);
  }
}

// A compiler barrier between a chunk's dot products and its updates: the
// updates read the staged rows again from shared memory instead of keeping
// them in registers since the dots, which spills (ptxas -v in the build
// log shows the registers and spills of each kernel).
__device__ __forceinline__ void reread_staged_rows() {
  asm volatile("" ::: "memory");
}

// The sum over the TPR neighbouring lanes of a row (every lane of the warp
// takes part).
template <int TPR>
__device__ __forceinline__ float row_sum(float s) {
#pragma unroll
  for (int o = 1; o < TPR; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// Stages rows [0, n) of the [*, D] rows at src into dst times mul, and zeros
// for rows [n, TILE).
template <int D, int NT>
__device__ __forceinline__ void stage(const float* src, int n, float mul,
                                      float* dst) {
  for (int e = threadIdx.x; e < TILE * D; e += NT)
    dst[e] = e < n * D ? src[e] * mul : 0.f;
}

// ---- float32 inputs on the CUDA cores ----

template <int DPT, int TPR>
__global__ void __launch_bounds__(ROWS * TPR)
attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ out,
                float* __restrict__ lse, int Tq, int Tk, int tiles,
                float scale) {
  constexpr int D = DPT * TPR;
  constexpr int NT = ROWS * TPR;
  constexpr int CHUNK = 16;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sk = reinterpret_cast<float*>(smem);  // [TILE * D]
  float* sv = sk + TILE * D;
  const int bh = blockIdx.x / tiles;
  const int row = (blockIdx.x % tiles) * ROWS + threadIdx.x / TPR;
  const int h = threadIdx.x % TPR;
  const bool live = row < Tq;
  const long long q_row = (static_cast<long long>(bh) * Tq + row) * D;
  const float* kb = k + static_cast<long long>(bh) * Tk * D;
  const float* vb = v + static_cast<long long>(bh) * Tk * D;

  float x[DPT], acc[DPT];
  load_slice<DPT, TPR>(q + (live ? q_row : 0), h, live, scale, x);
#pragma unroll
  for (int e = 0; e < DPT; ++e) acc[e] = 0.f;
  float m = NEG, denom = 0.f;

  for (int k0 = 0; k0 < Tk; k0 += TILE) {
    const int nk = min(TILE, Tk - k0);
    __syncthreads();  // the previous tile is consumed
    stage<D, NT>(kb + static_cast<long long>(k0) * D, nk, 1.f, sk);
    stage<D, NT>(vb + static_cast<long long>(k0) * D, nk, 1.f, sv);
    __syncthreads();
    // every chunk starts at a real key, so its max is a real logit
    for (int j = 0; j < nk; j += CHUNK) {
      float s[CHUNK];
#pragma unroll
      for (int c = 0; c < CHUNK; ++c)
        s[c] = dot_slice<DPT, TPR>(x, sk + (j + c) * D, h);
      float m_new = m;
#pragma unroll
      for (int c = 0; c < CHUNK; ++c) {
        s[c] = row_sum<TPR>(s[c]);
        if (j + c >= nk) s[c] = NEG;
        m_new = fmaxf(m_new, s[c]);
      }
      const float alpha = expf(m - m_new);
      float p_sum = 0.f;
#pragma unroll
      for (int c = 0; c < CHUNK; ++c) {
        s[c] = expf(s[c] - m_new);
        p_sum += s[c];
      }
      denom = denom * alpha + p_sum;
#pragma unroll
      for (int e = 0; e < DPT; ++e) acc[e] *= alpha;
#pragma unroll
      for (int c = 0; c < CHUNK; ++c)
        axpy_slice<DPT, TPR>(s[c], sv + (j + c) * D, h, acc);
      m = m_new;
    }
  }
  if (live) {
    const float d = fmaxf(denom, FLOOR);
#pragma unroll
    for (int e = 0; e < DPT; ++e)
      out[q_row + dim_of<DPT, TPR>(e, h)] = acc[e] / d;
    if (h == 0) lse[static_cast<long long>(bh) * Tq + row] = m + logf(d);
  }
}

template <int DPT, int TPR>
__global__ void __launch_bounds__(ROWS * TPR)
attn_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ g,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dq, int Tq, int Tk, int tiles,
               float scale) {
  constexpr int D = DPT * TPR;
  constexpr int NT = ROWS * TPR;
  constexpr int CHUNK = 4;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sk = reinterpret_cast<float*>(smem);  // [TILE * D]
  float* sv = sk + TILE * D;
  const int bh = blockIdx.x / tiles;
  const int row = (blockIdx.x % tiles) * ROWS + threadIdx.x / TPR;
  const int h = threadIdx.x % TPR;
  const bool live = row < Tq;
  const long long q_row = (static_cast<long long>(bh) * Tq + row) * D;
  const long long r_row = static_cast<long long>(bh) * Tq + row;
  const float* kb = k + static_cast<long long>(bh) * Tk * D;
  const float* vb = v + static_cast<long long>(bh) * Tk * D;

  float qs[DPT], go[DPT], acc[DPT];
  load_slice<DPT, TPR>(q + (live ? q_row : 0), h, live, scale, qs);
  load_slice<DPT, TPR>(g + (live ? q_row : 0), h, live, 1.f, go);
#pragma unroll
  for (int e = 0; e < DPT; ++e) acc[e] = 0.f;
  const float row_lse = live ? lse[r_row] : 0.f;
  const float row_delta = live ? delta[r_row] : 0.f;

  for (int k0 = 0; k0 < Tk; k0 += TILE) {
    const int nk = min(TILE, Tk - k0);
    __syncthreads();
    stage<D, NT>(kb + static_cast<long long>(k0) * D, nk, 1.f, sk);
    stage<D, NT>(vb + static_cast<long long>(k0) * D, nk, 1.f, sv);
    __syncthreads();
    for (int j = 0; j < nk; j += CHUNK) {
      float s[CHUNK], dp[CHUNK];
#pragma unroll
      for (int c = 0; c < CHUNK; ++c) {
        s[c] = dot_slice<DPT, TPR>(qs, sk + (j + c) * D, h);
        dp[c] = dot_slice<DPT, TPR>(go, sv + (j + c) * D, h);
      }
#pragma unroll
      for (int c = 0; c < CHUNK; ++c) {
        s[c] = row_sum<TPR>(s[c]);
        dp[c] = row_sum<TPR>(dp[c]);
        const float p = j + c < nk ? expf(s[c] - row_lse) : 0.f;
        s[c] = p * (dp[c] - row_delta);  // ds
      }
      reread_staged_rows();
#pragma unroll
      for (int c = 0; c < CHUNK; ++c)
        axpy_slice<DPT, TPR>(s[c], sk + (j + c) * D, h, acc);
    }
  }
  if (live) store_slice<DPT, TPR>(acc, scale, h, dq + q_row);
}

template <int DPT, int TPR>
__global__ void __launch_bounds__(ROWS * TPR)
attn_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ g,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dk,
                 float* __restrict__ dv, int Tq, int Tk, int tiles,
                 float scale) {
  constexpr int D = DPT * TPR;
  constexpr int NT = ROWS * TPR;
  // query rows a step; one past D = 64, where four spilled at 128
  // (dkdv_dpt)
  constexpr int CHUNK = D > 64 ? 1 : 4;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sq = reinterpret_cast<float*>(smem);  // [TILE * D]: qs = q * scale
  float* sg = sq + TILE * D;                   // [TILE * D]: dO
  float* s_lse = sg + TILE * D;                // [TILE]
  float* s_delta = s_lse + TILE;               // [TILE]
  const int bh = blockIdx.x / tiles;
  const int row = (blockIdx.x % tiles) * ROWS + threadIdx.x / TPR;
  const int h = threadIdx.x % TPR;
  const bool live = row < Tk;
  const long long k_row = (static_cast<long long>(bh) * Tk + row) * D;
  const long long q_base = static_cast<long long>(bh) * Tq;

  float kr[DPT], vr[DPT], dk_acc[DPT], dv_acc[DPT];
  load_slice<DPT, TPR>(k + (live ? k_row : 0), h, live, 1.f, kr);
  load_slice<DPT, TPR>(v + (live ? k_row : 0), h, live, 1.f, vr);
#pragma unroll
  for (int e = 0; e < DPT; ++e) dk_acc[e] = dv_acc[e] = 0.f;

  for (int q0 = 0; q0 < Tq; q0 += TILE) {
    const int nq = min(TILE, Tq - q0);
    __syncthreads();
    stage<D, NT>(q + (q_base + q0) * D, nq, scale, sq);
    stage<D, NT>(g + (q_base + q0) * D, nq, 1.f, sg);
    for (int i = threadIdx.x; i < TILE; i += NT) {
      s_lse[i] = i < nq ? lse[q_base + q0 + i] : 0.f;
      s_delta[i] = i < nq ? delta[q_base + q0 + i] : 0.f;
    }
    __syncthreads();
    for (int i = 0; i < nq; i += CHUNK) {
      float s[CHUNK], dp[CHUNK];
#pragma unroll
      for (int c = 0; c < CHUNK; ++c) {
        s[c] = dot_slice<DPT, TPR>(kr, sq + (i + c) * D, h);
        dp[c] = dot_slice<DPT, TPR>(vr, sg + (i + c) * D, h);
      }
#pragma unroll
      for (int c = 0; c < CHUNK; ++c) {
        s[c] = row_sum<TPR>(s[c]);
        dp[c] = row_sum<TPR>(dp[c]);
        // query rows past Tq are masked out of p
        const float p = i + c < nq ? expf(s[c] - s_lse[i + c]) : 0.f;
        s[c] = p;
        dp[c] = p * (dp[c] - s_delta[i + c]);  // ds
      }
      reread_staged_rows();
#pragma unroll
      for (int c = 0; c < CHUNK; ++c) {
        axpy_slice<DPT, TPR>(s[c], sg + (i + c) * D, h, dv_acc);
        axpy_slice<DPT, TPR>(dp[c], sq + (i + c) * D, h, dk_acc);
      }
    }
  }
  if (live) {
    store_slice<DPT, TPR>(dk_acc, 1.f, h, dk + k_row);
    store_slice<DPT, TPR>(dv_acc, 1.f, h, dv + k_row);
  }
}

// ---- bfloat16 inputs on the tensor cores ----

constexpr int MMA_THREADS = 128;  // 4 warps, 16 of the block's rows each
constexpr int STEP = 16;          // rows of a staged tile taken at a time
constexpr int PAD = 8;            // bf16 values (16 bytes) after a staged row
constexpr float LOG2E = 1.4426950408889634f;

// 2^x by the special-function unit (ex2.approx: relative error 2^-22). The
// kernels fold log2(e) into the logit's scale (and the lse or the running
// max), so that p is one multiply-add and this.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Starts the copies of rows [0, n) of the [*, D] bf16 rows at src into a
// staged tile of pitch D + PAD (zeros for rows [n, TILE)), 16 bytes a thread.
template <int D>
__device__ __forceinline__ void stage_async(const bf16* src, int n,
                                            bf16* dst) {
  constexpr int PER_ROW = D / 8;  // 16-byte pieces of a row
  for (int c = threadIdx.x; c < TILE * PER_ROW; c += MMA_THREADS) {
    const int r = c / PER_ROW, col = (c % PER_ROW) * 8;
    const bool live = r < n;
    copy_async<16>(dst + r * (D + PAD) + col, src + (live ? r * D + col : 0),
                   live);
  }
}

// Starts the copies of n float32 values at src into dst[0, TILE) (zeros past
// n); `first` is the thread that copies value 0.
__device__ __forceinline__ void stage_row_stats_async(const float* src, int n,
                                                      float* dst, int first) {
  const int i = static_cast<int>(threadIdx.x) - first;
  if (i >= 0 && i < TILE) copy_async<4>(dst + i, src + (i < n ? i : 0), i < n);
}

// The A fragments (16 rows x 16 dims each) of rows r0 and r0 + 8 of the
// [n_rows, D] bf16 matrix at base, read from device memory; zeros for a row
// past n_rows. tig = lane % 4.
template <int D>
__device__ __forceinline__ void load_a_fragments(const bf16* base, int r0,
                                                 int n_rows, int tig,
                                                 uint32_t (&a)[D / 16][4]) {
  const bool live[2] = {r0 < n_rows, r0 + 8 < n_rows};
  const uint32_t* row[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    row[h] = reinterpret_cast<const uint32_t*>(
        base + static_cast<long long>(live[h] ? r0 + 8 * h : 0) * D);
#pragma unroll
  for (int kb = 0; kb < D / 16; ++kb)
#pragma unroll
    for (int r = 0; r < 4; ++r)  // dims 16 kb + 8 (r / 2) + 2 tig, + 1
      a[kb][r] = live[r % 2] ? row[r % 2][8 * kb + 4 * (r / 2) + tig] : 0u;
}

// (x0, x1) as two registers of two bf16 each (x0 in the low half):
// hi = bf16(x) and lo = bf16(x - hi), so that hi + lo holds ~16 bits of x.
__device__ __forceinline__ void split(float x0, float x1, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 back = __bfloat1622float2(h);
  hi = as_register(h);
  lo = as_register(__floats2bfloat162_rn(x0 - back.x, x1 - back.y));
}

// Two 16 x 8 accumulators side by side as the hi and lo A fragments of a
// 16 x 16 operand: accumulator j holds columns 8 j + 2 tig, + 1 of rows
// grp (values 0, 1) and grp + 8 (values 2, 3), which is the A layout.
__device__ __forceinline__ void split_fragment(const float (&x)[2][4],
                                               uint32_t (&hi)[4],
                                               uint32_t (&lo)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
    split(x[r / 2][2 * (r % 2)], x[r / 2][2 * (r % 2) + 1], hi[r], lo[r]);
}

// acc[16 x D] += (hi + lo)[16 x 16] . rows[16 x D], rows being 16 staged rows
// (pitch D + PAD) taken as B through ldmatrix.trans; t_off is the lane's
// offset: row lane % 16, column 8 (lane / 16).
template <int D>
__device__ __forceinline__ void mma_over_rows(float (&acc)[D / 8][4],
                                              const uint32_t (&hi)[4],
                                              const uint32_t (&lo)[4],
                                              const bf16* rows, int t_off) {
#pragma unroll
  for (int nd = 0; nd < D / 8; nd += 2) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, rows + t_off + 8 * nd);
    mma_bf16(acc[nd], hi, b[0], b[1]);
    mma_bf16(acc[nd + 1], hi, b[2], b[3]);
    mma_bf16(acc[nd], lo, b[0], b[1]);
    mma_bf16(acc[nd + 1], lo, b[2], b[3]);
  }
}

// x[16 x 16] = a[16 x D] . rows[16 x D]^T, rows being 16 staged rows taken as
// B through ldmatrix; b_off is the lane's offset: row lane % 8 + 8 (lane /
// 16), column 8 ((lane / 8) % 2).
template <int D>
__device__ __forceinline__ void mma_over_dims(float (&x)[2][4],
                                              const uint32_t (&a)[D / 16][4],
                                              const bf16* rows, int b_off) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = 0.f;
#pragma unroll
  for (int kb = 0; kb < D / 16; ++kb) {
    uint32_t b[4];
    ldmatrix_x4(b, rows + b_off + 16 * kb);
    mma_bf16(x[0], a[kb], b[0], b[1]);
    mma_bf16(x[1], a[kb], b[2], b[3]);
  }
}

// acc (rows r0 and r0 + 8 of a [n_rows, D] matrix) as bf16, row r0 times
// mul[0] and row r0 + 8 times mul[1].
template <int D>
__device__ __forceinline__ void store_accumulator(const float (&acc)[D / 8][4],
                                                  const float (&mul)[2],
                                                  bf16* base, int r0,
                                                  int n_rows, int tig) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (r0 + 8 * h >= n_rows) continue;
    __nv_bfloat162* row = reinterpret_cast<__nv_bfloat162*>(
        base + static_cast<long long>(r0 + 8 * h) * D);
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      row[4 * nd + tig] = __floats2bfloat162_rn(acc[nd][2 * h] * mul[h],
                                                acc[nd][2 * h + 1] * mul[h]);
  }
}

// The same with one mul for both rows.
template <int D>
__device__ __forceinline__ void store_accumulator(const float (&acc)[D / 8][4],
                                                  float mul, bf16* base,
                                                  int r0, int n_rows,
                                                  int tig) {
  const float both[2] = {mul, mul};
  store_accumulator<D>(acc, both, base, r0, n_rows, tig);
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
attn_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ g,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dq,
                   int Tq, int Tk, int tiles, float scale) {
  constexpr int PITCH = D + PAD;
  extern __shared__ __align__(16) unsigned char smem[];
  // [2][TILE * PITCH] each: two stages of k and of v (mma_smem_bytes)
  bf16 (*sk)[TILE * PITCH] = reinterpret_cast<bf16 (*)[TILE * PITCH]>(smem);
  bf16 (*sv)[TILE * PITCH] = sk + 2;
  const int bh = blockIdx.x / tiles;
  const int lane = threadIdx.x % 32, grp = lane / 4, tig = lane % 4;
  // this thread's query rows: r0 and r0 + 8
  const int r0 = (blockIdx.x % tiles) * ROWS + (threadIdx.x / 32) * 16 + grp;
  const long long q_base = static_cast<long long>(bh) * Tq;
  const bf16* kb = k + static_cast<long long>(bh) * Tk * D;
  const bf16* vb = v + static_cast<long long>(bh) * Tk * D;
  const int b_off = (lane % 8 + 8 * (lane / 16)) * PITCH + 8 * ((lane / 8) % 2);
  const int t_off = (lane % 16) * PITCH + 8 * (lane / 16);

  uint32_t qa[D / 16][4], ga[D / 16][4];
  load_a_fragments<D>(q + q_base * D, r0, Tq, tig, qa);
  load_a_fragments<D>(g + q_base * D, r0, Tq, tig, ga);
  const float scale2 = scale * LOG2E;
  float row_lse2[2], row_delta[2];  // lse times log2(e)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool live = r0 + 8 * h < Tq;
    row_lse2[h] = live ? lse[q_base + r0 + 8 * h] * LOG2E : 0.f;
    row_delta[h] = live ? delta[q_base + r0 + 8 * h] : 0.f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;

  const int n_tiles = (Tk + TILE - 1) / TILE;
  stage_async<D>(kb, min(TILE, Tk), sk[0]);
  stage_async<D>(vb, min(TILE, Tk), sv[0]);
  commit_copies();
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % 2, k0 = i * TILE;
    wait_copies<0>();  // this thread's part of tile i has landed
    // every thread's part has, and every thread is done with tile i - 1
    __syncthreads();
    if (i + 1 < n_tiles) {  // tile i + 1 loads while tile i multiplies
      const int n = min(TILE, Tk - k0 - TILE);
      stage_async<D>(kb + static_cast<long long>(k0 + TILE) * D, n, sk[st ^ 1]);
      stage_async<D>(vb + static_cast<long long>(k0 + TILE) * D, n, sv[st ^ 1]);
      commit_copies();
    }
#pragma unroll
    for (int c = 0; c < TILE; c += STEP) {
      if (k0 + c >= Tk) break;  // the same for every thread
      float s[2][4], dp[2][4];
      mma_over_dims<D>(s, qa, sk[st] + c * PITCH, b_off);
      mma_over_dims<D>(dp, ga, sv[st] + c * PITCH, b_off);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // keys past Tk are masked out of p
          const int key = k0 + c + 8 * j + 2 * tig + e % 2;
          const float p =
              key < Tk ? exp2_approx(s[j][e] * scale2 - row_lse2[e / 2]) : 0.f;
          dp[j][e] = p * (dp[j][e] - row_delta[e / 2]);  // ds
        }
      uint32_t hi[4], lo[4];
      split_fragment(dp, hi, lo);
      mma_over_rows<D>(acc, hi, lo, sk[st] + c * PITCH, t_off);
    }
  }
  store_accumulator<D>(acc, scale, dq + q_base * D, r0, Tq, tig);
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
attn_dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ g,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int Tq, int Tk, int tiles,
                     float scale) {
  constexpr int PITCH = D + PAD;
  extern __shared__ __align__(16) unsigned char smem[];
  // two stages of q and of dO, [2][TILE * PITCH] each, then two stages of
  // the lse and of delta, [2][TILE] each (dkdv_mma_smem_bytes)
  bf16 (*sq)[TILE * PITCH] = reinterpret_cast<bf16 (*)[TILE * PITCH]>(smem);
  bf16 (*sg)[TILE * PITCH] = sq + 2;  // dO
  float (*s_lse)[TILE] = reinterpret_cast<float (*)[TILE]>(sg + 2);
  float (*s_delta)[TILE] = s_lse + 2;
  const int bh = blockIdx.x / tiles;
  const int lane = threadIdx.x % 32, grp = lane / 4, tig = lane % 4;
  // this thread's key rows: r0 and r0 + 8
  const int r0 = (blockIdx.x % tiles) * ROWS + (threadIdx.x / 32) * 16 + grp;
  const long long k_base = static_cast<long long>(bh) * Tk;
  const long long q_base = static_cast<long long>(bh) * Tq;
  const bf16* qb = q + q_base * D;
  const bf16* gb = g + q_base * D;
  const int b_off = (lane % 8 + 8 * (lane / 16)) * PITCH + 8 * ((lane / 8) % 2);
  const int t_off = (lane % 16) * PITCH + 8 * (lane / 16);

  const float scale2 = scale * LOG2E;
  uint32_t ka[D / 16][4], va[D / 16][4];
  load_a_fragments<D>(k + k_base * D, r0, Tk, tig, ka);
  load_a_fragments<D>(v + k_base * D, r0, Tk, tig, va);
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[nd][e] = dv_acc[nd][e] = 0.f;

  const int n_tiles = (Tq + TILE - 1) / TILE;
  auto stage_tile = [&](int q0, int st) {
    const int n = min(TILE, Tq - q0);
    stage_async<D>(qb + static_cast<long long>(q0) * D, n, sq[st]);
    stage_async<D>(gb + static_cast<long long>(q0) * D, n, sg[st]);
    stage_row_stats_async(lse + q_base + q0, n, s_lse[st], 0);
    stage_row_stats_async(delta + q_base + q0, n, s_delta[st], TILE);
  };
  stage_tile(0, 0);
  commit_copies();
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % 2, q0 = i * TILE;
    wait_copies<0>();
    __syncthreads();  // tile i has landed; tile i - 1 is consumed
    if (i + 1 < n_tiles) {
      stage_tile(q0 + TILE, st ^ 1);
      commit_copies();
    }
#pragma unroll
    for (int c = 0; c < TILE; c += STEP) {
      if (q0 + c >= Tq) break;
      // transposed: rows are this warp's keys, columns the 16 queries
      float p[2][4], ds[2][4];
      mma_over_dims<D>(p, ka, sq[st] + c * PITCH, b_off);
      mma_over_dims<D>(ds, va, sg[st] + c * PITCH, b_off);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = c + 8 * j + 2 * tig;
        const float2 l = *reinterpret_cast<const float2*>(&s_lse[st][col]);
        const float2 dl = *reinterpret_cast<const float2*>(&s_delta[st][col]);
        const float lse2[2] = {l.x * LOG2E, l.y * LOG2E};
        const float dlt[2] = {dl.x, dl.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // query rows past Tq are masked out of p
          const float pe =
              q0 + col + e % 2 < Tq
                  ? exp2_approx(p[j][e] * scale2 - lse2[e % 2])
                  : 0.f;
          p[j][e] = pe;
          ds[j][e] = pe * (ds[j][e] - dlt[e % 2]);
        }
      }
      uint32_t hi[4], lo[4];
      split_fragment(p, hi, lo);
      mma_over_rows<D>(dv_acc, hi, lo, sg[st] + c * PITCH, t_off);
      split_fragment(ds, hi, lo);
      mma_over_rows<D>(dk_acc, hi, lo, sq[st] + c * PITCH, t_off);
    }
  }
  store_accumulator<D>(dk_acc, scale, dk + k_base * D, r0, Tk, tig);
  store_accumulator<D>(dv_acc, 1.f, dv + k_base * D, r0, Tk, tig);
}

// The forward of bfloat16 inputs: a block of 4 warps owns 64 query rows, 16
// a warp, and streams the keys and values in 64-row tiles. Per tile: S = Q K^T
// for the whole tile, the rows' new running max, one rescale of acc and
// denom, then 16 keys at a time p = 2^(scale2 (s - max)) in registers,
// summed as float32 into denom and repacked as hi + lo A fragments for
// acc += P V. D = 32 and 64 (at 80 and 128, attn_fwd_wgmma_kernel below).
// At least 5 (D = 32) and 4 (D = 64) blocks on an SM: 96 and 128
// registers.
template <int D>
__global__ void __launch_bounds__(MMA_THREADS, D == 32 ? 5 : 4)
attn_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ out,
                    float* __restrict__ lse, int Tq, int Tk, int tiles,
                    float scale) {
  static_assert(D <= 64, "D = 80 and 128 take attn_fwd_wgmma_kernel");
  constexpr int PITCH = D + PAD;
  constexpr int STEPS = TILE / STEP;
  extern __shared__ __align__(16) unsigned char smem[];
  // [2][TILE * PITCH] each: two stages of k and of v (mma_smem_bytes)
  bf16 (*sk)[TILE * PITCH] = reinterpret_cast<bf16 (*)[TILE * PITCH]>(smem);
  bf16 (*sv)[TILE * PITCH] = sk + 2;
  const int bh = blockIdx.x / tiles;
  const int lane = threadIdx.x % 32, grp = lane / 4, tig = lane % 4;
  // this thread's query rows: r0 and r0 + 8
  const int r0 = (blockIdx.x % tiles) * ROWS + (threadIdx.x / 32) * 16 + grp;
  const long long q_base = static_cast<long long>(bh) * Tq;
  const bf16* kb = k + static_cast<long long>(bh) * Tk * D;
  const bf16* vb = v + static_cast<long long>(bh) * Tk * D;
  const int b_off = (lane % 8 + 8 * (lane / 16)) * PITCH + 8 * ((lane / 8) % 2);
  const int t_off = (lane % 16) * PITCH + 8 * (lane / 16);

  uint32_t qa[D / 16][4];
  load_a_fragments<D>(q + q_base * D, r0, Tq, tig, qa);
  const float scale2 = scale * LOG2E;
  // per row: the running max of the unscaled q.k, and this thread's share of
  // the denominator (its 16 of a tile's 64 keys; summed over the row's four
  // lanes at the end)
  float m[2] = {NEG, NEG}, denom[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;

  const int n_tiles = (Tk + TILE - 1) / TILE;
  stage_async<D>(kb, min(TILE, Tk), sk[0]);
  stage_async<D>(vb, min(TILE, Tk), sv[0]);
  commit_copies();
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % 2, k0 = i * TILE;
    wait_copies<0>();  // this thread's part of tile i has landed
    // every thread's part has, and every thread is done with tile i - 1
    __syncthreads();
    if (i + 1 < n_tiles) {  // tile i + 1 loads while tile i multiplies
      const int n = min(TILE, Tk - k0 - TILE);
      stage_async<D>(kb + static_cast<long long>(k0 + TILE) * D, n, sk[st ^ 1]);
      stage_async<D>(vb + static_cast<long long>(k0 + TILE) * D, n, sv[st ^ 1]);
      commit_copies();
    }
    // keys past Tk are staged as zeros and masked here (in the last tile
    // only); key k0 is real, so every row's max is a real logit
    const bool ragged = k0 + TILE > Tk;  // the same for every thread
    float s[STEPS][2][4];
    float m_new[2] = {m[0], m[1]};
#pragma unroll
    for (int c = 0; c < STEPS; ++c) {
      mma_over_dims<D>(s[c], qa, sk[st] + c * STEP * PITCH, b_off);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + c * STEP + 8 * j + 2 * tig + e % 2;
          if (ragged && key >= Tk) s[c][j][e] = NEG;
          m_new[e / 2] = fmaxf(m_new[e / 2], s[c][j][e]);
        }
    }
    float alpha[2], shift[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // over the four lanes of a row
      m_new[h] = fmaxf(m_new[h], __shfl_xor_sync(0xffffffffu, m_new[h], 1));
      m_new[h] = fmaxf(m_new[h], __shfl_xor_sync(0xffffffffu, m_new[h], 2));
      alpha[h] = exp2_approx((m[h] - m_new[h]) * scale2);
      shift[h] = m_new[h] * scale2;
      m[h] = m_new[h];
      denom[h] *= alpha[h];
    }
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nd][e] *= alpha[e / 2];
#pragma unroll
    for (int c = 0; c < STEPS; ++c) {
      if (k0 + c * STEP >= Tk) break;  // the same for every thread
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // a masked key: 2^(-1e30 scale2 - shift) = 0
          const float p = exp2_approx(fmaf(s[c][j][e], scale2, -shift[e / 2]));
          s[c][j][e] = p;
          denom[e / 2] += p;  // the float32 p, not its bf16 parts
        }
      uint32_t hi[4], lo[4];
      split_fragment(s[c], hi, lo);
      mma_over_rows<D>(acc, hi, lo, sv[st] + c * STEP * PITCH, t_off);
    }
  }
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    denom[h] += __shfl_xor_sync(0xffffffffu, denom[h], 1);
    denom[h] += __shfl_xor_sync(0xffffffffu, denom[h], 2);
    denom[h] = fmaxf(denom[h], FLOOR);
    inv[h] = 1.f / denom[h];
    if (tig == 0 && r0 + 8 * h < Tq)
      lse[q_base + r0 + 8 * h] = m[h] * scale + logf(denom[h]);
  }
  store_accumulator<D>(acc, inv, out + q_base * D, r0, Tq, tig);
}

// Dims a thread of the CUDA-core kernels owns: 32 in the forward and dq (one
// exp per row and key per thread; at D = 128, 4 threads a row, 256 a
// block), and in dk/dv, which holds four row slices (k, v and both sums)
// in registers, 16 at D <= 64 and 32 at D = 128 with one query row a step
// (CHUNK). At D = 128, 16 dims a thread made 512 threads, whose 128
// registers a thread left ptxas at 32 and 1976 bytes of spills: 750 ms at
// [128, 1600, 1600, 80] against 18 ms (probes/k3_f32_dkdv.py on an H100
// 80GB HBM3 at 700 W, PERF.md). At D = 80 all three take 20 dims a thread,
// 4 threads a row: five float4 chunks a thread, as at D = 128 eight.
template <int D>
__host__ __device__ constexpr int fwd_dpt() { return D == 80 ? 20 : 32; }
template <int D>
__host__ __device__ constexpr int dkdv_dpt() {
  return D == 80 ? 20 : D > 64 ? 32 : 16;
}

// Dynamic shared memory of each kernel, in bytes: the float32 kernels'
// tiles of the other operand (and dk/dv's lse and delta), the bf16
// kernels' two stages of two tiles (and dk/dv's lse and delta).
template <int D>
constexpr int f32_smem_bytes() { return 2 * TILE * D * 4; }
template <int D>
constexpr int f32_dkdv_smem_bytes() { return f32_smem_bytes<D>() + 2 * TILE * 4; }
template <int D>
constexpr int mma_smem_bytes() {
  return 2 * 2 * TILE * (D + PAD) * static_cast<int>(sizeof(bf16));
}
template <int D>
constexpr int dkdv_mma_smem_bytes() {
  return mma_smem_bytes<D>() + 2 * 2 * TILE * 4;
}

// The bf16 forward, dq and dk/dv at D = 80 and 128: the wgmma kernels of
// the section below (their launchers follow the tensor maps').
template <int D>
cudaError_t launch_fwd_wgmma(const void* q, const void* k, const void* v,
                             void* out, void* lse, int BH, int Tq, int Tk,
                             float scale, cudaStream_t stream);
template <int D>
cudaError_t launch_dq_wgmma(const void* q, const void* k, const void* v,
                            const void* g, const void* lse, const void* delta,
                            void* dq, int BH, int Tq, int Tk, float scale,
                            cudaStream_t stream);
template <int D>
cudaError_t launch_dkdv_wgmma(const void* q, const void* k, const void* v,
                              const void* g, const void* lse,
                              const void* delta, void* dk, void* dv, int BH,
                              int Tq, int Tk, float scale,
                              cudaStream_t stream);

int tiles_of(int rows) { return (rows + ROWS - 1) / ROWS; }

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       void* out, void* lse, int BH, int Tq, int Tk,
                       float scale, cudaStream_t stream) {
  const int tiles = tiles_of(Tq);
  if constexpr (std::is_same_v<T, bf16> && D > 64) {
    return launch_fwd_wgmma<D>(q, k, v, out, lse, BH, Tq, Tk, scale, stream);
  } else if constexpr (std::is_same_v<T, bf16>) {
    constexpr int smem = mma_smem_bytes<D>();
    const cudaError_t err = allow_smem(attn_fwd_mma_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    attn_fwd_mma_kernel<D><<<BH * tiles, MMA_THREADS, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(out),
        static_cast<float*>(lse), Tq, Tk, tiles, scale);
  } else {
    constexpr int DPT = fwd_dpt<D>(), TPR = D / DPT;
    constexpr int smem = f32_smem_bytes<D>();
    const cudaError_t err = allow_smem(attn_fwd_kernel<DPT, TPR>, smem);
    if (err != cudaSuccess) return err;
    attn_fwd_kernel<DPT, TPR><<<BH * tiles, ROWS * TPR, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out),
        static_cast<float*>(lse), Tq, Tk, tiles, scale);
  }
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* g, const void* lse, const void* delta,
                      void* dq, int BH, int Tq, int Tk, float scale,
                      cudaStream_t stream) {
  const int tiles = tiles_of(Tq);
  const float* row_lse = static_cast<const float*>(lse);
  const float* row_delta = static_cast<const float*>(delta);
  if constexpr (std::is_same_v<T, bf16> && D > 64) {
    return launch_dq_wgmma<D>(q, k, v, g, lse, delta, dq, BH, Tq, Tk, scale,
                              stream);
  } else if constexpr (std::is_same_v<T, bf16>) {
    constexpr int smem = mma_smem_bytes<D>();
    const cudaError_t err = allow_smem(attn_dq_mma_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    attn_dq_mma_kernel<D><<<BH * tiles, MMA_THREADS, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(g), row_lse,
        row_delta, static_cast<bf16*>(dq), Tq, Tk, tiles, scale);
  } else {
    constexpr int DPT = fwd_dpt<D>(), TPR = D / DPT;
    constexpr int smem = f32_smem_bytes<D>();
    const cudaError_t err = allow_smem(attn_dq_kernel<DPT, TPR>, smem);
    if (err != cudaSuccess) return err;
    attn_dq_kernel<DPT, TPR><<<BH * tiles, ROWS * TPR, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(g), row_lse,
        row_delta, static_cast<float*>(dq), Tq, Tk, tiles, scale);
  }
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkdv(const void* q, const void* k, const void* v,
                        const void* g, const void* lse, const void* delta,
                        void* dk, void* dv, int BH, int Tq, int Tk,
                        float scale, cudaStream_t stream) {
  const int tiles = tiles_of(Tk);
  const float* row_lse = static_cast<const float*>(lse);
  const float* row_delta = static_cast<const float*>(delta);
  if constexpr (std::is_same_v<T, bf16> && D > 64) {
    return launch_dkdv_wgmma<D>(q, k, v, g, lse, delta, dk, dv, BH, Tq, Tk,
                                scale, stream);
  } else if constexpr (std::is_same_v<T, bf16>) {
    constexpr int smem = dkdv_mma_smem_bytes<D>();
    const cudaError_t err = allow_smem(attn_dkdv_mma_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    attn_dkdv_mma_kernel<D><<<BH * tiles, MMA_THREADS, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(g), row_lse,
        row_delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), Tq, Tk,
        tiles, scale);
  } else {
    constexpr int DPT = dkdv_dpt<D>(), TPR = D / DPT;
    constexpr int smem = f32_dkdv_smem_bytes<D>();
    const cudaError_t err = allow_smem(attn_dkdv_kernel<DPT, TPR>, smem);
    if (err != cudaSuccess) return err;
    attn_dkdv_kernel<DPT, TPR><<<BH * tiles, ROWS * TPR, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(g), row_lse,
        row_delta, static_cast<float*>(dk), static_cast<float*>(dv), Tq, Tk,
        tiles, scale);
  }
  return cudaGetLastError();
}

// ---- head dims over 128, in 128-wide chunks ----
//
// D = 128 nc (nc >= 2; the wrapper pads any D over 128 up to that, as the
// TPU kernel pads D to its 128 lanes): a grid axis runs over the nc chunks
// of the output (blockIdx.y), and each block owns its rows' 128-wide chunk
// oc of out, dq, dk or dv. Every block computes the logits (and dP) in
// full, summed over the nc chunks of the head dim in order, one staged
// 128-wide chunk of each operand at a time, so the blocks of a row group
// compute the same p and ds, bit for bit, and each its chunk's share of the
// second products; the lse is written by the blocks of chunk 0.
// Accumulators stay at D = 128's size at any D; the logits are computed nc
// times, the price of that. float32 takes these kernels at every nc; bf16
// only past RESIDENT_MAX_NC chunks (D >= 512): at D = 256 and 384 the
// forward, dq and dk/dv take the resident kernels of the sections below,
// which compute the logits once a tile.
//   - tensor cores (bf16): a unit of the pipeline is one chunk c of one
//     tile of the streamed operand. It stages chunk c of the block's own
//     rows (q, or q and dO, or k and v) and of the tile's rows (k, or k and
//     v, or q and dO), two deep with cp.async as at D <= 128, and adds
//     their products into S (and dP), A and B fragments both read with
//     ldmatrix; the last chunk's unit also stages the tile's chunk oc of
//     the second product's operand (v, k, or q and dO) and runs the softmax
//     and the second products as the D <= 128 kernels do. Shared memory:
//     104 KB (the forward, 2 blocks an SM), 174 KB (dq) and 141 KB (dk/dv,
//     which takes 32 queries a tile so that its p and ds over a tile fit
//     beside its two accumulators), one block an SM;
//   - CUDA cores (float32): 4 threads a row as at D = 128, 32 dims a thread
//     of the output chunk, 16 rows of the streamed operand a unit; a
//     thread streams its 32 dims of its block row from device memory (L1 or
//     L2) 4 at a time against the staged rows, so no row slice is held in
//     registers.

constexpr int CD = 128;               // dims of a chunk
constexpr int WPITCH = CD + PAD;      // bf16 values of a staged chunk row
constexpr int WUNIT = TILE * WPITCH;  // one staged [64 x 128] bf16 chunk
constexpr int DKDV_WTILE = 32;        // queries a tile of the wide dk/dv
constexpr int F32_UNIT = 16;          // streamed rows a unit (float32)

// Starts the copies of rows [0, n) of a 128-column chunk of the rows
// `stride` values apart at src into a staged chunk of pitch WPITCH (zeros
// for rows [n, NROWS)), 16 bytes a thread.
template <int NROWS>
__device__ __forceinline__ void stage_chunk_async(const bf16* src,
                                                  long long stride, int n,
                                                  bf16* dst) {
  constexpr int PER_ROW = CD / 8;
  for (int c = threadIdx.x; c < NROWS * PER_ROW; c += MMA_THREADS) {
    const int r = c / PER_ROW, col = (c % PER_ROW) * 8;
    const bool live = r < n;
    copy_async<16>(dst + r * WPITCH + col, src + (live ? r * stride + col : 0),
                   live);
  }
}

// x[16 x 16] += a_rows[16 x 128] . rows[16 x 128]^T, both staged chunks:
// A fragments through ldmatrix at a_off (row lane % 16, column 8 (lane /
// 16), which gives registers 0..3 the rows grp, grp + 8 at columns 2 tig
// and 8 + 2 tig, the A layout), B at b_off; mma_over_dims with a's rows
// staged, adding to x.
__device__ __forceinline__ void mma_add_chunk(float (&x)[2][4],
                                              const bf16* a_rows, int a_off,
                                              const bf16* rows, int b_off) {
#pragma unroll
  for (int kb = 0; kb < CD / 16; ++kb) {
    uint32_t a[4], b[4];
    ldmatrix_x4(a, a_rows + a_off + 16 * kb);
    ldmatrix_x4(b, rows + b_off + 16 * kb);
    mma_bf16(x[0], a, b[0], b[1]);
    mma_bf16(x[1], a, b[2], b[3]);
  }
}

template <int N>
__device__ __forceinline__ void zero_fragments(float (&x)[N][2][4]) {
#pragma unroll
  for (int c = 0; c < N; ++c)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[c][j][e] = 0.f;
}

__device__ __forceinline__ void zero_accumulator(float (&acc)[CD / 8][4]) {
#pragma unroll
  for (int nd = 0; nd < CD / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;
}

// acc (rows r0 and r0 + 8 of an 8 N-wide slice of columns: a 128-wide
// chunk, N = 16, or half the head dim) as bf16 into rows `stride` values
// apart at base, row r0 times mul[0] and row r0 + 8 times mul[1].
template <int N>
__device__ __forceinline__ void store_chunk(const float (&acc)[N][4],
                                            const float (&mul)[2], bf16* base,
                                            long long stride, int r0,
                                            int n_rows, int tig) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (r0 + 8 * h >= n_rows) continue;
    __nv_bfloat162* row =
        reinterpret_cast<__nv_bfloat162*>(base + (r0 + 8 * h) * stride);
#pragma unroll
    for (int nd = 0; nd < N; ++nd)
      row[4 * nd + tig] = __floats2bfloat162_rn(acc[nd][2 * h] * mul[h],
                                                acc[nd][2 * h + 1] * mul[h]);
  }
}

// The forward at D = 128 nc (the chunked route, nc > RESIDENT_MAX_NC). A
// stage's slots: q, k, v (wide_smem_bytes).
__global__ void __launch_bounds__(MMA_THREADS, 2)
attn_fwd_wide_chunked_mma_kernel(const bf16* __restrict__ q,
                                 const bf16* __restrict__ k,
                                 const bf16* __restrict__ v,
                                 bf16* __restrict__ out,
                                 float* __restrict__ lse, int Tq, int Tk,
                                 int tiles, int nc, float scale) {
  constexpr int STEPS = TILE / STEP;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* slots = reinterpret_cast<bf16*>(smem);  // [2][3][WUNIT]
  const long long Dp = static_cast<long long>(nc) * CD;
  const int oc = blockIdx.y;
  const int bh = blockIdx.x / tiles;
  const int lane = threadIdx.x % 32, grp = lane / 4, tig = lane % 4;
  const int first = (blockIdx.x % tiles) * ROWS;
  const int warp_row = (threadIdx.x / 32) * 16;
  const int r0 = first + warp_row + grp;  // this thread's rows r0, r0 + 8
  const long long q_base = static_cast<long long>(bh) * Tq;
  const bf16* qb = q + (q_base + first) * Dp;
  const bf16* kb = k + static_cast<long long>(bh) * Tk * Dp;
  const bf16* vb = v + static_cast<long long>(bh) * Tk * Dp + oc * CD;
  const int b_off = (lane % 8 + 8 * (lane / 16)) * WPITCH + 8 * ((lane / 8) % 2);
  const int t_off = (lane % 16) * WPITCH + 8 * (lane / 16);
  const int nq = min(ROWS, Tq - first);
  auto slot = [&](int st, int which) {
    return slots + (3 * st + which) * WUNIT;
  };
  const int units = (Tk + TILE - 1) / TILE * nc;
  auto stage_unit = [&](int u) {
    const int c = u % nc, k0 = u / nc * TILE, n = min(TILE, Tk - k0);
    stage_chunk_async<TILE>(qb + c * CD, Dp, nq, slot(u % 2, 0));
    stage_chunk_async<TILE>(kb + k0 * Dp + c * CD, Dp, n, slot(u % 2, 1));
    if (c == nc - 1)
      stage_chunk_async<TILE>(vb + k0 * Dp, Dp, n, slot(u % 2, 2));
  };

  const float scale2 = scale * LOG2E;
  float m[2] = {NEG, NEG}, denom[2] = {0.f, 0.f};
  float acc[CD / 8][4];
  zero_accumulator(acc);
  float s[STEPS][2][4];
  stage_unit(0);
  commit_copies();
  for (int u = 0; u < units; ++u) {
    const int st = u % 2, c = u % nc, k0 = u / nc * TILE;
    wait_copies<0>();
    __syncthreads();  // unit u has landed; unit u - 1 is consumed
    if (u + 1 < units) {
      stage_unit(u + 1);
      commit_copies();
    }
    if (c == 0) zero_fragments(s);
#pragma unroll
    for (int cs = 0; cs < STEPS; ++cs)
      mma_add_chunk(s[cs], slot(st, 0) + warp_row * WPITCH, t_off,
                    slot(st, 1) + cs * STEP * WPITCH, b_off);
    if (c < nc - 1) continue;  // the same for every thread

    // the tile's logits are whole: the D <= 128 kernel's softmax step
    const bool ragged = k0 + TILE > Tk;
    float m_new[2] = {m[0], m[1]};
#pragma unroll
    for (int cs = 0; cs < STEPS; ++cs)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + cs * STEP + 8 * j + 2 * tig + e % 2;
          if (ragged && key >= Tk) s[cs][j][e] = NEG;
          m_new[e / 2] = fmaxf(m_new[e / 2], s[cs][j][e]);
        }
    float alpha[2], shift[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m_new[h] = fmaxf(m_new[h], __shfl_xor_sync(0xffffffffu, m_new[h], 1));
      m_new[h] = fmaxf(m_new[h], __shfl_xor_sync(0xffffffffu, m_new[h], 2));
      alpha[h] = exp2_approx((m[h] - m_new[h]) * scale2);
      shift[h] = m_new[h] * scale2;
      m[h] = m_new[h];
      denom[h] *= alpha[h];
    }
#pragma unroll
    for (int nd = 0; nd < CD / 8; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nd][e] *= alpha[e / 2];
#pragma unroll
    for (int cs = 0; cs < STEPS; ++cs) {
      if (k0 + cs * STEP >= Tk) break;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p =
              exp2_approx(fmaf(s[cs][j][e], scale2, -shift[e / 2]));
          s[cs][j][e] = p;
          denom[e / 2] += p;
        }
      uint32_t hi[4], lo[4];
      split_fragment(s[cs], hi, lo);
      mma_over_rows<CD>(acc, hi, lo, slot(st, 2) + cs * STEP * WPITCH, t_off);
    }
  }
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    denom[h] += __shfl_xor_sync(0xffffffffu, denom[h], 1);
    denom[h] += __shfl_xor_sync(0xffffffffu, denom[h], 2);
    denom[h] = fmaxf(denom[h], FLOOR);
    inv[h] = 1.f / denom[h];
    if (oc == 0 && tig == 0 && r0 + 8 * h < Tq)
      lse[q_base + r0 + 8 * h] = m[h] * scale + logf(denom[h]);
  }
  store_chunk(acc, inv, out + q_base * Dp + oc * CD, Dp, r0, Tq, tig);
}

// dq at D = 128 nc (the chunked route, nc >= 4). A stage's slots: q, dO, k,
// v, and the tile's k of chunk oc (wide_smem_bytes).
__global__ void __launch_bounds__(MMA_THREADS)
attn_dq_wide_chunked_mma_kernel(const bf16* __restrict__ q,
                                const bf16* __restrict__ k,
                                const bf16* __restrict__ v,
                                const bf16* __restrict__ g,
                                const float* __restrict__ lse,
                                const float* __restrict__ delta,
                                bf16* __restrict__ dq, int Tq, int Tk,
                                int tiles, int nc, float scale) {
  constexpr int STEPS = TILE / STEP;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* slots = reinterpret_cast<bf16*>(smem);  // [2][5][WUNIT]
  const long long Dp = static_cast<long long>(nc) * CD;
  const int oc = blockIdx.y;
  const int bh = blockIdx.x / tiles;
  const int lane = threadIdx.x % 32, grp = lane / 4, tig = lane % 4;
  const int first = (blockIdx.x % tiles) * ROWS;
  const int warp_row = (threadIdx.x / 32) * 16;
  const int r0 = first + warp_row + grp;
  const long long q_base = static_cast<long long>(bh) * Tq;
  const bf16* qb = q + (q_base + first) * Dp;
  const bf16* gb = g + (q_base + first) * Dp;
  const bf16* kb = k + static_cast<long long>(bh) * Tk * Dp;
  const bf16* vb = v + static_cast<long long>(bh) * Tk * Dp;
  const int b_off = (lane % 8 + 8 * (lane / 16)) * WPITCH + 8 * ((lane / 8) % 2);
  const int t_off = (lane % 16) * WPITCH + 8 * (lane / 16);
  const int nq = min(ROWS, Tq - first);
  auto slot = [&](int st, int which) {
    return slots + (5 * st + which) * WUNIT;
  };
  const int units = (Tk + TILE - 1) / TILE * nc;
  auto stage_unit = [&](int u) {
    const int c = u % nc, k0 = u / nc * TILE, n = min(TILE, Tk - k0);
    const int st = u % 2;
    stage_chunk_async<TILE>(qb + c * CD, Dp, nq, slot(st, 0));
    stage_chunk_async<TILE>(gb + c * CD, Dp, nq, slot(st, 1));
    stage_chunk_async<TILE>(kb + k0 * Dp + c * CD, Dp, n, slot(st, 2));
    stage_chunk_async<TILE>(vb + k0 * Dp + c * CD, Dp, n, slot(st, 3));
    if (c == nc - 1)
      stage_chunk_async<TILE>(kb + k0 * Dp + oc * CD, Dp, n, slot(st, 4));
  };

  const float scale2 = scale * LOG2E;
  float row_lse2[2], row_delta[2];  // lse times log2(e)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool live = r0 + 8 * h < Tq;
    row_lse2[h] = live ? lse[q_base + r0 + 8 * h] * LOG2E : 0.f;
    row_delta[h] = live ? delta[q_base + r0 + 8 * h] : 0.f;
  }
  float acc[CD / 8][4];
  zero_accumulator(acc);
  float s[STEPS][2][4], dp[STEPS][2][4];
  stage_unit(0);
  commit_copies();
  for (int u = 0; u < units; ++u) {
    const int st = u % 2, c = u % nc, k0 = u / nc * TILE;
    wait_copies<0>();
    __syncthreads();
    if (u + 1 < units) {
      stage_unit(u + 1);
      commit_copies();
    }
    if (c == 0) {
      zero_fragments(s);
      zero_fragments(dp);
    }
#pragma unroll
    for (int cs = 0; cs < STEPS; ++cs) {
      mma_add_chunk(s[cs], slot(st, 0) + warp_row * WPITCH, t_off,
                    slot(st, 2) + cs * STEP * WPITCH, b_off);
      mma_add_chunk(dp[cs], slot(st, 1) + warp_row * WPITCH, t_off,
                    slot(st, 3) + cs * STEP * WPITCH, b_off);
    }
    if (c < nc - 1) continue;
#pragma unroll
    for (int cs = 0; cs < STEPS; ++cs) {
      if (k0 + cs * STEP >= Tk) break;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // keys past Tk are masked out of p
          const int key = k0 + cs * STEP + 8 * j + 2 * tig + e % 2;
          const float p =
              key < Tk ? exp2_approx(s[cs][j][e] * scale2 - row_lse2[e / 2])
                       : 0.f;
          dp[cs][j][e] = p * (dp[cs][j][e] - row_delta[e / 2]);  // ds
        }
      uint32_t hi[4], lo[4];
      split_fragment(dp[cs], hi, lo);
      mma_over_rows<CD>(acc, hi, lo, slot(st, 4) + cs * STEP * WPITCH, t_off);
    }
  }
  const float mul[2] = {scale, scale};
  store_chunk(acc, mul, dq + q_base * Dp + oc * CD, Dp, r0, Tq, tig);
}

// dk and dv at D = 128 nc (the chunked route, nc >= 4), 32 queries a tile.
// A stage's slots: the block's k and v rows (64 each), the tile's q and dO
// rows (32 each), the tile's q and dO of chunk oc (32 each); then the
// stages' lse and delta (wide_dkdv_smem_bytes).
__global__ void __launch_bounds__(MMA_THREADS)
attn_dkdv_wide_chunked_mma_kernel(const bf16* __restrict__ q,
                                  const bf16* __restrict__ k,
                                  const bf16* __restrict__ v,
                                  const bf16* __restrict__ g,
                                  const float* __restrict__ lse,
                                  const float* __restrict__ delta,
                                  bf16* __restrict__ dk, bf16* __restrict__ dv,
                                  int Tq, int Tk, int tiles, int nc,
                                  float scale) {
  constexpr int QT = DKDV_WTILE;
  constexpr int STEPS = QT / STEP;
  constexpr int HALF = QT * WPITCH;            // a staged [32 x 128] chunk
  constexpr int STAGE = 2 * WUNIT + 4 * HALF;  // bf16 values of a stage
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* slots = reinterpret_cast<bf16*>(smem);                 // [2][STAGE]
  float* stats = reinterpret_cast<float*>(slots + 2 * STAGE);  // [2][2][QT]
  const long long Dp = static_cast<long long>(nc) * CD;
  const int oc = blockIdx.y;
  const int bh = blockIdx.x / tiles;
  const int lane = threadIdx.x % 32, grp = lane / 4, tig = lane % 4;
  const int first = (blockIdx.x % tiles) * ROWS;
  const int warp_row = (threadIdx.x / 32) * 16;
  const int r0 = first + warp_row + grp;  // this thread's keys r0, r0 + 8
  const long long k_base = static_cast<long long>(bh) * Tk;
  const long long q_base = static_cast<long long>(bh) * Tq;
  const bf16* kb = k + (k_base + first) * Dp;
  const bf16* vb = v + (k_base + first) * Dp;
  const bf16* qb = q + q_base * Dp;
  const bf16* gb = g + q_base * Dp;
  const int b_off = (lane % 8 + 8 * (lane / 16)) * WPITCH + 8 * ((lane / 8) % 2);
  const int t_off = (lane % 16) * WPITCH + 8 * (lane / 16);
  const int nk = min(ROWS, Tk - first);
  // slots 0, 1: k, v [64 rows]; 2, 3: q, dO [32]; 4, 5: q, dO of chunk oc
  auto slot = [&](int st, int which) {
    return slots + st * STAGE +
           (which < 2 ? which * WUNIT : 2 * WUNIT + (which - 2) * HALF);
  };
  auto stats_of = [&](int st) { return stats + 2 * QT * st; };
  const int units = (Tq + QT - 1) / QT * nc;
  auto stage_unit = [&](int u) {
    const int c = u % nc, q0 = u / nc * QT, n = min(QT, Tq - q0);
    const int st = u % 2;
    stage_chunk_async<TILE>(kb + c * CD, Dp, nk, slot(st, 0));
    stage_chunk_async<TILE>(vb + c * CD, Dp, nk, slot(st, 1));
    stage_chunk_async<QT>(qb + q0 * Dp + c * CD, Dp, n, slot(st, 2));
    stage_chunk_async<QT>(gb + q0 * Dp + c * CD, Dp, n, slot(st, 3));
    if (c == nc - 1) {
      stage_chunk_async<QT>(qb + q0 * Dp + oc * CD, Dp, n, slot(st, 4));
      stage_chunk_async<QT>(gb + q0 * Dp + oc * CD, Dp, n, slot(st, 5));
      if (threadIdx.x < 2 * QT) {  // [lse QT][delta QT]
        const int i = threadIdx.x % QT;
        const float* src = (threadIdx.x < QT ? lse : delta) + q_base + q0;
        copy_async<4>(stats_of(st) + threadIdx.x, src + (i < n ? i : 0),
                      i < n);
      }
    }
  };

  const float scale2 = scale * LOG2E;
  float dk_acc[CD / 8][4], dv_acc[CD / 8][4];
  zero_accumulator(dk_acc);
  zero_accumulator(dv_acc);
  float p[STEPS][2][4], ds[STEPS][2][4];
  stage_unit(0);
  commit_copies();
  for (int u = 0; u < units; ++u) {
    const int st = u % 2, c = u % nc, q0 = u / nc * QT;
    wait_copies<0>();
    __syncthreads();
    if (u + 1 < units) {
      stage_unit(u + 1);
      commit_copies();
    }
    if (c == 0) {
      zero_fragments(p);
      zero_fragments(ds);
    }
    // transposed: rows are this warp's keys, columns 16 queries a step
#pragma unroll
    for (int cs = 0; cs < STEPS; ++cs) {
      mma_add_chunk(p[cs], slot(st, 0) + warp_row * WPITCH, t_off,
                    slot(st, 2) + cs * STEP * WPITCH, b_off);
      mma_add_chunk(ds[cs], slot(st, 1) + warp_row * WPITCH, t_off,
                    slot(st, 3) + cs * STEP * WPITCH, b_off);
    }
    if (c < nc - 1) continue;
    const float* l_row = stats_of(st);
    const float* d_row = l_row + QT;
#pragma unroll
    for (int cs = 0; cs < STEPS; ++cs) {
      if (q0 + cs * STEP >= Tq) break;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = cs * STEP + 8 * j + 2 * tig;
        const float2 l = *reinterpret_cast<const float2*>(l_row + col);
        const float2 dl = *reinterpret_cast<const float2*>(d_row + col);
        const float lse2[2] = {l.x * LOG2E, l.y * LOG2E};
        const float dlt[2] = {dl.x, dl.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // query rows past Tq are masked out of p
          const float pe = q0 + col + e % 2 < Tq
                               ? exp2_approx(p[cs][j][e] * scale2 - lse2[e % 2])
                               : 0.f;
          p[cs][j][e] = pe;
          ds[cs][j][e] = pe * (ds[cs][j][e] - dlt[e % 2]);
        }
      }
      uint32_t hi[4], lo[4];
      split_fragment(p[cs], hi, lo);
      mma_over_rows<CD>(dv_acc, hi, lo, slot(st, 5) + cs * STEP * WPITCH,
                        t_off);
      split_fragment(ds[cs], hi, lo);
      mma_over_rows<CD>(dk_acc, hi, lo, slot(st, 4) + cs * STEP * WPITCH,
                        t_off);
    }
  }
  const float dk_mul[2] = {scale, scale}, dv_mul[2] = {1.f, 1.f};
  store_chunk(dk_acc, dk_mul, dk + k_base * Dp + oc * CD, Dp, r0, Tk, tig);
  store_chunk(dv_acc, dv_mul, dv + k_base * Dp + oc * CD, Dp, r0, Tk, tig);
}

// ---- D = 256 and 384 on the tensor cores: the block's rows resident ----
//
// The chunked dq and dk/dv above recompute S and dP once for each 128-wide
// chunk of the output (twice at D = 256), stage the block's own rows
// again from L2 for every unit (44% of dq's ~5.8 GB of L2 reads at
// [32, 1600, 1600, 256]), and fit one block of 4 warps on an SM (174 and
// 141 KB of shared memory): 4.7 and 5.8% of their bounds (PERF.md). Up to
// RESIDENT_MAX_NC chunks (D = 384), the kernels below instead own all D of
// their 64 rows' output:
//   - 8 warps, 16 rows a pair: warp w < 4 computes S (dq: q . k^T; dk/dv
//     transposed, k . q^T) and p for rows 16 w .. 16 w + 15, warp w + 4 dP
//     (dO . v^T; v . dO^T) for the same rows, each over the whole head
//     dim, 16 dims a step in order: the chunked kernels' order (chunk 0's
//     steps, then chunk 1's, into one fragment), so S and dP are the same
//     bits, computed once a tile instead of D / 128 times;
//   - the block's own rows (q and dO; k and v) are staged once, at
//     pitch D + PAD, and stay resident in shared memory; only the
//     streamed operand is staged, in tiles of RTILE = 32 rows two deep
//     with cp.async, at full D. Shared memory: 2 64-row and 4 32-row
//     slots, 256 (D + PAD) bf16 values, and the exchange below: 151,552
//     and 217,088 bytes for dq at D = 256 and 384, 143,872 and 209,408
//     for dk/dv, one block an SM (8 warps, against 4);
//   - the exchange: each warp writes its float32 fragments (p from the S
//     warps; dq's dP warps their dP) to shared memory lane by lane, and
//     after one barrier reads its partner's. dq: both warps of a pair
//     form the same ds = p (dP - delta) and each takes half of dq's D
//     (D / 4 accumulators a thread). dk/dv: the S warp keeps p and sums
//     dv, the dP warp reads p, forms ds and sums dk, each over all D (D / 2
//     accumulators a thread; split by D halves instead, each warp would
//     hold the same count and p and ds both, hi and lo);
//   - the second products are the chunked kernels' (mma_over_rows, hi then
//     lo for each 16-row step in order, the scale on dq and dk at the
//     end), so dq, dk and dv equal theirs bit for bit;
//   - what bounds them on this card: every 16 x 16 A fragment and 16 x 16
//     B pair is one ldmatrix.x4 (512 bytes of the SM's 128 bytes a clock)
//     for two mma.sync in the first products, so shared-memory reads, not
//     the tensor cores, set the pace there; each A fragment is read once
//     for both 16-row steps of a tile (mma_tile_over_dims). The tensor
//     cores still run the split's lo halves (dq 8, dk/dv 12 passes a
//     16 x 16 x D tile pair against the 6 and 8 of the bound's count).

constexpr int RES_WARPS = 8;
constexpr int RES_THREADS = 32 * RES_WARPS;
constexpr int RTILE = 32;             // rows of a streamed tile
constexpr int RSTEPS = RTILE / STEP;  // its 16-row steps
constexpr int RESIDENT_MAX_NC = 3;    // D = 256 and 384; past it, chunked
// float32 values a warp puts into the exchange a tile: its fragments of
// every step, value and lane
constexpr int XWARP = RSTEPS * 2 * 4 * 32;

// Starts the copies of rows [0, n) of the [*, D] bf16 rows at src into
// NROWS staged rows of pitch D + PAD (zeros for rows [n, NROWS)), 16 bytes
// a thread of the RES_THREADS.
template <int D, int NROWS>
__device__ __forceinline__ void stage_rows_async(const bf16* src, int n,
                                                 bf16* dst) {
  constexpr int PER_ROW = D / 8;
  for (int c = threadIdx.x; c < NROWS * PER_ROW; c += RES_THREADS) {
    const int r = c / PER_ROW, col = (c % PER_ROW) * 8;
    const bool live = r < n;
    copy_async<16>(dst + r * (D + PAD) + col, src + (live ? r * D + col : 0),
                   live);
  }
}

// x[cs] = a_rows[16 x D] . (rows 16 cs .. 16 cs + 15 of a staged tile)^T
// for each step cs of the tile: over the head dim 16 dims a step in order,
// as mma_add_chunk sums chunk after chunk, each A fragment read once for
// all the steps. Offsets as mma_add_chunk's, at pitch D + PAD.
template <int D>
__device__ __forceinline__ void mma_tile_over_dims(float (&x)[RSTEPS][2][4],
                                                   const bf16* a_rows,
                                                   int a_off,
                                                   const bf16* rows,
                                                   int b_off) {
  zero_fragments(x);
#pragma unroll
  for (int kb = 0; kb < D / 16; ++kb) {
    uint32_t a[4];
    ldmatrix_x4(a, a_rows + a_off + 16 * kb);
#pragma unroll
    for (int cs = 0; cs < RSTEPS; ++cs) {
      uint32_t b[4];
      ldmatrix_x4(b, rows + cs * STEP * (D + PAD) + b_off + 16 * kb);
      mma_bf16(x[cs][0], a, b[0], b[1]);
      mma_bf16(x[cs][1], a, b[2], b[3]);
    }
  }
}

// A warp's fragments into the exchange, value by value, lane beside lane.
__device__ __forceinline__ void put_fragments(const float (&x)[RSTEPS][2][4],
                                              float* to, int lane) {
#pragma unroll
  for (int cs = 0; cs < RSTEPS; ++cs)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        to[((cs * 2 + j) * 4 + e) * 32 + lane] = x[cs][j][e];
}

// Value e of accumulator j of step cs that `put_fragments` wrote for lane.
__device__ __forceinline__ float fragment_value(const float* from, int cs,
                                                int j, int e, int lane) {
  return from[((cs * 2 + j) * 4 + e) * 32 + lane];
}

// Dynamic shared memory of the resident kernels: the block's 64 rows of
// two operands, two stages of 32 rows of two others, then dk/dv's two
// stages of the lse and delta and the exchange (dq: all 8 warps'; dk/dv:
// the S warps' p).
template <int NC>
__host__ __device__ constexpr int resident_smem_bytes(bool dkdv) {
  return (2 * ROWS + 2 * 2 * RTILE) * (NC * CD + PAD) *
             static_cast<int>(sizeof(bf16)) +
         (dkdv ? 2 * 2 * RTILE * 4 + 4 * XWARP * 4 : 8 * XWARP * 4);
}

// dq at D = 128 NC, NC <= RESIDENT_MAX_NC: a block of 8 warps owns 64
// query rows and all D of their dq, and streams the keys' k and v.
template <int NC>
__global__ void __launch_bounds__(RES_THREADS, 1)
attn_dq_wide_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ g,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        bf16* __restrict__ dq, int Tq, int Tk, int tiles,
                        float scale) {
  constexpr int D = NC * CD, PITCH = D + PAD, HALF = D / 2;
  constexpr int OWN = ROWS * PITCH, STREAM = RTILE * PITCH;
  extern __shared__ __align__(16) unsigned char smem[];
  // the block's q and dO rows [OWN] each, two stages of k and of v
  // [2][STREAM] each, the exchange [8][XWARP] (resident_smem_bytes)
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sg = sq + OWN;
  bf16* sk = sg + OWN;
  bf16* sv = sk + 2 * STREAM;
  float* exchange = reinterpret_cast<float*>(sv + 2 * STREAM);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane / 4, tig = lane % 4;
  // role 0 (warps 0-3): S and p; role 1 (warps 4-7): dP. Warps w and w ^ 4
  // share rows 16 (w % 4) .. + 15; each sums half of their dq, columns
  // role HALF .. + HALF - 1
  const int role = warp / 4, warp_row = (warp % 4) * STEP;
  const int bh = blockIdx.x / tiles;
  const int first = (blockIdx.x % tiles) * ROWS;
  const int r0 = first + warp_row + grp;  // this thread's rows r0, r0 + 8
  const long long q_base = static_cast<long long>(bh) * Tq;
  const bf16* kb = k + static_cast<long long>(bh) * Tk * D;
  const bf16* vb = v + static_cast<long long>(bh) * Tk * D;
  const int b_off = (lane % 8 + 8 * (lane / 16)) * PITCH + 8 * ((lane / 8) % 2);
  const int t_off = (lane % 16) * PITCH + 8 * (lane / 16);

  // the block's rows, past Tq as zeros; landed by the first tile's wait
  const int nq = min(ROWS, Tq - first);
  stage_rows_async<D, ROWS>(q + (q_base + first) * D, nq, sq);
  stage_rows_async<D, ROWS>(g + (q_base + first) * D, nq, sg);
  const float scale2 = scale * LOG2E;
  float row_lse2[2], row_delta[2];  // lse times log2(e)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool live = r0 + 8 * h < Tq;
    row_lse2[h] = live ? lse[q_base + r0 + 8 * h] * LOG2E : 0.f;
    row_delta[h] = live ? delta[q_base + r0 + 8 * h] : 0.f;
  }
  float acc[HALF / 8][4];
#pragma unroll
  for (int nd = 0; nd < HALF / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;

  const int n_tiles = (Tk + RTILE - 1) / RTILE;
  auto stage_tile = [&](int k0, int st) {
    const int n = min(RTILE, Tk - k0);
    stage_rows_async<D, RTILE>(kb + static_cast<long long>(k0) * D, n,
                               sk + st * STREAM);
    stage_rows_async<D, RTILE>(vb + static_cast<long long>(k0) * D, n,
                               sv + st * STREAM);
  };
  stage_tile(0, 0);
  commit_copies();
  const bf16* a_rows = (role ? sg : sq) + warp_row * PITCH;
  float* mine = exchange + warp * XWARP;
  const float* theirs = exchange + (warp ^ 4) * XWARP;
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % 2, k0 = i * RTILE;
    wait_copies<0>();
    // tile i has landed; tile i - 1 and the exchange are consumed
    __syncthreads();
    if (i + 1 < n_tiles) {
      stage_tile(k0 + RTILE, st ^ 1);
      commit_copies();
    }
    const bf16* tile_k = sk + st * STREAM;
    float x[RSTEPS][2][4];  // S (role 0, then p) or dP (role 1)
    mma_tile_over_dims<D>(x, a_rows, t_off, role ? sv + st * STREAM : tile_k,
                          b_off);
    if (role == 0) {
#pragma unroll
      for (int cs = 0; cs < RSTEPS; ++cs)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            // keys past Tk are masked out of p
            const int key = k0 + cs * STEP + 8 * j + 2 * tig + e % 2;
            x[cs][j][e] = key < Tk ? exp2_approx(x[cs][j][e] * scale2 -
                                                 row_lse2[e / 2])
                                   : 0.f;
          }
    }
    put_fragments(x, mine, lane);
    __syncthreads();  // every pair's p and dP are in the exchange
#pragma unroll
    for (int cs = 0; cs < RSTEPS; ++cs) {
      if (k0 + cs * STEP >= Tk) break;  // the same for every thread
      float ds[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float y = fragment_value(theirs, cs, j, e, lane);
          const float p = role ? y : x[cs][j][e];
          const float dp = role ? x[cs][j][e] : y;
          ds[j][e] = p * (dp - row_delta[e / 2]);
        }
      uint32_t hi[4], lo[4];
      split_fragment(ds, hi, lo);
      mma_over_rows<HALF>(acc, hi, lo,
                          tile_k + cs * STEP * PITCH + role * HALF, t_off);
    }
  }
  const float mul[2] = {scale, scale};
  store_chunk(acc, mul, dq + q_base * D + role * HALF, D, r0, Tq, tig);
}

// dk and dv at D = 128 NC, NC <= RESIDENT_MAX_NC: a block of 8 warps owns
// 64 key rows and all D of their dk and dv, and streams the queries' q, dO,
// lse and delta.
template <int NC>
__global__ void __launch_bounds__(RES_THREADS, 1)
attn_dkdv_wide_mma_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const bf16* __restrict__ g,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv,
                          int Tq, int Tk, int tiles, float scale) {
  constexpr int D = NC * CD, PITCH = D + PAD;
  constexpr int OWN = ROWS * PITCH, STREAM = RTILE * PITCH;
  extern __shared__ __align__(16) unsigned char smem[];
  // the block's k and v rows [OWN] each, two stages of q and of dO
  // [2][STREAM] each, two stages of [lse RTILE][delta RTILE], the exchange
  // [4][XWARP] (resident_smem_bytes)
  bf16* sk = reinterpret_cast<bf16*>(smem);
  bf16* sv = sk + OWN;
  bf16* sq = sv + OWN;
  bf16* sg = sq + 2 * STREAM;
  float* stats = reinterpret_cast<float*>(sg + 2 * STREAM);
  float* exchange = stats + 2 * 2 * RTILE;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane / 4, tig = lane % 4;
  // role 0 (warps 0-3): S^T, p and dv; role 1 (warps 4-7): dP^T, ds and
  // dk, for key rows 16 (w % 4) .. + 15, all D
  const int role = warp / 4, warp_row = (warp % 4) * STEP;
  const int bh = blockIdx.x / tiles;
  const int first = (blockIdx.x % tiles) * ROWS;
  const int r0 = first + warp_row + grp;  // this thread's keys r0, r0 + 8
  const long long k_base = static_cast<long long>(bh) * Tk;
  const long long q_base = static_cast<long long>(bh) * Tq;
  const bf16* qb = q + q_base * D;
  const bf16* gb = g + q_base * D;
  const int b_off = (lane % 8 + 8 * (lane / 16)) * PITCH + 8 * ((lane / 8) % 2);
  const int t_off = (lane % 16) * PITCH + 8 * (lane / 16);

  // the block's rows, past Tk as zeros; landed by the first tile's wait
  const int nk = min(ROWS, Tk - first);
  stage_rows_async<D, ROWS>(k + (k_base + first) * D, nk, sk);
  stage_rows_async<D, ROWS>(v + (k_base + first) * D, nk, sv);
  const float scale2 = scale * LOG2E;
  float acc[D / 8][4];  // dv (role 0) or dk (role 1)
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;

  const int n_tiles = (Tq + RTILE - 1) / RTILE;
  auto stage_tile = [&](int q0, int st) {
    const int n = min(RTILE, Tq - q0);
    stage_rows_async<D, RTILE>(qb + static_cast<long long>(q0) * D, n,
                               sq + st * STREAM);
    stage_rows_async<D, RTILE>(gb + static_cast<long long>(q0) * D, n,
                               sg + st * STREAM);
    if (threadIdx.x < 2 * RTILE) {  // [lse RTILE][delta RTILE]
      const int i = threadIdx.x % RTILE;
      const float* src = (threadIdx.x < RTILE ? lse : delta) + q_base + q0;
      copy_async<4>(stats + 2 * RTILE * st + threadIdx.x,
                    src + (i < n ? i : 0), i < n);
    }
  };
  stage_tile(0, 0);
  commit_copies();
  const bf16* a_rows = (role ? sv : sk) + warp_row * PITCH;
  float* p_of_pair = exchange + (warp % 4) * XWARP;
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % 2, q0 = i * RTILE;
    wait_copies<0>();
    // tile i has landed; tile i - 1 and the exchange are consumed
    __syncthreads();
    if (i + 1 < n_tiles) {
      stage_tile(q0 + RTILE, st ^ 1);
      commit_copies();
    }
    const bf16* tile_q = sq + st * STREAM;
    const bf16* tile_g = sg + st * STREAM;
    const float* l_row = stats + 2 * RTILE * st;
    const float* d_row = l_row + RTILE;
    // transposed: rows are this warp's keys, columns 16 queries a step
    float x[RSTEPS][2][4];  // S^T (role 0, then p) or dP^T (role 1)
    mma_tile_over_dims<D>(x, a_rows, t_off, role ? tile_g : tile_q, b_off);
    if (role == 0) {
#pragma unroll
      for (int cs = 0; cs < RSTEPS; ++cs)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = cs * STEP + 8 * j + 2 * tig;
          const float2 l = *reinterpret_cast<const float2*>(l_row + col);
          const float lse2[2] = {l.x * LOG2E, l.y * LOG2E};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            // query rows past Tq are masked out of p
            x[cs][j][e] = q0 + col + e % 2 < Tq
                              ? exp2_approx(x[cs][j][e] * scale2 - lse2[e % 2])
                              : 0.f;
        }
      put_fragments(x, p_of_pair, lane);
    }
    __syncthreads();  // every pair's p is in the exchange
#pragma unroll
    for (int cs = 0; cs < RSTEPS; ++cs) {
      if (q0 + cs * STEP >= Tq) break;  // the same for every thread
      if (role == 1) {  // ds = p (dP - delta), over x's dP
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = cs * STEP + 8 * j + 2 * tig;
          const float2 dl = *reinterpret_cast<const float2*>(d_row + col);
          const float dlt[2] = {dl.x, dl.y};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            x[cs][j][e] = fragment_value(p_of_pair, cs, j, e, lane) *
                          (x[cs][j][e] - dlt[e % 2]);
        }
      }
      uint32_t hi[4], lo[4];
      split_fragment(x[cs], hi, lo);  // p (role 0) or ds (role 1)
      mma_over_rows<D>(acc, hi, lo,
                       (role ? tile_q : tile_g) + cs * STEP * PITCH, t_off);
    }
  }
  const float mul[2] = {role ? scale : 1.f, role ? scale : 1.f};
  store_chunk(acc, mul, (role ? dk : dv) + k_base * D, D, r0, Tk, tig);
}

// ---- the bf16 forward at D = 256 and 384: wgmma, TMA, q resident ----
//
// The chunked forward above computes the logits and the whole softmax once
// for each 128-wide chunk of the output (twice at D = 256), stages the
// block's q from L2 again beside every chunk of k, and reads every A and B
// fragment of mma.sync with ldmatrix: 9.1% of its bound at
// [32, 1600, 1600, 256] (PERF.md). Up to RESIDENT_MAX_NC chunks (the
// forward's budget below fits there, as the resident dq's and dk/dv's
// does, and not at D = 512) attn_fwd_wide_mma_kernel<NC> owns all D of
// its query rows instead:
//   - two warpgroups of 4 warps. Every copy is TMA (cp.async.bulk.tensor:
//     the hardware forms the addresses, zero-fills what lies past the
//     tensor and counts the bytes into an mbarrier), issued by thread 0
//     alone: q once, k and v a 64-key tile at a time into rings of stages,
//     each stage with a full and an empty mbarrier; thread 0 refills a
//     stage once every warp has released it. TMA rather than cp.async,
//     which could write the same swizzled layout but from every thread's
//     issue slots, and needs a proxy fence before wgmma reads it. No
//     producer warpgroup: one whose setmaxnreg gave the consumers 240
//     registers left ptxas spilling the D = 256 accumulators and
//     serialising the wgmmas, where two warpgroups alone get 255 a thread
//     and need 204 (PERF.md). The tensor maps are 3-D, [BH, T, D],
//     so a ragged last tile reads zero rows, never the next head's; keys
//     past Tk are still masked to -1e30. cuTensorMapEncodeTiled is the
//     driver's, taken through cudaGetDriverEntryPoint: the library links
//     no libcuda;
//   - tiles sit in shared memory in TMA's 128-byte swizzle, which wgmma's
//     descriptors read: [64 rows x 64 dims] slabs of 8 KB, D / 64 a tile;
//   - S = q k^T is wgmma.m64n64k16 with both operands read from shared
//     memory (K-major), 16 dims a step over the whole head dim in order,
//     once a tile; P.V is wgmma.m64nNk16 with p's bf16 hi, then lo, as the
//     A operand from registers for each 16-key step in order, into float32
//     accumulators of N output dims (v MN-major). Every step of a tile is
//     issued, the ragged tile's too (a masked key's p is 0 and its v row
//     zero-filled, so it adds 0): a branch among the wgmmas made ptxas
//     serialise them. A warpgroup's accumulators have mma.sync's m16n8 C
//     layout in each warp, so the softmax and split_fragment are the
//     D <= 128 kernel's, and so is the arithmetic
//     (attention_fwd_emulation): the max of the unscaled logit,
//     p = exp2_approx(s scale2 - shift) over 64-key tiles, the denominator
//     from the float32 p, out = acc / max(denom, 1e-30), lse written once
//     a row. wgmma may sum inside a 16-dim step otherwise than mma.sync;
//   - registers: a warpgroup's 64 x 256 accumulator is 128 float32 a
//     thread, beside S (32) and p's hi and lo (32). At D = 256 each
//     warpgroup owns 64 query rows and all 256 dims (128 rows a block); at
//     D = 384 all 384 would be 192 registers, so both take the same 64
//     rows, each half of the output's dims (96 accumulators), and both
//     compute the same S (a third more tensor-core work than one S passed
//     through shared memory, but no exchange and no wait between them);
//   - shared memory (FwdPlan::SMEM): q, two stages of k and at D = 256
//     two of v, at D = 384 one (a second would pass the 232,448 bytes a
//     block may opt into): 193 KB at both, one block an SM;
//   - waves: at [32, 1600] D = 256 the grid is 416 blocks of 128 rows
//     (3.15 waves of 132); 64-row blocks would need S twice or 192
//     accumulators.

constexpr int FWD_CONSUMERS = 2;                  // warpgroups
constexpr int FWD_THREADS = 128 * FWD_CONSUMERS;
constexpr int SLAB = 64;                          // dims of a swizzled row
constexpr int SLAB_BYTES = TILE * SLAB * 2;       // [64 rows x 64 dims] bf16
constexpr int SW_ALIGN = 1024;                    // a swizzle atom's alignment

template <int NC>
struct FwdPlan {
  static constexpr int D = NC * CD;
  static constexpr int SLABS = D / SLAB;
  static constexpr int TILE_BYTES = SLABS * SLAB_BYTES;  // 64 rows of D
  // query rows a block; output dims a consumer warpgroup owns
  static constexpr int BLOCK_ROWS = NC == 2 ? 2 * TILE : TILE;
  static constexpr int OWN = NC == 2 ? D : D / 2;
  static constexpr int K_STAGES = 2, V_STAGES = NC == 2 ? 2 : 1;
  static constexpr int Q_BYTES = BLOCK_ROWS / TILE * TILE_BYTES;
  static constexpr int SMEM =
      SW_ALIGN + Q_BYTES + (K_STAGES + V_STAGES) * TILE_BYTES;
};

// The forward at D = 128 NC, NC <= RESIDENT_MAX_NC: a block owns
// FwdPlan<NC>::BLOCK_ROWS query rows and all D of their output; q_map,
// k_map and v_map are 3-D tensor maps of q, k and v ([BH, T, D] bf16,
// boxes of 64 dims x 64 rows x 1, 128-byte swizzle).
template <int NC>
__global__ void __launch_bounds__(FWD_THREADS, 1)
attn_fwd_wide_mma_kernel(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         bf16* __restrict__ out, float* __restrict__ lse,
                         int Tq, int Tk, int tiles, float scale) {
  using P = FwdPlan<NC>;
  constexpr int D = P::D, STEPS = TILE / STEP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ uint64_t q_full, k_full[P::K_STAGES], k_empty[P::K_STAGES],
      v_full[P::V_STAGES], v_empty[P::V_STAGES];
  // q [BLOCK_ROWS / 64][SLABS][SLAB_BYTES], then the k and v stages
  // [stage][SLABS][SLAB_BYTES], from the first 1024-byte boundary
  unsigned char* sq =
      smem_raw + (SW_ALIGN - shared_address(smem_raw) % SW_ALIGN) % SW_ALIGN;
  unsigned char* sk = sq + P::Q_BYTES;
  unsigned char* sv = sk + P::K_STAGES * P::TILE_BYTES;
  const int bh = blockIdx.x / tiles;
  const int first = (blockIdx.x % tiles) * P::BLOCK_ROWS;
  const int n_tiles = (Tk + TILE - 1) / TILE;
  if (threadIdx.x == 0) {
    barrier_init(&q_full, 1);
    // a stage is full after thread 0's one arrival and its bytes, empty
    // after one arrival of each warp
#pragma unroll
    for (int s = 0; s < P::K_STAGES; ++s) {
      barrier_init(&k_full[s], 1);
      barrier_init(&k_empty[s], 4 * FWD_CONSUMERS);
    }
#pragma unroll
    for (int s = 0; s < P::V_STAGES; ++s) {
      barrier_init(&v_full[s], 1);
      barrier_init(&v_empty[s], 4 * FWD_CONSUMERS);
    }
    barrier_init_fence();
  }
  __syncthreads();
  // tile i of k and of v into its stage
  auto load_k = [&](int i) {
    const int ks = i % P::K_STAGES;
    barrier_expect_bytes(&k_full[ks], P::TILE_BYTES);
    for (int s = 0; s < P::SLABS; ++s)
      tma_load_3d(sk + (ks * P::SLABS + s) * SLAB_BYTES, &k_map, &k_full[ks],
                  s * SLAB, i * TILE, bh);
  };
  auto load_v = [&](int i) {
    const int vs = i % P::V_STAGES;
    barrier_expect_bytes(&v_full[vs], P::TILE_BYTES);
    for (int s = 0; s < P::SLABS; ++s)
      tma_load_3d(sv + (vs * P::SLABS + s) * SLAB_BYTES, &v_map, &v_full[vs],
                  s * SLAB, i * TILE, bh);
  };
  if (threadIdx.x == 0) {
    barrier_expect_bytes(&q_full, P::Q_BYTES);
    for (int g = 0; g < P::BLOCK_ROWS / TILE; ++g)
      for (int s = 0; s < P::SLABS; ++s)
        tma_load_3d(sq + (g * P::SLABS + s) * SLAB_BYTES, &q_map, &q_full,
                    s * SLAB, first + g * TILE, bh);
    for (int i = 0; i < P::K_STAGES && i < n_tiles; ++i) load_k(i);
    for (int i = 0; i < P::V_STAGES && i < n_tiles; ++i) load_v(i);
  }
  // warpgroup wg: rows row0 .. row0 + 63 of the block, output dims col0 ..
  // col0 + OWN - 1
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int grp = lane / 4, tig = lane % 4;
  const int row0 = NC == 2 ? wg * TILE : 0;
  const int col0 = NC == 2 ? 0 : wg * P::OWN;
  const int r0 = first + row0 + warp * STEP + grp;  // rows r0, r0 + 8
  const long long q_base = static_cast<long long>(bh) * Tq;
  const unsigned char* q_rows = sq + row0 / TILE * P::TILE_BYTES;
  const float scale2 = scale * LOG2E;
  float m[2] = {NEG, NEG}, denom[2] = {0.f, 0.f};
  float acc[P::OWN / 8][4];
  float(&acc_flat)[P::OWN / 2] = reinterpret_cast<float(&)[P::OWN / 2]>(acc);
#pragma unroll
  for (int i = 0; i < P::OWN / 2; ++i) acc_flat[i] = 0.f;

  barrier_wait(&q_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int ks = i % P::K_STAGES, vs = i % P::V_STAGES, k0 = i * TILE;
    // S = q k^T over the head dim, 16 dims a step in order (the first
    // step's scale-d of 0 starts the sum)
    float s[STEPS][2][4];
    float(&s_flat)[32] = reinterpret_cast<float(&)[32]>(s);
    barrier_wait(&k_full[ks], (i / P::K_STAGES) & 1);
    const unsigned char* k_tile = sk + ks * P::TILE_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / STEP; ++kk) {
      const int at = kk / 4 * SLAB_BYTES + kk % 4 * 2 * STEP;
      wgmma_m64n64k16_ss(s_flat, sw128_descriptor(q_rows + at, 0),
                         sw128_descriptor(k_tile + at, 0), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_hold(s_flat);
    // the k stage is released; once every warp has, thread 0 refills it
    if (lane == 0) barrier_arrive(&k_empty[ks]);
    if (threadIdx.x == 0 && i + P::K_STAGES < n_tiles) {
      barrier_wait(&k_empty[ks], (i / P::K_STAGES) & 1);
      load_k(i + P::K_STAGES);
    }
    __syncwarp();

    // the D <= 128 kernel's softmax step
    const bool ragged = k0 + TILE > Tk;
    float m_new[2] = {m[0], m[1]};
#pragma unroll
    for (int cs = 0; cs < STEPS; ++cs)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + cs * STEP + 8 * j + 2 * tig + e % 2;
          if (ragged && key >= Tk) s[cs][j][e] = NEG;
          m_new[e / 2] = fmaxf(m_new[e / 2], s[cs][j][e]);
        }
    float alpha[2], shift[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m_new[h] = fmaxf(m_new[h], __shfl_xor_sync(0xffffffffu, m_new[h], 1));
      m_new[h] = fmaxf(m_new[h], __shfl_xor_sync(0xffffffffu, m_new[h], 2));
      alpha[h] = exp2_approx((m[h] - m_new[h]) * scale2);
      shift[h] = m_new[h] * scale2;
      m[h] = m_new[h];
      denom[h] *= alpha[h];
    }
#pragma unroll
    for (int nd = 0; nd < P::OWN / 8; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nd][e] *= alpha[e / 2];
    uint32_t hi[STEPS][4], lo[STEPS][4];
#pragma unroll
    for (int cs = 0; cs < STEPS; ++cs) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // a masked key: 2^(-1e30 scale2 - shift) = 0
          const float p = exp2_approx(fmaf(s[cs][j][e], scale2, -shift[e / 2]));
          s[cs][j][e] = p;
          denom[e / 2] += p;  // the float32 p, not its bf16 parts
        }
      split_fragment(s[cs], hi[cs], lo[cs]);
    }

    // acc += p v: hi, then lo, for each 16-key step in order, every step
    barrier_wait(&v_full[vs], (i / P::V_STAGES) & 1);
    const unsigned char* v_cols =
        sv + vs * P::TILE_BYTES + col0 / SLAB * SLAB_BYTES;
    wgmma_hold(acc_flat);
    wgmma_fence();
#pragma unroll
    for (int cs = 0; cs < STEPS; ++cs) {
      const uint64_t b =
          sw128_descriptor(v_cols + cs * STEP * 2 * SLAB, SLAB_BYTES);
      wgmma_rs<P::OWN>(acc_flat, hi[cs], b);
      wgmma_rs<P::OWN>(acc_flat, lo[cs], b);
    }
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_hold(acc_flat);
    if (lane == 0) barrier_arrive(&v_empty[vs]);
    if (threadIdx.x == 0 && i + P::V_STAGES < n_tiles) {
      barrier_wait(&v_empty[vs], (i / P::V_STAGES) & 1);
      load_v(i + P::V_STAGES);
    }
    __syncwarp();
  }
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    denom[h] += __shfl_xor_sync(0xffffffffu, denom[h], 1);
    denom[h] += __shfl_xor_sync(0xffffffffu, denom[h], 2);
    denom[h] = fmaxf(denom[h], FLOOR);
    inv[h] = 1.f / denom[h];
    if (col0 == 0 && tig == 0 && r0 + 8 * h < Tq)
      lse[q_base + r0 + 8 * h] = m[h] * scale + logf(denom[h]);
  }
  store_chunk(acc, inv, out + q_base * D + col0, D, r0, Tq, tig);
}

// ---- bf16 at D = 80 and 128: the forward, dq and dk/dv on wgmma, TMA ----
//
// The mma.sync kernels, designed for D <= 64, ran D = 128 (and ViT-Huge's
// D = 80, padded to it) at 9-14% of their bounds at [128, 1600, 1600, 80]:
// mma.sync with ldmatrix, 4 warps of 16 rows, dk/dv reading its own rows'
// A fragments from shared memory at every product for want of registers,
// the forward 152 / 198 registers (PERF.md). Here attn_fwd_wgmma_kernel<D>,
// attn_dq_wgmma_kernel<D> and attn_dkdv_wgmma_kernel<D> (D = 80, 128) take
// the design of the wide forward above instead:
//   - two warpgroups a block, each owning 64 rows (query rows for the
//     forward and dq, key rows for dk/dv; 128 a block), all D of their
//     output. Thread 0 issues every copy with TMA: the block's own rows
//     once (q; q and dO; or k and v), resident for the whole kernel, and
//     the streamed operand (k and v, or q and dO) a 64-row tile at a time
//     into a ring of NARROW_STAGES stages with a full and an empty
//     mbarrier each; it refills a stage once every warp has released it
//     (a third stage gained nothing in dq);
//   - the staged rows are 128 dims wide in TMA's 128-byte swizzle, two
//     [64 x 64] slabs a tile, at both D: at D = 80 the second slab's box
//     reaches past the tensor's 80 dims and TMA writes zeros there (and
//     counts their bytes), so no padded copy exists in device memory. The
//     first products issue only the real 16-dim steps (5 at D = 80, 8 at
//     128), the second products take N = D columns (wgmma m64n80k16 reads
//     64 columns from the first slab and 16 from the second);
//   - the forward: S = Q K^T is wgmma.m64n64k16 with both operands in
//     shared memory (K-major) over the real 16-dim steps in order; the
//     online softmax of attn_fwd_mma_kernel on the accumulator (its 8-column
//     groups in order are mma.sync's s[c][j], so the max, p and the
//     denominator are summed in that kernel's order: attention_fwd_emulation
//     holds for both); p split into hi and lo is the register A operand of
//     acc += P V, hi then lo for each 16-key step in order, the v tile read
//     as MN-major B. Out and lse are plain guarded stores (each row's lse
//     by one thread), as a 1-D TMA map of per-row values traps where a
//     head's rows start off 16 bytes (dk/dv below);
//   - dq: S = Q K^T and dP = dO V^T are wgmma.m64n64k16 with both operands
//     in shared memory (K-major), 16 dims a step over the head dim in
//     order; p = exp2_approx(s scale2 - lse2) and ds = p (dp - delta) in
//     registers (keys past Tk masked to p = 0), split into hi and lo and
//     fed as the register A operand of dQ += dS K, hi then lo for each
//     16-key step in order, the k tile read as MN-major B;
//   - dk/dv: S^T = K Q^T and dP^T = V dO^T the same way with the block's k
//     and v rows as A; p and ds the same arithmetic (queries past Tq masked
//     to p = 0), then dV += P^T dO and dK += dS^T Q from registers, hi then
//     lo for each 16-query step, the q and dO tiles read again as MN-major
//     B. A tile's lse and delta are loaded by the warpgroup's threads, one
//     value each (its load in flight during the first products), into a
//     double buffer of the warpgroup's, read after a named barrier: the
//     rows of a tile start anywhere in the [BH Tq] rows, where TMA would
//     need 16-byte aligned ones;
//   - S and dP are two commit groups, so that p is computed while dP is
//     in flight; dk/dv issues dV's products before it splits ds, which
//     then overlaps them. Issuing the next tile's S and dP while dq's
//     second products were still in flight made ptxas serialise the
//     wgmmas (C7515) and dq slower: not kept;
//   - the sums are those of the mma.sync kernels (attention_fwd_emulation,
//     attention_dq_emulation, attention_dkdv_emulation): 64-row tiles,
//     16-row steps in order, hi before lo, dq and dk scaled at the end; on
//     the card dq, dk and dv come out the bits of the mma.sync kernels at
//     D = 80 (padded to 128 there) and 128. Every step of a tile is issued,
//     the ragged tile's too (a masked p is 0 and TMA zero-fills the rows
//     past T): a branch among the wgmmas made ptxas serialise them in the
//     wide forward. Each output element is one thread's, summed in a fixed
//     order: two launches give the same bits;
//   - registers: dk/dv at D = 128 holds two 64 x 128 float32 accumulators
//     (128 a thread) beside S^T and dP^T (64) and the hi and lo parts of p
//     and ds (64); ptxas gives it 255, no spill, and dq 147 (D = 80) and
//     154 (128); one block of 8 warps an SM. The forward holds D / 2
//     accumulators (40, 64) beside S (32) and p's hi and lo (32), which
//     fit the 128 registers a thread of two blocks an SM with no spill;
//     two blocks, one's softmax beside the other's products, ran faster
//     than one block with more registers at both D (probes/
//     k3_fwd_narrow.py, PERF.md). Issuing the next tile's S before the
//     softmax instead (two S buffers, one block) made ptxas serialise the
//     wgmmas: not kept;
//   - shared memory: the block's rows (64 KB; the forward's q 32 KB) and
//     two stages of two tiles (64 KB), 129 KB with the alignment
//     (NARROW_SMEM; the forward's 97 KB, NARROW_FWD_SMEM, so that two
//     blocks fit an SM), and dk/dv's 2 KB of lse and delta.

constexpr int NARROW_WGS = 2;                      // warpgroups a block
constexpr int NARROW_THREADS = 128 * NARROW_WGS;
constexpr int NARROW_ROWS = TILE * NARROW_WGS;     // rows a block owns
constexpr int NARROW_STAGES = 2;
constexpr int NTILE_BYTES = 2 * SLAB_BYTES;        // 64 rows x 128 dims
// the block's rows of two operands, then the stages' tiles of two (dq: k
// and v; dk/dv: q and dO)
constexpr int NARROW_SMEM =
    SW_ALIGN + 2 * NARROW_WGS * NTILE_BYTES + NARROW_STAGES * 2 * NTILE_BYTES;
// the forward's: the block's q rows, then the stages' k and v tiles
constexpr int NARROW_FWD_SMEM =
    SW_ALIGN + NARROW_WGS * NTILE_BYTES + NARROW_STAGES * 2 * NTILE_BYTES;

// The first 1024-byte boundary at or after p (a swizzle atom's alignment).
__device__ __forceinline__ unsigned char* swizzle_aligned(unsigned char* p) {
  return p + (SW_ALIGN - shared_address(p) % SW_ALIGN) % SW_ALIGN;
}

// Waits until the 128 threads of warpgroup wg have arrived (named barrier
// 1 + wg; 0 is __syncthreads').
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
}

// x[64 x 64] = a[64 x D] . b[64 x D]^T over the real 16-dim steps of D, a
// and b staged tiles (two 128-byte-swizzled slabs, K-major); the first
// step's scale-d of 0 starts the sum.
template <int D>
__device__ __forceinline__ void wgmma_over_dims(float (&x)[32],
                                                const unsigned char* a,
                                                const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < D / STEP; ++kk) {
    const int at = kk / 4 * SLAB_BYTES + kk % 4 * 2 * STEP;
    wgmma_m64n64k16_ss(x, sw128_descriptor(a + at, 0),
                       sw128_descriptor(b + at, 0), kk > 0);
  }
}

// acc[64 x D] += (hi + lo)[64 x 64] . rows[64 x D]: the four 16-row steps
// of a staged tile in order, hi then lo, rows read as MN-major B.
template <int D>
__device__ __forceinline__ void wgmma_over_rows(
    float (&acc)[D / 2], const uint32_t (&hi)[TILE / STEP][4],
    const uint32_t (&lo)[TILE / STEP][4], const unsigned char* rows) {
#pragma unroll
  for (int cs = 0; cs < TILE / STEP; ++cs) {
    const uint64_t b = sw128_descriptor(rows + cs * STEP * 2 * SLAB,
                                        SLAB_BYTES);
    wgmma_rs<D>(acc, hi[cs], b);
    wgmma_rs<D>(acc, lo[cs], b);
  }
}

// The forward at D = 80 and 128: a block owns NARROW_ROWS query rows and
// all D of their output; q_map, k_map and v_map are 3-D tensor maps of q,
// k and v ([BH, T, D] bf16, boxes of 64 dims x 64 rows x 1, 128-byte
// swizzle). Two blocks an SM: 128 registers a thread.
template <int D>
__global__ void __launch_bounds__(NARROW_THREADS, 2)
attn_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      bf16* __restrict__ out, float* __restrict__ lse,
                      int Tq, int Tk, int tiles, float scale) {
  constexpr int STEPS = TILE / STEP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ uint64_t q_full, full[NARROW_STAGES], empty[NARROW_STAGES];
  // q [NARROW_WGS][NTILE_BYTES], then the stages' k and v tiles
  // [stage][2][NTILE_BYTES]
  unsigned char* sq = swizzle_aligned(smem_raw);
  unsigned char* skv = sq + NARROW_WGS * NTILE_BYTES;
  const int bh = blockIdx.x / tiles;
  const int first = (blockIdx.x % tiles) * NARROW_ROWS;
  const int n_tiles = (Tk + TILE - 1) / TILE;
  if (threadIdx.x == 0) {
    barrier_init(&q_full, 1);
    // a stage is full after thread 0's one arrival and its bytes, empty
    // after one arrival of each warp
#pragma unroll
    for (int s = 0; s < NARROW_STAGES; ++s) {
      barrier_init(&full[s], 1);
      barrier_init(&empty[s], 4 * NARROW_WGS);
    }
    barrier_init_fence();
  }
  __syncthreads();
  auto load_tile = [&](int i) {  // keys i * TILE .. + 63 of k and of v
    const int st = i % NARROW_STAGES;
    unsigned char* dst = skv + st * 2 * NTILE_BYTES;
    barrier_expect_bytes(&full[st], 2 * NTILE_BYTES);
    for (int s = 0; s < 2; ++s) {
      tma_load_3d(dst + s * SLAB_BYTES, &k_map, &full[st], s * SLAB,
                  i * TILE, bh);
      tma_load_3d(dst + NTILE_BYTES + s * SLAB_BYTES, &v_map, &full[st],
                  s * SLAB, i * TILE, bh);
    }
  };
  if (threadIdx.x == 0) {
    barrier_expect_bytes(&q_full, NARROW_WGS * NTILE_BYTES);
    for (int w = 0; w < NARROW_WGS; ++w)
      for (int s = 0; s < 2; ++s)
        tma_load_3d(sq + w * NTILE_BYTES + s * SLAB_BYTES, &q_map, &q_full,
                    s * SLAB, first + w * TILE, bh);
    for (int i = 0; i < NARROW_STAGES && i < n_tiles; ++i) load_tile(i);
  }
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int grp = lane / 4, tig = lane % 4;
  const int r0 = first + wg * TILE + warp * STEP + grp;  // rows r0, r0 + 8
  const long long q_base = static_cast<long long>(bh) * Tq;
  const unsigned char* q_rows = sq + wg * NTILE_BYTES;
  const float scale2 = scale * LOG2E;
  // per row: the running max of the unscaled q.k, and this thread's share
  // of the denominator (its 16 of a tile's 64 keys; summed over the row's
  // four lanes at the end)
  float m[2] = {NEG, NEG}, denom[2] = {0.f, 0.f};
  float acc[D / 8][4];
  float(&acc_flat)[D / 2] = reinterpret_cast<float(&)[D / 2]>(acc);
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_flat[i] = 0.f;

  barrier_wait(&q_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % NARROW_STAGES, k0 = i * TILE;
    const unsigned char* k_tile = skv + st * 2 * NTILE_BYTES;
    const unsigned char* v_tile = k_tile + NTILE_BYTES;
    float s[STEPS][2][4];
    float(&s_flat)[32] = reinterpret_cast<float(&)[32]>(s);
    barrier_wait(&full[st], (i / NARROW_STAGES) & 1);
    wgmma_fence();
    wgmma_over_dims<D>(s_flat, q_rows, k_tile);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_hold(s_flat);

    // attn_fwd_mma_kernel's softmax step: keys past Tk (zero rows from
    // TMA) are masked in the last tile; key k0 is real, so every row's
    // max is a real logit
    const bool ragged = k0 + TILE > Tk;  // the same for every thread
    float m_new[2] = {m[0], m[1]};
#pragma unroll
    for (int cs = 0; cs < STEPS; ++cs)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + cs * STEP + 8 * j + 2 * tig + e % 2;
          if (ragged && key >= Tk) s[cs][j][e] = NEG;
          m_new[e / 2] = fmaxf(m_new[e / 2], s[cs][j][e]);
        }
    float alpha[2], shift[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // over the four lanes of a row
      m_new[h] = fmaxf(m_new[h], __shfl_xor_sync(0xffffffffu, m_new[h], 1));
      m_new[h] = fmaxf(m_new[h], __shfl_xor_sync(0xffffffffu, m_new[h], 2));
      alpha[h] = exp2_approx((m[h] - m_new[h]) * scale2);
      shift[h] = m_new[h] * scale2;
      m[h] = m_new[h];
      denom[h] *= alpha[h];
    }
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nd][e] *= alpha[e / 2];
    uint32_t hi[STEPS][4], lo[STEPS][4];
#pragma unroll
    for (int cs = 0; cs < STEPS; ++cs) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // a masked key: 2^(-1e30 scale2 - shift) = 0
          const float p = exp2_approx(fmaf(s[cs][j][e], scale2, -shift[e / 2]));
          s[cs][j][e] = p;
          denom[e / 2] += p;  // the float32 p, not its bf16 parts
        }
      split_fragment(s[cs], hi[cs], lo[cs]);
    }

    // acc += p v: hi, then lo, for each 16-key step in order, every step
    wgmma_hold(acc_flat);
    wgmma_fence();
    wgmma_over_rows<D>(acc_flat, hi, lo, v_tile);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_hold(acc_flat);
    // the stage is released; once every warp has, thread 0 refills it
    if (lane == 0) barrier_arrive(&empty[st]);
    if (threadIdx.x == 0 && i + NARROW_STAGES < n_tiles) {
      barrier_wait(&empty[st], (i / NARROW_STAGES) & 1);
      load_tile(i + NARROW_STAGES);
    }
    __syncwarp();
  }
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    denom[h] += __shfl_xor_sync(0xffffffffu, denom[h], 1);
    denom[h] += __shfl_xor_sync(0xffffffffu, denom[h], 2);
    denom[h] = fmaxf(denom[h], FLOOR);
    inv[h] = 1.f / denom[h];
    if (tig == 0 && r0 + 8 * h < Tq)
      lse[q_base + r0 + 8 * h] = m[h] * scale + logf(denom[h]);
  }
  store_accumulator<D>(acc, inv, out + q_base * D, r0, Tq, tig);
}

// dq at D = 80 and 128: a block owns NARROW_ROWS query rows; q_map, k_map,
// v_map and g_map are 3-D tensor maps of q, k, v and dO ([BH, T, D] bf16,
// boxes of 64 dims x 64 rows x 1, 128-byte swizzle).
template <int D>
__global__ void __launch_bounds__(NARROW_THREADS, 1)
attn_dq_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const __grid_constant__ CUtensorMap g_map,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dq,
                     int Tq, int Tk, int tiles, float scale) {
  constexpr int STEPS = TILE / STEP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ uint64_t rows_full, full[NARROW_STAGES], empty[NARROW_STAGES];
  // q [NARROW_WGS][NTILE_BYTES], dO the same, then the stages' k and v
  // tiles [stage][2][NTILE_BYTES]
  unsigned char* sq = swizzle_aligned(smem_raw);
  unsigned char* sg = sq + NARROW_WGS * NTILE_BYTES;
  unsigned char* skv = sg + NARROW_WGS * NTILE_BYTES;
  const int bh = blockIdx.x / tiles;
  const int first = (blockIdx.x % tiles) * NARROW_ROWS;
  const int n_tiles = (Tk + TILE - 1) / TILE;
  if (threadIdx.x == 0) {
    barrier_init(&rows_full, 1);
    // a stage is full after thread 0's one arrival and its bytes, empty
    // after one arrival of each warp
#pragma unroll
    for (int s = 0; s < NARROW_STAGES; ++s) {
      barrier_init(&full[s], 1);
      barrier_init(&empty[s], 4 * NARROW_WGS);
    }
    barrier_init_fence();
  }
  __syncthreads();
  auto load_tile = [&](int i) {  // keys i * TILE .. + 63 of k and of v
    const int st = i % NARROW_STAGES;
    unsigned char* dst = skv + st * 2 * NTILE_BYTES;
    barrier_expect_bytes(&full[st], 2 * NTILE_BYTES);
    for (int s = 0; s < 2; ++s) {
      tma_load_3d(dst + s * SLAB_BYTES, &k_map, &full[st], s * SLAB,
                  i * TILE, bh);
      tma_load_3d(dst + NTILE_BYTES + s * SLAB_BYTES, &v_map, &full[st],
                  s * SLAB, i * TILE, bh);
    }
  };
  if (threadIdx.x == 0) {
    barrier_expect_bytes(&rows_full, 2 * NARROW_WGS * NTILE_BYTES);
    for (int w = 0; w < NARROW_WGS; ++w)
      for (int s = 0; s < 2; ++s) {
        const int at = w * NTILE_BYTES + s * SLAB_BYTES;
        tma_load_3d(sq + at, &q_map, &rows_full, s * SLAB, first + w * TILE,
                    bh);
        tma_load_3d(sg + at, &g_map, &rows_full, s * SLAB, first + w * TILE,
                    bh);
      }
    for (int i = 0; i < NARROW_STAGES && i < n_tiles; ++i) load_tile(i);
  }
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int grp = lane / 4, tig = lane % 4;
  const int r0 = first + wg * TILE + warp * STEP + grp;  // rows r0, r0 + 8
  const long long q_base = static_cast<long long>(bh) * Tq;
  const unsigned char* q_rows = sq + wg * NTILE_BYTES;
  const unsigned char* g_rows = sg + wg * NTILE_BYTES;
  const float scale2 = scale * LOG2E;
  float row_lse2[2], row_delta[2];  // lse times log2(e)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool live = r0 + 8 * h < Tq;
    row_lse2[h] = live ? lse[q_base + r0 + 8 * h] * LOG2E : 0.f;
    row_delta[h] = live ? delta[q_base + r0 + 8 * h] : 0.f;
  }
  float acc[D / 8][4];
  float(&acc_flat)[D / 2] = reinterpret_cast<float(&)[D / 2]>(acc);
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_flat[i] = 0.f;

  barrier_wait(&rows_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % NARROW_STAGES, k0 = i * TILE;
    const unsigned char* k_tile = skv + st * 2 * NTILE_BYTES;
    const unsigned char* v_tile = k_tile + NTILE_BYTES;
    float s[STEPS][2][4], dp[STEPS][2][4];
    float(&s_flat)[32] = reinterpret_cast<float(&)[32]>(s);
    float(&dp_flat)[32] = reinterpret_cast<float(&)[32]>(dp);
    barrier_wait(&full[st], (i / NARROW_STAGES) & 1);
    // S and dP in two groups: p is computed while dP is in flight
    wgmma_fence();
    wgmma_over_dims<D>(s_flat, q_rows, k_tile);
    wgmma_commit();
    wgmma_over_dims<D>(dp_flat, g_rows, v_tile);
    wgmma_commit();
    wgmma_wait<1>();
    wgmma_hold(s_flat);
#pragma unroll
    for (int cs = 0; cs < STEPS; ++cs)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // keys past Tk are masked out of p
          const int key = k0 + cs * STEP + 8 * j + 2 * tig + e % 2;
          s[cs][j][e] =
              key < Tk ? exp2_approx(s[cs][j][e] * scale2 - row_lse2[e / 2])
                       : 0.f;
        }
    wgmma_wait<0>();
    wgmma_hold(dp_flat);
    uint32_t hi[STEPS][4], lo[STEPS][4];
#pragma unroll
    for (int cs = 0; cs < STEPS; ++cs) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)  // ds
          dp[cs][j][e] = s[cs][j][e] * (dp[cs][j][e] - row_delta[e / 2]);
      split_fragment(dp[cs], hi[cs], lo[cs]);
    }
    wgmma_hold(acc_flat);
    wgmma_fence();
    wgmma_over_rows<D>(acc_flat, hi, lo, k_tile);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_hold(acc_flat);
    // the stage is released; once every warp has, thread 0 refills it
    if (lane == 0) barrier_arrive(&empty[st]);
    if (threadIdx.x == 0 && i + NARROW_STAGES < n_tiles) {
      barrier_wait(&empty[st], (i / NARROW_STAGES) & 1);
      load_tile(i + NARROW_STAGES);
    }
    __syncwarp();
  }
  store_accumulator<D>(acc, scale, dq + q_base * D, r0, Tq, tig);
}

// dk/dv at D = 80 and 128: a block owns NARROW_ROWS key rows; the tensor
// maps as dq's.
template <int D>
__global__ void __launch_bounds__(NARROW_THREADS, 1)
attn_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       const __grid_constant__ CUtensorMap g_map,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       bf16* __restrict__ dk, bf16* __restrict__ dv, int Tq,
                       int Tk, int tiles, float scale) {
  constexpr int STEPS = TILE / STEP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ uint64_t rows_full, full[NARROW_STAGES], empty[NARROW_STAGES];
  // each warpgroup's double buffer of a tile's lse and delta
  __shared__ __align__(8) float stats[NARROW_WGS][2][2][TILE];
  // k [NARROW_WGS][NTILE_BYTES], v the same, then the stages' q and dO
  // tiles [stage][2][NTILE_BYTES]
  unsigned char* sk = swizzle_aligned(smem_raw);
  unsigned char* sv = sk + NARROW_WGS * NTILE_BYTES;
  unsigned char* stages = sv + NARROW_WGS * NTILE_BYTES;
  const int bh = blockIdx.x / tiles;
  const int first = (blockIdx.x % tiles) * NARROW_ROWS;
  const int n_tiles = (Tq + TILE - 1) / TILE;
  if (threadIdx.x == 0) {
    barrier_init(&rows_full, 1);
#pragma unroll
    for (int s = 0; s < NARROW_STAGES; ++s) {
      barrier_init(&full[s], 1);
      barrier_init(&empty[s], 4 * NARROW_WGS);
    }
    barrier_init_fence();
  }
  __syncthreads();
  auto load_tile = [&](int i) {  // queries i * TILE .. + 63
    const int st = i % NARROW_STAGES;
    unsigned char* dst = stages + st * 2 * NTILE_BYTES;
    barrier_expect_bytes(&full[st], 2 * NTILE_BYTES);
    for (int s = 0; s < 2; ++s) {
      tma_load_3d(dst + s * SLAB_BYTES, &q_map, &full[st], s * SLAB,
                  i * TILE, bh);
      tma_load_3d(dst + NTILE_BYTES + s * SLAB_BYTES, &g_map, &full[st],
                  s * SLAB, i * TILE, bh);
    }
  };
  if (threadIdx.x == 0) {
    barrier_expect_bytes(&rows_full, 2 * NARROW_WGS * NTILE_BYTES);
    for (int w = 0; w < NARROW_WGS; ++w)
      for (int s = 0; s < 2; ++s) {
        const int at = w * NTILE_BYTES + s * SLAB_BYTES;
        tma_load_3d(sk + at, &k_map, &rows_full, s * SLAB, first + w * TILE,
                    bh);
        tma_load_3d(sv + at, &v_map, &rows_full, s * SLAB, first + w * TILE,
                    bh);
      }
    for (int i = 0; i < NARROW_STAGES && i < n_tiles; ++i) load_tile(i);
  }
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int grp = lane / 4, tig = lane % 4;
  const int r0 = first + wg * TILE + warp * STEP + grp;  // rows r0, r0 + 8
  const long long k_base = static_cast<long long>(bh) * Tk;
  const long long q_base = static_cast<long long>(bh) * Tq;
  // this thread's value of each tile's statistics: row t % 64 of the lse
  // (t < 64) or of delta
  const int t = threadIdx.x % 128;
  const float* stat_rows = (t < TILE ? lse : delta) + q_base;
  const unsigned char* k_rows = sk + wg * NTILE_BYTES;
  const unsigned char* v_rows = sv + wg * NTILE_BYTES;
  const float scale2 = scale * LOG2E;
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
  float(&dk_flat)[D / 2] = reinterpret_cast<float(&)[D / 2]>(dk_acc);
  float(&dv_flat)[D / 2] = reinterpret_cast<float(&)[D / 2]>(dv_acc);
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_flat[i] = dv_flat[i] = 0.f;

  barrier_wait(&rows_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % NARROW_STAGES, q0 = i * TILE;
    const unsigned char* q_tile = stages + st * 2 * NTILE_BYTES;
    const unsigned char* g_tile = q_tile + NTILE_BYTES;
    const float* s_lse = stats[wg][i & 1][0];
    const float* s_delta = stats[wg][i & 1][1];
    const int q_row = q0 + t % TILE;
    const float stat = q_row < Tq ? stat_rows[q_row] : 0.f;
    // transposed: rows are this warp's keys, columns the tile's queries
    float s[STEPS][2][4], dp[STEPS][2][4];
    float(&s_flat)[32] = reinterpret_cast<float(&)[32]>(s);
    float(&dp_flat)[32] = reinterpret_cast<float(&)[32]>(dp);
    barrier_wait(&full[st], (i / NARROW_STAGES) & 1);
    // S^T and dP^T in two groups: p is computed while dP^T is in flight
    wgmma_fence();
    wgmma_over_dims<D>(s_flat, k_rows, q_tile);
    wgmma_commit();
    wgmma_over_dims<D>(dp_flat, v_rows, g_tile);
    wgmma_commit();
    // the other buffer is still read by the warps behind; this one was
    // last read two tiles ago, before every warp passed the last barrier
    stats[wg][i & 1][t / TILE][t % TILE] = stat;
    warpgroup_sync(wg);
    wgmma_wait<1>();
    wgmma_hold(s_flat);
    uint32_t p_hi[STEPS][4], p_lo[STEPS][4], ds_hi[STEPS][4], ds_lo[STEPS][4];
#pragma unroll
    for (int cs = 0; cs < STEPS; ++cs)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = cs * STEP + 8 * j + 2 * tig;
        const float2 l = *reinterpret_cast<const float2*>(s_lse + col);
        const float lse2[2] = {l.x * LOG2E, l.y * LOG2E};
#pragma unroll
        for (int e = 0; e < 4; ++e)  // query rows past Tq are masked out
          s[cs][j][e] = q0 + col + e % 2 < Tq
                            ? exp2_approx(s[cs][j][e] * scale2 - lse2[e % 2])
                            : 0.f;
      }
    wgmma_wait<0>();
    wgmma_hold(dp_flat);
#pragma unroll
    for (int cs = 0; cs < STEPS; ++cs) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = cs * STEP + 8 * j + 2 * tig;
        const float2 dl = *reinterpret_cast<const float2*>(s_delta + col);
        const float dlt[2] = {dl.x, dl.y};
#pragma unroll
        for (int e = 0; e < 4; ++e)  // ds
          dp[cs][j][e] = s[cs][j][e] * (dp[cs][j][e] - dlt[e % 2]);
      }
      split_fragment(s[cs], p_hi[cs], p_lo[cs]);
    }
    // dV first; ds is split while its products run
    wgmma_hold(dv_flat);
    wgmma_hold(dk_flat);
    wgmma_fence();
    wgmma_over_rows<D>(dv_flat, p_hi, p_lo, g_tile);
    wgmma_commit();
#pragma unroll
    for (int cs = 0; cs < STEPS; ++cs)
      split_fragment(dp[cs], ds_hi[cs], ds_lo[cs]);
    wgmma_fence();
    wgmma_over_rows<D>(dk_flat, ds_hi, ds_lo, q_tile);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_hold(dv_flat);
    wgmma_hold(dk_flat);
    if (lane == 0) barrier_arrive(&empty[st]);
    if (threadIdx.x == 0 && i + NARROW_STAGES < n_tiles) {
      barrier_wait(&empty[st], (i / NARROW_STAGES) & 1);
      load_tile(i + NARROW_STAGES);
    }
    __syncwarp();
  }
  store_accumulator<D>(dk_acc, scale, dk + k_base * D, r0, Tk, tig);
  store_accumulator<D>(dv_acc, 1.f, dv + k_base * D, r0, Tk, tig);
}

// ---- float32 at D = 128 nc, on the CUDA cores ----

constexpr int W_DPT = 32, W_TPR = CD / W_DPT;  // 4 threads a row
constexpr int W_THREADS = ROWS * W_TPR;        // 256

// Stages rows [0, n) of a 128-column chunk of the rows `stride` values
// apart at src into dst [F32_UNIT][CD] times mul (zeros past n).
__device__ __forceinline__ void stage_f32_chunk(const float* src,
                                                long long stride, int n,
                                                float mul, float* dst) {
  for (int e = threadIdx.x; e < F32_UNIT * CD; e += W_THREADS) {
    const int r = e / CD, col = e % CD;
    dst[e] = r < n ? src[r * stride + col] * mul : 0.f;
  }
}

// s[j] += (this thread's 32 dims of row, times mul) . (the same dims of
// staged row j) for the F32_UNIT staged rows; row is read from device
// memory 4 dims at a time, in dot_slice's order.
__device__ __forceinline__ void add_dots(const float* row, bool live,
                                         float mul, const float* staged,
                                         int h, float (&s)[F32_UNIT]) {
#pragma unroll
  for (int c = 0; c < W_DPT / 4; ++c) {
    const int at = 4 * (c * W_TPR + h);
    float4 x = live ? __ldg(reinterpret_cast<const float4*>(row + at))
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    x.x *= mul;
    x.y *= mul;
    x.z *= mul;
    x.w *= mul;
#pragma unroll
    for (int j = 0; j < F32_UNIT; ++j) {
      const float4 r = *reinterpret_cast<const float4*>(staged + j * CD + at);
      s[j] = fmaf(x.x, r.x, s[j]);
      s[j] = fmaf(x.y, r.y, s[j]);
      s[j] = fmaf(x.z, r.z, s[j]);
      s[j] = fmaf(x.w, r.w, s[j]);
    }
  }
}

__global__ void __launch_bounds__(W_THREADS)
attn_fwd_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, int Tq, int Tk, int tiles,
                     int nc, float scale) {
  constexpr int U = F32_UNIT;
  __shared__ __align__(16) float sk[U * CD];
  __shared__ __align__(16) float sv[U * CD];
  const long long Dp = static_cast<long long>(nc) * CD;
  const int oc = blockIdx.y;
  const int bh = blockIdx.x / tiles;
  const int row = (blockIdx.x % tiles) * ROWS + threadIdx.x / W_TPR;
  const int h = threadIdx.x % W_TPR;
  const bool live = row < Tq;
  const long long r_row = static_cast<long long>(bh) * Tq + (live ? row : 0);
  const float* q_row = q + r_row * Dp;
  const float* kb = k + static_cast<long long>(bh) * Tk * Dp;
  const float* vb = v + static_cast<long long>(bh) * Tk * Dp + oc * CD;

  float acc[W_DPT];
#pragma unroll
  for (int e = 0; e < W_DPT; ++e) acc[e] = 0.f;
  float m = NEG, denom = 0.f;
  for (int k0 = 0; k0 < Tk; k0 += U) {
    const int nk = min(U, Tk - k0);
    float s[U];
#pragma unroll
    for (int j = 0; j < U; ++j) s[j] = 0.f;
    for (int c = 0; c < nc; ++c) {
      __syncthreads();  // the previous unit is consumed
      stage_f32_chunk(kb + k0 * Dp + c * CD, Dp, nk, 1.f, sk);
      if (c == nc - 1) stage_f32_chunk(vb + k0 * Dp, Dp, nk, 1.f, sv);
      __syncthreads();
      add_dots(q_row + c * CD, live, scale, sk, h, s);
    }
    // the D <= 128 kernel's 16-key chunk; key k0 is real
    float m_new = m;
#pragma unroll
    for (int j = 0; j < U; ++j) {
      s[j] = row_sum<W_TPR>(s[j]);
      if (j >= nk) s[j] = NEG;
      m_new = fmaxf(m_new, s[j]);
    }
    const float alpha = expf(m - m_new);
    float p_sum = 0.f;
#pragma unroll
    for (int j = 0; j < U; ++j) {
      s[j] = expf(s[j] - m_new);
      p_sum += s[j];
    }
    denom = denom * alpha + p_sum;
#pragma unroll
    for (int e = 0; e < W_DPT; ++e) acc[e] *= alpha;
#pragma unroll
    for (int j = 0; j < U; ++j)
      axpy_slice<W_DPT, W_TPR>(s[j], sv + j * CD, h, acc);
    m = m_new;
  }
  if (live) {
    const float d = fmaxf(denom, FLOOR);
#pragma unroll
    for (int e = 0; e < W_DPT; ++e)
      out[r_row * Dp + oc * CD + dim_of<W_DPT, W_TPR>(e, h)] = acc[e] / d;
    if (oc == 0 && h == 0) lse[r_row] = m + logf(d);
  }
}

__global__ void __launch_bounds__(W_THREADS)
attn_dq_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ g,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int Tq, int Tk, int tiles, int nc, float scale) {
  constexpr int U = F32_UNIT;
  __shared__ __align__(16) float sk[U * CD];
  __shared__ __align__(16) float sv[U * CD];
  __shared__ __align__(16) float sko[U * CD];  // the unit's k, chunk oc
  const long long Dp = static_cast<long long>(nc) * CD;
  const int oc = blockIdx.y;
  const int bh = blockIdx.x / tiles;
  const int row = (blockIdx.x % tiles) * ROWS + threadIdx.x / W_TPR;
  const int h = threadIdx.x % W_TPR;
  const bool live = row < Tq;
  const long long r_row = static_cast<long long>(bh) * Tq + (live ? row : 0);
  const float* q_row = q + r_row * Dp;
  const float* g_row = g + r_row * Dp;
  const float* kb = k + static_cast<long long>(bh) * Tk * Dp;
  const float* vb = v + static_cast<long long>(bh) * Tk * Dp;
  const float row_lse = live ? lse[r_row] : 0.f;
  const float row_delta = live ? delta[r_row] : 0.f;

  float acc[W_DPT];
#pragma unroll
  for (int e = 0; e < W_DPT; ++e) acc[e] = 0.f;
  for (int k0 = 0; k0 < Tk; k0 += U) {
    const int nk = min(U, Tk - k0);
    float s[U], dp[U];
#pragma unroll
    for (int j = 0; j < U; ++j) s[j] = dp[j] = 0.f;
    for (int c = 0; c < nc; ++c) {
      __syncthreads();
      stage_f32_chunk(kb + k0 * Dp + c * CD, Dp, nk, 1.f, sk);
      stage_f32_chunk(vb + k0 * Dp + c * CD, Dp, nk, 1.f, sv);
      if (c == nc - 1)
        stage_f32_chunk(kb + k0 * Dp + oc * CD, Dp, nk, 1.f, sko);
      __syncthreads();
      add_dots(q_row + c * CD, live, scale, sk, h, s);
      add_dots(g_row + c * CD, live, 1.f, sv, h, dp);
    }
#pragma unroll
    for (int j = 0; j < U; ++j) {
      s[j] = row_sum<W_TPR>(s[j]);
      dp[j] = row_sum<W_TPR>(dp[j]);
      const float p = j < nk ? expf(s[j] - row_lse) : 0.f;
      s[j] = p * (dp[j] - row_delta);  // ds
    }
#pragma unroll
    for (int j = 0; j < U; ++j)
      axpy_slice<W_DPT, W_TPR>(s[j], sko + j * CD, h, acc);
  }
  if (live)
    store_slice<W_DPT, W_TPR>(acc, scale, h, dq + r_row * Dp + oc * CD);
}

__global__ void __launch_bounds__(W_THREADS)
attn_dkdv_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ g,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dk,
                      float* __restrict__ dv, int Tq, int Tk, int tiles,
                      int nc, float scale) {
  constexpr int U = F32_UNIT;
  __shared__ __align__(16) float sq[U * CD];   // qs = q * scale
  __shared__ __align__(16) float sg[U * CD];   // dO
  __shared__ __align__(16) float sqo[U * CD];  // qs, chunk oc
  __shared__ __align__(16) float sgo[U * CD];  // dO, chunk oc
  __shared__ float s_lse[U], s_delta[U];
  const long long Dp = static_cast<long long>(nc) * CD;
  const int oc = blockIdx.y;
  const int bh = blockIdx.x / tiles;
  const int row = (blockIdx.x % tiles) * ROWS + threadIdx.x / W_TPR;
  const int h = threadIdx.x % W_TPR;
  const bool live = row < Tk;
  const long long k_row = static_cast<long long>(bh) * Tk + (live ? row : 0);
  const long long q_base = static_cast<long long>(bh) * Tq;
  const float* qb = q + q_base * Dp;
  const float* gb = g + q_base * Dp;

  float dk_acc[W_DPT], dv_acc[W_DPT];
#pragma unroll
  for (int e = 0; e < W_DPT; ++e) dk_acc[e] = dv_acc[e] = 0.f;
  for (int q0 = 0; q0 < Tq; q0 += U) {
    const int nq = min(U, Tq - q0);
    float s[U], dp[U];
#pragma unroll
    for (int i = 0; i < U; ++i) s[i] = dp[i] = 0.f;
    for (int c = 0; c < nc; ++c) {
      __syncthreads();
      stage_f32_chunk(qb + q0 * Dp + c * CD, Dp, nq, scale, sq);
      stage_f32_chunk(gb + q0 * Dp + c * CD, Dp, nq, 1.f, sg);
      if (c == nc - 1) {
        stage_f32_chunk(qb + q0 * Dp + oc * CD, Dp, nq, scale, sqo);
        stage_f32_chunk(gb + q0 * Dp + oc * CD, Dp, nq, 1.f, sgo);
        for (int i = threadIdx.x; i < U; i += W_THREADS) {
          s_lse[i] = i < nq ? lse[q_base + q0 + i] : 0.f;
          s_delta[i] = i < nq ? delta[q_base + q0 + i] : 0.f;
        }
      }
      __syncthreads();
      add_dots(k + k_row * Dp + c * CD, live, 1.f, sq, h, s);
      add_dots(v + k_row * Dp + c * CD, live, 1.f, sg, h, dp);
    }
#pragma unroll
    for (int i = 0; i < U; ++i) {
      s[i] = row_sum<W_TPR>(s[i]);
      dp[i] = row_sum<W_TPR>(dp[i]);
      // query rows past Tq are masked out of p
      const float p = i < nq ? expf(s[i] - s_lse[i]) : 0.f;
      s[i] = p;
      dp[i] = p * (dp[i] - s_delta[i]);  // ds
    }
#pragma unroll
    for (int i = 0; i < U; ++i) {
      axpy_slice<W_DPT, W_TPR>(s[i], sgo + i * CD, h, dv_acc);
      axpy_slice<W_DPT, W_TPR>(dp[i], sqo + i * CD, h, dk_acc);
    }
  }
  if (live) {
    store_slice<W_DPT, W_TPR>(dk_acc, 1.f, h, dk + k_row * Dp + oc * CD);
    store_slice<W_DPT, W_TPR>(dv_acc, 1.f, h, dv + k_row * Dp + oc * CD);
  }
}

// Dynamic shared memory of the wide tensor-core kernels: `slots` staged
// [64 x 128] chunks a stage, two stages; dk/dv's stages hold two 64-row
// chunks and four 32-row ones, then the two stages' lse and delta.
constexpr int wide_smem_bytes(int slots) {
  return 2 * slots * WUNIT * static_cast<int>(sizeof(bf16));
}
constexpr int wide_dkdv_smem_bytes() {
  return 2 * (2 * WUNIT + 4 * DKDV_WTILE * WPITCH) *
             static_cast<int>(sizeof(bf16)) +
         2 * 2 * DKDV_WTILE * 4;
}

// The resident kernels' launches: dq and dk/dv one block for 64 rows, 8
// warps; the forward one block for FwdPlan<NC>::BLOCK_ROWS rows, three
// warpgroups.
static_assert(RESIDENT_MAX_NC == 3, "the launchers take NC = 2 and 3");
static_assert(NARROW_SMEM <= 232448,
              "the wgmma gradient kernels' shared memory passes an H100 "
              "block's");
static_assert(2 * (NARROW_FWD_SMEM + 1024) <= 233472,
              "two blocks of the wgmma forward pass an H100 SM's shared "
              "memory (with the 1 KB it keeps for each block)");
static_assert(resident_smem_bytes<RESIDENT_MAX_NC>(false) <= 232448 &&
                  resident_smem_bytes<RESIDENT_MAX_NC>(true) <= 232448 &&
                  FwdPlan<2>::SMEM <= 232448 &&
                  FwdPlan<RESIDENT_MAX_NC>::SMEM <= 232448,
              "the resident kernels' shared memory passes an H100 block's");

// cuTensorMapEncodeTiled, the driver's, taken through the runtime (the
// library links no libcuda); null where the driver does not give it.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled driver_encode_tiled() {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  const cudaError_t err = cudaGetDriverEntryPointByVersion(
      "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
  const cudaError_t err = cudaGetDriverEntryPoint(
      "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
  return err == cudaSuccess && found == cudaDriverEntryPointSuccess
             ? reinterpret_cast<EncodeTiled>(fn)
             : nullptr;
}

// The tensor map of the contiguous bf16 [BH, rows, D] at base for
// attn_fwd_wide_mma_kernel and the wgmma gradient kernels: boxes of 64 dims
// x 64 rows x 1, 128-byte swizzle, zeros past each extent (so a box never
// reaches the next head, and at D = 80 the second box of a row holds 16
// real dims and 48 zeros).
cudaError_t rows_tensor_map(CUtensorMap* map, const void* base, int BH,
                            int rows, int D) {
  static const EncodeTiled encode = driver_encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {  // bytes, of dims 1 and 2
      static_cast<cuuint64_t>(D) * sizeof(bf16),
      static_cast<cuuint64_t>(rows) * D * sizeof(bf16)};
  const cuuint32_t box[3] = {SLAB, TILE, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int NC>
cudaError_t launch_fwd_resident(const void* q, const void* k, const void* v,
                                void* out, void* lse, int BH, int Tq, int Tk,
                                float scale, cudaStream_t stream) {
  constexpr int D = NC * CD, smem = FwdPlan<NC>::SMEM;
  CUtensorMap maps[3];
  const void* bases[3] = {q, k, v};
  const int rows[3] = {Tq, Tk, Tk};
  for (int i = 0; i < 3; ++i) {
    const cudaError_t err = rows_tensor_map(&maps[i], bases[i], BH, rows[i], D);
    if (err != cudaSuccess) return err;
  }
  const int tiles = (Tq + FwdPlan<NC>::BLOCK_ROWS - 1) / FwdPlan<NC>::BLOCK_ROWS;
  const cudaError_t err = allow_smem(attn_fwd_wide_mma_kernel<NC>, smem);
  if (err != cudaSuccess) return err;
  attn_fwd_wide_mma_kernel<NC><<<BH * tiles, FWD_THREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<bf16*>(out),
      static_cast<float*>(lse), Tq, Tk, tiles, scale);
  return cudaGetLastError();
}

template <int NC>
cudaError_t launch_dq_resident(const void* q, const void* k, const void* v,
                               const void* g, const void* lse,
                               const void* delta, void* dq, int BH, int Tq,
                               int Tk, float scale, cudaStream_t stream) {
  const int tiles = tiles_of(Tq);
  constexpr int smem = resident_smem_bytes<NC>(false);
  const cudaError_t err = allow_smem(attn_dq_wide_mma_kernel<NC>, smem);
  if (err != cudaSuccess) return err;
  attn_dq_wide_mma_kernel<NC><<<BH * tiles, RES_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), Tq, Tk, tiles, scale);
  return cudaGetLastError();
}

template <int NC>
cudaError_t launch_dkdv_resident(const void* q, const void* k, const void* v,
                                 const void* g, const void* lse,
                                 const void* delta, void* dk, void* dv,
                                 int BH, int Tq, int Tk, float scale,
                                 cudaStream_t stream) {
  const int tiles = tiles_of(Tk);
  constexpr int smem = resident_smem_bytes<NC>(true);
  const cudaError_t err = allow_smem(attn_dkdv_wide_mma_kernel<NC>, smem);
  if (err != cudaSuccess) return err;
  attn_dkdv_wide_mma_kernel<NC><<<BH * tiles, RES_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), Tq, Tk, tiles, scale);
  return cudaGetLastError();
}

// The tensor maps of q, k, v and g for the wgmma gradient kernels.
cudaError_t narrow_tensor_maps(CUtensorMap (&maps)[4], const void* q,
                               const void* k, const void* v, const void* g,
                               int BH, int Tq, int Tk, int D) {
  const void* bases[4] = {q, k, v, g};
  const int rows[4] = {Tq, Tk, Tk, Tq};
  for (int i = 0; i < 4; ++i) {
    const cudaError_t err = rows_tensor_map(&maps[i], bases[i], BH, rows[i], D);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <int D>
cudaError_t launch_fwd_wgmma(const void* q, const void* k, const void* v,
                             void* out, void* lse, int BH, int Tq, int Tk,
                             float scale, cudaStream_t stream) {
  CUtensorMap maps[3];
  const void* bases[3] = {q, k, v};
  const int rows[3] = {Tq, Tk, Tk};
  for (int i = 0; i < 3; ++i) {
    const cudaError_t err = rows_tensor_map(&maps[i], bases[i], BH, rows[i], D);
    if (err != cudaSuccess) return err;
  }
  const cudaError_t err = allow_smem(attn_fwd_wgmma_kernel<D>, NARROW_FWD_SMEM);
  if (err != cudaSuccess) return err;
  const int tiles = (Tq + NARROW_ROWS - 1) / NARROW_ROWS;
  attn_fwd_wgmma_kernel<D><<<BH * tiles, NARROW_THREADS, NARROW_FWD_SMEM,
                             stream>>>(
      maps[0], maps[1], maps[2], static_cast<bf16*>(out),
      static_cast<float*>(lse), Tq, Tk, tiles, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_wgmma(const void* q, const void* k, const void* v,
                            const void* g, const void* lse, const void* delta,
                            void* dq, int BH, int Tq, int Tk, float scale,
                            cudaStream_t stream) {
  CUtensorMap maps[4];
  cudaError_t err = narrow_tensor_maps(maps, q, k, v, g, BH, Tq, Tk, D);
  if (err != cudaSuccess) return err;
  err = allow_smem(attn_dq_wgmma_kernel<D>, NARROW_SMEM);
  if (err != cudaSuccess) return err;
  const int tiles = (Tq + NARROW_ROWS - 1) / NARROW_ROWS;
  attn_dq_wgmma_kernel<D><<<BH * tiles, NARROW_THREADS, NARROW_SMEM,
                            stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), Tq, Tk, tiles,
      scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkdv_wgmma(const void* q, const void* k, const void* v,
                              const void* g, const void* lse,
                              const void* delta, void* dk, void* dv, int BH,
                              int Tq, int Tk, float scale,
                              cudaStream_t stream) {
  CUtensorMap maps[4];
  cudaError_t err = narrow_tensor_maps(maps, q, k, v, g, BH, Tq, Tk, D);
  if (err != cudaSuccess) return err;
  err = allow_smem(attn_dkdv_wgmma_kernel<D>, NARROW_SMEM);
  if (err != cudaSuccess) return err;
  const int tiles = (Tk + NARROW_ROWS - 1) / NARROW_ROWS;
  attn_dkdv_wgmma_kernel<D><<<BH * tiles, NARROW_THREADS, NARROW_SMEM,
                              stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), Tq, Tk, tiles, scale);
  return cudaGetLastError();
}

// Blocks an SM of `kernel` launched with `threads` and `smem` bytes of
// dynamic shared memory (after the opt-in its launch makes).
template <typename Kernel>
cudaError_t occupancy(Kernel* kernel, int threads, int smem, int* blocks) {
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                       threads, smem);
}

// The wide launchers take launch_fwd's, launch_dq's and launch_dkdv's
// arguments, then the chunks nc and the dtype (bf: bfloat16). In bf16 the
// forward, dq and dk/dv take the resident kernels up to RESIDENT_MAX_NC
// chunks (their rows at D = 512 would pass a block's shared memory) and
// the chunked ones past it; float32 takes the chunked kernels. Each is a
// route chosen by shape: a failed map, opt-in or launch is returned.
cudaError_t launch_fwd_wide(const void* q, const void* k, const void* v,
                            void* out, void* lse, int BH, int Tq, int Tk,
                            float scale, cudaStream_t stream, int nc,
                            bool bf) {
  const int tiles = tiles_of(Tq);
  const dim3 grid(BH * tiles, nc);
  if (bf && nc == 2)
    return launch_fwd_resident<2>(q, k, v, out, lse, BH, Tq, Tk, scale,
                                  stream);
  if (bf && nc == 3)
    return launch_fwd_resident<3>(q, k, v, out, lse, BH, Tq, Tk, scale,
                                  stream);
  if (bf) {
    constexpr int smem = wide_smem_bytes(3);
    const cudaError_t err = allow_smem(attn_fwd_wide_chunked_mma_kernel, smem);
    if (err != cudaSuccess) return err;
    attn_fwd_wide_chunked_mma_kernel<<<grid, MMA_THREADS, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(out),
        static_cast<float*>(lse), Tq, Tk, tiles, nc, scale);
  } else {
    attn_fwd_wide_kernel<<<grid, W_THREADS, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out),
        static_cast<float*>(lse), Tq, Tk, tiles, nc, scale);
  }
  return cudaGetLastError();
}

cudaError_t launch_dq_wide(const void* q, const void* k, const void* v,
                           const void* g, const void* lse, const void* delta,
                           void* dq, int BH, int Tq, int Tk, float scale,
                           cudaStream_t stream, int nc, bool bf) {
  const int tiles = tiles_of(Tq);
  const dim3 grid(BH * tiles, nc);
  const float* row_lse = static_cast<const float*>(lse);
  const float* row_delta = static_cast<const float*>(delta);
  if (bf && nc == 2)
    return launch_dq_resident<2>(q, k, v, g, lse, delta, dq, BH, Tq, Tk,
                                 scale, stream);
  if (bf && nc == 3)
    return launch_dq_resident<3>(q, k, v, g, lse, delta, dq, BH, Tq, Tk,
                                 scale, stream);
  if (bf) {
    constexpr int smem = wide_smem_bytes(5);
    const cudaError_t err = allow_smem(attn_dq_wide_chunked_mma_kernel, smem);
    if (err != cudaSuccess) return err;
    attn_dq_wide_chunked_mma_kernel<<<grid, MMA_THREADS, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(g), row_lse,
        row_delta, static_cast<bf16*>(dq), Tq, Tk, tiles, nc, scale);
  } else {
    attn_dq_wide_kernel<<<grid, W_THREADS, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(g), row_lse,
        row_delta, static_cast<float*>(dq), Tq, Tk, tiles, nc, scale);
  }
  return cudaGetLastError();
}

cudaError_t launch_dkdv_wide(const void* q, const void* k, const void* v,
                             const void* g, const void* lse,
                             const void* delta, void* dk, void* dv, int BH,
                             int Tq, int Tk, float scale, cudaStream_t stream,
                             int nc, bool bf) {
  const int tiles = tiles_of(Tk);
  const dim3 grid(BH * tiles, nc);
  const float* row_lse = static_cast<const float*>(lse);
  const float* row_delta = static_cast<const float*>(delta);
  if (bf && nc == 2)
    return launch_dkdv_resident<2>(q, k, v, g, lse, delta, dk, dv, BH, Tq,
                                   Tk, scale, stream);
  if (bf && nc == 3)
    return launch_dkdv_resident<3>(q, k, v, g, lse, delta, dk, dv, BH, Tq,
                                   Tk, scale, stream);
  if (bf) {
    constexpr int smem = wide_dkdv_smem_bytes();
    const cudaError_t err =
        allow_smem(attn_dkdv_wide_chunked_mma_kernel, smem);
    if (err != cudaSuccess) return err;
    attn_dkdv_wide_chunked_mma_kernel<<<grid, MMA_THREADS, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(g), row_lse,
        row_delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), Tq, Tk,
        tiles, nc, scale);
  } else {
    attn_dkdv_wide_kernel<<<grid, W_THREADS, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(g), row_lse,
        row_delta, static_cast<float*>(dk), static_cast<float*>(dv), Tq, Tk,
        tiles, nc, scale);
  }
  return cudaGetLastError();
}

bool valid(int BH, int Tq, int Tk) { return BH > 0 && Tq > 0 && Tk > 0; }

}  // namespace

// One launcher for each (dtype, D) the kernels are built for, D = 32, 64, 80
// and 128 (the bfloat16 launchers take the tensor-core kernels), and the wide
// launchers for D = 128 nc, nc >= 2; any other D is refused with
// cudaErrorInvalidValue (the wrapper pads D to one of those before that).
#define ATTN_DISPATCH(LAUNCH, D, BF16, ...)                                 \
  do {                                                                      \
    cudaError_t err = cudaErrorInvalidValue;                                \
    if ((D) > CD && (D) % CD == 0)                                          \
      err = LAUNCH##_wide(__VA_ARGS__, (D) / CD, (BF16) != 0);              \
    else if ((D) == 32)                                                     \
      err = (BF16) ? LAUNCH<__nv_bfloat16, 32>(__VA_ARGS__)                 \
                   : LAUNCH<float, 32>(__VA_ARGS__);                        \
    else if ((D) == 64)                                                     \
      err = (BF16) ? LAUNCH<__nv_bfloat16, 64>(__VA_ARGS__)                 \
                   : LAUNCH<float, 64>(__VA_ARGS__);                        \
    else if ((D) == 80)                                                     \
      err = (BF16) ? LAUNCH<__nv_bfloat16, 80>(__VA_ARGS__)                 \
                   : LAUNCH<float, 80>(__VA_ARGS__);                        \
    else if ((D) == 128)                                                    \
      err = (BF16) ? LAUNCH<__nv_bfloat16, 128>(__VA_ARGS__)                \
                   : LAUNCH<float, 128>(__VA_ARGS__);                       \
    return static_cast<int>(err);                                           \
  } while (0)

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 = the
// launch was accepted). Pointers are device pointers of contiguous tensors:
// q, out, g and dq [BH, Tq, D]; k, v, dk and dv [BH, Tk, D], in bfloat16
// when bf16 is set, else float32; lse and delta [BH, Tq] float32.

int attention_fwd(const void* q, const void* k, const void* v, void* out,
                  void* lse, int BH, int Tq, int Tk, int D, int bf16,
                  float scale, void* stream) {
  if (!valid(BH, Tq, Tk)) return static_cast<int>(cudaErrorInvalidValue);
  ATTN_DISPATCH(launch_fwd, D, bf16, q, k, v, out, lse, BH, Tq, Tk, scale,
                static_cast<cudaStream_t>(stream));
}

int attention_dq(const void* q, const void* k, const void* v, const void* g,
                 const void* lse, const void* delta, void* dq, int BH, int Tq,
                 int Tk, int D, int bf16, float scale, void* stream) {
  if (!valid(BH, Tq, Tk)) return static_cast<int>(cudaErrorInvalidValue);
  ATTN_DISPATCH(launch_dq, D, bf16, q, k, v, g, lse, delta, dq, BH, Tq, Tk,
                scale, static_cast<cudaStream_t>(stream));
}

int attention_dkdv(const void* q, const void* k, const void* v,
                   const void* g, const void* lse, const void* delta,
                   void* dk, void* dv, int BH, int Tq, int Tk, int D,
                   int bf16, float scale, void* stream) {
  if (!valid(BH, Tq, Tk)) return static_cast<int>(cudaErrorInvalidValue);
  ATTN_DISPATCH(launch_dkdv, D, bf16, q, k, v, g, lse, delta, dk, dv, BH, Tq,
                Tk, scale, static_cast<cudaStream_t>(stream));
}

// Blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor) of the bf16
// wide kernel `kernel` (0 the forward, 1 dq, 2 dk/dv) that a launch at head
// dim D takes; *smem gets its dynamic shared memory in bytes.
int attention_wide_occupancy(int kernel, int D, int* blocks, int* smem) {
  if (D <= CD || D % CD != 0 || kernel < 0 || kernel > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nc = D / CD;
  const bool resident = nc <= RESIDENT_MAX_NC;
  cudaError_t err;
  if (!resident) {
    *smem = kernel == 0   ? wide_smem_bytes(3)
            : kernel == 1 ? wide_smem_bytes(5)
                          : wide_dkdv_smem_bytes();
    err = kernel == 0   ? occupancy(attn_fwd_wide_chunked_mma_kernel,
                                    MMA_THREADS, *smem, blocks)
          : kernel == 1 ? occupancy(attn_dq_wide_chunked_mma_kernel,
                                    MMA_THREADS, *smem, blocks)
                        : occupancy(attn_dkdv_wide_chunked_mma_kernel,
                                    MMA_THREADS, *smem, blocks);
  } else if (kernel == 0) {
    *smem = nc == 2 ? FwdPlan<2>::SMEM : FwdPlan<3>::SMEM;
    err = nc == 2 ? occupancy(attn_fwd_wide_mma_kernel<2>, FWD_THREADS,
                              *smem, blocks)
                  : occupancy(attn_fwd_wide_mma_kernel<3>, FWD_THREADS,
                              *smem, blocks);
  } else if (nc == 2) {
    *smem = resident_smem_bytes<2>(kernel == 2);
    err = kernel == 1 ? occupancy(attn_dq_wide_mma_kernel<2>, RES_THREADS,
                                  *smem, blocks)
                      : occupancy(attn_dkdv_wide_mma_kernel<2>, RES_THREADS,
                                  *smem, blocks);
  } else {
    *smem = resident_smem_bytes<3>(kernel == 2);
    err = kernel == 1 ? occupancy(attn_dq_wide_mma_kernel<3>, RES_THREADS,
                                  *smem, blocks)
                      : occupancy(attn_dkdv_wide_mma_kernel<3>, RES_THREADS,
                                  *smem, blocks);
  }
  return static_cast<int>(err);
}

// The same for the bf16 forward at D = 80 and 128, attn_fwd_wgmma_kernel.
int attention_fwd_wgmma_occupancy(int D, int* blocks, int* smem) {
  if (D != 80 && D != 128) return static_cast<int>(cudaErrorInvalidValue);
  *smem = NARROW_FWD_SMEM;
  return static_cast<int>(
      D == 80 ? occupancy(attn_fwd_wgmma_kernel<80>, NARROW_THREADS, *smem,
                          blocks)
              : occupancy(attn_fwd_wgmma_kernel<128>, NARROW_THREADS, *smem,
                          blocks));
}

const char* attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
