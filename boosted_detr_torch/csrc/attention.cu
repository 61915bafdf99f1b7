// Fused attention (K3) for Hopper (sm_90a): the forward with its per-row
// log-sum-exp, and the two kernels of its gradient.
//
// Replaces the Pallas TPU kernels of boosted_detr_tpu/ops/pallas_attention.py:
//   attn_fwd_kernel  <- _attention_kernel (:45-80), called by
//                       _fused_attention_fwd_impl (:97-135, call :112);
//   attn_dq_kernel   <- _dq_kernel (:138-163), called by
//                       _fused_attention_bwd_impl (:202-255, call :233);
//   attn_dkdv_kernel <- _dkdv_kernel (:166-199), same function, call :257.
// q is [BH, Tq, D], k and v [BH, Tk, D], contiguous, all float32 or all
// bfloat16, with no mask; D is 32 or 64. The arithmetic is the TPU
// kernels':
//   - q, k and v are read in their dtype and widened to float32;
//   - qs = q * scale (scale = 1/sqrt(D)) is formed before the dot;
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
// 42 us. Operations bound all three. This first version multiplies in
// float32 on the CUDA cores, whose peak (67 TFLOP/s) puts a floor ~15x
// above that bound; tensor cores (mma.sync or wgmma on bf16 tiles), TMA
// and warp specialisation are the later steps toward it.
//
// Design, the same for the three kernels:
//   - a block owns 64 rows (query rows for the forward and dq, key rows for
//     dk/dv) and keeps their float32 slices in registers: each thread owns
//     DPT of the D dims of one row, TPR = D / DPT neighbouring lanes share a
//     row, and a dot product is summed over them with xor shuffles;
//   - the other operand streams through shared memory in tiles of 64 rows,
//     widened to float32 (rows past the end zero-filled); all threads read
//     the same staged row at a time, in float4 chunks that the TPR threads
//     of a row take side by side, so the reads broadcast without bank
//     conflicts;
//   - the forward takes keys 16 at a time: one max, one exp of the old max
//     and one rescale of the accumulator per chunk, as the TPU kernel does
//     per 512-key block; dq and dk/dv take 4 rows at a time (chunks of 8
//     spilled registers to local memory);
//   - the gradient is two kernels, as on the TPU: dq streams over key tiles
//     and dk/dv over query tiles, so that every sum belongs to one thread
//     and runs in a fixed order, with no atomics;
//   - keys past Tk and query rows past Tq are masked (never summed) where
//     the TPU padded T to its 256/512 blocks and D to 128 lanes, and the
//     lse is one float32 per row where the TPU kept a lane-replicated
//     [Tq_pad, 128] tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 64;  // rows a block owns
constexpr int TILE = 64;  // rows of the other operand staged per step
constexpr float NEG = -1e30f;
constexpr float FLOOR = 1e-30f;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void narrow(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void narrow(float v, __nv_bfloat16* dst) {
  *dst = __float2bfloat16_rn(v);
}

// The row dim of element e of the DPT-dim slice that thread h of a row
// owns: the slice is DPT / 4 chunks of 4 dims, and its chunk c is chunk
// c * TPR + h of the row.
template <int DPT, int TPR>
__device__ __forceinline__ int dim_of(int e, int h) {
  return 4 * ((e / 4) * TPR + h) + (e % 4);
}

// x = the slice of `row` times mul, widened to float32; zeros when !live.
template <int DPT, int TPR, typename T>
__device__ __forceinline__ void load_slice(const T* row, int h, bool live,
                                           float mul, float (&x)[DPT]) {
#pragma unroll
  for (int e = 0; e < DPT; ++e)
    x[e] = live ? widen(row[dim_of<DPT, TPR>(e, h)]) * mul : 0.f;
}

template <int DPT, int TPR, typename T>
__device__ __forceinline__ void store_slice(const float (&x)[DPT], float mul,
                                            int h, T* row) {
#pragma unroll
  for (int e = 0; e < DPT; ++e) narrow(x[e] * mul, row + dim_of<DPT, TPR>(e, h));
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

// Stages rows [0, n) of the [*, D] rows at src into dst as float32 times
// mul, and zeros for rows [n, TILE).
template <int D, int NT, typename T>
__device__ __forceinline__ void stage(const T* src, int n, float mul,
                                      float* dst) {
  for (int e = threadIdx.x; e < TILE * D; e += NT)
    dst[e] = e < n * D ? widen(src[e]) * mul : 0.f;
}

template <typename T, int DPT, int TPR>
__global__ void __launch_bounds__(ROWS * TPR)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, T* __restrict__ out,
                float* __restrict__ lse, int Tq, int Tk, int tiles,
                float scale) {
  constexpr int D = DPT * TPR;
  constexpr int NT = ROWS * TPR;
  constexpr int CHUNK = 16;
  __shared__ __align__(16) float sk[TILE * D];
  __shared__ __align__(16) float sv[TILE * D];
  const int bh = blockIdx.x / tiles;
  const int row = (blockIdx.x % tiles) * ROWS + threadIdx.x / TPR;
  const int h = threadIdx.x % TPR;
  const bool live = row < Tq;
  const long long q_row = (static_cast<long long>(bh) * Tq + row) * D;
  const T* kb = k + static_cast<long long>(bh) * Tk * D;
  const T* vb = v + static_cast<long long>(bh) * Tk * D;

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
      narrow(acc[e] / d, out + q_row + dim_of<DPT, TPR>(e, h));
    if (h == 0) lse[static_cast<long long>(bh) * Tq + row] = m + logf(d);
  }
}

template <typename T, int DPT, int TPR>
__global__ void __launch_bounds__(ROWS * TPR)
attn_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ g,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dq, int Tq, int Tk, int tiles, float scale) {
  constexpr int D = DPT * TPR;
  constexpr int NT = ROWS * TPR;
  constexpr int CHUNK = 4;
  __shared__ __align__(16) float sk[TILE * D];
  __shared__ __align__(16) float sv[TILE * D];
  const int bh = blockIdx.x / tiles;
  const int row = (blockIdx.x % tiles) * ROWS + threadIdx.x / TPR;
  const int h = threadIdx.x % TPR;
  const bool live = row < Tq;
  const long long q_row = (static_cast<long long>(bh) * Tq + row) * D;
  const long long r_row = static_cast<long long>(bh) * Tq + row;
  const T* kb = k + static_cast<long long>(bh) * Tk * D;
  const T* vb = v + static_cast<long long>(bh) * Tk * D;

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

template <typename T, int DPT, int TPR>
__global__ void __launch_bounds__(ROWS * TPR)
attn_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ g,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, int Tq, int Tk, int tiles, float scale) {
  constexpr int D = DPT * TPR;
  constexpr int NT = ROWS * TPR;
  constexpr int CHUNK = 4;
  __shared__ __align__(16) float sq[TILE * D];  // qs = q * scale
  __shared__ __align__(16) float sg[TILE * D];  // dO
  __shared__ float s_lse[TILE], s_delta[TILE];
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

// Dims a thread owns: 32 in the forward and dq (one exp per row and key
// per thread), 16 in dk/dv, which holds four row slices (k, v and both
// sums) in registers.
constexpr int DPT_FWD = 32;
constexpr int DPT_DQ = 32;
constexpr int DPT_DKDV = 16;

int tiles_of(int rows) { return (rows + ROWS - 1) / ROWS; }

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       void* out, void* lse, int BH, int Tq, int Tk,
                       float scale, cudaStream_t stream) {
  constexpr int TPR = D / DPT_FWD;
  const int tiles = tiles_of(Tq);
  attn_fwd_kernel<T, DPT_FWD, TPR><<<BH * tiles, ROWS * TPR, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), Tq, Tk, tiles, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* g, const void* lse, const void* delta,
                      void* dq, int BH, int Tq, int Tk, float scale,
                      cudaStream_t stream) {
  constexpr int TPR = D / DPT_DQ;
  const int tiles = tiles_of(Tq);
  attn_dq_kernel<T, DPT_DQ, TPR><<<BH * tiles, ROWS * TPR, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), Tq, Tk, tiles, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkdv(const void* q, const void* k, const void* v,
                        const void* g, const void* lse, const void* delta,
                        void* dk, void* dv, int BH, int Tq, int Tk,
                        float scale, cudaStream_t stream) {
  constexpr int TPR = D / DPT_DKDV;
  const int tiles = tiles_of(Tk);
  attn_dkdv_kernel<T, DPT_DKDV, TPR><<<BH * tiles, ROWS * TPR, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), Tq, Tk, tiles, scale);
  return cudaGetLastError();
}

bool valid(int BH, int Tq, int Tk) { return BH > 0 && Tq > 0 && Tk > 0; }

}  // namespace

// One launcher for each (dtype, D) the kernels are built for; any other D
// is refused with cudaErrorInvalidValue (the wrapper raises before that).
#define ATTN_DISPATCH(LAUNCH, D, BF16, ...)                                 \
  do {                                                                      \
    cudaError_t err = cudaErrorInvalidValue;                                \
    if ((D) == 32)                                                          \
      err = (BF16) ? LAUNCH<__nv_bfloat16, 32>(__VA_ARGS__)                 \
                   : LAUNCH<float, 32>(__VA_ARGS__);                        \
    else if ((D) == 64)                                                     \
      err = (BF16) ? LAUNCH<__nv_bfloat16, 64>(__VA_ARGS__)                 \
                   : LAUNCH<float, 64>(__VA_ARGS__);                        \
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

const char* attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
