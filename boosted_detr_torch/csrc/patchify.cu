// Patchify-stem convolution forward for Hopper (sm_90a): clip, convert,
// space-to-depth and matrix product in one pass over the image.
//
// Replaces the Pallas TPU kernel _fwd_kernel / _fwd_impl of
// boosted_detr_tpu/ops/pallas_patchify.py (:83-92, :122-149). It computes
//
//   out[b, ho, wo, n] = sum_{di, dj, c} r(clip(x[b, ho*P+di-pt, wo*P+dj-pl, c]))
//                                       * w[di, dj, c, n]
//
// for an NHWC float32 image x [B, H, W, C] and an HWIO kernel w [P, P, C, N]
// (float32 or bfloat16): clip is the optional [0, 1] clamp, r rounds to the
// kernel's dtype, the sum is taken in float32 and the result is written in
// the output dtype (float32 or bfloat16). Positions outside the image are
// zero: (pt, pl) is XLA's SAME padding for stride == kernel == P, so a
// geometry that P does not divide gives the SAME-padded convolution that
// the JAX package computes with an ordinary conv in that case.
//
// Bound on an H100 SXM at the flagship shape (x f32 [8, 640, 640, 3],
// w bf16 [8, 8, 3, 128], out bf16 [8, 80, 80, 128]; M = 51200 output
// positions, K = 192, N = 128): it must read 39.3 MB of image and write
// 13.1 MB of output, about 15.7 us at 3.35 TB/s, while its 2.52 GFLOP take
// about 2.5 us at the 989 TFLOP/s bf16 tensor-core rate. Memory bytes bound
// it, at the ViT patch embed too (P = 16 -> 384: 49.7 MB, 14.8 us, against
// 7.55 GFLOP, 7.6 us).
//
// Two kernels. patchify_fwd_mma_kernel (further down, with its design)
// takes bfloat16 weights on the tensor cores where the patch divides the
// image, P*C is a multiple of 8, K of 16 and N of 8: the three shapes the
// models run. patchify_fwd_kernel, the first version, keeps everything
// else: float32 weights (tensor cores would make them TF32), other patch
// sizes (the P = 4 stem) and SAME-padded geometries.
//
// patchify_fwd_kernel: one thread block per output row (b, ho), per slice
// of BN output channels (blockIdx.y; BN = N up to 128, smaller when shared
// memory requires it) and per span of the row's positions (blockIdx.z: the
// whole row where it fits, fwd_span_plan in ops/patchify.py). The block
//   1. reads the span's part of its P image rows, which is contiguous in
//      NHWC (P*W*C float32 for a whole row, 61 KB at the flagship), clips
//      it, rounds it to the kernel's dtype and stages it in shared memory as
//      float32 (exact), with SAME padding written as zeros;
//   2. stages the kernel slice [P*P*C, BN] in shared memory in its own dtype
//      (48 KB bf16 at the flagship);
//   3. lets every thread accumulate 4 positions x 4 channels in float32 by
//      FMA on the CUDA cores: the patch of position wo is, for each di, the
//      P*C contiguous values at row di, column wo*P*C, so space-to-depth is
//      only an offset.
// Each image byte is read from device memory once per channel slice, each
// output byte written once; the weights are re-read from L2 by every block.
// The host computes the shared memory from the geometry (ops/patchify.py):
// where P whole rows and the kernel slice pass the 227 KB a block may use
// even at 4 channels (P = 16 at W = 4096: 786 KB of rows; P = 4 at W = 8192:
// 393 KB), the block takes a span of the row's positions instead, the
// longest that fits beside a slice of up to 128 channels. Each output sums
// the same products in the same order on every cut.

#include <type_traits>

#include "mma.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TM = 4;  // positions per thread per pass
constexpr int TN = 4;  // channels per thread

__device__ __forceinline__ float round_to(float v, float) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void load4(const float* src, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(src);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* src, float* v) {
  const uint2 q = *reinterpret_cast<const uint2*>(src);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}

__device__ __forceinline__ void store4(float* dst, const float* v) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, const float* v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 packed;
  packed.x = *reinterpret_cast<unsigned int*>(&lo);
  packed.y = *reinterpret_cast<unsigned int*>(&hi);
  *reinterpret_cast<uint2*>(dst) = packed;
}
__device__ __forceinline__ void store1(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16_rn(v);
}

// Stages values [e0, e0 + row) of the SAME-padded image row h of image b
// into dst[0, row) as float32: clipped to [0, 1] when clip01, rounded to
// WT, with SAME padding (rows outside the image, columns before pad_left
// and past the image) as zeros. Every thread of the block takes part.
template <typename WT>
__device__ __forceinline__ void stage_image_row(
    float* dst, const float* __restrict__ x, int b, int h, int H, int W,
    int C, int e0, int row, int pad_left, int clip01, int vec4, WT wzero) {
  const int tid = threadIdx.x;
  if (h < 0 || h >= H) {
    for (int e = tid; e < row; e += THREADS) dst[e] = 0.f;
    return;
  }
  const float* src = x + (static_cast<long long>(b) * H + h) * W * C + e0;
  if (vec4) {  // no horizontal padding, e0 and row multiples of 4, aligned
    for (int e = 4 * tid; e < row; e += 4 * THREADS) {
      float v[4];
      const float4 q = __ldg(reinterpret_cast<const float4*>(src + e));
      v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // written so that NaN passes through, as torch.clamp and jnp.clip do
        if (clip01) v[i] = v[i] < 0.f ? 0.f : (v[i] > 1.f ? 1.f : v[i]);
        v[i] = round_to(v[i], wzero);
      }
      store4(dst + e, v);
    }
  } else {
    const int lo = pad_left * C - e0, hi = lo + W * C;
    for (int e = tid; e < row; e += THREADS) {
      float v = 0.f;
      if (e >= lo && e < hi) {
        v = __ldg(src + (e - pad_left * C));
        if (clip01) v = v < 0.f ? 0.f : (v > 1.f ? 1.f : v);
        v = round_to(v, wzero);
      }
      dst[e] = v;
    }
  }
}

// Shared memory: the image rows img [P][row] as float32, row = span*P*C
// (span positions of the row), then the kernel slice ws [K][bn] in WT,
// 16-byte aligned.
__host__ __device__ inline long long image_bytes(int P, int span, int C) {
  return (static_cast<long long>(P) * span * P * C * 4 + 15) / 16 * 16;
}

template <typename WT, typename OT>
__global__ void __launch_bounds__(THREADS)
patchify_fwd_kernel(const float* __restrict__ x, const WT* __restrict__ w,
                    OT* __restrict__ out, int H, int W, int C, int P, int N,
                    int Ho, int Wo, int pad_top, int pad_left, int bn,
                    int span, int clip01, int vec4) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int PC = P * C;
  const int K = P * PC;
  const int w0 = blockIdx.z * span;          // the span's first position
  const int positions = min(span, Wo - w0);  // and its positions
  const int row = positions * PC;  // the span's part of a padded row
  float* img = reinterpret_cast<float*>(smem);
  WT* ws = reinterpret_cast<WT*>(smem + image_bytes(P, span, C));

  const int tid = threadIdx.x;
  const int b = blockIdx.x / Ho;
  const int ho = blockIdx.x - b * Ho;
  const int n0 = blockIdx.y * bn;
  const WT wzero = WT(0.f);

  // 1. Image rows: clip, round to WT, SAME padding as zeros.
  for (int di = 0; di < P; ++di)
    stage_image_row(img + di * row, x, b, ho * P + di - pad_top, H, W, C,
                    w0 * PC, row, pad_left, clip01, vec4, wzero);

  // 2. Kernel slice [K, bn]; channels past N are zero.
  for (int e = tid; e < K * bn; e += THREADS) {
    const int k = e / bn;
    const int j = e - k * bn;
    const int n = n0 + j;
    ws[e] = n < N ? w[static_cast<long long>(k) * N + n] : wzero;
  }
  __syncthreads();

  // 3. Each thread: channels j0..j0+3 of the slice, positions wo = wb +
  //    i*rg for i < TM, one pass after another over the row.
  const int groups = bn / TN;  // bn is a power of two >= TN, so this divides
  const int rg = THREADS / groups;
  const int j0 = (tid % groups) * TN;
  const int ty = tid / groups;
  OT* out_row =
      out + ((static_cast<long long>(b) * Ho + ho) * Wo + w0) * N;
  const bool vec_out = (N % TN == 0) && (n0 + j0 + TN <= N);

  // wo counts the span's positions
  for (int wb = ty; wb < positions; wb += TM * rg) {
    int base[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int wo = wb + i * rg;
      // out-of-span positions are not stored
      base[i] = (wo < positions ? wo : 0) * PC;
    }
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int jj = 0; jj < TN; ++jj) acc[i][jj] = 0.f;

    for (int di = 0; di < P; ++di) {
      const float* a_row = img + di * row;
      const WT* w_rows = ws + static_cast<long long>(di) * PC * bn + j0;
      for (int r = 0; r < PC; ++r) {
        float wv[TN];
        load4(w_rows + r * bn, wv);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float a = a_row[base[i] + r];
#pragma unroll
          for (int jj = 0; jj < TN; ++jj)
            acc[i][jj] = fmaf(a, wv[jj], acc[i][jj]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int wo = wb + i * rg;
      if (wo >= positions) continue;
      OT* dst = out_row + static_cast<long long>(wo) * N + n0 + j0;
      if (vec_out) {
        store4(dst, acc[i]);
      } else {
#pragma unroll
        for (int jj = 0; jj < TN; ++jj)
          if (n0 + j0 + jj < N) store1(dst + jj, acc[i][jj]);
      }
    }
  }
}

template <typename WT, typename OT>
cudaError_t launch(const float* x, const void* w, void* out, int batch, int H,
                   int W, int C, int P, int N, int Ho, int Wo, int pad_top,
                   int pad_left, int bn, int span, int clip01, int vec4,
                   long long smem_bytes, cudaStream_t stream) {
  auto kernel = patchify_fwd_kernel<WT, OT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned int>(batch) * Ho, (N + bn - 1) / bn,
                  (Wo + span - 1) / span);
  kernel<<<grid, THREADS, static_cast<size_t>(smem_bytes), stream>>>(
      x, static_cast<const WT*>(w), static_cast<OT*>(out), H, W, C, P, N, Ho,
      Wo, pad_top, pad_left, bn, span, clip01, vec4);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// The forward on the tensor cores (bfloat16 weights).
//
// Every product is mma.sync.m16n8k16 on bf16 operands with float32 sums:
// bf16 x bf16 is exact in float32, so only the order of the sums differs
// from the plain version.
//   - A block takes up to 80 output positions (5 tiles of 16; 48 above 128
//     channels): R whole output rows (b, ho) where a row is short (Wo = 40
//     at the ViT patch embed leaves a ragged tile: masked, not padded), or a
//     segment of a long row (two of 80 at 1280 px). Its 8 warps split the
//     channels, 8 NB each (N = 128: 16, N = 384: 48), and each keeps the
//     float32 accumulators of all the block's positions for its channels in
//     registers (MT x NB x 4 a thread), so that the image is read from
//     device memory once for all N channels.
//   - k = (di, dj, c) runs in 8-value chunks, which lie side by side in one
//     image row when P*C is a multiple of 8 (so a chunk is 16 aligned bytes
//     once rounded to bf16), and in slabs of 48 k values: 6 chunks, 3 MMA
//     steps; one image row at P = 16, two at P = 8. The weights do not fit
//     beside the image at P = 16 -> 384 (590 KB), so both stream slab by
//     slab, two deep with cp.async: the float32 image rows of slab s + 1
//     (15 KB) and its [48, channels] weight rows (12 or 37 KB, from L2) load
//     while slab s multiplies.
//   - cp.async cannot clip or convert, so a slab's image rows land as they
//     are and one pass clips them, rounds them to bf16 and lays them out by
//     position, [m][chunk] with a pitch of 112 bytes: space-to-depth is that
//     pass's addressing. ldmatrix then reads A fragments with one row
//     address a lane, and the weight rows (pitch padded by 16 bytes) give B
//     fragments through ldmatrix.trans; with both pitches an odd number of
//     16-byte groups, the eight rows of an ldmatrix phase fall into eight
//     different bank groups.
//   - Each MMA step sums its 16 products from zero, and one float32 add
//     (rounded to nearest) puts them on the running sum. The tensor cores'
//     own additions truncate: with the running sum passed through them
//     for all K / 16 steps, the stem's outputs at each path's checked
//     train step (chip_smoke.py) rounded to another bf16 value than the
//     plain version's in 658 / 2,695 / 1,734 places (640 / 1280 / P = 16),
//     58-60% of them nearer zero; summed from zero, 414 / 1,641 / 664,
//     51-56% nearer zero (probes/loss_check_noise.py, H100 80GB HBM3 at
//     700 W; each path at its own trained state, which the change moves).
//   - Two __syncthreads a slab: after the first every thread's copies of
//     slab s have landed and every warp is done with slab s - 1; after the
//     second the patches are whole and the image rows' room is free for the
//     next copies.
//   - bf16 outputs go through shared memory (the weight slabs' room) and
//     leave in 16-byte stores; float32 outputs are stored from the
//     accumulators, 8 bytes a lane.
// What holds it at about a third of its bound at the stems: every block
// reads all the weights again from L2 (48 KB for 80 positions: at 1280 px
// 123 MB beside the 210 MB of image and output; blocks of 40 positions,
// twice the weight traffic, took 0.045 ms longer), and the short phases
// between barriers. At P = 16 -> 384 a block's 37 KB slabs and 128
// registers leave two blocks on an SM.

constexpr int SLAB = 48;               // k values of one pipeline step
constexpr int SLAB_CHUNKS = SLAB / 8;  // 8-value chunks of a slab
constexpr int A_PITCH = SLAB + 8;      // bf16 values: 112 bytes a position
constexpr int WARPS = THREADS / 32;

// Channels of a block and the pitch of a staged weight row (16 bytes of
// padding: eight rows fall into eight different 16-byte bank groups).
__host__ __device__ constexpr int mma_channels(int NB) { return WARPS * NB * 8; }
__host__ __device__ constexpr int mma_w_pitch(int NB) {
  return mma_channels(NB) + 8;
}

// The most image rows that one slab's chunks lie in.
__host__ __device__ inline int mma_slab_rows(int P, int C) {
  const int cpr = P * C / 8, chunks = P * cpr;
  int most = 1;
  for (int lo = 0; lo < chunks; lo += SLAB_CHUNKS) {
    const int hi = (lo + SLAB_CHUNKS < chunks ? lo + SLAB_CHUNKS : chunks) - 1;
    const int n = hi / cpr - lo / cpr + 1;
    most = n > most ? n : most;
  }
  return most;
}

// Shared memory: the slab's image rows as float32 [R][rows][seg * P * C], the
// slab's patches as bf16 [16 MT][A_PITCH], the weight slabs [2][SLAB][pitch],
// and two ints a position (where it starts in the image rows and in `out`).
__host__ __device__ inline long long mma_smem(int P, int C, int R, int seg,
                                              int MT, int NB) {
  return 4LL * R * mma_slab_rows(P, C) * seg * P * C +
         2LL * 16 * MT * A_PITCH + 2LL * 2 * SLAB * mma_w_pitch(NB) +
         2LL * 4 * 16 * MT;
}

__device__ __forceinline__ float clip_unit(float v) {
  // written so that NaN passes through, as torch.clamp and jnp.clip do
  return v < 0.f ? 0.f : (v > 1.f ? 1.f : v);
}

// A block takes R output rows (b, ho) by a segment of `seg` positions wo
// (blockIdx.y) and 64 NB channels (blockIdx.z): at most 16 MT positions.
// With 16 NB channels a warp, 5 tiles of positions fit into the 85 registers
// that leave three blocks on an SM; with 48 and 3 tiles (P = 16 -> 384),
// into the 128 that leave two; wider blocks take what they need.
template <int MT, int NB, typename OT>
__global__ void __launch_bounds__(THREADS, NB == 2 ? 3 : (MT <= 3 ? 2 : 1))
patchify_fwd_mma_kernel(const float* __restrict__ x, const bf16* __restrict__ w,
                        OT* __restrict__ out, int H, int W, int C, int P,
                        int N, int Ho, int Wo, int total_rows, int R, int seg,
                        int clip01) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int NBLK = mma_channels(NB);
  constexpr int W_PITCH = mma_w_pitch(NB);
  constexpr int PER_W_ROW = NBLK / 8;  // 16-byte pieces of a weight row
  const int PC = P * C, K = P * PC, cpr = PC / 8, chunks = K / 8;
  const int nr = mma_slab_rows(P, C);
  const int seg_vals = seg * PC;
  float* raw = reinterpret_cast<float*>(smem);
  bf16* as = reinterpret_cast<bf16*>(smem + 4LL * R * nr * seg_vals);
  bf16* ws = as + 16 * MT * A_PITCH;
  int* raw_at = reinterpret_cast<int*>(ws + 2 * SLAB * W_PITCH);
  int* out_at = raw_at + 16 * MT;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row0 = blockIdx.x * R;
  const int rows_live = min(R, total_rows - row0);
  const int wo0 = blockIdx.y * seg;
  const int wlen = min(seg, Wo - wo0);
  const int m_live = rows_live * wlen;
  const int n0 = blockIdx.z * NBLK;
  const int n_slabs = (K + SLAB - 1) / SLAB;

  // Position m of the block is position wo0 + m % wlen of output row
  // row0 + m / wlen: where its patch starts in the first staged image row,
  // and which of the [B * Ho * Wo] output positions it is; -1 past the
  // block's positions. (The divisions are taken once, here.)
  for (int m = tid; m < 16 * MT; m += THREADS) {
    const int r = m / wlen, wl = m - r * wlen;
    raw_at[m] = m < m_live ? r * nr * seg_vals + wl * PC : -1;
    out_at[m] = m < m_live ? (row0 + r) * Wo + wo0 + wl : -1;
  }

  // Starts the copies of slab s: the image rows its chunks lie in, as they
  // are (float32), and its weight rows (zeros past K and N).
  auto stage = [&](int s) {
    const int c_lo = s * SLAB_CHUNKS;
    const int c_hi = min(c_lo + SLAB_CHUNKS, chunks) - 1;
    const int di_lo = c_lo / cpr, n_di = c_hi / cpr - di_lo + 1;
    const int per_seg = wlen * PC / 4;  // 16-byte pieces of a row's segment
    for (int r = 0; r < rows_live; ++r) {
      const int b = (row0 + r) / Ho, ho = (row0 + r) - b * Ho;
      for (int dr = 0; dr < n_di; ++dr) {
        const long long h = static_cast<long long>(b) * H + ho * P + di_lo + dr;
        const float* src = x + (h * W + wo0 * P) * C;
        float* dst = raw + (r * nr + dr) * seg_vals;
        for (int piece = tid; piece < per_seg; piece += THREADS)
          copy_async<16>(dst + 4 * piece, src + 4 * piece, true);
      }
    }
    bf16* dst = ws + (s % 2) * SLAB * W_PITCH;
    for (int i = tid; i < SLAB * PER_W_ROW; i += THREADS) {
      const int kr = i / PER_W_ROW, col = (i % PER_W_ROW) * 8;
      const int k = s * SLAB + kr;
      const bool live = k < K && n0 + col < N;
      copy_async<16>(dst + kr * W_PITCH + col,
                     w + (live ? static_cast<long long>(k) * N + n0 + col : 0),
                     live);
    }
  };

  // Slab s of the staged image rows as patches: clipped, rounded to bf16,
  // 8 values (16 bytes) a store; zeros for positions past the block's.
  // Eight lanes a position, one a chunk (six of them work).
  auto convert = [&](int s) {
    const int c = tid % 8;
    const int ch = s * SLAB_CHUNKS + c;
    if (c >= SLAB_CHUNKS) return;
    const int di = ch / cpr, j = ch - di * cpr;
    const int chunk_at = (di - s * SLAB_CHUNKS / cpr) * seg_vals + 8 * j;
    for (int m = tid / 8; m < 16 * MT; m += THREADS / 8) {
      uint4 packed = make_uint4(0u, 0u, 0u, 0u);
      if (ch < chunks && raw_at[m] >= 0) {
        const float* src = raw + raw_at[m] + chunk_at;
        float4 a = *reinterpret_cast<const float4*>(src);
        float4 b = *reinterpret_cast<const float4*>(src + 4);
        if (clip01) {
          a = make_float4(clip_unit(a.x), clip_unit(a.y), clip_unit(a.z),
                          clip_unit(a.w));
          b = make_float4(clip_unit(b.x), clip_unit(b.y), clip_unit(b.z),
                          clip_unit(b.w));
        }
        packed = make_uint4(as_register(__floats2bfloat162_rn(a.x, a.y)),
                            as_register(__floats2bfloat162_rn(a.z, a.w)),
                            as_register(__floats2bfloat162_rn(b.x, b.y)),
                            as_register(__floats2bfloat162_rn(b.z, b.w)));
      }
      *reinterpret_cast<uint4*>(as + m * A_PITCH + 8 * c) = packed;
    }
  };

  float acc[MT][NB][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nb][e] = 0.f;

  stage(0);
  commit_copies();
  for (int s = 0; s < n_slabs; ++s) {
    wait_copies<0>();  // this thread's part of slab s has landed
    // every thread's part has, and every warp is done with slab s - 1
    __syncthreads();
    convert(s);
    __syncthreads();  // the patches are whole; the image rows are free
    if (s + 1 < n_slabs) {  // slab s + 1 loads while slab s multiplies
      stage(s + 1);
      commit_copies();
    }
    // this lane's ldmatrix rows: k row lane % 16 of the weights, channel
    // 8 (lane / 16) of a pair of 8-channel blocks; position lane % 16 of a
    // 16-position tile, chunk lane / 16 of a step's two
    const bf16* wt = ws + (s % 2) * SLAB * W_PITCH + (lane % 16) * W_PITCH +
                     warp * NB * 8 + 8 * (lane / 16);
    const bf16* at = as + (lane % 16) * A_PITCH + 8 * (lane / 16);
#pragma unroll
    for (int t = 0; t < SLAB / 16; ++t) {
      if (s * SLAB + 16 * t >= K) break;  // the same for every thread
      uint32_t b[NB / 2][4];
#pragma unroll
      for (int np = 0; np < NB / 2; ++np)
        ldmatrix_x4_trans(b[np], wt + 16 * t * W_PITCH + 16 * np);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (16 * mt >= m_live) break;
        uint32_t a[4];
        ldmatrix_x4(a, at + 16 * mt * A_PITCH + 16 * t);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          // the step's 16 products from zero, then one float32 add
          float part[4] = {0.f, 0.f, 0.f, 0.f};
          mma_bf16(part, a, b[nb / 2][2 * (nb % 2)],
                   b[nb / 2][2 * (nb % 2) + 1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nb][e] += part[e];
        }
      }
    }
  }

  // Accumulator (mt, nb): positions 16 mt + grp and + 8, channels
  // 8 (warp NB + nb) + 2 tig and + 1 of the block's.
  const int grp = lane / 4, tig = lane % 4;
  if constexpr (std::is_same_v<OT, float>) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = 16 * mt + grp + 8 * h;
        if (m >= m_live) continue;
        float* dst = out + static_cast<long long>(out_at[m]) * N + n0 +
                     warp * NB * 8 + 2 * tig;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
          if (n0 + warp * NB * 8 + 8 * nb < N)
            *reinterpret_cast<float2*>(dst + 8 * nb) =
                make_float2(acc[mt][nb][2 * h], acc[mt][nb][2 * h + 1]);
      }
  } else {
    // through shared memory (the weight slabs' room), for 16-byte stores
    __syncthreads();  // every warp is done with the last slab
    bf16* os = ws;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
          *reinterpret_cast<__nv_bfloat162*>(
              os + (16 * mt + grp + 8 * h) * W_PITCH + (warp * NB + nb) * 8 +
              2 * tig) =
              __floats2bfloat162_rn(acc[mt][nb][2 * h], acc[mt][nb][2 * h + 1]);
    __syncthreads();
    for (int i = tid; i < m_live * PER_W_ROW; i += THREADS) {
      const int m = i / PER_W_ROW, col = (i % PER_W_ROW) * 8;
      if (n0 + col < N)
        *reinterpret_cast<uint4*>(
            out + static_cast<long long>(out_at[m]) * N + n0 + col) =
            *reinterpret_cast<const uint4*>(os + m * W_PITCH + col);
    }
  }
}

template <int MT, int NB, typename OT>
cudaError_t launch_mma(const float* x, const void* w, void* out, int batch,
                       int H, int W, int C, int P, int N, int Ho, int Wo,
                       int R, int seg, int clip01, cudaStream_t stream) {
  auto kernel = patchify_fwd_mma_kernel<MT, NB, OT>;
  const long long smem = mma_smem(P, C, R, seg, MT, NB);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int total_rows = batch * Ho;
  const dim3 grid((total_rows + R - 1) / R, (Wo + seg - 1) / seg,
                  (N + mma_channels(NB) - 1) / mma_channels(NB));
  kernel<<<grid, THREADS, static_cast<size_t>(smem), stream>>>(
      x, static_cast<const bf16*>(w), static_cast<OT*>(out), H, W, C, P, N,
      Ho, Wo, total_rows, R, seg, clip01);
  return cudaGetLastError();
}

template <int MT, typename OT>
cudaError_t launch_mma_channels(int NB, const float* x, const void* w,
                                void* out, int batch, int H, int W, int C,
                                int P, int N, int Ho, int Wo, int R, int seg,
                                int clip01, cudaStream_t stream) {
  switch (NB) {
    case 2:
      return launch_mma<MT, 2, OT>(x, w, out, batch, H, W, C, P, N, Ho, Wo, R,
                                   seg, clip01, stream);
    case 6:
      return launch_mma<MT, 6, OT>(x, w, out, batch, H, W, C, P, N, Ho, Wo, R,
                                   seg, clip01, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename OT>
cudaError_t launch_mma_tiles(int MT, int NB, const float* x, const void* w,
                             void* out, int batch, int H, int W, int C, int P,
                             int N, int Ho, int Wo, int R, int seg, int clip01,
                             cudaStream_t stream) {
  switch (MT) {
    case 3:
      return launch_mma_channels<3, OT>(NB, x, w, out, batch, H, W, C, P, N,
                                        Ho, Wo, R, seg, clip01, stream);
    case 5:
      return launch_mma_channels<5, OT>(NB, x, w, out, batch, H, W, C, P, N,
                                        Ho, Wo, R, seg, clip01, stream);
  }
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Weight gradient (K1-dW).
//
// Replaces the Pallas TPU kernel _dw_kernel / _dw_impl of
// boosted_detr_tpu/ops/pallas_patchify.py (:95-113, :152-175), the weight
// half of the custom VJP (:178-206). It computes
//
//   dw[di, dj, c, n] = sum_{b, ho, wo} r(clip(x[b, ho*P+di-pt, wo*P+dj-pl, c]))
//                                      * r(g[b, ho, wo, n])
//
// with r the rounding to the weights' dtype, each product of the rounded
// values summed in float32, then cast to the weights' dtype; the float32
// sum is an output too. K = P*P*C rows (di, dj, c) by N columns.
//
// Bound on an H100 SXM at the flagship shape (x f32 [8, 640, 640, 3],
// g bf16 [8, 80, 80, 128], dw [192, 128]; M = 51200 positions): 39.3 MB of
// image and 13.1 MB of g read is about 15.6 us at 3.35 TB/s, against
// 2.5 GFLOP, about 2.5 us at the bf16 tensor-core rate. Memory bytes bound
// it, at the two other main shapes too: the 1280 stem (x [8, 1280, 1280,
// 3], g [8, 160, 160, 128]) reads 209.7 MB, 62.6 us, against 10 GFLOP,
// 10 us; the ViT patch embed (P = 16 -> 384, g [8, 40, 40, 384], dw
// [768, 384]) moves 50.9 MB, 15.2 us, against 7.55 GFLOP, 7.6 us.
//
// The TPU kernel carries one dW accumulator across its sequential grid;
// Hopper's blocks run in no order, so every route splits the reduction
// over M into deterministic passes with no atomics (bitwise repeatable).
// patchify_dw_mma_kernel (further down, with its design) takes bfloat16
// weights and g on the tensor cores under the forward's conditions (P
// divides the image, P*C a multiple of 8, K of 16, N of 8): the three
// shapes the models run. The first version keeps float32 weights (tensor
// cores would make the products TF32), the P = 4 stem and SAME-padded
// geometries:
//   1. patchify_dw_partial_kernel: block (chunk, k tile, n tile) sums the
//      positions of a chunk of output rows (b, ho) into a [BK, BN] float32
//      tile of its chunk's partial. For each row, one span of its positions
//      after another (the whole row where it fits), it stages the part of
//      the image rows that its k tile touches (the row of intra-patch
//      offset di is contiguous in NHWC, as in the forward: the gather is an
//      offset) and of the g row, both rounded, in shared memory; each
//      thread accumulates TK x TN outputs by FMA over the span's positions,
//      so every cut sums the row's positions in the same order.
//   2. patchify_partials_sum_kernel: each thread sums one (k, n) over the
//      chunks in chunk order and writes the float32 sum and its cast.
// The host sizes the chunks to give about two blocks per SM. Bytes: the
// image rows a k tile touches overlap the next tile's by up to one row, and
// the partials (7.9 MB at the flagship) are written and read once more.
// The products run on the CUDA cores. The span is the longest that fits
// in shared memory (dw_span_plan in ops/patchify.py): a whole row at the
// flagship, 213 of 256 positions at P = 16 and W = 4096.

constexpr int DW_TK = 4;                    // k values per thread
constexpr int DW_TN = 8;                    // n values per thread
constexpr int DW_BK = 16 * DW_TK;           // 64 k values per block tile
constexpr int DW_BN = 16 * DW_TN;           // 128 n values per block tile

__host__ __device__ inline int dw_rows_staged(int P, int C) {
  const int pc = P * C;
  const int rows = (DW_BK - 1) / pc + 2;  // a k tile spans at most this many
  return rows < P ? rows : P;
}

// The staged image rows of a span of positions, in floats, rounded up to
// whole 16-byte groups.
__host__ __device__ inline long long dw_image_floats(int P, int C, int span) {
  const long long n =
      static_cast<long long>(dw_rows_staged(P, C)) * span * P * C;
  return (n + 3) / 4 * 4;
}

__device__ __forceinline__ float load_as_float(const float* p) { return *p; }
__device__ __forceinline__ float load_as_float(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename WT, typename GT>
__global__ void __launch_bounds__(THREADS)
patchify_dw_partial_kernel(const float* __restrict__ x,
                           const GT* __restrict__ g,
                           float* __restrict__ partial, int batch, int H,
                           int W, int C, int P, int N, int Ho, int Wo,
                           int pad_top, int pad_left, int rows_per_chunk,
                           int span, int clip01, int vec4) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int row = span * P * C;  // a span's part of a padded row, in values
  const int PC = P * C;
  const int K = P * PC;
  float* img = reinterpret_cast<float*>(smem);   // [staged][row]
  float* gs = img + dw_image_floats(P, C, span);  // [span][DW_BN], aligned

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // n group
  const int ty = tid / 16;  // k group
  const int k0 = blockIdx.y * DW_BK;
  const int n0 = blockIdx.z * DW_BN;
  const int di_lo = k0 / PC;
  const int k_end = min(k0 + DW_BK, K);
  const int di_hi = (k_end - 1) / PC;  // inclusive
  const WT wzero = WT(0.f);

  // Offsets of this thread's k values in the staged rows; k past K reads
  // the zero at the start of a padded slot (valid flag clears it below).
  int off[DW_TK];
  bool k_ok[DW_TK];
#pragma unroll
  for (int t = 0; t < DW_TK; ++t) {
    const int k = k0 + ty * DW_TK + t;
    k_ok[t] = k < K;
    const int kk = k_ok[t] ? k : k0;
    const int di = kk / PC;
    off[t] = (di - di_lo) * row + (kk - di * PC);
  }

  float acc[DW_TK][DW_TN];
#pragma unroll
  for (int t = 0; t < DW_TK; ++t)
#pragma unroll
    for (int q = 0; q < DW_TN; ++q) acc[t][q] = 0.f;

  const int total_rows = batch * Ho;
  const int r_begin = blockIdx.x * rows_per_chunk;
  const int r_end = min(r_begin + rows_per_chunk, total_rows);
  for (int r = r_begin; r < r_end; ++r) {
    const int b = r / Ho;
    const int ho = r - b * Ho;
    for (int w0 = 0; w0 < Wo; w0 += span) {
      const int positions = min(span, Wo - w0);
      for (int di = di_lo; di <= di_hi; ++di)
        stage_image_row(img + (di - di_lo) * row, x, b, ho * P + di - pad_top,
                        H, W, C, w0 * PC, positions * PC, pad_left, clip01,
                        vec4, wzero);
      const GT* g_row = g + (static_cast<long long>(r) * Wo + w0) * N;
      for (int e = tid; e < positions * DW_BN; e += THREADS) {
        const int wo = e / DW_BN;
        const int n = n0 + (e - wo * DW_BN);
        gs[e] = n < N ? round_to(load_as_float(g_row + static_cast<long long>(wo) * N + n), wzero)
                      : 0.f;
      }
      __syncthreads();
      for (int wo = 0; wo < positions; ++wo) {
        const float* a_base = img + wo * PC;
        float a[DW_TK];
#pragma unroll
        for (int t = 0; t < DW_TK; ++t) a[t] = a_base[off[t]];
        float gv[DW_TN];
        const float4 g0 = *reinterpret_cast<const float4*>(gs + wo * DW_BN + tx * DW_TN);
        const float4 g1 = *reinterpret_cast<const float4*>(gs + wo * DW_BN + tx * DW_TN + 4);
        gv[0] = g0.x; gv[1] = g0.y; gv[2] = g0.z; gv[3] = g0.w;
        gv[4] = g1.x; gv[5] = g1.y; gv[6] = g1.z; gv[7] = g1.w;
#pragma unroll
        for (int t = 0; t < DW_TK; ++t)
#pragma unroll
          for (int q = 0; q < DW_TN; ++q)
            acc[t][q] = fmaf(a[t], gv[q], acc[t][q]);
      }
      __syncthreads();
    }
  }

  float* dst = partial + static_cast<long long>(blockIdx.x) * K * N;
#pragma unroll
  for (int t = 0; t < DW_TK; ++t) {
    if (!k_ok[t]) continue;
    const int k = k0 + ty * DW_TK + t;
#pragma unroll
    for (int q = 0; q < DW_TN; ++q) {
      const int n = n0 + tx * DW_TN + q;
      if (n < N) dst[static_cast<long long>(k) * N + n] = acc[t][q];
    }
  }
}

template <typename WT>
__global__ void __launch_bounds__(THREADS)
patchify_partials_sum_kernel(const float* __restrict__ partial, int chunks,
                             int KN, float* __restrict__ dw32,
                             WT* __restrict__ dw) {
  const int e = blockIdx.x * THREADS + threadIdx.x;
  if (e >= KN) return;
  float s = 0.f;
  for (int c = 0; c < chunks; ++c) s += partial[static_cast<long long>(c) * KN + e];
  dw32[e] = s;
  store1(dw + e, s);
}

// The image rows and the g row of a span of positions.
__host__ __device__ inline long long dw_smem(int P, int C, int span) {
  return 4LL * dw_image_floats(P, C, span) + 4LL * span * DW_BN;
}

template <typename WT, typename GT>
cudaError_t launch_dw(const float* x, const void* g, float* partial,
                      float* dw32, void* dw, int batch, int H, int W, int C,
                      int P, int N, int Ho, int Wo, int pad_top, int pad_left,
                      int rows_per_chunk, int chunks, int span, int clip01,
                      int vec4, cudaStream_t stream) {
  auto kernel = patchify_dw_partial_kernel<WT, GT>;
  const long long smem = dw_smem(P, C, span);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int K = P * P * C;
  const dim3 grid(chunks, (K + DW_BK - 1) / DW_BK, (N + DW_BN - 1) / DW_BN);
  kernel<<<grid, THREADS, static_cast<size_t>(smem), stream>>>(
      x, static_cast<const GT*>(g), partial, batch, H, W, C, P, N, Ho, Wo,
      pad_top, pad_left, rows_per_chunk, span, clip01, vec4);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int KN = K * N;
  patchify_partials_sum_kernel<WT><<<(KN + THREADS - 1) / THREADS, THREADS, 0,
                                  stream>>>(partial, chunks, KN, dw32,
                                            static_cast<WT*>(dw));
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// The weight gradient on the tensor cores (bfloat16 weights and g).
//
// Every product is mma.sync.m16n8k16 on bf16 operands with float32 sums.
// The function rounds both the patches and g to bf16 (the JAX kernel casts
// g to the weights' dtype, pallas_patchify.py:109), and a product of two
// bf16 values is exact in float32, so the tensor cores compute the same
// function: only the order of the float32 sums differs from the plain
// version. The positions m are the MMA's reduction axis: patches^T [k][m]
// is A, g [m][n] is B, and dw [k][n] the accumulator.
//   - A block of 8 warps owns a [192 x 128] tile of dw (4 warps along k,
//     48 values each, by 2 along n, 64 each) whose float32 accumulators
//     stay in registers (96 a lane) across a chunk of positions. At P = 8
//     -> 128 that is all of dw, so the image is read from device memory
//     once. At P = 16 -> 384 dw is 4 x 3 tiles: a k tile's image rows are
//     its own (4 of the 16 rows of a patch), so the image is still read
//     once, while each g value is read by the 4 k tiles of its n tile. The
//     12 tiles of a chunk are neighbours in blockIdx.x and run together,
//     so 9.8 MB of g come from device memory and the other 29.5 MB from L2.
//   - A chunk is a run of stages of up to 80 positions (5 MMA steps of
//     16): R output rows (b, ho) whole where a row is short (Wo = 40 at
//     P = 16: two rows), or a segment of a long row, so that no image width
//     exceeds shared memory. A stage's float32 image rows (the rows its k
//     tile touches, 61 KB) and its g rows (bf16, 20 KB) land with cp.async
//     into a ring of two; the next stage's copies are started as soon as
//     a stage has landed, and run under its conversion and its products.
//   - cp.async cannot clip or convert, so one pass clips the landed rows,
//     rounds them to bf16 and lays them out by position, [m][k] with a
//     pitch of 400 bytes (space-to-depth is its addressing), as the
//     forward does. g needs no conversion: ldmatrix.trans reads its B
//     fragments where it landed (pitch 272 bytes), and A fragments of
//     patches^T come from the [m][k] layout through ldmatrix.trans too.
//     Both pitches are odd numbers of 16-byte groups: the eight rows of an
//     ldmatrix phase fall into eight different bank groups.
//   - The reduction across chunks is deterministic: every block writes its
//     float32 tile to its chunk's partial, and patchify_partials_sum_kernel
//     sums the partials in chunk order and casts. With 128 chunks at the
//     stems the partials are 12.6 MB, which stay in the 50 MB L2 between
//     the two passes. Measured against a thread-block cluster that sums
//     its blocks' tiles in rank order through distributed shared memory
//     and writes one partial a cluster (probes/dw_cluster.py builds that
//     variant from this source; H100 80GB HBM3 at 700 W, card time a call
//     at the 640 stem / 1280 stem / P = 16): this kernel 0.047 / 0.122 /
//     0.091 ms; clusters of 2 0.047 / 0.123 / 0.122; of 4 0.074 / 0.217 /
//     0.166; of 8 0.074 / 0.219 / 0.168. The partials cost no measurable
//     time at P = 8, and a cluster must find its SMs free in one GPC at
//     once (the likely cause of the loss; not measured apart). No cluster
//     stayed.
// Shared memory at the main shapes: 2 x 61,440 bytes of image rows, 32,000
// of patches, 2 x 21,760 of g, 736 of tables: 199,136 bytes, one block an
// SM, as the 96 accumulators a lane allow anyway. ptxas (sm_90a, CUDA
// 12.8): 168 registers, no spills.

constexpr int DW_MT = 5;                     // 16-position MMA steps a stage
constexpr int DW_STAGE = 16 * DW_MT;         // positions a stage
constexpr int DW_KT = 192;                   // k values of a block's tile
constexpr int DW_NT = 128;                   // channels of a block's tile
constexpr int DW_KW = DW_KT / 4 / 16;        // 16-row k tiles of a warp: 3
constexpr int DW_NW = DW_NT / 2 / 8;         // 8-channel blocks of a warp: 8
constexpr int DW_CHUNKS = DW_KT / 8;         // 8-value k chunks of a tile
constexpr int DW_A_PITCH = DW_KT + 8;        // bf16: 400 bytes a position
constexpr int DW_G_PITCH = DW_NT + 8;        // bf16: 272 bytes a position

// The most image rows (intra-patch offsets di) that one k tile touches.
__host__ __device__ inline int dw_mma_rows(int P, int C) {
  const int pc = P * C, K = P * pc;
  int most = 1;
  for (int lo = 0; lo < K; lo += DW_KT) {
    const int hi = (lo + DW_KT < K ? lo + DW_KT : K) - 1;
    const int n = hi / pc - lo / pc + 1;
    most = n > most ? n : most;
  }
  return most;
}

// Shared memory: two stages of image rows as float32 [R][rows][seg*P*C],
// the patches [DW_STAGE][DW_A_PITCH] bf16, two stages of g rows
// [DW_STAGE][DW_G_PITCH] bf16, and the tables (row and column of each
// position in a stage, where each k chunk lies in the image rows).
__host__ __device__ inline long long dw_mma_raw_floats(int P, int C, int R,
                                                       int seg) {
  return static_cast<long long>(R) * dw_mma_rows(P, C) * seg * P * C;
}
__host__ __device__ inline long long dw_mma_smem(int P, int C, int R,
                                                 int seg) {
  return 2LL * 4 * dw_mma_raw_floats(P, C, R, seg) +
         2LL * DW_STAGE * DW_A_PITCH + 2LL * 2 * DW_STAGE * DW_G_PITCH +
         4LL * 2 * DW_STAGE + 4LL * DW_CHUNKS;
}

// Block (tile, chunk): k values k0.. of the tile blockIdx.x % k_tiles,
// channels n0.. of blockIdx.x / k_tiles, stages chunk * per_chunk.. of the
// ceil(total_rows / R) x ceil(Wo / seg) stages in position order. Writes
// its tile of its chunk's partial [K][N].
__global__ void __launch_bounds__(THREADS, 1)
patchify_dw_mma_kernel(const float* __restrict__ x, const bf16* __restrict__ g,
                       float* __restrict__ partial, int H, int W, int C,
                       int P, int N, int Ho, int Wo, int total_rows, int R,
                       int seg, int per_chunk, int clip01) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int PC = P * C, K = P * PC;
  const int nr = dw_mma_rows(P, C);
  const long long raw_stage = dw_mma_raw_floats(P, C, R, seg);
  float* raw = reinterpret_cast<float*>(smem);
  bf16* as = reinterpret_cast<bf16*>(smem + 2 * 4 * raw_stage);
  bf16* gs = as + DW_STAGE * DW_A_PITCH;
  int* r_of = reinterpret_cast<int*>(gs + 2 * DW_STAGE * DW_G_PITCH);
  int* wl_of = r_of + DW_STAGE;
  int* chunk_at = wl_of + DW_STAGE;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int k_tiles = (K + DW_KT - 1) / DW_KT;
  const int k0 = (blockIdx.x % k_tiles) * DW_KT;
  const int n0 = (blockIdx.x / k_tiles) * DW_NT;
  const int di_lo = k0 / PC;
  const int nr_t = (min(k0 + DW_KT, K) - 1) / PC - di_lo + 1;
  const int n_seg = (Wo + seg - 1) / seg;
  const int stages = (total_rows + R - 1) / R * n_seg;
  const int st_begin = blockIdx.y * per_chunk;
  const int n_st = max(0, min(per_chunk, stages - st_begin));
  const int seg_vals = seg * PC;

  // Position m of a stage is column wl_of[m] of its row r_of[m] (R for
  // none); k chunk c starts chunk_at[c] values into a position's image
  // rows (-1 past K). (The divisions are taken once, here.)
  for (int m = tid; m < DW_STAGE; m += THREADS) {
    r_of[m] = m < R * seg ? m / seg : R;
    wl_of[m] = m % seg;
  }
  for (int c = tid; c < DW_CHUNKS; c += THREADS) {
    const int k = k0 + 8 * c;
    const int di = k / PC;
    chunk_at[c] = k < K ? (di - di_lo) * seg_vals + (k - di * PC) : -1;
  }
  __syncthreads();

  // Starts the copies of stage st into ring slot buf: the image rows of
  // its k tile as they are (float32), and its g rows (zeros past the
  // stage's positions and past N).
  auto stage = [&](int st, int buf) {
    const int rg = st / n_seg, row0 = rg * R, wo0 = (st - rg * n_seg) * seg;
    const int rows_live = min(R, total_rows - row0);
    const int wlen = min(seg, Wo - wo0);
    const int pieces = wlen * PC / 4;  // 16-byte pieces of a row's segment
    float* dst_stage = raw + buf * raw_stage;
    for (int r = 0; r < rows_live; ++r) {
      const int b = (row0 + r) / Ho, ho = (row0 + r) - b * Ho;
      for (int dr = 0; dr < nr_t; ++dr) {
        const long long h = static_cast<long long>(b) * H + ho * P + di_lo + dr;
        const float* src = x + (h * W + static_cast<long long>(wo0) * P) * C;
        float* dst = dst_stage + (r * nr + dr) * seg_vals;
        for (int piece = tid; piece < pieces; piece += THREADS)
          copy_async<16>(dst + 4 * piece, src + 4 * piece, true);
      }
    }
    bf16* gdst = gs + buf * DW_STAGE * DW_G_PITCH;
    for (int i = tid; i < DW_STAGE * (DW_NT / 8); i += THREADS) {
      const int m = i / (DW_NT / 8), col = (i % (DW_NT / 8)) * 8;
      const bool live = r_of[m] < rows_live && wl_of[m] < wlen && n0 + col < N;
      const long long at =
          live ? (static_cast<long long>(row0 + r_of[m]) * Wo + wo0 +
                  wl_of[m]) * N + n0 + col
               : 0;
      copy_async<16>(gdst + m * DW_G_PITCH + col, g + at, live);
    }
  };

  // Stage st's image rows in slot buf as patches: clipped, rounded to
  // bf16, 8 values (16 bytes) a store; zeros past the stage's positions
  // and past K.
  auto convert = [&](int st, int buf) {
    const int rg = st / n_seg, row0 = rg * R, wo0 = (st - rg * n_seg) * seg;
    const int rows_live = min(R, total_rows - row0);
    const int wlen = min(seg, Wo - wo0);
    const float* src_stage = raw + buf * raw_stage;
    for (int e = tid; e < DW_STAGE * DW_CHUNKS; e += THREADS) {
      const int m = e / DW_CHUNKS, c = e - m * DW_CHUNKS;
      const int r = r_of[m], wl = wl_of[m], ca = chunk_at[c];
      uint4 packed = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows_live && wl < wlen && ca >= 0) {
        const float* src = src_stage + r * nr * seg_vals + wl * PC + ca;
        float4 a = *reinterpret_cast<const float4*>(src);
        float4 b = *reinterpret_cast<const float4*>(src + 4);
        if (clip01) {
          a = make_float4(clip_unit(a.x), clip_unit(a.y), clip_unit(a.z),
                          clip_unit(a.w));
          b = make_float4(clip_unit(b.x), clip_unit(b.y), clip_unit(b.z),
                          clip_unit(b.w));
        }
        packed = make_uint4(as_register(__floats2bfloat162_rn(a.x, a.y)),
                            as_register(__floats2bfloat162_rn(a.z, a.w)),
                            as_register(__floats2bfloat162_rn(b.x, b.y)),
                            as_register(__floats2bfloat162_rn(b.z, b.w)));
      }
      *reinterpret_cast<uint4*>(as + m * DW_A_PITCH + 8 * c) = packed;
    }
  };

  float acc[DW_KW][DW_NW][4];
#pragma unroll
  for (int kt = 0; kt < DW_KW; ++kt)
#pragma unroll
    for (int nb = 0; nb < DW_NW; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[kt][nb][e] = 0.f;

  const int wk = warp % 4, wn = warp / 4;
  // this lane's ldmatrix rows: for A (patches^T) position lane % 8 + 8
  // (lane / 16) of a step, k chunk (lane / 8) % 2 of a 16-value k tile; for
  // B (g) position lane % 16 of a step, channel block lane / 16 of a pair
  const bf16* a_at = as + (lane % 8 + 8 * (lane / 16)) * DW_A_PITCH +
                     wk * DW_KW * 16 + 8 * ((lane / 8) % 2);
  const int g_off = (lane % 16) * DW_G_PITCH + wn * DW_NW * 8 + 8 * (lane / 16);

  if (n_st > 0) {
    stage(st_begin, 0);
    commit_copies();
  }
  for (int i = 0; i < n_st; ++i) {
    const int st = st_begin + i, buf = i % 2;
    wait_copies<0>();  // this thread's part of stage i has landed
    // every thread's part has, and every warp is done with stage i - 1
    __syncthreads();
    if (i + 1 < n_st) {  // stage i + 1 loads under stage i's work
      stage(st + 1, 1 - buf);
      commit_copies();
    }
    convert(st, buf);
    __syncthreads();  // the patches are whole
    const int rg = st / n_seg, row0 = rg * R, wo0 = (st - rg * n_seg) * seg;
    const int m_live =
        (min(R, total_rows - row0) - 1) * seg + min(seg, Wo - wo0);
    const bf16* gt = gs + buf * DW_STAGE * DW_G_PITCH + g_off;
#pragma unroll
    for (int t = 0; t < DW_MT; ++t) {
      if (16 * t >= m_live) break;  // the same for every thread
      uint32_t a[DW_KW][4], b[DW_NW / 2][4];
#pragma unroll
      for (int kt = 0; kt < DW_KW; ++kt)
        ldmatrix_x4_trans(a[kt], a_at + 16 * t * DW_A_PITCH + 16 * kt);
#pragma unroll
      for (int np = 0; np < DW_NW / 2; ++np)
        ldmatrix_x4_trans(b[np], gt + 16 * t * DW_G_PITCH + 16 * np);
#pragma unroll
      for (int kt = 0; kt < DW_KW; ++kt)
#pragma unroll
        for (int nb = 0; nb < DW_NW; ++nb)
          mma_bf16(acc[kt][nb], a[kt], b[nb / 2][2 * (nb % 2)],
                   b[nb / 2][2 * (nb % 2) + 1]);
    }
  }

  // Accumulator (kt, nb): k rows 16 (3 wk + kt) + grp and + 8, channels
  // 8 (8 wn + nb) + 2 tig and + 1 of the tile.
  const int grp = lane / 4, tig = lane % 4;
  const int kw0 = wk * DW_KW * 16, nw0 = wn * DW_NW * 8;
  float* dst = partial + static_cast<long long>(blockIdx.y) * K * N;
#pragma unroll
  for (int kt = 0; kt < DW_KW; ++kt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = k0 + kw0 + 16 * kt + grp + 8 * h;
      if (k >= K) continue;
#pragma unroll
      for (int nb = 0; nb < DW_NW; ++nb) {
        const int n = n0 + nw0 + 8 * nb + 2 * tig;
        if (n < N)
          *reinterpret_cast<float2*>(dst + static_cast<long long>(k) * N + n) =
              make_float2(acc[kt][nb][2 * h], acc[kt][nb][2 * h + 1]);
      }
    }
}

cudaError_t launch_dw_mma(const float* x, const bf16* g, float* partial,
                          float* dw32, bf16* dw, int batch, int H, int W,
                          int C, int P, int N, int Ho, int Wo, int R, int seg,
                          int chunks, int per_chunk, int clip01,
                          long long smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      patchify_dw_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int K = P * P * C;
  const dim3 grid((K + DW_KT - 1) / DW_KT * ((N + DW_NT - 1) / DW_NT), chunks);
  patchify_dw_mma_kernel<<<grid, THREADS, static_cast<size_t>(smem), stream>>>(
      x, g, partial, H, W, C, P, N, Ho, Wo, batch * Ho, R, seg, per_chunk,
      clip01);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int KN = K * N;
  patchify_partials_sum_kernel<bf16><<<(KN + THREADS - 1) / THREADS, THREADS,
                                        0, stream>>>(partial, chunks, KN, dw32,
                                                     dw);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block of the kernel needs for a span of `span`
// positions and `bn` channels, in bytes. The wrapper checks it against the
// card's limit before it launches.
long long patchify_smem_bytes(int P, int C, int span, int bn, int w_bf16) {
  const long long k = static_cast<long long>(P) * P * C;
  return image_bytes(P, span, C) + k * bn * (w_bf16 ? 2 : 4);
}

// Launches the kernel on `stream` and returns cudaGetLastError() (0 = the
// launch was accepted). Pointers are device pointers of contiguous tensors;
// the caller allocates `out` [batch, Ho, Wo, N]. `bn` is a power of two
// from 4 to 128; a block takes `span` of a row's Wo positions (with vec4,
// span * P * C is a multiple of 4).
int patchify_fwd(const void* x, const void* w, void* out, int batch, int H,
                 int W, int C, int P, int N, int Ho, int Wo, int pad_top,
                 int pad_left, int bn, int span, int w_bf16, int out_bf16,
                 int clip01, int vec4, void* stream) {
  if (batch <= 0 || Ho <= 0 || Wo <= 0 || N <= 0 || C <= 0 || P <= 0 ||
      bn < TN || bn > 128 || (bn & (bn - 1)) != 0 || span <= 0 ||
      span > Wo || static_cast<long long>(batch) * Ho > 0x7fffffffLL ||
      (N + bn - 1) / bn > 65535 || (Wo + span - 1) / span > 65535 ||
      (vec4 && (static_cast<long long>(span) * P * C) % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = patchify_smem_bytes(P, C, span, bn, w_bf16);
  const float* xf = static_cast<const float*>(x);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (w_bf16 && out_bf16)
    err = launch<__nv_bfloat16, __nv_bfloat16>(
        xf, w, out, batch, H, W, C, P, N, Ho, Wo, pad_top, pad_left, bn,
        span, clip01, vec4, smem, s);
  else if (w_bf16)
    err = launch<__nv_bfloat16, float>(xf, w, out, batch, H, W, C, P, N, Ho,
                                       Wo, pad_top, pad_left, bn, span,
                                       clip01, vec4, smem, s);
  else if (out_bf16)
    err = launch<float, __nv_bfloat16>(xf, w, out, batch, H, W, C, P, N, Ho,
                                       Wo, pad_top, pad_left, bn, span,
                                       clip01, vec4, smem, s);
  else
    err = launch<float, float>(xf, w, out, batch, H, W, C, P, N, Ho, Wo,
                               pad_top, pad_left, bn, span, clip01, vec4,
                               smem, s);
  return static_cast<int>(err);
}

// Launches the tensor-core forward on `stream` and returns
// cudaGetLastError(). It takes bfloat16 weights, P dividing H and W, P*C a
// multiple of 8, P*P*C of 16 and N of 8, x and w aligned to 16 bytes; a
// block takes R output rows by `seg` positions, at most 16 MT of them (MT 3
// or 5), and 64 NB channels (NB 2 or 6). `smem_bytes` is the caller's
// count of the block's shared memory, checked against the kernel's own.
int patchify_fwd_mma(const void* x, const void* w, void* out, int batch,
                     int H, int W, int C, int P, int N, int Ho, int Wo, int R,
                     int seg, int MT, int NB, int out_bf16, int clip01,
                     long long smem_bytes, void* stream) {
  if (batch <= 0 || C <= 0 || P <= 0 || N <= 0 || Ho <= 0 || Wo <= 0 ||
      Ho * P != H || Wo * P != W || (P * C) % 8 != 0 || (P * P * C) % 16 != 0 ||
      N % 8 != 0 || R <= 0 || seg <= 0 || seg > Wo ||
      R * seg > 16 * MT || (MT != 3 && MT != 5) ||
      (NB != 2 && NB != 6) ||
      static_cast<long long>(batch) * Ho * Wo > 0x7fffffffLL ||
      (Wo + seg - 1) / seg > 65535 ||
      (N + mma_channels(NB) - 1) / mma_channels(NB) > 65535 ||
      smem_bytes != mma_smem(P, C, R, seg, MT, NB))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xf = static_cast<const float*>(x);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      out_bf16 ? launch_mma_tiles<__nv_bfloat16>(MT, NB, xf, w, out, batch, H,
                                                 W, C, P, N, Ho, Wo, R, seg,
                                                 clip01, s)
               : launch_mma_tiles<float>(MT, NB, xf, w, out, batch, H, W, C, P,
                                         N, Ho, Wo, R, seg, clip01, s);
  return static_cast<int>(err);
}

// Shared memory one block of the weight-gradient kernel needs, in bytes:
// the image rows a k tile touches and the g row, over a span of `span`
// positions.
long long patchify_dw_smem_bytes(int P, int C, int span) {
  return dw_smem(P, C, span);
}

// Launches the two passes of the weight gradient on `stream` and returns
// cudaGetLastError() (0 = both launches were accepted). x [batch, H, W, C]
// float32, g [batch, Ho, Wo, N] (bfloat16 when g_bf16, else float32),
// partial [chunks, K, N] float32 scratch, dw32 [K, N] float32 and dw [K, N]
// (bfloat16 when w_bf16, else float32) are device pointers of contiguous
// tensors, K = P*P*C; chunks * rows_per_chunk >= batch * Ho; a block stages
// `span` of a row's positions at a time (with vec4, span * P * C is a
// multiple of 4).
int patchify_dw(const void* x, const void* g, void* partial, void* dw32,
                void* dw, int batch, int H, int W, int C, int P, int N,
                int Ho, int Wo, int pad_top, int pad_left, int rows_per_chunk,
                int chunks, int span, int w_bf16, int g_bf16, int clip01,
                int vec4, void* stream) {
  const long long K = static_cast<long long>(P) * P * C;
  if (batch <= 0 || Ho <= 0 || Wo <= 0 || N <= 0 || C <= 0 || P <= 0 ||
      rows_per_chunk <= 0 || chunks <= 0 || span <= 0 || span > Wo ||
      (vec4 && (static_cast<long long>(span) * P * C) % 4 != 0) ||
      static_cast<long long>(chunks) * rows_per_chunk <
          static_cast<long long>(batch) * Ho ||
      (K + DW_BK - 1) / DW_BK > 65535 || (N + DW_BN - 1) / DW_BN > 65535 ||
      K * N > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xf = static_cast<const float*>(x);
  float* pf = static_cast<float*>(partial);
  float* d32 = static_cast<float*>(dw32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (w_bf16 && g_bf16)
    err = launch_dw<__nv_bfloat16, __nv_bfloat16>(
        xf, g, pf, d32, dw, batch, H, W, C, P, N, Ho, Wo, pad_top, pad_left,
        rows_per_chunk, chunks, span, clip01, vec4, s);
  else if (w_bf16)
    err = launch_dw<__nv_bfloat16, float>(
        xf, g, pf, d32, dw, batch, H, W, C, P, N, Ho, Wo, pad_top, pad_left,
        rows_per_chunk, chunks, span, clip01, vec4, s);
  else if (g_bf16)
    err = launch_dw<float, __nv_bfloat16>(
        xf, g, pf, d32, dw, batch, H, W, C, P, N, Ho, Wo, pad_top, pad_left,
        rows_per_chunk, chunks, span, clip01, vec4, s);
  else
    err = launch_dw<float, float>(
        xf, g, pf, d32, dw, batch, H, W, C, P, N, Ho, Wo, pad_top, pad_left,
        rows_per_chunk, chunks, span, clip01, vec4, s);
  return static_cast<int>(err);
}

// Launches the tensor-core weight gradient and the sum of its partials on
// `stream` and returns cudaGetLastError(). x [batch, H, W, C] float32 and
// g [batch, Ho, Wo, N] bfloat16, aligned to 16 bytes; partial
// [chunks, K, N] float32 scratch, dw32 [K, N] float32 and dw
// [K, N] bfloat16. P divides H and W, P*C is a multiple of 8, K = P*P*C of
// 16 and N of 8; a stage is R rows (b, ho) by `seg` positions (R == 1 or
// seg == Wo, R * seg <= 80); chunk c takes stages c * per_chunk.., and
// `chunks` cover them all.
// `smem_bytes` is the caller's count, checked against the kernel's own.
int patchify_dw_mma(const void* x, const void* g, void* partial, void* dw32,
                    void* dw, int batch, int H, int W, int C, int P, int N,
                    int Ho, int Wo, int R, int seg, int chunks, int per_chunk,
                    int clip01, long long smem_bytes,
                    void* stream) {
  const long long K = static_cast<long long>(P) * P * C;
  const long long stages = (static_cast<long long>(batch) * Ho + R - 1) / R *
                           ((Wo + seg - 1) / seg);
  if (batch <= 0 || C <= 0 || P <= 0 || N <= 0 || Ho * P != H ||
      Wo * P != W || (P * C) % 8 != 0 || K % 16 != 0 || N % 8 != 0 ||
      R <= 0 || seg <= 0 || seg > Wo || (R > 1 && seg != Wo) ||
      R * seg > DW_STAGE || chunks <= 0 || per_chunk <= 0 ||
      static_cast<long long>(chunks) * per_chunk < stages ||
      chunks > 65535 ||
      static_cast<long long>(batch) * Ho > 0x7fffffffLL ||
      K * N > 0x7fffffffLL || smem_bytes != dw_mma_smem(P, C, R, seg))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_dw_mma(
      static_cast<const float*>(x), static_cast<const bf16*>(g),
      static_cast<float*>(partial), static_cast<float*>(dw32),
      static_cast<bf16*>(dw), batch, H, W, C, P, N, Ho, Wo, R, seg, chunks,
      per_chunk, clip01, smem_bytes,
      static_cast<cudaStream_t>(stream)));
}

const char* patchify_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
