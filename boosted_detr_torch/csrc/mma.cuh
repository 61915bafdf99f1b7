// Building blocks of the tensor-core kernels (attention.cu, patchify.cu) on
// Hopper (sm_90a): asynchronous copies into shared memory, ldmatrix, and the
// warp-level bf16 product mma.sync.m16n8k16 with float32 sums.
//
// Fragment layouts of m16n8k16, with grp = lane / 4 and tig = lane % 4:
//   A (16 x 16, row): registers 0..3 hold rows grp, grp + 8, grp, grp + 8 at
//     columns 2 tig, + 1 (registers 0, 1) and 8 + 2 tig, + 1 (2, 3);
//   B (16 x 8, col): registers 0, 1 hold rows 2 tig, + 1 and 8 + 2 tig, + 1
//     of column grp;
//   C (16 x 8): values 0, 1 are row grp, columns 2 tig, + 1; values 2, 3 the
//     same columns of row grp + 8.
// ldmatrix reads four 8 x 8 bf16 matrices, lane l giving the address of row
// l % 8 of matrix l / 8 (16 bytes, 16-byte aligned); matrix i lands in
// register i in the layout above.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t shared_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Starts an asynchronous copy of BYTES (4 or 16) from device to shared
// memory; zeros are written instead when !live (src is then not read).
template <int BYTES>
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           bool live) {
  const int n = live ? BYTES : 0;
  const uint32_t to = shared_address(dst);
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(to), "l"(src), "r"(n) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(to), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most PENDING of this thread's committed groups are in flight.
template <int PENDING>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Four 8 x 8 bf16 matrices from shared memory, one row address a lane.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(shared_address(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(shared_address(p))
      : "memory");
}

// c += a . b: a 16 x 16 (row), b 16 x 8 (col), c 16 x 8 float32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_register(__nv_bfloat162 x) {
  return *reinterpret_cast<const uint32_t*>(&x);
}

}  // namespace
