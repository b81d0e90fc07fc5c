// Tensor-core building blocks for the bf16 kernels (resblock.cu K2,
// attention.cu K3 and K8): warp-wide ldmatrix loads of 8x8 b16 tiles out of shared
// memory, the m16n8k16 bf16 product with f32 accumulation, the index maps of
// its fragments, cp.async copies into shared memory and division by a
// multiply.
//
// Fragments of mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, for a
// lane with g = lane / 4 (its group) and t = lane % 4 (its place in the group):
//
//     A (16 x 16, rows m, depth k), four b16x2 registers:
//         a0 = (m = g,     k = 2t, 2t+1)    a1 = (m = g + 8, k = 2t, 2t+1)
//         a2 = (m = g,     k = 2t+8, 2t+9)  a3 = (m = g + 8, k = 2t+8, 2t+9)
//     B (16 x 8, depth k, columns n), two b16x2 registers:
//         b0 = (k = 2t, 2t+1; n = g)        b1 = (k = 2t+8, 2t+9; n = g)
//     C (16 x 8), four f32:
//         c0, c1 = (m = g,     n = 2t, 2t+1)
//         c2, c3 = (m = g + 8, n = 2t, 2t+1)
//
// The lower k (or n) of a pair sits in the low half of its register.
//
// ldmatrix.x4 loads four 8x8 tiles; lanes 8i .. 8i+7 give the addresses of
// tile i's eight rows of 16 bytes, and register i receives tile i. Without
// .trans a lane receives (row g, columns 2t, 2t+1) of each tile; with .trans
// it receives (rows 2t, 2t+1, column g), the tile transposed. So:
//
//     A from rows m of k-contiguous values  -> ldmatrix       (tiles m0-7 k0-7,
//                                                              m8-15 k0-7, m0-7 k8-15,
//                                                              m8-15 k8-15)
//     A from rows k of m-contiguous values  -> ldmatrix.trans
//     B from rows n of k-contiguous values  -> ldmatrix
//     B from rows k of n-contiguous values  -> ldmatrix.trans
//
// A C fragment turns into an A fragment of the next product (depth = this
// product's n) without leaving registers: columns 16j .. 16j+15 of C, the
// n-tiles 2j and 2j+1, are a0 = pack(c[2j][0], c[2j][1]), a1 = pack(c[2j][2],
// c[2j][3]), a2 = pack(c[2j+1][0], c[2j+1][1]), a3 = pack(c[2j+1][2], c[2j+1][3]).
//
// The eight 16-byte rows of one ldmatrix tile fall on different shared-memory
// banks when the row stride is an odd number of 16-byte words:
// padded_row_elems gives such a stride.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// Shared-memory addresses are 32-bit offsets in the shared window: a kernel
// takes one with shared_address and adds byte offsets to it.
__device__ __forceinline__ uint32_t shared_address(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t row) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(row));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t row) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(row));
}

// 16 bytes from device memory into shared memory without a trip through
// registers; the copies of a thread stay in flight until cp_async_wait_all.
__device__ __forceinline__ void cp_async_16(uint32_t smem, const void* global) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(smem), "l"(global));
}

// 4 or 8 bytes the same way, through L1 (the .cg form copies 16 bytes only).
template <int kBytes>
__device__ __forceinline__ void cp_async_small(uint32_t smem, const void* global) {
    static_assert(kBytes == 4 || kBytes == 8, "cp.async.ca copies 4, 8 or 16 bytes");
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" :: "r"(smem), "l"(global), "n"(kBytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// d += a . b on one 16 x 8 x 16 tile, bf16 operands, f32 sums.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b on one 16 x 8 x 8 tile: a0, a1 and b are the first (or the
// second) half of the depth of m16n8k16's a0, a1 (or a2, a3) and b0 (or b1).
__device__ __forceinline__ void mma_bf16_1688(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t b) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a0), "r"(a1), "r"(b));
}

// Two floats rounded to bf16 (nearest even) in one register, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

// Which rows and columns of a C fragment a lane holds: rows g and g + 8,
// columns 2t and 2t + 1 of each n-tile.
__device__ __forceinline__ int frag_row(int lane) { return lane >> 2; }
__device__ __forceinline__ int frag_col(int lane) { return (lane & 3) * 2; }

// The row a lane addresses in an ldmatrix.x4 of an A operand (16 rows, two
// 8-wide halves of depth): row (lane mod 16), depth half (lane / 16).
__device__ __forceinline__ int a_row_of_lane(int lane) { return lane & 15; }
__device__ __forceinline__ int a_half_of_lane(int lane) { return lane >> 4; }

// n / d by one high multiply, exact for n * d < 2^32:
// the kernels' position and element indices, whose divisors (board sizes,
// head sizes, chunk counts) are known only at run time.
struct FastDiv {
    uint32_t d;
    uint64_t m;  // ceil(2^32 / d)
    __device__ explicit FastDiv(uint32_t divisor) : d(divisor), m(0xffffffffull / divisor + 1) {}
    __device__ __forceinline__ uint32_t operator()(uint32_t n) const {
        return static_cast<uint32_t>((n * m) >> 32);
    }
};

// A row stride, in b16 elements, that holds `elems` values, is a multiple of
// eight (16-byte rows) and an odd number of 16-byte words.
__host__ __device__ inline int padded_row_elems(int elems) {
    int ld = (elems + 7) & ~7;
    if (((ld >> 3) & 1) == 0) ld += 8;
    return ld;
}

}  // namespace
