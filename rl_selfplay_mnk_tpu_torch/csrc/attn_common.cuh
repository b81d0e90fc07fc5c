// What the attention kernels of attention.cu and attention_board.cu share:
// the limits on a head's size, the conversions between the tensors' type and
// f32, the softmax of four rows held across a warp, and the opt-in to the
// card's whole per-block shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kColsPerLane = 6;             // key columns (or query rows) a lane holds
constexpr int kMaxL = 32 * kColsPerLane;    // 192 tokens: 13x13 = 169 fits
constexpr int kMaxDh = 64;                  // two head channels a lane

constexpr unsigned kFull = 0xffffffffu;

constexpr int kRows = 4;  // query rows (or key columns) a warp works on at a time

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
    return __float2bfloat16(v);
}
// v rounded to T (round to nearest even), as a float.
template <typename T> __device__ __forceinline__ float round_to(float v) {
    return to_f(from_f<T>(v));
}

// Four rows' probabilities from their raw scores, in place: x = s * scale,
// m = max x, p = exp(x - m) * (1 / sum). Lanes hold columns lane + 32 t;
// columns >= L give 0. The four rows' shuffles run side by side.
__device__ __forceinline__ void softmax_rows(float (&p)[kRows][kColsPerLane], int L, int lane,
                                             float scale, float (&m)[kRows],
                                             float (&rinv)[kRows]) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) m[r] = -INFINITY;
#pragma unroll
    for (int t = 0; t < kColsPerLane; ++t) {
        if (32 * t < L) {
            const bool live = lane + 32 * t < L;
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
                p[r][t] = live ? __fmul_rn(p[r][t], scale) : -INFINITY;
                m[r] = fmaxf(m[r], p[r][t]);
            }
        }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) m[r] = fmaxf(m[r], __shfl_xor_sync(kFull, m[r], off));
    }
    float sum[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) sum[r] = 0.0f;
#pragma unroll
    for (int t = 0; t < kColsPerLane; ++t) {
        if (32 * t < L) {
            const bool live = lane + 32 * t < L;
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
                p[r][t] = live ? expf(__fsub_rn(p[r][t], m[r])) : 0.0f;
                sum[r] += p[r][t];
            }
        }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) sum[r] += __shfl_xor_sync(kFull, sum[r], off);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) rinv[r] = __frcp_rn(sum[r]);
#pragma unroll
    for (int t = 0; t < kColsPerLane; ++t) {
        if (32 * t < L) {
#pragma unroll
            for (int r = 0; r < kRows; ++r) p[r][t] = __fmul_rn(p[r][t], rinv[r]);
        }
    }
}

// How the 32 lanes split over head channels: 2^shift lanes side by side own
// the channels, and the 32 >> shift groups share out the rows.
__device__ __forceinline__ int channel_shift(int dh) {
    int shift = 5;
    while (shift > 0 && (1 << (shift - 1)) >= dh) --shift;
    return shift;
}

// One value per row for column j of the warp's (L, 4) tile.
__device__ __forceinline__ void put_tile(float* tile, int j, float a, float b, float c, float d) {
    *reinterpret_cast<float4*>(tile + kRows * j) = make_float4(a, b, c, d);
}

// Lets a kernel use the card's whole per-block shared memory; once per kernel.
template <typename Kernel>
cudaError_t allow_large_smem(Kernel kernel, bool& done) {
    if (done) return cudaSuccess;
    int device = 0, max_optin = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&max_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_optin);
    done = err == cudaSuccess;
    return err;
}

}  // namespace
