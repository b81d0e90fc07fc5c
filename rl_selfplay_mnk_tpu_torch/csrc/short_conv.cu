// LFM2's gated short convolution for Hopper (sm_90a): the forward
// (short_conv_fwd), the backward's input gradient with per-group partial
// sums of the taps' gradient (short_conv_bwd), and the sum of those
// partials (short_conv_wsum).
//
// Replaces no TPU kernel: the JAX package has no such layer. Before this
// kernel the port ran it as plain PyTorch in f32 (ops/short_conv.py
// short_conv_reference): a cast of (B, C, x) to f32, the product, a pad and
// three shifted multiply-adds, the gate and a cast back, each a pass over
// memory, and as many again in the backward.
//
// Function (the same rounding points as the plain version): with bcx read
// in its own dtype (bf16 or f32) and the taps w (D, K) in f32,
//   B, C, x = split3(bcx);  z[t] = sum_j w[:, j] * (B * x)[t - K + 1 + j];
//   y = C * z, rounded to bcx's dtype once.
// Backward: dz = dy * C; dC = dy * z; d(Bx)[t] = sum_j w[:, j] * dz[t + K - 1 - j];
// dB = d(Bx) * x; dx = d(Bx) * B (one (rows, 3D) gradient, rounded once);
// dw[:, j] = sum over boards and cells of dz[t] * (Bx)[t - K + 1 + j] in f32.
//
// Bound: bytes. Forward reads 3 D and writes D elements a cell, backward
// reads 4 D and writes 3 D; LFM2's update minibatch (512 boards of 81
// cells, D = 2048) moves 340 MB forward and 595 MB backward a layer.
//
// Design. A thread owns one vector of VE channels (16 bytes) of one board
// and walks the board's cells in order, keeping the last K cells' B and x
// in registers: every element is read once and written once. Neighbouring
// threads hold neighbouring channel vectors of the same cell, so each load
// and store of a warp is contiguous. The backward walks the cells from the
// last to the first, keeping the next K cells' dz, and adds dz * Bx into
// the thread's K x VE tap sums; threads of the same channels in other
// board groups write their sums into a [groups][D][K] partial buffer that
// short_conv_wsum adds in a fixed order. No atomics: the same bits every
// run.
//
// The C entries return cudaGetLastError() after the launch (or
// cudaErrorInvalidValue for a shape they do not take); the Python wrapper
// raises when it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTaps = 3;  // LFM2's conv_L_cache

typedef __nv_bfloat16 bf16;

template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
    T v[N];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16_rn(v); }

template <typename T, int VE>
__device__ __forceinline__ void load(const T* p, float (&v)[VE]) {
    const Pack<T, VE> q = *reinterpret_cast<const Pack<T, VE>*>(p);
#pragma unroll
    for (int e = 0; e < VE; ++e) v[e] = to_f32(q.v[e]);
}

template <typename T, int VE>
__device__ __forceinline__ void store(T* p, const float (&v)[VE]) {
    Pack<T, VE> q;
#pragma unroll
    for (int e = 0; e < VE; ++e) q.v[e] = from_f32<T>(v[e]);
    *reinterpret_cast<Pack<T, VE>*>(p) = q;
}

// Thread -> (channel vector, board): vectors of a board's channels run
// fastest, so a warp covers contiguous channels of one cell.
template <typename T, int VE>
__global__ void __launch_bounds__(kThreads)
short_conv_fwd(const T* __restrict__ bcx, const float* __restrict__ w, long long boards,
               int length, int d, T* __restrict__ y) {
    const int vectors = d / VE;
    const long long item = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    if (item >= boards * vectors) return;
    const int vec = static_cast<int>(item % vectors);
    const long long board = item / vectors;
    const int c0 = vec * VE;
    float tap[kTaps][VE];
#pragma unroll
    for (int e = 0; e < VE; ++e)
#pragma unroll
        for (int j = 0; j < kTaps; ++j) tap[j][e] = w[(c0 + e) * kTaps + j];
    float bx[kTaps][VE];  // Bx at t - K + 1 .. t, the oldest first
#pragma unroll
    for (int j = 0; j < kTaps; ++j)
#pragma unroll
        for (int e = 0; e < VE; ++e) bx[j][e] = 0.0f;
    const T* in = bcx + board * length * 3 * d;
    T* out = y + board * length * d;
    for (int t = 0; t < length; ++t) {
        const T* row = in + static_cast<long long>(t) * 3 * d;
        float b[VE], c[VE], x[VE], z[VE];
        load<T, VE>(row + c0, b);
        load<T, VE>(row + d + c0, c);
        load<T, VE>(row + 2 * d + c0, x);
#pragma unroll
        for (int e = 0; e < VE; ++e) {
#pragma unroll
            for (int j = 0; j + 1 < kTaps; ++j) bx[j][e] = bx[j + 1][e];
            bx[kTaps - 1][e] = b[e] * x[e];
            float s = bx[0][e] * tap[0][e];
#pragma unroll
            for (int j = 1; j < kTaps; ++j) s = s + bx[j][e] * tap[j][e];
            z[e] = c[e] * s;
        }
        store<T, VE>(out + static_cast<long long>(t) * d + c0, z);
    }
}

// Thread -> (channel vector, board group); a thread walks the boards
// group, group + groups, ... Its tap sums go to part[group][channel][tap].
template <typename T, int VE>
__global__ void __launch_bounds__(kThreads)
short_conv_bwd(const T* __restrict__ bcx, const float* __restrict__ w, const T* __restrict__ dy,
               long long boards, int length, int d, int groups, T* __restrict__ dbcx,
               float* __restrict__ part) {
    const int vectors = d / VE;
    const long long item = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    if (item >= static_cast<long long>(groups) * vectors) return;
    const int vec = static_cast<int>(item % vectors);
    const int group = static_cast<int>(item / vectors);
    const int c0 = vec * VE;
    float tap[kTaps][VE], dw[kTaps][VE];
#pragma unroll
    for (int e = 0; e < VE; ++e)
#pragma unroll
        for (int j = 0; j < kTaps; ++j) {
            tap[j][e] = w[(c0 + e) * kTaps + j];
            dw[j][e] = 0.0f;
        }
    for (long long board = group; board < boards; board += groups) {
        const T* in = bcx + board * length * 3 * d;
        const T* g = dy + board * length * d;
        T* out = dbcx + board * length * 3 * d;
        // Walking t down: dz at t .. t + K - 1 (dz[0] = t), and Bx at
        // t - K + 1 .. t (bx[K - 1] = t), loaded as t moves.
        float dz[kTaps][VE], bx[kTaps][VE], bk[kTaps][VE], xk[kTaps][VE];
#pragma unroll
        for (int j = 0; j < kTaps; ++j)
#pragma unroll
            for (int e = 0; e < VE; ++e) dz[j][e] = bx[j][e] = bk[j][e] = xk[j][e] = 0.0f;
        // Bx at length - K + 1 .. length - 1 into bx[0 .. K - 2]: the first
        // step's shift moves them to bx[1 .. K - 1]
#pragma unroll
        for (int i = 0; i + 1 < kTaps; ++i) {
            const int t = length - kTaps + 1 + i;
            if (t >= 0) {
                const T* row = in + static_cast<long long>(t) * 3 * d;
                float b[VE], x[VE];
                load<T, VE>(row + c0, b);
                load<T, VE>(row + 2 * d + c0, x);
#pragma unroll
                for (int e = 0; e < VE; ++e) {
                    bk[i][e] = b[e];
                    xk[i][e] = x[e];
                    bx[i][e] = b[e] * x[e];
                }
            }
        }
        for (int t = length - 1; t >= 0; --t) {
            // bx[j] holds Bx at t - K + 1 + j once shifted: bring t - K + 1 in at 0
#pragma unroll
            for (int j = kTaps - 1; j > 0; --j)
#pragma unroll
                for (int e = 0; e < VE; ++e) {
                    bx[j][e] = bx[j - 1][e];
                    bk[j][e] = bk[j - 1][e];
                    xk[j][e] = xk[j - 1][e];
                }
            {
                const int tn = t - kTaps + 1;
                float b[VE], x[VE];
                if (tn >= 0) {
                    const T* row = in + static_cast<long long>(tn) * 3 * d;
                    load<T, VE>(row + c0, b);
                    load<T, VE>(row + 2 * d + c0, x);
                } else {
#pragma unroll
                    for (int e = 0; e < VE; ++e) b[e] = x[e] = 0.0f;
                }
#pragma unroll
                for (int e = 0; e < VE; ++e) {
                    bk[0][e] = b[e];
                    xk[0][e] = x[e];
                    bx[0][e] = b[e] * x[e];
                }
            }
            const T* row = in + static_cast<long long>(t) * 3 * d;
            float c[VE], gy[VE];
            load<T, VE>(row + d + c0, c);
            load<T, VE>(g + static_cast<long long>(t) * d + c0, gy);
            float db[VE], dc[VE], dx[VE];
#pragma unroll
            for (int e = 0; e < VE; ++e) {
#pragma unroll
                for (int j = kTaps - 1; j > 0; --j) dz[j][e] = dz[j - 1][e];
                float z = bx[0][e] * tap[0][e];
#pragma unroll
                for (int j = 1; j < kTaps; ++j) z = z + bx[j][e] * tap[j][e];
                dz[0][e] = gy[e] * c[e];
                dc[e] = gy[e] * z;
                // d(Bx)[t] = sum_j w[j] dz[t + K - 1 - j]
                float dbx = dz[kTaps - 1][e] * tap[0][e];
#pragma unroll
                for (int j = 1; j < kTaps; ++j) dbx = dbx + dz[kTaps - 1 - j][e] * tap[j][e];
                db[e] = dbx * xk[kTaps - 1][e];
                dx[e] = dbx * bk[kTaps - 1][e];
#pragma unroll
                for (int j = 0; j < kTaps; ++j) dw[j][e] += dz[0][e] * bx[j][e];
            }
            T* orow = out + static_cast<long long>(t) * 3 * d;
            store<T, VE>(orow + c0, db);
            store<T, VE>(orow + d + c0, dc);
            store<T, VE>(orow + 2 * d + c0, dx);
        }
    }
    float* mine = part + static_cast<long long>(group) * d * kTaps;
#pragma unroll
    for (int e = 0; e < VE; ++e)
#pragma unroll
        for (int j = 0; j < kTaps; ++j) mine[(c0 + e) * kTaps + j] = dw[j][e];
}

// dw[i] = sum over groups of part[group][i], in group order, a thread an i.
__global__ void __launch_bounds__(kThreads)
short_conv_wsum(const float* __restrict__ part, int groups, int n, float* __restrict__ dw) {
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (i >= n) return;
    float t = 0.0f;
    for (int g = 0; g < groups; ++g) t += part[static_cast<long long>(g) * n + i];
    dw[i] = t;
}

bool shape_ok(long long boards, int length, int d, int ve, int taps) {
    return boards >= 0 && length >= 1 && d >= 1 && ve >= 1 && d % ve == 0 && taps == kTaps;
}

int blocks_for(long long items) {
    return static_cast<int>((items + kThreads - 1) / kThreads);
}

}  // namespace

// y (boards, length, d) from bcx (boards, length, 3d) and the taps w (d, taps).
extern "C" int short_conv_fwd_launch(int is_bf16, int ve, const void* bcx, const void* w,
                                     long long boards, int length, int d, int taps, void* y,
                                     void* stream) {
    if (!shape_ok(boards, length, d, ve, taps)) return static_cast<int>(cudaErrorInvalidValue);
    if (boards == 0) return 0;
    const long long items = boards * (d / ve);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (is_bf16 && ve == 8)
        short_conv_fwd<bf16, 8><<<blocks_for(items), kThreads, 0, st>>>(
            static_cast<const bf16*>(bcx), static_cast<const float*>(w), boards, length, d,
            static_cast<bf16*>(y));
    else if (is_bf16 && ve == 1)
        short_conv_fwd<bf16, 1><<<blocks_for(items), kThreads, 0, st>>>(
            static_cast<const bf16*>(bcx), static_cast<const float*>(w), boards, length, d,
            static_cast<bf16*>(y));
    else if (!is_bf16 && ve == 4)
        short_conv_fwd<float, 4><<<blocks_for(items), kThreads, 0, st>>>(
            static_cast<const float*>(bcx), static_cast<const float*>(w), boards, length, d,
            static_cast<float*>(y));
    else if (!is_bf16 && ve == 1)
        short_conv_fwd<float, 1><<<blocks_for(items), kThreads, 0, st>>>(
            static_cast<const float*>(bcx), static_cast<const float*>(w), boards, length, d,
            static_cast<float*>(y));
    else
        return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(cudaGetLastError());
}

// dbcx (boards, length, 3d), and dw (d, taps) through part ([groups][d][taps] f32).
extern "C" int short_conv_bwd_launch(int is_bf16, int ve, const void* bcx, const void* w,
                                     const void* dy, long long boards, int length, int d,
                                     int taps, int groups, void* dbcx, void* part, void* dw,
                                     void* stream) {
    if (!shape_ok(boards, length, d, ve, taps) || groups < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const long long items = static_cast<long long>(groups) * (d / ve);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (is_bf16 && ve == 8)
        short_conv_bwd<bf16, 8><<<blocks_for(items), kThreads, 0, st>>>(
            static_cast<const bf16*>(bcx), static_cast<const float*>(w),
            static_cast<const bf16*>(dy), boards, length, d, groups, static_cast<bf16*>(dbcx),
            static_cast<float*>(part));
    else if (is_bf16 && ve == 1)
        short_conv_bwd<bf16, 1><<<blocks_for(items), kThreads, 0, st>>>(
            static_cast<const bf16*>(bcx), static_cast<const float*>(w),
            static_cast<const bf16*>(dy), boards, length, d, groups, static_cast<bf16*>(dbcx),
            static_cast<float*>(part));
    else if (!is_bf16 && ve == 4)
        short_conv_bwd<float, 4><<<blocks_for(items), kThreads, 0, st>>>(
            static_cast<const float*>(bcx), static_cast<const float*>(w),
            static_cast<const float*>(dy), boards, length, d, groups, static_cast<float*>(dbcx),
            static_cast<float*>(part));
    else if (!is_bf16 && ve == 1)
        short_conv_bwd<float, 1><<<blocks_for(items), kThreads, 0, st>>>(
            static_cast<const float*>(bcx), static_cast<const float*>(w),
            static_cast<const float*>(dy), boards, length, d, groups, static_cast<float*>(dbcx),
            static_cast<float*>(part));
    else
        return static_cast<int>(cudaErrorInvalidValue);
    const int code = static_cast<int>(cudaGetLastError());
    if (code != 0) return code;
    const int n = d * taps;
    short_conv_wsum<<<blocks_for(n), kThreads, 0, st>>>(static_cast<const float*>(part), groups, n,
                                                          static_cast<float*>(dw));
    return static_cast<int>(cudaGetLastError());
}
