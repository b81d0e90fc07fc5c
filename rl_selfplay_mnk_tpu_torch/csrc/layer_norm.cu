// LayerNorm over the last axis for Hopper (sm_90a): the forward
// (ln_rows_fwd), the backward's dx with per-block partial sums of dgamma
// and dbeta (ln_rows_bwd), and the sum of those partials over the blocks
// (ln_cols_sum).
//
// Replaces no TPU kernel: the JAX package leaves flax's nn.LayerNorm to
// XLA, which fuses it with its neighbours. Before this kernel the port ran
// it as three steps (x cast to f32, ATen's LayerNorm, the result cast
// back) and their three backwards, ATen's with one block of threads a row:
// at the transformers' widths (56 to 256) most of a block idles through
// two block-wide reductions, and the cost of a row is latency, not bytes.
//
// Function (ops/layer_norm.py layer_norm_reference, the same rounding
// points): with x read in its own dtype (bf16 or f32) and everything else
// in f32,
//   mean = sum(x) / d,  var = sum((x - mean)^2) / d  (two passes),
//   rstd = rsqrt(var + eps),  y = gamma * (rstd * (x - mean)) + beta,
// y rounded to x's dtype once. Backward, with xh = (x - mean) * rstd and
// g = dy * gamma:  dx = rstd * (g - mean(g) - xh * mean(g * xh)), rounded to
// x's dtype once; dgamma = sum over rows of dy * xh, dbeta = sum of dy.
//
// Bound: bytes. A bf16 row of d = 56 reads 112 bytes and writes 112 (and
// 8 bytes of mean and rstd when autograd needs them); the backward reads x,
// dy, mean and rstd and writes dx. The update minibatch's 663,552 rows
// (8192 boards x 81 tokens) move 149 MB forward, about 44 us at the card's
// 3.35 TB/s.
//
// Design. A group of lanes owns a row and keeps all of it in registers, so
// x is read once and both reductions are shuffles inside the group. The
// plan (ops/layer_norm.py row_plan) comes from the width: the widest load
// of 16, 8, 4 or 2 bytes that divides the row's bytes and every address,
// the smallest power of two of lanes that covers the row with one load
// each (at most 32), and as many loads a lane as the row then needs
// (vectors_per_lane, rounded up to a power of two: a template argument).
// At d = 56 in bf16 that is 8 lanes of one 16-byte load, four rows a warp.
// Blocks of 256 threads walk the rows by warps, as many blocks as the card
// holds at once, so gamma and beta are read once a thread into registers.
//
// The backward keeps f32 partial sums of dy * xh and dy for the columns a
// lane owns over all the rows it walks, adds them over the warp's groups by
// shuffles, over the block's warps in shared memory in warp order, and
// writes one [2][d] row of partials a block. ln_cols_sum adds those rows up
// in a fixed order. No atomics: the same inputs on the same card give the
// same bits.
//
// The C entries return cudaGetLastError() after the launch (or
// cudaErrorInvalidValue for a plan the kernels do not take); the Python
// wrapper raises when it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxWidth = 512;   // ops/layer_norm.py MAX_WIDTH
constexpr int kMaxPerLane = 16;  // elements a lane holds of a row: vector_elems * vectors_per_lane
constexpr int kSumRows = 32;     // ln_cols_sum: threads a column of partials is split over
constexpr unsigned kFull = 0xffffffffu;

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

// The sum over a row's group of lanes, in every lane of it (a butterfly:
// both lanes of a pair add the same two numbers).
__device__ __forceinline__ float group_sum(float s, int lanes) {
    for (int o = lanes >> 1; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
    return s;
}

// Where a thread sits: its lane in its row's group, the group's place in
// the warp, and the warp's place in the grid.
struct Seat {
    int sub, group, lanes, rows_per_warp;
    long long warp, warps;
};

__device__ __forceinline__ Seat seat(int lanes_log2) {
    Seat s;
    const int lane = threadIdx.x & 31;
    s.lanes = 1 << lanes_log2;
    s.sub = lane & (s.lanes - 1);
    s.group = lane >> lanes_log2;
    s.rows_per_warp = 32 >> lanes_log2;
    s.warp = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
    s.warps = static_cast<long long>(gridDim.x) * kWarps;
    return s;
}

// This lane's elements of a row in f32: load i of VE elements at vector
// sub + i * lanes; 0 past the row's end or for a row past the last.
template <typename T, int VE, int VPL>
__device__ __forceinline__ void load_row(const T* row, bool live, const Seat& s, int vectors,
                                         float (&v)[VPL][VE]) {
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
        const int vec = s.sub + i * s.lanes;
        if (live && vec < vectors) {
            const Pack<T, VE> p = *reinterpret_cast<const Pack<T, VE>*>(row + vec * VE);
#pragma unroll
            for (int e = 0; e < VE; ++e) v[i][e] = to_f32(p.v[e]);
        } else {
#pragma unroll
            for (int e = 0; e < VE; ++e) v[i][e] = 0.0f;
        }
    }
}

template <typename T, int VE, int VPL>
__device__ __forceinline__ void store_row(T* row, bool live, const Seat& s, int vectors,
                                          const float (&v)[VPL][VE]) {
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
        const int vec = s.sub + i * s.lanes;
        if (live && vec < vectors) {
            Pack<T, VE> p;
#pragma unroll
            for (int e = 0; e < VE; ++e) p.v[e] = from_f32<T>(v[i][e]);
            *reinterpret_cast<Pack<T, VE>*>(row + vec * VE) = p;
        }
    }
}

// gamma or beta at this lane's columns (0 past the row's end).
template <int VE, int VPL>
__device__ __forceinline__ void load_params(const float* p, const Seat& s, int width,
                                            float (&w)[VPL][VE]) {
#pragma unroll
    for (int i = 0; i < VPL; ++i)
#pragma unroll
        for (int e = 0; e < VE; ++e) {
            const int col = (s.sub + i * s.lanes) * VE + e;
            w[i][e] = col < width ? p[col] : 0.0f;
        }
}

template <typename T, int VE, int VPL>
__global__ void __launch_bounds__(kThreads)
ln_rows_fwd(const T* __restrict__ x, const float* __restrict__ gamma,
            const float* __restrict__ beta, long long rows, int width, int lanes_log2, float eps,
            T* __restrict__ y, float* __restrict__ mean_out, float* __restrict__ rstd_out) {
    const Seat s = seat(lanes_log2);
    const int vectors = width / VE;
    const float d = static_cast<float>(width);
    float g[VPL][VE], b[VPL][VE];
    load_params(gamma, s, width, g);
    load_params(beta, s, width, b);
    // The bound is the same in every lane of a warp, so whole warps shuffle.
    for (long long base = s.warp * s.rows_per_warp; base < rows;
         base += s.warps * s.rows_per_warp) {
        const long long row = base + s.group;
        const bool live = row < rows;
        const long long offset = live ? row * width : 0;
        float v[VPL][VE];
        load_row<T, VE, VPL>(x + offset, live, s, vectors, v);
        float sum = 0.0f;
#pragma unroll
        for (int i = 0; i < VPL; ++i)
#pragma unroll
            for (int e = 0; e < VE; ++e) sum += v[i][e];
        const float mean = group_sum(sum, s.lanes) / d;
        float sq = 0.0f;
#pragma unroll
        for (int i = 0; i < VPL; ++i)
#pragma unroll
            for (int e = 0; e < VE; ++e) {
                const bool in = (s.sub + i * s.lanes) < vectors;
                v[i][e] = in ? v[i][e] - mean : 0.0f;
                sq += v[i][e] * v[i][e];
            }
        const float rstd = rsqrtf(group_sum(sq, s.lanes) / d + eps);
#pragma unroll
        for (int i = 0; i < VPL; ++i)
#pragma unroll
            for (int e = 0; e < VE; ++e) v[i][e] = g[i][e] * (rstd * v[i][e]) + b[i][e];
        store_row<T, VE, VPL>(y + offset, live, s, vectors, v);
        if (mean_out != nullptr && live && s.sub == 0) {
            mean_out[row] = mean;
            rstd_out[row] = rstd;
        }
    }
}

// Shared memory of ln_rows_bwd: each warp's [2][width] partial sums.
__host__ __device__ constexpr size_t bwd_smem_bytes(int width) {
    return static_cast<size_t>(kWarps) * 2 * width * sizeof(float);
}

template <typename T, int VE, int VPL>
__global__ void __launch_bounds__(kThreads)
ln_rows_bwd(const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ mean,
            const float* __restrict__ rstd, const float* __restrict__ gamma, long long rows,
            int width, int lanes_log2, T* __restrict__ dx, float* __restrict__ part) {
    extern __shared__ float warp_sums[];  // [kWarps][2][width]
    const Seat s = seat(lanes_log2);
    const int vectors = width / VE;
    const float d = static_cast<float>(width);
    float g[VPL][VE], dg[VPL][VE], db[VPL][VE];
    load_params(gamma, s, width, g);
#pragma unroll
    for (int i = 0; i < VPL; ++i)
#pragma unroll
        for (int e = 0; e < VE; ++e) dg[i][e] = db[i][e] = 0.0f;
    for (long long base = s.warp * s.rows_per_warp; base < rows;
         base += s.warps * s.rows_per_warp) {
        const long long row = base + s.group;
        const bool live = row < rows;
        const long long offset = live ? row * width : 0;
        float xv[VPL][VE], dv[VPL][VE];
        load_row<T, VE, VPL>(x + offset, live, s, vectors, xv);
        load_row<T, VE, VPL>(dy + offset, live, s, vectors, dv);
        const float m = live ? mean[row] : 0.0f;
        const float r = live ? rstd[row] : 0.0f;
        // Past the row's end dy and gamma are 0, so nothing there adds to a sum.
        float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
        for (int i = 0; i < VPL; ++i)
#pragma unroll
            for (int e = 0; e < VE; ++e) {
                xv[i][e] = (xv[i][e] - m) * r;
                const float w = dv[i][e] * g[i][e];
                s1 += w;
                s2 += w * xv[i][e];
                dg[i][e] += dv[i][e] * xv[i][e];
                db[i][e] += dv[i][e];
            }
        const float c1 = group_sum(s1, s.lanes) / d;
        const float c2 = group_sum(s2, s.lanes) / d;
#pragma unroll
        for (int i = 0; i < VPL; ++i)
#pragma unroll
            for (int e = 0; e < VE; ++e)
                xv[i][e] = r * (dv[i][e] * g[i][e] - c1 - xv[i][e] * c2);
        store_row<T, VE, VPL>(dx + offset, live, s, vectors, xv);
    }
    // The warp's groups hold sums of the same columns: add them, then the
    // first group writes the warp's.
#pragma unroll
    for (int i = 0; i < VPL; ++i)
#pragma unroll
        for (int e = 0; e < VE; ++e)
            for (int o = s.lanes; o < 32; o <<= 1) {
                dg[i][e] += __shfl_xor_sync(kFull, dg[i][e], o);
                db[i][e] += __shfl_xor_sync(kFull, db[i][e], o);
            }
    float* mine = warp_sums + (threadIdx.x >> 5) * 2 * width;
    if (s.group == 0) {
#pragma unroll
        for (int i = 0; i < VPL; ++i)
#pragma unroll
            for (int e = 0; e < VE; ++e) {
                const int col = (s.sub + i * s.lanes) * VE + e;
                if (col < width) {
                    mine[col] = dg[i][e];
                    mine[width + col] = db[i][e];
                }
            }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < 2 * width; c += kThreads) {
        float t = 0.0f;
        for (int w = 0; w < kWarps; ++w) t += warp_sums[w * 2 * width + c];
        part[static_cast<long long>(blockIdx.x) * 2 * width + c] = t;
    }
}

// dgamma and dbeta: the [blocks][2][width] partials summed over blocks.
// Thread (c, k) of a block adds the rows k, k + kSumRows, ... of column c,
// then row 0 adds the kSumRows sums in order.
__global__ void __launch_bounds__(32 * kSumRows)
ln_cols_sum(const float* __restrict__ part, int blocks, int width, float* __restrict__ dgamma,
            float* __restrict__ dbeta) {
    __shared__ float sums[kSumRows][33];
    const int cols = 2 * width;
    const int col = blockIdx.x * 32 + threadIdx.x;
    float t = 0.0f;
    if (col < cols) {
#pragma unroll 8
        for (int b = threadIdx.y; b < blocks; b += kSumRows)
            t += part[static_cast<long long>(b) * cols + col];
    }
    sums[threadIdx.y][threadIdx.x] = t;
    __syncthreads();
    if (threadIdx.y == 0 && col < cols) {
        float total = sums[0][threadIdx.x];
        for (int k = 1; k < kSumRows; ++k) total += sums[k][threadIdx.x];
        if (col < width)
            dgamma[col] = total;
        else
            dbeta[col - width] = total;
    }
}

int log2_of(int lanes) {
    int l = 0;
    while ((1 << l) < lanes) ++l;
    return (1 << l) == lanes ? l : -1;
}

// What every entry checks of a plan: a width the kernels take, a power of
// two of lanes that covers the row with vectors_per_lane loads of
// vector_elems.
bool plan_ok(int width, int ve, int lanes, int vpl) {
    return width >= 1 && width <= kMaxWidth && ve >= 1 && width % ve == 0 &&
           log2_of(lanes) >= 0 && lanes <= 32 && lanes * vpl * ve >= width &&
           ve * vpl <= kMaxPerLane;
}

struct FwdLaunch {
    const void *x, *gamma, *beta;
    long long rows;
    int width, lanes;
    float eps;
    int blocks;
    void *y, *mean, *rstd;
    cudaStream_t stream;

    template <typename T, int VE, int VPL>
    int run() const {
        if constexpr (VE * VPL > kMaxPerLane) {
            return static_cast<int>(cudaErrorInvalidValue);
        } else {
            ln_rows_fwd<T, VE, VPL><<<blocks, kThreads, 0, stream>>>(
                static_cast<const T*>(x), static_cast<const float*>(gamma),
                static_cast<const float*>(beta), rows, width, log2_of(lanes), eps,
                static_cast<T*>(y), static_cast<float*>(mean), static_cast<float*>(rstd));
            return static_cast<int>(cudaGetLastError());
        }
    }
};

struct BwdLaunch {
    const void *x, *dy, *mean, *rstd, *gamma;
    long long rows;
    int width, lanes, blocks;
    void *dx, *part;
    cudaStream_t stream;

    template <typename T, int VE, int VPL>
    int run() const {
        if constexpr (VE * VPL > kMaxPerLane) {
            return static_cast<int>(cudaErrorInvalidValue);
        } else {
            ln_rows_bwd<T, VE, VPL><<<blocks, kThreads, bwd_smem_bytes(width), stream>>>(
                static_cast<const T*>(x), static_cast<const T*>(dy),
                static_cast<const float*>(mean), static_cast<const float*>(rstd),
                static_cast<const float*>(gamma), rows, width, log2_of(lanes),
                static_cast<T*>(dx), static_cast<float*>(part));
            return static_cast<int>(cudaGetLastError());
        }
    }
};

struct Resources {
    int backward, width;
    int *registers, *local_bytes, *blocks_per_sm;

    template <typename T, int VE, int VPL>
    int run() const {
        if constexpr (VE * VPL > kMaxPerLane) {
            return static_cast<int>(cudaErrorInvalidValue);
        } else {
            const void* fn = backward ? reinterpret_cast<const void*>(ln_rows_bwd<T, VE, VPL>)
                                      : reinterpret_cast<const void*>(ln_rows_fwd<T, VE, VPL>);
            cudaFuncAttributes attr;
            cudaError_t err = cudaFuncGetAttributes(&attr, fn);
            if (err != cudaSuccess) return static_cast<int>(err);
            *registers = attr.numRegs;
            *local_bytes = static_cast<int>(attr.localSizeBytes);
            return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                blocks_per_sm, fn, kThreads, backward ? bwd_smem_bytes(width) : 0));
        }
    }
};

template <typename T, int VE, typename Op>
int with_vpl(int vpl, const Op& op) {
    switch (vpl) {
        case 1: return op.template run<T, VE, 1>();
        case 2: return op.template run<T, VE, 2>();
        case 4: return op.template run<T, VE, 4>();
        case 8: return op.template run<T, VE, 8>();
        case 16: return op.template run<T, VE, 16>();
    }
    return static_cast<int>(cudaErrorInvalidValue);
}

// The instantiation of (dtype, elements a load, loads a lane).
template <typename Op>
int dispatch(int is_bf16, int ve, int vpl, const Op& op) {
    if (is_bf16) {
        switch (ve) {
            case 1: return with_vpl<bf16, 1>(vpl, op);
            case 2: return with_vpl<bf16, 2>(vpl, op);
            case 4: return with_vpl<bf16, 4>(vpl, op);
            case 8: return with_vpl<bf16, 8>(vpl, op);
        }
    } else {
        switch (ve) {
            case 1: return with_vpl<float, 1>(vpl, op);
            case 2: return with_vpl<float, 2>(vpl, op);
            case 4: return with_vpl<float, 4>(vpl, op);
        }
    }
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// y (and, where mean and rstd are not null, each row's f32 mean and rstd)
// for rows x width elements of x. ve, lanes, vpl: the row plan.
extern "C" int ln_rows_fwd_launch(int is_bf16, const void* x, const void* gamma,
                                  const void* beta, long long rows, int width, int ve, int lanes,
                                  int vpl, float eps, int blocks, void* y, void* mean, void* rstd,
                                  void* stream) {
    if (rows == 0) return 0;
    if (rows < 0 || blocks < 1 || !plan_ok(width, ve, lanes, vpl) || (mean == nullptr) != (rstd == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    const FwdLaunch op{x, gamma, beta, rows, width, lanes, eps, blocks, y, mean, rstd,
                       static_cast<cudaStream_t>(stream)};
    return dispatch(is_bf16, ve, vpl, op);
}

// dx, and each block's [2][width] partial sums of dgamma and dbeta in part
// ([blocks][2][width] f32).
extern "C" int ln_rows_bwd_launch(int is_bf16, const void* x, const void* dy, const void* mean,
                                  const void* rstd, const void* gamma, long long rows, int width,
                                  int ve, int lanes, int vpl, int blocks, void* dx, void* part,
                                  void* stream) {
    if (rows < 0 || blocks < 1 || !plan_ok(width, ve, lanes, vpl))
        return static_cast<int>(cudaErrorInvalidValue);
    const BwdLaunch op{x, dy, mean, rstd, gamma, rows, width, lanes, blocks, dx, part,
                       static_cast<cudaStream_t>(stream)};
    return dispatch(is_bf16, ve, vpl, op);
}

// dgamma and dbeta from ln_rows_bwd's partials of `blocks` blocks.
extern "C" int ln_cols_sum_launch(const void* part, int blocks, int width, void* dgamma,
                                  void* dbeta, void* stream) {
    if (blocks < 1 || width < 1 || width > kMaxWidth) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 threads(32, kSumRows);
    ln_cols_sum<<<(2 * width + 31) / 32, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(part), blocks, width, static_cast<float*>(dgamma),
        static_cast<float*>(dbeta));
    return static_cast<int>(cudaGetLastError());
}

// One instantiation's registers and local (spilled) bytes a thread, and the
// blocks of 256 threads an SM holds at once (the backward with its shared
// memory at this width).
extern "C" int ln_rows_resources(int is_bf16, int ve, int vpl, int backward, int width,
                                 int* registers, int* local_bytes, int* blocks_per_sm) {
    if (width < 1 || width > kMaxWidth) return static_cast<int>(cudaErrorInvalidValue);
    const Resources op{backward, width, registers, local_bytes, blocks_per_sm};
    return dispatch(is_bf16, ve, vpl, op);
}
