// The expert layer's routing, dispatch and combine for Hopper (sm_90a),
// one chip's share of LFM2's expert layer (ops/moe.py):
//
//   moe_route_fwd    sigmoid scores, the top k by score + bias, weights
//                    normalised over the picks, each pair's held expert
//   moe_route_bwd    the router logits' gradient from the weights'
//   moe_count        pairs a held expert (and held elsewhere) per block
//   moe_scatter      the stable counting sort of the pairs by held expert:
//                    order, inverse and each held expert's end
//   moe_gather_fwd   the tokens' rows into the sorted pairs' rows
//   moe_gather_bwd   a token's gradient: the sum of its pairs' rows
//   moe_swiglu_fwd   silu(h1) * h3 over the held pairs' rows
//   moe_swiglu_bwd   its gradients
//   moe_combine_fwd  a token's output: its held pairs' rows, weighted
//   moe_combine_bwd  the pairs' rows' gradient and the weights'
//
// Replaces no TPU kernel: the JAX package has no expert layer. The grouped
// products between gather and combine are the library's grouped GEMM
// (torch._grouped_mm), which reads each expert's end on the device.
//
// Function (ops/moe.py held_experts, the same rounding points): the router
// in f32; every row of the sorted pairs in the compute dtype (bf16 or f32);
// the combine, the gather's gradient and the weights' gradient summed in
// f32 and rounded once. Nothing is read on the host: the number of held
// pairs is each kernel's read of the last end, on the device. Rows past it
// are neither read nor written.
//
// Bound: bytes (the router's 32 outputs a token are a small product). A
// token's row of D is read once by the gather and written once by the
// combine, forward and backward; the held pairs' rows (on average one a
// token where 8 of 32 experts are held and 4 picked) once each way.
//
// Design. The sort is a counting sort over held + 1 bins (the last holds
// the pairs of experts held elsewhere): moe_count counts each block's pairs
// a bin in shared memory; moe_scatter adds the counts of the blocks before
// it for its bases, then walks its pairs in rounds of a thread each, ranks
// a pair among the warp's of the same bin (__match_any_sync) and among the
// earlier warps' by their counts in shared memory: the sort is stable, and
// no atomics reach device memory. The row kernels give a block of 256
// threads a row (16 bytes a thread at D = 2048 in bf16). The weights'
// gradient is a dot product of two rows, summed over the block in a fixed
// order. The same inputs give the same bits every run.
//
// The C entries return cudaGetLastError() after the launch (or
// cudaErrorInvalidValue for a shape they do not take); the Python wrapper
// raises when it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxExperts = 64;    // router outputs a thread ranks
constexpr int kMaxTopK = 8;
constexpr int kMaxBins = 65;       // held experts + 1
constexpr int kPairsPerBlock = 4096;  // moe_count / moe_scatter: 16 rounds of 256
constexpr float kNormEps = 1e-6f;  // ops/moe.py NORM_EPS
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

__device__ __forceinline__ float sigmoidf(float v) { return 1.0f / (1.0f + __expf(-v)); }

// A token a thread. Ties in score + bias go to the lower expert.
__global__ void __launch_bounds__(kThreads)
moe_route_fwd(const float* __restrict__ logits, const float* __restrict__ bias, int tokens,
              int experts, int top_k, int first, int held, float scale, int* __restrict__ picks,
              float* __restrict__ weights, float* __restrict__ picked_scores,
              int* __restrict__ keys) {
    const int t = blockIdx.x * kThreads + threadIdx.x;
    if (t >= tokens) return;
    const float* row = logits + static_cast<long long>(t) * experts;
    float score[kMaxExperts], rank[kMaxExperts];
    for (int e = 0; e < experts; ++e) {
        score[e] = sigmoidf(row[e]);
        rank[e] = score[e] + bias[e];
    }
    int pick[kMaxTopK];
    float s[kMaxTopK], total = 0.0f;
    unsigned long long taken = 0ull;
    for (int j = 0; j < top_k; ++j) {
        int best = -1;
        for (int e = 0; e < experts; ++e)
            if (!((taken >> e) & 1ull) && (best < 0 || rank[e] > rank[best])) best = e;
        pick[j] = best;
        s[j] = score[best];
        taken |= 1ull << best;
        total += s[j];
    }
    const long long base = static_cast<long long>(t) * top_k;
    for (int j = 0; j < top_k; ++j) {
        picks[base + j] = pick[j];
        picked_scores[base + j] = s[j];
        weights[base + j] = s[j] / (total + kNormEps) * scale;
        const int local = pick[j] - first;
        keys[base + j] = (local >= 0 && local < held) ? local : held;
    }
}

// dlogits (tokens, experts): 0 but at the picks, where
// ds_i = scale * (dw_i / (S + eps) - sum_j dw_j s_j / (S + eps)^2) and
// dlogit_i = ds_i * s_i * (1 - s_i).
__global__ void __launch_bounds__(kThreads)
moe_route_bwd(const float* __restrict__ dweights, const int* __restrict__ picks,
              const float* __restrict__ picked_scores, int tokens, int experts, int top_k,
              float scale, float* __restrict__ dlogits) {
    const int t = blockIdx.x * kThreads + threadIdx.x;
    if (t >= tokens) return;
    const long long base = static_cast<long long>(t) * top_k;
    float total = 0.0f, dot = 0.0f;
    for (int j = 0; j < top_k; ++j) {
        total += picked_scores[base + j];
        dot += dweights[base + j] * picked_scores[base + j];
    }
    const float inv = 1.0f / (total + kNormEps);
    float* row = dlogits + static_cast<long long>(t) * experts;
    for (int e = 0; e < experts; ++e) row[e] = 0.0f;
    for (int j = 0; j < top_k; ++j) {
        const float sj = picked_scores[base + j];
        const float ds = scale * (dweights[base + j] * inv - dot * inv * inv);
        row[picks[base + j]] = ds * sj * (1.0f - sj);
    }
}

__global__ void __launch_bounds__(kThreads)
moe_count(const int* __restrict__ keys, long long pairs, int bins, int* __restrict__ counts) {
    __shared__ int local[kMaxBins];
    for (int b = threadIdx.x; b < bins; b += kThreads) local[b] = 0;
    __syncthreads();
    const long long start = static_cast<long long>(blockIdx.x) * kPairsPerBlock;
    for (int i = threadIdx.x; i < kPairsPerBlock; i += kThreads) {
        const long long p = start + i;
        if (p < pairs) atomicAdd(&local[keys[p]], 1);
    }
    __syncthreads();
    for (int b = threadIdx.x; b < bins; b += kThreads) counts[blockIdx.x * bins + b] = local[b];
}

// ends (held,) int32: the end of each held expert's rows; the pairs of
// experts held elsewhere follow the last.
__global__ void __launch_bounds__(kThreads)
moe_scatter(const int* __restrict__ keys, const int* __restrict__ counts, long long pairs,
            int bins, int* __restrict__ order, int* __restrict__ inverse, int* __restrict__ ends) {
    __shared__ int running[kMaxBins];
    __shared__ int warp_counts[kWarps][kMaxBins];
    const int blocks = gridDim.x;
    if (threadIdx.x < bins) {
        const int bin = threadIdx.x;
        int before_bins = 0, before_blocks = 0;
        for (int b = 0; b < blocks; ++b) {
            for (int k = 0; k < bin; ++k) before_bins += counts[b * bins + k];
            if (b < static_cast<int>(blockIdx.x)) before_blocks += counts[b * bins + bin];
        }
        running[bin] = before_bins + before_blocks;
        if (blockIdx.x == 0 && bin + 1 < bins) {
            int end = before_bins;
            for (int b = 0; b < blocks; ++b) end += counts[b * bins + bin];
            ends[bin] = end;
        }
    }
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const long long start = static_cast<long long>(blockIdx.x) * kPairsPerBlock;
    for (int round = 0; round < kPairsPerBlock; round += kThreads) {
        for (int i = threadIdx.x; i < kWarps * bins; i += kThreads)
            warp_counts[i / bins][i % bins] = 0;
        __syncthreads();
        const long long p = start + round + threadIdx.x;
        const bool live = p < pairs;
        const int key = live ? keys[p] : -1;
        const unsigned peers = __match_any_sync(kFull, key);
        const int rank = __popc(peers & ((1u << lane) - 1u));
        if (live && rank == 0) warp_counts[warp][key] = __popc(peers);
        __syncthreads();
        if (live) {
            int pos = running[key] + rank;
            for (int w = 0; w < warp; ++w) pos += warp_counts[w][key];
            order[pos] = static_cast<int>(p);
            inverse[p] = pos;
        }
        __syncthreads();
        if (threadIdx.x < bins) {
            int add = 0;
            for (int w = 0; w < kWarps; ++w) add += warp_counts[w][threadIdx.x];
            running[threadIdx.x] += add;
        }
        __syncthreads();
    }
}

// A block a sorted row r < the held pairs' count: xs[r] = x[order[r] / k].
template <typename T, int VE>
__global__ void __launch_bounds__(kThreads)
moe_gather_fwd(const void* x_, const int* __restrict__ order, const int* __restrict__ ends,
               int held, int top_k, int d, void* xs_) {
    const T* __restrict__ x = static_cast<const T*>(x_);
    T* __restrict__ xs = static_cast<T*>(xs_);
    const int r = blockIdx.x;
    if (r >= ends[held - 1]) return;
    const long long token = order[r] / top_k;
    for (int c = threadIdx.x * VE; c < d; c += kThreads * VE) {
        float v[VE];
        load<T, VE>(x + token * d + c, v);
        store<T, VE>(xs + static_cast<long long>(r) * d + c, v);
    }
}

// A block a token: dx[t] = the sum over its held pairs of dxs at their rows, in f32.
template <typename T, int VE>
__global__ void __launch_bounds__(kThreads)
moe_gather_bwd(const void* dxs_, const int* __restrict__ inverse, const int* __restrict__ ends,
               int held, int top_k, int d, void* dx_) {
    const T* __restrict__ dxs = static_cast<const T*>(dxs_);
    T* __restrict__ dx = static_cast<T*>(dx_);
    const long long t = blockIdx.x;
    const int total = ends[held - 1];
    int rows[kMaxTopK];
    for (int j = 0; j < top_k; ++j) rows[j] = inverse[t * top_k + j];
    for (int c = threadIdx.x * VE; c < d; c += kThreads * VE) {
        float acc[VE];
#pragma unroll
        for (int e = 0; e < VE; ++e) acc[e] = 0.0f;
        for (int j = 0; j < top_k; ++j) {
            if (rows[j] >= total) continue;
            float v[VE];
            load<T, VE>(dxs + static_cast<long long>(rows[j]) * d + c, v);
#pragma unroll
            for (int e = 0; e < VE; ++e) acc[e] += v[e];
        }
        store<T, VE>(dx + t * d + c, acc);
    }
}

// h = silu(h1) * h3 over the held rows, rounding silu(h1) first, as
// F.silu(h1) * h3 does.
template <typename T, int VE>
__global__ void __launch_bounds__(kThreads)
moe_swiglu_fwd(const void* h1_, const void* h3_, const int* __restrict__ ends, int held, int f,
               void* h_) {
    const T* __restrict__ h1 = static_cast<const T*>(h1_);
    const T* __restrict__ h3 = static_cast<const T*>(h3_);
    T* __restrict__ h = static_cast<T*>(h_);
    const long long items = static_cast<long long>(ends[held - 1]) * (f / VE);
    for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < items;
         i += static_cast<long long>(gridDim.x) * kThreads) {
        const long long at = i * VE;
        float a[VE], b[VE], out[VE];
        load<T, VE>(h1 + at, a);
        load<T, VE>(h3 + at, b);
#pragma unroll
        for (int e = 0; e < VE; ++e) {
            const float s = to_f32(from_f32<T>(a[e] * sigmoidf(a[e])));
            out[e] = s * b[e];
        }
        store<T, VE>(h + at, out);
    }
}

// dh1 = dh * h3 * silu'(h1), dh3 = dh * silu(h1) (silu(h1) rounded first).
template <typename T, int VE>
__global__ void __launch_bounds__(kThreads)
moe_swiglu_bwd(const void* dh_, const void* h1_, const void* h3_, const int* __restrict__ ends,
               int held, int f, void* dh1_, void* dh3_) {
    const T* __restrict__ dh = static_cast<const T*>(dh_);
    const T* __restrict__ h1 = static_cast<const T*>(h1_);
    const T* __restrict__ h3 = static_cast<const T*>(h3_);
    T* __restrict__ dh1 = static_cast<T*>(dh1_);
    T* __restrict__ dh3 = static_cast<T*>(dh3_);
    const long long items = static_cast<long long>(ends[held - 1]) * (f / VE);
    for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < items;
         i += static_cast<long long>(gridDim.x) * kThreads) {
        const long long at = i * VE;
        float g[VE], a[VE], b[VE], o1[VE], o3[VE];
        load<T, VE>(dh + at, g);
        load<T, VE>(h1 + at, a);
        load<T, VE>(h3 + at, b);
#pragma unroll
        for (int e = 0; e < VE; ++e) {
            const float sig = sigmoidf(a[e]);
            const float s = to_f32(from_f32<T>(a[e] * sig));
            o1[e] = g[e] * b[e] * (sig * (1.0f + a[e] * (1.0f - sig)));
            o3[e] = g[e] * s;
        }
        store<T, VE>(dh1 + at, o1);
        store<T, VE>(dh3 + at, o3);
    }
}

// A block a token: out[t] = the sum over its held pairs of w * y at their rows, in f32.
template <typename T, int VE>
__global__ void __launch_bounds__(kThreads)
moe_combine_fwd(const void* y_, const float* __restrict__ weights,
                const int* __restrict__ inverse, const int* __restrict__ ends, int held,
                int top_k, int d, void* out_) {
    const T* __restrict__ y = static_cast<const T*>(y_);
    T* __restrict__ out = static_cast<T*>(out_);
    const long long t = blockIdx.x;
    const int total = ends[held - 1];
    int rows[kMaxTopK];
    float w[kMaxTopK];
    for (int j = 0; j < top_k; ++j) {
        rows[j] = inverse[t * top_k + j];
        w[j] = weights[t * top_k + j];
    }
    for (int c = threadIdx.x * VE; c < d; c += kThreads * VE) {
        float acc[VE];
#pragma unroll
        for (int e = 0; e < VE; ++e) acc[e] = 0.0f;
        for (int j = 0; j < top_k; ++j) {
            if (rows[j] >= total) continue;
            float v[VE];
            load<T, VE>(y + static_cast<long long>(rows[j]) * d + c, v);
#pragma unroll
            for (int e = 0; e < VE; ++e) acc[e] += v[e] * w[j];
        }
        store<T, VE>(out + t * d + c, acc);
    }
}

// A block a sorted row r: for a held pair p = order[r] of token t,
// dys[r] = w[p] * dout[t] and dweights[p] = dout[t] . y[r]; for a pair held
// elsewhere dweights[p] = 0.
template <typename T, int VE>
__global__ void __launch_bounds__(kThreads)
moe_combine_bwd(const void* dout_, const void* y_, const float* __restrict__ weights,
                const int* __restrict__ order, const int* __restrict__ ends, int held, int top_k,
                int d, void* dys_, float* __restrict__ dweights) {
    const T* __restrict__ dout = static_cast<const T*>(dout_);
    const T* __restrict__ y = static_cast<const T*>(y_);
    T* __restrict__ dys = static_cast<T*>(dys_);
    __shared__ float sums[kWarps];
    const int r = blockIdx.x;
    const int p = order[r];
    if (r >= ends[held - 1]) {
        if (threadIdx.x == 0) dweights[p] = 0.0f;
        return;
    }
    const long long t = p / top_k;
    const float w = weights[p];
    float dot = 0.0f;
    for (int c = threadIdx.x * VE; c < d; c += kThreads * VE) {
        float g[VE], v[VE], o[VE];
        load<T, VE>(dout + t * d + c, g);
        load<T, VE>(y + static_cast<long long>(r) * d + c, v);
#pragma unroll
        for (int e = 0; e < VE; ++e) {
            dot += g[e] * v[e];
            o[e] = w * g[e];
        }
        store<T, VE>(dys + static_cast<long long>(r) * d + c, o);
    }
    for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(kFull, dot, o);
    if ((threadIdx.x & 31) == 0) sums[threadIdx.x >> 5] = dot;
    __syncthreads();
    if (threadIdx.x == 0) {
        float total = 0.0f;
        for (int w8 = 0; w8 < kWarps; ++w8) total += sums[w8];
        dweights[p] = total;
    }
}

cudaStream_t as_stream(void* s) { return static_cast<cudaStream_t>(s); }

int grid_for(long long items) { return static_cast<int>((items + kThreads - 1) / kThreads); }

}  // namespace

extern "C" int moe_route_launch(const void* logits, const void* bias, int tokens, int experts,
                                int top_k, int first, int held, float scale, void* picks,
                                void* weights, void* picked_scores, void* keys, void* stream) {
    if (tokens < 0 || experts < 1 || experts > kMaxExperts || top_k < 1 || top_k > kMaxTopK ||
        top_k > experts || held < 1 || held + 1 > kMaxBins)
        return static_cast<int>(cudaErrorInvalidValue);
    if (tokens == 0) return 0;
    moe_route_fwd<<<grid_for(tokens), kThreads, 0, as_stream(stream)>>>(
        static_cast<const float*>(logits), static_cast<const float*>(bias), tokens, experts, top_k,
        first, held, scale, static_cast<int*>(picks), static_cast<float*>(weights),
        static_cast<float*>(picked_scores), static_cast<int*>(keys));
    return static_cast<int>(cudaGetLastError());
}

extern "C" int moe_route_bwd_launch(const void* dweights, const void* picks,
                                    const void* picked_scores, int tokens, int experts, int top_k,
                                    float scale, void* dlogits, void* stream) {
    if (tokens < 0 || experts < 1 || experts > kMaxExperts || top_k < 1 || top_k > kMaxTopK)
        return static_cast<int>(cudaErrorInvalidValue);
    if (tokens == 0) return 0;
    moe_route_bwd<<<grid_for(tokens), kThreads, 0, as_stream(stream)>>>(
        static_cast<const float*>(dweights), static_cast<const int*>(picks),
        static_cast<const float*>(picked_scores), tokens, experts, top_k, scale,
        static_cast<float*>(dlogits));
    return static_cast<int>(cudaGetLastError());
}

// The sort of `pairs` keys in [0, bins): counts ([blocks][bins] int32,
// blocks = ceil(pairs / 4096)) as scratch; order, inverse (pairs,) and
// ends (bins - 1,) int32 out.
extern "C" int moe_sort_launch(const void* keys, long long pairs, int bins, void* counts,
                               void* order, void* inverse, void* ends, void* stream) {
    if (pairs < 1 || bins < 2 || bins > kMaxBins || pairs > 0x7fffffffLL)
        return static_cast<int>(cudaErrorInvalidValue);
    const int blocks = static_cast<int>((pairs + kPairsPerBlock - 1) / kPairsPerBlock);
    moe_count<<<blocks, kThreads, 0, as_stream(stream)>>>(static_cast<const int*>(keys), pairs,
                                                          bins, static_cast<int*>(counts));
    int code = static_cast<int>(cudaGetLastError());
    if (code != 0) return code;
    moe_scatter<<<blocks, kThreads, 0, as_stream(stream)>>>(
        static_cast<const int*>(keys), static_cast<const int*>(counts), pairs, bins,
        static_cast<int*>(order), static_cast<int*>(inverse), static_cast<int*>(ends));
    return static_cast<int>(cudaGetLastError());
}

// The row kernels' instantiation for (dtype, elements a load): bf16 with 8
// or 1, f32 with 4 or 1.
#define MOE_ROWS(KERNEL, GRID, ...)                                                        \
    do {                                                                                   \
        const cudaStream_t st = as_stream(stream);                                         \
        const unsigned grid = static_cast<unsigned>(GRID);                                 \
        if (is_bf16 && ve == 8)                                                            \
            KERNEL<bf16, 8><<<grid, kThreads, 0, st>>>(__VA_ARGS__);                       \
        else if (is_bf16 && ve == 1)                                                       \
            KERNEL<bf16, 1><<<grid, kThreads, 0, st>>>(__VA_ARGS__);                       \
        else if (!is_bf16 && ve == 4)                                                      \
            KERNEL<float, 4><<<grid, kThreads, 0, st>>>(__VA_ARGS__);                      \
        else if (!is_bf16 && ve == 1)                                                      \
            KERNEL<float, 1><<<grid, kThreads, 0, st>>>(__VA_ARGS__);                      \
        else                                                                               \
            return static_cast<int>(cudaErrorInvalidValue);                                \
        return static_cast<int>(cudaGetLastError());                                       \
    } while (0)

#define I32(p) static_cast<const int*>(p)
#define F32(p) static_cast<const float*>(p)

// xs rows 0 .. held pairs - 1 (a block a row of the pairs).
extern "C" int moe_gather_launch(int is_bf16, int ve, const void* x, const void* order,
                                 const void* ends, int held, int top_k, long long pairs, int d,
                                 void* xs, void* stream) {
    if (pairs < 1 || d < 1 || d % ve != 0 || held < 1) return static_cast<int>(cudaErrorInvalidValue);
    MOE_ROWS(moe_gather_fwd, pairs, x, I32(order), I32(ends), held, top_k, d, xs);
}

// dx (tokens, d), a block a token.
extern "C" int moe_gather_bwd_launch(int is_bf16, int ve, const void* dxs, const void* inverse,
                                     const void* ends, int held, int top_k, long long tokens,
                                     int d, void* dx, void* stream) {
    if (tokens < 1 || d < 1 || d % ve != 0 || held < 1 || top_k > kMaxTopK)
        return static_cast<int>(cudaErrorInvalidValue);
    MOE_ROWS(moe_gather_bwd, tokens, dxs, I32(inverse), I32(ends), held, top_k, d, dx);
}

// h over the held rows, `blocks` blocks walking them.
extern "C" int moe_swiglu_launch(int is_bf16, int ve, const void* h1, const void* h3,
                                 const void* ends, int held, int f, int blocks, void* h,
                                 void* stream) {
    if (f < 1 || f % ve != 0 || held < 1 || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
    MOE_ROWS(moe_swiglu_fwd, blocks, h1, h3, I32(ends), held, f, h);
}

extern "C" int moe_swiglu_bwd_launch(int is_bf16, int ve, const void* dh, const void* h1,
                                     const void* h3, const void* ends, int held, int f,
                                     int blocks, void* dh1, void* dh3, void* stream) {
    if (f < 1 || f % ve != 0 || held < 1 || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
    MOE_ROWS(moe_swiglu_bwd, blocks, dh, h1, h3, I32(ends), held, f, dh1, dh3);
}

// out (tokens, d), a block a token.
extern "C" int moe_combine_launch(int is_bf16, int ve, const void* y, const void* weights,
                                  const void* inverse, const void* ends, int held, int top_k,
                                  long long tokens, int d, void* out, void* stream) {
    if (tokens < 1 || d < 1 || d % ve != 0 || held < 1 || top_k > kMaxTopK)
        return static_cast<int>(cudaErrorInvalidValue);
    MOE_ROWS(moe_combine_fwd, tokens, y, F32(weights), I32(inverse), I32(ends), held, top_k, d, out);
}

// dys (rows, d) for the held rows and dweights (pairs,) f32, a block a row.
extern "C" int moe_combine_bwd_launch(int is_bf16, int ve, const void* dout, const void* y,
                                      const void* weights, const void* order, const void* ends,
                                      int held, int top_k, long long pairs, int d, void* dys,
                                      void* dweights, void* stream) {
    if (pairs < 1 || d < 1 || d % ve != 0 || held < 1) return static_cast<int>(cudaErrorInvalidValue);
    MOE_ROWS(moe_combine_bwd, pairs, dout, y, F32(weights), I32(order), I32(ends), held, top_k, d,
             dys, static_cast<float*>(dweights));
}
