// Eval-mode residual block for Hopper (sm_90a), BatchNorm folded:
//     h = relu(conv1(x) + b1)            (rounded to x's type, as the TPU kernel does)
//     y = relu(conv2(h) + b2 + x)
// with 3x3 SAME convolutions on an M x N board, channels-last activations
// (B, M*N, C) in bf16 or f32, weights in im2col layout (9C, C) ordered
// (dy, dx, cin) in the activation type, biases f32, f32 accumulation.
//
// Replaces the TPU kernel rl_selfplay_mnk_tpu/ops/pallas_resnet.py
// (_resblock_kernel, entry fused_residual_block).
//
// Bound: at the main path's shape (B=384 boards, 9x9, C=32, bf16) one call
// does 2 * 2*B*MN*9C*C = 1.15 GFLOP on 4 MB of x and y: 1.16 us at the
// tensor cores' bf16 peak against 1.19 us at the memory rate, so bytes bound
// the ideal time, barely. This first version does its products with FMA on
// the CUDA cores (67 TFLOP/s f32 peak: 17 us for the same work) and is bound
// by them; moving the products to mma/wgmma is later work.
// What the design does: a block owns a tile of boards and keeps x,
// the intermediate h and a 16-output-channel slice of one conv's weights
// in shared memory, so h never goes to device memory and x is read once.
// Activations are stored channel-major with a zero halo around each board,
// so the 3x3 patches are plain offsets into shared memory (no im2col in
// device memory, no bounds tests in the inner loop) and neighbouring
// threads read neighbouring positions (no bank conflicts). Each thread
// accumulates a 2-position x 8-channel tile in registers.
//
// The C entry returns cudaGetLastError() after the launch; the Python
// wrapper (ops/resblock.py) raises when it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCC = 16;                      // output channels per weight slice
constexpr int kRC = 8;                       // output channels per thread
constexpr int kLanes = kThreads / (kCC / kRC);  // 128 position lanes
constexpr int kRP = 2;                       // positions per thread per pass
constexpr int kPass = kLanes * kRP;          // 256 positions per pass

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
    return __float2bfloat16(v);
}

// Eight consecutive weights (16-byte aligned) as floats.
__device__ __forceinline__ void load8(const float* p, float* out) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        out[2 * i] = f.x;
        out[2 * i + 1] = f.y;
    }
}

__host__ __device__ inline size_t align16(size_t bytes) { return (bytes + 15) & ~size_t(15); }

template <typename T>
__host__ __device__ inline size_t act_elems(int C, int TB, int M, int N) {
    return static_cast<size_t>(C) * TB * (M + 2) * (N + 2);
}

template <typename T>
__host__ __device__ inline size_t smem_bytes(int C, int TB, int M, int N) {
    return align16(2 * act_elems<T>(C, TB, M, N) * sizeof(T))
           + static_cast<size_t>(9) * C * kCC * sizeof(T);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) resblock_kernel(
    const T* __restrict__ x,        // (B, MN, C)
    const T* __restrict__ w1,       // (9C, C)
    const float* __restrict__ b1,   // (C,)
    const T* __restrict__ w2,       // (9C, C)
    const float* __restrict__ b2,   // (C,)
    T* __restrict__ y,              // (B, MN, C)
    int B, int M, int N, int C, int TB)
{
    extern __shared__ __align__(16) unsigned char smem[];
    const int MN = M * N;
    const int PW = N + 2;
    const int HW = (M + 2) * PW;
    const int cstride = TB * HW;                         // channel stride in shared memory
    const size_t nact = act_elems<T>(C, TB, M, N);
    T* xs = reinterpret_cast<T*>(smem);                  // (C, TB, M+2, N+2)
    T* hs = xs + nact;                                   // (C, TB, M+2, N+2)
    T* ws = reinterpret_cast<T*>(smem + align16(2 * nact * sizeof(T)));  // (9C, kCC)

    const int tid = threadIdx.x;
    const int board0 = blockIdx.x * TB;
    const int nb = min(TB, B - board0);
    const int P = nb * MN;
    const size_t base = static_cast<size_t>(board0) * MN * C;

    for (size_t i = tid; i < 2 * nact; i += kThreads) xs[i] = from_f<T>(0.0f);
    __syncthreads();
    for (int i = tid; i < P * C; i += kThreads) {
        const int c = i % C;
        const int p = i / C;
        const int b = p / MN, q = p % MN;
        xs[c * cstride + b * HW + (q / N + 1) * PW + (q % N) + 1] = x[base + i];
    }

    const int lane = tid % kLanes;
    const int cg = tid / kLanes;
    const int K = 9 * C;

    for (int conv = 0; conv < 2; ++conv) {
        const T* W = conv == 0 ? w1 : w2;
        const float* bias = conv == 0 ? b1 : b2;
        const T* src = conv == 0 ? xs : hs;
        for (int c0 = 0; c0 < C; c0 += kCC) {
            __syncthreads();  // earlier readers of ws (and writers of hs) are done
            for (int i = tid; i < K * kCC; i += kThreads) {
                ws[i] = W[static_cast<size_t>(i / kCC) * C + c0 + i % kCC];
            }
            __syncthreads();
            for (int p0 = 0; p0 < P; p0 += kPass) {
                int center[kRP];
#pragma unroll
                for (int j = 0; j < kRP; ++j) {
                    const int p = p0 + lane + j * kLanes;
                    // Positions past the tile read board 0's first cell; their sums are dropped.
                    const int pp = p < P ? p : 0;
                    const int b = pp / MN, q = pp % MN;
                    center[j] = b * HW + (q / N + 1) * PW + (q % N) + 1;
                }
                float acc[kRP][kRC];
#pragma unroll
                for (int j = 0; j < kRP; ++j)
#pragma unroll
                    for (int r = 0; r < kRC; ++r) acc[j][r] = 0.0f;

                for (int tap = 0; tap < 9; ++tap) {
                    const int d = (tap / 3 - 1) * PW + (tap % 3 - 1);
                    const T* wrow = ws + tap * C * kCC + cg * kRC;
                    const T* s0 = src + center[0] + d;
                    const T* s1 = src + center[1] + d;
#pragma unroll 4
                    for (int ci = 0; ci < C; ++ci) {
                        float wv[kRC];
                        load8(wrow + ci * kCC, wv);
                        const float a0 = to_f(s0[ci * cstride]);
                        const float a1 = to_f(s1[ci * cstride]);
#pragma unroll
                        for (int r = 0; r < kRC; ++r) {
                            acc[0][r] = fmaf(a0, wv[r], acc[0][r]);
                            acc[1][r] = fmaf(a1, wv[r], acc[1][r]);
                        }
                    }
                }

#pragma unroll
                for (int j = 0; j < kRP; ++j) {
                    const int p = p0 + lane + j * kLanes;
                    if (p >= P) continue;
#pragma unroll
                    for (int r = 0; r < kRC; ++r) {
                        const int c = c0 + cg * kRC + r;
                        float v = acc[j][r] + bias[c];
                        if (conv == 0) {
                            hs[c * cstride + center[j]] = from_f<T>(fmaxf(v, 0.0f));
                        } else {
                            v += to_f(xs[c * cstride + center[j]]);
                            y[base + static_cast<size_t>(p) * C + c] = from_f<T>(fmaxf(v, 0.0f));
                        }
                    }
                }
            }
        }
    }
}

template <typename T>
int launch(const void* x, const void* w1, const void* b1, const void* w2,
           const void* b2, void* y, int B, int M, int N, int C, int TB,
           cudaStream_t stream)
{
    const size_t smem = smem_bytes<T>(C, TB, M, N);
    static bool attribute_set = false;
    if (!attribute_set) {
        int device = 0, max_optin = 0;
        cudaGetDevice(&device);
        cudaDeviceGetAttribute(&max_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
        cudaError_t err = cudaFuncSetAttribute(
            resblock_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, max_optin);
        if (err != cudaSuccess) return static_cast<int>(err);
        attribute_set = true;
    }
    const int blocks = (B + TB - 1) / TB;
    resblock_kernel<T><<<blocks, kThreads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w1), static_cast<const float*>(b1),
        static_cast<const T*>(w2), static_cast<const float*>(b2), static_cast<T*>(y),
        B, M, N, C, TB);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory one block needs: the wrapper picks the boards per block (TB)
// against the card's per-block limit with this.
extern "C" size_t resblock_smem_bytes(int is_bf16, int C, int TB, int M, int N) {
    return is_bf16 ? smem_bytes<__nv_bfloat16>(C, TB, M, N) : smem_bytes<float>(C, TB, M, N);
}

extern "C" int resblock_launch(
    int is_bf16, const void* x, const void* w1, const void* b1, const void* w2,
    const void* b2, void* y, int B, int M, int N, int C, int TB, void* stream)
{
    if (B == 0) return 0;
    if (C % kCC != 0) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return is_bf16 ? launch<__nv_bfloat16>(x, w1, b1, w2, b2, y, B, M, N, C, TB, s)
                   : launch<float>(x, w1, b1, w2, b2, y, B, M, N, C, TB, s);
}
