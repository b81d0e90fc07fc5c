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
// Bound: at the main path's shape (B = 384 boards, 9x9, C = 32, bf16) one
// call does 2 * 2*B*MN*9C*C = 1.15 GFLOP on 4 MB of x and y: 1.16 us at the
// tensor cores' bf16 peak against 1.19 us at the memory rate, so bytes bound
// the ideal time, barely. At the tournament's B = 16 and play's B = 1 the
// work is a few microseconds' latency on a few SMs, whatever the rates.
//
// Two kernels, chosen by the activation type in the Python wrapper
// (ops/resblock.py):
//
// bf16, resblock_mma_kernel: each conv is an implicit GEMM, (positions x 9C)
// . (9C x C), on the tensor cores (mma.sync m16n8k16, f32 sums; building
// blocks in mma_common.cuh). What the design does about the bound:
//  - one board per block while there are no more boards than SMs, so a
//    tournament's 16 boards run on 16 SMs; past that ceil(B / SMs) boards a
//    block (at most eight), so fewer blocks read the weights, which every
//    block needs (the plan is ops/resblock.py::mma_block_plan);
//  - x and h stay in shared memory position-major with a zero halo,
//    [board][(M+2)(N+2)][C + 8], so the A fragment of tap (dy, dx) is an
//    ldmatrix of 16 rows offset by dy*(N+2) + dx: the patches are never
//    built, and the row stride of an odd number of 16-byte words keeps the
//    eight rows of one ldmatrix on different banks (up to the jumps at a
//    board row's end);
//  - x and the weights arrive by cp.async, every copy of a thread in flight
//    at once; at C = 32 both convs' weights sit in shared memory whole,
//    where they do not fit each conv walks output-channel slices;
//  - a warp owns 16 output positions and all channels of the slice, and
//    loads the next k-step's fragments while the tensor cores multiply
//    this one's;
//  - h = relu(conv1 + b1) is rounded to bf16 once into a second shared
//    buffer, which conv2 reads; conv2's sums get b2 and x (read back from
//    shared memory), go through the ReLU and are written over x, and the
//    block then stores y in 16-byte stores. Position rows past the block's
//    last board (81 = 5*16 + 1) read a valid row and are dropped.
//
// f32, resblock_kernel: the first version, FMA on the CUDA cores (67 TFLOP/s
// f32 peak: 17 us for the work above). A tensor-core product of f32 data
// would be TF32, whose rounding does not meet the f32 comparison limit.
// A block owns a tile of boards and keeps x, the intermediate h and a
// 16-output-channel slice of one conv's weights in shared memory, so h never
// goes to device memory and x is read once. Activations are stored
// channel-major with a zero halo around each board, so the 3x3 patches are
// plain offsets into shared memory and neighbouring threads read
// neighbouring positions (no bank conflicts). Each thread accumulates a
// 2-position x 8-channel tile in registers. It takes bf16 too.
//
// Each C entry returns cudaGetLastError() after the launch; the Python
// wrapper raises when it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"

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

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kMmaMaxWarps = 16;
// The most 16-channel groups a slice has: 96 output channels. A wider slice
// of 9C weight rows does not fit an H100 block's shared memory next to a board.
constexpr int kMmaMaxGroups = 6;

// Shared memory of one block of the tensor-core kernel, in bytes: the weight
// buffers (both convs' weights whole, or one output-channel slice of CS at a
// time), x and h of TB boards, and both biases in f32.
// ops/resblock.py::mma_smem_bytes repeats this to plan without a card.
__host__ __device__ inline size_t mma_smem_bytes(int C, int TB, int M, int N, int CS, int whole) {
    const size_t weights = static_cast<size_t>(whole ? 2 : 1) * 9 * C * (CS + 8);
    const size_t acts = static_cast<size_t>(2) * TB * (M + 2) * (N + 2) * (C + 8);
    return (weights + acts) * sizeof(bf16) + 2 * C * sizeof(float);
}

// Starts the copies of rows k of a (9C, C) weight matrix, columns c0 .. c0 +
// CS, into rows of ldw; cp_async_wait_all and a barrier finish them.
__device__ __forceinline__ void stage_weights(uint32_t dst, const bf16* __restrict__ w, int K, int C,
                                              int c0, int CS, int ldw) {
    const int chunks = CS / 8;
    const FastDiv per_row(chunks);
    for (int i = threadIdx.x; i < K * chunks; i += blockDim.x) {
        const int k = per_row(i), ch = i - k * chunks;
        cp_async_16(dst + (k * ldw + ch * 8) * 2, w + static_cast<size_t>(k) * C + c0 + ch * 8);
    }
}

// One k-step's fragments: A (16 positions x 16 input channels) and B (16
// input channels x 16 output channels) for each group of the slice.
template <int kGroups>
struct KStep {
    uint32_t a[4];
    uint32_t b[kGroups][4];

    __device__ __forceinline__ void load(uint32_t a_addr, uint32_t b_addr) {
        ldmatrix_x4(a, a_addr);
#pragma unroll
        for (int gi = 0; gi < kGroups; ++gi) ldmatrix_x4_trans(b[gi], b_addr + gi * 32);
    }
    __device__ __forceinline__ void multiply(float (&acc)[2 * kGroups][4]) const {
#pragma unroll
        for (int gi = 0; gi < kGroups; ++gi) {
            mma_bf16_16816(acc[2 * gi], a, b[gi][0], b[gi][1]);
            mma_bf16_16816(acc[2 * gi + 1], a, b[gi][2], b[gi][3]);
        }
    }
};

// Walks the k-steps of a 3x3 conv in order (tap-major, then 16 input
// channels): the A row moves 32 bytes a step and jumps to the next tap's
// offset after the last channel group; B moves 16 weight rows a step.
struct KWalk {
    uint32_t a, b;
    int ci, dx;
    const int csteps, b_step, col_jump, row_jump;

    __device__ __forceinline__ KWalk(uint32_t a0, uint32_t b0, int C, int lda, int ldw, int PW)
        : a(a0), b(b0), ci(0), dx(0), csteps(C / 16), b_step(16 * ldw * 2),
          col_jump(lda * 2 - C * 2), row_jump((PW - 2) * lda * 2 - C * 2) {}
    __device__ __forceinline__ void next() {
        a += 32;
        b += b_step;
        if (++ci == csteps) {
            ci = 0;
            a += dx == 2 ? row_jump : col_jump;
            dx = dx == 2 ? 0 : dx + 1;
        }
    }
};

// kGroups: the 16-channel groups of an output-channel slice (CS = 16 kGroups).
template <int kGroups>
__global__ void __launch_bounds__(kMmaMaxWarps * 32) resblock_mma_kernel(
    const bf16* __restrict__ x,     // (B, MN, C)
    const bf16* __restrict__ w1,    // (9C, C)
    const float* __restrict__ b1,   // (C,)
    const bf16* __restrict__ w2,    // (9C, C)
    const float* __restrict__ b2,   // (C,)
    bf16* __restrict__ y,           // (B, MN, C)
    int B, int M, int N, int C, int TB, int whole)
{
    constexpr int CS = 16 * kGroups;
    extern __shared__ __align__(16) unsigned char smem[];
    const int MN = M * N;
    const int PW = N + 2;
    const int HW = (M + 2) * PW;
    const int K = 9 * C;
    const int lda = C + 8;    // activation row: odd number of 16-byte words (C % 16 == 0)
    const int ldw = CS + 8;   // weight row, the same
    bf16* ws = reinterpret_cast<bf16*>(smem);                          // (whole ? 2 : 1) x (K, ldw)
    bf16* xs = ws + static_cast<size_t>(whole ? 2 : 1) * K * ldw;      // (TB, HW, lda)
    bf16* hs = xs + static_cast<size_t>(TB) * HW * lda;                // (TB, HW, lda)
    float* bs = reinterpret_cast<float*>(hs + static_cast<size_t>(TB) * HW * lda);  // b1, b2
    const uint32_t ws_at = shared_address(ws), xs_at = shared_address(xs), hs_at = shared_address(hs);

    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31, nwarps = blockDim.x >> 5;
    const int board0 = blockIdx.x * TB;
    const int nb = min(TB, B - board0);
    const int P = nb * MN;
    const size_t base = static_cast<size_t>(board0) * MN * C;
    const int chunks = C / 8;  // 16-byte pieces of a position's channels
    const FastDiv per_position(chunks), per_board(MN), per_row(N);
    // The padded shared row of position p of the block.
    auto row_of = [&](int p) {
        const int b = per_board(p), q = p - b * MN;
        const int r = per_row(q);
        return b * HW + (r + 1) * PW + (q - r * N) + 1;
    };

    // x and the weights start copying; the halo rows of x and h are zero
    // (their interiors are written below), the biases go to shared memory.
    for (int i = tid; i < P * chunks; i += blockDim.x) {
        const int p = per_position(i), ch = i - p * chunks;
        cp_async_16(xs_at + (row_of(p) * lda + ch * 8) * 2, x + base + static_cast<size_t>(i) * 8);
    }
    if (whole) {
        stage_weights(ws_at, w1, K, C, 0, CS, ldw);
        stage_weights(ws_at + K * ldw * 2, w2, K, C, 0, CS, ldw);
    }
    const int halo = 2 * PW + 2 * M;
    const FastDiv per_halo(halo);
    for (int i = tid; i < TB * halo * chunks; i += blockDim.x) {
        const int j = per_position(i), ch = i - j * chunks;
        const int b = per_halo(j), e = j - b * halo;
        int r, c;
        if (e < PW) { r = 0; c = e; }
        else if (e < 2 * PW) { r = M + 1; c = e - PW; }
        else { r = 1 + (e - 2 * PW) / 2; c = ((e - 2 * PW) & 1) ? N + 1 : 0; }
        const size_t at = (static_cast<size_t>(b) * HW + r * PW + c) * lda + ch * 8;
        *reinterpret_cast<uint4*>(xs + at) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(hs + at) = make_uint4(0, 0, 0, 0);
    }
    for (int i = tid; i < 2 * C; i += blockDim.x) bs[i] = i < C ? b1[i] : b2[i - C];

    // This lane's row in an ldmatrix of A (or of B), as a byte offset.
    const int a_lane = a_row_of_lane(lane);
    const int half8 = a_half_of_lane(lane) * 8;
    const uint32_t w_lane = (a_lane * ldw + half8) * 2;
    const int g = frag_row(lane), tc = frag_col(lane);
    const int tiles = (P + 15) / 16;
    const int steps = 9 * (C / 16);

    for (int conv = 0; conv < 2; ++conv) {
        const uint32_t src_at = conv == 0 ? xs_at : hs_at;
        bf16* dst = conv == 0 ? hs : xs;
        const float* bias = bs + conv * C;
        for (int c0 = 0; c0 < C; c0 += CS) {
            if (!whole) {
                __syncthreads();  // the last slice's readers are done with ws
                stage_weights(ws_at, conv == 0 ? w1 : w2, K, C, c0, CS, ldw);
            }
            cp_async_wait_all();
            __syncthreads();  // x and the weights staged; h complete before conv2
            const uint32_t w_at = ws_at + (whole && conv == 1 ? K * ldw * 2 : 0) + w_lane;
            for (int tile = warp; tile < tiles; tile += nwarps) {
                // Positions past the block's boards read position P - 1; dropped below.
                const int center = row_of(min(tile * 16 + a_lane, P - 1));
                KWalk walk(src_at + ((center - PW - 1) * lda + half8) * 2, w_at, C, lda, ldw, PW);

                float acc[2 * kGroups][4];
#pragma unroll
                for (int j = 0; j < 2 * kGroups; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

                // Two steps' fragments in registers: the next step loads while
                // this one multiplies.
                KStep<kGroups> even, odd;
                even.load(walk.a, walk.b);
                walk.next();
                for (int s = 0; s < steps; s += 2) {
                    const bool has_odd = s + 1 < steps;
                    if (has_odd) {
                        odd.load(walk.a, walk.b);
                        walk.next();
                    }
                    even.multiply(acc);
                    if (s + 2 < steps) {
                        even.load(walk.a, walk.b);
                        walk.next();
                    }
                    if (has_odd) odd.multiply(acc);
                }

                // Epilogue: this lane's rows g and g + 8, channel pairs 2t, 2t + 1.
#pragma unroll
                for (int rr = 0; rr < 2; ++rr) {
                    const int p = tile * 16 + g + 8 * rr;
                    if (p >= P) continue;
                    bf16* row = dst + row_of(p) * lda;
#pragma unroll
                    for (int j = 0; j < 2 * kGroups; ++j) {
                        const int c = c0 + j * 8 + tc;
                        const float2 bv = *reinterpret_cast<const float2*>(bias + c);
                        float v0 = acc[j][2 * rr] + bv.x;
                        float v1 = acc[j][2 * rr + 1] + bv.y;
                        if (conv == 1) {  // y = relu(conv2 + b2 + x), over x
                            const float2 xv = __bfloat1622float2(
                                *reinterpret_cast<const __nv_bfloat162*>(row + c));
                            v0 += xv.x;
                            v1 += xv.y;
                        }
                        *reinterpret_cast<uint32_t*>(row + c) =
                            pack_bf16(fmaxf(v0, 0.0f), fmaxf(v1, 0.0f));
                    }
                }
            }
        }
    }
    __syncthreads();
    for (int i = tid; i < P * chunks; i += blockDim.x) {
        const int p = per_position(i), ch = i - p * chunks;
        *reinterpret_cast<uint4*>(y + base + static_cast<size_t>(i) * 8) =
            *reinterpret_cast<const uint4*>(xs + row_of(p) * lda + ch * 8);
    }
}

template <int kGroups>
int launch_mma(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
               void* y, int B, int M, int N, int C, int TB, int whole, int threads,
               cudaStream_t stream) {
    static bool allowed = false;
    if (!allowed) {
        int device = 0, max_optin = 0;
        cudaGetDevice(&device);
        cudaDeviceGetAttribute(&max_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
        const cudaError_t err = cudaFuncSetAttribute(
            resblock_mma_kernel<kGroups>, cudaFuncAttributeMaxDynamicSharedMemorySize, max_optin);
        if (err != cudaSuccess) return static_cast<int>(err);
        allowed = true;
    }
    const int blocks = (B + TB - 1) / TB;
    const size_t smem = mma_smem_bytes(C, TB, M, N, 16 * kGroups, whole);
    resblock_mma_kernel<kGroups><<<blocks, threads, smem, stream>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w1), static_cast<const float*>(b1),
        static_cast<const bf16*>(w2), static_cast<const float*>(b2), static_cast<bf16*>(y),
        B, M, N, C, TB, whole);
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

// The tensor-core kernel's shared memory per block (see mma_smem_bytes).
extern "C" size_t resblock_mma_smem_bytes(int C, int TB, int M, int N, int CS, int whole) {
    return mma_smem_bytes(C, TB, M, N, CS, whole);
}

// bf16 only. TB boards a block, output-channel slices of CS <= 96 (whole:
// CS == C and both convs' weights staged at once), `threads` a multiple of 32.
extern "C" int resblock_mma_launch(
    const void* x, const void* w1, const void* b1, const void* w2, const void* b2, void* y,
    int B, int M, int N, int C, int TB, int CS, int whole, int threads, void* stream)
{
    if (B == 0) return 0;
    if (C % 16 != 0 || CS % 16 != 0 || CS < 16 || CS > 16 * kMmaMaxGroups || C % CS != 0
        || (whole && CS != C)
        || TB < 1 || threads < 32 || threads > kMmaMaxWarps * 32 || threads % 32 != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (CS / 16) {
        case 1: return launch_mma<1>(x, w1, b1, w2, b2, y, B, M, N, C, TB, whole, threads, s);
        case 2: return launch_mma<2>(x, w1, b1, w2, b2, y, B, M, N, C, TB, whole, threads, s);
        case 3: return launch_mma<3>(x, w1, b1, w2, b2, y, B, M, N, C, TB, whole, threads, s);
        case 4: return launch_mma<4>(x, w1, b1, w2, b2, y, B, M, N, C, TB, whole, threads, s);
        case 5: return launch_mma<5>(x, w1, b1, w2, b2, y, B, M, N, C, TB, whole, threads, s);
        default: return launch_mma<6>(x, w1, b1, w2, b2, y, B, M, N, C, TB, whole, threads, s);
    }
}
