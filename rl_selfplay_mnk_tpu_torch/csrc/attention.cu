// Dense softmax attention over board tokens for Hopper (sm_90a), forward and
// backward, in the two layouts the transformer families use:
//
//     folded  q, k, v, o (BH, Dh, L)       one head per leading index, L contiguous
//     packed  q, k, v, o (B, L, D = H*Dh)  a head's Dh values contiguous inside a row
//
//     s  = (q . k) * 1/sqrt(Dh)            f32
//     p  = softmax(s) over the keys        f32
//     o  = round(p) . v                    p rounded to the tensors' type first
//     dp = dO . v
//     ds = round(p * (dp - rowsum(dp * p)) * scale)
//     dq = ds . k,  dk = ds^T . q,  dv = round(p)^T . dO
//
// with bf16 or f32 tensors, f32 sums, outputs rounded to the tensors' type.
//
// Replaces the TPU kernels of rl_selfplay_mnk_tpu/ops/pallas_attention.py:
// _attn_kernel (attn_folded_fwd), _attn_bwd_kernel (attn_folded_bwd),
// _packed_fwd_kernel (attn_packed_fwd) and _packed_bwd_kernel
// (attn_packed_bwd). What those kernels exist for is kept: no L x L tensor
// reaches device memory. Their head tiles, lane masks and padding masks are
// answers to the TPU's memory tiling and are not carried over.
//
// Bound: a forward call moves 4*B*L*D elements and does 4*B*H*L*L*Dh
// operations, a backward call 7*B*L*D elements and 10*B*H*L*L*Dh operations.
// At the trainer's shapes (B = 8192, L = 81, H = 4, Dh = 14, and B = 4096,
// L = 169, H = 2, Dh = 64, bf16) the memory time exceeds the tensor cores'
// time, so bytes bound the ideal: 0.089 ms for K3 at the first shape.
//
// The folded forward in bf16 (attn_folded_fwd_mma, below) does both
// products on the tensor cores; even padded to 16 (Dh) and 96 (L) they take
// about 20 us at the bf16 peak against the 89 us of bytes. What is left
// besides the bytes is the f32 softmax on the score tiles in registers, and
// the design keeps that to one pass: a block takes up to four consecutive
// heads, reads their contiguous span with 16-byte loads, four in flight a
// thread (single elements at its two ends), and scatters it into bf16
// [Dh_pad][L_pad + 8] slabs, zero padded (the odd number of 16-byte words
// keeps ldmatrix free of bank conflicts). The kernel is compiled for each
// padded size (L_pad a multiple of 16, Dh_pad 16, 32 or 64), so its loops
// carry no bounds. A warp owns 16 query rows: Q's A fragments and K^T's B
// fragments come from ldmatrix.trans of the [d][token] rows, the 16 x L_pad
// scores stay in registers, max and sum go by quad shuffles, p = exp(x -
// max) * (1 / sum) in f32 is rounded to bf16 and becomes the A fragment of
// P.V straight from registers, V's B fragments come from a plain ldmatrix.
// O goes back over the warp's own columns of q's slab and leaves as the
// span it came in. Padded key columns get x = -inf (p = 0); padded query
// rows (q zero) are computed and never stored. The packed forward in bf16
// (attn_packed_fwd_mma) is the same kernel on [token][channel] slabs, staged
// by cp.async (see there).
//
// The packed backward in bf16 (attn_packed_bwd_mma) is in attention_bwd.cu
// and the folded backward in bf16 (attn_folded_bwd_mma) in
// attention_folded_bwd.cu, each built by its own nvcc; the pieces they share
// with K3 and K8 (K3's span staging, move_span, among them) are in
// attn_mma.cuh.
//
// The other kernels here, and both forwards and both backwards in f32
// (a tensor-core product of f32 data would round to TF32), do their products
// with FMA on the CUDA cores out of shared memory, and that is what bounds
// them.
//
// Design of those: one block per (board, head). The head's q, k, v (and dO) sit in
// shared memory as f32 rows whose stride is a multiple of four floats and an
// odd number of 16-byte words, so a lane per key reads four channels at a
// time without bank conflicts. A warp owns four query rows at a time: each
// value of k it loads serves four rows, and the four rows' values of q come
// as broadcast loads. The rows' L <= 192 scores live in registers, six a
// lane and row; max and sum go by warp shuffle; the probabilities pass
// through a per-warp (L, 4) tile in shared memory and the lanes then own
// head channels for the product with v. The backward runs a second pass in
// which a warp owns four key columns and recomputes their probabilities
// from the row maxima and sums the first pass stored, so dk and dv are
// summed inside one warp in a fixed order: no atomics, the same bits every
// run. o is staged over q's rows and dk, dv over k's and v's rows and
// written out in the order of the layout; dq's rows go out as they are
// finished. The ragged edge (L not a multiple of 4 or 32, any B) is masked
// in the kernel.
//
// Each C entry returns cudaGetLastError() after the launch; the Python
// wrapper (ops/attention.py) raises when it is not 0.

#include "attn_common.cuh"
#include "attn_mma.cuh"
#include "mma_common.cuh"

namespace {

constexpr int kFwdThreads = 512;  // most threads a forward block may have
// A backward block holds more in registers: at most 256 threads, and two
// blocks an SM, which caps a thread at 128 registers. Left to itself the
// compiler takes 168 and only one block of a short board fits an SM.
constexpr int kBwdThreads = 256;
constexpr int kBwdBlocksPerSM = 2;

// One head's (L, Dh) slab inside a tensor of either layout.
struct Slab {
    size_t base;
    int stride_l;
    int stride_d;
};

template <bool kPacked>
__device__ __forceinline__ Slab slab_of(int head_index, int L, int dh, int H) {
    Slab s;
    if (kPacked) {
        const int b = head_index / H, h = head_index - b * H;
        s.base = static_cast<size_t>(b) * L * H * dh + static_cast<size_t>(h) * dh;
        s.stride_l = H * dh;
        s.stride_d = 1;
    } else {
        s.base = static_cast<size_t>(head_index) * dh * L;
        s.stride_l = 1;
        s.stride_d = L;
    }
    return s;
}

// A thread's walk over one head's slab in the order of device memory, a
// block's width at a time: (hi, lo) with lo the index that is contiguous in
// memory (the channel when packed, the token when folded). No division in
// the loop.
template <bool kPacked>
struct SlabWalk {
    int hi, lo, step_hi, step_lo, extent;
    size_t stride_hi;

    __device__ __forceinline__ SlabWalk(Slab s, int L, int dh) {
        extent = kPacked ? dh : L;
        stride_hi = kPacked ? s.stride_l : s.stride_d;
        step_hi = blockDim.x / extent;
        step_lo = blockDim.x - step_hi * extent;
        hi = threadIdx.x / extent;
        lo = threadIdx.x - hi * extent;
    }
    __device__ __forceinline__ size_t device_offset() const { return hi * stride_hi + lo; }
    // Position in shared rows [l * ld + d].
    __device__ __forceinline__ int shared_offset(int ld) const {
        return kPacked ? hi * ld + lo : lo * ld + hi;
    }
    __device__ __forceinline__ void advance() {
        lo += step_lo;
        hi += step_hi;
        if (lo >= extent) {
            lo -= extent;
            ++hi;
        }
    }
};

constexpr int kLoadsInFlight = 8;  // device loads a thread starts before it waits for one

// Device memory -> shared rows dst[l * ld + d] as f32, the row's tail zeroed.
template <bool kPacked, typename T>
__device__ __forceinline__ void load_rows(const T* __restrict__ src, Slab s, float* dst,
                                          int L, int dh, int ld) {
    const int n = L * dh;
    const int width = blockDim.x;
    SlabWalk<kPacked> walk(s, L, dh);
    for (int idx = threadIdx.x; idx < n; idx += kLoadsInFlight * width) {
        T vals[kLoadsInFlight];
        int at[kLoadsInFlight];
#pragma unroll
        for (int u = 0; u < kLoadsInFlight; ++u) {
            at[u] = walk.shared_offset(ld);
            if (idx + u * width < n) vals[u] = src[s.base + walk.device_offset()];
            walk.advance();
        }
#pragma unroll
        for (int u = 0; u < kLoadsInFlight; ++u) {
            if (idx + u * width < n) dst[at[u]] = to_f(vals[u]);
        }
    }
    const int pad = ld - dh;
    for (int idx = threadIdx.x; idx < L * pad; idx += width) {
        const int l = idx / pad;
        dst[l * ld + dh + (idx - l * pad)] = 0.0f;
    }
}

// Shared rows src[l * ld + d] -> device memory, rounded to T.
template <bool kPacked, typename T>
__device__ __forceinline__ void store_slab(T* __restrict__ dst, Slab s, const float* src,
                                           int L, int dh, int ld) {
    const int n = L * dh;
    SlabWalk<kPacked> walk(s, L, dh);
    for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
        dst[s.base + walk.device_offset()] = from_f<T>(src[walk.shared_offset(ld)]);
        walk.advance();
    }
}

// Row stride in floats: a multiple of 4 (16-byte loads) and an odd number of
// 16-byte words (a lane per row then reads without bank conflicts).
__host__ __device__ inline int row_stride(int dh) {
    int ld = (dh + 3) & ~3;
    if (((ld >> 2) & 1) == 0) ld += 4;
    return ld;
}

// acc[r][t] = sum_d vec[voff[r] + d] * mat[(lane + 32 t) * ld + d], summed in
// the order of d over the zero-padded row. Matrix rows past L - 1 repeat row
// L - 1; the caller drops them.
__device__ __forceinline__ void dots(const float* vec, const int (&voff)[kRows], const float* mat,
                                     int L, int dh, int ld, int lane,
                                     float (&acc)[kRows][kColsPerLane]) {
    int off[kColsPerLane];
#pragma unroll
    for (int t = 0; t < kColsPerLane; ++t) {
        off[t] = min(lane + 32 * t, L - 1) * ld;
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r][t] = 0.0f;
    }
    const int dpad = (dh + 3) & ~3;
    for (int d = 0; d < dpad; d += 4) {
        float4 a[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) a[r] = *reinterpret_cast<const float4*>(vec + voff[r] + d);
#pragma unroll
        for (int t = 0; t < kColsPerLane; ++t) {
            if (32 * t < L) {
                const float4 b = *reinterpret_cast<const float4*>(mat + off[t] + d);
#pragma unroll
                for (int r = 0; r < kRows; ++r) {
                    float v = acc[r][t];
                    v = fmaf(a[r].x, b.x, v);
                    v = fmaf(a[r].y, b.y, v);
                    v = fmaf(a[r].z, b.z, v);
                    v = fmaf(a[r].w, b.w, v);
                    acc[r][t] = v;
                }
            }
        }
    }
}

// acc[r][c] = sum_j tile[j * 4 + r] * mat[j * ld + d] for d = (lane mod
// 2^shift) + 32 c. Every lane ends with the whole sums of its channel.
__device__ __forceinline__ void weighted_rows(const float* tile, const float* mat, int L, int dh,
                                              int ld, int shift, int lane,
                                              float (&acc)[kRows][2]) {
    const int dw = 1 << shift;
    const int dl = lane & (dw - 1);
    const int group = lane >> shift;
    const int groups = 32 >> shift;
    const bool has0 = dl < dh;
    const bool has1 = dl + 32 < dh;
    const float* col = mat + dl;
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r][0] = acc[r][1] = 0.0f;
#pragma unroll 4
    for (int j = group; j < L; j += groups) {
        const float4 w = *reinterpret_cast<const float4*>(tile + kRows * j);
        if (has0) {
            const float v = col[j * ld];
            acc[0][0] = fmaf(w.x, v, acc[0][0]);
            acc[1][0] = fmaf(w.y, v, acc[1][0]);
            acc[2][0] = fmaf(w.z, v, acc[2][0]);
            acc[3][0] = fmaf(w.w, v, acc[3][0]);
        }
        if (has1) {
            const float v = col[j * ld + 32];
            acc[0][1] = fmaf(w.x, v, acc[0][1]);
            acc[1][1] = fmaf(w.y, v, acc[1][1]);
            acc[2][1] = fmaf(w.z, v, acc[2][1]);
            acc[3][1] = fmaf(w.w, v, acc[3][1]);
        }
    }
    __syncwarp();
    for (int off = dw; off < 32; off <<= 1) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
            acc[r][0] += __shfl_xor_sync(kFull, acc[r][0], off);
            acc[r][1] += __shfl_xor_sync(kFull, acc[r][1], off);
        }
    }
}

// The lanes of channel group 0 write their channel sums of the rows
// i0 .. i0 + 3 (those below L) into the shared rows dst[i * ld + d].
__device__ __forceinline__ void put_channels(float* dst, int i0, int L, int ld,
                                             const float (&acc)[kRows][2], int dh, int shift,
                                             int lane) {
    if (lane >= (1 << shift)) return;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
        if (i0 + r >= L) break;
        if (lane < dh) dst[(i0 + r) * ld + lane] = acc[r][0];
        if (lane + 32 < dh) dst[(i0 + r) * ld + lane + 32] = acc[r][1];
    }
}

// The same, rounded to T, straight into device memory.
template <typename T>
__device__ __forceinline__ void write_channels(T* __restrict__ dst, Slab s, int i0, int L,
                                               const float (&acc)[kRows][2], int dh, int shift,
                                               int lane) {
    if (lane >= (1 << shift)) return;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
        if (i0 + r >= L) break;
        T* row = dst + s.base + static_cast<size_t>(i0 + r) * s.stride_l;
        if (lane < dh) row[static_cast<size_t>(lane) * s.stride_d] = from_f<T>(acc[r][0]);
        if (lane + 32 < dh) row[static_cast<size_t>(lane + 32) * s.stride_d] = from_f<T>(acc[r][1]);
    }
}

// Floats of shared memory one block needs.
__host__ __device__ inline size_t fwd_smem_floats(int L, int dh, int threads) {
    return static_cast<size_t>(3) * L * row_stride(dh)
           + static_cast<size_t>(threads / 32) * kRows * L;
}
__host__ __device__ inline size_t bwd_smem_floats(int L, int dh, int threads) {
    return static_cast<size_t>(4) * L * row_stride(dh)
           + static_cast<size_t>(threads / 32) * 2 * kRows * L + static_cast<size_t>(3) * L;
}

template <bool kPacked, typename T>
__device__ __forceinline__ void attn_fwd_body(float* smem, const T* __restrict__ q,
                                              const T* __restrict__ k, const T* __restrict__ v,
                                              T* __restrict__ o, int L, int dh, int H, float scale) {
    const int ld = row_stride(dh);
    const int nwarps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    float* qs = smem;                               // (L, ld); row i becomes o's row i
    float* ks = qs + L * ld;                        // (L, ld)
    float* vs = ks + L * ld;                        // (L, ld)
    float* tile = vs + L * ld + warp * kRows * L;   // this warp's (L, 4) probabilities
    const Slab slab = slab_of<kPacked>(blockIdx.x, L, dh, H);
    load_rows<kPacked, T>(q, slab, qs, L, dh, ld);
    load_rows<kPacked, T>(k, slab, ks, L, dh, ld);
    load_rows<kPacked, T>(v, slab, vs, L, dh, ld);
    __syncthreads();

    const int shift = channel_shift(dh);
    for (int i0 = warp * kRows; i0 < L; i0 += nwarps * kRows) {
        int voff[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) voff[r] = min(i0 + r, L - 1) * ld;
        float p[kRows][kColsPerLane];
        dots(qs, voff, ks, L, dh, ld, lane, p);
        float m[kRows], rinv[kRows];
        softmax_rows(p, L, lane, scale, m, rinv);
#pragma unroll
        for (int t = 0; t < kColsPerLane; ++t) {
            const int j = lane + 32 * t;
            if (j < L) {
                put_tile(tile, j, round_to<T>(p[0][t]), round_to<T>(p[1][t]),
                         round_to<T>(p[2][t]), round_to<T>(p[3][t]));
            }
        }
        __syncwarp();
        float acc[kRows][2];
        weighted_rows(tile, vs, L, dh, ld, shift, lane, acc);
        put_channels(qs, i0, L, ld, acc, dh, shift, lane);  // these rows of q are this warp's alone
        __syncwarp();
    }
    __syncthreads();
    store_slab<kPacked, T>(o, slab, qs, L, dh, ld);
}

template <bool kPacked, typename T>
__device__ __forceinline__ void attn_bwd_body(float* smem, const T* __restrict__ q,
                                              const T* __restrict__ k, const T* __restrict__ v,
                                              const T* __restrict__ g, T* __restrict__ dq,
                                              T* __restrict__ dk, T* __restrict__ dv,
                                              int L, int dh, int H, float scale) {
    const int ld = row_stride(dh);
    const int nwarps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    float* qs = smem;                 // (L, ld)
    float* ks = qs + L * ld;          // (L, ld); row j becomes dk's row j
    float* vs = ks + L * ld;          // (L, ld); row j becomes dv's row j
    float* gs = vs + L * ld;          // (L, ld) the incoming gradient dO
    float* tile_ds = gs + L * ld + warp * 2 * kRows * L;  // this warp's (L, 4) ds
    float* tile_p = tile_ds + kRows * L;                  // and (L, 4) p
    float* row_max = gs + L * ld + nwarps * 2 * kRows * L;  // (L,)
    float* row_rinv = row_max + L;                          // (L,) 1 / sum
    float* row_dot = row_rinv + L;                          // (L,) rowsum(dp * p)
    const Slab slab = slab_of<kPacked>(blockIdx.x, L, dh, H);
    load_rows<kPacked, T>(q, slab, qs, L, dh, ld);
    load_rows<kPacked, T>(k, slab, ks, L, dh, ld);
    load_rows<kPacked, T>(v, slab, vs, L, dh, ld);
    load_rows<kPacked, T>(g, slab, gs, L, dh, ld);
    __syncthreads();

    const int shift = channel_shift(dh);
    // Pass 1, a warp owns four query rows: each row's maximum, 1 / sum and
    // rowsum(dp * p), and dq's rows.
    for (int i0 = warp * kRows; i0 < L; i0 += nwarps * kRows) {
        int voff[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) voff[r] = min(i0 + r, L - 1) * ld;
        float p[kRows][kColsPerLane], dp[kRows][kColsPerLane];
        dots(qs, voff, ks, L, dh, ld, lane, p);
        dots(gs, voff, vs, L, dh, ld, lane, dp);
        float m[kRows], rinv[kRows], rdot[kRows];
        softmax_rows(p, L, lane, scale, m, rinv);
#pragma unroll
        for (int r = 0; r < kRows; ++r) rdot[r] = 0.0f;
#pragma unroll
        for (int t = 0; t < kColsPerLane; ++t) {
            if (lane + 32 * t < L) {
#pragma unroll
                for (int r = 0; r < kRows; ++r) rdot[r] = fmaf(dp[r][t], p[r][t], rdot[r]);
            }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
            for (int r = 0; r < kRows; ++r) rdot[r] += __shfl_xor_sync(kFull, rdot[r], off);
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
            if (lane == 0 && i0 + r < L) {
                row_max[i0 + r] = m[r];
                row_rinv[i0 + r] = rinv[r];
                row_dot[i0 + r] = rdot[r];
            }
        }
#pragma unroll
        for (int t = 0; t < kColsPerLane; ++t) {
            const int j = lane + 32 * t;
            if (j < L) {
                float ds[kRows];
#pragma unroll
                for (int r = 0; r < kRows; ++r) {
                    ds[r] = round_to<T>(
                        __fmul_rn(__fmul_rn(p[r][t], __fsub_rn(dp[r][t], rdot[r])), scale));
                }
                put_tile(tile_ds, j, ds[0], ds[1], ds[2], ds[3]);
            }
        }
        __syncwarp();
        float acc[kRows][2];
        weighted_rows(tile_ds, ks, L, dh, ld, shift, lane, acc);
        write_channels<T>(dq, slab, i0, L, acc, dh, shift, lane);
        __syncwarp();
    }
    __syncthreads();

    // Pass 2, a warp owns four key columns: their p and ds over all query
    // rows, recomputed with the same arithmetic as pass 1, then dk's and dv's
    // rows, each summed over the query rows inside this warp.
    for (int j0 = warp * kRows; j0 < L; j0 += nwarps * kRows) {
        int voff[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) voff[r] = min(j0 + r, L - 1) * ld;
        float s[kRows][kColsPerLane], dp[kRows][kColsPerLane];
        dots(ks, voff, qs, L, dh, ld, lane, s);
        dots(vs, voff, gs, L, dh, ld, lane, dp);
#pragma unroll
        for (int t = 0; t < kColsPerLane; ++t) {
            const int i = lane + 32 * t;
            if (i < L) {
                const float m = row_max[i], rinv = row_rinv[i], rdot = row_dot[i];
                float p[kRows], ds[kRows];
#pragma unroll
                for (int r = 0; r < kRows; ++r) {
                    const float x = __fmul_rn(s[r][t], scale);
                    p[r] = __fmul_rn(expf(__fsub_rn(x, m)), rinv);
                    ds[r] = round_to<T>(__fmul_rn(__fmul_rn(p[r], __fsub_rn(dp[r][t], rdot)), scale));
                    p[r] = round_to<T>(p[r]);
                }
                put_tile(tile_ds, i, ds[0], ds[1], ds[2], ds[3]);
                put_tile(tile_p, i, p[0], p[1], p[2], p[3]);
            }
        }
        __syncwarp();
        float dkj[kRows][2], dvj[kRows][2];
        weighted_rows(tile_ds, qs, L, dh, ld, shift, lane, dkj);
        weighted_rows(tile_p, gs, L, dh, ld, shift, lane, dvj);
        __syncwarp();
        // These rows of k and v are read by this warp alone in this pass.
        put_channels(ks, j0, L, ld, dkj, dh, shift, lane);
        put_channels(vs, j0, L, ld, dvj, dh, shift, lane);
    }
    __syncthreads();
    store_slab<kPacked, T>(dk, slab, ks, L, dh, ld);
    store_slab<kPacked, T>(dv, slab, vs, L, dh, ld);
}

// The four kernels. The folded and the packed entry of one direction share
// the arithmetic above and differ in how they address device memory.

template <typename T>
__global__ void __launch_bounds__(kFwdThreads, 1) attn_folded_fwd(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int L, int dh, float scale)
{
    extern __shared__ __align__(16) float smem[];
    attn_fwd_body<false, T>(smem, q, k, v, o, L, dh, 1, scale);
}

template <typename T>
__global__ void __launch_bounds__(kBwdThreads, kBwdBlocksPerSM) attn_folded_bwd(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ g, T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
    int L, int dh, float scale)
{
    extern __shared__ __align__(16) float smem[];
    attn_bwd_body<false, T>(smem, q, k, v, g, dq, dk, dv, L, dh, 1, scale);
}

template <typename T>
__global__ void __launch_bounds__(kFwdThreads, 1) attn_packed_fwd(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int L, int dh, int H, float scale)
{
    extern __shared__ __align__(16) float smem[];
    attn_fwd_body<true, T>(smem, q, k, v, o, L, dh, H, scale);
}

template <typename T>
__global__ void __launch_bounds__(kBwdThreads, kBwdBlocksPerSM) attn_packed_bwd(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ g, T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
    int L, int dh, int H, float scale)
{
    extern __shared__ __align__(16) float smem[];
    attn_bwd_body<true, T>(smem, q, k, v, g, dq, dk, dv, L, dh, H, scale);
}

bool shape_ok(long long heads, int L, int dh, int threads, int max_threads) {
    return heads > 0 && heads <= 0x7fffffffLL && L >= 1 && L <= kMaxL && dh >= 1 && dh <= kMaxDh
           && threads >= 32 && threads <= max_threads && threads % 32 == 0;
}

template <typename T>
int folded_fwd(const void* q, const void* k, const void* v, void* o, int BH, int dh, int L,
               int threads, cudaStream_t stream) {
    static bool allowed = false;
    const cudaError_t err = allow_large_smem(attn_folded_fwd<T>, allowed);
    if (err != cudaSuccess) return static_cast<int>(err);
    const size_t smem = fwd_smem_floats(L, dh, threads) * sizeof(float);
    attn_folded_fwd<T><<<BH, threads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), L, dh, 1.0f / sqrtf(static_cast<float>(dh)));
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int folded_bwd(const void* q, const void* k, const void* v, const void* g, void* dq, void* dk,
               void* dv, int BH, int dh, int L, int threads, cudaStream_t stream) {
    static bool allowed = false;
    const cudaError_t err = allow_large_smem(attn_folded_bwd<T>, allowed);
    if (err != cudaSuccess) return static_cast<int>(err);
    const size_t smem = bwd_smem_floats(L, dh, threads) * sizeof(float);
    attn_folded_bwd<T><<<BH, threads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(g), static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv),
        L, dh, 1.0f / sqrtf(static_cast<float>(dh)));
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int packed_fwd(const void* q, const void* k, const void* v, void* o, int B, int L, int H, int dh,
               int threads, cudaStream_t stream) {
    static bool allowed = false;
    const cudaError_t err = allow_large_smem(attn_packed_fwd<T>, allowed);
    if (err != cudaSuccess) return static_cast<int>(err);
    const size_t smem = fwd_smem_floats(L, dh, threads) * sizeof(float);
    attn_packed_fwd<T><<<B * H, threads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), L, dh, H, 1.0f / sqrtf(static_cast<float>(dh)));
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int packed_bwd(const void* q, const void* k, const void* v, const void* g, void* dq, void* dk,
               void* dv, int B, int L, int H, int dh, int threads, cudaStream_t stream) {
    static bool allowed = false;
    const cudaError_t err = allow_large_smem(attn_packed_bwd<T>, allowed);
    if (err != cudaSuccess) return static_cast<int>(err);
    const size_t smem = bwd_smem_floats(L, dh, threads) * sizeof(float);
    attn_packed_bwd<T><<<B * H, threads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(g), static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv),
        L, dh, H, 1.0f / sqrtf(static_cast<float>(dh)));
    return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The folded forward in bf16 on the tensor cores (K3's bf16 path)
// ---------------------------------------------------------------------------

// Shared memory of one block: `heads` heads' q, k and v as bf16 [dpad][ld],
// dpad = 16 channel_tiles(Dh), ld = 16 key_tiles(L) + 8 (an odd number of
// 16-byte words), all zero outside [Dh][L].
__host__ __device__ inline size_t folded_mma_smem_bytes(int L, int dh, int heads) {
    return static_cast<size_t>(heads) * 3 * 16 * channel_tiles(dh)
           * padded_row_elems(16 * key_tiles(L)) * sizeof(bf16);
}

// kKT: 16-key tiles (also 16-row query tiles) a head is padded to, kDK:
// 16-channel tiles (key_tiles, channel_tiles).
template <int kKT, int kDK>
__global__ void __launch_bounds__(kMmaWarps * 32, (kKT >= 11 ? 3 : 4)) attn_folded_fwd_mma(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, int BH, int L, int dh, int heads, float scale)
{
    constexpr int kLd = 16 * kKT + 8;       // padded_row_elems(16 kKT)
    constexpr int kSlab = 16 * kDK * kLd;   // one tensor of one head
    constexpr int kHeadStride = 3 * kSlab;  // a head's q, k, v slabs, in that order
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* smem = reinterpret_cast<bf16*>(smem_raw);
    const int head0 = blockIdx.x * heads;
    const int nh = min(heads, BH - head0);
    const int n = nh * dh * L;
    const size_t span0 = static_cast<size_t>(head0) * dh * L;
    const SlabMap at{FastDiv(dh * L), FastDiv(L), kHeadStride, kLd};

    for (int i = threadIdx.x; i < heads * kHeadStride / 8; i += blockDim.x)
        reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
    __syncthreads();
    move_span<true>(const_cast<bf16*>(q) + span0, smem, n, at);
    move_span<true>(const_cast<bf16*>(k) + span0, smem + kSlab, n, at);
    move_span<true>(const_cast<bf16*>(v) + span0, smem + 2 * kSlab, n, at);
    __syncthreads();

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = frag_row(lane), tc = frag_col(lane);
    // This lane's row of an ldmatrix.x4: 8 rows of one tile, two tiles down
    // (rows + 8) and two across (16 bytes further).
    const int r8 = lane & 7, down = (lane >> 3) & 1, across = lane >> 4;

    for (int item = warp; item < nh * kKT; item += kMmaWarps) {
        const int hl = item / kKT;
        const int i0 = (item - hl * kKT) * 16;  // this warp's 16 query rows
        bf16* qs = smem + hl * kHeadStride;
        const uint32_t qs_at = shared_address(qs);
        const uint32_t ks_at = qs_at + kSlab * 2, vs_at = qs_at + 2 * kSlab * 2;

        // A = Q (rows i, depth d) from q's [d][i] rows: ldmatrix.trans.
        uint32_t qa[kDK][4];
#pragma unroll
        for (int kk = 0; kk < kDK; ++kk)
            ldmatrix_x4_trans(qa[kk], qs_at + ((kk * 16 + across * 8 + r8) * kLd + i0 + down * 8) * 2);

        // S = Q . K^T: B = K^T (depth d, columns j) from k's [d][j] rows: ldmatrix.trans.
        float s[2 * kKT][4];
#pragma unroll
        for (int j = 0; j < 2 * kKT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
        for (int jt = 0; jt < kKT; ++jt) {
#pragma unroll
            for (int kk = 0; kk < kDK; ++kk) {
                uint32_t b[4];
                ldmatrix_x4_trans(b, ks_at + ((kk * 16 + down * 8 + r8) * kLd + jt * 16 + across * 8) * 2);
                mma_bf16_16816(s[2 * jt], qa[kk], b[0], b[1]);
                mma_bf16_16816(s[2 * jt + 1], qa[kk], b[2], b[3]);
            }
        }

        float mx[2], rinv[2];
        softmax_fragments(s, L - tc, scale, mx, rinv);

        // O = round(P) . V: the rounded probabilities of keys 16jt .. 16jt+15
        // are the A fragment, straight from registers; B = V (depth j,
        // columns d) from v's [d][j] rows: plain ldmatrix.
        float oacc[2 * kDK][4];
#pragma unroll
        for (int u = 0; u < 2 * kDK; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e) oacc[u][e] = 0.0f;
#pragma unroll
        for (int jt = 0; jt < kKT; ++jt) {
            uint32_t pa[4];
            probability_fragment(pa, s, jt, rinv);
#pragma unroll
            for (int kk = 0; kk < kDK; ++kk) {
                uint32_t b[4];
                ldmatrix_x4(b, vs_at + ((kk * 16 + across * 8 + r8) * kLd + jt * 16 + down * 8) * 2);
                mma_bf16_16816(oacc[2 * kk], pa, b[0], b[1]);
                mma_bf16_16816(oacc[2 * kk + 1], pa, b[2], b[3]);
            }
        }

        // O's rows go into q's columns i0 .. i0+15, which only this warp reads
        // (its A fragments are already in registers): o's [d][i] layout.
#pragma unroll
        for (int u = 0; u < 2 * kDK; ++u) {
            const int d = u * 8 + tc;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                const int i = i0 + g + 8 * r;
                if (i < L) {
                    qs[d * kLd + i] = __float2bfloat16(oacc[u][2 * r]);
                    qs[(d + 1) * kLd + i] = __float2bfloat16(oacc[u][2 * r + 1]);
                }
            }
        }
    }
    __syncthreads();
    move_span<false>(o + span0, smem, n, at);
}

template <int kKT, int kDK>
int folded_fwd_mma(const void* q, const void* k, const void* v, void* o, int BH, int dh, int L,
                   int heads, cudaStream_t stream) {
    static bool allowed = false;
    const cudaError_t err = allow_large_smem(attn_folded_fwd_mma<kKT, kDK>, allowed);
    if (err != cudaSuccess) return static_cast<int>(err);
    attn_folded_fwd_mma<kKT, kDK><<<(BH + heads - 1) / heads, kMmaWarps * 32,
                                    folded_mma_smem_bytes(L, dh, heads), stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(o), BH, L, dh, heads, 1.0f / sqrtf(static_cast<float>(dh)));
    return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The packed forward in bf16 on the tensor cores (K8's bf16 path)
// ---------------------------------------------------------------------------
//
// attn_folded_fwd_mma moved to the packed layout. A head is L rows of Dh
// contiguous values at a stride of D = H Dh, so its shared slabs are
// [token][channel]: bf16 [16 key_tiles(L)][ld], ld = 16 channel_tiles(Dh) + 8
// (an odd number of 16-byte words), zero outside [L][Dh]. That is the layout
// m16n8k16 takes without a transpose for Q as A and for K as the B of Q.K^T,
// and through ldmatrix.trans for V as the B of P.V. A head row goes into its
// slab row by cp.async in the widest word (16, 8 or 4 bytes) that divides
// its 2 Dh bytes and the tensors' addresses, so a thread's copies are all in
// flight at once and nothing is scattered; only an odd Dh takes element
// copies. The rest is K3's: a block of four warps takes up to four
// consecutive heads (of one board or of two), a warp 16 query rows of a
// head, the scores and probabilities stay in registers, p is rounded to bf16
// where _packed_fwd_kernel rounds it, and O goes back over the warp's own
// rows of q's slab and leaves in the same words. Sums run in one fixed order
// and there are no atomics: the same bits every run.
//
// A (169, 64) head takes 76 KB of shared memory: three blocks fit an SM,
// and a thread may hold 168 registers (launch bounds of K3).

__host__ __device__ inline size_t packed_mma_smem_bytes(int L, int dh, int heads) {
    return static_cast<size_t>(heads) * 3 * 16 * key_tiles(L)
           * padded_row_elems(16 * channel_tiles(dh)) * sizeof(bf16);
}

// kKT: 16-key tiles (also 16-row query tiles) a head is padded to, kDK:
// 16-channel tiles (key_tiles, channel_tiles); word_bytes from
// packed_word_bytes.
template <int kKT, int kDK>
__global__ void __launch_bounds__(kMmaWarps * 32, (kKT >= 11 ? 3 : 4)) attn_packed_fwd_mma(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, int n_heads, int L, int H, int dh, int heads, int word_bytes,
    float scale)
{
    constexpr int kLd = 16 * kDK + 8;       // padded_row_elems(16 kDK)
    constexpr int kSlab = 16 * kKT * kLd;   // one tensor of one head
    constexpr int kHeadStride = 3 * kSlab;  // a head's q, k, v slabs, in that order
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* smem = reinterpret_cast<bf16*>(smem_raw);
    const int head0 = blockIdx.x * heads;
    const int nh = min(heads, n_heads - head0);
    const bf16* const src[3] = {q, k, v};

    switch (word_bytes) {
        case 16: stage_packed<kKT, kDK, 16, 3>(src, smem, head0, nh, L, H, dh); break;
        case 8: stage_packed<kKT, kDK, 8, 3>(src, smem, head0, nh, L, H, dh); break;
        case 4: stage_packed<kKT, kDK, 4, 3>(src, smem, head0, nh, L, H, dh); break;
        default: stage_packed<kKT, kDK, 2, 3>(src, smem, head0, nh, L, H, dh); break;
    }
    cp_async_wait_all();
    __syncthreads();

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = frag_row(lane), tc = frag_col(lane);
    // This lane's row of an ldmatrix.x4: 8 rows of one tile, two tiles down
    // (rows + 8) and two across (16 bytes further).
    const int r8 = lane & 7, down = (lane >> 3) & 1, across = lane >> 4;

    for (int item = warp; item < nh * kKT; item += kMmaWarps) {
        const int hl = item / kKT;
        const int i0 = (item - hl * kKT) * 16;  // this warp's 16 query rows
        bf16* qs = smem + hl * kHeadStride;
        const uint32_t qs_at = shared_address(qs);
        const uint32_t ks_at = qs_at + kSlab * 2, vs_at = qs_at + 2 * kSlab * 2;

        // A = Q (rows i, depth d) from q's [i][d] rows: plain ldmatrix.
        uint32_t qa[kDK][4];
#pragma unroll
        for (int kk = 0; kk < kDK; ++kk)
            ldmatrix_x4(qa[kk], qs_at + ((i0 + a_row_of_lane(lane)) * kLd + kk * 16
                                         + a_half_of_lane(lane) * 8) * 2);

        // S = Q . K^T: B = K^T (depth d, columns j) from k's [j][d] rows: plain ldmatrix.
        float s[2 * kKT][4];
#pragma unroll
        for (int j = 0; j < 2 * kKT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
        for (int jt = 0; jt < kKT; ++jt) {
#pragma unroll
            for (int kk = 0; kk < kDK; ++kk) {
                uint32_t b[4];
                ldmatrix_x4(b, ks_at + ((jt * 16 + across * 8 + r8) * kLd + kk * 16 + down * 8) * 2);
                mma_bf16_16816(s[2 * jt], qa[kk], b[0], b[1]);
                mma_bf16_16816(s[2 * jt + 1], qa[kk], b[2], b[3]);
            }
        }

        float mx[2], rinv[2];
        softmax_fragments(s, L - tc, scale, mx, rinv);

        // O = round(P) . V: B = V (depth j, columns d) from v's [j][d] rows:
        // ldmatrix.trans.
        float oacc[2 * kDK][4];
#pragma unroll
        for (int u = 0; u < 2 * kDK; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e) oacc[u][e] = 0.0f;
#pragma unroll
        for (int jt = 0; jt < kKT; ++jt) {
            uint32_t pa[4];
            probability_fragment(pa, s, jt, rinv);
#pragma unroll
            for (int kk = 0; kk < kDK; ++kk) {
                uint32_t b[4];
                ldmatrix_x4_trans(b, vs_at + ((jt * 16 + down * 8 + r8) * kLd + kk * 16 + across * 8) * 2);
                mma_bf16_16816(oacc[2 * kk], pa, b[0], b[1]);
                mma_bf16_16816(oacc[2 * kk + 1], pa, b[2], b[3]);
            }
        }

        // O's rows go over q's rows i0 .. i0+15, which only this warp reads
        // (its A fragments are already in registers), two channels a store.
#pragma unroll
        for (int u = 0; u < 2 * kDK; ++u) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                *reinterpret_cast<uint32_t*>(qs + (i0 + g + 8 * r) * kLd + u * 8 + tc) =
                    pack_bf16(oacc[u][2 * r], oacc[u][2 * r + 1]);
            }
        }
    }
    __syncthreads();
    switch (word_bytes) {
        case 16: store_packed<kKT, kDK, 16, 3>(o, smem, head0, nh, L, H, dh); break;
        case 8: store_packed<kKT, kDK, 8, 3>(o, smem, head0, nh, L, H, dh); break;
        case 4: store_packed<kKT, kDK, 4, 3>(o, smem, head0, nh, L, H, dh); break;
        default: store_packed<kKT, kDK, 2, 3>(o, smem, head0, nh, L, H, dh); break;
    }
}

// Once per instantiation: see mma_setup.
template <int kKT, int kDK>
cudaError_t packed_fwd_mma_setup() {
    static bool done = false;
    return mma_setup(attn_packed_fwd_mma<kKT, kDK>, done);
}

template <int kKT, int kDK>
int packed_fwd_mma(const void* q, const void* k, const void* v, void* o, int B, int L, int H,
                   int dh, int heads, cudaStream_t stream) {
    const cudaError_t err = packed_fwd_mma_setup<kKT, kDK>();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int n_heads = B * H;
    const int blocks = static_cast<int>((static_cast<long long>(n_heads) + heads - 1) / heads);
    const void* const tensors[] = {q, k, v, o};
    attn_packed_fwd_mma<kKT, kDK><<<blocks, kMmaWarps * 32, packed_mma_smem_bytes(L, dh, heads),
                                    stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(o), n_heads, L, H, dh, heads, packed_word_bytes(tensors, dh),
        1.0f / sqrtf(static_cast<float>(dh)));
    return static_cast<int>(cudaGetLastError());
}

// Registers and local memory (spills) a thread of the instantiation takes,
// and how many of its blocks of `heads` heads fit an SM.
template <int kKT, int kDK>
int packed_fwd_mma_resources(int L, int dh, int heads, int* registers, int* local_bytes,
                             int* blocks_per_sm) {
    const cudaError_t err = packed_fwd_mma_setup<kKT, kDK>();
    if (err != cudaSuccess) return static_cast<int>(err);
    return mma_resources(attn_packed_fwd_mma<kKT, kDK>, packed_mma_smem_bytes(L, dh, heads),
                         registers, local_bytes, blocks_per_sm);
}

}  // namespace

// Shared memory one block needs, in bytes: the wrapper holds it against the
// card's per-block limit before it launches.
extern "C" size_t attn_smem_bytes(int backward, int L, int dh, int threads) {
    return (backward ? bwd_smem_floats(L, dh, threads) : fwd_smem_floats(L, dh, threads))
           * sizeof(float);
}

extern "C" int attn_max_tokens() { return kMaxL; }
extern "C" int attn_max_head_dim() { return kMaxDh; }
extern "C" int attn_max_threads(int backward) { return backward ? kBwdThreads : kFwdThreads; }

extern "C" int attn_folded_fwd_launch(int is_bf16, const void* q, const void* k, const void* v,
                                      void* o, int BH, int dh, int L, int threads, void* stream) {
    if (BH == 0) return 0;
    if (!shape_ok(BH, L, dh, threads, kFwdThreads)) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return is_bf16 ? folded_fwd<__nv_bfloat16>(q, k, v, o, BH, dh, L, threads, s)
                   : folded_fwd<float>(q, k, v, o, BH, dh, L, threads, s);
}

extern "C" int attn_folded_bwd_launch(int is_bf16, const void* q, const void* k, const void* v,
                                      const void* g, void* dq, void* dk, void* dv, int BH, int dh,
                                      int L, int threads, void* stream) {
    if (BH == 0) return 0;
    if (!shape_ok(BH, L, dh, threads, kBwdThreads)) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return is_bf16 ? folded_bwd<__nv_bfloat16>(q, k, v, g, dq, dk, dv, BH, dh, L, threads, s)
                   : folded_bwd<float>(q, k, v, g, dq, dk, dv, BH, dh, L, threads, s);
}

extern "C" int attn_packed_fwd_launch(int is_bf16, const void* q, const void* k, const void* v,
                                      void* o, int B, int L, int H, int dh, int threads,
                                      void* stream) {
    if (B == 0) return 0;
    if (H < 1 || !shape_ok(static_cast<long long>(B) * H, L, dh, threads, kFwdThreads))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return is_bf16 ? packed_fwd<__nv_bfloat16>(q, k, v, o, B, L, H, dh, threads, s)
                   : packed_fwd<float>(q, k, v, o, B, L, H, dh, threads, s);
}

extern "C" int attn_packed_bwd_launch(int is_bf16, const void* q, const void* k, const void* v,
                                      const void* g, void* dq, void* dk, void* dv, int B, int L,
                                      int H, int dh, int threads, void* stream) {
    if (B == 0) return 0;
    if (H < 1 || !shape_ok(static_cast<long long>(B) * H, L, dh, threads, kBwdThreads))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return is_bf16 ? packed_bwd<__nv_bfloat16>(q, k, v, g, dq, dk, dv, B, L, H, dh, threads, s)
                   : packed_bwd<float>(q, k, v, g, dq, dk, dv, B, L, H, dh, threads, s);
}

// The folded forward on the tensor cores, bf16 only (is_bf16 = 1): `heads`
// consecutive heads a block (at most 4), four warps, a warp per 16 query
// rows of a head.
extern "C" size_t attn_folded_fwd_mma_smem_bytes(int L, int dh, int heads) {
    return folded_mma_smem_bytes(L, dh, heads);
}

extern "C" int attn_folded_fwd_mma_launch(int is_bf16, const void* q, const void* k, const void* v,
                                          void* o, int BH, int dh, int L, int heads, void* stream) {
    if (BH == 0) return 0;
    if (!is_bf16 || !shape_ok(BH, L, dh, kMmaWarps * 32, kMmaWarps * 32) || heads < 1
        || heads > kMmaMaxHeads)
        return static_cast<int>(cudaErrorInvalidValue);
    return for_tiles(L, dh, [&](auto kt, auto dk) {
        return folded_fwd_mma<decltype(kt)::value, decltype(dk)::value>(
            q, k, v, o, BH, dh, L, heads, static_cast<cudaStream_t>(stream));
    });
}

// The packed forward on the tensor cores, bf16 only (is_bf16 = 1): `heads`
// consecutive heads a block (at most 4), four warps, a warp per 16 query
// rows of a head.
extern "C" size_t attn_packed_fwd_mma_smem_bytes(int L, int dh, int heads) {
    return packed_mma_smem_bytes(L, dh, heads);
}

extern "C" int attn_packed_fwd_mma_launch(int is_bf16, const void* q, const void* k, const void* v,
                                          void* o, int B, int L, int H, int dh, int heads,
                                          void* stream) {
    if (B == 0) return 0;
    if (!is_bf16 || H < 1
        || !shape_ok(static_cast<long long>(B) * H, L, dh, kMmaWarps * 32, kMmaWarps * 32)
        || heads < 1 || heads > kMmaMaxHeads)
        return static_cast<int>(cudaErrorInvalidValue);
    return for_tiles(L, dh, [&](auto kt, auto dk) {
        return packed_fwd_mma<decltype(kt)::value, decltype(dk)::value>(
            q, k, v, o, B, L, H, dh, heads, static_cast<cudaStream_t>(stream));
    });
}

extern "C" int attn_packed_fwd_mma_resources(int L, int dh, int heads, int* registers,
                                             int* local_bytes, int* blocks_per_sm) {
    if (!shape_ok(1, L, dh, kMmaWarps * 32, kMmaWarps * 32) || heads < 1 || heads > kMmaMaxHeads)
        return static_cast<int>(cudaErrorInvalidValue);
    return for_tiles(L, dh, [&](auto kt, auto dk) {
        return packed_fwd_mma_resources<decltype(kt)::value, decltype(dk)::value>(
            L, dh, heads, registers, local_bytes, blocks_per_sm);
    });
}
