// Dense softmax attention over board tokens for Hopper (sm_90a) on the packed
// interface q, k, v, o (B, L, D = H*Dh), one block per board with all of its
// heads: the function of attention.cu (same sums, same rounding points)
//
//     s  = (q . k) * 1/sqrt(Dh)            f32
//     p  = softmax(s) over the keys        f32
//     o  = round(p) . v                    p rounded to the tensors' type first
//     dp = dO . v
//     ds = round(p * (dp - rowsum(dp * p)) * scale)
//     dq = ds . k,  dk = ds^T . q,  dv = round(p)^T . dO
//
// Replaces the TPU kernels of rl_selfplay_mnk_tpu/ops/pallas_attention.py
// that take a (TB, L, D) block and separate the heads on chip:
// _lane_slice_fwd_kernel (attn_lane_slice_fwd: forward only, per-head column
// slices, no transpose anywhere), _infold_fwd_kernel (attn_infold_fwd) and
// _infold_bwd_kernel (attn_infold_bwd), which transpose the block on chip
// and take per-head row slices.
//
// Bound: as in attention.cu, bytes at the shapes the models give (a forward
// moves 4*B*L*D elements, a backward 7*B*L*D): 0.089 ms for a forward at the
// 9x9 update's minibatch (B = 8192, L = 81, H = 4, Dh = 14, bf16), 0.155 ms
// for a backward. The bf16 forwards (attn_lane_slice_fwd_mma,
// attn_infold_fwd_mma) and the bf16 backward (attn_infold_bwd_mma), below,
// do their products on the tensor cores; the other kernels, and all three
// in f32 (a tensor-core product of f32 data would round to TF32), do them
// with FMA on the CUDA cores out of shared memory, which is what bounds them.
//
// Design of the FMA kernels. A board's rows are D*itemsize bytes, a multiple of 16 at every
// registry width, so q, k, v (and dO) come in, and the results go out, as
// 16-byte device accesses in the order of the layout, each element once. The
// tensors sit in shared memory in their own type (bf16 as bf16). A warp works
// on one head's four query rows (or key columns) at a time and keeps their
// L <= 192 scores in registers, lanes along the other token axis; max and
// sum go by warp shuffle.
//
//   lane slice  The board stays as rows [l][ld]; a head is the column slice
//     [h*dhp, h*dhp + Dh) of every row, dhp = Dh rounded up to 4 with the gap
//     zeroed, and ld is an odd number of 4-element words, so a lane per key
//     row reads four channels at a time without bank conflicts. The
//     probabilities pass through a per-warp (L, 4) tile and the lanes then
//     own head channels for the product with v. o is staged over q's rows.
//   in-kernel fold  The board is transposed while it is staged, to
//     [D][ldl] with the tokens contiguous (ldl = L rounded up to 4, never a
//     multiple of 32, the tail zeroed): a head is the row slice
//     [h*Dh, (h+1)*Dh). Scores read k with the lanes along the tokens,
//     conflict-free, and q as one broadcast load of four tokens. The
//     probabilities pass through a per-warp (4, ldl) tile; each lane then owns
//     (row, channel) outputs and sums over the tokens four at a time. The
//     backward runs a second pass in which a warp owns four key columns and
//     recomputes their probabilities from the row maxima, 1/sum and
//     rowsum(dp * p) of the first pass with the same FMA order, so dk and dv
//     are summed inside one warp in a fixed order: no atomics, the same bits
//     every run. o is staged over q, dk and dv over k and v, dq in a slab of
//     its own, and all are transposed back on the way out. Where the board
//     does not fit in shared memory the block walks the heads in groups
//     (heads_per_pass < H).
//
// Each C entry returns cudaGetLastError() after the launch; the Python
// wrapper (ops/attention.py) raises when it is not 0.

#include "attn_common.cuh"
#include "attn_mma.cuh"
#include "mma_common.cuh"

namespace {

constexpr int kBoardThreads = 256;   // most threads a block may have
constexpr int kBoardBlocksPerSM = 2; // caps a thread at 128 registers

template <typename T> struct Vec {
    static constexpr int n = 16 / sizeof(T);  // elements in a 16-byte access
};

// Four consecutive elements of shared memory (aligned to four elements) as f32.
__device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
    acc = fmaf(a.x, b.x, acc);
    acc = fmaf(a.y, b.y, acc);
    acc = fmaf(a.z, b.z, acc);
    return fmaf(a.w, b.w, acc);
}

// Whether the columns [c0, c0 + width) of rows of D elements at `ptr` can be
// moved as 16-byte accesses.
template <typename T>
__device__ __forceinline__ bool can_vectorize(const void* ptr, int D, int c0, int width) {
    constexpr int n = Vec<T>::n;
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && D % n == 0 && c0 % n == 0
           && width % n == 0;
}

// One access of a row: Vec<T>::n elements when `vec`, else one.
template <typename T>
__device__ __forceinline__ void load_chunk(const T* src, bool vec, T* vals) {
    if (vec) {
        *reinterpret_cast<uint4*>(vals) = *reinterpret_cast<const uint4*>(src);
    } else {
        vals[0] = src[0];
    }
}
template <typename T>
__device__ __forceinline__ void store_chunk(T* dst, bool vec, const T* vals) {
    if (vec) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(vals);
    } else {
        dst[0] = vals[0];
    }
}

// ---------------------------------------------------------------------------
// lane slice: rows [l][ld], heads are column slices
// ---------------------------------------------------------------------------

__host__ __device__ inline int padded_head(int dh) { return (dh + 3) & ~3; }

// Row stride in elements: room for H padded heads, a multiple of 4 and an odd
// number of 4-element words.
__host__ __device__ inline int slice_row_stride(int H, int dh) {
    int ld = H * padded_head(dh);
    if (((ld >> 2) & 1) == 0) ld += 4;
    return ld;
}

// Bytes of the q, k and v rows together, rounded up to the tiles' alignment.
__host__ __device__ inline size_t slice_slab_bytes(int L, int H, int dh, int itemsize) {
    const size_t bytes = static_cast<size_t>(3) * L * slice_row_stride(H, dh) * itemsize;
    return (bytes + 15) & ~static_cast<size_t>(15);
}

__host__ __device__ inline size_t lane_slice_smem_bytes(int L, int H, int dh, int threads,
                                                        int itemsize) {
    return slice_slab_bytes(L, H, dh, itemsize)
           + static_cast<size_t>(threads / 32) * kRows * L * sizeof(float);
}

// N tensors' boards, device rows [l][D] -> shared rows [l][ld] with every
// head's Dh values at [h*dhp, h*dhp + Dh) and the gap up to dhp zeroed.
template <typename T, int N>
__device__ __forceinline__ void stage_slices(const T* const (&src)[N], T* const (&dst)[N], int L,
                                             int D, int H, int dh, int ld) {
    constexpr int n = Vec<T>::n;
    const int dhp = padded_head(dh);
    bool vec = true;
#pragma unroll
    for (int a = 0; a < N; ++a) vec = vec && can_vectorize<T>(src[a], D, 0, D);
    const int cw = vec ? n : 1;
    const int per_row = D / cw;
    for (int idx = threadIdx.x; idx < L * per_row; idx += blockDim.x) {
        const int l = idx / per_row, c = (idx - l * per_row) * cw;
        __align__(16) T vals[N][n];
#pragma unroll
        for (int a = 0; a < N; ++a) load_chunk<T>(src[a] + static_cast<size_t>(l) * D + c, vec, vals[a]);
        int head = c / dh, d = c - head * dh;
#pragma unroll
        for (int e = 0; e < n; ++e) {
            if (e < cw) {
                const int at = l * ld + head * dhp + d;
#pragma unroll
                for (int a = 0; a < N; ++a) dst[a][at] = vals[a][e];
                if (++d == dh) {
                    d = 0;
                    ++head;
                }
            }
        }
    }
    const int gap = dhp - dh;
    for (int idx = threadIdx.x; idx < L * H * gap; idx += blockDim.x) {
        const int row_head = idx / gap, l = row_head / H, head = row_head - l * H;
        const int at = l * ld + head * dhp + dh + (idx - row_head * gap);
#pragma unroll
        for (int a = 0; a < N; ++a) dst[a][at] = from_f<T>(0.0f);
    }
}

// Shared rows [l][ld] (padded heads) -> one tensor's board, device rows [l][D].
template <typename T>
__device__ __forceinline__ void unstage_slices(T* __restrict__ dst, const T* src, int L, int D,
                                               int dh, int ld) {
    constexpr int n = Vec<T>::n;
    const int dhp = padded_head(dh);
    const bool vec = can_vectorize<T>(dst, D, 0, D);
    const int cw = vec ? n : 1;
    const int per_row = D / cw;
    for (int idx = threadIdx.x; idx < L * per_row; idx += blockDim.x) {
        const int l = idx / per_row, c = (idx - l * per_row) * cw;
        __align__(16) T vals[n];
        int head = c / dh, d = c - head * dh;
#pragma unroll
        for (int e = 0; e < n; ++e) {
            if (e < cw) {
                vals[e] = src[l * ld + head * dhp + d];
                if (++d == dh) {
                    d = 0;
                    ++head;
                }
            }
        }
        store_chunk<T>(dst + static_cast<size_t>(l) * D + c, vec, vals);
    }
}

template <typename T>
__global__ void __launch_bounds__(kBoardThreads, kBoardBlocksPerSM) attn_lane_slice_fwd(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int L, int H, int dh, float scale)
{
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int D = H * dh, dhp = padded_head(dh), ld = slice_row_stride(H, dh);
    const int nwarps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    T* qs = reinterpret_cast<T*>(smem_raw);  // (L, ld); a head's row i becomes o's
    T* ks = qs + L * ld;                     // (L, ld)
    T* vs = ks + L * ld;                     // (L, ld)
    float* tile = reinterpret_cast<float*>(smem_raw + slice_slab_bytes(L, H, dh, sizeof(T)))
                  + warp * kRows * L;    // this warp's (L, 4) p
    const size_t board = static_cast<size_t>(blockIdx.x) * L * D;
    {
        const T* const src[3] = {q + board, k + board, v + board};
        T* const dst[3] = {qs, ks, vs};
        stage_slices<T, 3>(src, dst, L, D, H, dh, ld);
    }
    __syncthreads();

    const int shift = channel_shift(dh);
    const int dw = 1 << shift, dl = lane & (dw - 1), group = lane >> shift, groups = 32 >> shift;
    const int row_groups = (L + kRows - 1) / kRows;
    for (int item = warp; item < H * row_groups; item += nwarps) {
        const int head = item / row_groups, i0 = (item - head * row_groups) * kRows;
        const int col = head * dhp;
        // Scores of four query rows against every key row of this head.
        int qoff[kRows], koff[kColsPerLane];
#pragma unroll
        for (int r = 0; r < kRows; ++r) qoff[r] = min(i0 + r, L - 1) * ld + col;
        float p[kRows][kColsPerLane];
#pragma unroll
        for (int t = 0; t < kColsPerLane; ++t) {
            koff[t] = min(lane + 32 * t, L - 1) * ld + col;
#pragma unroll
            for (int r = 0; r < kRows; ++r) p[r][t] = 0.0f;
        }
        for (int d = 0; d < dhp; d += 4) {
            float4 a[kRows];
#pragma unroll
            for (int r = 0; r < kRows; ++r) a[r] = load4(qs + qoff[r] + d);
#pragma unroll
            for (int t = 0; t < kColsPerLane; ++t) {
                if (32 * t < L) {
                    const float4 b = load4(ks + koff[t] + d);
#pragma unroll
                    for (int r = 0; r < kRows; ++r) p[r][t] = dot4(a[r], b, p[r][t]);
                }
            }
        }
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
        // o = p . v: 2^shift lanes own the head's channels, the lane groups
        // share out the key rows and their sums meet by shuffle.
        float acc[kRows][2];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r][0] = acc[r][1] = 0.0f;
        const bool has0 = dl < dh, has1 = dl + 32 < dh;
        const T* vcol = vs + col + dl;
#pragma unroll 4
        for (int j = group; j < L; j += groups) {
            const float4 w = *reinterpret_cast<const float4*>(tile + kRows * j);
            if (has0) {
                const float x = to_f(vcol[j * ld]);
                acc[0][0] = fmaf(w.x, x, acc[0][0]);
                acc[1][0] = fmaf(w.y, x, acc[1][0]);
                acc[2][0] = fmaf(w.z, x, acc[2][0]);
                acc[3][0] = fmaf(w.w, x, acc[3][0]);
            }
            if (has1) {
                const float x = to_f(vcol[j * ld + 32]);
                acc[0][1] = fmaf(w.x, x, acc[0][1]);
                acc[1][1] = fmaf(w.y, x, acc[1][1]);
                acc[2][1] = fmaf(w.z, x, acc[2][1]);
                acc[3][1] = fmaf(w.w, x, acc[3][1]);
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
        // These rows of this head's q are read by this warp alone.
        if (group == 0) {
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
                if (i0 + r < L) {
                    T* row = qs + (i0 + r) * ld + col;
                    if (has0) row[dl] = from_f<T>(acc[r][0]);
                    if (has1) row[dl + 32] = from_f<T>(acc[r][1]);
                }
            }
        }
        __syncwarp();
    }
    __syncthreads();
    unstage_slices<T>(o + board, qs, L, D, dh, ld);
}

// ---------------------------------------------------------------------------
// in-kernel fold: rows [channel][ldl], heads are row slices
// ---------------------------------------------------------------------------

// Token stride of a transposed row: a multiple of 4 (four tokens a load) that
// is not a multiple of 32 (rows of neighbouring channels on different banks).
__host__ __device__ inline int token_stride(int L) {
    int ldl = (L + 3) & ~3;
    if (ldl % 32 == 0) ldl += 4;
    return ldl;
}

__host__ __device__ inline size_t infold_smem_bytes(bool backward, int L, int dh,
                                                    int heads_per_pass, int threads,
                                                    int itemsize) {
    const size_t ldl = token_stride(L), warps = threads / 32;
    const size_t slabs = (backward ? 5 : 3) * static_cast<size_t>(heads_per_pass) * dh * ldl * itemsize;
    const size_t tiles = (backward ? 2 : 1) * warps * kRows * ldl * sizeof(float);
    const size_t stats = backward ? 3 * static_cast<size_t>(heads_per_pass) * ldl * sizeof(float) : 0;
    return ((slabs + 15) & ~static_cast<size_t>(15)) + tiles + stats;
}

// Columns [c0, c0 + width) of N tensors' boards, device rows [l][D] ->
// shared rows [c - c0][ldl], transposed, the tokens past L zeroed. A thread
// takes one 16-byte piece of a device row; neighbouring threads take
// neighbouring rows, so their shared stores are side by side.
template <typename T, int N>
__device__ __forceinline__ void stage_transposed(const T* const (&src)[N], T* const (&dst)[N],
                                                 int L, int D, int c0, int width, int ldl) {
    constexpr int n = Vec<T>::n;
    bool vec = true;
#pragma unroll
    for (int a = 0; a < N; ++a) vec = vec && can_vectorize<T>(src[a], D, c0, width);
    const int cw = vec ? n : 1;
    const int pieces = width / cw;
    for (int idx = threadIdx.x; idx < L * pieces; idx += blockDim.x) {
        const int piece = idx / L, l = idx - piece * L, c = piece * cw;
        __align__(16) T vals[N][n];
#pragma unroll
        for (int a = 0; a < N; ++a) {
            load_chunk<T>(src[a] + static_cast<size_t>(l) * D + c0 + c, vec, vals[a]);
        }
#pragma unroll
        for (int e = 0; e < n; ++e) {
            if (e < cw) {
#pragma unroll
                for (int a = 0; a < N; ++a) dst[a][(c + e) * ldl + l] = vals[a][e];
            }
        }
    }
    const int tail = ldl - L;
    for (int idx = threadIdx.x; idx < width * tail; idx += blockDim.x) {
        const int c = idx / tail, at = c * ldl + L + (idx - c * tail);
#pragma unroll
        for (int a = 0; a < N; ++a) dst[a][at] = from_f<T>(0.0f);
    }
}

// Shared rows [c - c0][ldl] -> columns [c0, c0 + width) of one tensor's
// board, device rows [l][D]: the transpose back.
template <typename T>
__device__ __forceinline__ void unstage_transposed(T* __restrict__ dst, const T* src, int L,
                                                   int D, int c0, int width, int ldl) {
    constexpr int n = Vec<T>::n;
    const bool vec = can_vectorize<T>(dst, D, c0, width);
    const int cw = vec ? n : 1;
    const int pieces = width / cw;
    for (int idx = threadIdx.x; idx < L * pieces; idx += blockDim.x) {
        const int piece = idx / L, l = idx - piece * L, c = piece * cw;
        __align__(16) T vals[n];
#pragma unroll
        for (int e = 0; e < n; ++e) {
            if (e < cw) vals[e] = src[(c + e) * ldl + l];
        }
        store_chunk<T>(dst + static_cast<size_t>(l) * D + c0 + c, vec, vals);
    }
}

// acc[r][t] = sum_d a[d][i0 + r] * b[d][lane + 32 t] over one head's Dh rows
// of two transposed slabs, in the order of d. Columns past L - 1 repeat
// column L - 1; the caller drops them.
template <typename T>
__device__ __forceinline__ void fold_dots(const T* a, const T* b, int i0, int L, int dh, int ldl,
                                          int lane, float (&acc)[kRows][kColsPerLane]) {
    int col[kColsPerLane];
#pragma unroll
    for (int t = 0; t < kColsPerLane; ++t) {
        col[t] = min(lane + 32 * t, L - 1);
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r][t] = 0.0f;
    }
    for (int d = 0; d < dh; ++d) {
        const float4 x = load4(a + d * ldl + i0);
#pragma unroll
        for (int t = 0; t < kColsPerLane; ++t) {
            if (32 * t < L) {
                const float y = to_f(b[d * ldl + col[t]]);
                acc[0][t] = fmaf(x.x, y, acc[0][t]);
                acc[1][t] = fmaf(x.y, y, acc[1][t]);
                acc[2][t] = fmaf(x.z, y, acc[2][t]);
                acc[3][t] = fmaf(x.w, y, acc[3][t]);
            }
        }
    }
}

// A warp's four rows of weights, lanes along the tokens -> its (4, ldl) tile,
// the tokens past L zeroed.
__device__ __forceinline__ void put_rows(float* tile, const float (&w)[kRows][kColsPerLane], int L,
                                         int ldl, int lane) {
#pragma unroll
    for (int t = 0; t < kColsPerLane; ++t) {
        const int j = lane + 32 * t;
        if (j < ldl) {
#pragma unroll
            for (int r = 0; r < kRows; ++r) tile[r * ldl + j] = j < L ? w[r][t] : 0.0f;
        }
    }
}

// out[c][i0 + r] = sum_j tile[r][j] * mat[c][j] for the head's Dh rows c of a
// transposed slab: each lane owns (r, c) outputs and sums over the tokens in
// their order, four at a time. Rows i0 + r >= L are dropped.
template <typename T>
__device__ __forceinline__ void fold_weighted(const float* tile, const T* mat, T* out, int i0,
                                              int L, int dh, int ldl, int lane) {
    for (int idx = lane; idx < kRows * dh; idx += 32) {
        const int r = idx & (kRows - 1), c = idx >> 2;
        float acc = 0.0f;
        for (int j = 0; j < ldl; j += 4) {
            acc = dot4(*reinterpret_cast<const float4*>(tile + r * ldl + j),
                       load4(mat + c * ldl + j), acc);
        }
        if (i0 + r < L) out[c * ldl + i0 + r] = from_f<T>(acc);
    }
}

template <typename T>
__global__ void __launch_bounds__(kBoardThreads, kBoardBlocksPerSM) attn_infold_fwd(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int L, int H, int dh, int heads_per_pass, float scale)
{
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int D = H * dh, ldl = token_stride(L);
    const int nwarps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int slab = heads_per_pass * dh * ldl;
    T* qt = reinterpret_cast<T*>(smem_raw);  // (heads * Dh, ldl); becomes o
    T* kt = qt + slab;
    T* vt = kt + slab;
    const size_t slab_bytes = (static_cast<size_t>(3) * slab * sizeof(T) + 15) & ~static_cast<size_t>(15);
    float* tile = reinterpret_cast<float*>(smem_raw + slab_bytes) + warp * kRows * ldl;
    const size_t board = static_cast<size_t>(blockIdx.x) * L * D;
    const int row_groups = (L + kRows - 1) / kRows;

    for (int h0 = 0; h0 < H; h0 += heads_per_pass) {
        const int heads = min(heads_per_pass, H - h0);
        {
            const T* const src[3] = {q + board, k + board, v + board};
            T* const dst[3] = {qt, kt, vt};
            stage_transposed<T, 3>(src, dst, L, D, h0 * dh, heads * dh, ldl);
        }
        __syncthreads();
        for (int item = warp; item < heads * row_groups; item += nwarps) {
            const int head = item / row_groups, i0 = (item - head * row_groups) * kRows;
            T* qh = qt + head * dh * ldl;
            float p[kRows][kColsPerLane];
            fold_dots<T>(qh, kt + head * dh * ldl, i0, L, dh, ldl, lane, p);
            float m[kRows], rinv[kRows];
            softmax_rows(p, L, lane, scale, m, rinv);
#pragma unroll
            for (int t = 0; t < kColsPerLane; ++t) {
#pragma unroll
                for (int r = 0; r < kRows; ++r) p[r][t] = round_to<T>(p[r][t]);
            }
            put_rows(tile, p, L, ldl, lane);
            __syncwarp();
            // These tokens of this head's q are read by this warp alone.
            fold_weighted<T>(tile, vt + head * dh * ldl, qh, i0, L, dh, ldl, lane);
            __syncwarp();
        }
        __syncthreads();
        unstage_transposed<T>(o + board, qt, L, D, h0 * dh, heads * dh, ldl);
        __syncthreads();
    }
}

template <typename T>
__global__ void __launch_bounds__(kBoardThreads, kBoardBlocksPerSM) attn_infold_bwd(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ g, T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
    int L, int H, int dh, int heads_per_pass, float scale)
{
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int D = H * dh, ldl = token_stride(L);
    const int nwarps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int slab = heads_per_pass * dh * ldl;
    T* qt = reinterpret_cast<T*>(smem_raw);  // (heads * Dh, ldl)
    T* kt = qt + slab;                       // becomes dk
    T* vt = kt + slab;                       // becomes dv
    T* gt = vt + slab;                       // the incoming gradient dO
    T* dqt = gt + slab;
    const size_t slab_bytes = (static_cast<size_t>(5) * slab * sizeof(T) + 15) & ~static_cast<size_t>(15);
    float* tiles = reinterpret_cast<float*>(smem_raw + slab_bytes);
    float* tile_ds = tiles + warp * 2 * kRows * ldl;  // this warp's (4, ldl) ds
    float* tile_p = tile_ds + kRows * ldl;            // and (4, ldl) p
    float* row_max = tiles + nwarps * 2 * kRows * ldl;  // (heads, ldl)
    float* row_rinv = row_max + heads_per_pass * ldl;   // (heads, ldl) 1 / sum
    float* row_dot = row_rinv + heads_per_pass * ldl;   // (heads, ldl) rowsum(dp * p)
    const size_t board = static_cast<size_t>(blockIdx.x) * L * D;
    const int row_groups = (L + kRows - 1) / kRows;

    for (int h0 = 0; h0 < H; h0 += heads_per_pass) {
        const int heads = min(heads_per_pass, H - h0);
        {
            const T* const src[4] = {q + board, k + board, v + board, g + board};
            T* const dst[4] = {qt, kt, vt, gt};
            stage_transposed<T, 4>(src, dst, L, D, h0 * dh, heads * dh, ldl);
        }
        __syncthreads();
        // Pass 1, a warp owns four query rows of a head: each row's maximum,
        // 1 / sum and rowsum(dp * p), and dq's rows.
        for (int item = warp; item < heads * row_groups; item += nwarps) {
            const int head = item / row_groups, i0 = (item - head * row_groups) * kRows;
            const int at = head * dh * ldl;
            float p[kRows][kColsPerLane], dp[kRows][kColsPerLane];
            fold_dots<T>(qt + at, kt + at, i0, L, dh, ldl, lane, p);
            fold_dots<T>(gt + at, vt + at, i0, L, dh, ldl, lane, dp);
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
                    row_max[head * ldl + i0 + r] = m[r];
                    row_rinv[head * ldl + i0 + r] = rinv[r];
                    row_dot[head * ldl + i0 + r] = rdot[r];
                }
            }
#pragma unroll
            for (int t = 0; t < kColsPerLane; ++t) {
#pragma unroll
                for (int r = 0; r < kRows; ++r) {
                    p[r][t] = round_to<T>(
                        __fmul_rn(__fmul_rn(p[r][t], __fsub_rn(dp[r][t], rdot[r])), scale));
                }
            }
            put_rows(tile_ds, p, L, ldl, lane);
            __syncwarp();
            fold_weighted<T>(tile_ds, kt + at, dqt + at, i0, L, dh, ldl, lane);
            __syncwarp();
        }
        __syncthreads();
        // Pass 2, a warp owns four key columns of a head: their p and ds over
        // all query rows, recomputed with the same arithmetic as pass 1, then
        // dk's and dv's rows, each summed over the query rows inside this warp.
        for (int item = warp; item < heads * row_groups; item += nwarps) {
            const int head = item / row_groups, j0 = (item - head * row_groups) * kRows;
            const int at = head * dh * ldl;
            float s[kRows][kColsPerLane], dp[kRows][kColsPerLane];
            fold_dots<T>(kt + at, qt + at, j0, L, dh, ldl, lane, s);
            fold_dots<T>(vt + at, gt + at, j0, L, dh, ldl, lane, dp);
#pragma unroll
            for (int t = 0; t < kColsPerLane; ++t) {
                const int i = lane + 32 * t;
                if (i < L) {
                    const float m = row_max[head * ldl + i], rinv = row_rinv[head * ldl + i];
                    const float rdot = row_dot[head * ldl + i];
#pragma unroll
                    for (int r = 0; r < kRows; ++r) {
                        const float x = __fmul_rn(s[r][t], scale);
                        const float p = __fmul_rn(expf(__fsub_rn(x, m)), rinv);
                        s[r][t] = round_to<T>(p);
                        dp[r][t] = round_to<T>(
                            __fmul_rn(__fmul_rn(p, __fsub_rn(dp[r][t], rdot)), scale));
                    }
                }
            }
            put_rows(tile_p, s, L, ldl, lane);
            put_rows(tile_ds, dp, L, ldl, lane);
            __syncwarp();
            // These tokens of this head's k and v are read by this warp alone
            // in this pass, and its reads of them are done.
            fold_weighted<T>(tile_ds, qt + at, kt + at, j0, L, dh, ldl, lane);
            fold_weighted<T>(tile_p, gt + at, vt + at, j0, L, dh, ldl, lane);
            __syncwarp();
        }
        __syncthreads();
        unstage_transposed<T>(dq + board, dqt, L, D, h0 * dh, heads * dh, ldl);
        unstage_transposed<T>(dk + board, kt, L, D, h0 * dh, heads * dh, ldl);
        unstage_transposed<T>(dv + board, vt, L, D, h0 * dh, heads * dh, ldl);
        __syncthreads();
    }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: attn_lane_slice_fwd_mma (K5), attn_infold_fwd_mma (K6)
// ---------------------------------------------------------------------------
//
// Both stage a board's rows as they lie in device memory, [token][channel],
// into bf16 slabs of ld = padded_row_elems(width) elements a row (an odd
// number of 16-byte words), by cp.async in the widest word that divides the
// rows' bytes, their first column's and the tensors' addresses: 16 bytes at
// every registry width, since a whole board row of four heads of 14 is
// seven words even where one head's 28 bytes are not. Rows L .. 16 kKT - 1
// are zeroed. A warp takes (head, 16 query rows) items; the scores of its
// 16 rows against all 16 kKT keys stay in registers, the softmax and the
// bf16 P fragments are K8's (softmax_fragments, probability_fragment), and
// O goes over the warp's own rows and head columns of q's row-major slab,
// which leaves as it came in. Past Dh = 16, S adds each 16-deep product
// past the first in f32 (mma_chained), as K9's S does: the tensor cores'
// accumulator truncates, and S sets where p rounds to bf16. Sums run in one
// fixed order, no atomics: the same bits every run.
//
//   lane slice (K5)  The board stays row-major; a head is the column slice
//     [h Dh, (h + 1) Dh) of every row. Q and K, as the A and B of S = Q K^T,
//     are built from 32-bit shared loads of channel pairs (h Dh + 2t is even
//     when Dh is; 16-bit loads for an odd Dh), channels past Dh read as
//     zero; V, the B of P V, from 16-bit loads of two rows (a head of 14 or
//     12 that starts inside a 16-byte word has no address for ldmatrix).
//     Nothing is transposed. A block stages all of its board's k and v rows
//     and the q rows of its query tiles.
//   in-kernel fold (K6)  The staged rows of a block's heads are transposed on
//     chip into [channel][token] slabs (K3's folded layout, ld = 16 kKT + 8):
//     8 x 8 tiles leave the row-major slabs by ldmatrix.trans, and each lane
//     stores its (channel, token pair) words, conflict-free on both sides.
//     A head is the row slice [h Dh, (h + 1) Dh); the fragments are K3's (Q,
//     K^T by ldmatrix.trans, V by ldmatrix), with the Q depth past Dh zeroed
//     in registers. O comes out of the tensor cores as (query row, channel)
//     fragments, the board's own layout, so the transpose back is the store
//     into q's row-major slab.
//
// A block's unit of work (ops/attention.py, board_mma_plan): a board splits
// over as many blocks as can all be resident on the card at once, K5 by its
// query tiles and K6 by groups of heads, and takes a block where the boards
// already fill it. K6 also takes no more heads a block than fit 75 KiB of
// slabs (three blocks an SM).

// Blocks an SM an instantiation asks for, from the registers a thread is
// expected to hold (S 8 kKT f32, O 8 kDK, Q 4 kDK, and the addresses): 4
// (128 registers a thread) or 3 (168). K5's V and K loads take more at the
// widest sizes, which are on no registry board: 2 (255). With fewer, ptxas
// (CUDA 12.9, sm_90a) spilled at (kKT, kDK) = (12, 1), (12, 2), (11, 4),
// (8, 4), (6, 4), (4, 4) and (3, 4).
template <int kKT, int kDK>
constexpr int kBoardMinBlocks = 8 * kKT + 12 * kDK < 72 ? 4 : 3;
template <int kKT, int kDK>
constexpr int kLaneSliceMinBlocks = kKT == 12 || (kKT >= 8 && kDK == 4)
                                        ? 2 : kBoardMinBlocks<kKT, kDK>;

// Word sizes for the staging, as template arguments.
template <int N>
struct Bytes {
    static constexpr int value = N;
};

template <typename F>
__device__ __forceinline__ void in_words(int word_bytes, const F& f) {
    switch (word_bytes) {
        case 16: f(Bytes<16>{}); break;
        case 8: f(Bytes<8>{}); break;
        case 4: f(Bytes<4>{}); break;
        default: f(Bytes<2>{}); break;
    }
}

// Rows [r0, r1) of the columns [c0, c0 + width) of one board, device rows
// [l][D] at `src`, -> the slab rows [l][ld] at `dst` by cp.async in words
// of kBytes; rows [r1, r_end) of the slab zeroed. The copies stay in flight
// until the caller's cp_async_wait_all.
template <int kBytes>
__device__ __forceinline__ void stage_rows(const bf16* src, bf16* dst, int ld, int D, int c0,
                                           int width, int r0, int r1, int r_end) {
    constexpr int kElems = kBytes / 2;
    const int per_row = width / kElems;
    const FastDiv by_row(per_row);
    for (int idx = threadIdx.x; idx < (r1 - r0) * per_row; idx += blockDim.x) {
        const int r = static_cast<int>(by_row(idx)), w = idx - r * per_row;
        const bf16* from = src + static_cast<size_t>(r0 + r) * D + c0 + w * kElems;
        bf16* to = dst + (r0 + r) * ld + w * kElems;
        if constexpr (kBytes == 16) cp_async_16(shared_address(to), from);
        else if constexpr (kBytes == 2) *to = *from;
        else cp_async_small<kBytes>(shared_address(to), from);
    }
    const int words = ld / 8;  // ld is a multiple of eight
    for (int idx = threadIdx.x; idx < (r_end - r1) * words; idx += blockDim.x)
        reinterpret_cast<uint4*>(dst + r1 * ld)[idx] = make_uint4(0, 0, 0, 0);
}

// The way back: slab rows [r0, r1), columns [0, width) -> device rows [l][D]
// from column c0 at `dst`.
template <int kBytes>
__device__ __forceinline__ void store_rows(bf16* dst, const bf16* src, int ld, int D, int c0,
                                           int width, int r0, int r1) {
    using Word = typename WordOf<kBytes>::type;
    constexpr int kElems = kBytes / 2;
    const int per_row = width / kElems;
    const FastDiv by_row(per_row);
    for (int idx = threadIdx.x; idx < (r1 - r0) * per_row; idx += blockDim.x) {
        const int r = static_cast<int>(by_row(idx)), w = idx - r * per_row;
        *reinterpret_cast<Word*>(dst + static_cast<size_t>(r0 + r) * D + c0 + w * kElems) =
            *reinterpret_cast<const Word*>(src + (r0 + r) * ld + w * kElems);
    }
}

__device__ __forceinline__ uint32_t bits_of(bf16 x) { return __bfloat16_as_ushort(x); }

// Channels c and c + 1 of a head's row as one b16x2 register, the lower in
// the low half; channels at or past dh read as zero. `words`: dh is even,
// so the pair is one aligned 32-bit load.
__device__ __forceinline__ uint32_t pair_at(const bf16* row, int c, int dh, bool words) {
    if (words) return c < dh ? *reinterpret_cast<const uint32_t*>(row + c) : 0u;
    if (c + 1 < dh) return bits_of(row[c]) | bits_of(row[c + 1]) << 16;
    return c < dh ? bits_of(row[c]) : 0u;
}

// O's fragments (oacc[u]: rows i0 + g and i0 + g + 8, channels 8u + 2t and
// 8u + 2t + 1) -> a head's columns of a row-major slab at `head`, rows
// below `rows` only.
template <int kDK>
__device__ __forceinline__ void put_output(bf16* head, int ld, const float (&oacc)[2 * kDK][4],
                                           int i0, int rows, int dh, int lane) {
    const int g = frag_row(lane), tc = frag_col(lane);
    const bool words = (dh & 1) == 0;
#pragma unroll
    for (int u = 0; u < 2 * kDK; ++u) {
        const int c = 8 * u + tc;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int i = i0 + g + 8 * r;
            if (i < rows && c < dh) {
                bf16* at = head + i * ld + c;
                if (words) {
                    *reinterpret_cast<uint32_t*>(at) = pack_bf16(oacc[u][2 * r], oacc[u][2 * r + 1]);
                } else {
                    at[0] = __float2bfloat16(oacc[u][2 * r]);
                    if (c + 1 < dh) at[1] = __float2bfloat16(oacc[u][2 * r + 1]);
                }
            }
        }
    }
}
// Shared memory of a K5 block: the board's q, k and v rows, [16 kKT][ld].
__host__ __device__ inline size_t lane_slice_mma_smem_bytes(int L, int H, int dh) {
    return static_cast<size_t>(3) * 16 * key_tiles(L) * padded_row_elems(H * dh) * sizeof(bf16);
}

// kKT: 16-token tiles a board is padded to, kDK: 16-channel tiles a head is
// padded to (key_tiles, channel_tiles). A block takes query tiles [t0, t0 +
// tiles) of board blockIdx.x / parts, t0 = tiles * (blockIdx.x % parts).
template <int kKT, int kDK>
__global__ void __launch_bounds__(kMmaWarps * 32, kLaneSliceMinBlocks<kKT, kDK>) attn_lane_slice_fwd_mma(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, int L, int H, int dh, int tiles, int parts, int word_bytes, float scale)
{
    constexpr int kTokens = 16 * kKT;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int D = H * dh, ld = padded_row_elems(D);
    bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // becomes o
    bf16* ks = qs + kTokens * ld;
    bf16* vs = ks + kTokens * ld;
    const int board_index = blockIdx.x / parts;
    const int t0 = tiles * (blockIdx.x - board_index * parts);
    const int nt = min(tiles, (L + 15) / 16 - t0);
    const int r0 = 16 * t0, r1 = min(L, 16 * (t0 + nt));
    const size_t board = static_cast<size_t>(board_index) * L * D;
    in_words(word_bytes, [&](auto word) {
        constexpr int kBytes = decltype(word)::value;
        stage_rows<kBytes>(q + board, qs, ld, D, 0, D, r0, r1, 16 * (t0 + nt));
        stage_rows<kBytes>(k + board, ks, ld, D, 0, D, 0, L, kTokens);
        stage_rows<kBytes>(v + board, vs, ld, D, 0, D, 0, L, kTokens);
    });
    cp_async_wait_all();
    __syncthreads();

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = frag_row(lane), tc = frag_col(lane);
    const bool words = (dh & 1) == 0;
    for (int item = warp; item < H * nt; item += kMmaWarps) {
        const int h = item / nt;
        const int i0 = 16 * (t0 + item - h * nt);  // this warp's 16 query rows
        const int col = h * dh;                    // and its head's columns

        // A = Q (rows i, depth d): channel pairs of q's rows i0 + g, i0 + g + 8.
        uint32_t qa[kDK][4];
        const bf16* q_lo = qs + (i0 + g) * ld + col;
        const bf16* q_hi = q_lo + 8 * ld;
#pragma unroll
        for (int kk = 0; kk < kDK; ++kk) {
            const int c = 16 * kk + tc;
            qa[kk][0] = pair_at(q_lo, c, dh, words);
            qa[kk][1] = pair_at(q_hi, c, dh, words);
            qa[kk][2] = pair_at(q_lo, c + 8, dh, words);
            qa[kk][3] = pair_at(q_hi, c + 8, dh, words);
        }

        // S = Q . K^T: B = K^T (depth d, column j) from k's row j = 8 jn + g.
        float s[2 * kKT][4];
#pragma unroll
        for (int jn = 0; jn < 2 * kKT; ++jn) {
#pragma unroll
            for (int e = 0; e < 4; ++e) s[jn][e] = 0.0f;
            const bf16* k_row = ks + (8 * jn + g) * ld + col;
#pragma unroll
            for (int kk = 0; kk < kDK; ++kk) {
                const int c = 16 * kk + tc;
                mma_chained(s[jn], qa[kk], pair_at(k_row, c, dh, words),
                            pair_at(k_row, c + 8, dh, words), kk);
            }
        }

        float mx[2], rinv[2];
        softmax_fragments(s, L - tc, scale, mx, rinv);

        // O = round(P) . V: B = V (depth j, column d) from v's rows 16 jt +
        // 2t, + 1 (+ 8) at channel 8u + g.
        float oacc[2 * kDK][4];
#pragma unroll
        for (int u = 0; u < 2 * kDK; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e) oacc[u][e] = 0.0f;
#pragma unroll
        for (int jt = 0; jt < kKT; ++jt) {
            uint32_t pa[4];
            probability_fragment(pa, s, jt, rinv);
            const bf16* v_rows = vs + (16 * jt + tc) * ld + col;
#pragma unroll
            for (int u = 0; u < 2 * kDK; ++u) {
                const int c = 8 * u + g;
                uint32_t b0 = 0, b1 = 0;
                if (c < dh) {
                    const bf16* at = v_rows + c;
                    b0 = bits_of(at[0]) | bits_of(at[ld]) << 16;
                    b1 = bits_of(at[8 * ld]) | bits_of(at[9 * ld]) << 16;
                }
                mma_bf16_16816(oacc[u], pa, b0, b1);
            }
        }
        // These rows and columns of q are read by this warp alone, and its
        // A fragments are in registers.
        put_output<kDK>(qs + col, ld, oacc, i0, r1, dh, lane);
    }
    __syncthreads();
    in_words(word_bytes, [&](auto word) {
        store_rows<decltype(word)::value>(o + board, qs, ld, D, 0, D, r0, r1);
    });
}

// Shared memory of a K6 block of `heads` heads: their columns of q, k and v
// row-major, [16 kKT][padded_row_elems(heads Dh)], then transposed,
// [heads Dh][16 kKT + 8].
__host__ __device__ inline size_t infold_mma_smem_bytes(int L, int dh, int heads) {
    const size_t tokens = 16 * key_tiles(L), width = static_cast<size_t>(heads) * dh;
    return 3 * (tokens * padded_row_elems(heads * dh) + width * (tokens + 8)) * sizeof(bf16);
}

// Rows [0, kTokens) x columns [0, width) of a row-major slab (row stride
// ld) -> `cols`, [channel][token] with row stride kTokens + 8. A warp moves
// 2 x 2 tiles of 8 x 8 at a time: ldmatrix.trans gives lane (g, t) tokens
// 2t, 2t + 1 of channel g of each tile, which it stores as one word.
// Channels past width are not stored.
template <int kTokens>
__device__ __forceinline__ void transpose_slab(const bf16* rows, int ld, bf16* cols, int width) {
    constexpr int kLdl = kTokens + 8;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = frag_row(lane), tc = frag_col(lane);
    const int tile = lane >> 3, r8 = lane & 7;
    const int channel_tiles8 = (width + 7) / 8, channel_pairs = (channel_tiles8 + 1) / 2;
    for (int item = warp; item < kTokens / 16 * channel_pairs; item += kMmaWarps) {
        const int tp = item / channel_pairs, cp = item - tp * channel_pairs;
        const int ct = min(2 * cp + (tile >> 1), channel_tiles8 - 1);
        uint32_t r[4];
        ldmatrix_x4_trans(r, shared_address(rows + (16 * tp + 8 * (tile & 1) + r8) * ld + 8 * ct));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int c = 8 * (2 * cp + (i >> 1)) + g;
            if (c < width)
                *reinterpret_cast<uint32_t*>(cols + c * kLdl + 16 * tp + 8 * (i & 1) + tc) = r[i];
        }
    }
}

// kKT, kDK as for K5. A block takes heads [h0, h0 + heads) of board
// blockIdx.x / parts, h0 = heads * (blockIdx.x % parts).
template <int kKT, int kDK>
__global__ void __launch_bounds__(kMmaWarps * 32, kBoardMinBlocks<kKT, kDK>) attn_infold_fwd_mma(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, int L, int H, int dh, int heads, int parts, int word_bytes, float scale)
{
    constexpr int kTokens = 16 * kKT, kLdl = kTokens + 8;  // padded_row_elems(kTokens)
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int D = H * dh, ld = padded_row_elems(heads * dh);
    const int rslab = kTokens * ld, tslab = heads * dh * kLdl;
    bf16* rows = reinterpret_cast<bf16*>(smem_raw);  // q (becomes o), k, v row-major
    bf16* cols = rows + 3 * rslab;                     // q, k, v transposed
    const int board_index = blockIdx.x / parts;
    const int h0 = heads * (blockIdx.x - board_index * parts);
    const int nh = min(heads, H - h0), width = nh * dh;
    const size_t board = static_cast<size_t>(board_index) * L * D;
    in_words(word_bytes, [&](auto word) {
        constexpr int kBytes = decltype(word)::value;
        stage_rows<kBytes>(q + board, rows, ld, D, h0 * dh, width, 0, L, kTokens);
        stage_rows<kBytes>(k + board, rows + rslab, ld, D, h0 * dh, width, 0, L, kTokens);
        stage_rows<kBytes>(v + board, rows + 2 * rslab, ld, D, h0 * dh, width, 0, L, kTokens);
    });
    cp_async_wait_all();
    __syncthreads();
    for (int t = 0; t < 3; ++t) transpose_slab<kTokens>(rows + t * rslab, ld, cols + t * tslab, width);
    __syncthreads();

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int tc = frag_col(lane);
    // This lane's row of an ldmatrix.x4: 8 rows of one tile, two tiles down
    // (rows + 8) and two across (16 bytes further). Channel rows past the
    // block's last head are read from its last row: they meet zeroed Q depth
    // or give output channels that are not stored.
    const int r8 = lane & 7, down = (lane >> 3) & 1, across = lane >> 4;
    const uint32_t qs_at = shared_address(cols);
    const uint32_t ks_at = qs_at + tslab * 2, vs_at = qs_at + 2 * tslab * 2;
    const int q_tiles = (L + 15) / 16;
    for (int item = warp; item < nh * q_tiles; item += kMmaWarps) {
        const int hl = item / q_tiles;
        const int i0 = 16 * (item - hl * q_tiles);  // this warp's 16 query rows
        const int row0 = hl * dh;                   // and its head's channel rows
        auto channel_row = [&](int d) { return min(row0 + d, width - 1); };

        // A = Q (rows i, depth d) from q's [d][i] rows: ldmatrix.trans; the
        // depth past Dh zeroed.
        uint32_t qa[kDK][4];
#pragma unroll
        for (int kk = 0; kk < kDK; ++kk) {
            ldmatrix_x4_trans(qa[kk], qs_at + (channel_row(kk * 16 + across * 8 + r8) * kLdl
                                               + i0 + down * 8) * 2);
            const int c = 16 * kk + tc;
            qa[kk][0] = within(qa[kk][0], c, dh);
            qa[kk][1] = within(qa[kk][1], c, dh);
            qa[kk][2] = within(qa[kk][2], c + 8, dh);
            qa[kk][3] = within(qa[kk][3], c + 8, dh);
        }

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
                ldmatrix_x4_trans(b, ks_at + (channel_row(kk * 16 + down * 8 + r8) * kLdl
                                              + jt * 16 + across * 8) * 2);
                mma_chained(s[2 * jt], qa[kk], b[0], b[1], kk);
                mma_chained(s[2 * jt + 1], qa[kk], b[2], b[3], kk);
            }
        }

        float mx[2], rinv[2];
        softmax_fragments(s, L - tc, scale, mx, rinv);

        // O = round(P) . V: B = V (depth j, columns d) from v's [d][j] rows:
        // plain ldmatrix.
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
                ldmatrix_x4(b, vs_at + (channel_row(kk * 16 + across * 8 + r8) * kLdl
                                        + jt * 16 + down * 8) * 2);
                mma_bf16_16816(oacc[2 * kk], pa, b[0], b[1]);
                mma_bf16_16816(oacc[2 * kk + 1], pa, b[2], b[3]);
            }
        }
        // q's row-major slab is no longer read: O goes there in the board's layout.
        put_output<kDK>(rows + row0, ld, oacc, i0, L, dh, lane);
    }
    __syncthreads();
    in_words(word_bytes, [&](auto word) {
        store_rows<decltype(word)::value>(o + board, rows, ld, D, h0 * dh, width, 0, L);
    });
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: attn_infold_bwd_mma (K7)
// ---------------------------------------------------------------------------
//
// K6's staging and the backward core of attn_mma.cuh (fold_bwd_query_rows,
// fold_bwd_key_rows: K9's two passes on [channel][token] slabs, shared with
// K4). A block stages its heads' columns of q, k, v and dO row-major by
// 16-byte cp.async, transposes all four on chip into [channel][token] slabs
// (transpose_slab), and runs pass 1 (a warp per 16 query rows of a head:
// the row statistics and dq) and pass 2 (a warp per 16 key rows: dk and dv).
// The gradients leave the tensor cores as (token, channel) fragments, the
// board's own layout: dq goes over q's row-major slab, dk and dv over k's and
// v's, all free once transposed, and they leave row-major in 16-byte words,
// as K6's O does. No atomics: the same bits every run. A block's unit is a
// group of heads of one board (board_mma_plan, "infold_bwd"): at (81, 14)
// two heads take 55 KiB, and three blocks share an SM.

// Shared memory of a K7 block of `heads` heads: their columns of q, k, v and
// dO row-major, [16 kKT][padded_row_elems(heads Dh)], then transposed,
// [heads Dh][16 kKT + 8], then each head's three row statistics (max,
// 1 / sum, row) of its 16 kKT query rows.
__host__ __device__ inline size_t infold_bwd_mma_smem_bytes(int L, int dh, int heads) {
    const size_t tokens = 16 * key_tiles(L), width = static_cast<size_t>(heads) * dh;
    return 4 * (tokens * padded_row_elems(heads * dh) + width * (tokens + 8)) * sizeof(bf16)
           + 3 * heads * tokens * sizeof(float);
}

// kKT, kDK as for K5. A block takes heads [h0, h0 + heads) of board
// blockIdx.x / parts, h0 = heads * (blockIdx.x % parts).
template <int kKT, int kDK>
__global__ void __launch_bounds__(kMmaWarps * 32, kFoldBwdMinBlocks<kKT, kDK>) attn_infold_bwd_mma(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ g_out, bf16* __restrict__ dq, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int L, int H, int dh, int heads, int parts, int word_bytes, float scale)
{
    constexpr int kTokens = 16 * kKT, kLdl = kTokens + 8;  // padded_row_elems(kTokens)
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int D = H * dh, ld = padded_row_elems(heads * dh);
    const int rslab = kTokens * ld, tslab = heads * dh * kLdl;
    bf16* rows = reinterpret_cast<bf16*>(smem_raw);  // q, k, v, dO row-major; dq, dk, dv over the first three
    bf16* cols = rows + 4 * rslab;                     // q, k, v, dO transposed
    float* stats = reinterpret_cast<float*>(cols + 4 * tslab);  // [head][3][16 kKT]
    const int board_index = blockIdx.x / parts;
    const int h0 = heads * (blockIdx.x - board_index * parts);
    const int nh = min(heads, H - h0), width = nh * dh;
    const size_t board = static_cast<size_t>(board_index) * L * D;
    const bf16* const src[4] = {q, k, v, g_out};
    in_words(word_bytes, [&](auto word) {
        constexpr int kBytes = decltype(word)::value;
#pragma unroll
        for (int t = 0; t < 4; ++t)
            stage_rows<kBytes>(src[t] + board, rows + t * rslab, ld, D, h0 * dh, width, 0, L, kTokens);
    });
    cp_async_wait_all();
    __syncthreads();
    for (int t = 0; t < 4; ++t) transpose_slab<kTokens>(rows + t * rslab, ld, cols + t * tslab, width);
    __syncthreads();

    const int lane = threadIdx.x & 31;
    const uint32_t cols_at = shared_address(cols);
    // A head's rows of the transposed slabs; channel rows past the block's
    // last head are read from its last row.
    auto head = [&](int hl) {
        const uint32_t q_at = cols_at + hl * dh * kLdl * 2;
        return FoldHead{q_at, q_at + tslab * 2, q_at + 2 * tslab * 2, q_at + 3 * tslab * 2,
                        width - 1 - hl * dh};
    };
    using Frags = float[2 * kDK][4];
    // The gradients over q's, k's and v's row-major slabs, the board's layout.
    fold_bwd_passes<kKT, kDK>(
        nh, L, dh, scale, stats, head,
        [&](int hl, int i0, const Frags& dqa) {
            put_output<kDK>(rows + hl * dh, ld, dqa, i0, L, dh, lane);
        },
        [&](int hl, int j0, const Frags& dka, const Frags& dva) {
            put_output<kDK>(rows + rslab + hl * dh, ld, dka, j0, L, dh, lane);
            put_output<kDK>(rows + 2 * rslab + hl * dh, ld, dva, j0, L, dh, lane);
        });
    __syncthreads();
    in_words(word_bytes, [&](auto word) {
        constexpr int kBytes = decltype(word)::value;
        store_rows<kBytes>(dq + board, rows, ld, D, h0 * dh, width, 0, L);
        store_rows<kBytes>(dk + board, rows + rslab, ld, D, h0 * dh, width, 0, L);
        store_rows<kBytes>(dv + board, rows + 2 * rslab, ld, D, h0 * dh, width, 0, L);
    });
}

// The widest word, 16 bytes at most, that divides 2 D, 2 cols (the columns
// of a block, and so their first column) and the tensors' addresses.
int board_word_bytes(const void* q, const void* k, const void* v, const void* o, int D, int cols) {
    const void* const tensors[] = {q, k, v, o};
    return packed_word_bytes(tensors, D | cols);
}

template <int kKT, int kDK>
cudaError_t lane_slice_mma_setup() {
    static bool done = false;
    return mma_setup(attn_lane_slice_fwd_mma<kKT, kDK>, done);
}

template <int kKT, int kDK>
cudaError_t infold_mma_setup() {
    static bool done = false;
    return mma_setup(attn_infold_fwd_mma<kKT, kDK>, done);
}

template <int kKT, int kDK>
int lane_slice_fwd_mma(const void* q, const void* k, const void* v, void* o, int B, int L, int H,
                       int dh, int tiles, cudaStream_t stream) {
    const cudaError_t err = lane_slice_mma_setup<kKT, kDK>();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int parts = ((L + 15) / 16 + tiles - 1) / tiles;
    attn_lane_slice_fwd_mma<kKT, kDK><<<B * parts, kMmaWarps * 32,
                                        lane_slice_mma_smem_bytes(L, H, dh), stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(o), L, H, dh, tiles, parts, board_word_bytes(q, k, v, o, H * dh, H * dh),
        1.0f / sqrtf(static_cast<float>(dh)));
    return static_cast<int>(cudaGetLastError());
}

template <int kKT, int kDK>
int infold_fwd_mma(const void* q, const void* k, const void* v, void* o, int B, int L, int H,
                   int dh, int heads, cudaStream_t stream) {
    const cudaError_t err = infold_mma_setup<kKT, kDK>();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int parts = (H + heads - 1) / heads;
    attn_infold_fwd_mma<kKT, kDK><<<B * parts, kMmaWarps * 32, infold_mma_smem_bytes(L, dh, heads),
                                    stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(o), L, H, dh, heads, parts,
        board_word_bytes(q, k, v, o, H * dh, heads * dh), 1.0f / sqrtf(static_cast<float>(dh)));
    return static_cast<int>(cudaGetLastError());
}

template <int kKT, int kDK>
cudaError_t infold_bwd_mma_setup() {
    static bool done = false;
    return mma_setup(attn_infold_bwd_mma<kKT, kDK>, done);
}

template <int kKT, int kDK>
int infold_bwd_mma(const void* q, const void* k, const void* v, const void* g, void* dq, void* dk,
                   void* dv, int B, int L, int H, int dh, int heads, cudaStream_t stream) {
    const cudaError_t err = infold_bwd_mma_setup<kKT, kDK>();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int parts = (H + heads - 1) / heads;
    const void* const tensors[] = {q, k, v, g, dq, dk, dv};
    attn_infold_bwd_mma<kKT, kDK><<<B * parts, kMmaWarps * 32,
                                    infold_bwd_mma_smem_bytes(L, dh, heads), stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(g), static_cast<bf16*>(dq), static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), L, H, dh, heads, parts,
        packed_word_bytes(tensors, H * dh | heads * dh), 1.0f / sqrtf(static_cast<float>(dh)));
    return static_cast<int>(cudaGetLastError());
}

bool shape_ok(int B, int L, int H, int dh, int heads_per_pass, int threads) {
    return B > 0 && L >= 1 && L <= kMaxL && H >= 1 && dh >= 1 && dh <= kMaxDh
           && heads_per_pass >= 1 && heads_per_pass <= H
           && threads >= 32 && threads <= kBoardThreads && threads % 32 == 0;
}

template <typename T>
int lane_slice_fwd(const void* q, const void* k, const void* v, void* o, int B, int L, int H,
                   int dh, int threads, cudaStream_t stream) {
    static bool allowed = false;
    const cudaError_t err = allow_large_smem(attn_lane_slice_fwd<T>, allowed);
    if (err != cudaSuccess) return static_cast<int>(err);
    const size_t smem = lane_slice_smem_bytes(L, H, dh, threads, sizeof(T));
    attn_lane_slice_fwd<T><<<B, threads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), L, H, dh, 1.0f / sqrtf(static_cast<float>(dh)));
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int infold_fwd(const void* q, const void* k, const void* v, void* o, int B, int L, int H, int dh,
               int heads_per_pass, int threads, cudaStream_t stream) {
    static bool allowed = false;
    const cudaError_t err = allow_large_smem(attn_infold_fwd<T>, allowed);
    if (err != cudaSuccess) return static_cast<int>(err);
    const size_t smem = infold_smem_bytes(false, L, dh, heads_per_pass, threads, sizeof(T));
    attn_infold_fwd<T><<<B, threads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), L, H, dh, heads_per_pass, 1.0f / sqrtf(static_cast<float>(dh)));
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int infold_bwd(const void* q, const void* k, const void* v, const void* g, void* dq, void* dk,
               void* dv, int B, int L, int H, int dh, int heads_per_pass, int threads,
               cudaStream_t stream) {
    static bool allowed = false;
    const cudaError_t err = allow_large_smem(attn_infold_bwd<T>, allowed);
    if (err != cudaSuccess) return static_cast<int>(err);
    const size_t smem = infold_smem_bytes(true, L, dh, heads_per_pass, threads, sizeof(T));
    attn_infold_bwd<T><<<B, threads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(g), static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv),
        L, H, dh, heads_per_pass, 1.0f / sqrtf(static_cast<float>(dh)));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory one block needs, in bytes: the wrapper holds it against the
// card's per-block limit before it launches. kind: 0 lane-slice forward,
// 1 in-kernel-fold forward, 2 in-kernel-fold backward.
extern "C" size_t board_attn_smem_bytes(int kind, int L, int H, int dh, int heads_per_pass,
                                        int threads, int itemsize) {
    if (kind == 0) return lane_slice_smem_bytes(L, H, dh, threads, itemsize);
    return infold_smem_bytes(kind == 2, L, dh, heads_per_pass, threads, itemsize);
}

extern "C" int board_attn_max_tokens() { return kMaxL; }
extern "C" int board_attn_max_head_dim() { return kMaxDh; }
extern "C" int board_attn_max_threads() { return kBoardThreads; }

extern "C" int attn_lane_slice_fwd_launch(int is_bf16, const void* q, const void* k, const void* v,
                                          void* o, int B, int L, int H, int dh, int threads,
                                          void* stream) {
    if (B == 0) return 0;
    if (!shape_ok(B, L, H, dh, H, threads)) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return is_bf16 ? lane_slice_fwd<__nv_bfloat16>(q, k, v, o, B, L, H, dh, threads, s)
                   : lane_slice_fwd<float>(q, k, v, o, B, L, H, dh, threads, s);
}

extern "C" int attn_infold_fwd_launch(int is_bf16, const void* q, const void* k, const void* v,
                                      void* o, int B, int L, int H, int dh, int heads_per_pass,
                                      int threads, void* stream) {
    if (B == 0) return 0;
    if (!shape_ok(B, L, H, dh, heads_per_pass, threads))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return is_bf16
        ? infold_fwd<__nv_bfloat16>(q, k, v, o, B, L, H, dh, heads_per_pass, threads, s)
        : infold_fwd<float>(q, k, v, o, B, L, H, dh, heads_per_pass, threads, s);
}

extern "C" int attn_infold_bwd_launch(int is_bf16, const void* q, const void* k, const void* v,
                                      const void* g, void* dq, void* dk, void* dv, int B, int L,
                                      int H, int dh, int heads_per_pass, int threads,
                                      void* stream) {
    if (B == 0) return 0;
    if (!shape_ok(B, L, H, dh, heads_per_pass, threads))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return is_bf16
        ? infold_bwd<__nv_bfloat16>(q, k, v, g, dq, dk, dv, B, L, H, dh, heads_per_pass, threads, s)
        : infold_bwd<float>(q, k, v, g, dq, dk, dv, B, L, H, dh, heads_per_pass, threads, s);
}

// The bf16 kernels on the tensor cores (is_bf16 = 1), four warps a block.
// K5: `tiles` query tiles of one board a block; K6 and K7: `heads` heads of
// one board a block. Their shared memory, and what an instantiation takes on
// the card (registers, local bytes, blocks an SM at that shared memory).
extern "C" size_t attn_lane_slice_fwd_mma_smem_bytes(int L, int H, int dh) {
    return lane_slice_mma_smem_bytes(L, H, dh);
}

extern "C" size_t attn_infold_fwd_mma_smem_bytes(int L, int dh, int heads) {
    return infold_mma_smem_bytes(L, dh, heads);
}

extern "C" int attn_lane_slice_fwd_mma_launch(int is_bf16, const void* q, const void* k,
                                              const void* v, void* o, int B, int L, int H, int dh,
                                              int tiles, void* stream) {
    if (B == 0) return 0;
    if (!is_bf16 || !shape_ok(B, L, H, dh, H, kMmaWarps * 32) || tiles < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    return for_tiles(L, dh, [&](auto kt, auto dk) {
        return lane_slice_fwd_mma<decltype(kt)::value, decltype(dk)::value>(
            q, k, v, o, B, L, H, dh, tiles, static_cast<cudaStream_t>(stream));
    });
}

extern "C" int attn_infold_fwd_mma_launch(int is_bf16, const void* q, const void* k, const void* v,
                                          void* o, int B, int L, int H, int dh, int heads,
                                          void* stream) {
    if (B == 0) return 0;
    if (!is_bf16 || !shape_ok(B, L, H, dh, heads, kMmaWarps * 32))
        return static_cast<int>(cudaErrorInvalidValue);
    return for_tiles(L, dh, [&](auto kt, auto dk) {
        return infold_fwd_mma<decltype(kt)::value, decltype(dk)::value>(
            q, k, v, o, B, L, H, dh, heads, static_cast<cudaStream_t>(stream));
    });
}

extern "C" int attn_lane_slice_fwd_mma_resources(int L, int H, int dh, int* registers,
                                                 int* local_bytes, int* blocks_per_sm) {
    if (!shape_ok(1, L, H, dh, H, kMmaWarps * 32)) return static_cast<int>(cudaErrorInvalidValue);
    return for_tiles(L, dh, [&](auto kt, auto dk) {
        constexpr int kKT = decltype(kt)::value, kDK = decltype(dk)::value;
        const cudaError_t err = lane_slice_mma_setup<kKT, kDK>();
        if (err != cudaSuccess) return static_cast<int>(err);
        return mma_resources(attn_lane_slice_fwd_mma<kKT, kDK>, lane_slice_mma_smem_bytes(L, H, dh),
                             registers, local_bytes, blocks_per_sm);
    });
}

extern "C" int attn_infold_fwd_mma_resources(int L, int dh, int heads, int* registers,
                                             int* local_bytes, int* blocks_per_sm) {
    if (!shape_ok(1, L, heads, dh, heads, kMmaWarps * 32))
        return static_cast<int>(cudaErrorInvalidValue);
    return for_tiles(L, dh, [&](auto kt, auto dk) {
        constexpr int kKT = decltype(kt)::value, kDK = decltype(dk)::value;
        const cudaError_t err = infold_mma_setup<kKT, kDK>();
        if (err != cudaSuccess) return static_cast<int>(err);
        return mma_resources(attn_infold_fwd_mma<kKT, kDK>, infold_mma_smem_bytes(L, dh, heads),
                             registers, local_bytes, blocks_per_sm);
    });
}

extern "C" size_t attn_infold_bwd_mma_smem_bytes(int L, int dh, int heads) {
    return infold_bwd_mma_smem_bytes(L, dh, heads);
}

extern "C" int attn_infold_bwd_mma_launch(int is_bf16, const void* q, const void* k, const void* v,
                                          const void* g, void* dq, void* dk, void* dv, int B,
                                          int L, int H, int dh, int heads, void* stream) {
    if (B == 0) return 0;
    if (!is_bf16 || !shape_ok(B, L, H, dh, heads, kMmaWarps * 32))
        return static_cast<int>(cudaErrorInvalidValue);
    return for_tiles(L, dh, [&](auto kt, auto dk_tiles) {
        return infold_bwd_mma<decltype(kt)::value, decltype(dk_tiles)::value>(
            q, k, v, g, dq, dk, dv, B, L, H, dh, heads, static_cast<cudaStream_t>(stream));
    });
}

extern "C" int attn_infold_bwd_mma_resources(int L, int dh, int heads, int* registers,
                                             int* local_bytes, int* blocks_per_sm) {
    if (!shape_ok(1, L, heads, dh, heads, kMmaWarps * 32))
        return static_cast<int>(cudaErrorInvalidValue);
    return for_tiles(L, dh, [&](auto kt, auto dk_tiles) {
        constexpr int kKT = decltype(kt)::value, kDK = decltype(dk_tiles)::value;
        const cudaError_t err = infold_bwd_mma_setup<kKT, kDK>();
        if (err != cudaSuccess) return static_cast<int>(err);
        return mma_resources(attn_infold_bwd_mma<kKT, kDK>, infold_bwd_mma_smem_bytes(L, dh, heads),
                             registers, local_bytes, blocks_per_sm);
    });
}
