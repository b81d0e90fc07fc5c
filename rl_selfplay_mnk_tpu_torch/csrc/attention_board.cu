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
// moves 4*B*L*D elements, a backward 7*B*L*D). The products are FMA on the
// CUDA cores out of shared memory, which is what bounds these versions.
//
// Design. A board's rows are D*itemsize bytes, a multiple of 16 at every
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
