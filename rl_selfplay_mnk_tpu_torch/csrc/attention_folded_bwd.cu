// The folded attention backward in bf16 on the tensor cores (K4's bf16 path)
// for Hopper (sm_90a): q, k, v, dO (BH, Dh, L), a head per leading index
// with its tokens contiguous, -> dq, dk, dv of the same shape.
//
//     p  = softmax(q . k * scale) over the keys   f32, padded keys masked
//     dp = dO . v
//     row = sum_j dp * p                           over the f32 p
//     ds = round(p * (dp - row) * scale)
//     dq = ds . k,  dk = ds^T . q,  dv = round(p)^T . dO
//
// with f32 sums and outputs rounded to bf16: the arithmetic of
// attention_folded_bwd_reference (ops/attention.py). Replaces the bf16 use
// of _attn_bwd_kernel (rl_selfplay_mnk_tpu/ops/pallas_attention.py); f32
// keeps attn_folded_bwd (attention.cu), whose FMA products stay in f32 where
// the tensor cores would round to TF32.
//
// Bound: a call moves 7*BH*L*Dh bf16 elements and does 10*BH*L*L*Dh
// operations; at the 9x9 update's minibatch (BH = 32,768 heads, L = 81,
// Dh = 14) the bytes take 0.155 ms, and the products, padded to 96 x 96 x 16
// and counted seven times, about 0.07 ms at the bf16 peak. Besides those
// there are two exponentials a score (about 0.6 G a call) and the f32
// arithmetic of dS around the products.
//
// Design. K3's staging and K9's two passes, shared with K7 through
// attn_mma.cuh. A block of four warps takes up to four consecutive heads,
// whose q, k, v and dO are one contiguous span each: it reads them with
// 16-byte loads, four in flight a thread, and scatters them into bf16
// [16 channel_tiles(Dh)][16 key_tiles(L) + 8] slabs, zero padded
// (move_span). Pass 1 takes a warp per 16 query rows, pass 2 a warp per 16
// key rows (fold_bwd_passes). Q and dO are read again
// in pass 2, so dq goes to a fifth slab of its own; dK and dV go over the
// warp's own columns of k and v, which only it reads in pass 2. All three
// leave as the spans they came in. The kernel is compiled per padded size
// (for_tiles), so that no loop carries a bound. At (81, 14) a head takes
// 17.4 KiB: four heads a block, three blocks an SM.
//
// Each C entry returns cudaGetLastError() after the launch; the Python
// wrapper (ops/attention.py) raises when it is not 0.

#include "attn_common.cuh"
#include "attn_mma.cuh"
#include "mma_common.cuh"

namespace {

// Shared memory of one block: `heads` heads' five slabs (q, k, v, dO, dq in
// that order), then each head's three row statistics (max, 1 / sum, row) of
// its 16 key_tiles(L) query rows.
__host__ __device__ inline size_t folded_bwd_mma_smem_bytes(int L, int dh, int heads) {
    const int tokens = 16 * key_tiles(L);
    return static_cast<size_t>(heads)
           * (5 * 16 * channel_tiles(dh) * padded_row_elems(tokens) * sizeof(bf16)
              + 3 * tokens * sizeof(float));
}

// A C fragment's rows (tokens t0 + g, t0 + g + 8) and columns (channels
// 8u + tc, + 1) -> a head's [channel][token] slab, tokens below L only.
template <int kKT, int kDK>
__device__ __forceinline__ void put_folded(bf16* slab, const float (&acc)[2 * kDK][4], int t0,
                                           int L, int lane) {
    constexpr int kLd = 16 * kKT + 8;
    const int g = frag_row(lane), tc = frag_col(lane);
#pragma unroll
    for (int u = 0; u < 2 * kDK; ++u) {
        const int d = u * 8 + tc;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int t = t0 + g + 8 * r;
            if (t < L) {
                slab[d * kLd + t] = __float2bfloat16(acc[u][2 * r]);
                slab[(d + 1) * kLd + t] = __float2bfloat16(acc[u][2 * r + 1]);
            }
        }
    }
}

// kKT: 16-token tiles a head is padded to, kDK: 16-channel tiles
// (key_tiles, channel_tiles).
template <int kKT, int kDK>
__global__ void __launch_bounds__(kMmaWarps * 32, kFoldBwdMinBlocks<kKT, kDK>) attn_folded_bwd_mma(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ g_out, bf16* __restrict__ dq, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int BH, int L, int dh, int heads, float scale)
{
    constexpr int kLd = 16 * kKT + 8;       // padded_row_elems(16 kKT)
    constexpr int kSlab = 16 * kDK * kLd;   // one tensor of one head
    constexpr int kHeadStride = 5 * kSlab;  // a head's q, k, v, dO and dq slabs, in that order
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* smem = reinterpret_cast<bf16*>(smem_raw);
    float* stats = reinterpret_cast<float*>(smem + heads * kHeadStride);  // [head][3][16 kKT]
    const int head0 = blockIdx.x * heads;
    const int nh = min(heads, BH - head0);
    const int n = nh * dh * L;
    const size_t span0 = static_cast<size_t>(head0) * dh * L;
    const SlabMap at{FastDiv(dh * L), FastDiv(L), kHeadStride, kLd};

    // Zero the four slabs that are read, padding included, then stage.
    constexpr int kRead = 4 * kSlab / 8;  // 16-byte words of a head's q, k, v, dO
    for (int i = threadIdx.x; i < nh * kRead; i += blockDim.x) {
        const int hl = i / kRead;
        reinterpret_cast<uint4*>(smem + hl * kHeadStride)[i - hl * kRead] = make_uint4(0, 0, 0, 0);
    }
    __syncthreads();
    move_span<true>(const_cast<bf16*>(q) + span0, smem, n, at);
    move_span<true>(const_cast<bf16*>(k) + span0, smem + kSlab, n, at);
    move_span<true>(const_cast<bf16*>(v) + span0, smem + 2 * kSlab, n, at);
    move_span<true>(const_cast<bf16*>(g_out) + span0, smem + 3 * kSlab, n, at);
    __syncthreads();

    const int lane = threadIdx.x & 31;
    auto head = [&](int hl) {
        const uint32_t q_at = shared_address(smem + hl * kHeadStride);
        return FoldHead{q_at, q_at + kSlab * 2, q_at + 2 * kSlab * 2, q_at + 3 * kSlab * 2,
                        16 * kDK - 1};
    };
    using Frags = float[2 * kDK][4];
    // dq to its own slab; dk and dv over the warp's own columns of k and v,
    // which only it reads in pass 2 (their A fragments are in registers).
    fold_bwd_passes<kKT, kDK>(
        nh, L, dh, scale, stats, head,
        [&](int hl, int i0, const Frags& dqa) {
            put_folded<kKT, kDK>(smem + hl * kHeadStride + 4 * kSlab, dqa, i0, L, lane);
        },
        [&](int hl, int j0, const Frags& dka, const Frags& dva) {
            put_folded<kKT, kDK>(smem + hl * kHeadStride + kSlab, dka, j0, L, lane);
            put_folded<kKT, kDK>(smem + hl * kHeadStride + 2 * kSlab, dva, j0, L, lane);
        });
    __syncthreads();
    move_span<false>(dq + span0, smem + 4 * kSlab, n, at);
    move_span<false>(dk + span0, smem + kSlab, n, at);
    move_span<false>(dv + span0, smem + 2 * kSlab, n, at);
}

template <int kKT, int kDK>
cudaError_t folded_bwd_mma_setup() {
    static bool done = false;
    return mma_setup(attn_folded_bwd_mma<kKT, kDK>, done);
}

template <int kKT, int kDK>
int folded_bwd_mma(const void* q, const void* k, const void* v, const void* g, void* dq, void* dk,
                   void* dv, int BH, int dh, int L, int heads, cudaStream_t stream) {
    const cudaError_t err = folded_bwd_mma_setup<kKT, kDK>();
    if (err != cudaSuccess) return static_cast<int>(err);
    attn_folded_bwd_mma<kKT, kDK><<<(BH + heads - 1) / heads, kMmaWarps * 32,
                                    folded_bwd_mma_smem_bytes(L, dh, heads), stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(g), static_cast<bf16*>(dq), static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), BH, L, dh, heads, 1.0f / sqrtf(static_cast<float>(dh)));
    return static_cast<int>(cudaGetLastError());
}

template <int kKT, int kDK>
int folded_bwd_mma_resources(int L, int dh, int heads, int* registers, int* local_bytes,
                             int* blocks_per_sm) {
    const cudaError_t err = folded_bwd_mma_setup<kKT, kDK>();
    if (err != cudaSuccess) return static_cast<int>(err);
    return mma_resources(attn_folded_bwd_mma<kKT, kDK>, folded_bwd_mma_smem_bytes(L, dh, heads),
                         registers, local_bytes, blocks_per_sm);
}

bool folded_bwd_shape_ok(int BH, int L, int dh, int heads) {
    return BH > 0 && L >= 1 && L <= kMaxL && dh >= 1 && dh <= kMaxDh && heads >= 1
           && heads <= kMmaMaxHeads;
}

}  // namespace

// The folded backward on the tensor cores, bf16 only (is_bf16 = 1): `heads`
// consecutive heads a block (at most 4), four warps, a warp per 16 query
// rows of a head in pass 1 and per 16 key rows in pass 2.
extern "C" size_t attn_folded_bwd_mma_smem_bytes(int L, int dh, int heads) {
    return folded_bwd_mma_smem_bytes(L, dh, heads);
}

extern "C" int attn_folded_bwd_mma_launch(int is_bf16, const void* q, const void* k, const void* v,
                                          const void* g, void* dq, void* dk, void* dv, int BH,
                                          int dh, int L, int heads, void* stream) {
    if (BH == 0) return 0;
    if (!is_bf16 || !folded_bwd_shape_ok(BH, L, dh, heads))
        return static_cast<int>(cudaErrorInvalidValue);
    return for_tiles(L, dh, [&](auto kt, auto dk_tiles) {
        return folded_bwd_mma<decltype(kt)::value, decltype(dk_tiles)::value>(
            q, k, v, g, dq, dk, dv, BH, dh, L, heads, static_cast<cudaStream_t>(stream));
    });
}

extern "C" int attn_folded_bwd_mma_resources(int L, int dh, int heads, int* registers,
                                             int* local_bytes, int* blocks_per_sm) {
    if (!folded_bwd_shape_ok(1, L, dh, heads)) return static_cast<int>(cudaErrorInvalidValue);
    return for_tiles(L, dh, [&](auto kt, auto dk_tiles) {
        return folded_bwd_mma_resources<decltype(kt)::value, decltype(dk_tiles)::value>(
            L, dh, heads, registers, local_bytes, blocks_per_sm);
    });
}
