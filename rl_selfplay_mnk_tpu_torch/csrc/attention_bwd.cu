// The packed attention backward in bf16 on the tensor cores (K9's bf16
// path) for Hopper (sm_90a): q, k, v, dO (B, L, D = H*Dh), a head's Dh values
// contiguous inside a row, -> dq, dk, dv of the same shape.
//
//     p  = softmax(q . k * scale) over the keys   f32, padded keys masked
//     dp = dO . v
//     row = sum_j dp * p                           over the f32 p
//     ds = round(p * (dp - row) * scale)
//     dq = ds . k,  dk = ds^T . q,  dv = round(p)^T . dO
//
// with f32 sums and outputs rounded to bf16: the arithmetic of
// attention_packed_bwd_reference (ops/attention.py). Replaces the bf16 use
// of _packed_bwd_kernel (rl_selfplay_mnk_tpu/ops/pallas_attention.py); f32
// keeps attn_packed_bwd (attention.cu), whose FMA products stay in f32 where
// the tensor cores would round to TF32.
//
// Bound: a call moves 7*B*L*D bf16 elements and does 10*B*H*L*L*Dh
// operations; at the 13x13 update's minibatch (B = 4096, L = 169, H = 2,
// Dh = 64) the bytes take 0.37 ms and the operations, even padded to
// 176 x 176 x 64 and counted seven times (below), about 0.23 ms at the bf16
// peak. What is left besides the bytes is two exponentials a score and the
// f32 arithmetic of dS around the products.
//
// Design. A block of four warps takes up to four consecutive heads (of one
// board or of more), one where a head is large: at (169, 64) the four slabs
// of q, k, v and dO take 99 KiB and two blocks share an SM. The heads are
// staged by K8's stage_packed, cp.async in the widest word, into bf16
// [16 key_tiles(L)][16 channel_tiles(Dh) + 8] slabs, zero padded, and the
// kernel is compiled per padded size, as K3's and K8's. Two passes, each
// walking (head, 16-row tile) items across the warps:
//
//   Pass 1, a warp per 16 query rows. S = Q K^T and dP = dO V^T (Q, dO as A
//   and K, V as B, plain ldmatrix) are both held in registers, 16 kKT f32 a
//   lane each; K8's softmax_fragments turns S into exp(x - max) and gives
//   max and 1 / sum, row = sum dP p is taken over p = exp(x - max) * (1 /
//   sum) in f32, and dS is rounded to bf16 straight into the A fragments of
//   dQ = dS K (K as B through ldmatrix.trans), which frees S and dP before
//   dQ's sums come alive. Each row's max, 1 / sum and row go to shared
//   memory; dq leaves from its fragments, two channels a store where the
//   tensors allow it.
//
//   Pass 2, a warp per 16 key rows, streaming over the query tiles. S^T = K
//   Q^T and dP^T = V dO^T (K, V as A from registers, Q, dO as B, plain
//   ldmatrix) a 16 x 16 tile at a time; p = exp(x - max) * (1 / sum) from
//   the stored statistics with softmax_fragments' arithmetic; round(P)^T and
//   dS^T become A fragments in registers for dV += round(P)^T dO and dK +=
//   dS^T Q (dO and Q as B through ldmatrix.trans). dK and dV are summed in
//   registers over the query tiles, in one order, inside one warp: no
//   atomics, the same bits every run. They go back over the warp's own rows
//   of k's and v's slabs, which only this warp reads in pass 2, and leave by
//   K8's store_packed.
//
// Seven products of 16 x 16 x Dh tiles a (query, key) tile pair: S, dP, dQ
// in pass 1 and S^T, dP^T, dV, dK in pass 2; a FlashAttention-2 backward
// takes five, with atomics for dQ. Holding S and dP together costs the
// registers: at (169, 64) the peak is 176 f32 of them, so a thread may take
// 255 and two blocks (eight warps) share an SM.
//
// S and dP (both passes) add each 16-deep product past the first in f32,
// rounding to nearest (mma_chained): chained in the tensor cores' own
// accumulator, their round-toward-zero put dk's worst element at the
// update's minibatch at 1.22 of chip_smoke.py's bf16 limit on an H100,
// against 0.78 this way; dQ, dK and dV feed only the outputs' rounding and
// stay chained.
//
// Some sums go a depth pair at a time instead (mma_pairs, the fold core's
// sum, close to the plain version's sequential f32 sum), chosen at compile
// time (kPairS, kPairT): pass 1's S where a head has at most 32 channels
// (kDK <= 2), pass 2's S^T and dP^T where it has at most 16 (kDK = 1); the
// instantiations for heads of 64 are unchanged. Measured with
// utils/attn_bwd_study.py --numerics --seeds 0 ... 9 (NVIDIA H100 80GB HBM3,
// 700 W), as shares of chip_smoke.py's bf16 limit from the plain version and
// from the f64 computation:
//   * Dh <= 16: as one truncated product a tile, pass 2's put dv at 1.01 at
//     the 9x9 update's minibatch (8192, 81, 4, 14), and pass 1's S put dq at
//     1.05 at one input at (2048, 169, 8, 12). Pairing pass 1's dP as well
//     moved no share across the limit and cost as much time again as S's
//     pairs. The pairs take 1.9x the time of one product a tile at
//     (8192, 81, 4, 14), 2.0x at (2048, 169, 8, 12).
//   * Dh = 32: pass 1's S as one product a 16-channel step put dq at 1.54
//     (from both) at (384, 81, 3, 32), seed 2; paired, 0.67 at worst over
//     the ten seeds. Pairing pass 2 too gave dk 0.63 and left dv where it
//     was (1.04 at the seed where the plain version is 1.03 from f64, 0.78
//     from f64); pairing pass 1's dP too put dq at 0.82. S's pairs take
//     1.5x the time there (0.0497 -> 0.0745 ms).
//   * Dh = 64: at most 1.00 from the plain version and 0.97 from f64.
//
// Padding: key columns >= L are masked to p = 0 in pass 1; query rows >= L
// (q and dO zero) give dP = 0 and row = 0, so their dS is 0 and their
// round(P) meets zero rows of dO: they add nothing in pass 2. Key rows >= L
// in pass 2 and query rows >= L in pass 1 are computed and never stored.
//
// Each C entry returns cudaGetLastError() after the launch; the Python
// wrapper (ops/attention.py) raises when it is not 0.

#include "attn_common.cuh"
#include "attn_mma.cuh"
#include "mma_common.cuh"

namespace {

// Shared memory of one block: `heads` heads' four slabs (q, k, v, dO in
// that order), then each head's three row statistics (max, 1 / sum, row) of
// its 16 key_tiles(L) query rows.
__host__ __device__ inline size_t packed_bwd_mma_smem_bytes(int L, int dh, int heads) {
    const int rows = 16 * key_tiles(L);
    return static_cast<size_t>(heads)
           * (4 * rows * padded_row_elems(16 * channel_tiles(dh)) * sizeof(bf16)
              + 3 * rows * sizeof(float));
}

// S (pass 1), S^T or dP^T (pass 2) over one 16-channel tile kk: a depth pair
// at a time where kPairs (mma_pairs), else one 16-deep product added in f32
// past the first (mma_chained).
template <bool kPairs>
__device__ __forceinline__ void channel_step(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1, int kk, int dh) {
    if constexpr (kPairs) mma_pairs(d, a, b0, b1, 16 * kk, dh, kk == 0);
    else mma_chained(d, a, b0, b1, kk);
}

// Which sums go a depth pair at a time: pass 1's S where a head has at most
// 32 channels (kDK <= 2), pass 2's S^T and dP^T where it has at most 16.
template <int kDK>
constexpr bool kPairS = kDK <= 2;
template <int kDK>
constexpr bool kPairT = kDK == 1;

template <int kKT, int kDK>
__global__ void __launch_bounds__(kMmaWarps * 32, kBwdMinBlocks<kKT, kDK>) attn_packed_bwd_mma(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ g_out, bf16* __restrict__ dq, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int n_heads, int L, int H, int dh, int heads, int word_bytes,
    float scale)
{
    constexpr int kLd = 16 * kDK + 8;       // padded_row_elems(16 kDK)
    constexpr int kRows = 16 * kKT;         // a head's padded tokens
    constexpr int kSlab = kRows * kLd;      // one tensor of one head
    constexpr int kHeadStride = 4 * kSlab;  // a head's q, k, v, dO slabs, in that order
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* smem = reinterpret_cast<bf16*>(smem_raw);
    float* stats = reinterpret_cast<float*>(smem + heads * kHeadStride);  // [head][3][kRows]
    const int head0 = blockIdx.x * heads;
    const int nh = min(heads, n_heads - head0);
    const bf16* const src[4] = {q, k, v, g_out};

    switch (word_bytes) {
        case 16: stage_packed<kKT, kDK, 16, 4>(src, smem, head0, nh, L, H, dh); break;
        case 8: stage_packed<kKT, kDK, 8, 4>(src, smem, head0, nh, L, H, dh); break;
        case 4: stage_packed<kKT, kDK, 4, 4>(src, smem, head0, nh, L, H, dh); break;
        default: stage_packed<kKT, kDK, 2, 4>(src, smem, head0, nh, L, H, dh); break;
    }
    cp_async_wait_all();
    __syncthreads();

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = frag_row(lane), tc = frag_col(lane);
    // This lane's row of an ldmatrix.x4: 8 rows of one tile, two tiles down
    // (rows + 8) and two across (16 bytes further).
    const int r8 = lane & 7, down = (lane >> 3) & 1, across = lane >> 4;
    const size_t D = static_cast<size_t>(H) * dh;

    // Pass 1, a warp owns 16 query rows: their statistics, and dq.
    for (int item = warp; item < nh * kKT; item += kMmaWarps) {
        const int hl = item / kKT;
        const int i0 = (item - hl * kKT) * 16;
        if (i0 >= L) continue;  // a tile of padding only
        const uint32_t qs_at = shared_address(smem + hl * kHeadStride);
        const uint32_t ks_at = qs_at + kSlab * 2, vs_at = ks_at + kSlab * 2, gs_at = vs_at + kSlab * 2;

        // S = Q . K^T: A = Q from q's [i][d] rows, B = K^T from k's [j][d] rows,
        // both plain ldmatrix.
        float s[2 * kKT][4];
        {
            uint32_t qa[kDK][4];
#pragma unroll
            for (int kk = 0; kk < kDK; ++kk)
                ldmatrix_x4(qa[kk], qs_at + ((i0 + a_row_of_lane(lane)) * kLd + kk * 16
                                             + a_half_of_lane(lane) * 8) * 2);
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
                    channel_step<kPairS<kDK>>(s[2 * jt], qa[kk], b[0], b[1], kk, dh);
                    channel_step<kPairS<kDK>>(s[2 * jt + 1], qa[kk], b[2], b[3], kk, dh);
                }
            }
        }
        float mx[2], rinv[2];
        softmax_fragments(s, L - tc, scale, mx, rinv);  // s = exp(x - max)

        // dP = dO . V^T: A = dO from dO's [i][d] rows, B = V^T from v's [j][d]
        // rows, both plain ldmatrix.
        float dp[2 * kKT][4];
        {
            uint32_t ga[kDK][4];
#pragma unroll
            for (int kk = 0; kk < kDK; ++kk)
                ldmatrix_x4(ga[kk], gs_at + ((i0 + a_row_of_lane(lane)) * kLd + kk * 16
                                             + a_half_of_lane(lane) * 8) * 2);
#pragma unroll
            for (int j = 0; j < 2 * kKT; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) dp[j][e] = 0.0f;
#pragma unroll
            for (int jt = 0; jt < kKT; ++jt) {
#pragma unroll
                for (int kk = 0; kk < kDK; ++kk) {
                    uint32_t b[4];
                    ldmatrix_x4(b, vs_at + ((jt * 16 + across * 8 + r8) * kLd + kk * 16 + down * 8) * 2);
                    mma_chained(dp[2 * jt], ga[kk], b[0], b[1], kk);
                    mma_chained(dp[2 * jt + 1], ga[kk], b[2], b[3], kk);
                }
            }
        }

        // row = sum_j dp * p over the f32 p of each of the lane's two rows.
        float row[2] = {0.0f, 0.0f};
#pragma unroll
        for (int j = 0; j < 2 * kKT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
                row[e >> 1] = fmaf(dp[j][e], __fmul_rn(s[j][e], rinv[e >> 1]), row[e >> 1]);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            row[r] += __shfl_xor_sync(kFull, row[r], 1);
            row[r] += __shfl_xor_sync(kFull, row[r], 2);
        }
        if (tc == 0) {
            float* st = stats + hl * 3 * kRows;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                st[i0 + g + 8 * r] = mx[r];
                st[kRows + i0 + g + 8 * r] = rinv[r];
                st[2 * kRows + i0 + g + 8 * r] = row[r];
            }
        }

        // ds = round(p * (dp - row) * scale) of keys 16 jt .. 16 jt + 15 as
        // the A fragment of dQ = dS . K (fragment map of probability_fragment).
        uint32_t dsa[kKT][4];
#pragma unroll
        for (int jt = 0; jt < kKT; ++jt) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int j = 2 * jt + half;
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                    float ds[2];
#pragma unroll
                    for (int c = 0; c < 2; ++c) {
                        const float p = __fmul_rn(s[j][2 * r + c], rinv[r]);
                        ds[c] = __fmul_rn(__fmul_rn(p, __fsub_rn(dp[j][2 * r + c], row[r])), scale);
                    }
                    dsa[jt][2 * half + r] = pack_bf16(ds[0], ds[1]);
                }
            }
        }

        // dQ = dS . K: B = K (depth j, columns d) from k's [j][d] rows: ldmatrix.trans.
        float dqa[2 * kDK][4];
#pragma unroll
        for (int u = 0; u < 2 * kDK; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e) dqa[u][e] = 0.0f;
#pragma unroll
        for (int jt = 0; jt < kKT; ++jt) {
#pragma unroll
            for (int kk = 0; kk < kDK; ++kk) {
                uint32_t b[4];
                ldmatrix_x4_trans(b, ks_at + ((jt * 16 + down * 8 + r8) * kLd + kk * 16 + across * 8) * 2);
                mma_bf16_16816(dqa[2 * kk], dsa[jt], b[0], b[1]);
                mma_bf16_16816(dqa[2 * kk + 1], dsa[jt], b[2], b[3]);
            }
        }

        // dq's rows i < L, channels d < Dh, from the fragments: a pair of
        // channels a 4-byte store where the tensors' words allow it.
        bf16* out = dq + packed_head_base(head0 + hl, L, H, dh);
#pragma unroll
        for (int u = 0; u < 2 * kDK; ++u) {
            const int d = u * 8 + tc;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                const int i = i0 + g + 8 * r;
                if (i < L && d < dh) {
                    bf16* at = out + i * D + d;
                    if (word_bytes >= 4) {
                        *reinterpret_cast<uint32_t*>(at) = pack_bf16(dqa[u][2 * r], dqa[u][2 * r + 1]);
                    } else {
                        at[0] = __float2bfloat16(dqa[u][2 * r]);
                        if (d + 1 < dh) at[1] = __float2bfloat16(dqa[u][2 * r + 1]);
                    }
                }
            }
        }
    }
    __syncthreads();

    // Pass 2, a warp owns 16 key rows: dk's and dv's rows, summed over the
    // query tiles inside this warp.
    for (int item = warp; item < nh * kKT; item += kMmaWarps) {
        const int hl = item / kKT;
        const int j0 = (item - hl * kKT) * 16;
        if (j0 >= L) continue;
        bf16* ks = smem + hl * kHeadStride + kSlab;
        bf16* vs = ks + kSlab;
        const uint32_t ks_at = shared_address(ks);
        const uint32_t qs_at = ks_at - kSlab * 2, vs_at = ks_at + kSlab * 2, gs_at = vs_at + kSlab * 2;
        const float* stat = stats + hl * 3 * kRows;

        // A = K, V (rows j, depth d) from their [j][d] rows: plain ldmatrix.
        uint32_t ka[kDK][4], va[kDK][4];
#pragma unroll
        for (int kk = 0; kk < kDK; ++kk) {
            const uint32_t at = ((j0 + a_row_of_lane(lane)) * kLd + kk * 16 + a_half_of_lane(lane) * 8) * 2;
            ldmatrix_x4(ka[kk], ks_at + at);
            ldmatrix_x4(va[kk], vs_at + at);
        }
        float dka[2 * kDK][4], dva[2 * kDK][4];
#pragma unroll
        for (int u = 0; u < 2 * kDK; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e) dka[u][e] = dva[u][e] = 0.0f;

        for (int it = 0; it < kKT && it * 16 < L; ++it) {
            // S^T = K . Q^T and dP^T = V . dO^T of query rows 16 it .. 16 it + 15:
            // B = Q^T, dO^T from their [i][d] rows, plain ldmatrix.
            float sT[2][4] = {}, dpT[2][4] = {};
#pragma unroll
            for (int kk = 0; kk < kDK; ++kk) {
                const uint32_t at = ((it * 16 + across * 8 + r8) * kLd + kk * 16 + down * 8) * 2;
                uint32_t b[4];
                ldmatrix_x4(b, qs_at + at);
                channel_step<kPairT<kDK>>(sT[0], ka[kk], b[0], b[1], kk, dh);
                channel_step<kPairT<kDK>>(sT[1], ka[kk], b[2], b[3], kk, dh);
                ldmatrix_x4(b, gs_at + at);
                channel_step<kPairT<kDK>>(dpT[0], va[kk], b[0], b[1], kk, dh);
                channel_step<kPairT<kDK>>(dpT[1], va[kk], b[2], b[3], kk, dh);
            }
            // p and ds of (key g or g + 8, query 16 it + 8 n + tc + c), then
            // round(P)^T and dS^T as A fragments (rows j, depth i).
            uint32_t pa[4], dsa[4];
#pragma unroll
            for (int n = 0; n < 2; ++n) {
                const int i = it * 16 + 8 * n + tc;
                const float2 m = *reinterpret_cast<const float2*>(stat + i);
                const float2 ri = *reinterpret_cast<const float2*>(stat + kRows + i);
                const float2 rw = *reinterpret_cast<const float2*>(stat + 2 * kRows + i);
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                    float p[2], ds[2];
#pragma unroll
                    for (int c = 0; c < 2; ++c) {
                        const float x = __fmul_rn(sT[n][2 * r + c], scale);
                        p[c] = __fmul_rn(expf(__fsub_rn(x, c ? m.y : m.x)), c ? ri.y : ri.x);
                        ds[c] = __fmul_rn(__fmul_rn(p[c], __fsub_rn(dpT[n][2 * r + c], c ? rw.y : rw.x)),
                                          scale);
                    }
                    pa[2 * n + r] = pack_bf16(p[0], p[1]);
                    dsa[2 * n + r] = pack_bf16(ds[0], ds[1]);
                }
            }
            // dV += round(P)^T . dO and dK += dS^T . Q: B = dO, Q (depth i,
            // columns d) from their [i][d] rows, ldmatrix.trans.
#pragma unroll
            for (int kk = 0; kk < kDK; ++kk) {
                const uint32_t at = ((it * 16 + down * 8 + r8) * kLd + kk * 16 + across * 8) * 2;
                uint32_t b[4];
                ldmatrix_x4_trans(b, gs_at + at);
                mma_bf16_16816(dva[2 * kk], pa, b[0], b[1]);
                mma_bf16_16816(dva[2 * kk + 1], pa, b[2], b[3]);
                ldmatrix_x4_trans(b, qs_at + at);
                mma_bf16_16816(dka[2 * kk], dsa, b[0], b[1]);
                mma_bf16_16816(dka[2 * kk + 1], dsa, b[2], b[3]);
            }
        }

        // dK's and dV's rows go over the warp's own rows of k and v (their A
        // fragments are already in registers), two channels a store.
#pragma unroll
        for (int u = 0; u < 2 * kDK; ++u) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                const int at = (j0 + g + 8 * r) * kLd + u * 8 + tc;
                *reinterpret_cast<uint32_t*>(ks + at) = pack_bf16(dka[u][2 * r], dka[u][2 * r + 1]);
                *reinterpret_cast<uint32_t*>(vs + at) = pack_bf16(dva[u][2 * r], dva[u][2 * r + 1]);
            }
        }
    }
    __syncthreads();
    switch (word_bytes) {
        case 16:
            store_packed<kKT, kDK, 16, 4>(dk, smem + kSlab, head0, nh, L, H, dh);
            store_packed<kKT, kDK, 16, 4>(dv, smem + 2 * kSlab, head0, nh, L, H, dh);
            break;
        case 8:
            store_packed<kKT, kDK, 8, 4>(dk, smem + kSlab, head0, nh, L, H, dh);
            store_packed<kKT, kDK, 8, 4>(dv, smem + 2 * kSlab, head0, nh, L, H, dh);
            break;
        case 4:
            store_packed<kKT, kDK, 4, 4>(dk, smem + kSlab, head0, nh, L, H, dh);
            store_packed<kKT, kDK, 4, 4>(dv, smem + 2 * kSlab, head0, nh, L, H, dh);
            break;
        default:
            store_packed<kKT, kDK, 2, 4>(dk, smem + kSlab, head0, nh, L, H, dh);
            store_packed<kKT, kDK, 2, 4>(dv, smem + 2 * kSlab, head0, nh, L, H, dh);
            break;
    }
}

template <int kKT, int kDK>
cudaError_t packed_bwd_mma_setup() {
    static bool done = false;
    return mma_setup(attn_packed_bwd_mma<kKT, kDK>, done);
}

template <int kKT, int kDK>
int packed_bwd_mma(const void* q, const void* k, const void* v, const void* g, void* dq, void* dk,
                   void* dv, int B, int L, int H, int dh, int heads, cudaStream_t stream) {
    const cudaError_t err = packed_bwd_mma_setup<kKT, kDK>();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int n_heads = B * H;
    const int blocks = static_cast<int>((static_cast<long long>(n_heads) + heads - 1) / heads);
    const void* const tensors[] = {q, k, v, g, dq, dk, dv};
    attn_packed_bwd_mma<kKT, kDK><<<blocks, kMmaWarps * 32,
                                    packed_bwd_mma_smem_bytes(L, dh, heads), stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(g), static_cast<bf16*>(dq), static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), n_heads, L, H, dh, heads, packed_word_bytes(tensors, dh),
        1.0f / sqrtf(static_cast<float>(dh)));
    return static_cast<int>(cudaGetLastError());
}

template <int kKT, int kDK>
int packed_bwd_mma_resources(int L, int dh, int heads, int* registers, int* local_bytes,
                             int* blocks_per_sm) {
    const cudaError_t err = packed_bwd_mma_setup<kKT, kDK>();
    if (err != cudaSuccess) return static_cast<int>(err);
    return mma_resources(attn_packed_bwd_mma<kKT, kDK>, packed_bwd_mma_smem_bytes(L, dh, heads),
                         registers, local_bytes, blocks_per_sm);
}

bool bwd_shape_ok(long long n_heads, int L, int dh, int heads) {
    return n_heads > 0 && n_heads <= 0x7fffffffLL && L >= 1 && L <= kMaxL && dh >= 1
           && dh <= kMaxDh && heads >= 1 && heads <= kMmaMaxHeads;
}

}  // namespace

// The packed backward on the tensor cores, bf16 only (is_bf16 = 1): `heads`
// consecutive heads a block (at most 4), four warps, a warp per 16 query
// rows of a head in pass 1 and per 16 key rows in pass 2.
extern "C" size_t attn_packed_bwd_mma_smem_bytes(int L, int dh, int heads) {
    return packed_bwd_mma_smem_bytes(L, dh, heads);
}

extern "C" int attn_packed_bwd_mma_launch(int is_bf16, const void* q, const void* k, const void* v,
                                          const void* g, void* dq, void* dk, void* dv, int B, int L,
                                          int H, int dh, int heads, void* stream) {
    if (B == 0) return 0;
    if (!is_bf16 || H < 1 || !bwd_shape_ok(static_cast<long long>(B) * H, L, dh, heads))
        return static_cast<int>(cudaErrorInvalidValue);
    return for_tiles(L, dh, [&](auto kt, auto dk_tiles) {
        return packed_bwd_mma<decltype(kt)::value, decltype(dk_tiles)::value>(
            q, k, v, g, dq, dk, dv, B, L, H, dh, heads, static_cast<cudaStream_t>(stream));
    });
}

extern "C" int attn_packed_bwd_mma_resources(int L, int dh, int heads, int* registers,
                                             int* local_bytes, int* blocks_per_sm) {
    if (!bwd_shape_ok(1, L, dh, heads)) return static_cast<int>(cudaErrorInvalidValue);
    return for_tiles(L, dh, [&](auto kt, auto dk_tiles) {
        return packed_bwd_mma_resources<decltype(kt)::value, decltype(dk_tiles)::value>(
            L, dh, heads, registers, local_bytes, blocks_per_sm);
    });
}
