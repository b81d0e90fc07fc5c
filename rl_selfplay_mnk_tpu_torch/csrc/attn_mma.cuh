// What the bf16 tensor-core attention kernels share (attention.cu: K3's
// attn_folded_fwd_mma and K8's attn_packed_fwd_mma; attention_bwd.cu: K9's
// attn_packed_bwd_mma; attention_folded_bwd.cu: K4's attn_folded_bwd_mma;
// attention_board.cu: K5's attn_lane_slice_fwd_mma, K6's attn_infold_fwd_mma
// and K7's attn_infold_bwd_mma): the padded sizes they are compiled for, the
// products of S and dP summed in f32 past the first (mma_chained), the
// softmax of a warp's score fragments and the probability fragment built from it,
// the cp.async staging of packed heads into [token][channel] slabs and the
// way back out, the span staging of folded heads into [channel][token]
// slabs, the backward's two passes on [channel][token] slabs (K4, K7), and
// the per-instantiation set-up and resource query.

#pragma once

#include "attn_common.cuh"
#include "mma_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMmaWarps = 4;       // warps of a block of a tensor-core kernel
constexpr int kMmaMaxHeads = 4;    // heads a block of it takes at most

// The kernels are compiled for these counts of 16-token tiles and 16-channel
// tiles; a head is padded with zeros up to the next one.
__host__ __device__ inline int key_tiles(int L) {
    const int kt = (L + 15) / 16;
    return kt <= 4 ? kt : kt <= 6 ? 6 : kt <= 8 ? 8 : kt <= 11 ? 11 : 12;
}
__host__ __device__ inline int channel_tiles(int dh) {
    const int dk = (dh + 15) / 16;
    return dk <= 2 ? dk : 4;
}

// The instantiation of a tensor-core kernel for a head of L tokens and dh
// channels: f(Tiles<key_tiles(L)>{}, Tiles<channel_tiles(dh)>{}).
template <int N>
struct Tiles {
    static constexpr int value = N;
};

template <int kKT, typename F>
int for_channel_tiles(int dh, const F& f) {
    switch (channel_tiles(dh)) {
        case 1: return f(Tiles<kKT>{}, Tiles<1>{});
        case 2: return f(Tiles<kKT>{}, Tiles<2>{});
        default: return f(Tiles<kKT>{}, Tiles<4>{});
    }
}

template <typename F>
int for_tiles(int L, int dh, const F& f) {
    switch (key_tiles(L)) {
        case 1: return for_channel_tiles<1>(dh, f);
        case 2: return for_channel_tiles<2>(dh, f);
        case 3: return for_channel_tiles<3>(dh, f);
        case 4: return for_channel_tiles<4>(dh, f);
        case 6: return for_channel_tiles<6>(dh, f);
        case 8: return for_channel_tiles<8>(dh, f);
        case 11: return for_channel_tiles<11>(dh, f);
        default: return for_channel_tiles<12>(dh, f);
    }
}

// d += a . b for S and dP, whose f32 values set where p and ds round to
// bf16. The tensor cores add a product into their accumulator rounding toward
// zero, so chained over the channel tiles they pull every score and dp a
// little toward zero, and p and ds round on another side of a bf16 step than
// the plain version's f32 sums several times as often as an FMA sum does.
// So each 16-deep product past the first (kk > 0) is summed apart and added
// in f32, rounding to nearest.
__device__ __forceinline__ void mma_chained(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                            uint32_t b1, int kk) {
    if (kk == 0) {
        mma_bf16_16816(d, a, b0, b1);
        return;
    }
    float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    mma_bf16_16816(t, a, b0, b1);
#pragma unroll
    for (int e = 0; e < 4; ++e) d[e] += t[e];
}

// Softmax of a warp's 16 query rows, whose scores s are the C fragments of
// S = Q . K^T over kNT 8-key tiles: rows g (s[.][0..1]) and g + 8 (s[.][2..3]).
// In f32 with the arithmetic of softmax_rows: x = s * scale, key columns past
// the board get x = -inf (p = 0; the lane's column 8j + tc + c is a token iff
// 8j + c < live_cols = L - tc), s becomes exp(x - max) in place, mx the max
// and rinv 1 / sum of each of the lane's two rows. Max and sum go by quad
// shuffles.
template <int kNT>
__device__ __forceinline__ void softmax_fragments(float (&s)[kNT][4], int live_cols, float scale,
                                                  float (&mx)[2], float (&rinv)[2]) {
    mx[0] = mx[1] = -INFINITY;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            s[j][e] = j * 8 + (e & 1) < live_cols ? __fmul_rn(s[j][e], scale) : -INFINITY;
            mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
    }
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            s[j][e] = expf(__fsub_rn(s[j][e], mx[e >> 1]));
            sum[e >> 1] += s[j][e];
        }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(kFull, sum[r], 1);
        sum[r] += __shfl_xor_sync(kFull, sum[r], 2);
        rinv[r] = __frcp_rn(sum[r]);
    }
}

// p = exp(x - max) * (1 / sum) of keys 16 jt .. 16 jt + 15, rounded to bf16,
// as the A fragment of O = P . V, straight from softmax_fragments' registers.
template <int kNT>
__device__ __forceinline__ void probability_fragment(uint32_t (&pa)[4], const float (&s)[kNT][4],
                                                     int jt, const float (&rinv)[2]) {
    const int lo = 2 * jt, hi = 2 * jt + 1;
    pa[0] = pack_bf16(__fmul_rn(s[lo][0], rinv[0]), __fmul_rn(s[lo][1], rinv[0]));
    pa[1] = pack_bf16(__fmul_rn(s[lo][2], rinv[1]), __fmul_rn(s[lo][3], rinv[1]));
    pa[2] = pack_bf16(__fmul_rn(s[hi][0], rinv[0]), __fmul_rn(s[hi][1], rinv[0]));
    pa[3] = pack_bf16(__fmul_rn(s[hi][2], rinv[1]), __fmul_rn(s[hi][3], rinv[1]));
}

// ---------------------------------------------------------------------------
// Packed heads <-> [token][channel] shared slabs
// ---------------------------------------------------------------------------
//
// A packed head is L rows of Dh contiguous values at a stride of D = H Dh.
// Its slab is bf16 [16 key_tiles(L)][ld], ld = 16 channel_tiles(Dh) + 8 (an
// odd number of 16-byte words), zero outside [L][Dh]; a head's kN slabs (one
// a tensor) lie one after another. A head row goes into its slab row by
// cp.async in the widest word (16, 8 or 4 bytes) that divides its 2 Dh bytes
// and the tensors' addresses, so a thread's copies are all in flight at once
// and nothing is scattered; only an odd Dh takes element copies.

template <int kBytes> struct WordOf;
template <> struct WordOf<16> { using type = uint4; };
template <> struct WordOf<8> { using type = uint2; };
template <> struct WordOf<4> { using type = uint32_t; };
template <> struct WordOf<2> { using type = uint16_t; };

// The widest word, 16 bytes at most, that divides a head row's 2 Dh bytes
// and every tensor's address: each head row then starts on a word.
template <int kN>
int packed_word_bytes(const void* const (&tensors)[kN], int dh) {
    uintptr_t all = static_cast<uintptr_t>(2 * dh);
    for (const void* t : tensors) all |= reinterpret_cast<uintptr_t>(t);
    int bytes = 16;
    while (bytes > 2 && (all & (bytes - 1)) != 0) bytes >>= 1;
    return bytes;
}

// Element offset of head n's row 0 in a packed tensor.
__device__ __forceinline__ size_t packed_head_base(int n, int L, int H, int dh) {
    const int b = n / H;
    return static_cast<size_t>(b) * L * H * dh + static_cast<size_t>(n - b * H) * dh;
}

// The block's nh heads of the kN tensors in src -> their shared slabs, in
// words of kBytes. A slab row's 16 kDK channels are a power of two of words
// that divides the block's threads, so a thread keeps one word column and
// walks the rows. Rows >= L and words past the head's Dh channels are
// zeroed. The copies stay in flight until the caller's cp_async_wait_all.
template <int kKT, int kDK, int kBytes, int kN>
__device__ __forceinline__ void stage_packed(const bf16* const (&src)[kN], bf16* smem, int head0,
                                             int nh, int L, int H, int dh) {
    using Word = typename WordOf<kBytes>::type;
    constexpr int kLd = 16 * kDK + 8, kSlab = 16 * kKT * kLd;
    constexpr int kWords = 32 * kDK / kBytes, kElems = kBytes / 2;
    constexpr int kRowStep = kMmaWarps * 32 / kWords;
    const int w = threadIdx.x % kWords, live = 2 * dh / kBytes;
    const size_t D = static_cast<size_t>(H) * dh;
    for (int hl = 0; hl < nh; ++hl) {
        const size_t base = packed_head_base(head0 + hl, L, H, dh) + w * kElems;
#pragma unroll
        for (int t = 0; t < kN; ++t) {
            const bf16* from = src[t] + base;
            bf16* to = smem + (kN * hl + t) * kSlab + w * kElems;
            for (int l = threadIdx.x / kWords; l < 16 * kKT; l += kRowStep) {
                bf16* at = to + l * kLd;
                if (l < L && w < live) {
                    if constexpr (kBytes == 16) cp_async_16(shared_address(at), from + l * D);
                    else if constexpr (kBytes == 2) *at = from[l * D];
                    else cp_async_small<kBytes>(shared_address(at), from + l * D);
                } else {
                    *reinterpret_cast<Word*>(at) = Word{};
                }
            }
        }
    }
}

// Rows [0, L) of one slab of each of the block's heads out to the packed
// tensor o: `slab` is head 0's slab, the next head's is kN slabs further.
template <int kKT, int kDK, int kBytes, int kN>
__device__ __forceinline__ void store_packed(bf16* __restrict__ o, const bf16* slab, int head0,
                                             int nh, int L, int H, int dh) {
    using Word = typename WordOf<kBytes>::type;
    constexpr int kLd = 16 * kDK + 8, kSlab = 16 * kKT * kLd;
    constexpr int kWords = 32 * kDK / kBytes, kElems = kBytes / 2;
    constexpr int kRowStep = kMmaWarps * 32 / kWords;
    const int w = threadIdx.x % kWords;
    if (w >= 2 * dh / kBytes) return;
    const size_t D = static_cast<size_t>(H) * dh;
    for (int hl = 0; hl < nh; ++hl) {
        bf16* to = o + packed_head_base(head0 + hl, L, H, dh) + w * kElems;
        const bf16* from = slab + kN * hl * kSlab + w * kElems;
        for (int l = threadIdx.x / kWords; l < L; l += kRowStep)
            *reinterpret_cast<Word*>(to + l * D) = *reinterpret_cast<const Word*>(from + l * kLd);
    }
}

// ---------------------------------------------------------------------------
// Folded heads: (Dh, L) spans <-> [channel][token] shared slabs (K3, K4)
// ---------------------------------------------------------------------------

// Where element e of a span of consecutive heads' (Dh, L) slabs sits in the
// heads' [dpad][ld] shared slabs, without a branch.
struct SlabMap {
    FastDiv per_head, per_row;  // by Dh * L, by L
    int head_stride, ld;
    __device__ __forceinline__ int operator()(uint32_t e) const {
        const uint32_t h = per_head(e), r = e - h * per_head.d;
        const uint32_t d = per_row(r);
        return h * head_stride + d * ld + (r - d * per_row.d);
    }
};

// Device span (n elements) <-> the heads' shared slabs. 16-byte accesses
// where the span is aligned, single elements at its two ends; a thread
// starts kChunksInFlight loads before it scatters the first.
constexpr int kChunksInFlight = 4;

template <bool kLoad>
__device__ __forceinline__ void move_span(bf16* __restrict__ dev, bf16* smem, int n, SlabMap at) {
    const int misalign = static_cast<int>((reinterpret_cast<uintptr_t>(dev) & 15) / sizeof(bf16));
    const int lead = min(n, (8 - misalign) & 7);
    const int chunks = (n - lead) / 8;
    const int tail = lead + 8 * chunks;
    for (int e = threadIdx.x; e < lead + (n - tail); e += blockDim.x) {
        const int i = e < lead ? e : tail + (e - lead);
        if (kLoad) smem[at(i)] = dev[i];
        else dev[i] = smem[at(i)];
    }
    uint4* dev_chunks = reinterpret_cast<uint4*>(dev + lead);
    for (int c0 = threadIdx.x; c0 < chunks; c0 += kChunksInFlight * blockDim.x) {
        uint4 raw[kChunksInFlight];
        if (kLoad) {
#pragma unroll
            for (int u = 0; u < kChunksInFlight; ++u) {
                const int c = c0 + u * blockDim.x;
                if (c < chunks) raw[u] = dev_chunks[c];
            }
        }
#pragma unroll
        for (int u = 0; u < kChunksInFlight; ++u) {
            const int c = c0 + u * blockDim.x;
            if (c < chunks) {
                bf16* v = reinterpret_cast<bf16*>(&raw[u]);
#pragma unroll
                for (int e = 0; e < 8; ++e) {
                    const int s = at(lead + 8 * c + e);
                    if (kLoad) smem[s] = v[e];
                    else v[e] = smem[s];
                }
                if (!kLoad) dev_chunks[c] = raw[u];
            }
        }
    }
}

// ---------------------------------------------------------------------------
// The backward on [channel][token] slabs (K4's and K7's bf16 paths)
// ---------------------------------------------------------------------------
//
// K9's two passes (attention_bwd.cu) on K3's folded layout. A head's q, k,
// v and dO are bf16 slabs of a row per channel, [d][token], with a row
// stride of 16 kKT + 8 (an odd number of 16-byte words: ldmatrix without
// bank conflicts), zero at the tokens >= L. The passes are K9's; what
// changes is where each fragment comes from:
//
//   A, depth the channels (Q, dO in pass 1; K, V in pass 2): ldmatrix.trans,
//       the depth past Dh zeroed in registers (within);
//   B, depth the channels (K^T, V^T in pass 1; Q^T, dO^T in pass 2):
//       ldmatrix.trans;
//   B, depth the tokens (K in dQ = dS K; dO in dV, Q in dK): plain ldmatrix.
//
// The gradients leave the tensor cores as (token, channel) fragments, and
// each kernel takes them through its own functor: K4 into [channel][token]
// slabs, K7 into the board's row-major rows. A head's channel rows are read
// up to FoldHead::last at most: K7's heads lie side by side in one slab and
// there is no row past the block's last head. Rows read past a head's Dh
// meet zeroed depth, or give output channels that are not stored.
//
// Padding: key columns >= L get p = 0 in pass 1; query rows >= L (q and dO
// zero) give dP = 0 and row = 0, so their dS is 0 and their round(P) meets
// zero rows of dO: they add nothing in pass 2. Rows >= L of either pass are
// computed and never stored.
//
// Precision. dQ, dK and dV add each 16-deep step over the tokens past the
// first in f32, rounding to nearest (mma_chained; 6 steps at 9x9, 11 at
// 13x13). Pass 2's S^T and dP^T, whose p and ds round to bf16 for dv and dk,
// are summed over the channels a depth pair at a time (mma_pairs: the
// m16n8k8 product of two channels, each added in f32 in the order of the
// channels), close to the plain version's sequential f32 sum. As one 16-deep
// product, whose sum the tensor cores truncate, they put K7's dv at the 9x9
// update's minibatch at 1.01 of chip_smoke.py's bf16 limit on an H100
// (utils/attn_bwd_study.py --numerics gives the share as built). Pass 1's S
// and dP (the row statistics, dq's ds) stay one product a 16-deep step:
// paired too, they cost as much time again as pass 2's pairs and did not
// move dq's worst share past the spread of its inputs. (K9 pairs pass 1's S
// where Dh <= 16: attention_bwd.cu says why.)

// A b16x2 fragment register with its depth (channel) pair starting at c:
// the halves at or past dh zeroed.
__device__ __forceinline__ uint32_t within(uint32_t r, int c, int dh) {
    return c + 1 < dh ? r : c < dh ? (r & 0xffffu) : 0u;
}

// Registers a thread of the instantiation is expected to need at its peak
// (pass 1's S and dP, dQ's sums, addresses), and from that the blocks an SM
// is asked to hold: 4 (128 registers a thread), 3 (168) or 2 (255). The
// [channel][token] backward (K4, K7) also holds the clamped channel rows and
// the zeroed depth: at Dh > 16 ptxas (CUDA 12.8, sm_90a) spilled with K9's
// count from two key tiles on at kDK = 4 and from eight at kDK = 2, so it
// asks for two blocks there.
template <int kKT, int kDK>
constexpr int kBwdMinBlocks = 16 * kKT + 8 * kDK + 16 <= 88 ? 4
                              : 16 * kKT + 8 * kDK + 16 <= 160 ? 3 : 2;
template <int kKT, int kDK>
constexpr int kFoldBwdMinBlocks =
    (kDK == 4 && kKT >= 2) || (kDK == 2 && kKT >= 8) ? 2 : kBwdMinBlocks<kKT, kDK>;


// A head's four slabs (shared addresses of channel 0's row of q, k, v and
// dO) and the last channel row that may be read.
struct FoldHead {
    uint32_t q, k, v, g;
    int last;
    // Byte address of (channel d, token t) in the slab at `slab`.
    template <int kLd>
    __device__ __forceinline__ uint32_t at(uint32_t slab, int d, int t) const {
        return slab + (min(d, last) * kLd + t) * 2;
    }
};

// The A fragments of the tokens t0 .. t0 + 15 (rows) with the channels as
// depth, from the [d][token] slab at `slab`: ldmatrix.trans, the depth past
// dh zeroed.
template <int kKT, int kDK>
__device__ __forceinline__ void channel_depth_a(uint32_t (&a)[kDK][4], const FoldHead& hd,
                                                uint32_t slab, int t0, int dh, int lane) {
    constexpr int kLd = 16 * kKT + 8;
    const int r8 = lane & 7, down = (lane >> 3) & 1, across = lane >> 4, tc = frag_col(lane);
#pragma unroll
    for (int kk = 0; kk < kDK; ++kk) {
        ldmatrix_x4_trans(a[kk], hd.at<kLd>(slab, kk * 16 + across * 8 + r8, t0 + down * 8));
        const int c = 16 * kk + tc;
        a[kk][0] = within(a[kk][0], c, dh);
        a[kk][1] = within(a[kk][1], c, dh);
        a[kk][2] = within(a[kk][2], c + 8, dh);
        a[kk][3] = within(a[kk][3], c + 8, dh);
    }
}

// d (+)= a . b over the 16 channels c0 .. c0 + 15 a depth pair at a time:
// the m16n8k8 product of channels c0 + 2 pair, + 1 (the other lanes' depth
// zeroed), added in f32 in the order of the channels. Pairs at or past dh
// are zero and skipped. `first`: d holds no sum yet.
__device__ __forceinline__ void mma_pairs(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1, int c0, int dh, bool first) {
    const int t = threadIdx.x & 3;  // the lane's depth pair within each half
#pragma unroll
    for (int pair = 0; pair < 8; ++pair) {
        if (c0 + 2 * pair >= dh) break;
        const bool mine = t == (pair & 3);
        const uint32_t a_lo = pair < 4 ? a[0] : a[2], a_hi = pair < 4 ? a[1] : a[3];
        float u[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_bf16_1688(u, mine ? a_lo : 0u, mine ? a_hi : 0u, pair < 4 ? b0 : b1);
#pragma unroll
        for (int e = 0; e < 4; ++e) d[e] = first && pair == 0 ? u[e] : __fadd_rn(d[e], u[e]);
    }
}

// acc = A . B^T over the channels, B the tokens t0 .. t0 + 16 kTiles - 1 of
// the [d][token] slab at `slab` (ldmatrix.trans), 8 tokens a C fragment:
// summed a depth pair at a time (mma_pairs) or a 16-deep step at a time
// (mma_chained).
template <int kKT, int kDK, int kTiles, bool kPairs>
__device__ __forceinline__ void channel_scores(float (&acc)[2 * kTiles][4],
                                               const uint32_t (&a)[kDK][4], const FoldHead& hd,
                                               uint32_t slab, int t0, int dh, int lane) {
    constexpr int kLd = 16 * kKT + 8;
    const int r8 = lane & 7, down = (lane >> 3) & 1, across = lane >> 4;
#pragma unroll
    for (int j = 0; j < 2 * kTiles; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
#pragma unroll
    for (int jt = 0; jt < kTiles; ++jt) {
#pragma unroll
        for (int kk = 0; kk < kDK; ++kk) {
            uint32_t b[4];
            ldmatrix_x4_trans(b, hd.at<kLd>(slab, kk * 16 + down * 8 + r8,
                                            t0 + jt * 16 + across * 8));
            if constexpr (kPairs) {
                mma_pairs(acc[2 * jt], a[kk], b[0], b[1], 16 * kk, dh, kk == 0);
                mma_pairs(acc[2 * jt + 1], a[kk], b[2], b[3], 16 * kk, dh, kk == 0);
            } else {
                mma_chained(acc[2 * jt], a[kk], b[0], b[1], kk);
                mma_chained(acc[2 * jt + 1], a[kk], b[2], b[3], kk);
            }
        }
    }
}

// acc += A . B, B with the tokens t0 .. t0 + 15 as depth and the channels as
// columns, from the [d][token] slab at `slab`: plain ldmatrix, 8 channels a
// C fragment. `step` counts the 16-deep products of acc's sum: past the
// first (step > 0) each is added in f32 (mma_chained).
template <int kKT, int kDK>
__device__ __forceinline__ void token_depth_product(float (&acc)[2 * kDK][4],
                                                    const uint32_t (&a)[4], const FoldHead& hd,
                                                    uint32_t slab, int t0, int step, int lane) {
    constexpr int kLd = 16 * kKT + 8;
    const int r8 = lane & 7, down = (lane >> 3) & 1, across = lane >> 4;
#pragma unroll
    for (int kk = 0; kk < kDK; ++kk) {
        uint32_t b[4];
        ldmatrix_x4(b, hd.at<kLd>(slab, kk * 16 + across * 8 + r8, t0 + down * 8));
        mma_chained(acc[2 * kk], a, b[0], b[1], step);
        mma_chained(acc[2 * kk + 1], a, b[2], b[3], step);
    }
}

// Pass 1 for one warp: query rows i0 .. i0 + 15 of one head. S = Q K^T and
// dP = dO V^T are held in registers; softmax_fragments turns S into
// exp(x - max) and gives max and 1 / sum; row = sum_j dP p is taken over
// p = exp(x - max) * (1 / sum) in f32; the rows' max, 1 / sum and row go to
// stat ([3][16 kKT]); dS is rounded to bf16 straight into the A fragments of
// dQ = dS K, which frees S and dP before dQ's sums come alive. dQ's C
// fragments (rows i0 + g, + 8; channels 8u + tc, + 1) go to put_dq.
template <int kKT, int kDK, typename PutDq>
__device__ __forceinline__ void fold_bwd_query_rows(const FoldHead& hd, float* stat, int i0, int L,
                                                    int dh, float scale, const PutDq& put_dq) {
    constexpr int kTokens = 16 * kKT;
    const int lane = threadIdx.x & 31;
    const int g = frag_row(lane), tc = frag_col(lane);
    float s[2 * kKT][4];
    {
        uint32_t qa[kDK][4];
        channel_depth_a<kKT, kDK>(qa, hd, hd.q, i0, dh, lane);
        channel_scores<kKT, kDK, kKT, false>(s, qa, hd, hd.k, 0, dh, lane);
    }
    float mx[2], rinv[2];
    softmax_fragments(s, L - tc, scale, mx, rinv);  // s = exp(x - max)
    float dp[2 * kKT][4];
    {
        uint32_t ga[kDK][4];
        channel_depth_a<kKT, kDK>(ga, hd, hd.g, i0, dh, lane);
        channel_scores<kKT, kDK, kKT, false>(dp, ga, hd, hd.v, 0, dh, lane);
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
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            stat[i0 + g + 8 * r] = mx[r];
            stat[kTokens + i0 + g + 8 * r] = rinv[r];
            stat[2 * kTokens + i0 + g + 8 * r] = row[r];
        }
    }

    // ds = round(p * (dp - row) * scale) of keys 16 jt .. 16 jt + 15 as the
    // A fragment of dQ = dS . K (fragment map of probability_fragment).
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

    // dQ = dS . K: B = K (depth j, columns d) from k's [d][j] rows.
    float dqa[2 * kDK][4];
#pragma unroll
    for (int u = 0; u < 2 * kDK; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) dqa[u][e] = 0.0f;
#pragma unroll
    for (int jt = 0; jt < kKT; ++jt)
        token_depth_product<kKT, kDK>(dqa, dsa[jt], hd, hd.k, 16 * jt, jt, lane);
    put_dq(dqa);
}

// Pass 2 for one warp: key rows j0 .. j0 + 15 of one head, streaming over
// the query tiles. S^T = K Q^T and dP^T = V dO^T a 16 x 16 tile at a time
// (K, V as A from registers), a depth pair at a time; p = exp(x - max) * (1 / sum) from the stored
// statistics with softmax_fragments' arithmetic; round(P)^T and dS^T become
// A fragments for dV += round(P)^T dO and dK += dS^T Q. dK and dV are summed
// in registers over the query tiles, in one order, inside one warp: no
// atomics, the same bits every run. Their C fragments (rows j0 + g, + 8;
// channels 8u + tc, + 1) go to put(dk, dv).
template <int kKT, int kDK, typename Put>
__device__ __forceinline__ void fold_bwd_key_rows(const FoldHead& hd, const float* stat, int j0,
                                                  int L, int dh, float scale, const Put& put) {
    constexpr int kTokens = 16 * kKT;
    const int lane = threadIdx.x & 31, tc = frag_col(lane);
    uint32_t ka[kDK][4], va[kDK][4];
    channel_depth_a<kKT, kDK>(ka, hd, hd.k, j0, dh, lane);
    channel_depth_a<kKT, kDK>(va, hd, hd.v, j0, dh, lane);
    float dka[2 * kDK][4], dva[2 * kDK][4];
#pragma unroll
    for (int u = 0; u < 2 * kDK; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) dka[u][e] = dva[u][e] = 0.0f;

    for (int it = 0; it < kKT && it * 16 < L; ++it) {
        float sT[2][4], dpT[2][4];
        channel_scores<kKT, kDK, 1, true>(sT, ka, hd, hd.q, it * 16, dh, lane);
        channel_scores<kKT, kDK, 1, true>(dpT, va, hd, hd.g, it * 16, dh, lane);
        // p and ds of (key g or g + 8, query 16 it + 8 n + tc + c), then
        // round(P)^T and dS^T as A fragments (rows j, depth i).
        uint32_t pa[4], dsa[4];
#pragma unroll
        for (int n = 0; n < 2; ++n) {
            const int i = it * 16 + 8 * n + tc;
            const float2 m = *reinterpret_cast<const float2*>(stat + i);
            const float2 ri = *reinterpret_cast<const float2*>(stat + kTokens + i);
            const float2 rw = *reinterpret_cast<const float2*>(stat + 2 * kTokens + i);
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
        // columns d) from their [d][i] rows.
        token_depth_product<kKT, kDK>(dva, pa, hd, hd.g, it * 16, it, lane);
        token_depth_product<kKT, kDK>(dka, dsa, hd, hd.q, it * 16, it, lane);
    }
    put(dka, dva);
}

// Both passes over a block's nh heads, a warp per (head, 16-row tile) item
// and a barrier between them: head(hl) gives head hl's FoldHead, stats holds
// [head][3][16 kKT] floats, put_dq(hl, i0, dq) and put_dkdv(hl, j0, dk, dv)
// take the C fragments of rows i0 (j0) .. + 15 of head hl. Tiles of padding
// only are skipped.
template <int kKT, int kDK, typename Head, typename PutDq, typename PutDkDv>
__device__ __forceinline__ void fold_bwd_passes(int nh, int L, int dh, float scale, float* stats,
                                                const Head& head, const PutDq& put_dq,
                                                const PutDkDv& put_dkdv) {
    using Frags = float[2 * kDK][4];
    const int warp = threadIdx.x >> 5;
    for (int item = warp; item < nh * kKT; item += kMmaWarps) {
        const int hl = item / kKT;
        const int i0 = (item - hl * kKT) * 16;
        if (i0 >= L) continue;
        fold_bwd_query_rows<kKT, kDK>(head(hl), stats + hl * 3 * 16 * kKT, i0, L, dh, scale,
                                      [&](const Frags& dqa) { put_dq(hl, i0, dqa); });
    }
    __syncthreads();
    for (int item = warp; item < nh * kKT; item += kMmaWarps) {
        const int hl = item / kKT;
        const int j0 = (item - hl * kKT) * 16;
        if (j0 >= L) continue;
        fold_bwd_key_rows<kKT, kDK>(
            head(hl), stats + hl * 3 * 16 * kKT, j0, L, dh, scale,
            [&](const Frags& dka, const Frags& dva) { put_dkdv(hl, j0, dka, dva); });
    }
}

// ---------------------------------------------------------------------------
// Per instantiation, on the host
// ---------------------------------------------------------------------------

// Once per kernel (the caller keeps `done`): the card's whole per-block
// shared memory, and the largest shared-memory carveout, so that as many
// blocks share an SM as fit.
template <typename Kernel>
cudaError_t mma_setup(Kernel kernel, bool& done) {
    if (done) return cudaSuccess;
    bool allowed = false;
    cudaError_t err = allow_large_smem(kernel, allowed);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                   cudaSharedmemCarveoutMaxShared);
    done = err == cudaSuccess;
    return err;
}

// Registers and local memory (spills) a thread of the kernel takes, and how
// many of its blocks, each with smem_bytes of shared memory, fit an SM.
template <typename Kernel>
int mma_resources(Kernel kernel, size_t smem_bytes, int* registers, int* local_bytes,
                  int* blocks_per_sm) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, kMmaWarps * 32,
                                                            smem_bytes);
    if (err == cudaSuccess) {
        *registers = attr.numRegs;
        *local_bytes = static_cast<int>(attr.localSizeBytes);
    }
    return static_cast<int>(err);
}

}  // namespace
