// What the bf16 tensor-core attention kernels share (attention.cu: K3's
// attn_folded_fwd_mma and K8's attn_packed_fwd_mma; attention_bwd.cu: K9's
// attn_packed_bwd_mma; attention_board.cu: K5's attn_lane_slice_fwd_mma and
// K6's attn_infold_fwd_mma): the padded sizes they are compiled for, the
// products of S and dP summed in f32 past the first (mma_chained), the
// softmax of a warp's score fragments and the probability fragment built from it,
// the cp.async staging of packed heads into [token][channel] slabs and the
// way back out, and the per-instantiation set-up and resource query.

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
