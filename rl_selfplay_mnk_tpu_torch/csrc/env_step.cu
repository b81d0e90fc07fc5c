// Fused MNK env step for Hopper (sm_90a): stone placement, K-in-a-row win
// check, draw/done/reward, player toggle and the next action mask, in one
// kernel.
//
// Replaces the TPU kernel rl_selfplay_mnk_tpu/ops/pallas_env.py
// (_step_kernel, entry fused_step). That kernel counts the mover's stones on
// every line as a (E, MN) @ (MN, L) product with the line-incidence matrix on
// the MXU, a win where a count exceeds k - 0.5. Every line is tested, not
// only the lines through the placed cell, so the result is the same when
// play goes on past a win.
//
// Bound: bytes. An env reads 2*MN floats and four scalars and writes 2*MN
// floats, four scalars and MN mask bytes (1.4 KB at 9x9, 2.9 KB at 13x13),
// and reads nothing else. At bench.py's 8192 envs on 9x9 a call moves
// 11.5 MB, about 3.4 us at the card's 3.35 TB/s; at the main path's 384 envs
// (0.54 MB) and a tournament half-pairing's 16 the call is one memory round
// trip and its launch, whatever the bytes.
//
// Design. A warp takes an env and four warps make a block, so 8192 envs are
// 2048 blocks. A thread needs 40 registers, so an SM holds 12 blocks, and
// 8192 envs run as 1.3 waves of 6,336 over the 132 SMs: capped at 32
// registers, for 16 blocks an SM and all 8192 at once, the kernel spilled
// 48 bytes a thread and took 0.0066 ms a call at 8192 envs against 0.0061
// (NVIDIA H100 80GB HBM3, 700 W). Nothing is staged in shared memory and no
// __syncthreads is needed:
//
//   1. The lanes stride the cells: each 32-cell chunk of either plane is one
//      coalesced 128-byte load and store, the mask a 32-byte store. Three
//      chunks are loaded before any is used (9x9 in one round trip, 13x13 in
//      two). The scalars of the env are loaded in the same round trip.
//   2. The mover's plane becomes ballot words: chunk j's word, bit i set
//      where cell 32 j + i holds a mover stone, is kept by lane j.
//   3. Lane r takes row r of the board (two shuffles and a funnel shift out
//      of those words), and with k - 1 shuffles down from the rows below it
//      tests every run of k from the row's cells in the four directions,
//      shift-and-AND in registers: no line table, no dependent loads. One
//      vote gives the env's win.
//
// That is exact where every mover value after the placement is 0 or 1: a
// line's count is then the number of its stones. Any other value (an
// occupied cell played again becomes 2, a plane may hold anything the
// caller put there) is found by a second ballot, and that env takes an
// exact path in the kernel: each lane sums the float mover values of the
// lines starting at its cells, from the input in device memory, in the cell
// order of each line, with the product's infinities and NaN (a non-finite
// value off a line makes its count NaN: x * 0 over the matrix's zeros).
// Every env of a board wider or taller than 32 cells, whose rows do not fit
// a word, or with k > 32 (no line then) takes the exact path too. Its sums
// are the product's wherever they are exact in f32 (counts of stones, small
// integers, halves); the product's own order is not specified.
//
// The C entry returns cudaGetLastError() after the launch; the Python
// wrapper (ops/env_step.py) raises when it is not 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;  // an env a warp
constexpr int kBlocksPerSm = 12;   // 40 registers a thread (design note)
constexpr int kChunksInFlight = 3; // 32-cell chunks of each plane loaded before use
constexpr unsigned kFull = 0xffffffffu;

struct Board {
    int m, n, k, mn;
    int words;  // 32-cell chunks of a plane
    bool bits;  // rows fit a word and a lane each, runs a shift: the ballot path may be taken
};

// The placement and the mover value of one cell, with the arithmetic of
// fused_step_reference: b + onehot * is_black, w + onehot * (1 - is_black),
// mover = b * is_black + w * (1 - is_black), where onehot is 1 at the
// action's cell of an active env (no cell for an action off the board).
struct Move {
    int cell;        // the cell a stone goes on, or -1
    float is_black;  // 1 where player 0 moves

    __device__ __forceinline__ float black(float b, int c) const {
        return __fadd_rn(b, c == cell ? is_black : 0.0f);
    }
    __device__ __forceinline__ float white(float w, int c) const {
        return __fadd_rn(w, c == cell ? 1.0f - is_black : 0.0f);
    }
    __device__ __forceinline__ float mover(float b2, float w2) const {
        return __fadd_rn(__fmul_rn(b2, is_black), __fmul_rn(w2, 1.0f - is_black));
    }
};

// The exact path: the count of every line of the board, each line once,
// from the lines starting at the lane's cells (line_cells' four directions),
// as the product gives it: sum_c mover[c] * incidence[c][line] over all
// cells. Where every non-finite mover value lies on the line, the terms off
// it are zeros and the count is the float sum of the line's values (+inf
// through a +inf, NaN through a NaN or through both infinities); a
// non-finite value off the line makes the count NaN (x * 0). True where
// some line's count exceeds k - 0.5.
__device__ bool exact_win(const float* __restrict__ in, const Move& mv, const Board& bd, int lane) {
    const auto value = [&](int c) {
        return mv.mover(mv.black(__ldg(in + c), c), mv.white(__ldg(in + bd.mn + c), c));
    };
    int odd = 0;
    for (int c = lane; c < bd.mn; c += 32) odd += !isfinite(value(c));
    const int non_finite = __reduce_add_sync(kFull, odd);
    const float thresh = static_cast<float>(bd.k) - 0.5f;
    bool win = false;
    const auto line = [&](int c, int step) {
        float count = 0.0f;
        int on_line = 0;
        for (int i = 0; i < bd.k; ++i) {
            const float v = value(c + i * step);
            count = __fadd_rn(count, v);
            on_line += !isfinite(v);
        }
        return on_line == non_finite && count > thresh;
    };
    for (int c = lane; c < bd.mn; c += 32) {
        const int r = c / bd.n, col = c - r * bd.n;
        const bool across = col + bd.k <= bd.n, down = r + bd.k <= bd.m;
        if (across) win |= line(c, 1);
        if (down) win |= line(c, bd.n);
        if (down && across) win |= line(c, bd.n + 1);
        if (down && col - bd.k + 1 >= 0) win |= line(c, bd.n - 1);
    }
    return __any_sync(kFull, win);
}

// The ballot path: the mover's stones are bits, chunk j's word on lane j.
// Lane r tests the runs of k starting in row r; true where there is one.
__device__ __forceinline__ bool run_win(uint32_t word, const Board& bd, int lane) {
    const int start = lane * bd.n;
    const int w = (start >> 5) & 31, o = start & 31;
    const uint32_t lo = __shfl_sync(kFull, word, w);
    const uint32_t hi = __shfl_sync(kFull, word, (w + 1) & 31);
    const uint32_t row_mask = bd.n == 32 ? kFull : (1u << bd.n) - 1u;
    // A row that ends in word w + 1 reads a word that exists; rows past the
    // board are empty.
    const uint32_t row = lane < bd.m ? __funnelshift_r(lo, hi, o) & row_mask : 0u;
    uint32_t across = row, down = row, diag = row, back = row;
    for (int i = 1; i < bd.k; ++i) {
        // Row lane + i: every lane whose runs down can be whole reads a lane
        // below 32, since lane + k <= m <= 32 there.
        const uint32_t below = __shfl_down_sync(kFull, row, i);
        across &= row >> i;       // cell c + i of this row
        down &= below;            // cell c of row + i
        diag &= below >> i;       // cell c + i of row + i
        back &= below << i;       // cell c - i of row + i
    }
    const bool win = across != 0 || (lane + bd.k <= bd.m && (down | diag | back) != 0);
    return __any_sync(kFull, win);
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32, kBlocksPerSm) env_step_kernel(
    const float* __restrict__ boards,      // (E, 2*MN)
    const int* __restrict__ player,        // (E,)
    const int* __restrict__ move_count,    // (E,)
    const int64_t* __restrict__ actions,   // (E,)
    const bool* __restrict__ active,       // (E,)
    int num_envs, Board bd,
    float* __restrict__ out_boards,        // (E, 2*MN)
    int* __restrict__ out_player,          // (E,)
    int* __restrict__ out_move_count,      // (E,)
    float* __restrict__ out_rewards,       // (E,)
    bool* __restrict__ out_dones,          // (E,)
    bool* __restrict__ out_mask)           // (E, MN)
{
    const int lane = threadIdx.x & 31;
    const int e = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
    if (e >= num_envs) return;  // whole warp leaves together: no block sync follows

    const bool act = active[e];
    const int p = player[e];
    const int64_t a = actions[e];
    const int mc = move_count[e];
    const Move mv{act && a >= 0 && a < bd.mn ? static_cast<int>(a) : -1, p == 0 ? 1.0f : 0.0f};
    const size_t at = static_cast<size_t>(e) * 2 * bd.mn;
    const float* in = boards + at;
    float* out = out_boards + at;
    bool* mask = out_mask + static_cast<size_t>(e) * bd.mn;

    uint32_t word = 0;  // lane j: the mover bits of cells 32 j .. 32 j + 31
    bool odd = false;   // some mover value is neither 0 nor 1
    for (int j0 = 0; j0 < bd.words; j0 += kChunksInFlight) {
        float b[kChunksInFlight], w[kChunksInFlight];
#pragma unroll
        for (int u = 0; u < kChunksInFlight; ++u) {
            const int c = 32 * (j0 + u) + lane;
            if (c < bd.mn) {
                b[u] = in[c];
                w[u] = in[bd.mn + c];
            }
        }
#pragma unroll
        for (int u = 0; u < kChunksInFlight; ++u) {
            const int j = j0 + u;
            if (j >= bd.words) break;
            const int c = 32 * j + lane;
            float v = 0.0f;
            if (c < bd.mn) {
                const float b2 = mv.black(b[u], c), w2 = mv.white(w[u], c);
                out[c] = b2;
                out[bd.mn + c] = w2;
                mask[c] = __fadd_rn(b2, w2) < 0.5f;
                v = mv.mover(b2, w2);
            }
            const uint32_t stones = __ballot_sync(kFull, v == 1.0f);
            odd |= __any_sync(kFull, !(v == 0.0f || v == 1.0f));
            if (lane == j) word = stones;
        }
    }

    const bool win = bd.bits && !odd ? run_win(word, bd, lane) : exact_win(in, mv, bd, lane);

    if (lane == 0) {
        const int ai = act ? 1 : 0;
        const int count = mc + ai;
        const bool won = win && act;
        const bool draw = count >= bd.mn && !won && act;
        out_player[e] = p ^ ai;
        out_move_count[e] = count;
        out_rewards[e] = won ? 1.0f : 0.0f;
        out_dones[e] = won || draw;
    }
}

}  // namespace

extern "C" int env_step_launch(
    const void* boards, const void* player, const void* move_count,
    const void* actions, const void* active, int num_envs, int m, int n, int k,
    void* out_boards, void* out_player, void* out_move_count,
    void* out_rewards, void* out_dones, void* out_mask, void* stream)
{
    if (num_envs == 0) return 0;
    if (m < 1 || n < 1 || k < 1 || num_envs < 0) return static_cast<int>(cudaErrorInvalidValue);
    Board bd;
    bd.m = m;
    bd.n = n;
    bd.k = k;
    bd.mn = m * n;
    bd.words = (bd.mn + 31) / 32;
    bd.bits = m <= 32 && n <= 32 && k <= 32;
    const int blocks = (num_envs + kWarpsPerBlock - 1) / kWarpsPerBlock;
    env_step_kernel<<<blocks, kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(boards), static_cast<const int*>(player),
        static_cast<const int*>(move_count), static_cast<const int64_t*>(actions),
        static_cast<const bool*>(active), num_envs, bd,
        static_cast<float*>(out_boards), static_cast<int*>(out_player),
        static_cast<int*>(out_move_count), static_cast<float*>(out_rewards),
        static_cast<bool*>(out_dones), static_cast<bool*>(out_mask));
    return static_cast<int>(cudaGetLastError());
}

// The kernel's registers and local (spilled) bytes a thread, and the blocks
// of four envs an SM holds at once.
extern "C" int env_step_resources(int* registers, int* local_bytes, int* blocks_per_sm) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, env_step_kernel);
    if (err != cudaSuccess) return static_cast<int>(err);
    *registers = attr.numRegs;
    *local_bytes = static_cast<int>(attr.localSizeBytes);
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, env_step_kernel, kWarpsPerBlock * 32, 0));
}
