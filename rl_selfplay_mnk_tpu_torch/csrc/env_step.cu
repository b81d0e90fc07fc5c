// Fused MNK env step for Hopper (sm_90a): stone placement, K-in-a-row win
// check, draw/done/reward, player toggle and the next action mask, in one
// kernel.
//
// Replaces the TPU kernel rl_selfplay_mnk_tpu/ops/pallas_env.py
// (_step_kernel, entry fused_step). That kernel finds wins with a
// (E, MN) @ (MN, L) line-incidence matmul on the MXU; here each env walks
// its line list instead: every line is tested (not only the lines through
// the placed cell), so the result is the same when play goes on past a win.
//
// Bound: bytes. Per env it reads 2*MN floats and writes 2*MN floats plus MN
// mask bytes (about 0.8 KB at 9x9), so at the main path's 384 envs one call
// moves about 0.3 MB: a few hundred nanoseconds at the card's memory rate,
// far below the launch cost. The design keeps the call to one launch: one
// warp per env over a 1-D grid (any env count, the ragged tail masked),
// lanes stride the cells so board reads and writes are coalesced, the
// mover's plane and the line table sit in shared memory, and a warp vote
// (__any_sync) reduces the per-line win flags.
//
// The C entry returns cudaGetLastError() after the launch; the Python
// wrapper (ops/env_step.py) raises when it is not 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;

__global__ void env_step_kernel(
    const float* __restrict__ boards,      // (E, 2*MN)
    const int* __restrict__ player,        // (E,)
    const int* __restrict__ move_count,    // (E,)
    const int64_t* __restrict__ actions,   // (E,)
    const bool* __restrict__ active,       // (E,)
    const int* __restrict__ line_cells,    // (L, k)
    int num_envs, int mn, int num_lines, int k,
    float* __restrict__ out_boards,        // (E, 2*MN)
    int* __restrict__ out_player,          // (E,)
    int* __restrict__ out_move_count,      // (E,)
    float* __restrict__ out_rewards,       // (E,)
    bool* __restrict__ out_dones,          // (E,)
    bool* __restrict__ out_mask)           // (E, MN)
{
    extern __shared__ int smem[];
    int* s_lines = smem;                                     // L * k
    float* s_mover = reinterpret_cast<float*>(smem + num_lines * k);  // warps * MN

    for (int i = threadIdx.x; i < num_lines * k; i += blockDim.x) {
        s_lines[i] = line_cells[i];
    }
    __syncthreads();

    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int e = blockIdx.x * kWarpsPerBlock + warp;
    if (e >= num_envs) return;  // whole warp leaves together: no block sync follows

    float* mover = s_mover + warp * mn;
    const bool act = active[e];
    const int p = player[e];
    const int64_t a = actions[e];
    const bool is_black = (p == 0);
    const float* in = boards + static_cast<size_t>(e) * 2 * mn;
    float* out = out_boards + static_cast<size_t>(e) * 2 * mn;
    bool* mask = out_mask + static_cast<size_t>(e) * mn;

    for (int c = lane; c < mn; c += 32) {
        const float hit = (act && c == a) ? 1.0f : 0.0f;
        const float b = in[c] + (is_black ? hit : 0.0f);
        const float w = in[mn + c] + (is_black ? 0.0f : hit);
        out[c] = b;
        out[mn + c] = w;
        mover[c] = is_black ? b : w;
        mask[c] = (b + w) < 0.5f;
    }
    __syncwarp();

    const float thresh = static_cast<float>(k) - 0.5f;
    bool win = false;
    for (int l = lane; l < num_lines; l += 32) {
        const int* cells = s_lines + l * k;
        float count = 0.0f;
        for (int j = 0; j < k; ++j) count += mover[cells[j]];
        win |= count > thresh;
    }
    win = __any_sync(0xffffffffu, win);

    if (lane == 0) {
        const int ai = act ? 1 : 0;
        const int mc = move_count[e] + ai;
        const bool won = win && act;
        const bool draw = (mc >= mn) && !won && act;
        out_player[e] = p ^ ai;
        out_move_count[e] = mc;
        out_rewards[e] = won ? 1.0f : 0.0f;
        out_dones[e] = won || draw;
    }
}

}  // namespace

extern "C" int env_step_launch(
    const void* boards, const void* player, const void* move_count,
    const void* actions, const void* active, const void* line_cells,
    int num_envs, int mn, int num_lines, int k,
    void* out_boards, void* out_player, void* out_move_count,
    void* out_rewards, void* out_dones, void* out_mask, void* stream)
{
    if (num_envs == 0) return 0;
    const int blocks = (num_envs + kWarpsPerBlock - 1) / kWarpsPerBlock;
    const size_t smem = sizeof(int) * (static_cast<size_t>(num_lines) * k
                                       + static_cast<size_t>(kWarpsPerBlock) * mn);
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            env_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    env_step_kernel<<<blocks, kWarpsPerBlock * 32, smem,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(boards), static_cast<const int*>(player),
        static_cast<const int*>(move_count), static_cast<const int64_t*>(actions),
        static_cast<const bool*>(active), static_cast<const int*>(line_cells),
        num_envs, mn, num_lines, k,
        static_cast<float*>(out_boards), static_cast<int*>(out_player),
        static_cast<int*>(out_move_count), static_cast<float*>(out_rewards),
        static_cast<bool*>(out_dones), static_cast<bool*>(out_mask));
    return static_cast<int>(cudaGetLastError());
}
