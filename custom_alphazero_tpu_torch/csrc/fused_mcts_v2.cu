// One software-pipelined PUCT wave of the fused Connect-N search, for Hopper.
//
// Replaces the TPU kernel custom_alphazero_tpu/ops/fused_mcts_v2.py::_wave_kernel
// (launched through FusedConnectNSearchV2._kernel_call, pallas_call at :394),
// with the same carry layout at the boundary: float32 edge arrays (B, A, N)
// (prior, children, visits, value_sum), node arrays (B, N) (parent,
// parent_action, expanded, is_terminal, reward) and per-game (B, 1) scalars
// (node_count, leaf, leaf_terminal), updated in place, plus the (B, 64) leaf
// board (8x8 padded, cell r*8+c) written out.
//
// Per game, as the TPU kernel:
//   phase A (wave > 0): write the previous leaf's renormalised prior column,
//     mark it expanded, back the value up the parent chain (negamax, bounded
//     by N steps; a terminal leaf uses its stored reward, otherwise -value).
//   phase B (wave < S): descend by PUCT argmax from the root (the root row
//     uses `mixed`), placing stones on the padded board and mirroring it at
//     every level; create the child in slot node_count; detect n-in-a-row
//     with window sums over the flat 64-cell board in 4 directions; emit the
//     leaf board.
//   drain (wave == S): the leaf board is zero.
//
// Design: one warp per game, lanes over actions (A <= 8) for the PUCT row
// and over board cells for placement and line detection; the descent board
// and column heights live in shared memory. The TPU kernel computes every
// node's PUCT argmax once per wave; here each visited node's row is computed
// during the descent. Statistics are frozen within a wave, so both give the
// same choice. The chain walks (backup, descent) are serial per game.
//
// Bound on the H100: the carry is read and written once per wave
// (B=1024, A=7, N=251: ~34 MB each way, ~20 us at 3.35 TB/s); the work per
// game is a serial chain of dependent loads (descent depth + backup depth),
// so this simple kernel is latency-bound far above that bound. Holding a
// game's tree in shared memory (~33 KB at 250 simulations) is the planned
// redesign.
//
// Exactness: the arithmetic is IEEE float32 in the TPU kernel's order,
// u = c_puct * prior * sqrt(sum_nv) / (1 + nv), q = w / max(nv, 1), built
// with -fmad=false and the _rn intrinsics (no contraction, correctly rounded
// division and square root); masked scores are -FLT_MAX; the argmax takes
// the lowest action among equal scores.

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCells = 64;
constexpr int kPW = 8;
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

constexpr int kContinue = 0;
constexpr int kNew = 1;
constexpr int kUnexpanded = 2;
constexpr int kTerminal = 3;

struct Carry {
  float* prior;
  float* children;
  float* visits;
  float* value_sum;
  float* parent;
  float* parent_action;
  float* expanded;
  float* is_terminal;
  float* reward;
  float* node_count;
  float* leaf;
  float* leaf_terminal;
};

struct Geometry {
  int batch, actions, nodes, height, width, n_in_row, simulations, wave;
  float c_puct;
};

// Row index and cell of dropping a stone in `col`, as the TPU kernel's
// place(): row = clip((H - 1) - heights[col], 0, H - 1).
__device__ __forceinline__ int drop_cell(const float* heights, int col,
                                         int height) {
  float row = __fsub_rn(__fsub_rn((float)height, 1.0f), heights[col]);
  row = fminf(fmaxf(row, 0.0f), (float)(height - 1));
  return (int)row * kPW + col;
}

__global__ void wave_kernel(const float* __restrict__ mixed,
                            const float* __restrict__ renormed,
                            const float* __restrict__ value,
                            const float* __restrict__ root_board,
                            Carry c, float* __restrict__ leaf_board,
                            Geometry g) {
  __shared__ float s_board[kWarpsPerBlock][kCells];
  __shared__ float s_placed[kWarpsPerBlock][kCells];
  __shared__ float s_heights[kWarpsPerBlock][kPW];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int b = blockIdx.x * kWarpsPerBlock + warp;
  if (b >= g.batch) return;  // whole warps leave together

  const int A = g.actions, N = g.nodes;
  const size_t edge = (size_t)b * A * N;
  float* prior = c.prior + edge;
  float* children = c.children + edge;
  float* visits = c.visits + edge;
  float* value_sum = c.value_sum + edge;
  const size_t nodes = (size_t)b * N;
  float* parent = c.parent + nodes;
  float* parent_action = c.parent_action + nodes;
  float* expanded = c.expanded + nodes;
  float* is_terminal = c.is_terminal + nodes;
  float* reward = c.reward + nodes;
  float* out_board = leaf_board + (size_t)b * kCells;

  // ---- phase A: expand + back up the previous wave's leaf ----------------
  if (g.wave > 0) {
    const int leaf = (int)c.leaf[b];
    const bool leaf_term = c.leaf_terminal[b] > 0.0f;
    const bool do_expand = !(expanded[leaf] > 0.0f) && !leaf_term;
    __syncwarp();
    if (do_expand && lane < A) prior[lane * N + leaf] = renormed[b * A + lane];
    if (lane == 0) {
      if (do_expand) expanded[leaf] = 1.0f;
      float v = leaf_term ? reward[leaf] : -value[b];
      int node = leaf;
      for (int it = 0; it < N && node > 0; ++it) {
        const int p = (int)parent[node];
        const int pa = (int)parent_action[node];
        visits[pa * N + p] = __fadd_rn(visits[pa * N + p], 1.0f);
        value_sum[pa * N + p] = __fadd_rn(value_sum[pa * N + p], v);
        node = p;
        v = -v;
      }
    }
    __syncwarp();
  }

  if (g.wave >= g.simulations) {  // drain wave: no select
    for (int i = lane; i < kCells; i += 32) out_board[i] = 0.0f;
    return;
  }

  // ---- phase B: select + create ------------------------------------------
  float* board = s_board[warp];
  float* placed = s_placed[warp];
  float* heights = s_heights[warp];
  for (int i = lane; i < kCells; i += 32) board[i] = root_board[b * kCells + i];
  __syncwarp();
  if (lane < kPW) {
    float h = 0.0f;  // stones per column: exact small integers
    for (int r = 0; r < kPW; ++r) h = __fadd_rn(h, fabsf(board[r * kPW + lane]));
    heights[lane] = h;
  }
  __syncwarp();
  float full = 0.0f;
  for (int col = 0; col < kPW; ++col) full = __fadd_rn(full, heights[col]);

  int node = 0, action = 0, code = kContinue;
  for (int it = 0; it < N && code == kContinue; ++it) {
    // PUCT row of `node`; lanes >= A never win the argmax.
    float nv = 0.0f, score = -INFINITY;
    float pe = 0.0f, w = 0.0f;
    if (lane < A) {
      pe = node == 0 ? mixed[b * A + lane] : prior[lane * N + node];
      nv = visits[lane * N + node];
      w = value_sum[lane * N + node];
    }
    float sum_nv = nv;  // integer-valued: exact in any order
    for (int off = 16; off > 0; off >>= 1)
      sum_nv = __fadd_rn(sum_nv, __shfl_xor_sync(kFull, sum_nv, off));
    if (lane < A) {
      const float q = __fdiv_rn(w, fmaxf(nv, 1.0f));
      const float u = __fdiv_rn(
          __fmul_rn(__fmul_rn(g.c_puct, pe), __fsqrt_rn(sum_nv)),
          __fadd_rn(1.0f, nv));
      score = pe > 0.0f ? __fadd_rn(q, u) : -FLT_MAX;
    }
    int best = lane;
    for (int off = 16; off > 0; off >>= 1) {
      const float other = __shfl_xor_sync(kFull, score, off);
      const int other_idx = __shfl_xor_sync(kFull, best, off);
      if (other > score || (other == score && other_idx < best)) {
        score = other;
        best = other_idx;
      }
    }
    const float child = children[best * N + node];
    const bool node_term = is_terminal[node] > 0.0f;
    const bool node_exp = expanded[node] > 0.0f;
    const int new_code = node_term ? kTerminal
                         : !node_exp ? kUnexpanded
                         : child == -1.0f ? kNew
                                          : kContinue;
    action = best;
    if (new_code == kContinue) {
      const int cell = drop_cell(heights, action, g.height);
      __syncwarp();
      for (int i = lane; i < kCells; i += 32)
        board[i] = -__fadd_rn(board[i], i == cell ? 1.0f : 0.0f);
      if (lane == 0) heights[action] = __fadd_rn(heights[action], 1.0f);
      full = __fadd_rn(full, 1.0f);
      node = (int)child;
    }
    code = new_code;
    __syncwarp();
  }

  // CREATE the selected child in slot node_count.
  const float slot = c.node_count[b];
  const bool is_new = code == kNew && slot < (float)N;
  const int cell = drop_cell(heights, action, g.height);
  for (int i = lane; i < kCells; i += 32)
    placed[i] = __fadd_rn(board[i], i == cell ? 1.0f : 0.0f);
  __syncwarp();

  // n-in-a-row of the mover's stones: window sums over the flat padded
  // board in the E, S, SE and SW directions (padding cells read zero).
  const int k = g.n_in_row;
  const float threshold = __fsub_rn((float)k, 0.5f);
  bool hit = false;
  const int dirs[4] = {1, kPW, kPW + 1, kPW - 1};
  for (int di = 0; di < 4; ++di) {
    const int d = dirs[di];
    const int starts = kCells - (k - 1) * d;
    for (int s = lane; s < starts; s += 32) {
      float sum = 0.0f;
      for (int i = 0; i < k; ++i)
        sum = __fadd_rn(sum, placed[s + i * d] == 1.0f ? 1.0f : 0.0f);
      hit = hit || sum > threshold;
    }
  }
  const bool win = __any_sync(kFull, hit);
  const bool filled =
      __fadd_rn(full, 1.0f) >= (float)(g.height * g.width);
  const bool child_term = win || filled;

  if (lane == 0 && is_new) {
    const int sl = (int)slot;
    parent[sl] = (float)node;
    parent_action[sl] = (float)action;
    children[action * N + node] = slot;
    is_terminal[sl] = child_term ? 1.0f : 0.0f;
    reward[sl] = win ? 1.0f : 0.0f;
    c.node_count[b] = __fadd_rn(slot, 1.0f);
  }
  __syncwarp();
  if (lane == 0) {
    const bool node_term = is_terminal[node] > 0.0f;
    c.leaf[b] = is_new ? slot : (float)node;
    c.leaf_terminal[b] = (is_new ? child_term : node_term) ? 1.0f : 0.0f;
  }
  for (int i = lane; i < kCells; i += 32)
    out_board[i] = is_new ? -placed[i] : board[i];
}

}  // namespace

extern "C" int fused_mcts_v2_wave(
    const void* mixed, const void* renormed, const void* value,
    const void* root_board, void* prior, void* children, void* visits,
    void* value_sum, void* parent, void* parent_action, void* expanded,
    void* is_terminal, void* reward, void* node_count, void* leaf,
    void* leaf_terminal, void* leaf_board, int batch, int actions, int nodes,
    int height, int width, int n_in_row, float c_puct, int simulations,
    int wave, void* stream) {
  if (batch == 0) return 0;
  Carry c{static_cast<float*>(prior),         static_cast<float*>(children),
          static_cast<float*>(visits),        static_cast<float*>(value_sum),
          static_cast<float*>(parent),        static_cast<float*>(parent_action),
          static_cast<float*>(expanded),      static_cast<float*>(is_terminal),
          static_cast<float*>(reward),        static_cast<float*>(node_count),
          static_cast<float*>(leaf),          static_cast<float*>(leaf_terminal)};
  Geometry g{batch, actions, nodes, height, width, n_in_row, simulations, wave,
             c_puct};
  const dim3 grid((batch + kWarpsPerBlock - 1) / kWarpsPerBlock);
  wave_kernel<<<grid, 32 * kWarpsPerBlock, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mixed), static_cast<const float*>(renormed),
      static_cast<const float*>(value), static_cast<const float*>(root_board),
      c, static_cast<float*>(leaf_board), g);
  return static_cast<int>(cudaGetLastError());
}
