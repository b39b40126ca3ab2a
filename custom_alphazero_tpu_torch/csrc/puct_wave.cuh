// One software-pipelined PUCT wave of the fused Connect-N search, for Hopper:
// the kernel behind both fused searches, templated on the carry's edge layout.
//
// csrc/fused_mcts_v2.cu instantiates it for the v2 layout (kernel K1, edge
// arrays (B, A, N)) and csrc/fused_mcts.cu for the v1 layout (kernel K2,
// edge arrays (B, N*A), a node's A edges contiguous). At the boundary both
// keep their TPU kernel's carry: float32 edge arrays (prior, children,
// visits, value_sum), node arrays (B, N) (parent, parent_action, expanded,
// is_terminal, reward) and per-game (B, 1) scalars (node_count, leaf,
// leaf_terminal), updated in place, plus the leaf board written out (8x8
// padded, cell r*8+c, whether the wrapper sees it as (B, 64) or (B, 8, 8)).
//
// Per game, as the TPU kernels:
//   phase A (wave > 0): write the previous leaf's renormalised prior row,
//     mark it expanded, back the value up the parent chain (negamax, bounded
//     by N steps; a terminal leaf uses its stored reward, otherwise -value).
//   phase B (wave < S): descend by PUCT argmax from the root (the root row
//     uses `mixed`), placing stones on the padded board and mirroring it at
//     every level; create the child in slot node_count; detect n-in-a-row;
//     emit the leaf board.
//   drain (wave == S): the leaf board is zero.
//
// The two TPU kernels differ in two places, kept here as Layout flags:
//   - v1 takes its argmax over the whole N*A edge range, so a row with every
//     action masked (a terminal or unexpanded node) reads the child of edge 0
//     instead of the node's own action 0. The child is never followed there.
//   - v1 counts lines in row, column and diagonal windows of the H x W board;
//     v2 in flat windows of the 64 padded cells (the padding column guards
//     the row edges on boards narrower than 8).
//
// Design: one warp per game, lanes over actions (A <= 8) for the PUCT row
// and over board cells for placement and line detection; the descent board
// and column heights live in shared memory. The TPU kernels compute every
// node's PUCT argmax once per wave; here each visited node's row is computed
// during the descent. Statistics are frozen within a wave, so both give the
// same choice. The chain walks (backup, descent) are serial per game.
//
// Bound on the H100: the bytes a wave must touch are the path's rows and
// the backup chain (a few KB per game, ~0.3 us at 3.35 TB/s for B=1024); the
// whole carry is ~34 MB each way at B=1024, A=7, N=251. The work per game is
// a serial chain of dependent loads (descent depth + backup depth), so this
// simple kernel is latency-bound far above either bound. Holding a game's
// tree in shared memory (~33 KB at 250 simulations) is the planned redesign.
//
// Exactness: the arithmetic is IEEE float32 in the TPU kernels' order,
// u = c_puct * prior * sqrt(sum_nv) / (1 + nv), q = w / max(nv, 1), built
// with -fmad=false and the _rn intrinsics (no contraction, correctly rounded
// division and square root); masked scores are -FLT_MAX; the argmax takes
// the lowest action among equal scores.

#pragma once

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace puct_wave {

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

// Row index and cell of dropping a stone in `col`, as the TPU kernels'
// place(): row = clip((H - 1) - heights[col], 0, H - 1).
__device__ __forceinline__ int drop_cell(const float* heights, int col,
                                         int height) {
  float row = __fsub_rn(__fsub_rn((float)height, 1.0f), heights[col]);
  row = fminf(fmaxf(row, 0.0f), (float)(height - 1));
  return (int)row * kPW + col;
}

// Whether this lane's windows hold n-in-a-row of the mover's stones
// (cells equal to 1) in `placed`; the caller reduces over the warp.
template <bool kBoardWindows>
__device__ __forceinline__ bool lane_has_line(const float* placed, int lane,
                                              const Geometry& g) {
  const int k = g.n_in_row;
  const float threshold = __fsub_rn((float)k, 0.5f);
  bool hit = false;
  if constexpr (kBoardWindows) {
    // Windows of k cells along (dr, dc) that lie inside the 8x8 tile,
    // counting only cells of the H x W board.
    const int dr[4] = {0, 1, 1, 1};
    const int dc[4] = {1, 0, 1, -1};
    for (int di = 0; di < 4; ++di) {
      for (int s = lane; s < kCells; s += 32) {
        const int r0 = s / kPW, c0 = s % kPW;
        const int r1 = r0 + (k - 1) * dr[di], c1 = c0 + (k - 1) * dc[di];
        if (r1 >= kPW || c1 < 0 || c1 >= kPW) continue;
        float sum = 0.0f;
        for (int i = 0; i < k; ++i) {
          const int r = r0 + i * dr[di], c = c0 + i * dc[di];
          const bool mine =
              placed[r * kPW + c] == 1.0f && r < g.height && c < g.width;
          sum = __fadd_rn(sum, mine ? 1.0f : 0.0f);
        }
        hit = hit || sum > threshold;
      }
    }
  } else {
    // Flat windows over the padded 64 cells in the E, S, SE and SW
    // directions (padding cells read zero).
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
  }
  return hit;
}

// Layout: static int edge(node, action, A, N), the flat index of an edge in
// one game's edge arrays, and static constexpr bool kV1, the v1 kernel's
// rules (see the top of this file).
template <class Layout>
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
  const size_t edges = (size_t)b * A * N;
  float* prior = c.prior + edges;
  float* children = c.children + edges;
  float* visits = c.visits + edges;
  float* value_sum = c.value_sum + edges;
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
    if (do_expand && lane < A)
      prior[Layout::edge(leaf, lane, A, N)] = renormed[b * A + lane];
    if (lane == 0) {
      if (do_expand) expanded[leaf] = 1.0f;
      float v = leaf_term ? reward[leaf] : -value[b];
      int node = leaf;
      for (int it = 0; it < N && node > 0; ++it) {
        const int p = (int)parent[node];
        const int e = Layout::edge(p, (int)parent_action[node], A, N);
        visits[e] = __fadd_rn(visits[e], 1.0f);
        value_sum[e] = __fadd_rn(value_sum[e], v);
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
      const int e = Layout::edge(node, lane, A, N);
      pe = node == 0 ? mixed[b * A + lane] : prior[e];
      nv = visits[e];
      w = value_sum[e];
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
    // v1: a fully masked row's argmax over the whole edge range is edge 0.
    const int child_edge = Layout::kV1 && score == -FLT_MAX
                               ? 0
                               : Layout::edge(node, best, A, N);
    const float child = children[child_edge];
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

  const bool win = __any_sync(kFull, lane_has_line<Layout::kV1>(placed, lane, g));
  const bool filled =
      __fadd_rn(full, 1.0f) >= (float)(g.height * g.width);
  const bool child_term = win || filled;

  if (lane == 0 && is_new) {
    const int sl = (int)slot;
    parent[sl] = (float)node;
    parent_action[sl] = (float)action;
    children[Layout::edge(node, action, A, N)] = slot;
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

// Launch one wave on `stream`; returns cudaGetLastError() (0 = launched).
template <class Layout>
int launch(const void* mixed, const void* renormed, const void* value,
           const void* root_board, void* prior, void* children, void* visits,
           void* value_sum, void* parent, void* parent_action,
           void* expanded, void* is_terminal, void* reward, void* node_count,
           void* leaf, void* leaf_terminal, void* leaf_board, int batch,
           int actions, int nodes, int height, int width, int n_in_row,
           float c_puct, int simulations, int wave, void* stream) {
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
  wave_kernel<Layout><<<grid, 32 * kWarpsPerBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mixed), static_cast<const float*>(renormed),
      static_cast<const float*>(value), static_cast<const float*>(root_board),
      c, static_cast<float*>(leaf_board), g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace puct_wave
