// One software-pipelined PUCT wave step of the fused Connect-N search, for
// Hopper: the kernel behind both fused searches, templated on the carry's
// edge layout.
//
// csrc/fused_mcts_v2.cu instantiates it for the v2 layout (kernel K1, edge
// arrays (B, A, N)) and csrc/fused_mcts.cu for the v1 layout (kernel K2,
// edge arrays (B, N*A), a node's A edges contiguous). At the boundary both
// keep their TPU kernel's carry: float32 edge arrays (prior, children,
// visits, value_sum), node arrays (B, N) (parent, parent_action, expanded,
// is_terminal, reward) and per-game (B, 1) scalars (node_count, leaf,
// leaf_terminal), updated in place, plus the leaf board (8x8 padded, cell
// r*8+c, whether the wrapper sees it as (B, 64) or (B, 8, 8)).
//
// A step is what one wave of the search does between two net forwards. The
// TPU kernels left the elementwise work around the wave to XLA, which fused
// it into one device program with them; here it is part of the kernel, so
// that a wave on the card is this kernel and the net. Per game:
//   prologue: the legal mask of the previous leaf (top row of its board
//     empty, leaf not terminal); the net's priors renormalised over it (sum
//     left to right, uniform over legal moves at zero mass, 1e-35 floor);
//     the root prior captured at wave 1 for live roots; the root row mixed
//     with this wave's Gamma draws, (1 - f) * P + f * g / sum(g).
//   phase A (wave > 0): write the previous leaf's renormalised prior row,
//     mark it expanded, back the value up the path that the previous step
//     recorded (negamax; a terminal leaf uses its stored reward, otherwise
//     -value).
//   phase B (wave < S): descend by PUCT argmax from the root (the root row
//     uses the mixed prior), placing stones on the padded board and
//     mirroring it at every level; create the child in slot node_count;
//     detect n-in-a-row; record the path; emit the leaf board.
//   drain (wave >= S): the leaf board is zero.
//   epilogue: the (H, W, 4) observation of the leaf board that the net
//     reads: planes empty, mine, theirs, ones.
//
// The two TPU kernels differ in two places, kept here as Layout flags:
//   - v1 takes its argmax over the whole N*A edge range, so a row with every
//     action masked (a terminal or unexpanded node) reads the child of edge 0
//     instead of the node's own action 0. The child is never followed there.
//   - v1 counts lines in row, column and diagonal windows of the H x W board;
//     v2 in flat windows of the 64 padded cells (the padding column guards
//     the row edges on boards narrower than 8).
//
// Bound on the H100: the bytes a step must touch are the path's rows, the
// board and the small per-game rows (a few KB per game, ~0.4 us at 3.35 TB/s
// for B=1024); the whole carry is ~34 MB each way at B=1024, A=7, N=251.
// The kernel returns to the host every wave, because the net runs between
// waves, so a design that holds a game's tree in shared memory would load
// and store that carry on every launch: 0.020 ms at 3.35 TB/s, more than
// the kernel took before this design. What bounds the kernel instead is the
// chain of dependent loads of its deepest game, so the design shortens the
// chain:
//   - one warp per game, lanes over actions (A <= 8) for the PUCT row and
//     over board cells (two per lane, in registers) for placement; lines
//     and the observation's planes are read off 64-bit masks of the board
//     gathered by ballot, so the kernel uses no shared memory;
//   - every load whose address needs no other load is issued at the top: the
//     wave index, the per-game scalars, the boards, the net's row, the
//     recorded path and the root's row (patched in registers with phase A's
//     update of the root edge, so the root level costs no round trip);
//   - the backup is no chain: phase B records the (node, action) of every
//     level it walks, the new edge last, and phase A of the next step
//     updates those edges in parallel, lane j with sign (-1)^(L-1-j). The
//     edges of a path are distinct, so visits + 1 and value_sum + v are the
//     serial chain's values exactly;
//   - the descent costs one round trip per level: a node's prior, visits,
//     value sums, children and its terminal and expanded flags are loaded in
//     one batch, and the chosen child comes by shuffle from its lane.
// About 2 + d round trips for a game at depth d, where the serial version
// took about 5 + 3 d.
//
// The wave index lives in device memory (counter[0]) so that a CUDA graph
// can replay the step: every warp reads it at the top, and the last block to
// finish (counter[1] counts finished blocks) advances it. That is free of
// races: a block adds to counter[1] only after all its warps have read and
// used counter[0], and counter[0] is written only once every block has added.
//
// Exactness: the arithmetic is IEEE float32 in the TPU kernels' and XLA's
// order, u = c_puct * prior * sqrt(sum_nv) / (1 + nv), q = w / max(nv, 1),
// built with -fmad=false and the _rn intrinsics (no contraction, correctly
// rounded division and square root); masked scores are -FLT_MAX; the argmax
// takes the lowest action among equal scores; the mirrored board keeps its
// signed zeros.

#pragma once

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace puct_wave {

constexpr int kCells = 64;
constexpr int kPW = 8;
#ifndef PUCT_WARPS_PER_BLOCK
#define PUCT_WARPS_PER_BLOCK 4
#endif
constexpr int kWarpsPerBlock = PUCT_WARPS_PER_BLOCK;
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

// What a step reads and writes beside the carry.
struct Step {
  const float* probs;       // (B, A) the net's priors of the previous leaf
  const float* value;       // (B, 1) the net's value of the previous leaf
  const float* gamma;       // (S, B, A) root-noise draws, or null: no noise
  const float* root_board;  // (B, 64)
  float* root_prior;        // (B, A) in/out: captured at wave 1
  float* leaf_board;        // (B, 64) in/out: the previous leaf's, then this
  int* path;                // (B, path_stride) in/out: [0] edges, then
                            // node * A + action of each, from the root
  int* counter;             // [0] the wave index, [1] finished blocks
  float* renormed;          // (B, A) out
  float* mixed;             // (B, A) out
  float* obs;               // (B, H, W, 4) out
};

struct Geometry {
  int batch, actions, nodes, height, width, n_in_row, simulations,
      path_stride;
  // prior_fraction is 1 - noise_fraction, rounded once by the caller.
  float c_puct, noise_fraction, prior_fraction;
};

// Cell of dropping a stone in `col` of a column holding `stones`, as the TPU
// kernels' place(): row = clip((H - 1) - stones, 0, H - 1).
__device__ __forceinline__ int drop_cell(float stones, int col, int height) {
  float row = __fsub_rn(__fsub_rn((float)height, 1.0f), stones);
  row = fminf(fmaxf(row, 0.0f), (float)(height - 1));
  return (int)row * kPW + col;
}

// Sum of `x` over lanes 0 .. count-1, left to right, on every lane.
__device__ __forceinline__ float sum_left_to_right(float x, int count) {
  float total = __shfl_sync(kFull, x, 0);
  for (int a = 1; a < count; ++a)
    total = __fadd_rn(total, __shfl_sync(kFull, x, a));
  return total;
}

// The 64 cells where a condition holds, bit i for cell i, on every lane;
// each lane gives the condition for its cells `lane` and `lane + 32`.
__device__ __forceinline__ uint64_t cell_mask(bool lo, bool hi) {
  return (uint64_t)__ballot_sync(kFull, lo) |
         ((uint64_t)__ballot_sync(kFull, hi) << 32);
}

// `bits` (one row of 8 cells) in every row.
__device__ __forceinline__ uint64_t every_row(unsigned bits) {
  return (uint64_t)(bits & 0xffu) * 0x0101010101010101ull;
}

// Whether `mine` (the mover's stones after the move) holds n-in-a-row: a
// start cell s has a line along d when cells s, s + d, ... s + (k - 1) d are
// all set, that is when bit s survives the AND of the mask shifted by each.
// A shift drops the windows that leave the 64 cells, as the TPU kernels'
// window bounds do.
template <bool kBoardWindows>
__device__ __forceinline__ bool has_line(uint64_t mine, const Geometry& g) {
  const int k = g.n_in_row;
  uint64_t east = ~0ull, west = ~0ull;
  if constexpr (kBoardWindows) {
    // v1: only cells of the H x W board count, and a window stays inside the
    // tile's 8 columns: starts with k columns to their east, or west.
    mine &= every_row((1u << g.width) - 1u) &
            (g.height >= kPW ? ~0ull : (1ull << (kPW * g.height)) - 1ull);
    east = every_row(0xffu >> (k - 1));
    west = every_row(0xffu << (k - 1));
  }
  // E, S, SE, SW; v2 counts flat windows of the padded cells.
  const int dirs[4] = {1, kPW, kPW + 1, kPW - 1};
  const uint64_t starts[4] = {east, ~0ull, east, west};
  bool hit = false;
  for (int di = 0; di < 4; ++di) {
    uint64_t run = mine;
    for (int i = 1; i < k; ++i) {
      const int shift = i * dirs[di];
      run = shift < kCells ? run & (mine >> shift) : 0ull;
    }
    hit = hit || (run & starts[di]) != 0ull;
  }
  return hit;
}

// Write the leaf board (this lane's cells `lo` = cell lane, `hi` = cell
// lane + 32) and its observation: row by row, lane c * 4 + plane.
__device__ __forceinline__ void emit_leaf(float lo, float hi,
                                          float* out_board, float* obs,
                                          int lane, const Geometry& g) {
  out_board[lane] = lo;
  out_board[lane + 32] = hi;
  const uint64_t empty = cell_mask(lo == 0.0f, hi == 0.0f);
  const uint64_t mine = cell_mask(lo == 1.0f, hi == 1.0f);
  const uint64_t theirs = cell_mask(lo == -1.0f, hi == -1.0f);
  const int c = lane / 4, plane = lane % 4;
  const uint64_t cells = plane == 0   ? empty
                         : plane == 1 ? mine
                         : plane == 2 ? theirs
                                      : ~0ull;
  if (c < g.width) {
    for (int r = 0; r < g.height; ++r)
      obs[(r * g.width + c) * 4 + plane] =
          (cells >> (r * kPW + c)) & 1ull ? 1.0f : 0.0f;
  }
}

// One game's step, by one warp. Every branch that holds a shuffle or a
// warp barrier is taken by the whole warp: its condition comes from values
// that all lanes loaded from one address or received by shuffle.
//
// Layout: static int edge(node, action, A, N), the flat index of an edge in
// one game's edge arrays, and static constexpr bool kV1, the v1 kernel's
// rules (see the top of this file).
template <class Layout>
__device__ __forceinline__ void game_step(const Step& s, const Carry& c,
                                          const Geometry& g, int wave, int b,
                                          int lane) {
  const int A = g.actions, N = g.nodes;
  const size_t edges = (size_t)b * A * N;
  float* prior = c.prior + edges;
  float* children = c.children + edges;
  float* visits = c.visits + edges;
  float* value_sum = c.value_sum + edges;
  const size_t nodes = (size_t)b * N;
  float* expanded = c.expanded + nodes;
  float* is_terminal = c.is_terminal + nodes;
  float* reward = c.reward + nodes;
  float* out_board = s.leaf_board + (size_t)b * kCells;
  float* obs = s.obs + (size_t)b * g.height * g.width * 4;
  int* path = s.path + (size_t)b * g.path_stride;
  const bool alane = lane < A;
  const bool noisy = s.gamma != nullptr && wave < g.simulations;

  // ---- the top batch: loads that depend on no other load -------------------
  const float leaf_f = c.leaf[b];
  const float leaf_term_f = c.leaf_terminal[b];
  const int prev_edges = path[0];
  const int path_lo = 1 + lane < g.path_stride ? path[1 + lane] : 0;
  const float slot = c.node_count[b];
  const float root_term_f = is_terminal[0];
  const float root_exp_f = expanded[0];
  const float val = s.value[b];
  float b_lo = s.root_board[(size_t)b * kCells + lane];
  float b_hi = s.root_board[(size_t)b * kCells + lane + 32];
  float top = 1.0f, p_net = 0.0f, root_p = 0.0f, draw = 0.0f;
  float nv = 0.0f, w = 0.0f, ch = 0.0f;  // the root's row
  if (alane) {
    top = out_board[lane];
    p_net = s.probs[b * A + lane];
    root_p = s.root_prior[b * A + lane];
    const int e = Layout::edge(0, lane, A, N);
    nv = visits[e];
    w = value_sum[e];
    ch = children[e];
    // The one load here behind another (the wave index): issued last.
    if (noisy) draw = s.gamma[((size_t)wave * g.batch + b) * A + lane];
  }

  // ---- the second batch: what phase A needs of the last leaf and its path,
  // issued before the prologue's arithmetic waits for the first.
  const bool backup = wave > 0;
  const int leaf = backup ? (int)leaf_f : 0;
  const bool on_path = backup && lane < prev_edges;
  const float leaf_exp_f = expanded[leaf];
  const float leaf_reward = reward[leaf];
  int path_edge = 0;
  float old_nv = 0.0f, old_w = 0.0f;
  if (on_path) {
    path_edge = Layout::edge(path_lo / A, path_lo % A, A, N);
    old_nv = visits[path_edge];
    old_w = value_sum[path_edge];
  }

  // ---- prologue: renormalised priors, root prior, root noise ---------------
  const bool leaf_term = leaf_term_f > 0.0f;
  const bool legal = alane && top == 0.0f && leaf_term_f == 0.0f;
  const float masked = legal ? p_net : 0.0f;
  const float total = sum_left_to_right(masked, A);
  const int num_legal = max(__popc(__ballot_sync(kFull, legal)), 1);
  float renormed =
      total > 0.0f ? __fdiv_rn(masked, fmaxf(total, (float)1e-30))
                   : __fdiv_rn(legal ? 1.0f : 0.0f, (float)num_legal);
  renormed = legal ? fmaxf(renormed, (float)1e-35) : 0.0f;
  if (wave == 1 && !(root_term_f > 0.0f)) root_p = renormed;
  float mixed = root_p;
  if (noisy) {
    const bool root_legal = root_p > 0.0f;
    const float noise = root_legal ? draw : 0.0f;
    const float noise_sum = sum_left_to_right(noise, A);
    mixed = __fadd_rn(
        __fmul_rn(g.prior_fraction, root_p),
        __fmul_rn(g.noise_fraction,
                  __fdiv_rn(noise, fmaxf(noise_sum, (float)1e-30))));
    mixed = root_legal ? fmaxf(mixed, (float)1e-35) : 0.0f;
  }
  if (alane) {
    s.renormed[b * A + lane] = renormed;
    s.mixed[b * A + lane] = mixed;
    if (wave == 1) s.root_prior[b * A + lane] = root_p;
  }

  // ---- phase A: expand + back up the previous step's leaf ------------------
  bool root_exp = root_exp_f > 0.0f;
  if (backup) {
    const bool do_expand = !(leaf_exp_f > 0.0f) && !leaf_term;
    const float v = leaf_term ? leaf_reward : -val;
    if (do_expand && alane) prior[Layout::edge(leaf, lane, A, N)] = renormed;
    if (do_expand && lane == 0) expanded[leaf] = 1.0f;
    root_exp = root_exp || (do_expand && leaf == 0);
    if (on_path) {
      visits[path_edge] = __fadd_rn(old_nv, 1.0f);
      value_sum[path_edge] =
          __fadd_rn(old_w, (prev_edges - 1 - lane) & 1 ? -v : v);
    }
    for (int j = lane + 32; j < prev_edges; j += 32) {  // paths over 32 deep
      const int code = path[1 + j];
      const int e = Layout::edge(code / A, code % A, A, N);
      visits[e] = __fadd_rn(visits[e], 1.0f);
      value_sum[e] =
          __fadd_rn(value_sum[e], (prev_edges - 1 - j) & 1 ? -v : v);
    }
    if (prev_edges > 0) {
      // The path's first edge is the root's: bring the row loaded at the top
      // up to date, with the values just stored.
      const int root_action = __shfl_sync(kFull, path_lo, 0);
      if (lane == root_action) {
        nv = __fadd_rn(nv, 1.0f);
        w = __fadd_rn(w, (prev_edges - 1) & 1 ? -v : v);
      }
    }
    __syncwarp();  // phase B reads what other lanes stored
  }

  if (wave >= g.simulations) {  // drain wave: no select
    emit_leaf(0.0f, 0.0f, out_board, obs, lane, g);
    return;
  }

  // ---- phase B: select + create --------------------------------------------
  // Stones per column (exact small integers), on every lane of the column.
  float stones = __fadd_rn(fabsf(b_lo), fabsf(b_hi));
  stones = __fadd_rn(stones, __shfl_xor_sync(kFull, stones, 8));
  stones = __fadd_rn(stones, __shfl_xor_sync(kFull, stones, 16));
  float full = stones;
  for (int off = 1; off < kPW; off <<= 1)
    full = __fadd_rn(full, __shfl_xor_sync(kFull, full, off));
  const float root_child0 = __shfl_sync(kFull, ch, 0);

  int node = 0, action = 0, code = kContinue, depth = 0;
  float pe = mixed;
  bool node_term = root_term_f > 0.0f, node_exp = root_exp;
  for (int it = 0; it < N; ++it) {
    // PUCT row of `node`; lanes >= A never win the argmax.
    float sum_nv = alane ? nv : 0.0f;  // integer-valued: exact in any order
    for (int off = 16; off > 0; off >>= 1)
      sum_nv = __fadd_rn(sum_nv, __shfl_xor_sync(kFull, sum_nv, off));
    float score = -INFINITY;
    if (alane) {
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
    float child = __shfl_sync(kFull, ch, best);
    // v1: a fully masked row's argmax over the whole edge range is edge 0.
    if (Layout::kV1 && score == -FLT_MAX) child = root_child0;
    action = best;
    code = node_term          ? kTerminal
           : !node_exp        ? kUnexpanded
           : child == -1.0f   ? kNew
                              : kContinue;
    if (code != kContinue) break;

    if (lane == 0 && 1 + depth < g.path_stride)
      path[1 + depth] = node * A + action;
    ++depth;
    const int cell =
        drop_cell(__shfl_sync(kFull, stones, action), action, g.height);
    b_lo = -__fadd_rn(b_lo, lane == cell ? 1.0f : 0.0f);
    b_hi = -__fadd_rn(b_hi, lane + 32 == cell ? 1.0f : 0.0f);
    if (lane % kPW == action) stones = __fadd_rn(stones, 1.0f);
    full = __fadd_rn(full, 1.0f);
    node = (int)child;
    // The child's row and flags, one batch of loads.
    if (alane) {
      const int e = Layout::edge(node, lane, A, N);
      pe = prior[e];
      nv = visits[e];
      w = value_sum[e];
      ch = children[e];
    }
    node_term = is_terminal[node] > 0.0f;
    node_exp = expanded[node] > 0.0f;
  }

  // CREATE the selected child in slot node_count.
  const bool is_new = code == kNew && slot < (float)N;
  const int cell =
      drop_cell(__shfl_sync(kFull, stones, action), action, g.height);
  const float p_lo = __fadd_rn(b_lo, lane == cell ? 1.0f : 0.0f);
  const float p_hi = __fadd_rn(b_hi, lane + 32 == cell ? 1.0f : 0.0f);
  const bool win =
      has_line<Layout::kV1>(cell_mask(p_lo == 1.0f, p_hi == 1.0f), g);
  const bool filled = __fadd_rn(full, 1.0f) >= (float)(g.height * g.width);
  const bool child_term = win || filled;

  if (lane == 0) {
    if (is_new) {
      const int sl = (int)slot;
      c.parent[nodes + sl] = (float)node;
      c.parent_action[nodes + sl] = (float)action;
      children[Layout::edge(node, action, A, N)] = slot;
      is_terminal[sl] = child_term ? 1.0f : 0.0f;
      reward[sl] = win ? 1.0f : 0.0f;
      c.node_count[b] = __fadd_rn(slot, 1.0f);
      if (1 + depth < g.path_stride) path[1 + depth] = node * A + action;
    }
    path[0] = depth + (is_new ? 1 : 0);
    c.leaf[b] = is_new ? slot : (float)node;
    c.leaf_terminal[b] = (is_new ? child_term : node_term) ? 1.0f : 0.0f;
  }
  emit_leaf(is_new ? -p_lo : b_lo, is_new ? -p_hi : b_hi, out_board, obs,
            lane, g);
}

template <class Layout>
__global__ void wave_kernel(Step s, Carry c, Geometry g) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int b = blockIdx.x * kWarpsPerBlock + warp;
  const int wave = __ldcg(s.counter);
  if (b < g.batch) game_step<Layout>(s, c, g, wave, b, lane);
  __syncthreads();
  if (threadIdx.x == 0) {
    const int finished = atomicAdd(s.counter + 1, 1);
    if (finished == (int)gridDim.x - 1) {
      s.counter[1] = 0;
      s.counter[0] = wave + 1;
    }
  }
}

// Launch one step on `stream`; returns cudaGetLastError() (0 = launched).
template <class Layout>
int launch(const Step& s, const Carry& c, const Geometry& g, void* stream) {
  if (g.batch == 0) return 0;
  const dim3 grid((g.batch + kWarpsPerBlock - 1) / kWarpsPerBlock);
  wave_kernel<Layout><<<grid, 32 * kWarpsPerBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(s, c, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace puct_wave

// The C entry point `name` of a kernel library: the step for edge layout
// `Layout`. Pointers in the order of Step, then of Carry.
#define PUCT_WAVE_ENTRY(name, Layout)                                          \
  extern "C" int name(                                                         \
      const void* probs, const void* value, const void* gamma,                 \
      const void* root_board, void* root_prior, void* leaf_board, void* path,  \
      void* counter, void* renormed, void* mixed, void* obs, void* prior,      \
      void* children, void* visits, void* value_sum, void* parent,             \
      void* parent_action, void* expanded, void* is_terminal, void* reward,    \
      void* node_count, void* leaf, void* leaf_terminal, int batch,            \
      int actions, int nodes, int height, int width, int n_in_row,             \
      int simulations, int path_stride, float c_puct, float noise_fraction,    \
      float prior_fraction, void* stream) {                                    \
    using F = float*;                                                          \
    using CF = const float*;                                                   \
    const puct_wave::Step s{                                                   \
        static_cast<CF>(probs),     static_cast<CF>(value),                    \
        static_cast<CF>(gamma),     static_cast<CF>(root_board),               \
        static_cast<F>(root_prior), static_cast<F>(leaf_board),                \
        static_cast<int*>(path),    static_cast<int*>(counter),                \
        static_cast<F>(renormed),   static_cast<F>(mixed),                     \
        static_cast<F>(obs)};                                                  \
    const puct_wave::Carry c{                                                  \
        static_cast<F>(prior),         static_cast<F>(children),               \
        static_cast<F>(visits),        static_cast<F>(value_sum),              \
        static_cast<F>(parent),        static_cast<F>(parent_action),          \
        static_cast<F>(expanded),      static_cast<F>(is_terminal),            \
        static_cast<F>(reward),        static_cast<F>(node_count),             \
        static_cast<F>(leaf),          static_cast<F>(leaf_terminal)};         \
    const puct_wave::Geometry g{batch,       actions,        nodes,            \
                                height,      width,          n_in_row,         \
                                simulations, path_stride,    c_puct,           \
                                noise_fraction, prior_fraction};               \
    return puct_wave::launch<Layout>(s, c, g, stream);                         \
  }
