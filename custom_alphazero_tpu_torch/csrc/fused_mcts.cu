// Kernel K2: the fused Connect-N search wave in the v1 layout, for Hopper.
//
// Replaces the TPU kernel custom_alphazero_tpu/ops/fused_mcts.py::_wave_kernel
// (built in FusedConnectNSearch._kernel_call, pallas_call at :478). Edge
// arrays are (B, N*A): edge (node, action) of a game sits at node * A +
// action, so a node's A edges are one contiguous 28-byte row at A = 7. The
// TPU kernel places the leaf's prior row and the root's noisy prior on edge
// lanes with a matmul by a 0/1 fold matrix; here the row is written
// directly. Its argmax over the whole edge range and its line windows on the
// H x W board are kept (kV1). The kernel itself, its bound and its exactness
// argument are in puct_wave.cuh, shared with kernel K1 (fused_mcts_v2.cu).

#include "puct_wave.cuh"

namespace {

struct NodeMajor {
  static constexpr bool kV1 = true;
  __device__ static int edge(int node, int action, int actions, int nodes) {
    return node * actions + action;
  }
};

}  // namespace

extern "C" int fused_mcts_wave(
    const void* mixed, const void* renormed, const void* value,
    const void* root_board, void* prior, void* children, void* visits,
    void* value_sum, void* parent, void* parent_action, void* expanded,
    void* is_terminal, void* reward, void* node_count, void* leaf,
    void* leaf_terminal, void* leaf_board, int batch, int actions, int nodes,
    int height, int width, int n_in_row, float c_puct, int simulations,
    int wave, void* stream) {
  return puct_wave::launch<NodeMajor>(
      mixed, renormed, value, root_board, prior, children, visits, value_sum,
      parent, parent_action, expanded, is_terminal, reward, node_count, leaf,
      leaf_terminal, leaf_board, batch, actions, nodes, height, width,
      n_in_row, c_puct, simulations, wave, stream);
}
