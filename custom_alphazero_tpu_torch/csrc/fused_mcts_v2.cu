// Kernel K1: the fused Connect-N search wave in the v2 layout, for Hopper.
//
// Replaces the TPU kernel custom_alphazero_tpu/ops/fused_mcts_v2.py::_wave_kernel
// (launched through FusedConnectNSearchV2._kernel_call, pallas_call at :394).
// Edge arrays are (B, A, N): edge (node, action) of a game sits at
// action * N + node. The kernel itself, its bound and its exactness argument
// are in puct_wave.cuh, shared with kernel K2 (fused_mcts.cu).

#include "puct_wave.cuh"

namespace {

struct ActionMajor {
  static constexpr bool kV1 = false;
  __device__ static int edge(int node, int action, int actions, int nodes) {
    return action * nodes + node;
  }
};

}  // namespace

extern "C" int fused_mcts_v2_wave(
    const void* mixed, const void* renormed, const void* value,
    const void* root_board, void* prior, void* children, void* visits,
    void* value_sum, void* parent, void* parent_action, void* expanded,
    void* is_terminal, void* reward, void* node_count, void* leaf,
    void* leaf_terminal, void* leaf_board, int batch, int actions, int nodes,
    int height, int width, int n_in_row, float c_puct, int simulations,
    int wave, void* stream) {
  return puct_wave::launch<ActionMajor>(
      mixed, renormed, value, root_board, prior, children, visits, value_sum,
      parent, parent_action, expanded, is_terminal, reward, node_count, leaf,
      leaf_terminal, leaf_board, batch, actions, nodes, height, width,
      n_in_row, c_puct, simulations, wave, stream);
}
