// Kernel K1: the wave step of the fused Connect-N search in the v2
// layout, for Hopper.
//
// Replaces the TPU kernel custom_alphazero_tpu/ops/fused_mcts_v2.py::_wave_kernel
// (launched through FusedConnectNSearchV2._kernel_call, pallas_call at :394)
// and the XLA ops around it in the search's wave loop.
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

PUCT_WAVE_ENTRY(fused_mcts_v2_wave, ActionMajor)
