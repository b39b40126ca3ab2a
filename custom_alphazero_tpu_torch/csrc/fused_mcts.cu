// Kernel K2: the wave step of the fused Connect-N search in the v1
// layout, for Hopper.
//
// Replaces the TPU kernel custom_alphazero_tpu/ops/fused_mcts.py::_wave_kernel
// (built in FusedConnectNSearch._kernel_call, pallas_call at :478) and the
// XLA ops around it in the search's wave loop. Edge
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

PUCT_WAVE_ENTRY(fused_mcts_wave, NodeMajor)
