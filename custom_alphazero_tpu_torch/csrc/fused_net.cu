// The policy-value net's inference forward (ops/fused_net.py), for Hopper.
//
// Replaces no TPU kernel: the JAX package leaves the net to XLA, which fuses
// each layer's BatchNorm, bias, add and ReLU into the convolution on the
// TPU. On the card the module path ran each of those as a separate pass over
// the activation. Six kernels:
//
// - pack: every trunk conv weight, read from the live float32 parameters
//   through a table of addresses and rounded to bf16 (as autocast rounds
//   it), into one buffer: C_out rows of (tap, C_in), zero-padded to whole K
//   steps, the GEMM's K-major N x K operand. One launch a search (a
//   forward recorded into a graph), one an eager forward.
// - conv_kernel_ws: a block conv, bf16 input with C_in and filters
//   multiples of 64 (every block conv of a net the fused forward takes). An
//   implicit GEMM on NHWC activations: one GEMM row is one board cell,
//   M = B x H x W, N = filters, K = taps x C_in, each K step one tap's 64
//   channels. Warp-specialised: one producer thread keeps a ring of
//   shared-memory stages full by TMA, each stage with a full and an empty
//   mbarrier. A step's A tile is loaded in TMA's im2col mode (the tap is
//   the im2col offset; cells past the board's edges and the batch read the
//   out-of-bounds zeros: no im2col tensor, no thread computes an address or
//   a mask); its B tile is a box of the packed weight. Consumer warpgroups
//   wait on a stage's full barrier, issue wgmma (m64n128k16, both operands
//   128-byte swizzled, float32 sums in the packed weight's K order), keep
//   one group in flight and release the stage on its empty barrier: no
//   block-wide barrier in the K loop. A 1x1 projection's K loop runs
//   through the same ring into a second accumulator; an identity skip's
//   bf16 tile is loaded by TMA while the K loop runs. The epilogue, in
//   float32 from the live parameters and running statistics, applies the
//   conv's bias and eval-mode BatchNorm as one scale and offset a channel,
//   adds the skip, applies ReLU and writes bf16 (one rounding a layer)
//   through shared memory in 16-byte chunks. In a block with a
//   squeeze-excitation gate the second conv's epilogue stops after the
//   BatchNorm (kLinear: no skip, no ReLU) and se_kernel finishes the block.
//   ops/fused_net.py's ``conv_plan`` picks the tile, 128 or 192 cells by
//   128 filters, from the GEMM's shape. A nested bottleneck tower's convs
//   (pre-activation: each reads relu(n(y)) of the tensor before it) take
//   the pre-activation modes (kPre, kPreIdentity): the conv's bias and an
//   identity tile added, the sum rounded once as the skip stream and
//   relu(n) of the rounded value, n the next conv's norm, written beside
//   it, both staged through the ring; their 1x1 convs run as whole layers
//   of one tap, and outputs of 192 filters take 96-filter tiles
//   (wgmma m64n96k16; ``conv_tile``) where 128-filter ones would leave a
//   tile half empty.
// - conv_kernel: the stem, which reads the float32 observations over the
//   flat K = taps x C_in and rounds them to bf16 on load: every thread
//   gathers a run of K of one cell and a share of the weight (masked
//   cp.async), and the block meets at a barrier each K step; the same
//   epilogue, without a skip; before a nested bottleneck tower, a second
//   output with the first block's norm and ReLU.
// - se_kernel: a block's squeeze-excitation gate and the rest of the
//   block, once a block: out = relu(x + sigmoid(g) * y + o), g and o the
//   two halves of dense2(relu(dense1(mean of y over the board))), y the
//   second conv's bf16 output, x the block input. The mean over a
//   position's cells needs every cell of it, and a position's cells
//   straddle the conv's tiles, so the conv's epilogue cannot finish the
//   block. One CTA takes two positions (half the threads each): each
//   thread sums a 16-byte chunk of channels over a fixed set of cells, the
//   partial sums meet in shared memory in a fixed order (no atomics: a
//   forward repeats bit for bit), the dense layers read the live float32
//   weights and biases, copied to shared memory while the board is summed,
//   and the threads write the output in bf16 from the chunks of y and x
//   they hold in registers since their first load: one read of each.
// - gpool_kernel: a nested bottleneck tower's pooled inner block: the
//   mean, scaled mean and max of the pooled channels over each position's
//   cells (fixed order), the dense layer to a bias a regular channel, and
//   relu(n(r + bias)) of the regular channels r, the next conv's input; as
//   with se_kernel, a position's cells straddle the conv's tiles.
// - heads: the policy and value 1x1 convs (a few filters each) over the
//   trunk's bf16 output, one thread a board cell, with their BatchNorm and
//   ReLU, written in float32 for the dense layers.
//
// What bounds it on an H100: a c4-r5 forward at B=1,024 is 107.5 GFLOP,
// 0.109 ms at the bf16 peak, against about 0.074 ms of its bytes read and
// written once; the tensor cores bound it. Every layer is one launch with
// its whole epilogue in registers, so an activation is written once, in
// bf16, and read only by the next layer. A block conv whose threads compute
// every gather's address and mask, meeting at a barrier each step, stayed
// below a third of the peak feeding wgmma. With both operands loaded by
// TMA, builds without the A or without the B loads ran no faster at the
// 19 x 256 shape: what keeps conv_kernel_ws at 40-50% of the peak is each
// CTA's fixed cost (the pipeline's fill, the epilogue, about 5 us a round
// of CTAs) and the last round of tiles, which ``conv_plan`` weighs. A gated
// block adds se_kernel, about 9 us at B=256 with 256 filters beside the
// block's two 24 us convs: one CTA a SM, bound by the L2 traffic of every
// CTA's copy of the gate's float32 weights beside the activations, and by
// its phases in turn (loads, dense layers, output).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

// Both conv kernels' tiles are kBN filters wide, their K stages kBK = one
// 128-byte row of bf16. Both operands are K-major and 128-byte swizzled,
// the layout wgmma reads through its descriptors: 16-byte chunk j of row r
// sits at chunk j ^ (r % 8) of the row.
constexpr int kBN = 128;
constexpr int kBK = 64;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ int swizzled(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

// 16 bytes from global to shared memory; zeros where !ok (nothing read).
__device__ __forceinline__ void cp_async_cg(uint32_t dst, const void* src,
                                            bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared memory written by the threads (cp.async, st.shared), made visible
// to wgmma's reads.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma's descriptor of a K-major 128-byte-swizzled tile at ``addr``, its
// 8-row groups 1024 bytes apart (the tile 1024-aligned; a step of 16 K
// within the 128-byte rows adds 32 bytes to ``addr``).
__device__ __forceinline__ uint64_t descriptor(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// Keeps the compiler from moving the accumulators across wgmma's
// asynchronous window.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a,
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n96k16(float (&d)[48], uint64_t a,
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47}, "
      "%48, %49, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(a), "l"(b), "r"(1));
}

// A conv's bias and eval-mode BatchNorm: y = z * scale + offset. nvcc
// builds with -fmad=false, so each operation rounds as in the plain
// version.
struct BatchNormArgs {
  const float* bias;
  const float* gamma;
  const float* beta;
  const float* mean;
  const float* var;
};

__device__ __forceinline__ void fold(const BatchNormArgs& bn, int c, float eps,
                                     float* scale, float* offset) {
  const float s = bn.gamma[c] / sqrtf(bn.var[c] + eps);
  *scale = s;
  *offset = (bn.bias[c] - bn.mean[c]) * s + bn.beta[c];
}

__host__ __device__ __forceinline__ int padded_depth(int depth) {
  return (depth + kBK - 1) / kBK * kBK;
}

// How a block conv's output takes a residual block's skip path (the entry
// point's ``residual``); kLinear: neither a skip nor ReLU, the second conv
// of a block whose squeeze-excitation gate se_kernel applies.
// kPre and kPreIdentity: a nested bottleneck tower's pre-activation
// epilogue, the conv's bias (and r itself, an identity tile) added, then two
// outputs: the rounded sum (the skip stream) and relu(n(that)) with the next
// conv's norm n (its input), either one absent.
enum Skip {
  kNoSkip = 0,
  kProjection = 1,
  kIdentity = 2,
  kLinear = 3,
  kPre = 4,
  kPreIdentity = 5
};

// ---------------------------------------------------------------------------
// The stem (conv_kernel): float32 observations x (B*H*W rows of C
// channels), its packed weight w (N rows of padded_depth(taps x C) in (tap,
// channel) order), the kernel size ks (odd, "same" padding).
// ---------------------------------------------------------------------------

// The stem's tile: 64 board cells (one warpgroup, four warps of 16 cells)
// by kBN filters, one thread a filter in the epilogue; a ring of kStages K
// stages in shared memory after the epilogue's scales and offsets.
struct Stem {
  static constexpr int BM = 64;
  static constexpr int kThreads = 128;
  static constexpr int kStages = 3;
  static constexpr int kATile = BM * kBK * 2;  // bytes
  static constexpr int kBTile = kBN * kBK * 2;
  static constexpr int kStage = kATile + kBTile;  // a multiple of 1024
  static constexpr int kFold = 4 * kBN * 4;       // a multiple of 1024
  static constexpr int kSmem = kFold + kStages * kStage;
  static_assert(kThreads == kBN, "one thread a filter of the tile");
};

struct StemInput {
  const float* x;
  const bf16* w;
  int C;
  int ks;
};

// The stem's K loop: K runs over taps x C_in as one flat index; each thread
// gathers a run of kRun consecutive K of one cell from float32 and rounds
// it to bf16 (the packed weight's padding is zeros).
__device__ __forceinline__ void stem_k_loop(const StemInput& op, int M, int H,
                                            int W, int N, int m0, int n0,
                                            unsigned char* tiles,
                                            float (&acc)[64]) {
  constexpr int kStages = Stem::kStages;
  constexpr int kStage = Stem::kStage;
  constexpr int kRun = Stem::BM * kBK / Stem::kThreads;
  const int tid = threadIdx.x;
  const int C = op.C;
  const int ks = op.ks;
  const int pad = ks / 2;
  const int depth = ks * ks * C;
  const int kp = padded_depth(depth);
  const int steps = kp / kBK;
  const uint32_t base = smem_addr(tiles);

  // This thread's cell, row tid / 2 of the tile, and its K run, (tid % 2) *
  // kRun of each step.
  const int r = tid / 2;
  const int kk = (tid % 2) * kRun;
  const int a_m = m0 + r;
  const int cell = a_m % (H * W);
  const int a_h = cell / W;
  const int a_w = cell % W;

  auto load = [&](int step, int stage) {
    const uint32_t b_tile = base + stage * kStage + Stem::kATile;
    unsigned char* a_ptr = tiles + stage * kStage;
    const int chunk = tid % 8;
    int k = step * kBK + kk;
    int tap = k / C;
    int c = k - tap * C;
    int dh = tap / ks - pad, dw = tap % ks - pad;
    // All the run's loads first, then the rounding: the loads are in
    // flight together.
    float v[kRun];
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      const int hh = a_h + dh;
      const int ww = a_w + dw;
      const bool ok =
          a_m < M && k < depth && hh >= 0 && hh < H && ww >= 0 && ww < W;
      v[j] = ok ? op.x[(long long)(a_m + dh * W + dw) * C + c] : 0.0f;
      ++k;
      if (++c == C) {
        c = 0;
        ++tap;
        dh = tap / ks - pad;
        dw = tap % ks - pad;
      }
    }
    uint32_t packed[kRun / 2];
#pragma unroll
    for (int j = 0; j < kRun; j += 2) {
      __nv_bfloat162 pair = __floats2bfloat162_rn(v[j], v[j + 1]);
      packed[j / 2] = *reinterpret_cast<uint32_t*>(&pair);
    }
#pragma unroll
    for (int j = 0; j < kRun / 8; ++j)
      *reinterpret_cast<uint4*>(a_ptr + swizzled(r, kk / 8 + j)) =
          make_uint4(packed[4 * j], packed[4 * j + 1], packed[4 * j + 2],
                     packed[4 * j + 3]);
    const int k_col = step * kBK;  // the packed weight's first column
#pragma unroll
    for (int i = 0; i < kBN * 8 / Stem::kThreads; ++i) {
      const int n = tid / 8 + 16 * i;
      const bool ok = n0 + n < N;
      const bf16* src =
          ok ? op.w + (long long)(n0 + n) * kp + k_col + chunk * 8 : op.w;
      cp_async_cg(b_tile + swizzled(n, chunk), src, ok);
    }
  };

  // wgmma keeps one step's group in flight while the next is queued, so a
  // stage is refilled two steps after it was read: kStages - 2 steps of
  // loads in flight ahead of the wgmma.
  constexpr int kAhead = kStages - 2;
#pragma unroll
  for (int s = 0; s < kAhead; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < steps; ++kt) {
    cp_async_wait<kAhead - 1>();
    fence_async_shared();
    __syncthreads();
    const int next = kt + kAhead;
    if (next < steps) load(next, next % kStages);
    cp_async_commit();
    const uint32_t a_tile = base + (kt % kStages) * kStage;
    const uint32_t b_tile = a_tile + Stem::kATile;
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_m64n128k16(acc, descriptor(a_tile + 32 * kk),
                       descriptor(b_tile + 32 * kk));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    fence_acc(acc);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(acc);
  cp_async_wait<0>();
  __syncthreads();
}

// One (64 x kBN) tile of the stem's output: relu(bn(conv(x))); with out2,
// also relu(nbn(y)) of the rounded output y into out2 (nbn's bias unread).
__global__ void __launch_bounds__(Stem::kThreads)
    conv_kernel(StemInput op, BatchNormArgs bn, BatchNormArgs nbn,
                bf16* __restrict__ out, bf16* __restrict__ out2, int M, int H,
                int W, int N, float eps) {
  extern __shared__ __align__(1024) unsigned char smem[];
  float* s_scale = reinterpret_cast<float*>(smem);
  float* s_offset = s_scale + kBN;
  float* n_scale = s_offset + kBN;
  float* n_offset = n_scale + kBN;
  unsigned char* tiles = smem + Stem::kFold;
  if (smem_addr(tiles) % 1024 != 0) __trap();  // the swizzle needs it
  const int m0 = blockIdx.x * Stem::BM;
  const int n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  // The epilogue's parameters of filter n0 + tid, loaded now and folded
  // after the K loop, so their latency overlaps it.
  float p[5] = {0.0f, 0.0f, 0.0f, 0.0f, 1.0f};
  const bool has_col = n0 + tid < N;
  if (has_col) {
    p[0] = bn.bias[n0 + tid];
    p[1] = bn.gamma[n0 + tid];
    p[2] = bn.beta[n0 + tid];
    p[3] = bn.mean[n0 + tid];
    p[4] = bn.var[n0 + tid];
  }
  float q[4] = {0.0f, 0.0f, 0.0f, 1.0f};  // the next norm's, for out2
  if (out2 != nullptr && has_col) {
    q[0] = nbn.gamma[n0 + tid];
    q[1] = nbn.beta[n0 + tid];
    q[2] = nbn.mean[n0 + tid];
    q[3] = nbn.var[n0 + tid];
  }

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  stem_k_loop(op, M, H, W, N, m0, n0, tiles, acc);

  float s = 0.0f, o = 0.0f;
  if (has_col) {
    s = p[1] / sqrtf(p[4] + eps);
    o = (p[0] - p[3]) * s + p[2];
  }
  s_scale[tid] = s;
  s_offset[tid] = o;
  if (out2 != nullptr) {
    const float ns = has_col ? q[0] / sqrtf(q[3] + eps) : 0.0f;
    n_scale[tid] = ns;
    n_offset[tid] = has_col ? (0.0f - q[2]) * ns + q[1] : 0.0f;
  }
  __syncthreads();

  // wgmma's accumulator layout: warp w holds cells 16 w to 16 w + 15; for
  // each 8 filters j, d[4j], d[4j+1] are cell lane / 4, filters 8 j +
  // 2 (lane % 4) and the next; d[4j+2], d[4j+3] the same 8 cells on. The
  // tile goes through shared memory (rows padded by 16 bytes, on distinct
  // banks) and out in 16-byte chunks, two rows a warp.
  constexpr int kOutStride = kBN + 8;
  bf16* staged = reinterpret_cast<bf16*>(tiles);
  const int lane = tid & 31;
  const int row0 = (tid >> 5) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int f = 8 * j + 2 * (lane & 3);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float v0 = acc[4 * j + 2 * half] * s_scale[f] + s_offset[f];
      const float v1 =
          acc[4 * j + 2 * half + 1] * s_scale[f + 1] + s_offset[f + 1];
      *reinterpret_cast<__nv_bfloat162*>(
          staged + (row0 + 8 * half) * kOutStride + f) =
          __floats2bfloat162_rn(fmaxf(v0, 0.0f), fmaxf(v1, 0.0f));
    }
  }
  __syncthreads();
  for (int e = tid; e < Stem::BM * kBN / 8; e += Stem::kThreads) {
    const int r = e / (kBN / 8);
    const int col = n0 + (e % (kBN / 8)) * 8;
    if (m0 + r < M && col < N)
      *reinterpret_cast<uint4*>(out + (long long)(m0 + r) * N + col) =
          *reinterpret_cast<const uint4*>(staged + r * kOutStride + col - n0);
  }
  if (out2 == nullptr) return;
  // The second output, the next norm and ReLU of each rounded value, staged
  // the same way once every thread has written its share of the first.
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int f = 8 * j + 2 * (lane & 3);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float v0 = acc[4 * j + 2 * half] * s_scale[f] + s_offset[f];
      const float v1 =
          acc[4 * j + 2 * half + 1] * s_scale[f + 1] + s_offset[f + 1];
      const float2 y = __bfloat1622float2(
          __floats2bfloat162_rn(fmaxf(v0, 0.0f), fmaxf(v1, 0.0f)));
      *reinterpret_cast<__nv_bfloat162*>(
          staged + (row0 + 8 * half) * kOutStride + f) =
          __floats2bfloat162_rn(
              fmaxf(y.x * n_scale[f] + n_offset[f], 0.0f),
              fmaxf(y.y * n_scale[f + 1] + n_offset[f + 1], 0.0f));
    }
  }
  __syncthreads();
  for (int e = tid; e < Stem::BM * kBN / 8; e += Stem::kThreads) {
    const int r = e / (kBN / 8);
    const int col = n0 + (e % (kBN / 8)) * 8;
    if (m0 + r < M && col < N)
      *reinterpret_cast<uint4*>(out2 + (long long)(m0 + r) * N + col) =
          *reinterpret_cast<const uint4*>(staged + r * kOutStride + col - n0);
  }
}

// ---------------------------------------------------------------------------
// The block conv (conv_kernel_ws): bf16 input, C_in and N multiples of kBK,
// so that every K step is one tap's whole 64-channel slice (one 128-byte
// row of each operand).
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Waits for the completion of the barrier's phase of parity ``parity``. A
// wait that outlasts 2^26 tries (seconds, where a step takes microseconds)
// traps: a fault in the pipeline's accounting ends the launch with an error
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One arrival, with the transaction bytes the phase still waits for.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// The 2-D box at (x0, x1) of ``map`` into ``dst``, completing on ``bar``.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int x0, int x1, uint32_t bar) {
  const uint64_t desc = reinterpret_cast<uint64_t>(map);
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(desc), "r"(bar), "r"(x0), "r"(x1)
      : "memory");
}

// Fetches a TMA descriptor ahead of its first load.
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// One tap's channels c..c+63 of a column of cells (``map``'s pixels per
// column) into ``dst``: the column's first cell's receptive field starts
// at (w, h) of image n, and the tap reads it at offset (dw, dh); cells past
// the board's edges and past the batch read zeros.
__device__ __forceinline__ void tma_load_im2col(uint32_t dst,
                                                const CUtensorMap* map, int c,
                                                int w, int h, int n,
                                                uint16_t dw, uint16_t dh,
                                                uint32_t bar) {
  const uint64_t desc = reinterpret_cast<uint64_t>(map);
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2], {%7, %8};\n"
      ::"r"(dst), "l"(desc), "r"(bar), "r"(c), "r"(w), "r"(h), "r"(n),
      "h"(dw), "h"(dh)
      : "memory");
}

// A pipelined tile: BM = 64 x WG board cells (WG consumer warpgroups, which
// share each weight stage) by BN filters (kBN, or 96 for outputs of 192 that
// would leave a 128-filter tile half empty), and one producer warp. A ring
// of kStages stages in shared memory, each the step's A tile (BM cells x 64
// channels) and B tile (BN filters x 64 K), 128-byte swizzled; the
// identity skip's tile beside it (swizzled boxes of BM rows x 64 filters,
// two for either width).
template <int WG_, int SKIP_, int BN_ = kBN>
struct Pipe {
  static constexpr int WG = WG_;
  static constexpr int SKIP = SKIP_;
  static constexpr int BN = BN_;
  static constexpr int kAcc = BN / 2;  // accumulators a consumer thread
  static constexpr int BM = 64 * WG;
  static constexpr int kConsumers = 128 * WG;
  static constexpr int kThreads = kConsumers + 32;
  static constexpr int kATile = BM * 128;  // bytes
  static constexpr int kBTile = BN * 128;
  static constexpr int kStage = kATile + kBTile;
  static constexpr int kRow = BN + 8;  // staged output rows, bf16
  // An identity tile beside the ring; two staged outputs (the skip stream
  // and its activation) in the pre-activation modes.
  static constexpr bool kTile = SKIP == kIdentity || SKIP == kPreIdentity;
  static constexpr bool kPreAct = SKIP == kPre || SKIP == kPreIdentity;
  static constexpr int kOutputs = kPreAct ? 2 : 1;
  static constexpr int kSkipBoxes = (BN + 63) / 64;
  static constexpr int kSkip = kTile ? BM * 128 * kSkipBoxes : 0;
  static constexpr int kMaxStages = 6;
  // The epilogue's four arrays of BN floats, then the barriers.
  static constexpr int kHead =
      (16 * BN + 8 * (2 * kMaxStages + 1) + 1023) / 1024 * 1024;
  static constexpr int kFit = (227 * 1024 - kHead - kSkip) / kStage;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kSmem = kHead + kStages * kStage + kSkip;
  static_assert(kStages >= 2, "a ring of at least two stages");
  static_assert(kOutputs * BM * kRow * 2 <= kStages * kStage,
                "staging fits the ring");
  static_assert(kConsumers >= BN, "a consumer thread a filter");
  static_assert(BN == kBN || (BN == 96 && SKIP != kProjection),
                "the projection's second accumulator takes kBN filters");
};

// The producer's side of one K loop (one thread): for each step, wait until
// the consumers have released the ring's stage, expect the stage's bytes,
// load the A tile (one tap's 64 channels of the tile's shifted cells, by
// TMA in im2col mode: zeros past the board's edges) and the B tile. ``t``
// counts steps over both loops; ``side()`` runs once the ring's first
// stages are in flight.
template <class P, class Side>
__device__ __forceinline__ void produce(const CUtensorMap* xmap,
                                        const CUtensorMap* wmap, int C, int ks,
                                        int steps, int& t, int h0, int w0,
                                        int b0, int n0, uint32_t ring,
                                        uint32_t full0, uint32_t empty0,
                                        Side side) {
  const int pad = ks / 2;
  int dh = 0, dw = 0, c0 = 0, k_col = 0;  // the tap's offsets from (h0, w0)
  for (int i = 0; i < steps; ++i, ++t) {
    const int s = t % P::kStages;
    const uint32_t full = full0 + 8 * s;
    mbar_wait(empty0 + 8 * s, ((t / P::kStages) & 1) ^ 1);
    const uint32_t a_tile = ring + s * P::kStage;
    mbar_expect_tx(full, P::kStage);
    tma_load_im2col(a_tile, xmap, c0, w0 - pad, h0 - pad, b0,
                    static_cast<uint16_t>(dw), static_cast<uint16_t>(dh),
                    full);
    tma_load(a_tile + P::kATile, wmap, k_col, n0, full);
    if (i == (steps < P::kStages ? steps : P::kStages) - 1) side();
    k_col += kBK;
    c0 += kBK;
    if (c0 == C) {
      c0 = 0;
      if (++dw == ks) {
        dw = 0;
        ++dh;
      }
    }
  }
}

// The consumers' side of one K loop into ``acc``: wait for a stage, issue
// the step's four wgmma (one group), keep it in flight while the previous
// group completes, then release the previous step's stage (lane 0 of each
// warp arrives).
template <class P>
__device__ __forceinline__ void consume(int steps, int& t, uint32_t ring,
                                        uint32_t full0, uint32_t empty0,
                                        int wg, int lane,
                                        float (&acc)[P::kAcc]) {
  for (int i = 0; i < steps; ++i, ++t) {
    const int s = t % P::kStages;
    mbar_wait(full0 + 8 * s, (t / P::kStages) & 1);
    const uint32_t a_tile = ring + s * P::kStage + wg * 64 * 128;
    const uint32_t b_tile = ring + s * P::kStage + P::kATile;
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      if constexpr (P::BN == 96)
        wgmma_m64n96k16(acc, descriptor(a_tile + 32 * kk),
                        descriptor(b_tile + 32 * kk));
      else
        wgmma_m64n128k16(acc, descriptor(a_tile + 32 * kk),
                         descriptor(b_tile + 32 * kk));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    fence_acc(acc);
    if (t > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((t - 1) % P::kStages));
  }
}

// The TMA maps of one pipelined launch: the packed weight (``w``) and the
// input's im2col view (``x``) of the conv, the same of the 1x1 projection
// (``rw``, ``rx``), and the identity skip's tiles (``skip``). Unused maps
// repeat ``w``.
struct Maps {
  CUtensorMap w, x, rw, rx, skip;
};

// One (BM x BN) tile of a block conv's output, relu(bn(conv(x)) + skip),
// skip bn_r(proj(r)) (kProjection), r itself (kIdentity) or nothing; or
// bn(conv(x)) alone (kLinear); fed by a producer warp. In the
// pre-activation modes y = conv(x) + bias (+ r, kPreIdentity), rounded,
// into out, and relu(n(y)) of the rounded y into out2, n the norm in rbn
// (its bias unread); a null out or out2 is not written.
template <class P>
__global__ void __launch_bounds__(P::kThreads)
    conv_kernel_ws(const __grid_constant__ Maps maps, int C, int ks,
                   BatchNormArgs bn, BatchNormArgs rbn,
                   bf16* __restrict__ out, bf16* __restrict__ out2, int M,
                   int H, int W, int N, float eps) {
  constexpr int S = P::kStages;
  extern __shared__ __align__(1024) unsigned char smem[];
  float* s_scale = reinterpret_cast<float*>(smem);
  float* s_offset = s_scale + P::BN;
  float* r_scale = s_offset + P::BN;
  float* r_offset = r_scale + P::BN;
  const uint32_t full0 = smem_addr(smem + 16 * P::BN);
  const uint32_t empty0 = full0 + 8 * S;
  const uint32_t skip_bar = empty0 + 8 * S;
  unsigned char* ring_ptr = smem + P::kHead;
  const uint32_t ring = smem_addr(ring_ptr);
  unsigned char* skip_tile = ring_ptr + S * P::kStage;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * P::BM;
  const int n0 = blockIdx.y * P::BN;
  if (tid == 0) {
    if (ring % 1024 != 0) __trap();  // the swizzle needs it
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 1);           // the producer's expect_tx
      mbar_init(empty0 + 8 * s, 4 * P::WG);  // each consumer warp
    }
    mbar_init(skip_bar, 1);
    // The initialisations visible to the TMA unit's arrivals.
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int steps = ks * ks * (C / kBK);
  const int rsteps = P::SKIP == kProjection ? N / kBK : 0;

  if (tid >= P::kConsumers) {
    if (tid == P::kConsumers) {
      const int hw = H * W;
      const int b0 = m0 / hw;
      const int h0 = (m0 % hw) / W;
      const int w0 = m0 % W;
      prefetch_map(&maps.x);
      prefetch_map(&maps.w);
      if constexpr (P::SKIP == kProjection) {
        prefetch_map(&maps.rx);
        prefetch_map(&maps.rw);
      }
      if constexpr (P::kTile) prefetch_map(&maps.skip);
      int t = 0;
      // The identity skip's tile, loaded while the K loop runs.
      auto skip = [&]() {
        if constexpr (P::kTile) {
          mbar_expect_tx(skip_bar, P::kSkip);
          for (int b = 0; b < P::kSkipBoxes; ++b)
            tma_load(smem_addr(skip_tile) + b * P::BM * 128, &maps.skip,
                     n0 + 64 * b, m0, skip_bar);
        }
      };
      produce<P>(&maps.x, &maps.w, C, ks, steps, t, h0, w0, b0, n0, ring,
                 full0, empty0, skip);
      if constexpr (P::SKIP == kProjection)
        produce<P>(&maps.rx, &maps.rw, N, 1, rsteps, t, h0, w0, b0, n0, ring,
                   full0, empty0, [] {});
    }
    __syncwarp();
  } else {
    const int wg = tid / 128;
    const int lane = tid & 31;
    // The epilogue's parameters of filter n0 + tid (threads past the tile's
    // filters hold none), loaded now and folded after the K loop, so that
    // their latency overlaps it: bias, gamma, beta, mean and var of the
    // conv (and of the projection).
    constexpr int kGroups = P::SKIP == kProjection || P::kPreAct ? 2 : 1;
    const int n = n0 + tid;
    const bool real = tid < P::BN && n < N;
    float prm[kGroups][5];
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const BatchNormArgs& a = g == 0 ? bn : rbn;
      prm[g][0] = real ? a.bias[n] : 0.0f;
      prm[g][1] = real ? a.gamma[n] : 0.0f;
      prm[g][2] = real ? a.beta[n] : 0.0f;
      prm[g][3] = real ? a.mean[n] : 0.0f;
      prm[g][4] = real ? a.var[n] : 1.0f;
    }
    float acc[P::kAcc];
#pragma unroll
    for (int i = 0; i < P::kAcc; ++i) acc[i] = 0.0f;
    int t = 0;
    consume<P>(steps, t, ring, full0, empty0, wg, lane, acc);
    float racc[P::SKIP == kProjection ? 64 : 1];
    if constexpr (P::SKIP == kProjection) {
#pragma unroll
      for (int i = 0; i < 64; ++i) racc[i] = 0.0f;
      consume<P>(rsteps, t, ring, full0, empty0, wg, lane, racc);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
    if constexpr (P::SKIP == kProjection) fence_acc(racc);
    if (lane == 0) mbar_arrive(empty0 + 8 * ((t - 1) % S));
    // Each filter's scale and offset (fold's arithmetic), zero past N; in
    // the pre-activation modes the conv's bias (s_offset) and the next
    // norm's scale and offset (r_scale, r_offset).
    if constexpr (P::kPreAct) {
      if (tid < P::BN) {
        s_offset[tid] = prm[0][0];
        const float sc = real ? prm[1][1] / sqrtf(prm[1][4] + eps) : 0.0f;
        r_scale[tid] = sc;
        r_offset[tid] = real ? (0.0f - prm[1][3]) * sc + prm[1][2] : 0.0f;
      }
    } else if (tid < P::BN) {
      float* folded[2][2] = {{s_scale, s_offset}, {r_scale, r_offset}};
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        float sc = 0.0f, of = 0.0f;
        if (g < kGroups) {
          const float* q = prm[g < kGroups ? g : 0];
          sc = q[1] / sqrtf(q[4] + eps);
          of = (q[0] - q[3]) * sc + q[2];
        }
        folded[g][0][tid] = sc;
        folded[g][1][tid] = of;
      }
    }
    // Every consumer is past the ring and the scales are written: the ring
    // stages the output.
    asm volatile("bar.sync 1, %0;\n" ::"n"(P::kConsumers) : "memory");
    if constexpr (P::kTile) mbar_wait(skip_bar, 0);
    bf16* staged = reinterpret_cast<bf16*>(ring_ptr);
    bf16* staged2 = staged + P::BM * P::kRow;  // the activation, kPreAct
    const int row0 = (tid >> 5) * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < P::BN / 8; ++j) {
      const int f = 8 * j + 2 * (lane & 3);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + 8 * half;
        const int i = 4 * j + 2 * half;
        float v0, v1;
        if constexpr (P::kPreAct) {
          v0 = acc[i] + s_offset[f];
          v1 = acc[i + 1] + s_offset[f + 1];
        } else {
          v0 = acc[i] * s_scale[f] + s_offset[f];
          v1 = acc[i + 1] * s_scale[f + 1] + s_offset[f + 1];
        }
        if constexpr (P::SKIP == kProjection) {
          v0 += racc[i] * r_scale[f] + r_offset[f];
          v1 += racc[i + 1] * r_scale[f + 1] + r_offset[f + 1];
        }
        if constexpr (P::kTile) {
          // Filter f of the row: box f / 64, 16-byte chunk (f % 64) / 8
          // swizzled by the row.
          const int cf = f & 63;
          const float2 rv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(
                  skip_tile + (f >> 6) * P::BM * 128 + row * 128 +
                  (((cf >> 3) ^ (row & 7)) << 4) + (cf & 7) * 2));
          v0 += rv.x;
          v1 += rv.y;
        }
        if constexpr (P::kPreAct) {
          const __nv_bfloat162 y = __floats2bfloat162_rn(v0, v1);
          *reinterpret_cast<__nv_bfloat162*>(staged + row * P::kRow + f) = y;
          const float2 yf = __bfloat1622float2(y);
          *reinterpret_cast<__nv_bfloat162*>(staged2 + row * P::kRow + f) =
              __floats2bfloat162_rn(
                  fmaxf(yf.x * r_scale[f] + r_offset[f], 0.0f),
                  fmaxf(yf.y * r_scale[f + 1] + r_offset[f + 1], 0.0f));
          continue;
        }
        if constexpr (P::SKIP != kLinear) {
          v0 = fmaxf(v0, 0.0f);
          v1 = fmaxf(v1, 0.0f);
        }
        *reinterpret_cast<__nv_bfloat162*>(staged + row * P::kRow + f) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(P::kConsumers) : "memory");
    if constexpr (P::kPreAct) {
#pragma unroll
      for (int o = 0; o < 2; ++o) {
        bf16* dst = o == 0 ? out : out2;
        const bf16* src = o == 0 ? staged : staged2;
        if (dst == nullptr) continue;
        for (int e = tid; e < P::BM * P::BN / 8; e += P::kConsumers) {
          const int row = e / (P::BN / 8);
          const int col = n0 + (e % (P::BN / 8)) * 8;
          if (m0 + row < M && col < N)
            *reinterpret_cast<uint4*>(dst + (long long)(m0 + row) * N +
                                      col) =
                *reinterpret_cast<const uint4*>(src + row * P::kRow + col -
                                                n0);
        }
      }
      return;
    }
    for (int e = tid; e < P::BM * P::BN / 8; e += P::kConsumers) {
      const int row = e / (P::BN / 8);
      const int col = n0 + (e % (P::BN / 8)) * 8;
      if (m0 + row < M && col < N)
        *reinterpret_cast<uint4*>(out + (long long)(m0 + row) * N + col) =
            *reinterpret_cast<const uint4*>(staged + row * P::kRow + col -
                                            n0);
    }
  }
}

// The driver's tensor-map encoders, through the runtime (no link to
// libcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);
typedef CUresult (*EncodeIm2col)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const int*, const int*, cuuint32_t,
                                 cuuint32_t, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

void* driver_function(const char* name) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  cudaError_t err = cudaGetDriverEntryPointByVersion(
      name, &p, 12000, cudaEnableDefault, &found);
#else
  cudaError_t err =
      cudaGetDriverEntryPoint(name, &p, cudaEnableDefault, &found);
#endif
  return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? p
                                                                     : nullptr;
}

// A row-major (rows x cols) bf16 matrix as a TMA map of 64-column boxes of
// box_rows rows, 128-byte swizzled as wgmma reads them; boxes past the
// matrix fill zeros.
bool tiled_map(CUtensorMap* map, const bf16* a, int rows, int cols,
               int box_rows) {
  static const EncodeTiled encode =
      reinterpret_cast<EncodeTiled>(driver_function("cuTensorMapEncodeTiled"));
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {kBK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<bf16*>(a), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// NHWC x ((B, H, W, C) bf16) as a TMA map in im2col mode for a ks x ks
// "same" conv: columns of ``pixels`` cells in (b, h, w) order, 64 channels
// each, 128-byte swizzled; a cell's receptive field starts at (w - pad,
// h - pad), and every (w, h) a tap reads off the board fills zeros.
bool im2col_map(CUtensorMap* map, const bf16* x, int B, int H, int W, int C,
                int ks, int pixels) {
  static const EncodeIm2col encode = reinterpret_cast<EncodeIm2col>(
      driver_function("cuTensorMapEncodeIm2col"));
  if (encode == nullptr) return false;
  const int pad = ks / 2;
  const cuuint64_t dims[4] = {
      static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(W),
      static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(C) * 2,
                                 static_cast<cuuint64_t>(W) * C * 2,
                                 static_cast<cuuint64_t>(H) * W * C * 2};
  const int lower[2] = {-pad, -pad};
  const int upper[2] = {pad - (ks - 1), pad - (ks - 1)};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<bf16*>(x), dims, strides, lower, upper, kBK,
                static_cast<cuuint32_t>(pixels), unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <class P>
cudaError_t launch_ws(const bf16* x, const bf16* w, int C, int ks,
                      const BatchNormArgs& bn, const bf16* r, const bf16* wr,
                      const BatchNormArgs& rbn, bf16* out, bf16* out2, int M,
                      int H, int W, int N, float eps, cudaStream_t stream) {
  auto kernel = conv_kernel_ws<P>;
  static bool sized = false;  // above 48 KB: once per kernel, before use
  if (!sized) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  const int B = M / (H * W);
  Maps maps;
  bool ok = tiled_map(&maps.w, w, N, ks * ks * C, P::BN) &&
            im2col_map(&maps.x, x, B, H, W, C, ks, P::BM);
  maps.rw = maps.rx = maps.skip = maps.w;
  if (P::SKIP == kProjection)
    ok = ok && tiled_map(&maps.rw, wr, N, N, kBN) &&
         im2col_map(&maps.rx, r, B, H, W, N, 1, P::BM);
  if (P::kTile) ok = ok && tiled_map(&maps.skip, r, M, N, P::BM);
  if (!ok) return cudaErrorInvalidValue;
  const dim3 grid((M + P::BM - 1) / P::BM, (N + P::BN - 1) / P::BN);
  kernel<<<grid, P::kThreads, P::kSmem, stream>>>(maps, C, ks, bn, rbn, out,
                                                  out2, M, H, W, N, eps);
  return cudaGetLastError();
}

// The tiles' instances: a projection's second accumulator only on
// 128-cell tiles (two warpgroups); 96-filter tiles only for the modes of a
// nested bottleneck tower's 192-filter convs.
template <int WG, int BN>
cudaError_t launch_ws_skip(const bf16* x, const bf16* w, int C, int ks,
                           const BatchNormArgs& bn, const bf16* r,
                           const bf16* wr, const BatchNormArgs& rbn,
                           int residual, bf16* out, bf16* out2, int M, int H,
                           int W, int N, float eps, cudaStream_t s) {
  if constexpr (BN != kBN) {
    switch (residual) {
      case kNoSkip:
        return launch_ws<Pipe<WG, kNoSkip, BN>>(x, w, C, ks, bn, r, wr, rbn,
                                                out, out2, M, H, W, N, eps,
                                                s);
      case kPre:
        return launch_ws<Pipe<WG, kPre, BN>>(x, w, C, ks, bn, r, wr, rbn,
                                             out, out2, M, H, W, N, eps, s);
      case kPreIdentity:
        return launch_ws<Pipe<WG, kPreIdentity, BN>>(
            x, w, C, ks, bn, r, wr, rbn, out, out2, M, H, W, N, eps, s);
    }
    return cudaErrorInvalidValue;
  }
  switch (residual) {
    case kNoSkip:
      return launch_ws<Pipe<WG, kNoSkip>>(x, w, C, ks, bn, r, wr, rbn, out,
                                          out2, M, H, W, N, eps, s);
    case kProjection:
      if constexpr (WG == 2)
        return launch_ws<Pipe<WG, kProjection>>(x, w, C, ks, bn, r, wr, rbn,
                                                out, out2, M, H, W, N, eps,
                                                s);
      break;
    case kIdentity:
      return launch_ws<Pipe<WG, kIdentity>>(x, w, C, ks, bn, r, wr, rbn, out,
                                            out2, M, H, W, N, eps, s);
    case kLinear:
      return launch_ws<Pipe<WG, kLinear>>(x, w, C, ks, bn, r, wr, rbn, out,
                                          out2, M, H, W, N, eps, s);
    case kPre:
      return launch_ws<Pipe<WG, kPre>>(x, w, C, ks, bn, r, wr, rbn, out,
                                       out2, M, H, W, N, eps, s);
    case kPreIdentity:
      return launch_ws<Pipe<WG, kPreIdentity>>(x, w, C, ks, bn, r, wr, rbn,
                                               out, out2, M, H, W, N, eps, s);
  }
  return cudaErrorInvalidValue;
}

// se_kernel: a block's squeeze-excitation gate over (B, HW cells, C) bf16
// rows, kSePositions positions a CTA, kSeHalf threads a position. A thread
// owns one 16-byte chunk q of a cell's C channels (C / 8 chunks, which
// divide kSeHalf) and the cells g, g + G, ... (G = kSeHalf / (C / 8)); it
// keeps the first kSeHeld of them, of y and of x, in registers from their
// one load, all in flight at once, to the output. The dense layers' weights,
// W1 (R, C) and W2 (2C, R) in torch's layout (R a multiple of 4), and
// biases are copied to shared memory by TMA bulk copies meanwhile; the
// dense layers read them in 16-byte vectors, each weight once for both
// positions.
constexpr int kSeHalf = 128;
constexpr int kSePositions = 2;
constexpr int kSeThreads = kSeHalf * kSePositions;
constexpr int kSeHeld = 12;

// The shared floats of a CTA: the copy's mbarrier (4 floats), W1, W2, b1
// and b2, then the partial sums (G rows of C a position), the means, the
// hidden units, the scales and the offsets.
inline int se_smem_floats(int C, int R) {
  const int G = kSeHalf / (C / 8);
  return 4 + 3 * R * C + R + 2 * C + kSePositions * (G * C + 3 * C + R);
}

// ``bytes`` (a multiple of 16) from global to shared memory in one TMA
// bulk copy, completing on ``bar``.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void se_add(float (&sum)[8], const uint4& raw) {
  const bf16* v = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) sum[i] += __bfloat162float(v[i]);
}

// relu((x + scale * y) + offset) of one 16-byte chunk, in bf16.
__device__ __forceinline__ uint4 se_out(const uint4& xr, const uint4& yr,
                                        const float (&fs)[8],
                                        const float (&fo)[8]) {
  const __nv_bfloat162* xv = reinterpret_cast<const __nv_bfloat162*>(&xr);
  const __nv_bfloat162* yv = reinterpret_cast<const __nv_bfloat162*>(&yr);
  uint4 res;
  __nv_bfloat162* rv = reinterpret_cast<__nv_bfloat162*>(&res);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 a = __bfloat1622float2(xv[i]);
    const float2 b = __bfloat1622float2(yv[i]);
    const float v0 = a.x + fs[2 * i] * b.x + fo[2 * i];
    const float v1 = a.y + fs[2 * i + 1] * b.y + fo[2 * i + 1];
    rv[i] = __floats2bfloat162_rn(fmaxf(v0, 0.0f), fmaxf(v1, 0.0f));
  }
  return res;
}

__global__ void __launch_bounds__(kSeThreads)
    se_kernel(const bf16* __restrict__ x, const bf16* __restrict__ y, int B,
              int HW, int C, int R, const float* __restrict__ w1,
              const float* __restrict__ b1, const float* __restrict__ w2,
              const float* __restrict__ b2, bf16* __restrict__ out) {
  static_assert(kSePositions == 2, "the dense layers take two positions");
  extern __shared__ __align__(16) float s_se[];
  const int Q = C / 8;
  const int G = kSeHalf / Q;
  float* s_w1 = s_se + 4;                       // [R][C]
  float* s_w2 = s_w1 + R * C;                   // [2C][R]
  float* s_b1 = s_w2 + 2 * C * R;               // [R]
  float* s_b2 = s_b1 + R;                       // [2C]
  float* part = s_b2 + 2 * C;                   // [position][G][C]
  float* mean = part + kSePositions * G * C;    // [position][C]
  float* hidden = mean + kSePositions * C;      // [position][R]
  float* scale = hidden + kSePositions * R;     // [position][C]
  float* offset = scale + kSePositions * C;     // [position][C]
  const uint32_t bar = smem_addr(s_se);
  const int tid = threadIdx.x;
  const int half = tid / kSeHalf;
  const int t = tid % kSeHalf;
  const int first = blockIdx.x * kSePositions;
  const int count = B - first < kSePositions ? B - first : kSePositions;
  const bool live = half < count;
  const int q = t % Q;
  const int g = t / Q;
  // The thread's chunk of cell g + k G is at at0 + k * step.
  const long long at0 = (static_cast<long long>(first + half) * HW + g) * C +
                        8 * q;
  const long long step = static_cast<long long>(G) * C;

  // The weights' copy, in flight while the board is summed.
  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar, 4 * (3 * R * C + R + 2 * C));
    bulk_copy(smem_addr(s_w1), w1, 4 * R * C, bar);
    bulk_copy(smem_addr(s_w2), w2, 8 * R * C, bar);
    bulk_copy(smem_addr(s_b1), b1, 4 * R, bar);
    bulk_copy(smem_addr(s_b2), b2, 8 * C, bar);
  }

  // Squeeze: each thread's chunk summed over its cells in order (the held
  // ones' loads all in flight at once), then the G partial sums of a
  // channel in order.
  uint4 yk[kSeHeld], xk[kSeHeld];
  if (live) {
#pragma unroll
    for (int k = 0; k < kSeHeld; ++k)
      if (g + k * G < HW) {
        yk[k] = *reinterpret_cast<const uint4*>(y + at0 + k * step);
        xk[k] = *reinterpret_cast<const uint4*>(x + at0 + k * step);
      }
    float sum[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) sum[i] = 0.0f;
#pragma unroll
    for (int k = 0; k < kSeHeld; ++k)
      if (g + k * G < HW) se_add(sum, yk[k]);
    for (int k = kSeHeld; g + k * G < HW; ++k)
      se_add(sum, *reinterpret_cast<const uint4*>(y + at0 + k * step));
#pragma unroll
    for (int i = 0; i < 8; ++i) part[(half * G + g) * C + 8 * q + i] = sum[i];
  }
  __syncthreads();
  if (live) {
    for (int c = t; c < C; c += kSeHalf) {
      float s = 0.0f;
      for (int j = 0; j < G; ++j) s += part[(half * G + j) * C + c];
      mean[half * C + c] = s / static_cast<float>(HW);
    }
  }
  mbar_wait(bar, 0);
  __syncthreads();

  // Excitation, the first dense layer: a warp four outputs j at a time,
  // for both positions, its lanes across the channels four at a time; each
  // sum by a butterfly (lane 0's order is fixed). A position past the batch
  // reads the other's means and writes nothing.
  const int warp = tid / 32;
  const int lane = tid % 32;
  const float4* m0 = reinterpret_cast<const float4*>(mean);
  const float4* m1 =
      reinterpret_cast<const float4*>(mean + (count > 1 ? C : 0));
  for (int j0 = 4 * warp; j0 < R; j0 += 4 * (kSeThreads / 32)) {
    float s[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
    const float4* w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = reinterpret_cast<const float4*>(
          s_w1 + (j0 + i < R ? j0 + i : j0) * C);
    for (int c = lane; c < C / 4; c += 32) {
      const float4 a0 = m0[c];
      const float4 a1 = m1[c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 wc = w[i][c];
        s[0][i] += a0.x * wc.x;
        s[0][i] += a0.y * wc.y;
        s[0][i] += a0.z * wc.z;
        s[0][i] += a0.w * wc.w;
        s[1][i] += a1.x * wc.x;
        s[1][i] += a1.y * wc.y;
        s[1][i] += a1.z * wc.z;
        s[1][i] += a1.w * wc.w;
      }
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[0][i] += __shfl_xor_sync(0xffffffffu, s[0][i], d);
        s[1][i] += __shfl_xor_sync(0xffffffffu, s[1][i], d);
      }
    }
    if (lane < count * 4) {  // lane p * 4 + i writes output j0 + i of p
      const int p = lane / 4;
      const int i = lane % 4;
      if (j0 + i < R) {
        float v = s[0][0];
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (k == lane) v = s[k / 4][k % 4];
        hidden[p * R + j0 + i] = fmaxf(v + s_b1[j0 + i], 0.0f);
      }
    }
  }
  __syncthreads();
  // The second: a thread an output row u of W2, for both positions, the
  // scale's sigmoid or the offset. A thread reads its row four columns at
  // a time from column 4 (u % (R / 4)) on, so that a quarter warp's reads
  // fall on distinct banks.
  const float4* h0 = reinterpret_cast<const float4*>(hidden);
  const float4* h1 = reinterpret_cast<const float4*>(hidden +
                                                     (count > 1 ? R : 0));
  for (int u = tid; u < 2 * C; u += kSeThreads) {
    const float4* row = reinterpret_cast<const float4*>(s_w2 + u * R);
    float a0 = 0.0f, a1 = 0.0f;
    int c = u % (R / 4);
#pragma unroll 4
    for (int k = 0; k < R / 4; ++k) {
      const float4 wv = row[c];
      const float4 x0 = h0[c];
      const float4 x1 = h1[c];
      a0 += x0.x * wv.x;
      a0 += x0.y * wv.y;
      a0 += x0.z * wv.z;
      a0 += x0.w * wv.w;
      a1 += x1.x * wv.x;
      a1 += x1.y * wv.y;
      a1 += x1.z * wv.z;
      a1 += x1.w * wv.w;
      c = c + 1 == R / 4 ? 0 : c + 1;
    }
    const float bias = s_b2[u];
#pragma unroll
    for (int p = 0; p < kSePositions; ++p) {
      if (p >= count) break;
      const float v = (p == 0 ? a0 : a1) + bias;
      if (u < C)
        scale[p * C + u] = 1.0f / (1.0f + expf(-v));
      else
        offset[p * C + u - C] = v;
    }
  }
  __syncthreads();
  if (!live) return;

  // The block's output, from the held chunks, then the rest's loads.
  float fs[8], fo[8];
#pragma unroll
  for (int i = 0; i < 8; i += 4) {
    const float4 sv =
        *reinterpret_cast<const float4*>(scale + half * C + 8 * q + i);
    const float4 ov =
        *reinterpret_cast<const float4*>(offset + half * C + 8 * q + i);
    fs[i] = sv.x;
    fs[i + 1] = sv.y;
    fs[i + 2] = sv.z;
    fs[i + 3] = sv.w;
    fo[i] = ov.x;
    fo[i + 1] = ov.y;
    fo[i + 2] = ov.z;
    fo[i + 3] = ov.w;
  }
#pragma unroll
  for (int k = 0; k < kSeHeld; ++k)
    if (g + k * G < HW)
      *reinterpret_cast<uint4*>(out + at0 + k * step) =
          se_out(xk[k], yk[k], fs, fo);
  for (int k = kSeHeld; g + k * G < HW; ++k)
    *reinterpret_cast<uint4*>(out + at0 + k * step) =
        se_out(*reinterpret_cast<const uint4*>(x + at0 + k * step),
               *reinterpret_cast<const uint4*>(y + at0 + k * step), fs, fo);
}

// gpool_kernel: a pooled inner block's pooled bias and its conv2's norm,
// over (B, HW cells) rows of the pooled channels g (G, rectified) and the
// regular channels r (R, conv1's raw output), both bf16: out = relu((r +
// bias) * scale + offset) per channel, bias = Wg [mean(g), mean(g) x
// pool_scale, max(g)] (Wg (R, 3G) float32, torch's Linear layout, 16-byte
// aligned), scale and offset conv2's folded norm. kGpPositions positions a
// CTA, kGpHalf threads a position. The board: a thread owns one 16-byte
// chunk q of a cell's G channels (G / 8 chunks, which divide kGpHalf) and
// the cells k, k + K, ... (K = kGpHalf / (G / 8)), their loads in flight
// together; its sums and maxima meet the other cells' in shared memory in
// a fixed order (no atomics: a forward repeats bit for bit). The dense
// layer: a warp four outputs at a time for both positions, its lanes
// across the 3G inputs four at a time, Wg's rows read where they live
// (from L2 after the first CTA), the sums by a butterfly (lane 0's order is
// fixed). Then the output in 16-byte chunks of 8 channels, kGpBatch chunks'
// loads in flight at once.
constexpr int kGpPositions = 2;
constexpr int kGpHalf = 128;
constexpr int kGpThreads = kGpPositions * kGpHalf;
constexpr int kGpCells = 4;  // cells a thread's loads hold in flight
constexpr int kGpBatch = 4;

// The shared floats of a CTA: the partial sums and maxima (K rows of G a
// position), the pooled features (3G a position), the biases (R a
// position), the scales and offsets (R each).
inline int gpool_smem_floats(int G, int R) {
  const int K = kGpHalf / (G / 8);
  return kGpPositions * (2 * K * G + 3 * G + R) + 2 * R;
}

__global__ void __launch_bounds__(kGpThreads)
    gpool_kernel(const bf16* __restrict__ g, const bf16* __restrict__ r,
                 int B, int HW, int G, int R, const float* __restrict__ wg,
                 float pool_scale, BatchNormArgs bn, float eps,
                 bf16* __restrict__ out) {
  extern __shared__ __align__(16) float s_gp[];
  const int Q = G / 8;
  const int K = kGpHalf / Q;
  float* part_sum = s_gp;                              // [position][K][G]
  float* part_max = part_sum + kGpPositions * K * G;   // [position][K][G]
  float* pooled = part_max + kGpPositions * K * G;     // [position][3G]
  float* bias = pooled + kGpPositions * 3 * G;         // [position][R]
  float* scale = bias + kGpPositions * R;              // [R]
  float* offset = scale + R;                           // [R]
  const int tid = threadIdx.x;
  const int half = tid / kGpHalf;
  const int t = tid % kGpHalf;
  const int first = blockIdx.x * kGpPositions;
  const int count = B - first < kGpPositions ? B - first : kGpPositions;

  for (int c = tid; c < R; c += kGpThreads) {
    const float sc = bn.gamma[c] / sqrtf(bn.var[c] + eps);
    scale[c] = sc;
    offset[c] = (0.0f - bn.mean[c]) * sc + bn.beta[c];
  }
  // The board: this thread's chunk over its cells, in order.
  if (half < count) {
    const int q = t % Q;
    const int k = t / Q;
    const bf16* base =
        g + static_cast<long long>(first + half) * HW * G + 8 * q;
    float sum[8], top[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      sum[i] = 0.0f;
      top[i] = -3.0e38f;
    }
    for (int cell0 = k; cell0 < HW; cell0 += kGpCells * K) {
      uint4 raw[kGpCells];
#pragma unroll
      for (int j = 0; j < kGpCells; ++j)
        if (cell0 + j * K < HW)
          raw[j] = *reinterpret_cast<const uint4*>(
              base + static_cast<long long>(cell0 + j * K) * G);
#pragma unroll
      for (int j = 0; j < kGpCells; ++j) {
        if (cell0 + j * K >= HW) break;
        const bf16* v = reinterpret_cast<const bf16*>(&raw[j]);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float x = __bfloat162float(v[i]);
          sum[i] += x;
          top[i] = fmaxf(top[i], x);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      part_sum[(half * K + k) * G + 8 * q + i] = sum[i];
      part_max[(half * K + k) * G + 8 * q + i] = top[i];
    }
  }
  __syncthreads();
  if (half < count) {
    for (int c = t; c < G; c += kGpHalf) {
      float sum = 0.0f, top = -3.0e38f;
      for (int k = 0; k < K && k < HW; ++k) {
        sum += part_sum[(half * K + k) * G + c];
        top = fmaxf(top, part_max[(half * K + k) * G + c]);
      }
      const float mean = sum / static_cast<float>(HW);
      pooled[half * 3 * G + c] = mean;
      pooled[half * 3 * G + G + c] = mean * pool_scale;
      pooled[half * 3 * G + 2 * G + c] = top;
    }
  }
  __syncthreads();

  // The dense layer, four outputs j0..j0+3 a warp at a time for both
  // positions (a position past the batch reads the first's features and
  // writes nothing).
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int inputs = 3 * G / 4;  // float4s a row
  const float4* p0 = reinterpret_cast<const float4*>(pooled);
  const float4* p1 =
      reinterpret_cast<const float4*>(pooled + (count > 1 ? 3 * G : 0));
  for (int j0 = 4 * warp; j0 < R; j0 += 4 * (kGpThreads / 32)) {
    float s[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
    for (int k = lane; k < inputs; k += 32) {
      float4 w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[i] = reinterpret_cast<const float4*>(
            wg + static_cast<long long>(j0 + i < R ? j0 + i : j0) * 3 *
                     G)[k];
      const float4 a0 = p0[k];
      const float4 a1 = p1[k];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[0][i] += a0.x * w[i].x;
        s[0][i] += a0.y * w[i].y;
        s[0][i] += a0.z * w[i].z;
        s[0][i] += a0.w * w[i].w;
        s[1][i] += a1.x * w[i].x;
        s[1][i] += a1.y * w[i].y;
        s[1][i] += a1.z * w[i].z;
        s[1][i] += a1.w * w[i].w;
      }
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[0][i] += __shfl_xor_sync(0xffffffffu, s[0][i], d);
        s[1][i] += __shfl_xor_sync(0xffffffffu, s[1][i], d);
      }
    }
    if (lane < count * 4) {  // lane p * 4 + i writes output j0 + i of p
      const int p = lane / 4;
      const int i = lane % 4;
      if (j0 + i < R) {
        float v = s[0][0];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (e == lane) v = s[e / 4][e % 4];
        bias[p * R + j0 + i] = v;
      }
    }
  }
  __syncthreads();

  // The output, kGpBatch chunks a thread at a time, loads first.
  const int chunks = R / 8;
  const int total = count * HW * chunks;
  for (int e0 = tid; e0 < total; e0 += kGpBatch * kGpThreads) {
    uint4 raw[kGpBatch];
#pragma unroll
    for (int b = 0; b < kGpBatch; ++b) {
      const int e = e0 + b * kGpThreads;
      if (e < total)
        raw[b] = *reinterpret_cast<const uint4*>(
            r + static_cast<long long>(first) * HW * R +
            static_cast<long long>(e) * 8);
    }
#pragma unroll
    for (int b = 0; b < kGpBatch; ++b) {
      const int e = e0 + b * kGpThreads;
      if (e >= total) break;
      const int p = e / (HW * chunks);
      const int c0 = 8 * (e % chunks);
      const __nv_bfloat162* rv =
          reinterpret_cast<const __nv_bfloat162*>(&raw[b]);
      uint4 res;
      __nv_bfloat162* ov = reinterpret_cast<__nv_bfloat162*>(&res);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = c0 + 2 * i;
        const float2 v = __bfloat1622float2(rv[i]);
        const float v0 = (v.x + bias[p * R + c]) * scale[c] + offset[c];
        const float v1 =
            (v.y + bias[p * R + c + 1]) * scale[c + 1] + offset[c + 1];
        ov[i] = __floats2bfloat162_rn(fmaxf(v0, 0.0f), fmaxf(v1, 0.0f));
      }
      *reinterpret_cast<uint4*>(out + static_cast<long long>(first) * HW *
                                          R +
                                static_cast<long long>(e) * 8) = res;
    }
  }
}

// pack: table rows (weight address, offset in out, C_out, C_in, taps) of
// int64. Each layer's (C_out, C_in, taps) float32 weight becomes C_out rows
// of padded_depth(C_in x taps) bf16 in (tap, C_in) order, zeros after
// them. One block a (32 x 32) tile of the layer's rows and padded K.
constexpr int kPackTile = 32;

__global__ void pack_kernel(const long long* __restrict__ table,
                            bf16* __restrict__ out) {
  const long long* row = table + blockIdx.y * 5;
  const float* src = reinterpret_cast<const float*>(row[0]);
  const long long offset = row[1];
  const int cout = static_cast<int>(row[2]);
  const int cin = static_cast<int>(row[3]);
  const int taps = static_cast<int>(row[4]);
  const int depth = cin * taps;
  const int kp = padded_depth(depth);
  const int k_tiles = kp / kPackTile;
  const int co_tiles = (cout + kPackTile - 1) / kPackTile;
  if (static_cast<int>(blockIdx.x) >= k_tiles * co_tiles) return;
  const int co0 = (blockIdx.x / k_tiles) * kPackTile;
  const int k = (blockIdx.x % k_tiles) * kPackTile + threadIdx.x;
  for (int i = threadIdx.y; i < kPackTile; i += blockDim.y) {
    const int co = co0 + i;
    if (co >= cout) continue;
    float w = 0.0f;
    if (k < depth) {
      const int tap = k / cin;
      w = src[(long long)co * depth + (k - tap * cin) * taps + tap];
    }
    out[offset + (long long)co * kp + k] = __float2bfloat16_rn(w);
  }
}

// heads: one thread a row (board cell) of the (M, C) bf16 trunk output,
// 16 bytes of channels a load; the P policy and V value filters' weights,
// rounded to bf16, in shared memory, read by all threads at once.
constexpr int kHeadsMax = 8;  // P + V
constexpr int kHeadsThreads = 128;

__global__ void __launch_bounds__(kHeadsThreads)
    heads_kernel(const bf16* __restrict__ x, int M, int C,
                 const float* __restrict__ wp, BatchNormArgs pbn, int P,
                 const float* __restrict__ wv, BatchNormArgs vbn, int V,
                 float eps, float* __restrict__ p, float* __restrict__ v) {
  extern __shared__ float s_w[];  // (P + V) rows of C, then scale, offset
  const int filters = P + V;
  float* s_scale = s_w + filters * C;
  float* s_offset = s_scale + filters;
  for (int i = threadIdx.x; i < filters * C; i += blockDim.x) {
    const float w = i < P * C ? wp[i] : wv[i - P * C];
    s_w[i] = __bfloat162float(__float2bfloat16_rn(w));
  }
  for (int j = threadIdx.x; j < filters; j += blockDim.x) {
    if (j < P)
      fold(pbn, j, eps, &s_scale[j], &s_offset[j]);
    else
      fold(vbn, j - P, eps, &s_scale[j], &s_offset[j]);
  }
  __syncthreads();
  const int row = blockIdx.x * kHeadsThreads + threadIdx.x;
  if (row >= M) return;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (long long)row * C);
  float sum[kHeadsMax];
#pragma unroll
  for (int j = 0; j < kHeadsMax; ++j) sum[j] = 0.0f;
#pragma unroll 4
  for (int q = 0; q < C / 8; ++q) {
    const uint4 raw = xr[q];
    const bf16* xs = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float xc = __bfloat162float(xs[i]);
#pragma unroll
      for (int j = 0; j < kHeadsMax; ++j)
        if (j < filters) sum[j] += xc * s_w[j * C + 8 * q + i];
    }
  }
#pragma unroll
  for (int j = 0; j < kHeadsMax; ++j) {
    if (j < filters) {
      const float y = fmaxf(sum[j] * s_scale[j] + s_offset[j], 0.0f);
      if (j < P)
        p[(long long)row * P + j] = y;
      else
        v[(long long)row * V + j - P] = y;
    }
  }
}

}  // namespace

extern "C" {

// Each entry point launches on ``stream`` and returns cudaGetLastError()
// (0 when the launch was taken).

int fused_net_pack(const long long* table, int layers, int tiles, bf16* out,
                   void* stream) {
  pack_kernel<<<dim3(tiles, layers), dim3(kPackTile, 8), 0,
                static_cast<cudaStream_t>(stream)>>>(table, out);
  return static_cast<int>(cudaGetLastError());
}

// The stem: x is the (M = B*H*W, C) NHWC float32 observations, w its packed
// bf16 weight (N rows of padded_depth(ks*ks*C)); N a multiple of 8. out2
// (or null): also relu(n(out)) of the rounded output, n the norm (nbias
// unread).
int fused_net_conv(const float* x, const bf16* w, int C, int ks,
                   const float* bias, const float* gamma, const float* beta,
                   const float* mean, const float* var, const float* nbias,
                   const float* ngamma, const float* nbeta,
                   const float* nmean, const float* nvar, bf16* out,
                   bf16* out2, int M, int H, int W, int N, float eps,
                   void* stream) {
  if (N % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  static bool sized = false;  // above 48 KB: once, before use
  if (!sized) {
    cudaError_t err = cudaFuncSetAttribute(
        conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Stem::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  const StemInput op{x, w, C, ks};
  const BatchNormArgs bn{bias, gamma, beta, mean, var};
  const BatchNormArgs nbn{nbias, ngamma, nbeta, nmean, nvar};
  const dim3 grid((M + Stem::BM - 1) / Stem::BM, (N + kBN - 1) / kBN);
  conv_kernel<<<grid, Stem::kThreads, Stem::kSmem,
                static_cast<cudaStream_t>(stream)>>>(op, bn, nbn, out, out2,
                                                     M, H, W, N, eps);
  return static_cast<int>(cudaGetLastError());
}

// One block conv through the pipelined kernel: x is (M = B*H*W, C) NHWC
// bf16, w its packed (N, ks*ks*C) weight, C and N multiples of 64.
// residual (a Skip): add to relu's input the 1x1 projection of r ((M, N)
// bf16, packed weight wr (N, N)) with its BatchNorm (1; bm 128 only), or r
// itself (2; wr and rbn unread); 3: no skip and no ReLU. 4 and 5: the
// pre-activation epilogue, conv(x) + bias (the bias slot of every one of
// bn's pointers read), plus r itself (5), rounded into out, and relu(n(out))
// into out2, n the norm in rbn (its bias unread), a null out or out2 left
// unwritten, not both; out2 is unread in the other modes. bm: the tile's
// cells, 128 or 192; bn: its filters, 128 or (residual 0, 4 or 5) 96.
int fused_net_conv_pipelined(
    const bf16* x, const bf16* w, int C, int ks, const float* bias,
    const float* gamma, const float* beta, const float* mean,
    const float* var, const bf16* r, const bf16* wr, const float* rbias,
    const float* rgamma, const float* rbeta, const float* rmean,
    const float* rvar, int residual, bf16* out, bf16* out2, int M, int H,
    int W, int N, float eps, int bm, int bn_tile, void* stream) {
  if (C % kBK != 0 || N % kBK != 0 || residual < kNoSkip ||
      residual > kPreIdentity ||
      (residual < kPre ? out == nullptr : out == nullptr && out2 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const BatchNormArgs bn{bias, gamma, beta, mean, var};
  const BatchNormArgs rbn{rbias, rgamma, rbeta, rmean, rvar};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (bm == 128 && bn_tile == kBN)
    err = launch_ws_skip<2, kBN>(x, w, C, ks, bn, r, wr, rbn, residual, out,
                                 out2, M, H, W, N, eps, s);
  else if (bm == 192 && bn_tile == kBN)
    err = launch_ws_skip<3, kBN>(x, w, C, ks, bn, r, wr, rbn, residual, out,
                                 out2, M, H, W, N, eps, s);
  else if (bm == 128 && bn_tile == 96)
    err = launch_ws_skip<2, 96>(x, w, C, ks, bn, r, wr, rbn, residual, out,
                                out2, M, H, W, N, eps, s);
  else if (bm == 192 && bn_tile == 96)
    err = launch_ws_skip<3, 96>(x, w, C, ks, bn, r, wr, rbn, residual, out,
                                out2, M, H, W, N, eps, s);
  return static_cast<int>(err);
}

// A residual block's squeeze-excitation gate and its output: x (the block
// input) and y (its second conv's output, kLinear) are (B * HW, C) bf16,
// out gets relu(x + sigmoid(g) * y + o), [g | o] = dense2(relu(dense1(the
// mean of y over each position's HW cells))); w1 (R, C), b1 (R), w2 (2C,
// R), b2 (2C) float32, torch's Linear layout, each 16-byte aligned.
// C a multiple of 8 dividing 1024, R a multiple of 4; both weights and the
// sums in one SM's shared memory (se_smem_floats).
int fused_net_se(const bf16* x, const bf16* y, int B, int HW, int C, int R,
                 const float* w1, const float* b1, const float* w2,
                 const float* b2, bf16* out, void* stream) {
  if (B < 1 || HW < 1 || R < 4 || R % 4 != 0 || C < 8 || C % 8 != 0 ||
      C > 8 * kSeHalf ||
      kSeHalf % (C / 8) != 0 || reinterpret_cast<uintptr_t>(w1) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w2) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(b1) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(b2) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = se_smem_floats(C, R) * static_cast<int>(sizeof(float));
  static int sized = 0;  // the dynamic shared memory allowed so far
  if (bytes > 48 * 1024 && bytes > sized) {
    cudaError_t err = cudaFuncSetAttribute(
        se_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = bytes;
  }
  se_kernel<<<(B + kSePositions - 1) / kSePositions, kSeThreads, bytes,
              static_cast<cudaStream_t>(stream)>>>(x, y, B, HW, C, R, w1, b1,
                                                   w2, b2, out);
  return static_cast<int>(cudaGetLastError());
}

// A pooled inner block's pooled bias and conv2's norm: g (B * HW, G) and r
// (B * HW, R) bf16, out (B * HW, R) bf16 = relu((r + Wg [mean(g), mean(g)
// x pool_scale, max(g)]) * scale + offset), Wg (R, 3G) float32, 16-byte
// aligned; scale and offset folded from gamma, beta, mean, var and eps. G a
// multiple of 8 whose G / 8 divides 128, R a multiple of 8.
int fused_net_gpool(const bf16* g, const bf16* r, int B, int HW, int G,
                    int R, const float* wg, float pool_scale,
                    const float* gamma, const float* beta, const float* mean,
                    const float* var, float eps, bf16* out, void* stream) {
  if (B < 1 || HW < 1 || G < 8 || G % 8 != 0 || kGpHalf % (G / 8) != 0 ||
      R < 8 || R % 8 != 0 || reinterpret_cast<uintptr_t>(wg) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = gpool_smem_floats(G, R) * static_cast<int>(sizeof(float));
  static int sized = 0;  // the dynamic shared memory allowed so far
  if (bytes > 48 * 1024 && bytes > sized) {
    cudaError_t err = cudaFuncSetAttribute(
        gpool_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = bytes;
  }
  const BatchNormArgs bn{gamma, gamma, beta, mean, var};
  gpool_kernel<<<(B + kGpPositions - 1) / kGpPositions, kGpThreads, bytes,
                 static_cast<cudaStream_t>(stream)>>>(
      g, r, B, HW, G, R, wg, pool_scale, bn, eps, out);
  return static_cast<int>(cudaGetLastError());
}

// The policy (P filters) and value (V filters) 1x1 convs of the (M, C) bf16
// trunk output (C a multiple of 8) into (M, P) and (M, V) float32; P + V at
// most 8.
int fused_net_heads(const bf16* x, int M, int C, const float* wp,
                    const float* pbias, const float* pgamma,
                    const float* pbeta, const float* pmean, const float* pvar,
                    int P, const float* wv, const float* vbias,
                    const float* vgamma, const float* vbeta,
                    const float* vmean, const float* vvar, int V, float eps,
                    float* p, float* v, void* stream) {
  if (P + V > kHeadsMax || P < 1 || V < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const BatchNormArgs pbn{pbias, pgamma, pbeta, pmean, pvar};
  const BatchNormArgs vbn{vbias, vgamma, vbeta, vmean, vvar};
  if (C % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = ((P + V) * C + 2 * (P + V)) * sizeof(float);
  heads_kernel<<<(M + kHeadsThreads - 1) / kHeadsThreads, kHeadsThreads,
                 bytes, static_cast<cudaStream_t>(stream)>>>(
      x, M, C, wp, pbn, P, wv, vbn, V, eps, p, v);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
