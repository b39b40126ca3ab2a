// The policy-value net's inference forward (ops/fused_net.py), for Hopper.
//
// Replaces no TPU kernel: the JAX package leaves the net to XLA, which fuses
// each layer's BatchNorm, bias, add and ReLU into the convolution on the
// TPU. On the card the module path ran each of those as a separate pass over
// the activation. Three kernels:
//
// - pack: every trunk conv weight, read from the live float32 parameters
//   through a table of addresses and rounded to bf16 (as autocast rounds
//   it), into one buffer: C_out rows of (tap, C_in), zero-padded to whole K
//   steps, the GEMM's K-major N x K operand. One launch a forward.
// - conv: an implicit GEMM on NHWC activations. One GEMM row is one board
//   cell: M = B x H x W, N = filters, K = taps x C_in. No im2col tensor is
//   written: each K step gathers one tap's channels of the shifted cells
//   with masked (zero-filling) cp.async loads at the board's edges and at a
//   channel tail. The stem reads the float32 observations over the flat
//   K = taps x C_in and rounds them to bf16 on load. wgmma (m64n128k16, both
//   operands from 128-byte-swizzled shared memory) with float32 sums. A
//   residual block's second conv takes the block's skip path: with a 1x1
//   projection of the block input it runs a second K loop into a second
//   accumulator; with an identity skip it adds the block input's bf16 tile,
//   read in the epilogue (no second K loop). The epilogue, in float32 from
//   the live parameters and running statistics, applies each conv's bias
//   and eval-mode BatchNorm as one scale and offset a channel, adds the
//   skip, applies ReLU and writes bf16: one rounding a layer.
// - heads: the policy and value 1x1 convs (a few filters each) over the
//   trunk's bf16 output, one thread a board cell, with their BatchNorm and
//   ReLU, written in float32 for the dense layers.
//
// What bounds it on an H100: a c4-r5 forward at B=1,024 is 107.5 GFLOP,
// 0.109 ms at the bf16 peak, against about 0.074 ms of its bytes read and
// written once; the tensor cores bound it. Every layer is one launch with
// its whole epilogue in registers, so an activation is written once, in
// bf16, and read only by the next layer. What keeps a conv below the peak
// is feeding wgmma: every tile reads the layer's whole packed weight (295 KB
// at 128 filters) and nine shifted copies of its rows through L2 and L1,
// and the threads that start those gathers compute each chunk's address and
// mask. The trunk's tiles are 128 cells, two warpgroups sharing each
// weight stage (half the weight traffic of 64-cell tiles), four stages in
// flight, wgmma keeping one step's group in flight while the next starts,
// one tile to an SM; where 128-cell tiles would leave the card's last
// wave of tiles mostly empty, the caller asks for 64-cell tiles, three to
// an SM (ops/fused_net.py, ``conv_tile``). The stem, one or a few K steps,
// runs 64-cell tiles. The output tile goes out through shared memory in
// 16-byte chunks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

// A conv tile: BM = 64 x WG board cells x kBN filters, one warpgroup (four
// warps of 16 cells) per 64 cells, all sharing the tile's weight; K stages
// of kBK = one 128-byte row of bf16, in a ring of STAGES in shared memory.
// Both operands are K-major and 128-byte swizzled, the layout wgmma reads
// through its descriptors: 16-byte chunk j of row r sits at chunk
// j ^ (r % 8) of the row.
constexpr int kBN = 128;
constexpr int kBK = 64;
constexpr int kFold = 4 * kBN * 4;  // epilogue scales and offsets, bytes

template <int WG_, int STAGES_>
struct Tiles {
  static constexpr int WG = WG_;
  static constexpr int BM = 64 * WG;
  static constexpr int kStages = STAGES_;
  static constexpr int kThreads = 128 * WG;
  static constexpr int kATile = BM * kBK * 2;  // bytes
  static constexpr int kBTile = kBN * kBK * 2;
  static constexpr int kStage = kATile + kBTile;  // a multiple of 1024
  static constexpr int kSmem = kFold + kStages * kStage;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ int swizzled(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

// 16 bytes from global to shared memory; zeros where !ok (nothing read).
__device__ __forceinline__ void cp_async_ca(uint32_t dst, const void* src,
                                            bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

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
__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
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

// A layer's GEMM operands: NHWC input x (B*H*W rows of C channels), packed
// weight w (N rows of kp: taps x C in (tap, channel) order, zero-padded to
// a multiple of kBK), the kernel size ks (odd, "same" padding).
template <typename TIn>
struct Operand {
  const TIn* x;
  const bf16* w;
  int C;
  int ks;
};

__host__ __device__ __forceinline__ int padded_depth(int depth) {
  return (depth + kBK - 1) / kBK * kBK;
}

// The K loop of one accumulator. FLAT (the stem): K runs over taps x C_in
// as one flat index; each thread gathers a run of 32 consecutive K of one
// row from float32 and rounds it to bf16. Otherwise (bf16 input with C_in a
// multiple of 8): K steps are (tap, kBK channels), gathered 16 bytes at a
// time with cp.async, zero-filled outside the board and the channels.
template <class T, bool FLAT, typename TIn>
__device__ __forceinline__ void k_loop(const Operand<TIn>& op, int M, int H,
                                       int W, int N, int m0, int n0,
                                       unsigned char* tiles, float (&acc)[64]) {
  constexpr int kStages = T::kStages;
  constexpr int kStage = T::kStage;
  constexpr int kRun = T::BM * kBK / T::kThreads;  // FLAT: K a thread
  const int tid = threadIdx.x;
  const int C = op.C;
  const int ks = op.ks;
  const int pad = ks / 2;
  const int hw = H * W;
  const int kc = (C + kBK - 1) / kBK;  // K steps a tap (not FLAT)
  const int depth = ks * ks * C;
  const int kp = padded_depth(depth);
  const int steps = FLAT ? kp / kBK : ks * ks * kc;
  const uint32_t base = smem_addr(tiles);

  // This thread's rows: FLAT, row tid / 2 and K run (tid % 2) * kRun;
  // otherwise rows tid / 8 + 16 i, 16-byte chunk tid % 8 of each.
  constexpr int kRows = FLAT ? 1 : T::BM * 8 / T::kThreads;
  int a_m[kRows], a_h[kRows], a_w[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int m = m0 + (FLAT ? tid / 2 : tid / 8 + 16 * T::WG * i);
    const int cell = m % hw;
    a_m[i] = m;
    a_h[i] = cell / W;
    a_w[i] = cell % W;
  }

  auto load = [&](int step, int stage) {
    const uint32_t a_tile = base + stage * kStage;
    const uint32_t b_tile = a_tile + T::kATile;
    unsigned char* a_ptr = tiles + stage * kStage;
    const int chunk = tid % 8;
    int k_col;  // the packed weight's first column of this step
    bool k_ok;  // this thread's chunk of the weight holds real K
    if constexpr (FLAT) {
      const int r = tid / 2;
      const int kk = (tid % 2) * kRun;
      int k = step * kBK + kk;
      int tap = k / C;
      int c = k - tap * C;
      int dh = tap / ks - pad, dw = tap % ks - pad;
      // All the run's loads first, then the rounding: the loads are in
      // flight together.
      float v[kRun];
#pragma unroll
      for (int j = 0; j < kRun; ++j) {
        const int hh = a_h[0] + dh;
        const int ww = a_w[0] + dw;
        const bool ok = a_m[0] < M && k < depth && hh >= 0 && hh < H &&
                        ww >= 0 && ww < W;
        v[j] = ok ? static_cast<float>(
                        op.x[(long long)(a_m[0] + dh * W + dw) * C + c])
                  : 0.0f;
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
      k_col = step * kBK;
      k_ok = true;  // the padding of the packed weight is zeros
    } else {
      const int tap = step / kc;
      const int c0 = (step - tap * kc) * kBK;
      const int dh = tap / ks - pad;
      const int dw = tap % ks - pad;
      const bool c_ok = c0 + chunk * 8 < C;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = tid / 8 + 16 * T::WG * i;
        const int hh = a_h[i] + dh;
        const int ww = a_w[i] + dw;
        const bool ok = c_ok && a_m[i] < M && hh >= 0 && hh < H && ww >= 0 &&
                        ww < W;
        const TIn* src = ok ? op.x + (long long)(a_m[i] + dh * W + dw) * C +
                                  c0 + chunk * 8
                            : op.x;
        cp_async_ca(a_tile + swizzled(r, chunk), src, ok);
      }
      k_col = tap * C + c0;
      k_ok = c_ok;
    }
#pragma unroll
    for (int i = 0; i < kBN * 8 / T::kThreads; ++i) {
      const int n = tid / 8 + 16 * T::WG * i;
      const bool ok = k_ok && n0 + n < N;
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
  const uint32_t a_rows = (tid / 128) * 64 * 128;  // this warpgroup's cells
  for (int kt = 0; kt < steps; ++kt) {
    cp_async_wait<kAhead - 1>();
    fence_async_shared();
    __syncthreads();
    const int next = kt + kAhead;
    if (next < steps) load(next, next % kStages);
    cp_async_commit();
    const uint32_t a_tile = base + (kt % kStages) * kStage;
    const uint32_t b_tile = a_tile + T::kATile;
    fence_operands(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_m64n128k16(acc, descriptor(a_tile + a_rows + 32 * kk),
                       descriptor(b_tile + 32 * kk));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    fence_operands(acc);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_operands(acc);
  cp_async_wait<0>();
  __syncthreads();
}

// How a conv's output takes a residual block's skip path (the entry
// point's ``residual``).
enum Skip { kNoSkip = 0, kProjection = 1, kIdentity = 2 };

// One (BM x kBN) tile of a conv layer's output: relu(bn(conv(x)) + skip),
// skip bn_r(proj(r)) (kProjection), r itself (kIdentity) or nothing.
template <class T, bool FLAT, int SKIP, typename TIn>
__global__ void __launch_bounds__(T::kThreads)
    conv_kernel(Operand<TIn> op, BatchNormArgs bn, Operand<bf16> rop,
                BatchNormArgs rbn, bf16* __restrict__ out, int M, int H,
                int W, int N, float eps) {
  extern __shared__ __align__(1024) unsigned char smem[];
  float* s_scale = reinterpret_cast<float*>(smem);
  float* s_offset = s_scale + kBN;
  float* r_scale = s_offset + kBN;
  float* r_offset = r_scale + kBN;
  unsigned char* tiles = smem + kFold;
  if (smem_addr(tiles) % 1024 != 0) __trap();  // the swizzle needs it
  const int m0 = blockIdx.x * T::BM;
  const int n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  // The epilogue's parameters of filter n0 + tid, loaded now and folded
  // after the K loop, so their latency overlaps it.
  float p[10] = {0.0f, 0.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0.0f, 0.0f, 0.0f, 1.0f};
  const bool has_col = tid < kBN && n0 + tid < N;
  if (has_col) {
    const BatchNormArgs* args[2] = {&bn, &rbn};
#pragma unroll
    for (int g = 0; g < (SKIP == kProjection ? 2 : 1); ++g) {
      p[5 * g] = args[g]->bias[n0 + tid];
      p[5 * g + 1] = args[g]->gamma[n0 + tid];
      p[5 * g + 2] = args[g]->beta[n0 + tid];
      p[5 * g + 3] = args[g]->mean[n0 + tid];
      p[5 * g + 4] = args[g]->var[n0 + tid];
    }
  }

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  k_loop<T, FLAT>(op, M, H, W, N, m0, n0, tiles, acc);
  float racc[64];  // the projection's sums (kProjection only)
  if constexpr (SKIP == kProjection) {
#pragma unroll
    for (int i = 0; i < 64; ++i) racc[i] = 0.0f;
    k_loop<T, false>(rop, M, H, W, N, m0, n0, tiles, racc);
  }

  if (tid < kBN) {
    float s = 0.0f, o = 0.0f, rs = 0.0f, ro = 0.0f;
    if (has_col) {
      s = p[1] / sqrtf(p[4] + eps);
      o = (p[0] - p[3]) * s + p[2];
      if constexpr (SKIP == kProjection) {
        rs = p[6] / sqrtf(p[9] + eps);
        ro = (p[5] - p[8]) * rs + p[7];
      }
    }
    s_scale[tid] = s;
    s_offset[tid] = o;
    r_scale[tid] = rs;
    r_offset[tid] = ro;
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
      float v0 = acc[4 * j + 2 * half] * s_scale[f] + s_offset[f];
      float v1 = acc[4 * j + 2 * half + 1] * s_scale[f + 1] + s_offset[f + 1];
      if constexpr (SKIP == kProjection) {
        v0 += racc[4 * j + 2 * half] * r_scale[f] + r_offset[f];
        v1 += racc[4 * j + 2 * half + 1] * r_scale[f + 1] + r_offset[f + 1];
      }
      if constexpr (SKIP == kIdentity) {
        const int m = m0 + row0 + 8 * half;
        if (m < M && n0 + f < N) {
          const float2 r = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(
                  rop.x + (long long)m * N + n0 + f));
          v0 += r.x;
          v1 += r.y;
        }
      }
      *reinterpret_cast<__nv_bfloat162*>(
          staged + (row0 + 8 * half) * kOutStride + f) =
          __floats2bfloat162_rn(fmaxf(v0, 0.0f), fmaxf(v1, 0.0f));
    }
  }
  __syncthreads();
  for (int e = tid; e < T::BM * kBN / 8; e += T::kThreads) {
    const int r = e / (kBN / 8);
    const int col = n0 + (e % (kBN / 8)) * 8;
    if (m0 + r < M && col < N)
      *reinterpret_cast<uint4*>(out + (long long)(m0 + r) * N + col) =
          *reinterpret_cast<const uint4*>(staged + r * kOutStride + col - n0);
  }
}

template <class T, bool FLAT, int SKIP, typename TIn>
cudaError_t launch_conv(const Operand<TIn>& op, const BatchNormArgs& bn,
                        const Operand<bf16>& rop, const BatchNormArgs& rbn,
                        bf16* out, int M, int H, int W, int N, float eps,
                        cudaStream_t stream) {
  auto kernel = conv_kernel<T, FLAT, SKIP, TIn>;
  static bool sized = false;  // above 48 KB: once per kernel, before use
  if (!sized) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  const dim3 grid((M + T::BM - 1) / T::BM, (N + kBN - 1) / kBN);
  kernel<<<grid, T::kThreads, T::kSmem, stream>>>(op, bn, rop, rbn, out, M, H,
                                                  W, N, eps);
  return cudaGetLastError();
}

// The stem (one or a few K steps, its float32 gathers the slow part) runs
// more, smaller tiles to an SM; the trunk shares each weight stage between
// two warpgroups, or runs 64-cell tiles, three to an SM, where the caller
// asks for them.
using StemTiles = Tiles<1, 3>;
using TrunkTiles = Tiles<2, 4>;
using SmallTrunkTiles = Tiles<1, 3>;

template <class T>
cudaError_t launch_trunk(const Operand<bf16>& op, const BatchNormArgs& bn,
                         const Operand<bf16>& rop, const BatchNormArgs& rbn,
                         int residual, bf16* out, int M, int H, int W, int N,
                         float eps, cudaStream_t s) {
  switch (residual) {
    case kNoSkip:
      return launch_conv<T, false, kNoSkip>(op, bn, rop, rbn, out, M, H, W, N,
                                            eps, s);
    case kProjection:
      return launch_conv<T, false, kProjection>(op, bn, rop, rbn, out, M, H,
                                                W, N, eps, s);
    case kIdentity:
      return launch_conv<T, false, kIdentity>(op, bn, rop, rbn, out, M, H, W,
                                              N, eps, s);
  }
  return cudaErrorInvalidValue;
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

// One conv layer: x is (M = B*H*W, C) NHWC, float32 (x_float, the stem: no
// residual, 64-cell tiles) or bf16 (C a multiple of 8); w its packed
// (ks*ks*C, N) bf16 weight; N a multiple of 8. residual (a Skip): add to
// relu's input the 1x1 projection of r ((M, N) bf16, packed weight wr
// (N, N)) with its BatchNorm (1), or r itself (2; wr and rbn unread). bm:
// the tile's cells, 64 or 128.
int fused_net_conv(const void* x, int x_float, const bf16* w, int C, int ks,
                   const float* bias, const float* gamma, const float* beta,
                   const float* mean, const float* var, const bf16* r,
                   const bf16* wr, const float* rbias, const float* rgamma,
                   const float* rbeta, const float* rmean, const float* rvar,
                   int residual, bf16* out, int M, int H, int W, int N,
                   float eps, int bm, void* stream) {
  if (N % 8 != 0 || residual < kNoSkip || residual > kIdentity)
    return static_cast<int>(cudaErrorInvalidValue);
  const BatchNormArgs bn{bias, gamma, beta, mean, var};
  const BatchNormArgs rbn{rbias, rgamma, rbeta, rmean, rvar};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Operand<bf16> rop{r, wr, N, 1};
  cudaError_t err;
  if (x_float) {
    const Operand<float> op{static_cast<const float*>(x), w, C, ks};
    err = residual != kNoSkip || bm != StemTiles::BM
              ? cudaErrorInvalidValue
              : launch_conv<StemTiles, true, kNoSkip>(op, bn, rop, rbn, out, M,
                                                      H, W, N, eps, s);
  } else if (C % 8 != 0) {
    err = cudaErrorInvalidValue;
  } else {
    const Operand<bf16> op{static_cast<const bf16*>(x), w, C, ks};
    if (bm == TrunkTiles::BM)
      err = launch_trunk<TrunkTiles>(op, bn, rop, rbn, residual, out, M, H, W,
                                     N, eps, s);
    else if (bm == SmallTrunkTiles::BM)
      err = launch_trunk<SmallTrunkTiles>(op, bn, rop, rbn, residual, out, M,
                                          H, W, N, eps, s);
    else
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
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
