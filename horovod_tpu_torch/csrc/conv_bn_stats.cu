// 1x1 convolution with BatchNorm statistics, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of experiments/pallas_conv_bn_spike.py:
//
//   hvd_conv_bn_stats <- _kernel   y = x . w (fp32 accumulation, stored
//                                  bf16) and the per-channel sum(y) and
//                                  sum(y^2) of the unrounded fp32 y over
//                                  every row
//
// x [N, K] bf16 is an NHWC activation read as rows of channels, w [K, C]
// bf16 the 1x1 kernel (HWIO with H = W = 1), y [N, C] bf16.  The statistics
// come back as per-CTA fp32 partials [2, G, C] (sum(y) for each of the G
// row CTAs, then sum(y^2)), which the caller sums (a plain torch.sum, as
// the reference sums outside its kernel); then mean = s1 / N and
// var = s2 / N - mean^2.
//
// What bounds it on this card: bytes.  At ResNet-50's stage-2 bottleneck
// shape (N 200704 = 256 x 28 x 28, K 512, C 128) it reads 205.5 MB of x and
// 0.13 MB of w and writes 51.4 MB of y: 257.0 MB, 0.0767 ms at 3.35 TB/s,
// against 26.3 GFLOP, 0.0266 ms at 989 TFLOP/s -- about 102 FLOP a byte,
// under the ~295 where the tensor cores become the limit.  So the aim is
// to read x once, with the products keeping up, and to produce the
// statistics without a second pass over y.
//
// Design (simple first; wgmma, TMA and warp specialisation are later
// work):
//   * persistent CTAs: grid (G, column blocks of 128 channels), G about the
//     SMs over the column blocks; CTA b walks the 128-row tiles b, b + G,
//     b + 2G, ... of x;
//   * each CTA keeps its [K, 128] column block of w resident in shared
//     memory (K 512: 136 KB with the row padding), loaded once;
//   * x streams through shared memory in [128 rows, 64 k] chunks, three
//     stages deep with cp.async, the pipeline running on across row tiles;
//   * 8 warps as 4 x 2, each owning a 32 x 64 output tile: mma.sync
//     m16n8k16 bf16 with fp32 accumulators, operands by ldmatrix (w with
//     .trans, as it is stored [k][n]); rows padded by 16 bytes so ldmatrix
//     is free of bank conflicts;
//   * epilogue of a row tile: y rounded once to bf16 (nearest-even) and
//     stored; the fp32 y and y^2 folded into per-thread column sums that
//     stay in registers across all of the CTA's row tiles (rows past N are
//     zero-filled, so they add nothing);
//   * at the end, a fixed-order reduction (warp shuffles over the rows a
//     warp holds, then the four row warps through shared memory) writes one
//     partial per column per CTA: no atomics, deterministic.
// The TPU kernel carries s1 and s2 in VMEM across its sequential
// ("arbitrary") row grid; CTAs here run unordered, so each keeps its own
// partial and the caller adds the G partials.
//
// Shapes: any N >= 1 (the tail tile masked); K and C multiples of 8 (rows
// of 16 bytes for cp.async); the [K, 128] column block of w must fit in
// shared memory beside the x stages, so K <= 640.  C past a multiple of
// 128 is masked (its w columns zero-filled, its y and partials not
// written).  No backward: the TPU kernel has none.
//
// Plain C interface, loaded with ctypes (horovod_tpu_torch/ops/_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;          // 8 warps: 4 along rows, 2 along columns
constexpr int kBM = 128;               // rows per tile
constexpr int kBN = 128;               // channels per CTA (one column block)
constexpr int kBK = 64;                // k per pipeline stage
constexpr int kStages = 3;             // x chunks in flight
constexpr int kPad = 8;                // bf16 padding per shared-memory row
constexpr int kLdx = kBK + kPad;       // x stage row: 144 bytes
constexpr int kLdw = kBN + kPad;       // w row: 272 bytes
constexpr int kWarpM = 32;             // rows per warp
constexpr int kWarpN = 64;             // channels per warp
constexpr int kSmemMax = 232448;       // shared memory a CTA may use (227 KB)

// ---------------------------------------------------------------------------
// PTX helpers (as in flash_attention.cu)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; pred false writes 16 zero bytes and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

// c += a (16x16, row) . b (16x8, col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two floats rounded to nearest-even bf16; lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A operand: the 16x16 tile at `p` of a row-major [rows][ld] array.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* p,
                                       int ld, int lane) {
  ldsm_x4(a, p + (lane & 15) * ld + (lane >> 4) * 8);
}

// B operand (k x n = 16 x 8) stored as [k][n] rows: the 16 rows at `p`,
// columns n..n+7.
__device__ __forceinline__ void load_bt(uint32_t (&b)[2], const bf16* p,
                                        int ld, int lane) {
  ldsm_x2_t(b, p + (lane & 15) * ld);
}

// K rounded up to whole pipeline chunks.
__host__ __device__ __forceinline__ int k_chunks(int K) {
  return (K + kBK - 1) / kBK;
}

// Shared memory the kernel needs for a given K (0 if K is out of range:
// the wrapper's MAX_K, ops/conv_bn_stats.py, is the largest K it accepts).
int smem_bytes(int K) {
  if (K < 8 || K % 8) return 0;
  const size_t bytes = (static_cast<size_t>(k_chunks(K)) * kBK * kLdw +
                        static_cast<size_t>(kStages) * kBM * kLdx) *
                       sizeof(bf16);
  return bytes <= static_cast<size_t>(kSmemMax) ? static_cast<int>(bytes) : 0;
}

// hvd_conv_bn_stats <- _kernel, experiments/pallas_conv_bn_spike.py:39.
// Bound by bytes: x read once, y written once (w and the partials are
// ~0.1 % at the stage-2 shape).
__global__ void __launch_bounds__(kThreads, 1)
    conv_bn_stats_kernel(const bf16* __restrict__ x,
                         const bf16* __restrict__ w, bf16* __restrict__ y,
                         float* __restrict__ parts, int N, int K, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nk = k_chunks(K);
  bf16* ws = reinterpret_cast<bf16*>(smem);              // [nk * kBK][kLdw]
  bf16* xs = ws + static_cast<size_t>(nk) * kBK * kLdw;  // [kStages][kBM][kLdx]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;   // warp's row and column slot
  const int g = lane >> 2, t = lane & 3;     // mma fragment row / column pair
  const int n0 = blockIdx.y * kBN;
  const int n_tiles = (N + kBM - 1) / kBM;
  // gridDim.x <= n_tiles, so every CTA has at least one tile.
  const int my_tiles = (n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int total = my_tiles * nk;           // (tile, k chunk) steps

  // The column block of w: rows k < K and columns < C; the rest zero.
  for (int c = tid; c < nk * kBK * (kBN / 8); c += kThreads) {
    const int k = c / (kBN / 8), col = (c % (kBN / 8)) * 8;
    const bool ok = k < K && n0 + col < C;
    cp_async16(ws + k * kLdw + col,
               w + (ok ? static_cast<size_t>(k) * C + n0 + col : 0), ok);
  }

  // Step `it`: the k chunk it % nk of this CTA's tile it / nk, into stage
  // it % kStages; rows past N and columns past K zero-filled.
  auto load_x = [&](int it) {
    const int tile = blockIdx.x + (it / nk) * gridDim.x;
    const int k0 = (it % nk) * kBK;
    bf16* dst = xs + (it % kStages) * kBM * kLdx;
    for (int c = tid; c < kBM * (kBK / 8); c += kThreads) {
      const int r = c / (kBK / 8), col = (c % (kBK / 8)) * 8;
      const int row = tile * kBM + r;
      const bool ok = row < N && k0 + col < K;
      cp_async16(dst + r * kLdx + col,
                 x + (ok ? static_cast<size_t>(row) * K + k0 + col : 0), ok);
    }
  };

  // The w copies ride in the first group.
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) load_x(s);
    cp_async_commit();
  }

  float acc[2][kWarpN / 8][4];
  float s1[kWarpN / 8][2], s2[kWarpN / 8][2];
#pragma unroll
  for (int nt = 0; nt < kWarpN / 8; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[0][nt][i] = acc[1][nt][i] = 0.f;
    s1[nt][0] = s1[nt][1] = s2[nt][0] = s2[nt][1] = 0.f;
  }

  for (int it = 0; it < total; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // stage it is here; stage it - 1 is free again
    if (it + kStages - 1 < total) load_x(it + kStages - 1);
    cp_async_commit();

    const int kc = it % nk;
    const bf16* xt = xs + (it % kStages) * kBM * kLdx + wm * kWarpM * kLdx;
    const bf16* wt = ws + kc * kBK * kLdw + wn * kWarpN;
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t a[2][4];
      load_a(a[0], xt + ks * 16, kLdx, lane);
      load_a(a[1], xt + 16 * kLdx + ks * 16, kLdx, lane);
#pragma unroll
      for (int nt = 0; nt < kWarpN / 8; ++nt) {
        uint32_t b[2];
        load_bt(b, wt + ks * 16 * kLdw + nt * 8, kLdw, lane);
        mma(acc[0][nt], a[0], b);
        mma(acc[1][nt], a[1], b);
      }
    }

    if (kc == nk - 1) {   // the tile is done: store y, fold the statistics
      const int tile = blockIdx.x + (it / nk) * gridDim.x;
      const int r0 = tile * kBM + wm * kWarpM + g;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = r0 + mi * 16;
#pragma unroll
        for (int nt = 0; nt < kWarpN / 8; ++nt) {
          float* c = acc[mi][nt];
          s1[nt][0] += c[0] + c[2];
          s1[nt][1] += c[1] + c[3];
          s2[nt][0] += c[0] * c[0] + c[2] * c[2];
          s2[nt][1] += c[1] * c[1] + c[3] * c[3];
          const int col = n0 + wn * kWarpN + nt * 8 + 2 * t;
          if (col < C) {
            if (r < N)
              *reinterpret_cast<uint32_t*>(y + static_cast<size_t>(r) * C +
                                           col) = pack_bf16(c[0], c[1]);
            if (r + 8 < N)
              *reinterpret_cast<uint32_t*>(
                  y + static_cast<size_t>(r + 8) * C + col) =
                  pack_bf16(c[2], c[3]);
          }
          c[0] = c[1] = c[2] = c[3] = 0.f;
        }
      }
    }
  }

  // The CTA's partials: sum the 8 fragment rows of each warp (lanes that
  // share t), then the four row warps in order, through shared memory.
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(xs);   // [2][4][kBN]
#pragma unroll
  for (int nt = 0; nt < kWarpN / 8; ++nt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float a = s1[nt][j], b = s2[nt][j];
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, o);
        b += __shfl_xor_sync(0xffffffffu, b, o);
      }
      if (g == 0) {
        const int cl = wn * kWarpN + nt * 8 + 2 * t + j;
        red[wm * kBN + cl] = a;
        red[(4 + wm) * kBN + cl] = b;
      }
    }
  }
  __syncthreads();
  for (int cl = tid; cl < kBN; cl += kThreads) {
    const int col = n0 + cl;
    if (col >= C) continue;
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      a += red[m * kBN + cl];
      b += red[(4 + m) * kBN + cl];
    }
    parts[static_cast<size_t>(blockIdx.x) * C + col] = a;
    parts[(static_cast<size_t>(gridDim.x) + blockIdx.x) * C + col] = b;
  }
}

}  // namespace

// x: contiguous bf16 [N, K]; w: contiguous bf16 [K, C]; y: contiguous bf16
// [N, C]; parts: contiguous fp32 [2, grid_rows, C].  All 16-byte aligned,
// on the current device; launches on `stream`, allocates nothing.
// grid_rows: CTAs along the rows, 1 <= grid_rows <= ceil(N / 128).
// Returns 0, a cudaError_t from the launch, or -1 for an unsupported shape.
extern "C" int hvd_conv_bn_stats(const void* x, const void* w, void* y,
                                 void* parts, int N, int K, int C,
                                 int grid_rows, void* stream) {
  const int smem = smem_bytes(K);
  if (N < 1 || smem == 0 || C < 8 || C % 8) return -1;
  const int n_tiles = (N + kBM - 1) / kBM;
  if (grid_rows < 1 || grid_rows > n_tiles) return -1;
  if (cudaError_t err = cudaFuncSetAttribute(
          conv_bn_stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          smem))
    return static_cast<int>(err);
  const dim3 grid(grid_rows, (C + kBN - 1) / kBN);
  conv_bn_stats_kernel<<<grid, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<bf16*>(y), static_cast<float*>(parts), N, K, C);
  return static_cast<int>(cudaGetLastError());
}
