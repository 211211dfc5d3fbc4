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
// to keep enough of x in flight to stream it at the card's rate, with the
// products and the epilogue hidden behind the stream, and to produce the
// statistics without a second pass over y.
//
// Design (warp-specialised, persistent; the building blocks are
// hopper.cuh's, written for the flash kernels: wgmma.mma_async products,
// cp.async.bulk.tensor loads and stores, mbarriers):
//   * grid (G, column blocks of 128 channels), G about the SMs over the
//     column blocks; CTA b walks the 128-row tiles b, b + G, b + 2G, ... of
//     x.  Three warpgroups: one thread of the first (the producer, its
//     registers cut to 24 by setmaxnreg) issues every load; the two others
//     (the consumers, 240 registers) each own 64 rows of every tile;
//   * the CTA's [K, 128] column block of w is loaded once by TMA, as
//     128-byte-swizzled [64 k][64 channel] boxes, and read in place as
//     wgmma's B operand, MN-major (the transpose bit, as dQ reads K), so no
//     warp ever re-reads it through registers;
//   * x streams through a ring of [128 rows][64 k] swizzled TMA boxes
//     (16 KB a stage; 4 stages up to K 512, 3 up to 576, 2 up to 640, what
//     shared memory leaves beside w), guarded by "full" and "empty"
//     mbarriers and running on across row tiles, so 32-64 KB of x is in
//     flight per SM while the consumers multiply and store;
//   * each consumer runs wgmma m64n128k16 (4 a stage) into a 64-register
//     fp32 accumulator, keeping one stage's products in flight while it
//     releases the stage before;
//   * epilogue of a row tile, per consumer: the unrounded fp32 y and y^2
//     are folded into per-thread column sums (32 columns a thread, 64
//     registers, kept across all of the CTA's tiles); y is rounded once to
//     bf16 (nearest-even) and written to a 128-byte-swizzled [64][128]
//     staging tile (conflict-free 4-byte stores), which one thread hands
//     to a TMA store while the ring keeps filling;
//   * TMA zero-fills x and w past N, K and C (so rows past N add nothing to
//     the sums) and the TMA store drops the parts of y past N and C: the
//     ragged shapes need no masks;
//   * at the end, a fixed-order reduction (warp shuffles over the fragment
//     rows, then the eight row warps through shared memory) writes one
//     partial per column per CTA: no atomics, deterministic.
// The TPU kernel carries s1 and s2 in VMEM across its sequential
// ("arbitrary") row grid; CTAs here run unordered, so each keeps its own
// partial and the caller adds the G partials.
//
// Shapes: any N >= 1; K and C multiples of 8 (TMA's 16-byte row strides);
// the [K, 128] column block of w must fit in shared memory beside two x
// stages and the y staging tiles, so K <= 640.  No backward: the TPU
// kernel has none.
//
// Plain C interface, loaded with ctypes (horovod_tpu_torch/ops/_build.py).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kBM = 128;                      // rows per tile
constexpr int kBN = 128;                      // channels per column block
constexpr int kBK = 64;                       // k per ring stage
constexpr int kStage = kBM * kBK * 2;         // bytes of an x stage
constexpr int kWChunk = kBK * kBN * 2;        // bytes of w per 64 k
constexpr int kYTile = 64 * kBN * 2;          // a consumer's staging tile
constexpr int kSmemMax = 232448;              // shared memory a CTA may use
constexpr int kMapError = -2;                 // a TMA map could not be encoded

// K rounded up to whole 64-k chunks.
__host__ __device__ __forceinline__ int k_chunks(int K) {
  return (K + kBK - 1) / kBK;
}

// Shared memory, byte offsets from the 1024-aligned base: w's column
// block, the x ring, the two consumers' y tiles, the barriers.
struct Smem {
  int w, x, y, bar, bytes;
  __host__ __device__ Smem(int K, int stages) {
    w = 0;
    x = w + k_chunks(K) * kWChunk;
    y = x + stages * kStage;
    bar = y + 2 * kYTile;
    bytes = bar + (2 * stages + 1) * 8 + 1024;
  }
};

// The deepest ring (4, 3 or 2 stages) that fits beside w; 0 if K is out of
// range (the wrapper's MAX_K, ops/conv_bn_stats.py, is the largest K it
// accepts).
int stages_for(int K) {
  if (K < 8 || K % 8) return 0;
  for (int s = 4; s >= 2; --s)
    if (Smem(K, s).bytes <= kSmemMax) return s;
  return 0;
}

// hvd_conv_bn_stats <- _kernel, experiments/pallas_conv_bn_spike.py:39.
// Bound by bytes: x read once, y written once (w and the partials are
// ~0.1 % at the stage-2 shape).
template <int kS>
__global__ void __launch_bounds__(kHThreads, 1)
    conv_bn_stats_kernel(const __grid_constant__ CUtensorMap tx,
                         const __grid_constant__ CUtensorMap tw,
                         const __grid_constant__ CUtensorMap ty,
                         float* __restrict__ parts, int N, int K, int C) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align_smem(smem_raw);
  const Smem L(K, kS);
  bf16* Ws = reinterpret_cast<bf16*>(sm + L.w);
  bf16* Xs = reinterpret_cast<bf16*>(sm + L.x);
  unsigned char* Ys = sm + L.y;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L.bar);
  uint64_t* empty = full + kS;
  uint64_t* wfull = empty + kS;
  const int nk = k_chunks(K);
  const int n0 = blockIdx.y * kBN;
  const int n_tiles = (N + kBM - 1) / kBM;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * kWG);
    }
    mbar_init(wfull, 1);
    fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x < kWG) {   // producer: one thread
    regs_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(wfull, nk * kWChunk);
      for (int kc = 0; kc < nk; ++kc)
        for (int h = 0; h < 2; ++h)
          tma_load_2d(Ws + kc * kBK * kBN + h * kBK * kSwz, &tw, wfull,
                      n0 + h * kSwz, kc * kBK);
      int it = 0;   // x stages loaded so far: the ring's position
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        for (int kc = 0; kc < nk; ++kc, ++it) {
          const int s = it % kS;
          mbar_wait(&empty[s], ((it / kS) & 1) ^ 1);
          mbar_expect_tx(&full[s], kStage);
          tma_load_2d(Xs + s * kBM * kBK, &tx, &full[s], kc * kBK,
                      tile * kBM);
        }
      }
    }
    return;
  }
  regs_inc<kConsumerRegs>();

  const int cw = threadIdx.x / kWG - 1;   // consumer warpgroup: 64 rows
  const int tc = threadIdx.x - kWG;       // consumer thread, 0..255
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  unsigned char* Yt = Ys + cw * kYTile;   // [2 boxes][64 rows][128 bytes]
  const bool leader = threadIdx.x % kWG == 0;
  float s1[32], s2[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s1[i] = s2[i] = 0.f;

  mbar_wait(wfull, 0);
  int it = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    float acc[64];
    for (int kc = 0; kc < nk; ++kc, ++it) {
      const int s = it % kS;
      mbar_wait(&full[s], (it / kS) & 1);
      const bf16* Xt = Xs + s * kBM * kBK;
      const bf16* Wt = Ws + kc * kBK * kBN;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks)
        mma_ss_tb(acc, desc_k<kBM>(Xt, cw * 64, ks), desc_mn<kBK>(Wt, ks),
                  kc > 0 || ks > 0);
      wgmma_commit();
      if (kc > 0) {   // the previous stage's products are done: free it
        wgmma_wait1();
        mbar_arrive(&empty[(it - 1) % kS]);
      }
    }
    wgmma_wait0();
    fence_regs(acc);
    mbar_arrive(&empty[(it - 1) % kS]);

    // Statistics of the fp32 y: thread (g, t) of warp `warp` holds rows
    // warp*16 + g and + 8, columns nt*8 + 2t and + 1 of each n8 block nt.
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float a = acc[nt * 4 + j], b = acc[nt * 4 + 2 + j];
        s1[nt * 2 + j] += a + b;
        s2[nt * 2 + j] += a * a + b * b;
      }
    }
    // y as bf16 into the staging tile, once the previous tile's store has
    // read it: box h holds channels h*64.., a row's 16-byte chunk c at
    // c ^ (row % 8) (TMA's 128-byte swizzle; rows r and r + 8 share it).
    if (leader) bulk_wait_read0();
    named_sync(1 + cw, kWG);
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
      const int r = warp * 16 + g;
      unsigned char* p = Yt + (nt / 8) * (kYTile / 2) + r * 128 +
                         (((nt % 8) ^ g) << 4) + t * 4;
      *reinterpret_cast<uint32_t*>(p) =
          pack_bf16(acc[nt * 4], acc[nt * 4 + 1]);
      *reinterpret_cast<uint32_t*>(p + 8 * 128) =
          pack_bf16(acc[nt * 4 + 2], acc[nt * 4 + 3]);
    }
    fence_proxy_async();
    named_sync(1 + cw, kWG);
    if (leader) {
      const int row = tile * kBM + cw * 64;
      tma_store_2d(&ty, Yt, n0, row);
      tma_store_2d(&ty, Yt + kYTile / 2, n0 + kSwz, row);
      bulk_commit();
    }
  }

  // The CTA's partials: sum the 8 fragment rows of each warp (lanes that
  // share t), then the eight row warps in order, through the x ring (every
  // stage has been consumed, and no load is in flight).
  named_sync(3, 2 * kWG);
  float* red = reinterpret_cast<float*>(Xs);   // [2][8][kBN]
  const int rw = cw * 4 + warp;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    float a = s1[i], b = s2[i];
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, o);
      b += __shfl_xor_sync(0xffffffffu, b, o);
    }
    if (g == 0) {
      const int cl = (i / 2) * 8 + 2 * t + (i & 1);
      red[rw * kBN + cl] = a;
      red[(8 + rw) * kBN + cl] = b;
    }
  }
  named_sync(3, 2 * kWG);
  const int which = tc / kBN, cl = tc % kBN, col = n0 + cl;
  if (col < C) {
    float v = 0.f;
#pragma unroll
    for (int m = 0; m < 8; ++m) v += red[(which * 8 + m) * kBN + cl];
    parts[(static_cast<size_t>(which) * gridDim.x + blockIdx.x) * C + col] =
        v;
  }
  if (leader) bulk_wait0();   // y's last stores complete before the exit
}

// The 2-D map (cols, rows) of a contiguous bf16 [rows, cols] tensor, in
// 128-byte-swizzled boxes of [box_rows][64 cols]; outside the tensor a
// load reads zeros and a store writes nothing.
bool map_2d(CUtensorMap* map, const void* p, int rows, int cols,
            int box_rows) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) *
                                 sizeof(bf16)};
  const cuuint32_t box[2] = {kSwz, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t step[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p),
             dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kS>
int launch(const CUtensorMap& tx, const CUtensorMap& tw,
           const CUtensorMap& ty, float* parts, int N, int K, int C,
           int grid_rows, cudaStream_t stream) {
  const int smem = Smem(K, kS).bytes;
  if (cudaError_t err = cudaFuncSetAttribute(
          conv_bn_stats_kernel<kS>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem))
    return static_cast<int>(err);
  const dim3 grid(grid_rows, (C + kBN - 1) / kBN);
  conv_bn_stats_kernel<kS><<<grid, kHThreads, smem, stream>>>(
      tx, tw, ty, parts, N, K, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: contiguous bf16 [N, K]; w: contiguous bf16 [K, C]; y: contiguous bf16
// [N, C]; parts: contiguous fp32 [2, grid_rows, C].  All 16-byte aligned,
// on the current device; launches on `stream`, allocates nothing.
// grid_rows: CTAs along the rows, 1 <= grid_rows <= ceil(N / 128).
// Returns 0, a cudaError_t from the launch, -1 for an unsupported shape,
// or -2 if a TMA map could not be encoded.
extern "C" int hvd_conv_bn_stats(const void* x, const void* w, void* y,
                                 void* parts, int N, int K, int C,
                                 int grid_rows, void* stream) {
  const int stages = stages_for(K);
  if (N < 1 || stages == 0 || C < 8 || C % 8) return -1;
  const int n_tiles = (N + kBM - 1) / kBM;
  if (grid_rows < 1 || grid_rows > n_tiles) return -1;
  CUtensorMap tx{}, tw{}, ty{};
  if (!map_2d(&tx, x, N, K, kBM) || !map_2d(&tw, w, K, C, kBK) ||
      !map_2d(&ty, y, N, C, 64))
    return kMapError;
  float* p = static_cast<float*>(parts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (stages) {
    case 4: return launch<4>(tx, tw, ty, p, N, K, C, grid_rows, s);
    case 3: return launch<3>(tx, tw, ty, p, N, K, C, grid_rows, s);
    default: return launch<2>(tx, tw, ty, p, N, K, C, grid_rows, s);
  }
}
