// Flash attention, forward and backward, for NVIDIA Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of horovod_tpu/ops/flash_attention.py:
//
//   hvd_flash_fwd     <- _fwd_kernel      out, lse from q, k, v
//   hvd_flash_bwd_dq  <- _bwd_dq_kernel   dq from q, k, v, dout, lse, delta
//   hvd_flash_bwd_dkv <- _bwd_dkv_kernel  dk, dv from the same inputs
//
// Same functions, not the same blocks: scores are fp32 dot products scaled
// AFTER the dot by an fp32 sm_scale; masked scores are -1e30 (not -inf) and
// the running max starts at -1e30; probabilities are rounded to v's dtype
// before P.V (forward) and to dout's dtype before P^T.dout (dV); dS is
// rounded to the q/k dtype before dS.K and dS^T.Q; out = acc / max(l,
// 1e-30) and lse = m + log(max(l, 1e-30)).  The bf16 kernels take their
// exponentials as 2^x of scores in log2 units (log2(e) folded into the
// scale, the key bias and lse: one FFMA and one ex2.approx a score, where
// expf costs about ten instructions and the softmax, not the products,
// bounds them); the plain versions keep the reference's exp of
// natural-unit scores.  The two differ by a few fp32 ulps of P, which the
// bf16 rounding of P and the tolerances that hold each kernel to its
// plain version absorb.  The fp32 kernels use expf.  Causal key tiles
// above the diagonal are skipped by the loop bound, not masked, for any
// ratio of query tile to key tile.  Packed rows (optional int32
// segment starts, the reference's seg_ref) add the mask key < start[query]
// and skip the key tiles below a query tile's first start (forward, dq)
// and the query tiles past the last row that can see a key tile (dk/dv),
// so packing saves the FLOPs of the masked blocks, as on the TPU.  Key
// padding (optional fp32 [B, S] additive key bias, the reference's
// bias_ref: 0 for a valid key, -1e30 for a masked one) adds bias[b, key] to
// every score of batch row b after the scale and the causal mask, as the
// reference adds it; one row serves every head, and no tile is skipped.
// Segments and the key bias are exclusive (as in the reference), and each
// kernel is compiled once per sideband kind, so the dense and packed paths
// run no code of the others.  delta = rowsum(dout * out) - g_lse is
// computed by the caller (fp32, [B, Hq, S]).
//
// Layout: q/out/dout/dq are contiguous [B, S, Hq, D], k/v/dk/dv contiguous
// [B, S, Hkv, D], indexed in place (no [B*H, S, D] transpose and no repeat
// of the KV heads); lse/delta are [B, Hq, S] fp32 (no sublane-replicated
// [8, S] copy).  GQA: query head h reads KV head h / G.  The tail of a
// sequence that is not a multiple of the tile is masked here: out-of-range
// rows are loaded as zeros and their keys masked to -1e30.
//
// What bounds them on this card: operations.  At the training shape (B 2,
// S 2048, Hq 32, D 128, causal) the forward does two causal products,
// 4 * B * Hq * S^2 * D / 2 = 68.7 GFLOP, against 16.8 MB of q/k/v/out, so
// ~4000 FLOP per byte, far above the ~295 where the tensor cores become the
// limit; the backward kernels do seven products (dQ 3, dK/dV 4, each
// recomputing the scores) over about twice the bytes.  BERT-base's shape (B
// 32, S 512, 12 heads, D 64, bidirectional, ragged key masks) sits near the
// ridge instead: 4 * B * H * S^2 * D = 25.8 GFLOP against 101 MB, ~255 FLOP
// a byte, so there the bound is bytes, ~0.03 ms.  The design is about
// feeding the tensor cores, with the score matrix never leaving registers:
//
//   * bf16 forward, dq and dk/dv (Hopper): warpgroup-wide wgmma.m64nNk16 with
//     fp32 accumulators in registers, fed by TMA.  A CTA is three
//     warpgroups: the first warp of the first (the producer, its registers
//     cut to 24 by setmaxnreg) issues every load, cp.async.bulk.tensor into
//     a two-stage ring of shared-memory tiles, each
//     stage guarded by a "full" mbarrier (the TMA's byte count) and an
//     "empty" one (the consumers' 256 arrivals); the two others (the
//     consumers, 240 registers) each own 64 rows of the CTA's 128 and run
//     the products, the masks and the softmax.  Tiles are stored as
//     128-byte-swizzled [rows][64] boxes, one box per 64 columns of D (TMA's
//     swizzle span), which is the layout the wgmma shared-memory descriptors
//     read: K-major (advance 32 bytes per k-step inside a box, the next box
//     after 4) where the product contracts over D, MN-major (the
//     instruction's transpose bit, 16 rows per k-step, the next box 64
//     columns on) where it contracts over the tile's rows.  The TMA maps are
//     4-D (D, H, S, B), so a box that runs past S is zero-filled and never
//     reads the next batch row.  lse, delta, segment starts and the key bias
//     are a few hundred bytes a stage, loaded by the producer warp's lanes
//     (before the stage frees) and released by the same arrival as the TMA
//     copies: a TMA box must start 16-byte aligned, which a row of S 4-byte
//     values does not unless S % 4 == 0.  An fp32 accumulator of m64nN is,
//     warp by warp, the C layout of mma.m16n8 tiles, which is the register A
//     layout of the next wgmma, so P and dS are rounded to bf16 in registers
//     and fed straight back.  With 4 work items an SM or more (a query block
//     of a head, or a key block of a KV head) the grid is persistent: one
//     CTA per SM walks the items sorted heaviest first, in a snake order
//     that pairs heavy causal items with light ones, and its producer loads
//     the next item's Q (and dO; or K/V, double-buffered) while the
//     consumers finish the current one, so an item's prologue and
//     epilogue hide behind the neighbour's products (at BERT's shape an
//     item is a few us of products).  With fewer, one CTA an item, which
//     the hardware schedules as SMs free up: a static split of ~2 items a
//     CTA balances data-dependent (packed) work badly.  What bounds them
//     in practice is the softmax's per-score instructions, not the
//     products (a 128 x 128 tile took about as long at D 64 as at D 128):
//     hence 2^x with the scale folded into one FFMA, and the scale left
//     out of tiles with no mask.
//     Ordering the two consumers' products against each other (named-barrier
//     ping-pong) and issuing the next tile's S with this tile's P.V were
//     both slower on the card.
//   * forward: items of (128 query rows, batch, head), 128-key tiles: with
//     D 128 the score accumulator (64) and the output accumulator (64)
//     take 128 of a consumer's 240 registers and the packed P 32, and two
//     stages of K and V (128 KB) and two Q tiles (64 KB) fit the 227 KB of
//     shared memory; 128 keys halve the tiles (and the softmax rescales)
//     of 64, and wider tiles would not fit.
//   * dk/dv: items of (128 keys, batch, KV head), 64 keys per consumer,
//     looping over the G query heads of the group and over 64-row query
//     tiles from the diagonal down (packed rows stop at the last row that
//     sees the block); K and V stay in shared memory for the whole loop.
//     dK and dV accumulate in fp32 registers across the whole group (128
//     of the 240 at D 128): no atomics and a fixed order, deterministic,
//     equal to the reference's repeat-then-sum.  The products run in the
//     order S^T = K.Q^T; P^T; dP^T = V.dO^T with dV += P^T.dO; dS^T; dK
//     += dS^T.Q, so no more than one transient 64x64 pair is live beside
//     the accumulators.
//   * dq: items of (128 query rows, batch, head), the forward's items and
//     order, 64-key steps: the producer loads the item's Q and dO tiles
//     once (double-buffered across items, with the rows' lse and delta by
//     its lanes) and streams 64-key K/V tiles through the ring; each
//     consumer runs S = Q.K^T and dP = dO.V^T (both operands K-major in
//     shared memory), P = 2^(S*scale*log2(e) - lse*log2(e)) with the
//     kind's mask, dS = P*(dP - delta)*scale rounded to bf16 in registers,
//     and dQ += dS.K with K as the MN-major operand (the contraction runs
//     over the tile's rows, as dS^T.Q in dk/dv).  64 keys a step keep S
//     and dP at 32 registers each beside the 64 x D fp32 dQ accumulator (64
//     at D 128) and the packed dS (16); 128 keys would need 192 + 32 and
//     spill.  Each item owns its rows' dQ: no atomics, deterministic.  dq
//     stays a kernel of its own (the reference's split).
//   * fp32 inputs: the tensor cores would round them to TF32, so fp32 runs
//     a plain FMA kernel per function (one thread per query row, or per key
//     row and role for dk/dv) on 64-row tiles.  It exists for exactness,
//     not speed: its bound is 67 TFLOP/s of fp32 FMA.
//
// The TMA maps are encoded on the host per call (cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint, so nothing links libcuda) and
// passed as __grid_constant__ kernel parameters.  Plain C interface,
// loaded with ctypes (horovod_tpu_torch/ops/_build.py).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;   // the reference's mask value
constexpr float kTiny = 1e-30f;     // the reference's floor on l
constexpr int kBM = 64;             // query rows per CTA (fp32 fwd, dq)
constexpr int kBN = 64;             // keys per tile (fp32 fwd, dq) or per
                                    // CTA (fp32 dkv)
constexpr int kBQ = 32;             // query rows per tile (fp32 dkv)

// Sideband kinds: each kernel is instantiated once per kind.
constexpr int kDense = 0;      // none
constexpr int kSegments = 1;   // int32 [B, S] segment starts (packed rows)
constexpr int kKeyBias = 2;    // fp32 [B, S] additive key bias (key padding)

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---------------------------------------------------------------------------
// Packed segments (the reference's seg_ref sideband)
// ---------------------------------------------------------------------------
//
// `sb` is one batch row's int32 [S] segment starts: query row r attends
// keys [sb[r], r].  Starts never decrease along a row, which the three
// bounds below rely on.  kSeg is true in the kSegments instantiation only.

// Segment start of query row `row`; 0 without segments or past S.
template <bool kSeg>
__device__ __forceinline__ int seg_start(const int* sb, int row, int S) {
  if constexpr (kSeg) return row < S ? sb[row] : 0;
  return 0;
}

// First kKeys-key tile of the query tile starting at row q0 (< S): its
// first row has the tile's smallest start, so every earlier key tile is
// masked for all its rows and is skipped — the reference's kv_first.
template <bool kSeg, int kKeys>
__device__ __forceinline__ int first_tile(const int* sb, int q0) {
  if constexpr (kSeg) return sb[q0] / kKeys;
  return 0;
}

// Query rows that can see the kKeys-key block starting at k0: the rows
// whose start is at most the block's last key, a prefix of the rows (binary
// search), at least k0 + 1 since row r's start is at most r.  S without
// segments.  The reference's n_q_live.
template <bool kSeg, int kKeys>
__device__ __forceinline__ int q_rows(const int* sb, int k0, int S) {
  if constexpr (!kSeg) return S;
  const int last = min(k0 + kKeys, S) - 1;
  int lo = 0, hi = S;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sb[mid] <= last) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// ---------------------------------------------------------------------------
// Tiles of the bf16 kernels (the Hopper building blocks are hopper.cuh's)
// ---------------------------------------------------------------------------

constexpr int kFwdM = 128;            // query rows per CTA (forward)
constexpr int kFwdN = 128;            // keys per tile (forward)
constexpr int kDkvN = 128;            // keys per CTA (dk/dv)
constexpr int kDkvM = 64;             // query rows per tile (dk/dv)
constexpr int kDqN = 64;              // keys per step (dq)
constexpr int kStages = 2;            // depth of the TMA ring (4 at D 64
                                      // measured no faster)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNegInf2 = kNegInf * kLog2e;   // the mask value in log2 units

// 2^x in one MUFU instruction (results below 2^-126 flush to 0, far
// below what a softmax row's sum of at least 1 can see).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The barriers of a Hopper kernel, laid out [full][empty] for the ring's
// kStages stages and then [full][empty] for the double buffer's 2: a full
// one completes on the producer's one arrival (with its TMA bytes), an
// empty one on the two consumer warpgroups' 256.  Thread 0 initialises
// them; the caller synchronises.
__device__ __forceinline__ void init_barriers(uint64_t* full) {
  if (threadIdx.x != 0) return;
  uint64_t* empty = full + kStages;
  for (int s = 0; s < kStages; ++s) {
    mbar_init(&full[s], 1);
    mbar_init(&empty[s], 2 * kWG);
  }
  for (int s = 0; s < 2; ++s) {
    mbar_init(&empty[kStages + s], 1);
    mbar_init(&empty[kStages + 2 + s], 2 * kWG);
  }
  fence_mbar_init();
}

// kRows rows (from row0) of one head of a [B, S, H, D] tensor through its
// 4-D map: D / 64 swizzled boxes of [kRows][64], one after the other.
template <int D, int kRows>
__device__ __forceinline__ void tma_rows(bf16* dst, const CUtensorMap* map,
                                         uint64_t* bar, int head, int row0,
                                         int b) {
#pragma unroll
  for (int c = 0; c < D / kSwz; ++c)
    tma_load_4d(dst + c * kRows * kSwz, map, bar, c * kSwz, head, row0, b);
}

// ---------------------------------------------------------------------------
// bf16 forward and dk/dv kernels (wgmma, TMA, warp-specialised)
// ---------------------------------------------------------------------------

// The CTA's k-th work item, or n_items past its last: a snake order over
// the items sorted heaviest first (CTA c of P takes items c, 2P - 1 - c,
// 2P + c, 4P - 1 - c, ...), which pairs heavy causal items with light ones
// without atomics.  With one CTA an item, CTA c takes item c alone.
__device__ __forceinline__ int snake_item(int k, int n_items) {
  const int P = gridDim.x, c = blockIdx.x;
  const int i = k * P + ((k & 1) ? P - 1 - c : c);
  return i < n_items ? i : n_items;
}

// Shared memory of the forward, byte offsets from the 1024-aligned base.
template <int D>
struct FwdSmem {
  static constexpr int kTileQ = kFwdM * D * 2;
  static constexpr int kTileKV = kFwdN * D * 2;
  static constexpr int kQ = 0;                                // [2] Q tiles
  static constexpr int kK = kQ + 2 * kTileQ;                  // [kStages] tiles
  static constexpr int kV = kK + kStages * kTileKV;           // [kStages] tiles
  static constexpr int kB = kV + kStages * kTileKV;           // bias x log2(e)
  static constexpr int kBar = kB + kStages * kFwdN * 4;       // full, empty, q
  static constexpr int kBytes = kBar + (2 * kStages + 4) * 8 + 1024;
};

// The forward's work item i: query block q0 of (batch b, head h), the
// last (heaviest causal) block of every head first, with its key tiles of
// kKeys keys: from j0, up to n_live.  dq walks the same items in 64-key
// steps.
struct FwdItem {
  int b, h, q0, j0, n_live;
};

template <bool kSeg, int kKeys = kFwdN>
__device__ __forceinline__ FwdItem fwd_item(int i, const int* seg, int B,
                                            int S, int Hq, int causal) {
  const int BH = B * Hq, n_qb = (S + kFwdM - 1) / kFwdM;
  const int n_tiles = (S + kKeys - 1) / kKeys;
  FwdItem w;
  w.b = (i % BH) / Hq;
  w.h = (i % BH) % Hq;
  w.q0 = (n_qb - 1 - i / BH) * kFwdM;
  w.n_live =
      causal ? min((w.q0 + kFwdM + kKeys - 1) / kKeys, n_tiles) : n_tiles;
  w.j0 = first_tile<kSeg, kKeys>(
      kSeg ? seg + static_cast<size_t>(w.b) * S : nullptr, w.q0);
  return w;
}

// hvd_flash_fwd (bf16) <- _fwd_kernel, horovod_tpu/ops/flash_attention.py:113.
// Bound by operations: Q.K^T and P.V, 4 * D FLOPs per live (query, key).
// Work items of 128 query rows of one (batch, head); each consumer
// warpgroup keeps its 64 rows' running max, denominator and 64 x D fp32
// accumulator in registers while the producer streams 128-key K/V tiles
// (and the key bias) through the ring, and the next item's Q into the
// other of two Q buffers.
template <int D, int kSide>
__global__ void __launch_bounds__(kHThreads, 1)
    fwd_bf16(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv, bf16* __restrict__ out,
             float* __restrict__ lse, const int* __restrict__ seg,
             const float* __restrict__ bias, int B, int S, int Hq, int Hkv,
             float sm_scale, int causal) {
  using L = FwdSmem<D>;
  constexpr bool kSeg = kSide == kSegments, kBias = kSide == kKeyBias;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align_smem(smem_raw);
  bf16* Qs = reinterpret_cast<bf16*>(sm + L::kQ);
  bf16* Ks = reinterpret_cast<bf16*>(sm + L::kK);
  bf16* Vs = reinterpret_cast<bf16*>(sm + L::kV);
  float* Bs = reinterpret_cast<float*>(sm + L::kB);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kBar);
  uint64_t* empty = full + kStages;
  uint64_t* qfull = empty + kStages;   // [2]
  uint64_t* qempty = qfull + 2;        // [2]
  const int n_items = B * Hq * ((S + kFwdM - 1) / kFwdM);

  init_barriers(full);
  __syncthreads();

  if (threadIdx.x < kWG) {   // producer: the first warp
    regs_dec<kProducerRegs>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      int it = 0;   // K/V tiles loaded so far: the ring's position
      for (int n = 0, i; (i = snake_item(n, n_items)) < n_items; ++n) {
        const FwdItem w = fwd_item<kSeg>(i, seg, B, S, Hq, causal);
        const int qb = n & 1, hk = w.h / (Hq / Hkv);
        mbar_wait(&qempty[qb], ((n >> 1) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(&qfull[qb], L::kTileQ);
          tma_rows<D, kFwdM>(Qs + qb * kFwdM * D, &tq, &qfull[qb], w.h, w.q0,
                             w.b);
        }
        const float* bb =
            kBias ? bias + static_cast<size_t>(w.b) * S : nullptr;
        for (int j = w.j0; j < w.n_live; ++j, ++it) {
          const int s = it % kStages;
          // The key tile's bias, by the lanes, read before the stage frees.
          float bv[kFwdN / 32];
          if constexpr (kBias) {
#pragma unroll
            for (int c = 0; c < kFwdN / 32; ++c) {
              const int key = j * kFwdN + c * 32 + lane;
              bv[c] = key < S ? bb[key] * kLog2e : 0.f;
            }
          }
          mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
          if constexpr (kBias) {
#pragma unroll
            for (int c = 0; c < kFwdN / 32; ++c)
              Bs[s * kFwdN + c * 32 + lane] = bv[c];
            __syncwarp();
          }
          if (lane == 0) {   // its arrival releases the lanes' stores too
            mbar_expect_tx(&full[s], 2 * L::kTileKV);
            tma_rows<D, kFwdN>(Ks + s * kFwdN * D, &tk, &full[s], hk,
                               j * kFwdN, w.b);
            tma_rows<D, kFwdN>(Vs + s * kFwdN * D, &tv, &full[s], hk,
                               j * kFwdN, w.b);
          }
        }
      }
    }
    return;
  }
  regs_inc<kConsumerRegs>();

  const int cw = threadIdx.x / kWG - 1;   // consumer warpgroup: 64 rows
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t qs = static_cast<size_t>(Hq) * D;
  const float scale2 = sm_scale * kLog2e;
  int it = 0;
  for (int n = 0, i; (i = snake_item(n, n_items)) < n_items; ++n) {
    const FwdItem w = fwd_item<kSeg>(i, seg, B, S, Hq, causal);
    const int* sb = kSeg ? seg + static_cast<size_t>(w.b) * S : nullptr;
    const int r_first = w.q0 + cw * 64;          // the warpgroup's first row
    const int row0 = r_first + warp * 16 + g;    // this thread's: row0, +8
    const int st[2] = {seg_start<kSeg>(sb, row0, S),
                       seg_start<kSeg>(sb, row0 + 8, S)};
    float acc[D / 2];
#pragma unroll
    for (int k = 0; k < D / 2; ++k) acc[k] = 0.f;
    float m[2] = {kNegInf2, kNegInf2}, l[2] = {0.f, 0.f};   // log2 units
    const int qb = n & 1;
    const bf16* Qt = Qs + qb * kFwdM * D;

    mbar_wait(&qfull[qb], (n >> 1) & 1);
    for (int j = w.j0; j < w.n_live; ++j, ++it) {
      const int s = it % kStages;
      mbar_wait(&full[s], (it / kStages) & 1);
      const bf16* Kt = Ks + s * kFwdN * D;
      const bf16* Vt = Vs + s * kFwdN * D;
      const float* Bt = Bs + s * kFwdN;

      float sc[kFwdN / 2];
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        mma_ss(sc, desc_k<kFwdM>(Qt, cw * 64, ks), desc_k<kFwdN>(Kt, 0, ks),
               ks);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(sc);

      // Only the diagonal tile and the ragged last one pay for the causal
      // and tail masks (whole-warpgroup decision).
      const int k_first = j * kFwdN;
      const bool edge = k_first + kFwdN > S ||
                        (causal && k_first + kFwdN - 1 > r_first);
      // A tile with no mask keeps the raw scores: the scale rides the
      // exponent's FFMA (max(s) * scale is max(s * scale), both rounded
      // once).  Otherwise the scores are scaled (the bias in the same
      // FFMA) and masked first.
      const bool raw = !kSeg && !kBias && !edge;
      float mx[2] = {-3e38f, -3e38f};   // below every score
#pragma unroll
      for (int nt = 0; nt < kFwdN / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = nt * 8 + t * 2 + (e & 1);
          const int row = row0 + (e >> 1) * 8, col = k_first + c;
          float x = sc[nt * 4 + e];
          if (!raw) {
            if constexpr (kBias) {   // the reference's order: causal, bias
              x = edge && causal && col > row ? kNegInf2 + Bt[c]
                                              : fmaf(x, scale2, Bt[c]);
              if (edge && col >= S) x = kNegInf2;
            } else {
              x *= scale2;
              if (col >= S || (causal && col > row) ||
                  (kSeg && col < st[e >> 1]))
                x = kNegInf2;
            }
            sc[nt * 4 + e] = x;
          }
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(m[r], quad_max(raw ? mx[r] * scale2 : mx[r]));
        alpha[r] = ex2(m[r] - mx[r]);
        m[r] = mx[r];
      }
      const float mul = raw ? scale2 : 1.f;
#pragma unroll
      for (int k = 0; k < kFwdN / 2; ++k) {
        const float p = ex2(fmaf(sc[k], mul, -m[(k >> 1) & 1]));
        sc[k] = p;
        rs[(k >> 1) & 1] += p;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(rs[r]);
#pragma unroll
      for (int k = 0; k < D / 2; ++k) acc[k] *= alpha[(k >> 1) & 1];

      uint32_t pa[kFwdN / 16][4];
#pragma unroll
      for (int kk = 0; kk < kFwdN / 16; ++kk) pack_a(pa[kk], sc, kk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kFwdN / 16; ++kk)
        mma_rs(acc, pa[kk], desc_mn<kFwdN>(Vt, kk));
      wgmma_commit();
      wgmma_wait0();
      fence_regs(acc);
      mbar_arrive(&empty[s]);
    }
    mbar_arrive(&qempty[qb]);

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + r * 8;
      if (row >= S) continue;
      const float lc = fmaxf(l[r], kTiny);
      bf16* ob = out + (static_cast<size_t>(w.b) * S + row) * qs + w.h * D;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
        *reinterpret_cast<uint32_t*>(ob + dt * 8 + t * 2) =
            pack_bf16(acc[dt * 4 + 2 * r] / lc, acc[dt * 4 + 2 * r + 1] / lc);
      if (t == 0)
        lse[(static_cast<size_t>(w.b) * Hq + w.h) * S + row] =
            (m[r] + log2f(lc)) * kLn2;
    }
  }
}

// Shared memory of dk/dv, byte offsets from the 1024-aligned base.
template <int D>
struct DkvSmem {
  static constexpr int kTileKV = kDkvN * D * 2;
  static constexpr int kTileQ = kDkvM * D * 2;
  static constexpr int kK = 0;                                // [2] K tiles
  static constexpr int kV = kK + 2 * kTileKV;                 // [2] V tiles
  static constexpr int kQ = kV + 2 * kTileKV;                 // [kStages] tiles
  static constexpr int kO = kQ + kStages * kTileQ;            // dout tiles
  static constexpr int kL = kO + kStages * kTileQ;            // lse x log2(e)
  static constexpr int kDl = kL + kStages * kDkvM * 4;        // delta x scale
  static constexpr int kSg = kDl + kStages * kDkvM * 4;       // int32 starts
  static constexpr int kBar = kSg + kStages * kDkvM * 4;      // full, empty, kv
  static constexpr int kBytes = kBar + (2 * kStages + 4) * 8 + 1024;
};

// The dk/dv work item i: key block k0 of (batch b, KV head hk), the first
// (heaviest causal) block of every head first, with the query tiles it
// walks: from first_q, n_live of them for each of the G heads.
struct DkvItem {
  int b, hk, k0, first_q, n_live;
};

template <bool kSeg>
__device__ __forceinline__ DkvItem dkv_item(int i, const int* seg, int B,
                                            int S, int Hkv, int causal) {
  const int BH = B * Hkv;
  DkvItem w;
  w.b = (i % BH) / Hkv;
  w.hk = (i % BH) % Hkv;
  w.k0 = (i / BH) * kDkvN;
  w.first_q = causal ? w.k0 / kDkvM : 0;   // tiles from the diagonal
  // Query tiles that can see this key block (segments: a prefix of rows);
  // at least one, since row k0 sees key k0.
  const int n_q = (q_rows<kSeg, kDkvN>(
                       kSeg ? seg + static_cast<size_t>(w.b) * S : nullptr,
                       w.k0, S) +
                   kDkvM - 1) /
                  kDkvM;
  w.n_live = n_q - w.first_q;
  return w;
}

// hvd_flash_bwd_dkv (bf16) <- _bwd_dkv_kernel, flash_attention.py:329.
// Bound by operations: four products (K.Q^T, V.dO^T, P^T.dO, dS^T.Q),
// 8 * D FLOPs per live pair.  Work items of 128 keys of one (batch, KV
// head), transposed so keys are the rows: each consumer warpgroup keeps
// its 64 keys' dK and dV in registers across the G query heads and every
// 64-row query tile, which the producer streams with their lse, delta
// (and segment starts); the next item's K and V go to the other of two
// K/V buffers.
template <int D, int kSide>
__global__ void __launch_bounds__(kHThreads, 1)
    bwd_dkv_bf16(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap tdo,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ dk,
                 bf16* __restrict__ dv, const int* __restrict__ seg,
                 const float* __restrict__ bias, int B, int S, int Hq,
                 int Hkv, float sm_scale, int causal) {
  using L = DkvSmem<D>;
  constexpr bool kSeg = kSide == kSegments, kBias = kSide == kKeyBias;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align_smem(smem_raw);
  bf16* Ks = reinterpret_cast<bf16*>(sm + L::kK);
  bf16* Vs = reinterpret_cast<bf16*>(sm + L::kV);
  bf16* Qs = reinterpret_cast<bf16*>(sm + L::kQ);
  bf16* dOs = reinterpret_cast<bf16*>(sm + L::kO);
  float* Ls = reinterpret_cast<float*>(sm + L::kL);
  float* Ds = reinterpret_cast<float*>(sm + L::kDl);
  int* Ss = reinterpret_cast<int*>(sm + L::kSg);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kBar);
  uint64_t* empty = full + kStages;
  uint64_t* kvfull = empty + kStages;   // [2]
  uint64_t* kvempty = kvfull + 2;       // [2]
  const int G = Hq / Hkv;
  const int n_items = B * Hkv * ((S + kDkvN - 1) / kDkvN);

  init_barriers(full);
  __syncthreads();

  if (threadIdx.x < kWG) {   // producer: the first warp
    regs_dec<kProducerRegs>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      int it = 0;   // query tiles loaded so far: the ring's position
      for (int n = 0, i; (i = snake_item(n, n_items)) < n_items; ++n) {
        const DkvItem w = dkv_item<kSeg>(i, seg, B, S, Hkv, causal);
        const int kb = n & 1;
        mbar_wait(&kvempty[kb], ((n >> 1) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(&kvfull[kb], 2 * L::kTileKV);
          tma_rows<D, kDkvN>(Ks + kb * kDkvN * D, &tk, &kvfull[kb], w.hk,
                             w.k0, w.b);
          tma_rows<D, kDkvN>(Vs + kb * kDkvN * D, &tv, &kvfull[kb], w.hk,
                             w.k0, w.b);
        }
        const int* sb = kSeg ? seg + static_cast<size_t>(w.b) * S : nullptr;
        for (int q = 0; q < G * w.n_live; ++q, ++it) {
          const int h = w.hk * G + q / w.n_live;
          const int qt0 = (w.first_q + q % w.n_live) * kDkvM;
          const int s = it % kStages;
          // The tile's lse, delta (and segment starts), by the lanes, read
          // before the stage frees: a TMA box must start 16-byte aligned,
          // and (b, h, qt0)'s row of [B, Hq, S] fp32 does not unless S % 4
          // == 0.  Rows past S: 0.
          const size_t r = (static_cast<size_t>(w.b) * Hq + h) * S;
          float lv[kDkvM / 32], dl[kDkvM / 32];
          int sv[kDkvM / 32];
#pragma unroll
          for (int c = 0; c < kDkvM / 32; ++c) {
            const int row = qt0 + c * 32 + lane;
            lv[c] = row < S ? lse[r + row] * kLog2e : 0.f;
            dl[c] = row < S ? delta[r + row] * sm_scale : 0.f;
            sv[c] = seg_start<kSeg>(sb, row, S);
          }
          mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
#pragma unroll
          for (int c = 0; c < kDkvM / 32; ++c) {
            Ls[s * kDkvM + c * 32 + lane] = lv[c];
            Ds[s * kDkvM + c * 32 + lane] = dl[c];
            if constexpr (kSeg) Ss[s * kDkvM + c * 32 + lane] = sv[c];
          }
          __syncwarp();
          if (lane == 0) {   // its arrival releases the lanes' stores too
            mbar_expect_tx(&full[s], 2 * L::kTileQ);
            tma_rows<D, kDkvM>(Qs + s * kDkvM * D, &tq, &full[s], h, qt0,
                               w.b);
            tma_rows<D, kDkvM>(dOs + s * kDkvM * D, &tdo, &full[s], h, qt0,
                               w.b);
          }
        }
      }
    }
    return;
  }
  regs_inc<kConsumerRegs>();

  const int cw = threadIdx.x / kWG - 1;   // consumer warpgroup: 64 keys
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t kv_stride = static_cast<size_t>(Hkv) * D;
  const float scale2 = sm_scale * kLog2e;
  int it = 0;
  for (int n = 0, i; (i = snake_item(n, n_items)) < n_items; ++n) {
    const DkvItem w = dkv_item<kSeg>(i, seg, B, S, Hkv, causal);
    const int k_first = w.k0 + cw * 64;        // the warpgroup's first key
    const int key0 = k_first + warp * 16 + g;  // this thread's: key0, +8
    // The key bias is a function of the key alone: two registers a thread.
    float kbias[2] = {0.f, 0.f};
    if constexpr (kBias) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = key0 + r * 8;
        if (key < S)
          kbias[r] = bias[static_cast<size_t>(w.b) * S + key] * kLog2e;
      }
    }
    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int k = 0; k < D / 2; ++k) dk_acc[k] = dv_acc[k] = 0.f;
    const int kb = n & 1;
    const bf16* Kt = Ks + kb * kDkvN * D;
    const bf16* Vt = Vs + kb * kDkvN * D;

    mbar_wait(&kvfull[kb], (n >> 1) & 1);
    for (int q = 0; q < G * w.n_live; ++q, ++it) {
      const int s = it % kStages;
      const int qt0 = (w.first_q + q % w.n_live) * kDkvM;
      mbar_wait(&full[s], (it / kStages) & 1);
      // Causal: a tile whose every row precedes this warpgroup's first key
      // adds nothing (the second warpgroup on the diagonal tile).
      if (!causal || k_first <= qt0 + kDkvM - 1) {
        const bf16* Qt = Qs + s * kDkvM * D;
        const bf16* dOt = dOs + s * kDkvM * D;
        const float* Lt = Ls + s * kDkvM;
        const float* Dt = Ds + s * kDkvM;
        const int* St = Ss + s * kDkvM;

        float sc[kDkvM / 2];   // S^T = K . Q^T, then P^T
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks)
          mma_ss(sc, desc_k<kDkvN>(Kt, cw * 64, ks),
                 desc_k<kDkvM>(Qt, 0, ks), ks);
        wgmma_commit();
        wgmma_wait0();
        fence_regs(sc);

        const bool edge =
            qt0 + kDkvM > S || (causal && k_first + 63 > qt0);
#pragma unroll
        for (int nt = 0; nt < kDkvM / 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = nt * 8 + t * 2 + (e & 1);
            const int key = key0 + (e >> 1) * 8, qrow = qt0 + c;
            // 2^(s * scale - lse), in one FFMA on a tile with no mask.
            float x = sc[nt * 4 + e];
            if constexpr (kBias) {   // the reference's order: causal, bias
              x = edge && causal && key > qrow ? kNegInf2 + kbias[e >> 1]
                                               : fmaf(x, scale2, kbias[e >> 1]);
              if (edge && qrow >= S) x = kNegInf2;
              x -= Lt[c];
            } else if (kSeg || edge) {
              x *= scale2;
              if (qrow >= S || (causal && key > qrow) ||
                  (kSeg && key < St[c]))
                x = kNegInf2;
              x -= Lt[c];
            } else {
              x = fmaf(x, scale2, -Lt[c]);
            }
            sc[nt * 4 + e] = ex2(x);
          }
        }
        uint32_t pa[kDkvM / 16][4];
#pragma unroll
        for (int kk = 0; kk < kDkvM / 16; ++kk) pack_a(pa[kk], sc, kk);

        float dp[kDkvM / 2];   // dP^T = V . dO^T; dV += P^T . dO
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks)
          mma_ss(dp, desc_k<kDkvN>(Vt, cw * 64, ks),
                 desc_k<kDkvM>(dOt, 0, ks), ks);
#pragma unroll
        for (int kk = 0; kk < kDkvM / 16; ++kk)
          mma_rs(dv_acc, pa[kk], desc_mn<kDkvM>(dOt, kk));
        wgmma_commit();
        wgmma_wait0();
        fence_regs(dp);
        fence_regs(dv_acc);

#pragma unroll
        for (int nt = 0; nt < kDkvM / 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int k = nt * 4 + e, c = nt * 8 + t * 2 + (e & 1);
            sc[k] *= fmaf(dp[k], sm_scale, -Dt[c]);   // dS^T (Dt: delta·scale)
          }
        }
#pragma unroll
        for (int kk = 0; kk < kDkvM / 16; ++kk) pack_a(pa[kk], sc, kk);
        wgmma_fence();   // dK += dS^T . Q
#pragma unroll
        for (int kk = 0; kk < kDkvM / 16; ++kk)
          mma_rs(dk_acc, pa[kk], desc_mn<kDkvM>(Qt, kk));
        wgmma_commit();
        wgmma_wait0();
        fence_regs(dk_acc);
      }
      mbar_arrive(&empty[s]);
    }
    mbar_arrive(&kvempty[kb]);

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + r * 8;
      if (key >= S) continue;
      const size_t o = (static_cast<size_t>(w.b) * S + key) * kv_stride +
                       w.hk * D;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        *reinterpret_cast<uint32_t*>(dk + o + dt * 8 + t * 2) =
            pack_bf16(dk_acc[dt * 4 + 2 * r], dk_acc[dt * 4 + 2 * r + 1]);
        *reinterpret_cast<uint32_t*>(dv + o + dt * 8 + t * 2) =
            pack_bf16(dv_acc[dt * 4 + 2 * r], dv_acc[dt * 4 + 2 * r + 1]);
      }
    }
  }
}

// Shared memory of dq, byte offsets from the 1024-aligned base.
template <int D>
struct DqSmem {
  static constexpr int kTileQ = kFwdM * D * 2;
  static constexpr int kTileKV = kDqN * D * 2;
  static constexpr int kQ = 0;                                // [2] Q tiles
  static constexpr int kO = kQ + 2 * kTileQ;                  // [2] dout tiles
  static constexpr int kK = kO + 2 * kTileQ;                  // [kStages] tiles
  static constexpr int kV = kK + kStages * kTileKV;           // [kStages] tiles
  static constexpr int kL = kV + kStages * kTileKV;           // [2] lse·log2e
  static constexpr int kDl = kL + 2 * kFwdM * 4;              // [2] delta·scale
  static constexpr int kB = kDl + 2 * kFwdM * 4;              // bias x log2(e)
  static constexpr int kBar = kB + kStages * kDqN * 4;        // full, empty, q
  static constexpr int kBytes = kBar + (2 * kStages + 4) * 8 + 1024;
};

// hvd_flash_bwd_dq (bf16) <- _bwd_dq_kernel, flash_attention.py:272.
// Bound by operations: Q.K^T again, dO.V^T and dS.K, 6 * D FLOPs per live
// pair.  The forward's work items (128 query rows of one (batch, head)) in
// 64-key steps: each consumer warpgroup keeps its 64 rows' dQ in fp32
// registers while the producer streams K/V tiles (and the key bias)
// through the ring, and the next item's Q, dO, lse and delta into the
// other of two buffers.
template <int D, int kSide>
__global__ void __launch_bounds__(kHThreads, 1)
    bwd_dq_bf16(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap tdo,
                const float* __restrict__ lse,
                const float* __restrict__ delta, bf16* __restrict__ dq,
                const int* __restrict__ seg, const float* __restrict__ bias,
                int B, int S, int Hq, int Hkv, float sm_scale, int causal) {
  using L = DqSmem<D>;
  constexpr bool kSeg = kSide == kSegments, kBias = kSide == kKeyBias;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align_smem(smem_raw);
  bf16* Qs = reinterpret_cast<bf16*>(sm + L::kQ);
  bf16* dOs = reinterpret_cast<bf16*>(sm + L::kO);
  bf16* Ks = reinterpret_cast<bf16*>(sm + L::kK);
  bf16* Vs = reinterpret_cast<bf16*>(sm + L::kV);
  float* Ls = reinterpret_cast<float*>(sm + L::kL);
  float* Ds = reinterpret_cast<float*>(sm + L::kDl);
  float* Bs = reinterpret_cast<float*>(sm + L::kB);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kBar);
  uint64_t* empty = full + kStages;
  uint64_t* qfull = empty + kStages;   // [2]
  uint64_t* qempty = qfull + 2;        // [2]
  const int n_items = B * Hq * ((S + kFwdM - 1) / kFwdM);

  init_barriers(full);
  __syncthreads();

  if (threadIdx.x < kWG) {   // producer: the first warp
    regs_dec<kProducerRegs>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      int it = 0;   // K/V tiles loaded so far: the ring's position
      for (int n = 0, i; (i = snake_item(n, n_items)) < n_items; ++n) {
        const FwdItem w = fwd_item<kSeg, kDqN>(i, seg, B, S, Hq, causal);
        const int qb = n & 1, hk = w.h / (Hq / Hkv);
        // The item's lse and delta, by the lanes, read before the buffer
        // frees: a TMA box must start 16-byte aligned, and (b, h, q0)'s
        // row of [B, Hq, S] fp32 does not unless S % 4 == 0.  Rows past S:
        // 0.
        const size_t r = (static_cast<size_t>(w.b) * Hq + w.h) * S;
        float lv[kFwdM / 32], dl[kFwdM / 32];
#pragma unroll
        for (int c = 0; c < kFwdM / 32; ++c) {
          const int row = w.q0 + c * 32 + lane;
          lv[c] = row < S ? lse[r + row] * kLog2e : 0.f;
          dl[c] = row < S ? delta[r + row] * sm_scale : 0.f;
        }
        mbar_wait(&qempty[qb], ((n >> 1) & 1) ^ 1);
#pragma unroll
        for (int c = 0; c < kFwdM / 32; ++c) {
          Ls[qb * kFwdM + c * 32 + lane] = lv[c];
          Ds[qb * kFwdM + c * 32 + lane] = dl[c];
        }
        __syncwarp();
        if (lane == 0) {   // its arrival releases the lanes' stores too
          mbar_expect_tx(&qfull[qb], 2 * L::kTileQ);
          tma_rows<D, kFwdM>(Qs + qb * kFwdM * D, &tq, &qfull[qb], w.h, w.q0,
                             w.b);
          tma_rows<D, kFwdM>(dOs + qb * kFwdM * D, &tdo, &qfull[qb], w.h,
                             w.q0, w.b);
        }
        const float* bb =
            kBias ? bias + static_cast<size_t>(w.b) * S : nullptr;
        for (int j = w.j0; j < w.n_live; ++j, ++it) {
          const int s = it % kStages;
          float bv[kDqN / 32];
          if constexpr (kBias) {
#pragma unroll
            for (int c = 0; c < kDqN / 32; ++c) {
              const int key = j * kDqN + c * 32 + lane;
              bv[c] = key < S ? bb[key] * kLog2e : 0.f;
            }
          }
          mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
          if constexpr (kBias) {
#pragma unroll
            for (int c = 0; c < kDqN / 32; ++c)
              Bs[s * kDqN + c * 32 + lane] = bv[c];
            __syncwarp();
          }
          if (lane == 0) {
            mbar_expect_tx(&full[s], 2 * L::kTileKV);
            tma_rows<D, kDqN>(Ks + s * kDqN * D, &tk, &full[s], hk,
                              j * kDqN, w.b);
            tma_rows<D, kDqN>(Vs + s * kDqN * D, &tv, &full[s], hk,
                              j * kDqN, w.b);
          }
        }
      }
    }
    return;
  }
  regs_inc<kConsumerRegs>();

  const int cw = threadIdx.x / kWG - 1;   // consumer warpgroup: 64 rows
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t qs = static_cast<size_t>(Hq) * D;
  const float scale2 = sm_scale * kLog2e;
  const int rl = cw * 64 + warp * 16 + g;   // this thread's rows: rl, rl + 8
  int it = 0;
  for (int n = 0, i; (i = snake_item(n, n_items)) < n_items; ++n) {
    const FwdItem w = fwd_item<kSeg, kDqN>(i, seg, B, S, Hq, causal);
    const int* sb = kSeg ? seg + static_cast<size_t>(w.b) * S : nullptr;
    const int r_first = w.q0 + cw * 64;   // the warpgroup's first row
    const int row0 = w.q0 + rl;
    const int st[2] = {seg_start<kSeg>(sb, row0, S),
                       seg_start<kSeg>(sb, row0 + 8, S)};
    float dq_acc[D / 2];
#pragma unroll
    for (int k = 0; k < D / 2; ++k) dq_acc[k] = 0.f;
    const int qb = n & 1;
    const bf16* Qt = Qs + qb * kFwdM * D;
    const bf16* dOt = dOs + qb * kFwdM * D;

    mbar_wait(&qfull[qb], (n >> 1) & 1);
    const float lr[2] = {Ls[qb * kFwdM + rl], Ls[qb * kFwdM + rl + 8]};
    const float dr[2] = {Ds[qb * kFwdM + rl], Ds[qb * kFwdM + rl + 8]};
    for (int j = w.j0; j < w.n_live; ++j, ++it) {
      const int s = it % kStages;
      const int k_first = j * kDqN;
      mbar_wait(&full[s], (it / kStages) & 1);
      // Causal: a tile whose every key follows this warpgroup's last row
      // adds nothing (the first warpgroup on the diagonal's second half).
      if (!causal || k_first <= r_first + 63) {
        const bf16* Kt = Ks + s * kDqN * D;
        const bf16* Vt = Vs + s * kDqN * D;
        const float* Bt = Bs + s * kDqN;

        float sc[kDqN / 2], dp[kDqN / 2];   // S = Q.K^T, dP = dO.V^T
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks)
          mma_ss(sc, desc_k<kFwdM>(Qt, cw * 64, ks), desc_k<kDqN>(Kt, 0, ks),
                 ks);
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks)
          mma_ss(dp, desc_k<kFwdM>(dOt, cw * 64, ks),
                 desc_k<kDqN>(Vt, 0, ks), ks);
        wgmma_commit();
        wgmma_wait0();
        fence_regs(sc);
        fence_regs(dp);

        const bool edge = k_first + kDqN > S ||
                          (causal && k_first + kDqN - 1 > r_first);
#pragma unroll
        for (int nt = 0; nt < kDqN / 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int k = nt * 4 + e, c = nt * 8 + t * 2 + (e & 1);
            const int row = row0 + (e >> 1) * 8, col = k_first + c;
            // 2^(s * scale - lse), in one FFMA on a tile with no mask.
            float x = sc[k];
            if constexpr (kBias) {   // the reference's order: causal, bias
              x = edge && causal && col > row ? kNegInf2 + Bt[c]
                                              : fmaf(x, scale2, Bt[c]);
              if (edge && col >= S) x = kNegInf2;
              x -= lr[e >> 1];
            } else if (kSeg || edge) {
              x *= scale2;
              if (col >= S || (causal && col > row) ||
                  (kSeg && col < st[e >> 1]))
                x = kNegInf2;
              x -= lr[e >> 1];
            } else {
              x = fmaf(x, scale2, -lr[e >> 1]);
            }
            // dS = P (dP - delta) scale  (dr: delta x scale)
            sc[k] = ex2(x) * fmaf(dp[k], sm_scale, -dr[e >> 1]);
          }
        }
        uint32_t pa[kDqN / 16][4];
#pragma unroll
        for (int kk = 0; kk < kDqN / 16; ++kk) pack_a(pa[kk], sc, kk);
        wgmma_fence();   // dQ += dS . K
#pragma unroll
        for (int kk = 0; kk < kDqN / 16; ++kk)
          mma_rs(dq_acc, pa[kk], desc_mn<kDqN>(Kt, kk));
        wgmma_commit();
        wgmma_wait0();
        fence_regs(dq_acc);
      }
      mbar_arrive(&empty[s]);
    }
    mbar_arrive(&qempty[qb]);

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + r * 8;
      if (row >= S) continue;
      bf16* o = dq + (static_cast<size_t>(w.b) * S + row) * qs + w.h * D;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
        *reinterpret_cast<uint32_t*>(o + dt * 8 + t * 2) =
            pack_bf16(dq_acc[dt * 4 + 2 * r], dq_acc[dt * 4 + 2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 kernels (FMA, exact products)
// ---------------------------------------------------------------------------

// Copy `rows` rows of D floats into dst [rows][ld]; rows past S are zeros.
template <int D>
__device__ __forceinline__ void stage_f32(float* dst, int ld,
                                          const float* src, size_t stride,
                                          int row0, int rows, int S,
                                          int nthreads) {
  for (int c = threadIdx.x; c < rows * D; c += nthreads) {
    const int r = c / D, col = c % D;
    dst[r * ld + col] =
        row0 + r < S ? src[static_cast<size_t>(row0 + r) * stride + col]
                     : 0.f;
  }
}

// fp32 twin of fwd_bf16 (and of _fwd_kernel): one thread per query row;
// kBN keys per tile, scores kept in shared memory.  Bound by 67 TFLOP/s
// of fp32 FMA; the correctness path for fp32 inputs.
template <int D, int kSide>
__global__ void __launch_bounds__(kBM)
    fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, float* __restrict__ out,
            float* __restrict__ lse, const int* __restrict__ seg,
            const float* __restrict__ bias, int S, int Hq, int Hkv,
            float sm_scale, int causal) {
  constexpr bool kSeg = kSide == kSegments, kBias = kSide == kKeyBias;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);   // [kBM][D + 1]
  float* Ks = Qs + kBM * (D + 1);                // [kBN][D]
  float* Vs = Ks + kBN * D;                      // [kBN][D]
  float* Ss = Vs + kBN * D;                      // [kBM][kBN + 1]
  float* Bs = Ss + kBM * (kBN + 1);              // [kBN] (kBias)

  const int qi = gridDim.x - 1 - blockIdx.x;
  const int b = blockIdx.y / Hq, h = blockIdx.y % Hq, hk = h / (Hq / Hkv);
  const int r = threadIdx.x;
  const size_t qs = static_cast<size_t>(Hq) * D;
  const size_t ks = static_cast<size_t>(Hkv) * D;
  const float* kb = k + static_cast<size_t>(b) * S * ks + hk * D;
  const float* vb = v + static_cast<size_t>(b) * S * ks + hk * D;
  const int q0 = qi * kBM, row = q0 + r;
  const int n_tiles = (S + kBN - 1) / kBN;
  const int n_live =
      causal ? min((q0 + kBM + kBN - 1) / kBN, n_tiles) : n_tiles;

  stage_f32<D>(Qs, D + 1, q + static_cast<size_t>(b) * S * qs + h * D, qs,
               q0, kBM, S, kBM);
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  float m = kNegInf, l = 0.f;
  const float* qr = Qs + r * (D + 1);
  float* sr = Ss + r * (kBN + 1);
  const int* sb = kSeg ? seg + static_cast<size_t>(b) * S : nullptr;
  const float* bb = kBias ? bias + static_cast<size_t>(b) * S : nullptr;
  const int st = seg_start<kSeg>(sb, row, S);

  for (int j = first_tile<kSeg, kBN>(sb, q0); j < n_live; ++j) {
    __syncthreads();
    stage_f32<D>(Ks, D, kb, ks, j * kBN, kBN, S, kBM);
    stage_f32<D>(Vs, D, vb, ks, j * kBN, kBN, S, kBM);
    if constexpr (kBias) Bs[r] = j * kBN + r < S ? bb[j * kBN + r] : 0.f;
    __syncthreads();
    float mx = m;
    for (int c = 0; c < kBN; ++c) {
      float x = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) x = fmaf(qr[d], Ks[c * D + d], x);
      x *= sm_scale;
      const int col = j * kBN + c;
      if constexpr (kBias) {
        if (causal && col > row) x = kNegInf;
        x += Bs[c];
        if (col >= S) x = kNegInf;
      } else if (col >= S || (causal && col > row) || (kSeg && col < st)) {
        x = kNegInf;
      }
      sr[c] = x;
      mx = fmaxf(mx, x);
    }
    const float alpha = expf(m - mx);
    m = mx;
    float rs = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
    for (int c = 0; c < kBN; ++c) {
      const float p = expf(sr[c] - m);
      rs += p;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(p, Vs[c * D + d], acc[d]);
    }
    l = l * alpha + rs;
  }
  if (row < S) {
    const float lc = fmaxf(l, kTiny);
    float* o = out + (static_cast<size_t>(b) * S + row) * qs + h * D;
#pragma unroll
    for (int d = 0; d < D; ++d) o[d] = acc[d] / lc;
    lse[(static_cast<size_t>(b) * Hq + h) * S + row] = m + logf(lc);
  }
}

// fp32 twin of bwd_dq_bf16 (and of _bwd_dq_kernel): one thread per query
// row, the same loop over key tiles.
template <int D, int kSide>
__global__ void __launch_bounds__(kBM)
    bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta, float* __restrict__ dq,
               const int* __restrict__ seg, const float* __restrict__ bias,
               int S, int Hq, int Hkv, float sm_scale, int causal) {
  constexpr bool kSeg = kSide == kSegments, kBias = kSide == kKeyBias;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);   // [kBM][D + 1]
  float* dOs = Qs + kBM * (D + 1);               // [kBM][D + 1]
  float* Ks = dOs + kBM * (D + 1);               // [kBN][D]
  float* Vs = Ks + kBN * D;                      // [kBN][D]
  float* Bs = Vs + kBN * D;                      // [kBN] (kBias)

  const int qi = gridDim.x - 1 - blockIdx.x;
  const int b = blockIdx.y / Hq, h = blockIdx.y % Hq, hk = h / (Hq / Hkv);
  const int r = threadIdx.x;
  const size_t qs = static_cast<size_t>(Hq) * D;
  const size_t ks = static_cast<size_t>(Hkv) * D;
  const size_t qoff = static_cast<size_t>(b) * S * qs + h * D;
  const float* kb = k + static_cast<size_t>(b) * S * ks + hk * D;
  const float* vb = v + static_cast<size_t>(b) * S * ks + hk * D;
  const int q0 = qi * kBM, row = q0 + r;
  const int n_tiles = (S + kBN - 1) / kBN;
  const int n_live =
      causal ? min((q0 + kBM + kBN - 1) / kBN, n_tiles) : n_tiles;

  stage_f32<D>(Qs, D + 1, q + qoff, qs, q0, kBM, S, kBM);
  stage_f32<D>(dOs, D + 1, dout + qoff, qs, q0, kBM, S, kBM);
  const size_t lo = (static_cast<size_t>(b) * Hq + h) * S;
  const float lr = row < S ? lse[lo + row] : 0.f;
  const float dr = row < S ? delta[lo + row] : 0.f;
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  const float* qr = Qs + r * (D + 1);
  const float* dor = dOs + r * (D + 1);
  const int* sb = kSeg ? seg + static_cast<size_t>(b) * S : nullptr;
  const float* bb = kBias ? bias + static_cast<size_t>(b) * S : nullptr;
  const int st = seg_start<kSeg>(sb, row, S);

  for (int j = first_tile<kSeg, kBN>(sb, q0); j < n_live; ++j) {
    __syncthreads();
    stage_f32<D>(Ks, D, kb, ks, j * kBN, kBN, S, kBM);
    stage_f32<D>(Vs, D, vb, ks, j * kBN, kBN, S, kBM);
    if constexpr (kBias) Bs[r] = j * kBN + r < S ? bb[j * kBN + r] : 0.f;
    __syncthreads();
    for (int c = 0; c < kBN; ++c) {
      float x = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        x = fmaf(qr[d], Ks[c * D + d], x);
        dp = fmaf(dor[d], Vs[c * D + d], dp);
      }
      x *= sm_scale;
      const int col = j * kBN + c;
      if constexpr (kBias) {
        if (causal && col > row) x = kNegInf;
        x += Bs[c];
        if (col >= S) x = kNegInf;
      } else if (col >= S || (causal && col > row) || (kSeg && col < st)) {
        x = kNegInf;
      }
      const float ds = expf(x - lr) * (dp - dr) * sm_scale;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(ds, Ks[c * D + d], acc[d]);
    }
  }
  if (row < S) {
    float* o = dq + (static_cast<size_t>(b) * S + row) * qs + h * D;
#pragma unroll
    for (int d = 0; d < D; ++d) o[d] = acc[d];
  }
}

// fp32 twin of bwd_dkv_bf16 (and of _bwd_dkv_kernel): 2 * kBN threads,
// warps 0-1 own dV of the CTA's kBN keys, warps 2-3 own dK.
template <int D, int kSide>
__global__ void __launch_bounds__(2 * kBN)
    bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dk,
                float* __restrict__ dv, const int* __restrict__ seg,
                const float* __restrict__ bias, int S, int Hq, int Hkv,
                float sm_scale, int causal) {
  constexpr bool kSeg = kSide == kSegments, kBias = kSide == kKeyBias;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);   // [kBN][D + 1]
  float* Vs = Ks + kBN * (D + 1);                // [kBN][D + 1]
  float* Qs = Vs + kBN * (D + 1);                // [kBQ][D]
  float* dOs = Qs + kBQ * D;                     // [kBQ][D]
  float* Ls = dOs + kBQ * D;                     // [kBQ]
  float* Ds = Ls + kBQ;                          // [kBQ]
  int* Ss = reinterpret_cast<int*>(Ds + kBQ);    // [kBQ]

  const int kj = blockIdx.x;
  const int b = blockIdx.y / Hkv, hk = blockIdx.y % Hkv, G = Hq / Hkv;
  const bool dk_role = threadIdx.x >= kBN;
  const int r = threadIdx.x % kBN;
  const size_t qs = static_cast<size_t>(Hq) * D;
  const size_t ks = static_cast<size_t>(Hkv) * D;
  const size_t koff = static_cast<size_t>(b) * S * ks + hk * D;
  const int k0 = kj * kBN, key = k0 + r;
  const float kbias =
      kBias && key < S ? bias[static_cast<size_t>(b) * S + key] : 0.f;
  const int* sb = kSeg ? seg + static_cast<size_t>(b) * S : nullptr;
  const int n_q = (q_rows<kSeg, kBN>(sb, k0, S) + kBQ - 1) / kBQ;
  const int first_q = causal ? k0 / kBQ : 0;

  stage_f32<D>(Ks, D + 1, k + koff, ks, k0, kBN, S, 2 * kBN);
  stage_f32<D>(Vs, D + 1, v + koff, ks, k0, kBN, S, 2 * kBN);
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  const float* kr = Ks + r * (D + 1);
  const float* vr = Vs + r * (D + 1);

  for (int gi = 0; gi < G; ++gi) {
    const int h = hk * G + gi;
    const size_t qoff = static_cast<size_t>(b) * S * qs + h * D;
    const size_t lo = (static_cast<size_t>(b) * Hq + h) * S;
    for (int qt = first_q; qt < n_q; ++qt) {
      const int qt0 = qt * kBQ;
      __syncthreads();
      stage_f32<D>(Qs, D, q + qoff, qs, qt0, kBQ, S, 2 * kBN);
      stage_f32<D>(dOs, D, dout + qoff, qs, qt0, kBQ, S, 2 * kBN);
      if (threadIdx.x < kBQ) {
        const bool ok = qt0 + threadIdx.x < S;
        Ls[threadIdx.x] = ok ? lse[lo + qt0 + threadIdx.x] : 0.f;
        Ds[threadIdx.x] = ok ? delta[lo + qt0 + threadIdx.x] : 0.f;
        if constexpr (kSeg)
          Ss[threadIdx.x] = seg_start<kSeg>(sb, qt0 + threadIdx.x, S);
      }
      __syncthreads();
      for (int c = 0; c < kBQ; ++c) {
        const int qrow = qt0 + c;
        float x = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) x = fmaf(kr[d], Qs[c * D + d], x);
        x *= sm_scale;
        if constexpr (kBias) {
          if (causal && key > qrow) x = kNegInf;
          x += kbias;
          if (qrow >= S) x = kNegInf;
        } else if (qrow >= S || (causal && key > qrow) ||
                   (kSeg && key < Ss[c])) {
          x = kNegInf;
        }
        const float p = expf(x - Ls[c]);
        if (!dk_role) {
#pragma unroll
          for (int d = 0; d < D; ++d) acc[d] = fmaf(p, dOs[c * D + d], acc[d]);
        } else {
          float dp = 0.f;
#pragma unroll
          for (int d = 0; d < D; ++d) dp = fmaf(vr[d], dOs[c * D + d], dp);
          const float ds = p * (dp - Ds[c]) * sm_scale;
#pragma unroll
          for (int d = 0; d < D; ++d) acc[d] = fmaf(ds, Qs[c * D + d], acc[d]);
        }
      }
    }
  }
  if (key < S) {
    float* o = (dk_role ? dk : dv) + (static_cast<size_t>(b) * S + key) * ks +
               hk * D;
#pragma unroll
    for (int d = 0; d < D; ++d) o[d] = acc[d];
  }
}
// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *out, *lse_out, *dq, *dk, *dv;
  const int* seg;
  const float* bias;
  int B, S, Hq, Hkv;
  float sm_scale;
  int causal;
  cudaStream_t stream;
};

// The instantiation of the call's sideband kind.
template <typename Kernel>
Kernel pick(const Args& a, Kernel dense, Kernel segments, Kernel key_bias) {
  return a.seg ? segments : a.bias ? key_bias : dense;
}

// Shared memory for the key-bias tile (fp32 forward and dq).
size_t bias_smem(const Args& a) { return a.bias ? kBN * sizeof(float) : 0; }

constexpr int kMapError = -2;   // a TMA map could not be encoded

// CTAs of a Hopper kernel's grid: persistent, one an SM, when there are
// items enough for the static split to balance (4 an SM or more); else one
// an item, which the hardware hands to SMs as they free up (a few items
// of data-dependent work, as packed rows give dk/dv).
int grid_ctas(int items) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return items >= 4 * sms ? sms : items;
}

// The 4-D map (D, H, S, B) of a contiguous bf16 [B, S, H, D] tensor, in
// 128-byte-swizzled boxes of 64 columns x `rows` rows of one head and one
// batch row; rows past S are zero-filled.
bool rows_map(CUtensorMap* map, const void* p, const Args& a, int H, int D,
              int rows) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(a.S),
                              static_cast<cuuint64_t>(a.B)};
  const cuuint64_t row = static_cast<cuuint64_t>(H) * D * sizeof(bf16);
  const cuuint64_t strides[3] = {D * sizeof(bf16), row, row * a.S};
  const cuuint32_t box[4] = {kSwz, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p),
             dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int fwd(const Args& a, int dtype) {
  if (dtype == 1) {
    CUtensorMap tq{}, tk{}, tv{};
    if (!rows_map(&tq, a.q, a, a.Hq, D, kFwdM) ||
        !rows_map(&tk, a.k, a, a.Hkv, D, kFwdN) ||
        !rows_map(&tv, a.v, a, a.Hkv, D, kFwdN))
      return kMapError;
    const int items = a.B * a.Hq * ((a.S + kFwdM - 1) / kFwdM);
    const size_t smem = FwdSmem<D>::kBytes;
    auto kernel = pick(a, fwd_bf16<D, kDense>, fwd_bf16<D, kSegments>,
                       fwd_bf16<D, kKeyBias>);
    if (int err = prepare(kernel, smem)) return err;
    kernel<<<grid_ctas(items), kHThreads, smem, a.stream>>>(
        tq, tk, tv, static_cast<bf16*>(a.out),
        static_cast<float*>(a.lse_out), a.seg, a.bias, a.B, a.S, a.Hq,
        a.Hkv, a.sm_scale, a.causal);
  } else {
    const dim3 grid((a.S + kBM - 1) / kBM, a.B * a.Hq);
    const size_t smem =
        (kBM * (D + 1) + 2 * kBN * D + kBM * (kBN + 1)) * sizeof(float) +
        bias_smem(a);
    auto kernel = pick(a, fwd_f32<D, kDense>, fwd_f32<D, kSegments>,
                       fwd_f32<D, kKeyBias>);
    if (int err = prepare(kernel, smem)) return err;
    kernel<<<grid, kBM, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<float*>(a.out),
        static_cast<float*>(a.lse_out), a.seg, a.bias, a.S, a.Hq, a.Hkv,
        a.sm_scale, a.causal);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int bwd_dq(const Args& a, int dtype) {
  if (dtype == 1) {
    CUtensorMap tq{}, tk{}, tv{}, tdo{};
    if (!rows_map(&tq, a.q, a, a.Hq, D, kFwdM) ||
        !rows_map(&tdo, a.dout, a, a.Hq, D, kFwdM) ||
        !rows_map(&tk, a.k, a, a.Hkv, D, kDqN) ||
        !rows_map(&tv, a.v, a, a.Hkv, D, kDqN))
      return kMapError;
    const int items = a.B * a.Hq * ((a.S + kFwdM - 1) / kFwdM);
    const size_t smem = DqSmem<D>::kBytes;
    auto kernel = pick(a, bwd_dq_bf16<D, kDense>, bwd_dq_bf16<D, kSegments>,
                       bwd_dq_bf16<D, kKeyBias>);
    if (int err = prepare(kernel, smem)) return err;
    kernel<<<grid_ctas(items), kHThreads, smem, a.stream>>>(
        tq, tk, tv, tdo, static_cast<const float*>(a.lse),
        static_cast<const float*>(a.delta), static_cast<bf16*>(a.dq), a.seg,
        a.bias, a.B, a.S, a.Hq, a.Hkv, a.sm_scale, a.causal);
  } else {
    const dim3 grid((a.S + kBM - 1) / kBM, a.B * a.Hq);
    const size_t smem =
        (2 * kBM * (D + 1) + 2 * kBN * D) * sizeof(float) + bias_smem(a);
    auto kernel = pick(a, bwd_dq_f32<D, kDense>, bwd_dq_f32<D, kSegments>,
                       bwd_dq_f32<D, kKeyBias>);
    if (int err = prepare(kernel, smem)) return err;
    kernel<<<grid, kBM, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<float*>(a.dq), a.seg, a.bias, a.S, a.Hq, a.Hkv,
        a.sm_scale, a.causal);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int bwd_dkv(const Args& a, int dtype) {
  if (dtype == 1) {
    CUtensorMap tq{}, tk{}, tv{}, tdo{};
    if (!rows_map(&tq, a.q, a, a.Hq, D, kDkvM) ||
        !rows_map(&tdo, a.dout, a, a.Hq, D, kDkvM) ||
        !rows_map(&tk, a.k, a, a.Hkv, D, kDkvN) ||
        !rows_map(&tv, a.v, a, a.Hkv, D, kDkvN))
      return kMapError;
    const int items = a.B * a.Hkv * ((a.S + kDkvN - 1) / kDkvN);
    const size_t smem = DkvSmem<D>::kBytes;
    auto kernel = pick(a, bwd_dkv_bf16<D, kDense>, bwd_dkv_bf16<D, kSegments>,
                       bwd_dkv_bf16<D, kKeyBias>);
    if (int err = prepare(kernel, smem)) return err;
    kernel<<<grid_ctas(items), kHThreads, smem, a.stream>>>(
        tq, tk, tv, tdo, static_cast<const float*>(a.lse),
        static_cast<const float*>(a.delta), static_cast<bf16*>(a.dk),
        static_cast<bf16*>(a.dv), a.seg, a.bias, a.B, a.S, a.Hq, a.Hkv,
        a.sm_scale, a.causal);
  } else {
    const dim3 grid((a.S + kBN - 1) / kBN, a.B * a.Hkv);
    const size_t smem =
        (2 * kBN * (D + 1) + 2 * kBQ * D + 2 * kBQ) * sizeof(float) +
        kBQ * sizeof(int);
    auto kernel = pick(a, bwd_dkv_f32<D, kDense>, bwd_dkv_f32<D, kSegments>,
                       bwd_dkv_f32<D, kKeyBias>);
    if (int err = prepare(kernel, smem)) return err;
    kernel<<<grid, 2 * kBN, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.seg, a.bias,
        a.S, a.Hq, a.Hkv, a.sm_scale, a.causal);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int (*F64)(const Args&, int), int (*F128)(const Args&, int)>
int dispatch(const Args& a, int D, int dtype) {
  if (dtype != 0 && dtype != 1) return -1;
  if (a.B < 1 || a.S < 1 || a.Hkv < 1 || a.Hq % a.Hkv) return -1;
  if (a.seg && a.bias) return -1;   // exclusive, as in the reference
  if (D == 64) return F64(a, dtype);
  if (D == 128) return F128(a, dtype);
  return -1;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (every tensor but lse/delta/bias,
// which are fp32).  q/out/dout/dq: contiguous [B, S, Hq, D]; k/v/dk/dv:
// contiguous [B, S, Hkv, D]; lse/delta: contiguous [B, Hq, S].  Sidebands,
// at most one non-null: seg, the contiguous int32 [B, S] segment starts of
// packed causal rows (each row's nondecreasing, seg[b, r] <= r); bias, the
// contiguous fp32 [B, S] additive key bias (0 valid, -1e30 masked).  D is
// 64 or 128; every pointer 16-byte aligned.  All on the current device;
// launches on `stream`, allocates nothing.  Returns 0, a cudaError_t from
// the launch, -1 for an unsupported dtype, head dim, shape or pair of
// sidebands, or -2 if a bf16 kernel's TMA map could not be encoded.
extern "C" int hvd_flash_fwd(const void* q, const void* k, const void* v,
                             void* out, void* lse, const void* seg,
                             const void* bias, int B, int S, int Hq, int Hkv,
                             int D, float sm_scale, int causal, int dtype,
                             void* stream) {
  Args a{};
  a.q = q, a.k = k, a.v = v, a.out = out, a.lse_out = lse;
  a.seg = static_cast<const int*>(seg);
  a.bias = static_cast<const float*>(bias);
  a.B = B, a.S = S, a.Hq = Hq, a.Hkv = Hkv, a.sm_scale = sm_scale;
  a.causal = causal, a.stream = static_cast<cudaStream_t>(stream);
  return dispatch<fwd<64>, fwd<128>>(a, D, dtype);
}

extern "C" int hvd_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, const void* seg,
                                const void* bias, int B, int S, int Hq,
                                int Hkv, int D, float sm_scale, int causal,
                                int dtype, void* stream) {
  Args a{};
  a.q = q, a.k = k, a.v = v, a.dout = dout, a.lse = lse, a.delta = delta;
  a.seg = static_cast<const int*>(seg);
  a.bias = static_cast<const float*>(bias);
  a.dq = dq, a.B = B, a.S = S, a.Hq = Hq, a.Hkv = Hkv;
  a.sm_scale = sm_scale, a.causal = causal;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch<bwd_dq<64>, bwd_dq<128>>(a, D, dtype);
}

extern "C" int hvd_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv,
                                 const void* seg, const void* bias, int B,
                                 int S, int Hq, int Hkv, int D, float sm_scale,
                                 int causal, int dtype, void* stream) {
  Args a{};
  a.q = q, a.k = k, a.v = v, a.dout = dout, a.lse = lse, a.delta = delta;
  a.seg = static_cast<const int*>(seg);
  a.bias = static_cast<const float*>(bias);
  a.dk = dk, a.dv = dv, a.B = B, a.S = S, a.Hq = Hq, a.Hkv = Hkv;
  a.sm_scale = sm_scale, a.causal = causal;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch<bwd_dkv<64>, bwd_dkv<128>>(a, D, dtype);
}
