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
// 1e-30) and lse = m + log(max(l, 1e-30)).  Causal key tiles above the
// diagonal are skipped by the loop bound, not masked, for any ratio of
// query tile to key tile.  Packed rows (optional int32 segment starts,
// the reference's seg_ref) add the mask key < start[query] and skip the
// key tiles below a query tile's first start (forward, dq) and the query
// tiles past the last row that can see a key tile (dk/dv), so packing
// saves the FLOPs of the masked blocks, as on the TPU.  Key padding
// (optional fp32 [B, S] additive key bias, the reference's bias_ref: 0 for
// a valid key, -1e30 for a masked one) adds bias[b, key] to every score of
// batch row b after the scale and the causal mask, as the reference adds
// it; one row serves every head, and no tile is skipped.  Segments and the
// key bias are exclusive (as in the reference), and each kernel is compiled
// once per sideband kind, so the dense and packed paths run the code they
// ran before the key bias existed.  delta = rowsum(dout * out) - g_lse is
// computed by the caller (fp32, [B, Hq, S]).
//
// Layout: q/out/dout/dq are contiguous [B, S, Hq, D], k/v/dk/dv contiguous
// [B, S, Hkv, D], indexed in place by strides (no [B*H, S, D] transpose and
// no repeat of the KV heads); lse/delta are [B, Hq, S] fp32 (no sublane-
// replicated [8, S] copy).  GQA: query head h reads KV head h / G.  The
// tail of a sequence that is not a multiple of the tile is masked here:
// out-of-range rows are loaded as zeros and their keys masked to -1e30.
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
//   * bf16: warp-level mma.sync.m16n8k16 (fp32 accumulate) for every
//     product.  Tiles are staged in shared memory by cp.async, two stages
//     deep, so the next K/V (or Q/dout) tile loads while this one
//     computes; operand fragments come out of shared memory by ldmatrix
//     (.trans where the product contracts over the tile's rows).  The
//     score/probability accumulators are re-packed in registers as the A
//     operand of the next product (the C layout of two m16n8 tiles is the
//     A layout of one m16k16), so P and dS never touch shared memory.
//     Rows are padded by 16 bytes in shared memory so ldmatrix is free of
//     bank conflicts.  The key bias of a key tile is staged in shared
//     memory beside it (forward, dq); dk/dv keep their keys' bias in two
//     registers a thread, as the bias depends on the key alone.
//   * forward and dq: one CTA of 4 warps per (64 query rows, batch, head),
//     16 rows per warp, looping over 64-key tiles; heavy (late) causal
//     query tiles are scheduled first.
//   * dk/dv: one CTA per (64 keys, batch, KV head), looping over the G query
//     heads of the group and over 32-row query tiles from the diagonal
//     down.  That sums the group's contributions in fp32 registers, with
//     no atomics and a fixed order: deterministic, and equal to the
//     reference's repeat-then-sum.  dq stays a kernel of its own (the
//     reference's split), so there are no atomics for dq either.
//   * fp32 inputs: the tensor cores would round them to TF32, so fp32 runs
//     a plain FMA kernel per function (one thread per query row, or per key
//     row and role for dk/dv) on the same tiles.  It exists for exactness,
//     not speed: its bound is 67 TFLOP/s of fp32 FMA.
//
// wgmma, TMA and warp specialisation are later work.  Plain C interface,
// loaded with ctypes (horovod_tpu_torch/ops/_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -1e30f;   // the reference's mask value
constexpr float kTiny = 1e-30f;     // the reference's floor on l
constexpr int kThreads = 128;       // 4 warps
constexpr int kBM = 64;             // query rows per CTA (fwd, dq)
constexpr int kBN = 64;             // keys per tile (fwd, dq); per CTA (dkv)
constexpr int kBQ = 32;             // query rows per tile (dkv)
constexpr int kPad = 8;             // bf16 padding per shared-memory row

// Sideband kinds: each kernel is instantiated once per kind.
constexpr int kDense = 0;      // none
constexpr int kSegments = 1;   // int32 [B, S] segment starts (packed rows)
constexpr int kKeyBias = 2;    // fp32 [B, S] additive key bias (key padding)

// ---------------------------------------------------------------------------
// PTX helpers
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

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
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

// Two floats rounded to nearest-even bf16 (as jnp.astype); lo in the low
// half, the lower column index of an mma fragment.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A operand: the 16x16 tile at `p` of a row-major [rows][ld] array.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* p,
                                       int ld, int lane) {
  ldsm_x4(a, p + (lane & 15) * ld + (lane >> 4) * 8);
}

// B operand (k x n = 16 x 8) stored as [n][k] rows: the 8 rows at `p`,
// columns k..k+15.  Used where the product contracts over D.
__device__ __forceinline__ void load_b(uint32_t (&b)[2], const bf16* p,
                                       int ld, int lane) {
  ldsm_x2(b, p + (lane & 7) * ld + ((lane >> 3) & 1) * 8);
}

// B operand (k x n = 16 x 8) stored as [k][n] rows: the 16 rows at `p`,
// columns n..n+7.  Used where the product contracts over the tile's rows.
__device__ __forceinline__ void load_bt(uint32_t (&b)[2], const bf16* p,
                                        int ld, int lane) {
  ldsm_x2_t(b, p + (lane & 15) * ld);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Stage `rows` rows of D bf16 (row i at src + (row0 + i) * stride) into
// dst [rows][D + kPad]; rows at or past S are zero-filled.
template <int D>
__device__ __forceinline__ void stage(bf16* dst, const bf16* src,
                                      size_t stride, int row0, int rows,
                                      int S) {
  constexpr int kChunks = D / 8;
  for (int c = threadIdx.x; c < rows * kChunks; c += kThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    const bool ok = row0 + r < S;
    cp_async16(dst + r * (D + kPad) + col,
               src + static_cast<size_t>(ok ? row0 + r : 0) * stride + col,
               ok);
  }
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

// First key tile of the query tile starting at row q0 (< S): its first row
// has the tile's smallest start, so every earlier key tile is masked for
// all its rows and is skipped — the reference's kv_first.
template <bool kSeg>
__device__ __forceinline__ int first_tile(const int* sb, int q0) {
  if constexpr (kSeg) return sb[q0] / kBN;
  return 0;
}

// Query rows that can see the key tile starting at k0: the rows whose
// start is at most the tile's last key, a prefix of the rows (binary
// search), at least k0 + 1 since row r's start is at most r.  S without
// segments.  The reference's n_q_live.
template <bool kSeg>
__device__ __forceinline__ int q_rows(const int* sb, int k0, int S) {
  if constexpr (!kSeg) return S;
  const int last = min(k0 + kBN, S) - 1;
  int lo = 0, hi = S;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sb[mid] <= last) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// ---------------------------------------------------------------------------
// bf16 kernels (tensor cores)
// ---------------------------------------------------------------------------

// Scores of one warp's 16 query rows against kBN keys: s = Qw . Kt^T.
template <int D>
__device__ __forceinline__ void scores_qk(float (&s)[kBN / 8][4],
                                          const bf16* Qw, const bf16* Kt,
                                          int lane) {
  constexpr int LD = D + kPad;
#pragma unroll
  for (int nt = 0; nt < kBN / 8; ++nt)
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t a[4];
    load_a(a, Qw + ks * 16, LD, lane);
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
      uint32_t b[2];
      load_b(b, Kt + nt * 8 * LD + ks * 16, LD, lane);
      mma(s[nt], a, b);
    }
  }
}

// acc[16 x D] += P[16 x kBN] (fp32 C fragments, rounded here) . Vt[kBN x D].
template <int D>
__device__ __forceinline__ void acc_pv(float (&acc)[D / 8][4],
                                       const float (&p)[kBN / 8][4],
                                       const bf16* Vt, int lane) {
  constexpr int LD = D + kPad;
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    a[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    a[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    a[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      uint32_t b[2];
      load_bt(b, Vt + kk * 16 * LD + dt * 8, LD, lane);
      mma(acc[dt], a, b);
    }
  }
}

// hvd_flash_fwd (bf16) <- _fwd_kernel, horovod_tpu/ops/flash_attention.py:113.
// Bound by operations: Q.K^T and P.V, 4 * D FLOPs per live (query, key).
// One CTA per 64 query rows of one (batch, head); each warp keeps its 16
// rows' running max, denominator and 16 x D fp32 accumulator in registers
// while K/V tiles stream through shared memory.
template <int D, int kSide>
__global__ void __launch_bounds__(kThreads)
    fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ out,
             float* __restrict__ lse, const int* __restrict__ seg,
             const float* __restrict__ bias, int S, int Hq, int Hkv,
             float sm_scale, int causal) {
  constexpr bool kSeg = kSide == kSegments, kBias = kSide == kKeyBias;
  constexpr int LD = D + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);   // [kBM][LD]
  bf16* Ks = Qs + kBM * LD;                    // [2][kBN][LD]
  bf16* Vs = Ks + 2 * kBN * LD;                // [2][kBN][LD]
  float* Bs = reinterpret_cast<float*>(Vs + 2 * kBN * LD);   // [kBN] (kBias)

  const int qi = gridDim.x - 1 - blockIdx.x;   // heavy causal tiles first
  const int b = blockIdx.y / Hq, h = blockIdx.y % Hq, hk = h / (Hq / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t qs = static_cast<size_t>(Hq) * D;    // q row stride
  const size_t ks = static_cast<size_t>(Hkv) * D;   // k/v row stride
  const bf16* qb = q + static_cast<size_t>(b) * S * qs + h * D;
  const bf16* kb = k + static_cast<size_t>(b) * S * ks + hk * D;
  const bf16* vb = v + static_cast<size_t>(b) * S * ks + hk * D;
  const int q0 = qi * kBM;
  const int n_tiles = (S + kBN - 1) / kBN;
  const int n_live =
      causal ? min((q0 + kBM + kBN - 1) / kBN, n_tiles) : n_tiles;

  const int* sb = kSeg ? seg + static_cast<size_t>(b) * S : nullptr;
  const float* bb = kBias ? bias + static_cast<size_t>(b) * S : nullptr;
  const int j0 = first_tile<kSeg>(sb, q0);

  stage<D>(Qs, qb, qs, q0, kBM, S);
  stage<D>(Ks, kb, ks, j0 * kBN, kBN, S);
  stage<D>(Vs, vb, ks, j0 * kBN, kBN, S);
  cp_async_commit();

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int row0 = q0 + warp * 16 + g;   // this thread's rows: row0, row0+8
  const int st[2] = {seg_start<kSeg>(sb, row0, S),
                     seg_start<kSeg>(sb, row0 + 8, S)};

  for (int j = j0; j < n_live; ++j) {
    const int buf = (j - j0) & 1;
    if (j + 1 < n_live) {
      const int nb = buf ^ 1;
      stage<D>(Ks + nb * kBN * LD, kb, ks, (j + 1) * kBN, kBN, S);
      stage<D>(Vs + nb * kBN * LD, vb, ks, (j + 1) * kBN, kBN, S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    // Tile j's key bias; the last reads of Bs were before the previous
    // iteration's closing barrier.
    if (kBias && threadIdx.x < kBN) {
      const int c = j * kBN + threadIdx.x;
      Bs[threadIdx.x] = c < S ? bb[c] : 0.f;
    }
    __syncthreads();
    const bf16* Kt = Ks + buf * kBN * LD;
    const bf16* Vt = Vs + buf * kBN * LD;

    float s[kBN / 8][4];
    scores_qk<D>(s, Qs + warp * 16 * LD, Kt, lane);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + (e >> 1) * 8;
        const int col = j * kBN + nt * 8 + t * 2 + (e & 1);
        float x = s[nt][e] * sm_scale;
        if constexpr (kBias) {
          if (causal && col > row) x = kNegInf;
          x += Bs[nt * 8 + t * 2 + (e & 1)];
          if (col >= S) x = kNegInf;
        } else if (col >= S || (causal && col > row) ||
                   (kSeg && col < st[e >> 1])) {
          x = kNegInf;
        }
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = quad_max(mx[i]);
      alpha[i] = expf(m[i] - mx[i]);
      m[i] = mx[i];
    }
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[nt][e] - m[e >> 1]);
        s[nt][e] = p;
        rs[e >> 1] += p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + quad_sum(rs[i]);
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }
    acc_pv<D>(acc, s, Vt, lane);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + i * 8;
    if (row >= S) continue;
    const float lc = fmaxf(l[i], kTiny);
    bf16* ob = out + (static_cast<size_t>(b) * S + row) * qs + h * D;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<uint32_t*>(ob + dt * 8 + t * 2) =
          pack_bf16(acc[dt][2 * i] / lc, acc[dt][2 * i + 1] / lc);
    if (t == 0)
      lse[(static_cast<size_t>(b) * Hq + h) * S + row] = m[i] + logf(lc);
  }
}

// hvd_flash_bwd_dq (bf16) <- _bwd_dq_kernel, flash_attention.py:272.
// Bound by operations: Q.K^T again, dO.V^T and dS.K, 6 * D FLOPs per live
// pair.  Same tiling as the forward; P is rebuilt from the saved lse, and
// dS goes from the accumulators straight into the dS.K product.
template <int D, int kSide>
__global__ void __launch_bounds__(kThreads)
    bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, bf16* __restrict__ dq,
                const int* __restrict__ seg, const float* __restrict__ bias,
                int S, int Hq, int Hkv, float sm_scale, int causal) {
  constexpr bool kSeg = kSide == kSegments, kBias = kSide == kKeyBias;
  constexpr int LD = D + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);   // [kBM][LD]
  bf16* dOs = Qs + kBM * LD;                   // [kBM][LD]
  bf16* Ks = dOs + kBM * LD;                   // [2][kBN][LD]
  bf16* Vs = Ks + 2 * kBN * LD;                // [2][kBN][LD]
  float* Bs = reinterpret_cast<float*>(Vs + 2 * kBN * LD);   // [kBN] (kBias)

  const int qi = gridDim.x - 1 - blockIdx.x;
  const int b = blockIdx.y / Hq, h = blockIdx.y % Hq, hk = h / (Hq / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t qs = static_cast<size_t>(Hq) * D;
  const size_t ks = static_cast<size_t>(Hkv) * D;
  const size_t qoff = static_cast<size_t>(b) * S * qs + h * D;
  const bf16* kb = k + static_cast<size_t>(b) * S * ks + hk * D;
  const bf16* vb = v + static_cast<size_t>(b) * S * ks + hk * D;
  const int q0 = qi * kBM;
  const int n_tiles = (S + kBN - 1) / kBN;
  const int n_live =
      causal ? min((q0 + kBM + kBN - 1) / kBN, n_tiles) : n_tiles;

  const int* sb = kSeg ? seg + static_cast<size_t>(b) * S : nullptr;
  const float* bb = kBias ? bias + static_cast<size_t>(b) * S : nullptr;
  const int j0 = first_tile<kSeg>(sb, q0);

  stage<D>(Qs, q + qoff, qs, q0, kBM, S);
  stage<D>(dOs, dout + qoff, qs, q0, kBM, S);
  stage<D>(Ks, kb, ks, j0 * kBN, kBN, S);
  stage<D>(Vs, vb, ks, j0 * kBN, kBN, S);
  cp_async_commit();

  const int row0 = q0 + warp * 16 + g;
  const int st[2] = {seg_start<kSeg>(sb, row0, S),
                     seg_start<kSeg>(sb, row0 + 8, S)};
  const float* lrow = lse + (static_cast<size_t>(b) * Hq + h) * S;
  const float* drow = delta + (static_cast<size_t>(b) * Hq + h) * S;
  float lr[2], dr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + i * 8;
    lr[i] = row < S ? lrow[row] : 0.f;
    dr[i] = row < S ? drow[row] : 0.f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  for (int j = j0; j < n_live; ++j) {
    const int buf = (j - j0) & 1;
    if (j + 1 < n_live) {
      const int nb = buf ^ 1;
      stage<D>(Ks + nb * kBN * LD, kb, ks, (j + 1) * kBN, kBN, S);
      stage<D>(Vs + nb * kBN * LD, vb, ks, (j + 1) * kBN, kBN, S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    // Tile j's key bias; the last reads of Bs were before the previous
    // iteration's closing barrier.
    if (kBias && threadIdx.x < kBN) {
      const int c = j * kBN + threadIdx.x;
      Bs[threadIdx.x] = c < S ? bb[c] : 0.f;
    }
    __syncthreads();
    const bf16* Kt = Ks + buf * kBN * LD;
    const bf16* Vt = Vs + buf * kBN * LD;

    float s[kBN / 8][4], dp[kBN / 8][4];
    scores_qk<D>(s, Qs + warp * 16 * LD, Kt, lane);
    scores_qk<D>(dp, dOs + warp * 16 * LD, Vt, lane);   // dout . v^T
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int row = row0 + i * 8;
        const int col = j * kBN + nt * 8 + t * 2 + (e & 1);
        float x = s[nt][e] * sm_scale;
        if constexpr (kBias) {
          if (causal && col > row) x = kNegInf;
          x += Bs[nt * 8 + t * 2 + (e & 1)];
          if (col >= S) x = kNegInf;
        } else if (col >= S || (causal && col > row) ||
                   (kSeg && col < st[i])) {
          x = kNegInf;
        }
        const float p = expf(x - lr[i]);
        s[nt][e] = p * (dp[nt][e] - dr[i]) * sm_scale;   // dS
      }
    }
    acc_pv<D>(acc, s, Kt, lane);   // dq += dS . k
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + i * 8;
    if (row >= S) continue;
    bf16* o = dq + (static_cast<size_t>(b) * S + row) * qs + h * D;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<uint32_t*>(o + dt * 8 + t * 2) =
          pack_bf16(acc[dt][2 * i], acc[dt][2 * i + 1]);
  }
}

// acc[16 keys x D] += X^T . Y where X^T is a warp's [16 keys x kBQ] C tile
// (rounded here) and Yt the [kBQ x D] query-side tile in shared memory.
template <int D>
__device__ __forceinline__ void acc_xty(float (&acc)[D / 8][4],
                                        const float (&x)[kBQ / 8][4],
                                        const bf16* Yt, int lane) {
  constexpr int LD = D + kPad;
#pragma unroll
  for (int kk = 0; kk < kBQ / 16; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    a[1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    a[2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      uint32_t b[2];
      load_bt(b, Yt + kk * 16 * LD + dt * 8, LD, lane);
      mma(acc[dt], a, b);
    }
  }
}

// [16 keys x kBQ] = Xw (a warp's 16 rows of K or V) . Yt^T (kBQ query rows).
template <int D>
__device__ __forceinline__ void scores_kq(float (&s)[kBQ / 8][4],
                                          const bf16* Xw, const bf16* Yt,
                                          int lane) {
  constexpr int LD = D + kPad;
#pragma unroll
  for (int nt = 0; nt < kBQ / 8; ++nt)
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    uint32_t a[4];
    load_a(a, Xw + kc * 16, LD, lane);
#pragma unroll
    for (int nt = 0; nt < kBQ / 8; ++nt) {
      uint32_t b[2];
      load_b(b, Yt + nt * 8 * LD + kc * 16, LD, lane);
      mma(s[nt], a, b);
    }
  }
}

// hvd_flash_bwd_dkv (bf16) <- _bwd_dkv_kernel, flash_attention.py:329.
// Bound by operations: four products (K.Q^T, V.dO^T, P^T.dO, dS^T.Q),
// 8 * D FLOPs per live pair.  One CTA per 64 keys of one (batch, KV
// head), transposed so keys are the rows: each warp keeps 16 keys' dK and
// dV in registers across the G query heads and all query tiles.
template <int D, int kSide>
__global__ void __launch_bounds__(kThreads)
    bwd_dkv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ dk,
                 bf16* __restrict__ dv, const int* __restrict__ seg,
                 const float* __restrict__ bias, int S, int Hq, int Hkv,
                 float sm_scale, int causal) {
  constexpr bool kSeg = kSide == kSegments, kBias = kSide == kKeyBias;
  constexpr int LD = D + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);   // [kBN][LD]
  bf16* Vs = Ks + kBN * LD;                    // [kBN][LD]
  bf16* Qs = Vs + kBN * LD;                    // [2][kBQ][LD]
  bf16* dOs = Qs + 2 * kBQ * LD;               // [2][kBQ][LD]
  float* Ls = reinterpret_cast<float*>(dOs + 2 * kBQ * LD);   // [2][kBQ]
  float* Ds = Ls + 2 * kBQ;                                    // [2][kBQ]
  int* Ss = reinterpret_cast<int*>(Ds + 2 * kBQ);              // [2][kBQ]

  const int kj = blockIdx.x;
  const int b = blockIdx.y / Hkv, hk = blockIdx.y % Hkv, G = Hq / Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t qs = static_cast<size_t>(Hq) * D;
  const size_t ks = static_cast<size_t>(Hkv) * D;
  const size_t koff = static_cast<size_t>(b) * S * ks + hk * D;
  const int k0 = kj * kBN;
  const int first_q = causal ? k0 / kBQ : 0;   // tiles from the diagonal

  stage<D>(Ks, k + koff, ks, k0, kBN, S);
  stage<D>(Vs, v + koff, ks, k0, kBN, S);
  const int* sb = kSeg ? seg + static_cast<size_t>(b) * S : nullptr;
  // Query tiles that can see this key tile (segments: a prefix of rows).
  const int n_q = (q_rows<kSeg>(sb, k0, S) + kBQ - 1) / kBQ;
  const int n_live = n_q - first_q;            // >= 1: row k0 sees key k0
  const int n_iter = G * n_live;               // (head of group, q tile)

  // Issue the loads of iteration `it` into buffer `buf`.
  auto load_q = [&](int it, int buf) {
    const int h = hk * G + it / n_live;
    const int qt0 = (first_q + it % n_live) * kBQ;
    const size_t qoff = static_cast<size_t>(b) * S * qs + h * D;
    stage<D>(Qs + buf * kBQ * LD, q + qoff, qs, qt0, kBQ, S);
    stage<D>(dOs + buf * kBQ * LD, dout + qoff, qs, qt0, kBQ, S);
    const int r = threadIdx.x;
    if (r < kBQ) {
      const size_t lo = (static_cast<size_t>(b) * Hq + h) * S;
      const bool ok = qt0 + r < S;
      Ls[buf * kBQ + r] = ok ? lse[lo + qt0 + r] : 0.f;
      Ds[buf * kBQ + r] = ok ? delta[lo + qt0 + r] : 0.f;
      if constexpr (kSeg) Ss[buf * kBQ + r] = seg_start<kSeg>(sb, qt0 + r, S);
    }
  };
  if (n_iter > 0) load_q(0, 0);
  cp_async_commit();

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    dk_acc[dt][0] = dk_acc[dt][1] = dk_acc[dt][2] = dk_acc[dt][3] = 0.f;
    dv_acc[dt][0] = dv_acc[dt][1] = dv_acc[dt][2] = dv_acc[dt][3] = 0.f;
  }
  const int key0 = k0 + warp * 16 + g;   // this thread's keys: key0, key0+8
  // The key bias is a function of the key alone: two registers a thread.
  float kbias[2] = {0.f, 0.f};
  if constexpr (kBias) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = key0 + i * 8;
      if (key < S) kbias[i] = bias[static_cast<size_t>(b) * S + key];
    }
  }

  for (int it = 0; it < n_iter; ++it) {
    if (it + 1 < n_iter) {
      load_q(it + 1, (it + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int buf = it & 1;
    const bf16* Qt = Qs + buf * kBQ * LD;
    const bf16* dOt = dOs + buf * kBQ * LD;
    const float* Lt = Ls + buf * kBQ;
    const float* Dt = Ds + buf * kBQ;
    const int* St = Ss + buf * kBQ;
    const int qt0 = (first_q + it % n_live) * kBQ;

    float s[kBQ / 8][4], dp[kBQ / 8][4];
    scores_kq<D>(s, Ks + warp * 16 * LD, Qt, lane);    // (q . k^T)^T
    scores_kq<D>(dp, Vs + warp * 16 * LD, dOt, lane);  // (dout . v^T)^T
#pragma unroll
    for (int nt = 0; nt < kBQ / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + (e >> 1) * 8;
        const int c = nt * 8 + t * 2 + (e & 1);
        const int qrow = qt0 + c;
        float x = s[nt][e] * sm_scale;
        if constexpr (kBias) {
          if (causal && key > qrow) x = kNegInf;
          x += kbias[e >> 1];
          if (qrow >= S) x = kNegInf;
        } else if (qrow >= S || (causal && key > qrow) ||
                   (kSeg && key < St[c])) {
          x = kNegInf;
        }
        const float p = expf(x - Lt[c]);
        s[nt][e] = p;
        dp[nt][e] = p * (dp[nt][e] - Dt[c]) * sm_scale;   // dS^T
      }
    }
    acc_xty<D>(dv_acc, s, dOt, lane);    // dv += P^T . dout
    acc_xty<D>(dk_acc, dp, Qt, lane);    // dk += dS^T . q
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + i * 8;
    if (key >= S) continue;
    const size_t o = (static_cast<size_t>(b) * S + key) * ks + hk * D;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(dk + o + dt * 8 + t * 2) =
          pack_bf16(dk_acc[dt][2 * i], dk_acc[dt][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dv + o + dt * 8 + t * 2) =
          pack_bf16(dv_acc[dt][2 * i], dv_acc[dt][2 * i + 1]);
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

  for (int j = first_tile<kSeg>(sb, q0); j < n_live; ++j) {
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

  for (int j = first_tile<kSeg>(sb, q0); j < n_live; ++j) {
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
  const int n_q = (q_rows<kSeg>(sb, k0, S) + kBQ - 1) / kBQ;
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

// Shared memory for the key-bias tile (forward and dq only).
size_t bias_smem(const Args& a) { return a.bias ? kBN * sizeof(float) : 0; }

template <int D>
int fwd(const Args& a, int dtype) {
  const dim3 grid((a.S + kBM - 1) / kBM, a.B * a.Hq);
  if (dtype == 1) {
    const size_t smem =
        (kBM + 4 * kBN) * (D + kPad) * sizeof(bf16) + bias_smem(a);
    auto kernel = pick(a, fwd_bf16<D, kDense>, fwd_bf16<D, kSegments>,
                       fwd_bf16<D, kKeyBias>);
    if (int err = prepare(kernel, smem)) return err;
    kernel<<<grid, kThreads, smem, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<bf16*>(a.out),
        static_cast<float*>(a.lse_out), a.seg, a.bias, a.S, a.Hq, a.Hkv,
        a.sm_scale, a.causal);
  } else {
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
  const dim3 grid((a.S + kBM - 1) / kBM, a.B * a.Hq);
  if (dtype == 1) {
    const size_t smem =
        (2 * kBM + 4 * kBN) * (D + kPad) * sizeof(bf16) + bias_smem(a);
    auto kernel = pick(a, bwd_dq_bf16<D, kDense>, bwd_dq_bf16<D, kSegments>,
                       bwd_dq_bf16<D, kKeyBias>);
    if (int err = prepare(kernel, smem)) return err;
    kernel<<<grid, kThreads, smem, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<bf16*>(a.dq), a.seg, a.bias, a.S, a.Hq, a.Hkv,
        a.sm_scale, a.causal);
  } else {
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
  const dim3 grid((a.S + kBN - 1) / kBN, a.B * a.Hkv);
  if (dtype == 1) {
    const size_t smem = (2 * kBN + 4 * kBQ) * (D + kPad) * sizeof(bf16) +
                        4 * kBQ * sizeof(float) + 2 * kBQ * sizeof(int);
    auto kernel = pick(a, bwd_dkv_bf16<D, kDense>, bwd_dkv_bf16<D, kSegments>,
                       bwd_dkv_bf16<D, kKeyBias>);
    if (int err = prepare(kernel, smem)) return err;
    kernel<<<grid, kThreads, smem, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.seg, a.bias,
        a.S, a.Hq, a.Hkv, a.sm_scale, a.causal);
  } else {
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
// 64 or 128.  All on the current device; launches on `stream`, allocates
// nothing.  Returns 0, a cudaError_t from the launch, or -1 for an
// unsupported dtype, head dim, shape or pair of sidebands.
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
