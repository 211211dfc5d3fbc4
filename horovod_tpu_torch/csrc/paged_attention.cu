// Fused paged-attention decode for NVIDIA Hopper (sm_90a).
//
// Replaces horovod_tpu/ops/paged_attention.py::_decode_kernel, the Pallas
// TPU kernel launched by _decode_pallas.  Same function: one query token
// per sequence attends its K/V straight through the block table, GQA
// heads grouped [Hkv, G], k_pos <= pos, fp32 scores scaled by 1/sqrt(D),
// fp32 softmax, probabilities rounded to the value dtype before the PV
// product, output in q's dtype.
//
// What bounds it on this card: bytes.  Each live K/V slot is read once,
// so the least time is  sum_b (pos_b + 1) * Hkv * D * 2 * itemsize  bytes
// over 3.35 TB/s; the arithmetic (4 * Hq * D flops per live slot) is far
// below the tensor-core line.  At a decode batch that is a few MB, a few
// microseconds: the kernel is about latency, so its design keeps loads in
// flight and takes the serial steps out.
//
// Design (one launch a call):
//   * The table slots of each (sequence, kv head) are cut into ranges of
//     kRange (128) slots, one CTA of 128 threads per (range, kv head,
//     sequence), ranges fastest in the grid so a long row's ranges start
//     first.  The ranges depend on the table's width alone, never on the
//     batch.  A range past the row's pos exits after reading pos (and its
//     table entries, read beside pos so that a live range's K loads wait
//     on one round trip, not two); the TPU kernel DMAs every column and
//     only skips the flops.
//   * There is no scalar prefetch on Hopper: a CTA turns each token of its
//     range into a pool row (block * BS + slot); K/V rows of head h sit at
//     row * Hkv * D + h * D in the [NB, BS, Hkv, D] pool.  The range's K
//     chunks and then its V chunks stream through a cp.async ring of at
//     least 3 stages (all 4 chunks of a bf16 range at D <= 64, 3 at D 128):
//     each step issues the next chunk before computing on the current, so
//     loads overlap the scores and the PV product; one __syncthreads a
//     chunk.  A staged row's 16-byte pieces are XOR-swizzled by the row,
//     so 8 rows read together hit 8 bank groups.
//   * bf16 runs on the tensor cores (mma.sync.m16n8k16, fp32 accumulate),
//     64-token chunks: scores S = K.q^T with the tokens as M (16 a warp)
//     and the G query rows, padded to 8, as N; after the last K chunk one
//     warp per row takes the range's max and sum and writes P, rounded to
//     bf16, as the B operand of out^T += V^T.P^T (D as M, V^T through
//     ldmatrix.trans, the rows as N, the tokens as K).  On the CUDA cores
//     (the first version of this design) the scores and PV took ~3000
//     instructions a warp and bounded the kernel.  fp32 stays on FMA (the
//     tensor cores would round it to TF32): 32-token chunks, lane c owns
//     token c's dot products with the warp's rows (no shuffle per (token,
//     row)); PV one thread per two columns (and per token part when
//     D < 256).
//   * Merge: a row with one live range writes its output directly.
//     Otherwise each range writes its partial (m, l, acc; fp32) and bumps
//     the (sequence, kv head)'s counter; the range that finds every live
//     range counted merges them in range order (M = max m, out = sum
//     e^(m-M) acc / sum e^(m-M) l) and resets the counter to 0 for the
//     next call.  The live range count follows from pos, so the merge
//     order, and every bit of a row's output, depend on that row's pos
//     and the table width alone (the batch-composition contract).  A
//     thread-block cluster merging through distributed shared memory
//     would hold every range of a cluster, dead ones included, on its SM
//     until the merge, and caps a cluster at 8 (16 non-portable) CTAs;
//     the counter lets a dead range exit at once.  Counters live in a
//     buffer the wrapper keeps zeroed between calls, so calls that share
//     it must run in stream order.
// Every live block is read once and dead ones are skipped.  Padded rows
// (pos 0, all-trash table) attend one trash slot and stay finite: l > 0,
// since slot 0 is live for every row.
//
// Plain C interface, loaded with ctypes (horovod_tpu_torch/ops/_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRange = 128;   // table slots a CTA takes
constexpr int kRows = 4;      // query rows a thread carries at once (fp32)
constexpr float kNegInf = -1e30f;

typedef __nv_bfloat16 bf16;

// How each dtype computes.  bf16: tensor cores (mma.sync.m16n8k16, fp32
// accumulation), chunks of 64 tokens (16 a warp), the query rows padded to
// 8, the product's n.  fp32: FMA (the tensor cores would round it to
// TF32), chunks of 32 tokens (one a lane), rows padded to 4.
template <typename T>
struct Path;
template <>
struct Path<bf16> {
  static constexpr bool kMma = true;
  static constexpr int kTok = 64;
  static constexpr int kRowPad = 8;
};
template <>
struct Path<float> {
  static constexpr bool kMma = false;
  static constexpr int kTok = 32;
  static constexpr int kRowPad = 4;
};

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as jnp.astype
}

// 16 bytes of fp32 (4 values) as floats.
__device__ __forceinline__ void unpack(const uint4& r, float (&f)[4]) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; pred false writes 16 zero bytes and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
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

// The layout of a staged row of D values (a K or V token, or a bf16 query
// row): its 16-byte pieces in the order v ^ (row & 7) (fewer bits for a
// short row), so the 8 rows a shared-memory phase or an ldmatrix reads
// fall in 8 distinct bank groups.
template <typename T, int D>
struct Staged {
  static constexpr int kVec = 16 / sizeof(T);   // values a piece
  static constexpr int kPieces = D / kVec;
  static constexpr int kSwz = (kPieces < 8 ? kPieces : 8) - 1;
  __host__ __device__ static int at(int row, int piece) {   // element offset
    return row * D + (piece ^ (row & kSwz)) * kVec;
  }
};

// Depth of the cp.async ring: a range's 2 * kRange / kTok chunks (K then
// V) all in flight where they fit in 48 KB, never fewer than 3.
template <typename T, int D>
__host__ __device__ constexpr int ring_stages() {
  constexpr int kAll = 2 * kRange / Path<T>::kTok;
  constexpr int kFit =
      49152 / (Path<T>::kTok * D * static_cast<int>(sizeof(T)));
  return kFit >= kAll ? kAll : kFit >= 3 ? kFit : 3;
}

// PV's partial sums, summed once at the end: bf16, warps that share an
// m-tile of 16 columns (D < 64) split a chunk's k-steps; fp32, a thread
// owns two adjacent columns and, when D < 256, the threads on one column
// pair split a chunk's tokens.
template <typename T, int D>
__host__ __device__ constexpr int pv_parts() {
  if (Path<T>::kMma) return D / 16 < kWarps ? kWarps / (D / 16) : 1;
  return D / 2 < kThreads ? kThreads / (D / 2) : 1;
}

// The dynamic shared memory, byte offsets: the ring [kStages][kTok][D];
// q (bf16 [Gp][D] staged, the scores' B operand; fp32 [G][D]); the
// token-major scores [W][Gp] fp32 (fp32: then P; in the merge the ranges'
// weights); bf16 P [Gp][kRange + 8] (PV's B operand, padded rows); the
// PV sums [parts][Gp][D] fp32; m and l [Gp]; the range's pool rows.
template <typename T, int D>
struct Smem {
  static constexpr int kPLD = kRange + 8;
  int Gp, W;
  size_t q, s, p, acc, m, rows, bytes;
  __host__ __device__ Smem(int G, int splits) {
    constexpr bool kMma = Path<T>::kMma;
    Gp = (G + Path<T>::kRowPad - 1) / Path<T>::kRowPad * Path<T>::kRowPad;
    W = kRange > splits ? kRange : splits;
    q = sizeof(T) * ring_stages<T, D>() * Path<T>::kTok * D;
    s = q + (kMma ? 2 * Gp : 4 * G) * static_cast<size_t>(D);
    p = s + 4 * static_cast<size_t>(W) * Gp;
    acc = p + (kMma ? 2 * static_cast<size_t>(Gp) * kPLD : 0);
    m = acc + 4 * static_cast<size_t>(pv_parts<T, D>()) * Gp * D;
    rows = m + 8 * static_cast<size_t>(Gp);
    bytes = rows + 4 * kRange;
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ pool_k,
                    const T* __restrict__ pool_v,
                    const int32_t* __restrict__ tables,
                    const int32_t* __restrict__ pos, T* __restrict__ out,
                    float* __restrict__ part_ml, float* __restrict__ part_acc,
                    int* __restrict__ counters, int G, int Hkv, int BS,
                    int maxb) {
  using L = Staged<T, D>;
  constexpr bool kMma = Path<T>::kMma;
  constexpr int kTok = Path<T>::kTok;
  constexpr int kVec = L::kVec;
  constexpr int kStages = ring_stages<T, D>();
  constexpr int kParts = pv_parts<T, D>();
  constexpr int kPLD = Smem<T, D>::kPLD;
  // Ranges vary fastest, so a long row's ranges start first.
  const int sp = blockIdx.x;   // token range
  const int h = blockIdx.y;    // kv head
  const int b = blockIdx.z;    // sequence
  const int splits = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int last;
  const Smem<T, D> sm(G, splits);
  const int Gp = sm.Gp;
  T* ring = reinterpret_cast<T*>(smem_raw);
  T* q_b = reinterpret_cast<T*>(smem_raw + sm.q);          // bf16 path
  float* q_s = reinterpret_cast<float*>(smem_raw + sm.q);  // fp32 path
  float* s_s = reinterpret_cast<float*>(smem_raw + sm.s);
  T* p_s = reinterpret_cast<T*>(smem_raw + sm.p);          // bf16 path
  float* acc_s = reinterpret_cast<float*>(smem_raw + sm.acc);
  float* m_s = reinterpret_cast<float*>(smem_raw + sm.m);
  float* l_s = m_s + Gp;
  int* row_s = reinterpret_cast<int*>(smem_raw + sm.rows);

  // The range's pool rows, read beside pos (a table entry past pos is a
  // valid block id, the trash block), so the K loads wait on one round
  // trip, not two.
  const int slots = maxb * BS;
  const int t_begin = sp * kRange;   // < slots
  const int32_t* tbl = tables + static_cast<size_t>(b) * maxb;
  for (int c = tid; c < kRange && t_begin + c < slots; c += kThreads) {
    const int tok = t_begin + c;
    row_s[c] = tbl[tok / BS] * BS + (tok % BS);
  }
  const int n = min(pos[b] + 1, slots);   // live slots k_pos <= pos
  if (t_begin >= n) return;   // no live token in this range
  const int live = min(n - t_begin, kRange);
  const int n_ranges = (n + kRange - 1) / kRange;
  const int nk = (live + kTok - 1) / kTok;   // K chunks, then as many V
  __syncthreads();

  const size_t stride = static_cast<size_t>(Hkv) * D;
  const size_t head_off = static_cast<size_t>(h) * D;
  // Chunk i of the stream (K chunks 0..nk-1, then the V chunks) into stage
  // i % kStages, zeros past the live tokens; one commit group a chunk,
  // empty past the stream's end, so the group count stays in step.
  auto issue = [&](int i) {
    if (i < 2 * nk) {
      const T* src = i < nk ? pool_k : pool_v;
      const int c0 = (i < nk ? i : i - nk) * kTok;
      T* dst = ring + (i % kStages) * kTok * D;
      for (int v = tid; v < kTok * L::kPieces; v += kThreads) {
        const int c = v / L::kPieces, piece = v % L::kPieces;
        const bool ok = c0 + c < live;
        cp_async16(dst + L::at(c, piece),
                   ok ? src + static_cast<size_t>(row_s[c0 + c]) * stride +
                            head_off + piece * kVec
                      : src,
                   ok);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);

  // q and the PV sums, while the first chunks land.
  const int Hq = Hkv * G;
  const T* qb = q + (static_cast<size_t>(b) * Hq +
                     static_cast<size_t>(h) * G) * D;
  if constexpr (kMma) {   // bf16 rows, staged; the padding rows zero
    for (int v = tid; v < Gp * L::kPieces; v += kThreads) {
      const int g = v / L::kPieces, piece = v % L::kPieces;
      *reinterpret_cast<uint4*>(q_b + L::at(g, piece)) =
          g < G ? *reinterpret_cast<const uint4*>(qb + g * D + piece * kVec)
                : make_uint4(0, 0, 0, 0);
    }
  } else {
    for (int v = tid; v < G * L::kPieces; v += kThreads) {
      float f[kVec];
      unpack(*reinterpret_cast<const uint4*>(qb + v * kVec), f);
#pragma unroll
      for (int e = 0; e < kVec; ++e) q_s[v * kVec + e] = f[e];
    }
  }
  for (int i = tid; i < kParts * Gp * D; i += kThreads) acc_s[i] = 0.f;

  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  for (int i = 0; i < 2 * nk; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // chunk i is in; every thread is done with i - 1
    issue(i + kStages - 1);   // into the stage chunk i - 1 held
    const T* tile = ring + (i % kStages) * kTok * D;
    if (i < nk) {
      if constexpr (kMma) {
        // Scores: S[token][row] = K . q^T, tokens as M (16 a warp), the
        // rows as N (8 a tile), D as K.
        const int t0 = i * kTok + warp * 16;
        for (int nt = 0; nt < Gp / 8; ++nt) {
          float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int ks = 0; ks < D / 16; ++ks) {
            uint32_t a[4], bq[2];
            ldsm_x4(a, tile + L::at(warp * 16 + (lane & 15),
                                    2 * ks + (lane >> 4)));
            ldsm_x2(bq, q_b + L::at(nt * 8 + (lane & 7),
                                    2 * ks + ((lane >> 3) & 1)));
            mma(c, a, bq);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int tok = t0 + (lane >> 2) + (e >> 1) * 8;
            s_s[tok * Gp + nt * 8 + (lane & 3) * 2 + (e & 1)] =
                tok < live ? c[e] * scale : kNegInf;
          }
        }
      } else {
        // Scores: lane c, token c of the chunk, against the warp's rows.
        const int c = i * kTok + lane;
        for (int g0 = warp; g0 < G; g0 += kWarps * kRows) {
          float s[kRows];
#pragma unroll
          for (int r = 0; r < kRows; ++r) s[r] = 0.f;
#pragma unroll
          for (int v = 0; v < L::kPieces; ++v) {
            float kf[kVec];
            unpack(*reinterpret_cast<const uint4*>(tile + L::at(lane, v)),
                   kf);
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              const int g = g0 + r * kWarps;
              if (g < G) {
                const float4 x =
                    *reinterpret_cast<const float4*>(q_s + g * D + v * kVec);
                s[r] = fmaf(x.x, kf[0], s[r]);
                s[r] = fmaf(x.y, kf[1], s[r]);
                s[r] = fmaf(x.z, kf[2], s[r]);
                s[r] = fmaf(x.w, kf[3], s[r]);
              }
            }
          }
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const int g = g0 + r * kWarps;
            if (g < G)
              s_s[c * Gp + g] = c < live ? s[r] * scale : kNegInf;
          }
        }
      }
      continue;
    }
    if (i == nk) {
      // The range's softmax, one warp per query row; the V chunks are
      // already in flight.  P is rounded to v.dtype (bf16: into the PV
      // operand, zero past the live tokens).
      for (int g = warp; g < G; g += kWarps) {
        float mx = kNegInf;
        for (int c = lane; c < live; c += 32)
          mx = fmaxf(mx, s_s[c * Gp + g]);
        mx = warp_max(mx);
        float sum = 0.f;
        for (int c = lane; c < live; c += 32) {
          const float p = expf(s_s[c * Gp + g] - mx);
          sum += p;
          if constexpr (kMma)
            p_s[g * kPLD + c] = from_f32<T>(p);
          else
            s_s[c * Gp + g] = p;   // already v.dtype
        }
        if constexpr (kMma)
          for (int c = live + lane; c < nk * kTok; c += 32)
            p_s[g * kPLD + c] = from_f32<T>(0.f);
        sum = warp_sum(sum);
        if (lane == 0) {
          m_s[g] = mx;
          l_s[g] = sum;
        }
      }
      __syncthreads();
    }
    const int k0 = (i - nk) * kTok;   // the chunk's first token
    if constexpr (kMma) {
      // out^T[d][row] += V^T . P^T: D as M (16-column m-tiles over the
      // warps), the rows as N, the chunk's tokens as K (16 a step; warps
      // that share an m-tile take every kParts-th step).
      constexpr int kMT = D / 16;
      constexpr int kMW = kMT < kWarps ? kMT : kWarps;
      const int part = warp / kMW;
      for (int nt = 0; nt < Gp / 8; ++nt) {
        for (int mt = warp % kMW; mt < kMT; mt += kMW) {
          float* ac = acc_s + static_cast<size_t>(part) * Gp * D;
          const int d = mt * 16 + (lane >> 2), g = nt * 8 + (lane & 3) * 2;
          float c[4] = {ac[g * D + d], ac[(g + 1) * D + d],
                        ac[g * D + d + 8], ac[(g + 1) * D + d + 8]};
#pragma unroll
          for (int ks = part; ks < kTok / 16; ks += kParts) {
            uint32_t a[4], bp[2];
            const int j = lane >> 3;
            ldsm_x4_t(a, tile + L::at(ks * 16 + (j >> 1) * 8 + (lane & 7),
                                      mt * 2 + (j & 1)));
            ldsm_x2(bp, p_s + (nt * 8 + (lane & 7)) * kPLD + k0 + ks * 16 +
                            ((lane >> 3) & 1) * 8);
            mma(c, a, bp);
          }
          ac[g * D + d] = c[0];
          ac[(g + 1) * D + d] = c[1];
          ac[g * D + d + 8] = c[2];
          ac[(g + 1) * D + d + 8] = c[3];
        }
      }
    } else {
      // acc[g][col..col+1] += sum_c p[c][g] * v[c][col..col+1] over this
      // thread's tokens, four rows at a time (rows past G add padding).
      const int col = (tid % (kThreads / kParts)) * 2;
      const int part = tid / (kThreads / kParts);
      const int c_end = min(kTok, live - k0);
      for (int g0 = 0; g0 < G; g0 += 4) {
        float2 a[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          a[r] = *reinterpret_cast<const float2*>(
              acc_s + (part * Gp + g0 + r) * D + col);
        for (int c = part; c < c_end; c += kParts) {
          const float2 v = *reinterpret_cast<const float2*>(
              tile + L::at(c, col / kVec) + col % kVec);
          const float4 p =
              *reinterpret_cast<const float4*>(s_s + (k0 + c) * Gp + g0);
          a[0].x = fmaf(p.x, v.x, a[0].x);
          a[0].y = fmaf(p.x, v.y, a[0].y);
          a[1].x = fmaf(p.y, v.x, a[1].x);
          a[1].y = fmaf(p.y, v.y, a[1].y);
          a[2].x = fmaf(p.z, v.x, a[2].x);
          a[2].y = fmaf(p.z, v.y, a[2].y);
          a[3].x = fmaf(p.w, v.x, a[3].x);
          a[3].y = fmaf(p.w, v.y, a[3].y);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
          *reinterpret_cast<float2*>(acc_s + (part * Gp + g0 + r) * D +
                                     col) = a[r];
      }
    }
  }
  __syncthreads();

  T* ob = out + (static_cast<size_t>(b) * Hq + static_cast<size_t>(h) * G) * D;
  if (n_ranges == 1) {   // the row's only range: no merge
    for (int i = tid; i < G * D; i += kThreads) {
      float a = 0.f;
#pragma unroll
      for (int p = 0; p < kParts; ++p) a += acc_s[p * Gp * D + i];
      ob[i] = from_f32<T>(a / l_s[i / D]);
    }
    return;
  }
  const size_t base = (static_cast<size_t>(b) * Hkv + h) * splits;
  float* pml = part_ml + base * G * 2;    // [splits][G][2] of (b, h)
  float* pacc = part_acc + base * G * D;  // [splits][G][D]
  for (int i = tid; i < G * D; i += kThreads) {
    float a = 0.f;
#pragma unroll
    for (int p = 0; p < kParts; ++p) a += acc_s[p * Gp * D + i];
    pacc[static_cast<size_t>(sp) * G * D + i] = a;
  }
  for (int g = tid; g < G; g += kThreads) {
    pml[(sp * G + g) * 2] = m_s[g];
    pml[(sp * G + g) * 2 + 1] = l_s[g];
  }
  __threadfence();   // the partial is visible before the count says so
  __syncthreads();
  if (tid == 0) {
    int* cnt = counters + static_cast<size_t>(b) * Hkv + h;
    last = atomicAdd(cnt, 1) == n_ranges - 1;
    if (last) *cnt = 0;   // every live range has counted: ready for reuse
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // Merge the live ranges, through L2 (__ldcg): one warp per query row
  // takes M = max m, the ranges' weights e^(m - M) (into the score buffer,
  // [range][Gp]) and the denominator; then each output sums its ranges in
  // range order, four outputs a pass so their loads are in flight
  // together.  Every order here follows from n_ranges alone.
  for (int g = warp; g < G; g += kWarps) {
    float M = kNegInf;
    for (int r = lane; r < n_ranges; r += 32)
      M = fmaxf(M, __ldcg(pml + (r * G + g) * 2));
    M = warp_max(M);
    float den = 0.f;
    for (int r = lane; r < n_ranges; r += 32) {
      const float w = expf(__ldcg(pml + (r * G + g) * 2) - M);
      s_s[r * Gp + g] = w;
      den += w * __ldcg(pml + (r * G + g) * 2 + 1);
    }
    den = warp_sum(den);
    if (lane == 0) l_s[g] = den;
  }
  __syncthreads();
  for (int i0 = tid; i0 < G * D; i0 += 4 * kThreads) {
    float num[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int r = 0; r < n_ranges; ++r) {
      const float* pr = pacc + static_cast<size_t>(r) * G * D;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = i0 + k * kThreads;
        if (i < G * D)
          num[k] = fmaf(s_s[r * Gp + i / D], __ldcg(pr + i), num[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = i0 + k * kThreads;
      if (i < G * D) ob[i] = from_f32<T>(num[k] / l_s[i / D]);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* pool_k, const void* pool_v,
           const void* tables, const void* pos, void* out, float* part_ml,
           float* part_acc, int* counters, int B, int Hkv, int G, int BS,
           int maxb, int splits, cudaStream_t stream) {
  const size_t smem = Smem<T, D>(G, splits).bytes;
  auto kernel = paged_decode_kernel<T, D>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(splits, Hkv, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pool_k),
      static_cast<const T*>(pool_v), static_cast<const int32_t*>(tables),
      static_cast<const int32_t*>(pos), static_cast<T*>(out), part_ml,
      part_acc, counters, G, Hkv, BS, maxb);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* pool_k, const void* pool_v,
               const void* tables, const void* pos, void* out, float* ml,
               float* acc, int* cnt, int B, int Hkv, int G, int D, int BS,
               int maxb, cudaStream_t s) {
  const int splits = (maxb * BS + kRange - 1) / kRange;
#define HVD_PA_CASE(DIM)                                                  \
  case DIM:                                                               \
    return launch<T, DIM>(q, pool_k, pool_v, tables, pos, out, ml, acc,  \
                          cnt, B, Hkv, G, BS, maxb, splits, s);
  switch (D) {
    HVD_PA_CASE(16)
    HVD_PA_CASE(32)
    HVD_PA_CASE(64)
    HVD_PA_CASE(128)
    HVD_PA_CASE(256)
    default: return -1;
  }
#undef HVD_PA_CASE
}

}  // namespace

// Table slots a CTA takes: the token ranges are [s * R, (s + 1) * R) for
// s < ceil(maxb * BS / R), which sizes the caller's scratch.
extern "C" int hvd_paged_attention_range_tokens() { return kRange; }

// dtype: 0 = float32, 1 = bfloat16.  Shapes: q/out [B, Hkv*G, D];
// pools [NB, BS, Hkv, D]; tables [B, maxb] int32; pos [B] int32; scratch
// part_ml [B, Hkv, splits, G, 2] and part_acc [B, Hkv, splits, G, D]
// fp32, splits = ceil(maxb * BS / range_tokens) (the partials of rows
// with more than one live range, read back by the same launch); counters
// int32 [B * Hkv] or more, zero on entry and left zero; all contiguous on
// the current device, q and the pools 16-byte aligned.  Returns 0, a
// cudaError_t from the launch, or -1 for an unsupported dtype or head dim.
extern "C" int hvd_paged_attention_decode(
    const void* q, const void* pool_k, const void* pool_v, const void* tables,
    const void* pos, void* out, void* part_ml, void* part_acc, void* counters,
    int B, int Hkv, int G, int D, int BS, int maxb, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ml = static_cast<float*>(part_ml);
  float* acc = static_cast<float*>(part_acc);
  int* cnt = static_cast<int*>(counters);
  if (dtype == 0)
    return dispatch_d<float>(q, pool_k, pool_v, tables, pos, out, ml, acc,
                             cnt, B, Hkv, G, D, BS, maxb, s);
  if (dtype == 1)
    return dispatch_d<bf16>(q, pool_k, pool_v, tables, pos, out, ml,
                                     acc, cnt, B, Hkv, G, D, BS, maxb, s);
  return -1;
}
