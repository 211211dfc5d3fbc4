// Fused paged-attention decode for NVIDIA Hopper (sm_90a).
//
// Replaces horovod_tpu/ops/paged_attention.py::_decode_kernel, the Pallas
// TPU kernel launched by _decode_pallas.  Same function: one query token
// per sequence attends its K/V straight through the block table, GQA
// heads grouped [Hkv, G], k_pos <= pos, fp32 scores scaled by 1/sqrt(D),
// fp32 online softmax (m, l, acc), probabilities rounded to the value
// dtype before the PV product, output in q's dtype.
//
// What bounds it on this card: bytes.  Each live K/V slot is read once,
// so the least time is  sum_b (pos_b + 1) * Hkv * D * 2 * itemsize  bytes
// over 3.35 TB/s; the arithmetic (4 * Hq * D flops per live slot) is far
// below the tensor-core line.
//
// Design:
//   * The table slots of each (sequence, kv head) are cut into `splits`
//     ranges of `split_tokens` (128 from the wrapper); one CTA of 128
//     threads per (kv head, sequence, range), so even one long sequence
//     spreads over the SMs.  Ranges past pos exit at once: table
//     columns past pos are never touched, loads included (the TPU kernel
//     DMAs every column and only skips the flops).
//   * There is no scalar prefetch on Hopper: a CTA reads its own table
//     row and turns each token into a pool row (block * BS + slot); K/V
//     rows of head h sit at row * Hkv * D + h * D in the [NB, BS, Hkv, D]
//     pool.  Each step stages a chunk of up to 64 tokens' K and V rows in
//     shared memory with 16-byte loads issued by all threads at once, so
//     the loads of a chunk are in flight together.
//   * Scores: one warp per token, lanes along D, one warp reduction per
//     query row; softmax: one warp per query row; PV: one thread per
//     head-dim column, query rows accumulated in registers four at a
//     time.  The G query rows of the group live in shared memory (fp32).
//   * Each CTA writes its partial (m, l, acc); a second kernel merges the
//     ranges of each (sequence, kv head): M = max m, out = sum e^(m-M) acc
//     / sum e^(m-M) l.  Ranges with no live token (l = 0) are skipped.
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
constexpr int kRowBlock = 4;   // query rows accumulated in registers
constexpr float kNegInf = -1e30f;

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as jnp.astype
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

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Tokens staged per step: 64, or fewer so one staged K (or V) tile stays
// within 16 KiB.
template <typename T, int D>
__host__ __device__ constexpr int chunk_tokens() {
  return 16384 / (D * static_cast<int>(sizeof(T))) < 64
             ? 16384 / (D * static_cast<int>(sizeof(T)))
             : 64;
}

// Dynamic shared memory in bytes: staged K and V tiles first (16-byte
// aligned), then fp32 q, acc, probabilities and softmax state, then the
// chunk's pool rows.
template <typename T, int D>
constexpr size_t smem_bytes(int G) {
  constexpr int C = chunk_tokens<T, D>();
  return 2 * sizeof(T) * C * D +
         sizeof(float) * (2 * G * D + round_up(G, kRowBlock) * C + 3 * G) +
         sizeof(int) * C;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ pool_k,
                    const T* __restrict__ pool_v,
                    const int32_t* __restrict__ tables,
                    const int32_t* __restrict__ pos,
                    float* __restrict__ part_ml, float* __restrict__ part_acc,
                    int G, int Hkv, int BS, int maxb, int split_tokens) {
  constexpr int C = chunk_tokens<T, D>();
  constexpr int kVec = 16 / sizeof(T);      // elements per 16-byte load
  constexpr int kVecPerRow = D / kVec;
  constexpr int kLoads = (C * kVecPerRow + kThreads - 1) / kThreads;
  constexpr int kPerLane = (D + 31) / 32;
  const int h = blockIdx.x;   // kv head
  const int b = blockIdx.y;   // sequence
  const int sp = blockIdx.z;  // token range
  const int S = gridDim.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int G4 = round_up(G, kRowBlock);

  const int n = min(pos[b] + 1, maxb * BS);  // live slots k_pos <= pos
  const int t_begin = sp * split_tokens;
  const int t_end = min(n, t_begin + split_tokens);
  const size_t part = (static_cast<size_t>(b) * Hkv + h) * S + sp;
  if (t_begin >= t_end) {  // no live token in this range
    for (int g = tid; g < G; g += kThreads) {
      part_ml[(part * G + g) * 2] = kNegInf;
      part_ml[(part * G + g) * 2 + 1] = 0.f;
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);         // [C][D] staged K
  T* v_s = k_s + C * D;                            // [C][D] staged V
  float* q_s = reinterpret_cast<float*>(v_s + C * D);  // [G][D]
  float* acc_s = q_s + G * D;                      // [G][D]
  float* p_s = acc_s + G * D;                      // [G4][C]
  float* m_s = p_s + G4 * C;                       // [G]
  float* l_s = m_s + G;                            // [G]
  float* alpha_s = l_s + G;                        // [G]
  int* row_s = reinterpret_cast<int*>(alpha_s + G);  // [C] pool rows

  const int Hq = Hkv * G;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  const size_t head_off = static_cast<size_t>(h) * D;
  const size_t row_stride = static_cast<size_t>(Hkv) * D;
  const T* qb = q + (static_cast<size_t>(b) * Hq + static_cast<size_t>(h) * G) * D;
  for (int i = tid; i < G * D; i += kThreads) {
    q_s[i] = to_f32(qb[i]);
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  const int32_t* tbl = tables + static_cast<size_t>(b) * maxb;
  __syncthreads();

  for (int c0 = t_begin; c0 < t_end; c0 += C) {
    const int cn = min(C, t_end - c0);
    for (int c = tid; c < cn; c += kThreads) {
      const int t = c0 + c;
      row_s[c] = tbl[t / BS] * BS + (t % BS);
    }
    __syncthreads();
    // Stage the chunk's K and V rows: all of a thread's 16-byte loads are
    // issued before any is stored, so the whole chunk is in flight at once.
    {
      uint4 kr[kLoads], vr[kLoads];
#pragma unroll
      for (int j = 0; j < kLoads; ++j) {
        const int i = tid + j * kThreads;
        if (i < cn * kVecPerRow) {
          const size_t src =
              static_cast<size_t>(row_s[i / kVecPerRow]) * row_stride +
              head_off + static_cast<size_t>(i % kVecPerRow) * kVec;
          kr[j] = *reinterpret_cast<const uint4*>(pool_k + src);
          vr[j] = *reinterpret_cast<const uint4*>(pool_v + src);
        }
      }
#pragma unroll
      for (int j = 0; j < kLoads; ++j) {
        const int i = tid + j * kThreads;
        if (i < cn * kVecPerRow) {
          reinterpret_cast<uint4*>(k_s)[i] = kr[j];
          reinterpret_cast<uint4*>(v_s)[i] = vr[j];
        }
      }
    }
    __syncthreads();

    // Scores s[g][c] = (q_g . k_c) * scale, fp32 accumulation.
    for (int c = warp; c < cn; c += kWarps) {
      float kv[kPerLane];
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const int d = lane + 32 * i;
        kv[i] = d < D ? to_f32(k_s[c * D + d]) : 0.f;
      }
      for (int g = 0; g < G; ++g) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < kPerLane; ++i) {
          const int d = lane + 32 * i;
          if (d < D) s += q_s[g * D + d] * kv[i];
        }
        s = warp_sum(s);
        if (lane == 0) p_s[g * C + c] = s * scale;
      }
    }
    __syncthreads();

    // Online softmax update, one warp per query row.
    for (int g = warp; g < G; g += kWarps) {
      float mx = kNegInf;
      for (int c = lane; c < cn; c += 32) mx = fmaxf(mx, p_s[g * C + c]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int c = lane; c < cn; c += 32) {
        const float p = expf(p_s[g * C + c] - m_new);
        sum += p;
        p_s[g * C + c] = to_f32(from_f32<T>(p));  // cast to v.dtype
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        alpha_s[g] = alpha;
        m_s[g] = m_new;
        l_s[g] = l_s[g] * alpha + sum;
      }
    }
    __syncthreads();

    // acc[g][d] = acc[g][d] * alpha[g] + sum_c p[g][c] * v[c][d].
    for (int d = tid; d < D; d += kThreads) {
      for (int g0 = 0; g0 < G; g0 += kRowBlock) {
        float a[kRowBlock];
#pragma unroll
        for (int j = 0; j < kRowBlock; ++j)
          a[j] = g0 + j < G ? acc_s[(g0 + j) * D + d] * alpha_s[g0 + j] : 0.f;
        for (int c = 0; c < cn; ++c) {
          const float v = to_f32(v_s[c * D + d]);
#pragma unroll
          for (int j = 0; j < kRowBlock; ++j)
            a[j] += p_s[(g0 + j) * C + c] * v;
        }
#pragma unroll
        for (int j = 0; j < kRowBlock; ++j)
          if (g0 + j < G) acc_s[(g0 + j) * D + d] = a[j];
      }
    }
    __syncthreads();
  }

  for (int g = tid; g < G; g += kThreads) {
    part_ml[(part * G + g) * 2] = m_s[g];
    part_ml[(part * G + g) * 2 + 1] = l_s[g];
  }
  float* pacc = part_acc + part * G * D;
  for (int i = tid; i < G * D; i += kThreads) pacc[i] = acc_s[i];
}

// Merge the token ranges of one (sequence, kv head) into the output.
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_combine(const float* __restrict__ part_ml,
                     const float* __restrict__ part_acc, T* __restrict__ out,
                     int G, int Hkv, int D, int S) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const size_t base = (static_cast<size_t>(b) * Hkv + h) * S;
  T* ob = out + (static_cast<size_t>(b) * Hkv * G + static_cast<size_t>(h) * G) * D;
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D;
    const int d = i % D;
    float M = kNegInf;
    for (int s = 0; s < S; ++s) {
      const float* ml = part_ml + ((base + s) * G + g) * 2;
      if (ml[1] > 0.f) M = fmaxf(M, ml[0]);
    }
    float num = 0.f, den = 0.f;
    for (int s = 0; s < S; ++s) {
      const float* ml = part_ml + ((base + s) * G + g) * 2;
      if (ml[1] > 0.f) {
        const float w = expf(ml[0] - M);
        den += w * ml[1];
        num += w * part_acc[((base + s) * G + g) * D + d];
      }
    }
    ob[i] = from_f32<T>(num / den);
  }
}

template <typename T, int D>
int launch(const void* q, const void* pool_k, const void* pool_v,
           const void* tables, const void* pos, void* out, float* part_ml,
           float* part_acc, int B, int Hkv, int G, int BS, int maxb,
           int splits, int split_tokens, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, D>(G);
  auto kernel = paged_decode_kernel<T, D>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(Hkv, B, splits), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pool_k),
      static_cast<const T*>(pool_v), static_cast<const int32_t*>(tables),
      static_cast<const int32_t*>(pos), part_ml, part_acc, G, Hkv, BS, maxb,
      split_tokens);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_decode_combine<T><<<dim3(Hkv, B), kThreads, 0, stream>>>(
      part_ml, part_acc, static_cast<T*>(out), G, Hkv, D, splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* pool_k, const void* pool_v,
               const void* tables, const void* pos, void* out, float* ml,
               float* acc, int B, int Hkv, int G, int D, int BS, int maxb,
               int splits, int split_tokens, cudaStream_t s) {
#define HVD_PA_CASE(DIM)                                                    \
  case DIM:                                                                 \
    return launch<T, DIM>(q, pool_k, pool_v, tables, pos, out, ml, acc, B, \
                          Hkv, G, BS, maxb, splits, split_tokens, s);
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

// dtype: 0 = float32, 1 = bfloat16.  Shapes: q/out [B, Hkv*G, D];
// pools [NB, BS, Hkv, D]; tables [B, maxb] int32; pos [B] int32; scratch
// part_ml [B, Hkv, splits, G, 2] and part_acc [B, Hkv, splits, G, D]
// fp32; all contiguous on the current device.  The token ranges are
// [s * split_tokens, (s + 1) * split_tokens), s < splits.  Returns 0, a
// cudaError_t from a launch, or -1 for an unsupported dtype / head dim.
extern "C" int hvd_paged_attention_decode(
    const void* q, const void* pool_k, const void* pool_v, const void* tables,
    const void* pos, void* out, void* part_ml, void* part_acc, int B,
    int Hkv, int G, int D, int BS, int maxb, int splits, int split_tokens,
    int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ml = static_cast<float*>(part_ml);
  float* acc = static_cast<float*>(part_acc);
  if (dtype == 0)
    return dispatch_d<float>(q, pool_k, pool_v, tables, pos, out, ml, acc, B,
                             Hkv, G, D, BS, maxb, splits, split_tokens, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, pool_k, pool_v, tables, pos, out, ml,
                                     acc, B, Hkv, G, D, BS, maxb, splits,
                                     split_tokens, s);
  return -1;
}
