// Fused RMSNorm, forward and backward, for NVIDIA Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of horovod_tpu/ops/rms_norm.py:
//
//   hvd_rms_fwd <- _fwd_kernel   y = x * rstd * scale, rstd = 1/sqrt(mean(x^2)
//                                + eps), statistics and scale in fp32
//   hvd_rms_bwd <- _bwd_kernel   dx = rstd * (dy*s - xhat * mean_H(dy*s*xhat))
//                                with xhat = x * rstd, plus one partial
//                                sum_rows(dy * xhat) per row block
//
// Same functions and rounding points as the reference: x (and dy) are
// widened to fp32, y = (x * rstd) * scale in fp32 and rounded once to the
// output dtype; dx is rounded once to x's dtype.  The caller sums the
// [n_blocks, H] fp32 partials (the reference's jnp.sum outside its kernel).
//
// What bounds them on this card: bytes.  Each does ~5-8 FLOPs per element
// it reads, against the ~295 per byte where the tensor cores become the
// limit, so the only aim is to read each input once and write each output
// once.  At the Llama-3-8B training shape (R = B*S = 4096 rows, H 4096,
// bf16 x/y/dy) the forward moves 67 MB and the backward 101 MB: 0.020 and
// 0.030 ms at 3.35 TB/s.
//
// Design (simple first): one CTA of up to 256 threads walks rows; thread t
// owns the fixed columns [(k*T + t)*V, +V) of every row (V = 8 bf16 or 4
// fp32 values: one 16-byte load, neighbouring threads on neighbouring
// addresses; V = 1 where H or a pointer is off that width, so any H
// runs).  Per row: pass 1 reads the row and reduces the statistic over the
// CTA in fp32 (warp shuffles, then one value per warp through shared
// memory, in a fixed order); pass 2 reads the row again (from L1/L2, not
// HBM) and writes the result.
//   * forward: grid = one CTA per row (grid-strided past 2^20 rows).
//   * backward: the rows are cut into contiguous blocks of `rows` (the
//     wrapper picks ~264 blocks, two per SM of the H100's 132), and each
//     CTA keeps its block's dscale partial for its own columns in shared
//     memory, laid out [chunk][element][thread] so a warp's accesses hit
//     32 banks.  Only the owning thread ever touches a column, so there
//     are no atomics and no order that changes from run to run: the
//     result is deterministic.
//
// Plain C interface, loaded with ctypes (horovod_tpu_torch/ops/_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;        // threads per CTA, at most
constexpr int kMaxGrid = 1 << 20;    // forward CTAs, at most

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// V consecutive elements at p (aligned to min(16, V * sizeof(T)) bytes)
// widened to fp32: 16-byte loads where the span allows, else 8-byte or
// single elements.
template <int V, typename T>
__device__ __forceinline__ void load(const T* p, float (&f)[V]) {
  constexpr int kBytes = V * static_cast<int>(sizeof(T));
  if constexpr (kBytes % 16 == 0) {
    constexpr int kPer = 16 / sizeof(T);
#pragma unroll
    for (int o = 0; o < V; o += kPer) {
      const uint4 raw = *reinterpret_cast<const uint4*>(p + o);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < kPer; ++i) f[o + i] = to_f(e[i]);
    }
  } else if constexpr (kBytes == 8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) f[i] = to_f(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) f[i] = to_f(p[i]);
  }
}

// V fp32 values rounded to T and stored at p (aligned as for load).
template <int V, typename T>
__device__ __forceinline__ void store(T* p, const float (&f)[V]) {
  constexpr int kBytes = V * static_cast<int>(sizeof(T));
  if constexpr (kBytes % 16 == 0) {
    constexpr int kPer = 16 / sizeof(T);
#pragma unroll
    for (int o = 0; o < V; o += kPer) {
      uint4 raw;
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int i = 0; i < kPer; ++i) e[i] = from_f<T>(f[o + i]);
      *reinterpret_cast<uint4*>(p + o) = raw;
    }
  } else if constexpr (kBytes == 8) {
    uint2 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) e[i] = from_f<T>(f[i]);
    *reinterpret_cast<uint2*>(p) = raw;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = from_f<T>(f[i]);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of v over the CTA (blockDim.x a multiple of 32), in a fixed order;
// every thread gets it.  red: 33 floats of shared memory.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < static_cast<int>(blockDim.x >> 5) ? red[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) red[32] = t;
  }
  __syncthreads();
  return red[32];
}

// hvd_rms_fwd <- _fwd_kernel, horovod_tpu/ops/rms_norm.py:46.
// Bound by bytes: x read, y written, rstd written once.
template <typename TX, typename TY, int V>
__global__ void __launch_bounds__(kThreads)
    rms_fwd_kernel(const TX* __restrict__ x, const float* __restrict__ scale,
                   TY* __restrict__ y, float* __restrict__ rstd, int R, int H,
                   float eps) {
  __shared__ float red[33];
  const int step = blockDim.x * V;
  for (int row = blockIdx.x; row < R; row += gridDim.x) {
    const TX* xr = x + static_cast<size_t>(row) * H;
    TY* yr = y + static_cast<size_t>(row) * H;
    float ss = 0.f;
#pragma unroll 4
    for (int c = threadIdx.x * V; c < H; c += step) {
      float f[V];
      load<V>(xr + c, f);
#pragma unroll
      for (int i = 0; i < V; ++i) ss += f[i] * f[i];
    }
    ss = block_sum(ss, red);
    const float r = 1.f / sqrtf(ss / static_cast<float>(H) + eps);
#pragma unroll 4
    for (int c = threadIdx.x * V; c < H; c += step) {
      float f[V], s[V];
      load<V>(xr + c, f);
      load<V>(scale + c, s);
#pragma unroll
      for (int i = 0; i < V; ++i) f[i] = f[i] * r * s[i];
      store<V>(yr + c, f);
    }
    if (threadIdx.x == 0) rstd[row] = r;
  }
}

// hvd_rms_bwd <- _bwd_kernel, rms_norm.py:55.
// Bound by bytes: x and dy read, dx written once (plus rstd, scale and
// the partials, ~0.5 % at the training shape).  CTA b owns rows
// [b * rows, (b + 1) * rows) and writes parts[b, :].
template <typename TX, typename TY, int V>
__global__ void __launch_bounds__(kThreads)
    rms_bwd_kernel(const TX* __restrict__ x, const float* __restrict__ scale,
                   const float* __restrict__ rstd, const TY* __restrict__ dy,
                   TX* __restrict__ dx, float* __restrict__ parts, int R,
                   int H, int rows) {
  extern __shared__ float part[];   // [chunk k][element i][thread t]
  __shared__ float red[33];
  const int T = blockDim.x, t = threadIdx.x, step = T * V;
  // Column (k*T + t)*V + i lives at part[(k*V + i)*T + t].
  for (int c = t * V, k = 0; c < H; c += step, ++k) {
#pragma unroll
    for (int i = 0; i < V; ++i) part[(k * V + i) * T + t] = 0.f;
  }
  const int r0 = blockIdx.x * rows, r1 = min(R, r0 + rows);
  for (int row = r0; row < r1; ++row) {
    const size_t off = static_cast<size_t>(row) * H;
    const float r = rstd[row];
    float dot = 0.f;
#pragma unroll 4
    for (int c = t * V; c < H; c += step) {
      float xf[V], gf[V], s[V];
      load<V>(x + off + c, xf);
      load<V>(dy + off + c, gf);
      load<V>(scale + c, s);
#pragma unroll
      for (int i = 0; i < V; ++i) dot += (gf[i] * s[i]) * (xf[i] * r);
    }
    const float m = block_sum(dot, red) / static_cast<float>(H);
    int k = 0;
#pragma unroll 4
    for (int c = t * V; c < H; c += step, ++k) {
      float xf[V], gf[V], s[V], out[V];
      load<V>(x + off + c, xf);
      load<V>(dy + off + c, gf);
      load<V>(scale + c, s);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float xh = xf[i] * r;
        out[i] = r * (gf[i] * s[i] - xh * m);
        part[(k * V + i) * T + t] += gf[i] * xh;
      }
      store<V>(dx + off + c, out);
    }
  }
  float* pb = parts + static_cast<size_t>(blockIdx.x) * H;
  for (int c = t * V, k = 0; c < H; c += step, ++k) {
#pragma unroll
    for (int i = 0; i < V; ++i) pb[c + i] = part[(k * V + i) * T + t];
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Threads per CTA: enough 32-thread warps to cover the row's chunks once,
// at most kThreads.
int threads_for(int H, int V) {
  const int chunks = (H + V - 1) / V;
  const int warps = (chunks + 31) / 32;
  return warps * 32 < kThreads ? warps * 32 : kThreads;
}

template <typename TX, typename TY, int V>
int fwd_launch(const void* x, const void* scale, void* y, void* rstd, int R,
               int H, float eps, cudaStream_t stream) {
  const int threads = threads_for(H, V);
  const int grid = R < kMaxGrid ? R : kMaxGrid;
  rms_fwd_kernel<TX, TY, V><<<grid, threads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const float*>(scale),
      static_cast<TY*>(y), static_cast<float*>(rstd), R, H, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename TX, typename TY, int V>
int bwd_launch(const void* x, const void* scale, const void* rstd,
               const void* dy, void* dx, void* parts, int R, int H, int rows,
               cudaStream_t stream) {
  const int threads = threads_for(H, V);
  const int per_thread = (H + threads * V - 1) / (threads * V);
  const size_t smem = static_cast<size_t>(per_thread) * V * threads *
                      sizeof(float);
  auto kernel = rms_bwd_kernel<TX, TY, V>;
  if (smem > 48 * 1024) {
    if (cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem)))
      return static_cast<int>(err);
  }
  const int grid = (R + rows - 1) / rows;
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(rstd), static_cast<const TY*>(dy),
      static_cast<TX*>(dx), static_cast<float*>(parts), R, H, rows);
  return static_cast<int>(cudaGetLastError());
}

// The 16-byte width in elements for a (TX, TY) pair: 8 when both are
// bf16, else 4 (the wider type's 16 bytes).
template <typename TX, typename TY>
constexpr int vec_width() {
  return sizeof(TX) == 2 && sizeof(TY) == 2 ? 8 : 4;
}

template <typename TX, typename TY>
int fwd_typed(const void* x, const void* scale, void* y, void* rstd, int R,
              int H, float eps, cudaStream_t stream) {
  constexpr int kV = vec_width<TX, TY>();
  if (H % kV == 0 && aligned16(x) && aligned16(scale) && aligned16(y))
    return fwd_launch<TX, TY, kV>(x, scale, y, rstd, R, H, eps, stream);
  return fwd_launch<TX, TY, 1>(x, scale, y, rstd, R, H, eps, stream);
}

template <typename TX, typename TY>
int bwd_typed(const void* x, const void* scale, const void* rstd,
              const void* dy, void* dx, void* parts, int R, int H, int rows,
              cudaStream_t stream) {
  constexpr int kV = vec_width<TX, TY>();
  if (H % kV == 0 && aligned16(x) && aligned16(scale) && aligned16(dy) &&
      aligned16(dx))
    return bwd_launch<TX, TY, kV>(x, scale, rstd, dy, dx, parts, R, H, rows,
                                  stream);
  return bwd_launch<TX, TY, 1>(x, scale, rstd, dy, dx, parts, R, H, rows,
                               stream);
}

constexpr int kMaxH = 48 * 1024;   // the backward's partials fit in smem

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  x/y/dy/dx: contiguous [R, H];
// scale: contiguous fp32 [H]; rstd: fp32 [R]; parts: fp32
// [ceil(R / rows), H].  All on the current device; launches on `stream`,
// allocates nothing.  Returns 0, a cudaError_t from the launch, or -1 for
// an unsupported dtype or shape.
extern "C" int hvd_rms_fwd(const void* x, const void* scale, void* y,
                           void* rstd, int R, int H, float eps, int x_dtype,
                           int y_dtype, void* stream) {
  if (R < 0 || H < 1 || H > kMaxH) return -1;
  if (R == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_dtype * 2 + y_dtype) {
    case 0: return fwd_typed<float, float>(x, scale, y, rstd, R, H, eps, s);
    case 1: return fwd_typed<float, bf16>(x, scale, y, rstd, R, H, eps, s);
    case 2: return fwd_typed<bf16, float>(x, scale, y, rstd, R, H, eps, s);
    case 3: return fwd_typed<bf16, bf16>(x, scale, y, rstd, R, H, eps, s);
    default: return -1;
  }
}

extern "C" int hvd_rms_bwd(const void* x, const void* scale,
                           const void* rstd, const void* dy, void* dx,
                           void* parts, int R, int H, int rows, int x_dtype,
                           int dy_dtype, void* stream) {
  if (R < 0 || H < 1 || H > kMaxH || rows < 1) return -1;
  if (R == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_dtype * 2 + dy_dtype) {
    case 0:
      return bwd_typed<float, float>(x, scale, rstd, dy, dx, parts, R, H,
                                     rows, s);
    case 1:
      return bwd_typed<float, bf16>(x, scale, rstd, dy, dx, parts, R, H,
                                    rows, s);
    case 2:
      return bwd_typed<bf16, float>(x, scale, rstd, dy, dx, parts, R, H,
                                    rows, s);
    case 3:
      return bwd_typed<bf16, bf16>(x, scale, rstd, dy, dx, parts, R, H, rows,
                                   s);
    default: return -1;
  }
}
