#include "engine.h"

#include <fcntl.h>
#include <poll.h>
#include <sys/socket.h>
#include <unistd.h>

#include <algorithm>
#include <cassert>
#include <cctype>
#include <cerrno>
#include <chrono>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <map>
#include <sstream>

#if defined(__x86_64__)
#include <cpuid.h>
#include <immintrin.h>
#endif

namespace hvd {

// ---------------------------------------------------------------------------
// Reduction kernels
// ---------------------------------------------------------------------------

// IEEE half <-> float, scalar bit twiddling (no F16C dependency; the
// compiler auto-vectorizes the loops below well enough for a host-side
// control-plane data path).
static inline float HalfToFloat(uint16_t h) {
  uint32_t sign = (h & 0x8000u) << 16;
  uint32_t exp = (h >> 10) & 0x1f;
  uint32_t man = h & 0x3ffu;
  uint32_t f;
  if (exp == 0) {
    if (man == 0) {
      f = sign;
    } else {
      exp = 127 - 15 + 1;
      while ((man & 0x400u) == 0) {
        man <<= 1;
        exp--;
      }
      man &= 0x3ffu;
      f = sign | (exp << 23) | (man << 13);
    }
  } else if (exp == 0x1f) {
    f = sign | 0x7f800000u | (man << 13);
  } else {
    f = sign | ((exp - 15 + 127) << 23) | (man << 13);
  }
  float out;
  memcpy(&out, &f, 4);
  return out;
}

// Round-to-nearest-EVEN, exactly like the F16C hardware converter
// (_MM_FROUND_TO_NEAREST_INT): the SIMD kernel below handles 8-lane
// groups and this scalar handles the tails, so any rounding divergence
// would make results depend on where chunk/shard edges land — the
// multi-channel bit-exactness guarantee forbids that.
static inline uint16_t FloatToHalf(float v) {
  uint32_t f;
  memcpy(&f, &v, 4);
  uint32_t sign = (f >> 16) & 0x8000u;
  int32_t exp = static_cast<int32_t>((f >> 23) & 0xff) - 127 + 15;
  uint32_t man = f & 0x7fffffu;
  if (exp <= 0) {
    if (exp < -10) return static_cast<uint16_t>(sign);
    man |= 0x800000u;
    uint32_t shift = static_cast<uint32_t>(14 - exp);
    uint32_t half_man = man >> shift;
    uint32_t halfbit = 1u << (shift - 1);
    uint32_t rem = man & ((1u << shift) - 1u);
    if (rem > halfbit || (rem == halfbit && (half_man & 1u))) half_man += 1;
    return static_cast<uint16_t>(sign | half_man);
  }
  if (exp >= 0x1f) {
    // Source NaN (exponent field 0xff, mantissa nonzero) must become a
    // QUIET half NaN with the truncated payload — exactly what the F16C
    // converter emits — not infinity: the SIMD/scalar split falls on
    // chunk and shard edges, and any divergence would break the
    // channel-count bit-exactness guarantee.  Finite overflow (source
    // exponent < 0xff) still rounds to infinity.
    if (exp == 0xff - 127 + 15 && man != 0) {
      return static_cast<uint16_t>(sign | 0x7e00u | (man >> 13));
    }
    return static_cast<uint16_t>(sign | 0x7c00u);
  }
  uint32_t half = sign | (static_cast<uint32_t>(exp) << 10) | (man >> 13);
  uint32_t rem = man & 0x1fffu;
  if (rem > 0x1000u || (rem == 0x1000u && (half & 1u))) half += 1;
  return static_cast<uint16_t>(half);
}

// bfloat16 is float32's top 16 bits — the TPU-native conversion is two
// shifts (with round-to-nearest-even on the way down).
static inline float BF16ToFloat(uint16_t h) {
  uint32_t f = static_cast<uint32_t>(h) << 16;
  float out;
  memcpy(&out, &f, 4);
  return out;
}

static inline uint16_t FloatToBF16(float v) {
  uint32_t f;
  memcpy(&f, &v, 4);
  uint32_t rounding = 0x7fffu + ((f >> 16) & 1u);
  return static_cast<uint16_t>((f + rounding) >> 16);
}

// __restrict: dst and src never alias (dst is the accumulating local
// buffer, src a received scratch chunk), and telling GCC 10 so is what
// lets it vectorize the combine without runtime overlap checks.  The
// 4-way unrolled body keeps the vectorizer on the wide path even when a
// chunk tail disables peeling.
template <typename T, typename F>
static void CombineLoop(void* dst, const void* src, int64_t n, F f) {
  T* __restrict d = static_cast<T*>(dst);
  const T* __restrict s = static_cast<const T*>(src);
  int64_t i = 0;
  for (; i + 4 <= n; i += 4) {
    d[i] = f(d[i], s[i]);
    d[i + 1] = f(d[i + 1], s[i + 1]);
    d[i + 2] = f(d[i + 2], s[i + 2]);
    d[i + 3] = f(d[i + 3], s[i + 3]);
  }
  for (; i < n; ++i) d[i] = f(d[i], s[i]);
}

template <typename T>
static void TypedReduce(void* dst, const void* src, int64_t n, ReduceOp op) {
  switch (op) {
    case ReduceOp::SUM:
      CombineLoop<T>(dst, src, n, [](T a, T b) { return static_cast<T>(a + b); });
      return;
    case ReduceOp::MIN:
      CombineLoop<T>(dst, src, n, [](T a, T b) { return b < a ? b : a; });
      return;
    case ReduceOp::MAX:
      CombineLoop<T>(dst, src, n, [](T a, T b) { return a < b ? b : a; });
      return;
    case ReduceOp::PROD:
      CombineLoop<T>(dst, src, n, [](T a, T b) { return static_cast<T>(a * b); });
      return;
  }
}

// 16-bit floats combine through fp32, staged in blocks: convert a block
// of each side to fp32, combine, convert back — four SIMPLE loops GCC 10
// autovectorizes independently (the bf16 conversions are branch-free
// shifts), where the fused per-element convert-combine-convert body
// defeated its cost model.  fp16's subnormal-handling conversions stay
// scalar either way — its SUM hot path goes through the F16C kernel
// below.  This is the eager/DCN hot loop for fused 64 MB gradient
// buffers (the TPU jit path never touches it).
template <float (*ToF)(uint16_t), uint16_t (*FromF)(float), typename F>
static void HalfCombineLoop(uint16_t* __restrict d,
                            const uint16_t* __restrict s, int64_t n, F f) {
  constexpr int64_t kBlock = 256;
  float a[kBlock], b[kBlock];
  int64_t i = 0;
  for (; i + kBlock <= n; i += kBlock) {
    for (int64_t j = 0; j < kBlock; ++j) a[j] = ToF(d[i + j]);
    for (int64_t j = 0; j < kBlock; ++j) b[j] = ToF(s[i + j]);
    for (int64_t j = 0; j < kBlock; ++j) a[j] = f(a[j], b[j]);
    for (int64_t j = 0; j < kBlock; ++j) d[i + j] = FromF(a[j]);
  }
  for (; i < n; ++i) d[i] = FromF(f(ToF(d[i]), ToF(s[i])));
}

#if defined(__x86_64__)
// IEEE-half summation via the F16C hardware converters, 8 lanes at a time
// (the scalar HalfToFloat/FloatToHalf branch on subnormals and cannot
// vectorize).  Role parity with the reference's AVX fp16 MPI op
// (common/half.cc:26-65); selected once per call via CPUID, never inside
// the loop.
__attribute__((target("f16c,avx")))
static void HalfSumF16C(uint16_t* d, const uint16_t* s, int64_t n) {
  int64_t i = 0;
  for (; i + 8 <= n; i += 8) {
    __m256 a = _mm256_cvtph_ps(
        _mm_loadu_si128(reinterpret_cast<const __m128i*>(d + i)));
    __m256 b = _mm256_cvtph_ps(
        _mm_loadu_si128(reinterpret_cast<const __m128i*>(s + i)));
    _mm_storeu_si128(
        reinterpret_cast<__m128i*>(d + i),
        _mm256_cvtps_ph(_mm256_add_ps(a, b), _MM_FROUND_TO_NEAREST_INT));
  }
  for (; i < n; ++i) d[i] = FloatToHalf(HalfToFloat(d[i]) + HalfToFloat(s[i]));
}

static bool HasF16C() {
  // Raw CPUID instead of __builtin_cpu_supports("f16c"): GCC only learned
  // the "f16c" feature name in GCC 11, and the builtin is a compile ERROR
  // (not a false) on older compilers — which silently broke the whole
  // native-engine build on GCC 10 images.
  static const bool has = [] {
    unsigned int eax = 0, ebx = 0, ecx = 0, edx = 0;
    if (!__get_cpuid(1, &eax, &ebx, &ecx, &edx)) return false;
    if ((ecx & bit_F16C) == 0 || (ecx & bit_AVX) == 0) return false;
    // CPUID only reports CPU capability; the OS must also have enabled
    // XSAVE and YMM state (what __builtin_cpu_supports checked for us),
    // or the first VEX instruction SIGILLs.
    if ((ecx & bit_OSXSAVE) == 0) return false;
    uint32_t xlo, xhi;
    __asm__ volatile("xgetbv" : "=a"(xlo), "=d"(xhi) : "c"(0));
    return (xlo & 0x6) == 0x6;  // XMM and YMM state enabled
  }();
  return has;
}
#endif

template <float (*ToF)(uint16_t), uint16_t (*FromF)(float)>
static void HalfReduce(void* dst, const void* src, int64_t n, ReduceOp op) {
  uint16_t* d = static_cast<uint16_t*>(dst);
  const uint16_t* s = static_cast<const uint16_t*>(src);
#if defined(__x86_64__)
  if (op == ReduceOp::SUM && ToF == static_cast<float (*)(uint16_t)>(
                                 HalfToFloat) && HasF16C()) {
    HalfSumF16C(d, s, n);
    return;
  }
#endif
  switch (op) {
    case ReduceOp::SUM:
      HalfCombineLoop<ToF, FromF>(d, s, n,
                                  [](float a, float b) { return a + b; });
      return;
    case ReduceOp::MIN:
      HalfCombineLoop<ToF, FromF>(
          d, s, n, [](float a, float b) { return b < a ? b : a; });
      return;
    case ReduceOp::MAX:
      HalfCombineLoop<ToF, FromF>(
          d, s, n, [](float a, float b) { return a < b ? b : a; });
      return;
    case ReduceOp::PROD:
      HalfCombineLoop<ToF, FromF>(d, s, n,
                                  [](float a, float b) { return a * b; });
      return;
  }
}

void ReduceInto(void* dst, const void* src, int64_t count, DataType dtype,
                ReduceOp op) {
  switch (dtype) {
    case DataType::FLOAT32: TypedReduce<float>(dst, src, count, op); return;
    case DataType::FLOAT64: TypedReduce<double>(dst, src, count, op); return;
    case DataType::INT32: TypedReduce<int32_t>(dst, src, count, op); return;
    case DataType::INT64: TypedReduce<int64_t>(dst, src, count, op); return;
    case DataType::UINT8: TypedReduce<uint8_t>(dst, src, count, op); return;
    case DataType::INT8: TypedReduce<int8_t>(dst, src, count, op); return;
    case DataType::UINT16: TypedReduce<uint16_t>(dst, src, count, op); return;
    case DataType::INT16: TypedReduce<int16_t>(dst, src, count, op); return;
    case DataType::FLOAT16:
      HalfReduce<HalfToFloat, FloatToHalf>(dst, src, count, op);
      return;
    case DataType::BFLOAT16:
      HalfReduce<BF16ToFloat, FloatToBF16>(dst, src, count, op);
      return;
    case DataType::BOOL: {
      uint8_t* d = static_cast<uint8_t*>(dst);
      const uint8_t* s = static_cast<const uint8_t*>(src);
      // sum/max = logical or; min/prod = logical and.
      bool lor = op == ReduceOp::SUM || op == ReduceOp::MAX;
      for (int64_t i = 0; i < count; ++i) {
        d[i] = lor ? (d[i] || s[i]) : (d[i] && s[i]);
      }
      return;
    }
  }
}

// ---------------------------------------------------------------------------
// Wire-compression kernels (quantize / dequantize / block reduce)
// ---------------------------------------------------------------------------

// fp8 e4m3 (1/4/3, bias 7, saturating "fn" variant: no infinity, 0x7f =
// NaN, max finite 448).  Encode is RNE like every other wire conversion;
// decode goes through a 256-entry table built once (the dequant hot loop
// is a single gather).
static inline uint8_t FloatToFp8E4M3(float v) {
  uint32_t f;
  memcpy(&f, &v, 4);
  uint32_t sign = (f >> 24) & 0x80u;
  uint32_t absf = f & 0x7fffffffu;
  if (absf >= 0x7f800000u) return static_cast<uint8_t>(sign | 0x7fu);  // NaN/inf
  // Saturate finite overflow to the max finite (448), e4m3fn-style.
  // 0x43e00000 = 448.0f; values that ROUND past 448 saturate too — the
  // RNE step below cannot exceed 0x7e after this clamp.
  float av;
  memcpy(&av, &absf, 4);
  if (av > 448.0f) return static_cast<uint8_t>(sign | 0x7eu);
  int32_t exp = static_cast<int32_t>(absf >> 23) - 127 + 7;
  uint32_t man = absf & 0x7fffffu;
  if (exp <= 0) {
    // Subnormal target: smallest normal is 2^-6, subnormal lsb 2^-9.
    if (exp < -3) return static_cast<uint8_t>(sign);  // underflows to 0
    man |= 0x800000u;
    uint32_t shift = static_cast<uint32_t>(21 - exp);  // man>>shift -> 3 bits
    uint32_t q = man >> shift;
    uint32_t halfbit = 1u << (shift - 1);
    uint32_t rem = man & ((1u << shift) - 1u);
    if (rem > halfbit || (rem == halfbit && (q & 1u))) q += 1;
    return static_cast<uint8_t>(sign | q);
  }
  uint32_t q = (static_cast<uint32_t>(exp) << 3) | (man >> 20);
  uint32_t rem = man & 0xfffffu;
  if (rem > 0x80000u || (rem == 0x80000u && (q & 1u))) q += 1;
  if (q >= 0x7fu) q = 0x7eu;  // rounded past the top: saturate, not NaN
  return static_cast<uint8_t>(sign | q);
}

static inline float Fp8E4M3ToFloatScalar(uint8_t b) {
  uint32_t sign = (b & 0x80u) ? 0x80000000u : 0;
  uint32_t exp = (b >> 3) & 0xfu;
  uint32_t man = b & 0x7u;
  uint32_t f;
  if (exp == 0) {
    if (man == 0) {
      f = sign;
    } else {
      int e = 127 - 7 + 1;
      while ((man & 0x8u) == 0) {
        man <<= 1;
        e--;
      }
      f = sign | (static_cast<uint32_t>(e) << 23) | ((man & 0x7u) << 20);
    }
  } else if (exp == 0xfu && man == 0x7u) {
    f = sign | 0x7fc00000u;  // NaN
  } else {
    f = sign | ((exp - 7 + 127) << 23) | (man << 20);
  }
  float out;
  memcpy(&out, &f, 4);
  return out;
}

static const float* Fp8DecodeTable() {
  static const float* table = [] {
    float* t = new float[256];
    for (int i = 0; i < 256; ++i) {
      t[i] = Fp8E4M3ToFloatScalar(static_cast<uint8_t>(i));
    }
    return t;
  }();
  return table;
}

// Round-to-nearest-even float -> int8 in [-127, 127] (the symmetric
// range; -128 unused so negation is exact).  rintf honors the current FP
// rounding mode — FE_TONEAREST (RNE) per C default, matching every other
// wire conversion in this file.  Saturating comparisons first, NaN
// check last: casting a NaN or out-of-range float to int8 is UB, and a
// non-finite block already routed through the NaN-scale path below.
static inline int8_t QuantizeI8(float x) {
  float r = rintf(x);
  if (r >= 127.f) return 127;
  if (r <= -127.f) return -127;
  if (!(r == r)) return 0;  // NaN element: the block scale carries it
  return static_cast<int8_t>(r);
}

// One quantized block: [fp32 scale][block_elems codes], scale chosen so
// the block's max |value| maps to the top code (127 / 448).  An all-zero
// block carries scale 0 and zero codes.  A block containing ANY
// non-finite element (a mixed-precision overflow step) carries a NaN
// scale and zero codes: dequantization turns the whole block into NaNs,
// so the overflow PROPAGATES to every rank — block-granular, like fp16
// overflow — instead of silently zeroing the gradient out from under a
// GradScaler-style detector (and instead of the UB a NaN→int8 cast
// would be).
static void QuantizeBlock(const float* src, int64_t n, hvd::WireDtype wire,
                          uint8_t* dst, int64_t block_elems) {
  float maxabs = 0.f;
  bool finite = true;
  for (int64_t i = 0; i < n; ++i) {
    float a = fabsf(src[i]);
    finite = finite && std::isfinite(a);
    if (a > maxabs) maxabs = a;  // NaN compares false: `finite` covers it
  }
  const float top = wire == hvd::WireDtype::FP8 ? 448.f : 127.f;
  float scale = maxabs > 0.f ? maxabs / top : 0.f;
  if (!finite) scale = std::numeric_limits<float>::quiet_NaN();
  float inv = scale > 0.f ? 1.f / scale : 0.f;
  if (!std::isfinite(inv)) {
    // A subnormal-magnitude block (max|value| ~< 1e-36): 1/scale
    // overflows to inf, which would NaN-poison finite input through
    // 0*inf.  Values this small are below every wire format's
    // resolution anyway — flush the block to exact zero (scale 0).
    scale = 0.f;
    inv = 0.f;
  }
  memcpy(dst, &scale, 4);
  uint8_t* q = dst + 4;
  if (!finite || inv == 0.f) {
    for (int64_t i = 0; i < block_elems; ++i) q[i] = 0;
    return;
  }
  if (wire == hvd::WireDtype::FP8) {
    for (int64_t i = 0; i < n; ++i) q[i] = FloatToFp8E4M3(src[i] * inv);
  } else {
    for (int64_t i = 0; i < n; ++i) {
      q[i] = static_cast<uint8_t>(QuantizeI8(src[i] * inv));
    }
  }
  // Zero-pad the tail of a partial last block: padding dequantizes to
  // exactly 0 and can never move the block scale of any peer.
  for (int64_t i = n; i < block_elems; ++i) q[i] = 0;
}

static void DequantizeBlock(const uint8_t* src, int64_t n,
                            hvd::WireDtype wire, float* dst) {
  float scale;
  memcpy(&scale, src, 4);
  const uint8_t* q = src + 4;
  if (wire == hvd::WireDtype::FP8) {
    const float* table = Fp8DecodeTable();
    for (int64_t i = 0; i < n; ++i) dst[i] = table[q[i]] * scale;
  } else {
    const int8_t* s = reinterpret_cast<const int8_t*>(q);
    for (int64_t i = 0; i < n; ++i) dst[i] = static_cast<float>(s[i]) * scale;
  }
}

// ---------------------------------------------------------------------------
// Data-plane thread pool
// ---------------------------------------------------------------------------

void DataPool::Start(int nthreads) {
  Stop();
  {
    std::lock_guard<std::mutex> lk(mu_);
    stop_ = false;
  }
  for (int i = 0; i < nthreads; ++i) {
    threads_.emplace_back(&DataPool::Loop, this);
  }
}

void DataPool::Stop() {
  {
    std::lock_guard<std::mutex> lk(mu_);
    stop_ = true;
  }
  cv_.notify_all();
  for (auto& t : threads_) t.join();
  threads_.clear();
  std::lock_guard<std::mutex> lk(mu_);
  q_.clear();
  idle_ = 0;
}

void DataPool::Submit(std::function<void()> fn) {
  {
    std::lock_guard<std::mutex> lk(mu_);
    q_.push_back(std::move(fn));
  }
  cv_.notify_one();
}

bool DataPool::TrySubmitIfIdle(std::function<void()> fn) {
  {
    std::lock_guard<std::mutex> lk(mu_);
    if (idle_ - static_cast<int>(q_.size()) <= 0) return false;
    q_.push_back(std::move(fn));
  }
  cv_.notify_one();
  return true;
}

void DataPool::Loop() {
  std::unique_lock<std::mutex> lk(mu_);
  while (true) {
    ++idle_;
    cv_.wait(lk, [&] { return stop_ || !q_.empty(); });
    --idle_;
    if (q_.empty()) {
      if (stop_) return;
      continue;
    }
    auto fn = std::move(q_.front());
    q_.pop_front();
    lk.unlock();
    fn();
    lk.lock();
  }
}

// ---------------------------------------------------------------------------
// Engine lifecycle
// ---------------------------------------------------------------------------

Engine& Engine::Get() {
  static Engine* engine = new Engine();
  return *engine;
}

static int64_t EnvInt64(const char* name, int64_t dflt) {
  const char* v = std::getenv(name);
  if (v == nullptr || v[0] == '\0') return dflt;
  return std::strtoll(v, nullptr, 10);
}

// Magic status prefix the Python layer maps to its StepSkipped
// exception (like __sparse_retry__): a clean per-step outcome, not an
// engine abort — the world stays healthy and the next enqueue works.
static const char kSkippedStepError[] =
    "__skipped_step__: a backup-worker partial commit "
    "(HOROVOD_BACKUP_WORKERS) left this rank out of this step's "
    "reduction — skip the local update or re-sync, then continue";

// Identity used for co-location grouping at rendezvous.  HOROVOD_HOST_KEY
// overrides (tests fake multi-host topologies on one box with it);
// otherwise hostname#boot-id — the boot id disambiguates containers that
// share a hostname but not a kernel (where shm would silently not be
// shared).
static std::string HostKey() {
  const char* k = std::getenv("HOROVOD_HOST_KEY");
  if (k != nullptr && k[0] != '\0') return k;
  char host[256] = {0};
  ::gethostname(host, sizeof(host) - 1);
  std::string key(host);
  if (FILE* f = std::fopen("/proc/sys/kernel/random/boot_id", "r")) {
    char b[64] = {0};
    if (std::fgets(b, sizeof(b), f) != nullptr) {
      for (char* p = b; *p; ++p) {
        if (*p == '\n' || *p == '\r') *p = '\0';
      }
      key += "#";
      key += b;
    }
    std::fclose(f);
  }
  return key;
}

// Derive this rank's group view (node id, members, leaders) from the
// committed rank_host_ table — identical on every rank, so the shm edge
// names and the two-level message pattern agree across the world.
void Engine::AdoptTopology() {
  const int n = size_;
  if (static_cast<int>(rank_host_.size()) != n) rank_host_.assign(n, 0);
  nnodes_ = 1;
  for (auto g : rank_host_) nnodes_ = std::max(nnodes_, g + 1);
  node_id_ = rank_host_[rank_];
  group_members_.clear();
  group_leaders_.assign(nnodes_, -1);
  for (int r = 0; r < n; ++r) {
    if (group_leaders_[rank_host_[r]] < 0) group_leaders_[rank_host_[r]] = r;
    if (rank_host_[r] == node_id_) group_members_.push_back(r);
  }
  group_size_ = static_cast<int>(group_members_.size());
  local_index_ = 0;
  for (int i = 0; i < group_size_; ++i) {
    if (group_members_[i] == rank_) local_index_ = i;
  }
}

int Engine::Init(int rank, int size, int local_rank, int local_size,
                 const std::string& coordinator_addr) {
  if (initialized_.load()) return 0;
  rank_ = rank;
  size_ = size;
  local_rank_ = local_rank;
  local_size_ = local_size;
  // The launch identity is the persistent worker id and the job's full
  // world size; an elastic rendezvous commit may assign a different
  // (contiguous) rank_ and a smaller/restored size_ below.
  worker_id_ = rank;
  world_size_ = size;
  shut_down_.store(false);
  shutdown_requested_.store(false);

  // Knobs (reference operations.cc:1556-1618).
  cycle_time_ms_.store(
      std::max(1, static_cast<int>(EnvInt64("HOROVOD_CYCLE_TIME", 5))));
  cache_capacity_ = EnvInt64("HOROVOD_CACHE_CAPACITY", 1024);
  if (cache_capacity_ < 0) cache_capacity_ = 0;
  // Slot ids must stay under the wire format's bitvector bound
  // (ParseSlotBitvector rejects nbits > 1<<20 as a corrupt frame).
  if (cache_capacity_ > (1 << 20)) cache_capacity_ = 1 << 20;
  cache_enabled_ = cache_capacity_ > 0 && size_ > 1;
  // An elastic re-Init (shutdown + init in the same process) must start
  // with an empty cache on every rank: the new world's coordinator
  // assigns slots from scratch, and a replayed stale slot id would
  // execute the wrong response.  Teardown also clears (belt + braces).
  ClearCacheState();
  fusion_threshold_.store(
      EnvInt64("HOROVOD_FUSION_THRESHOLD", 64 * 1024 * 1024));
  // Data-plane fan-out: HOROVOD_NUM_CHANNELS independent socket pairs per
  // ring edge (1 restores the single-socket path; default auto from the
  // core count — parallel channels need cores to drive them, and past ~4
  // the per-message overhead outweighs the loopback/NIC parallelism).
  // The value used is the COORDINATOR's, committed at rendezvous, so a
  // heterogeneous env cannot wire mismatched fan-outs.
  num_channels_ = static_cast<int>(EnvInt64("HOROVOD_NUM_CHANNELS", 0));
  if (num_channels_ <= 0) {
    unsigned hc = std::thread::hardware_concurrency();
    num_channels_ = std::min(4, std::max(1, static_cast<int>(hc)));
  }
  if (num_channels_ > 16) num_channels_ = 16;
  // Concurrent-response wave width: default = the channel fan-out
  // (exactly the pre-autotune behavior); the coordinator's resolved
  // value is committed at rendezvous next to the channel count so wave
  // grouping agrees across ranks, and TUNE frames may retune it live.
  {
    int wave = static_cast<int>(EnvInt64("HOROVOD_WAVE_WIDTH", 0));
    if (wave <= 0) wave = num_channels_;
    wave_width_.store(std::min(16, std::max(1, wave)));
  }
  socket_buf_bytes_ =
      static_cast<int>(EnvInt64("HOROVOD_SOCKET_BUF_BYTES", 0));
  {
    int64_t chunk = EnvInt64("HOROVOD_CHUNK_BYTES", 1 << 20);
    if (chunk < 4096) chunk = 4096;
    chunk_bytes_.store(chunk & ~int64_t{7});  // 8-aligned for every dtype
  }
  // Size-based algorithm selection: payloads at or under the threshold
  // take the latency star path when shm star edges exist (0 disables; the
  // coordinator's committed value is broadcast at rendezvous so every
  // rank picks the same wire pattern, and TUNE frames retune it live).
  {
    int64_t at = EnvInt64("HOROVOD_ALGO_THRESHOLD", 32 << 10);
    algo_threshold_.store(at < 0 ? 0 : at);
  }
  // Default wire format for fp32 allreduce payloads
  // (HOROVOD_WIRE_DTYPE=fp32|fp16|bf16|int8|fp8; fp32 is byte-identical
  // to the pre-compression engine and stays the default contract).
  {
    const char* w = std::getenv("HOROVOD_WIRE_DTYPE");
    int wv = 0;
    if (w != nullptr && w[0] != '\0') {
      if (std::strcmp(w, "fp32") == 0 || std::strcmp(w, "float32") == 0) {
        wv = 0;
      } else if (std::strcmp(w, "fp16") == 0 ||
                 std::strcmp(w, "float16") == 0) {
        wv = 1;
      } else if (std::strcmp(w, "bf16") == 0 ||
                 std::strcmp(w, "bfloat16") == 0) {
        wv = 2;
      } else if (std::strcmp(w, "int8") == 0) {
        wv = 3;
      } else if (std::strcmp(w, "fp8") == 0 ||
                 std::strcmp(w, "fp8e4m3") == 0) {
        wv = 4;
      } else {
        std::fprintf(stderr,
                     "horovod_tpu: unknown HOROVOD_WIRE_DTYPE '%s' (want "
                     "fp32|fp16|bf16|int8|fp8); using fp32\n", w);
      }
    }
    wire_dtype_.store(wv);
  }
  // Priority scheduling: HOROVOD_PRIORITY_BANDS is the band WIDTH
  // (band = priority / width; 0 = off — bit-identical legacy arrival
  // ordering).  The coordinator's resolution is committed at rendezvous
  // like the channel count: response ORDER is part of the wire pattern
  // (waves pair responses with channels by list index), so every rank
  // must band identically.  Live-tunable thereafter (knob #7).
  {
    int64_t pb = EnvInt64("HOROVOD_PRIORITY_BANDS", 0);
    if (pb < 0) pb = 0;
    if (pb > (1 << 20)) pb = 1 << 20;
    priority_bands_.store(pb);
  }
  // Per-band fusion-threshold ladder (autotuner-learned bucket sizes):
  // HOROVOD_FUSION_LADDER="t0,t1,..." — band b fuses up to ladder[b]
  // bytes (missing/zero entries fall back to HOROVOD_FUSION_THRESHOLD;
  // bands past the last slot share it).
  for (int b = 0; b < kFusionLadderMax; ++b) fusion_ladder_[b].store(0);
  if (const char* lad = std::getenv("HOROVOD_FUSION_LADDER");
      lad != nullptr && lad[0] != '\0') {
    std::string all(lad);
    int b = 0;
    for (size_t start = 0; start < all.size() && b < kFusionLadderMax;
         ++b) {
      size_t end = all.find(',', start);
      if (end == std::string::npos) end = all.size();
      char* endp = nullptr;
      long long v = std::strtoll(all.c_str() + start, &endp, 10);
      if (endp != nullptr && v > 0) fusion_ladder_[b].store(v);
      start = end + 1;
    }
  }
  shm_ring_bytes_ = EnvInt64("HOROVOD_SHM_RING_BYTES", 2 << 20);
  if (shm_ring_bytes_ < (1 << 16)) shm_ring_bytes_ = 1 << 16;
  // Straggler tolerance: over-provision k backup workers — the
  // coordinator commits a SUM allreduce once nvoters-k voters are ready
  // (after the grace window) instead of waiting for the whole world.
  // The coordinator's resolution is committed at rendezvous (workers
  // adopt it below, like the channel count); 0 = fully synchronous.
  {
    // HOROVOD_BACKUP_WORKERS=auto: start fully synchronous (k=0) and
    // let the coordinator arm k=1 only while its step-time window ratio
    // p99/p50 exceeds HOROVOD_BACKUP_AUTO_RATIO (default 3.0) — the
    // same percentile instrument the straggler gate judges with.
    const char* braw = std::getenv("HOROVOD_BACKUP_WORKERS");
    backup_auto_ = braw != nullptr && std::string(braw) == "auto";
    backup_armed_.store(false);
    backup_workers_ = backup_auto_
        ? 0
        : static_cast<int>(EnvInt64("HOROVOD_BACKUP_WORKERS", 0));
    if (backup_workers_ < 0) backup_workers_ = 0;
    backup_auto_ratio_ = 3.0;
    const char* rraw = std::getenv("HOROVOD_BACKUP_AUTO_RATIO");
    if (rraw != nullptr && *rraw != '\0') {
      char* end = nullptr;
      double v = std::strtod(rraw, &end);
      if (end != rraw && v > 1.0) backup_auto_ratio_ = v;
    }
  }
  backup_grace_ms_ =
      static_cast<int>(EnvInt64("HOROVOD_BACKUP_GRACE_MS", 50));
  if (backup_grace_ms_ < 0) backup_grace_ms_ = 0;
  // HOROVOD_BACKUP_AUTO_RULE: which instrument arms backup=auto —
  // "quorum" (default: per-entry quorum-lag percentiles, sees every
  // rank including a straggling coordinator) or "steptime" (the PR 12
  // rule on rank 0's own completion-latency window, kept for
  // comparability).
  backup_auto_rule_ = 0;
  if (const char* rule = std::getenv("HOROVOD_BACKUP_AUTO_RULE");
      rule != nullptr && std::strcmp(rule, "steptime") == 0) {
    backup_auto_rule_ = 1;
  }
  // Fleet telemetry cadence: every N negotiation cycles each rank
  // piggybacks counter deltas on its control frame (0 disables —
  // provably zero wire bytes: the TELEM section is simply absent).
  telemetry_cycles_ = EnvInt64("HOROVOD_TELEMETRY_CYCLES", 50);
  if (telemetry_cycles_ < 0) telemetry_cycles_ = 0;
  // A new incarnation starts a fresh fleet table (re-ranked rows from a
  // dead world would mix identities); telem_last_ deliberately SURVIVES
  // so counter deltas stay exact across the re-init.
  {
    std::lock_guard<std::mutex> lk(fleet_mu_);
    fleet_rows_.clear();
    quorum_attr_.clear();
  }
  {
    std::lock_guard<std::mutex> lk(quorum_mu_);
    quorum_lag_samples_.clear();
    quorum_lag_next_ = 0;
  }
  stall_last_warned_.clear();
  // A dead incarnation's banked skip tokens are meaningless in the new
  // world (fresh epoch, fresh commits).
  skip_tokens_.clear();
  // HOROVOD_SHM_DISABLE=1: escape hatch back to the pure-TCP data plane
  // (bit-identical — transport never changes values).  The coordinator's
  // resolution (env AND a runtime /dev/shm probe) is committed at
  // rendezvous; this env read only seeds the single-rank/world-of-one
  // value.
  shm_enabled_ = EnvInt64("HOROVOD_SHM_DISABLE", 0) == 0;
  two_level_ = false;
  shm_ring_active_ = false;
  rank_host_.clear();
  // Hierarchical coordination: the coordinator's env resolution is
  // committed in the ASSIGN frame (rendezvous sets this); refined after
  // AdoptTopology — it only activates on a >1-group topology.
  hier_coord_ = false;
  // A previous incarnation's unshipped TUNE proposal must not leak into
  // the new world (tune_trials_ stays process-cumulative like every
  // other counter).
  {
    std::lock_guard<std::mutex> lk(tune_mu_);
    tune_pending_.store(false);
  }
  channel_drivers_ =
      static_cast<int>(EnvInt64("HOROVOD_CHANNEL_DRIVERS", 0));
  if (channel_drivers_ <= 0) {
    // One driver per core: drivers mostly block in poll, so matching the
    // core count keeps every core fed without the thrash of a
    // thread-per-channel (measured on the 2-core CI box: 4 channels on
    // 2 drivers beat both 1 driver and 4).
    unsigned hc = std::thread::hardware_concurrency();
    channel_drivers_ = std::max(1, static_cast<int>(hc));
  }
  if (channel_drivers_ > 16) channel_drivers_ = 16;
  stall_check_disabled_ = EnvInt64("HOROVOD_STALL_CHECK_DISABLE", 0) != 0;
  stall_warning_sec_ =
      static_cast<int>(EnvInt64("HOROVOD_STALL_WARNING_SEC", 60));
  socket_timeout_sec_ =
      static_cast<int>(EnvInt64("HOROVOD_SOCKET_TIMEOUT_SEC", 120));
  // Link self-healing: bounded in-place reconnect of a failed data-channel
  // socket before the expensive abort/elastic machinery fires.  0 retries
  // = off (bit-for-bit the pre-heal engine).  The coordinator's resolution
  // is committed at rendezvous (workers adopt it below, like the channel
  // count).
  link_retries_ = static_cast<int>(EnvInt64("HOROVOD_LINK_RETRIES", 3));
  if (link_retries_ < 0) link_retries_ = 0;
  if (link_retries_ > 1000) link_retries_ = 1000;
  link_heal_timeout_ms_ = EnvInt64("HOROVOD_LINK_HEAL_TIMEOUT_MS", 10000);
  if (link_heal_timeout_ms_ < 1) link_heal_timeout_ms_ = 1;
  // Bound on control-plane patience for a live-but-wedged peer.  The old
  // allowance scaled as (size+4) x socket timeout (~2.3 h at 64 ranks x
  // 120 s before the descriptive abort); HOROVOD_CONTROL_PATIENCE_SEC
  // caps it.  The default keeps a mild size-aware floor because a cycle's
  // collective execution time genuinely grows with world size (a 64 MB
  // ring is size-1 hops) — 30 s/rank ~= 32 min at 64 ranks, vs hours
  // before.  Dead peers still fail fast via EOF/keepalive.
  int control_patience_sec = static_cast<int>(EnvInt64(
      "HOROVOD_CONTROL_PATIENCE_SEC",
      std::max<int64_t>(600, static_cast<int64_t>(size_) * 30)));
  // HOROVOD_FAULT_TIMEOUT_SEC: a hard failure-detection bound.  A hung
  // (not just dead) peer is only detectable by the absence of progress, so
  // cap BOTH progress bounds — the per-transfer socket timeout and the
  // control-plane patience — at a THIRD of the fault timeout: the
  // coordinator burns its patience detecting the culprit (1 round =
  // fault/3), and a worker's longer wait (2x+1 = 3 rounds, see
  // worker_patience_rounds_) still totals <= the fault timeout even in
  // the worst case where the COORDINATOR is the hung rank and no abort
  // broadcast is coming.
  // Elastic in-place membership: HOROVOD_ELASTIC=1 lets a re-init after
  // an abort commit a new world around the survivors (plus any candidates
  // that show up within the grow window) instead of requiring every
  // original rank back.
  elastic_enabled_ = EnvInt64("HOROVOD_ELASTIC", 0) != 0;
  min_size_ = static_cast<int>(EnvInt64("HOROVOD_ELASTIC_MIN_SIZE", 1));
  if (min_size_ < 1) min_size_ = 1;
  grow_timeout_sec_ =
      static_cast<int>(EnvInt64("HOROVOD_ELASTIC_GROW_TIMEOUT_SEC", 30));
  if (grow_timeout_sec_ < 1) grow_timeout_sec_ = 1;
  rendezvous_timeout_sec_ =
      static_cast<int>(EnvInt64("HOROVOD_RENDEZVOUS_TIMEOUT_SEC", 120));
  if (rendezvous_timeout_sec_ < 5) rendezvous_timeout_sec_ = 5;
  fault_timeout_sec_ =
      static_cast<int>(EnvInt64("HOROVOD_FAULT_TIMEOUT_SEC", 0));
  if (fault_timeout_sec_ > 0) {
    int third = std::max(1, fault_timeout_sec_ / 3);
    if (socket_timeout_sec_ <= 0 || socket_timeout_sec_ > third) {
      socket_timeout_sec_ = third;
    }
    control_patience_sec = std::min(control_patience_sec, third);
  }
  // Healing must finish strictly inside every OTHER rank's no-progress
  // patience: healthy ranks downstream of a healing edge stall on their
  // own cascade steps, and a heal budget past their socket timeout would
  // convert a healable blip into their "link: no progress" abort.  The
  // fault bound (when set) already capped socket_timeout_sec_ above, so
  // this single cap also keeps heal-then-escalate inside the coordinator's
  // fault-timeout verdict window.
  if (socket_timeout_sec_ > 0) {
    link_heal_timeout_ms_ = std::min<int64_t>(
        link_heal_timeout_ms_,
        static_cast<int64_t>(socket_timeout_sec_) * 1000 * 3 / 4);
    if (link_heal_timeout_ms_ < 1) link_heal_timeout_ms_ = 1;
  }
  control_patience_rounds_ =
      socket_timeout_sec_ > 0
          ? std::max(1, control_patience_sec / socket_timeout_sec_)
          : 0;  // timeout disabled: blocking reads, rounds never consulted
  // Workers out-wait the coordinator (see engine.h) so the abort verdict
  // naming the culprit wins the race against their own generic timeout.
  worker_patience_rounds_ =
      control_patience_rounds_ > 0 ? control_patience_rounds_ * 2 + 1 : 0;
  abort_reason_.clear();

  // Deterministic fault injection for the multiproc fault tests:
  // HOROVOD_FAULT_INJECT=rank:step:kind (kinds exit|hang|drop-conn).
  // One-shot per PROCESS (fault_fired_ survives re-Init): an elastic
  // recovery re-initializes the engine in the same process with the env
  // var still set, and must not re-fire the fault on every incarnation.
  fault_kind_ = FaultKind::NONE;
  fault_step_ = -1;
  enqueue_count_.store(0);
  fault_hang_.store(false);
  fault_drop_.store(false);
  fault_stale_epoch_.store(false);
  fault_conn_reset_.store(false);
  fault_stall_ms_.store(0);
  fault_reset_period_ = 1;
  fault_reset_prev_ = false;
  fault_stall_len_ms_ = 200;
  if (const char* spec = std::getenv("HOROVOD_FAULT_INJECT");
      !fault_fired_ && spec != nullptr && spec[0] != '\0') {
    // Comma-separated schedule (chaos tests inject on several ranks in
    // one job): each process arms the first entry matching its PERSISTENT
    // worker id — stable across elastic re-ranking, identical to rank in
    // a fixed world.
    std::string all(spec);
    for (size_t start = 0; start < all.size();) {
      size_t end = all.find(',', start);
      if (end == std::string::npos) end = all.size();
      std::string tok = all.substr(start, end - start);
      start = end + 1;
      // rank:step:kind[:arg] — split on ':' by hand: step may be '*'
      // (every enqueue; meaningful for `slow`) and `slow` carries a
      // 4th field (the delay in ms), neither of which sscanf's
      // %d:%lld:%s handles.
      std::vector<std::string> fields;
      for (size_t p0 = 0; p0 <= tok.size();) {
        size_t c = tok.find(':', p0);
        if (c == std::string::npos) {
          fields.push_back(tok.substr(p0));
          break;
        }
        fields.push_back(tok.substr(p0, c - p0));
        p0 = c + 1;
      }
      if (fields.size() < 3 || fields[0].empty() || fields[1].empty()) {
        continue;
      }
      // Strictly numeric rank/step fields (end-pointer checked): a
      // typo'd token must be IGNORED, not atoi'd to 0 — which would arm
      // the fault on rank 0 and kill the coordinator.
      char* endp = nullptr;
      long frank = std::strtol(fields[0].c_str(), &endp, 10);
      if (endp == nullptr || *endp != '\0') continue;
      if (frank != worker_id_) continue;
      long long fstep = -2;
      if (fields[1] != "*") {
        fstep = std::strtoll(fields[1].c_str(), &endp, 10);
        if (endp == nullptr || *endp != '\0' || fstep < 0) continue;
      }
      const std::string& fkind = fields[2];
      fault_step_ = fstep;
      if (fkind == "exit") {
        fault_kind_ = FaultKind::EXIT;
      } else if (fkind == "hang") {
        fault_kind_ = FaultKind::HANG;
      } else if (fkind == "drop-conn") {
        fault_kind_ = FaultKind::DROP_CONN;
      } else if (fkind == "stale-epoch") {
        fault_kind_ = FaultKind::STALE_EPOCH;
      } else if (fkind == "slow") {
        // rank:step:slow:ms — a deterministic per-step enqueue delay:
        // the API thread sleeps before the enqueue while the background
        // loop keeps heartbeating, i.e. a straggler, not a wedge.
        fault_kind_ = FaultKind::SLOW;
        fault_slow_ms_ = fields.size() > 3
            ? std::strtoll(fields[3].c_str(), nullptr, 10) : 100;
        if (fault_slow_ms_ < 0) fault_slow_ms_ = 0;
      } else if (fkind == "conn-reset") {
        // rank:step:conn-reset[:K][:prev] — this rank shutdown(2)s one of
        // its OWN data-channel sockets mid-cascade (the link-heal driver
        // fault).  Optional numeric field = re-arm period for step '*'
        // (a flap schedule); optional 'prev' shoots the recv-side socket,
        // which discards buffered inbound bytes — the lost-data case.
        fault_kind_ = FaultKind::CONN_RESET;
        for (size_t fi = 3; fi < fields.size(); ++fi) {
          if (fields[fi] == "prev") {
            fault_reset_prev_ = true;
          } else if (!fields[fi].empty()) {
            long long period =
                std::strtoll(fields[fi].c_str(), &endp, 10);
            if (endp != nullptr && *endp == '\0' && period > 0) {
              fault_reset_period_ = period;
            }
          }
        }
      } else if (fkind == "ckpt-kill") {
        // rank:step:ckpt-kill — Python-owned: the checkpoint writer
        // parses the shared schedule itself and SIGKILLs mid-shard-write
        // (the kill must land between the tmp file's two half-writes,
        // which only the writer can time).  Accept the kind silently so
        // the shared parser does not warn, and keep scanning for an
        // engine-side kind on this rank.
        fault_step_ = -1;
        fault_kind_ = FaultKind::NONE;
        continue;
      } else if (fkind == "recv-stall") {
        // rank:step:recv-stall:ms — the next cascade on this rank stops
        // draining one channel for ms (a transient stall, not a dead
        // link): the collective must complete with zero aborts AND zero
        // reconnects — healing classifies, waits, and stands down.
        fault_kind_ = FaultKind::RECV_STALL;
        fault_stall_len_ms_ = fields.size() > 3
            ? std::strtoll(fields[3].c_str(), nullptr, 10) : 200;
        if (fault_stall_len_ms_ < 1) fault_stall_len_ms_ = 1;
      } else {
        std::fprintf(stderr,
                     "horovod_tpu: unknown HOROVOD_FAULT_INJECT kind '%s' "
                     "(want exit|hang|drop-conn|stale-epoch|slow|"
                     "conn-reset|recv-stall|ckpt-kill); ignored\n",
                     fkind.c_str());
        fault_step_ = -1;
        fault_kind_ = FaultKind::NONE;
        continue;
      }
      break;
    }
  }
  if (size_ > 1) {
    std::string host = "127.0.0.1";
    int port = 0;
    auto colon = coordinator_addr.rfind(':');
    if (colon != std::string::npos) {
      host = coordinator_addr.substr(0, colon);
      port = std::atoi(coordinator_addr.c_str() + colon + 1);
    }
    if (port == 0) {
      last_error_ = "coordinator address host:port required for size > 1";
      return 1;
    }
    // Job tag for shm segment names: the coordinator port is unique per
    // live job on a host, and every name is additionally epoch-stamped.
    shm_prefix_ = "hvd" + std::to_string(port) + "_";
    std::string err;
    const char* my_host_env = std::getenv("HOROVOD_HOST");
    std::string my_host = my_host_env ? my_host_env : "127.0.0.1";

    // Every rank opens an ephemeral data listener for ring neighbors.
    // Backlog covers the MAXIMUM channel fan-out (16) arriving at once
    // during wiring — the committed count is only known after
    // rendezvous, and the coordinator's may exceed this rank's env
    // value (overflowed connects retry, but the backlog avoids the
    // retry latency on the common path).
    int data_port = 0;
    data_listener_ = Listen("0.0.0.0", 0, 16 + 8, &data_port, &err);
    if (!data_listener_.valid()) {
      last_error_ = "data listener: " + err;
      return 1;
    }

    // Rendezvous: workers report (worker id, host, data_port) to the
    // coordinator, which commits a membership epoch and broadcasts
    // (epoch, assigned rank, size, peer table) — the moral equivalent of
    // MPI_Init's wire-up or NCCL's ncclUniqueId broadcast (reference
    // operations.cc:894-931), extended with elastic re-formation around
    // survivors (HOROVOD_ELASTIC=1).
    std::vector<std::string> peer_hosts;
    std::vector<int> peer_ports;
    int rdv = rank_ == 0
        ? CoordinatorRendezvous(host, port, my_host, data_port,
                                &peer_hosts, &peer_ports)
        : WorkerRendezvous(host, port, my_host, data_port,
                           &peer_hosts, &peer_ports);
    if (rdv != 0) return rdv;
    // rank_/size_/epoch_ now reflect the COMMITTED world, which on an
    // elastic re-init may be smaller than the env identity.  A world
    // shrunk to one keeps its control listener open (a later candidate
    // triggers a grow re-rendezvous) but wires no rings.
    // Derive the topology view from the committed grouping: identical on
    // every rank (the table was broadcast), so leader tables, shm edge
    // names and the two-level message pattern agree across the world.
    AdoptTopology();
    // Two-level collectives need BOTH a multi-group world and at least
    // one group worth decomposing; shm must be committed because the
    // intra-group phases run over shm edges.  Everything else (single
    // host, one-rank-per-host, shm off) is a flat ring — over shm when
    // the whole world is one group and shm is on, over TCP otherwise.
    two_level_ = shm_enabled_ && nnodes_ > 1 && size_ > nnodes_;
    // Control-plane hierarchy activates on any committed >1-group
    // topology with at least one multi-member group — independent of
    // shm: the member ↔ leader control conns are plain TCP, so a
    // synthetic host grouping (HOROVOD_HOST_KEY) scales the control
    // plane even where the data plane fell back to the flat ring.
    hier_coord_ = hier_coord_ && nnodes_ > 1 && size_ > nnodes_;
    if (!shm_enabled_ && nnodes_ > 1 && size_ > nnodes_ && rank_ == 0) {
      // A hierarchical topology exists but the intra-group phases cannot
      // run (shm off or unavailable on some host), so every rank joins
      // the flat cross-network ring.  Loud, because the bandwidth cost
      // is size_/nnodes_ extra ring participants per real link.
      std::fprintf(stderr,
                   "horovod_tpu: %d hosts x %d ranks committed but shared "
                   "memory is %s — collectives fall back to the flat "
                   "world-wide TCP ring (no per-host leaders).\n",
                   nnodes_, size_ / nnodes_,
                   EnvInt64("HOROVOD_SHM_DISABLE", 0) != 0
                       ? "disabled (HOROVOD_SHM_DISABLE=1)"
                       : "unavailable on at least one host");
    }
    if (size_ > 1) {
    // Ring wiring.  Each directed ring edge is its own TCP connection —
    // the GLOBAL ring opens num_channels_ independent connections per
    // edge (the data-plane fan-out; each channel later carries its own
    // shard of a collective) — opened by the edge's source, identified
    // by an (origin rank, ring id, channel, epoch) handshake.  The epoch
    // stamp makes elastic re-rendezvous airtight per channel: a stale
    // connect from a dead incarnation is dropped instead of stealing a
    // channel slot in the new world's wiring.  Connect cannot deadlock:
    // every listener already exists, so connects complete from the
    // backlog even before the peer accepts.
    struct Edge {
      int peer;
      int32_t ring;
      int32_t channel;
      Socket* slot;
    };
    ring_next_.clear();
    ring_prev_.clear();
    ring_next_.resize(num_channels_);
    ring_prev_.resize(num_channels_);
    cross_next_.clear();
    cross_prev_.clear();
    // Link self-healing plumbing: the committed peer table outlives
    // wiring (mid-run reconnect targets), the cascade stream sequences
    // restart per incarnation (a RESUME carries the epoch, so stale
    // sequences can't collide), and a dead incarnation's parked resumes
    // are dropped.
    peer_hosts_ = peer_hosts;
    peer_ports_ = peer_ports;
    link_seq_global_.assign(num_channels_, 0);
    link_seq_cross_.assign(num_channels_, 0);
    HealInboxClear();
    std::vector<Edge> outgoing, incoming;
    for (int32_t c = 0; c < num_channels_; ++c) {
      outgoing.push_back(
          {(rank_ + 1) % size_, RING_GLOBAL, c, &ring_next_[c]});
      incoming.push_back(
          {(rank_ - 1 + size_) % size_, RING_GLOBAL, c, &ring_prev_[c]});
    }
    // Hierarchical-coordination control edges: every non-leader member
    // wires ONE control connection to its group leader (the leader's
    // per-cycle aggregation fan-in), reusing the epoch-stamped data-ring
    // handshake so a dead incarnation's connect can never steal a slot.
    leader_conn_.Close();
    member_conns_.clear();
    if (hier_coord_ && group_size_ > 1) {
      if (local_index_ == 0) {
        member_conns_.resize(group_size_);
        for (int m = 1; m < group_size_; ++m) {
          incoming.push_back({group_members_[m], RING_CTRL, 0,
                              &member_conns_[m]});
        }
      } else {
        outgoing.push_back({group_members_[0], RING_CTRL, 0, &leader_conn_});
      }
    }
    if (two_level_ && local_index_ == 0 && nnodes_ > 1) {
      // One leader per host participates in the inter-host ring, with the
      // full channel fan-out (this is the hop that crosses a real
      // network, so it gets the same sharded streaming cascade as the
      // flat ring).
      cross_next_.resize(num_channels_);
      cross_prev_.resize(num_channels_);
      for (int32_t c = 0; c < num_channels_; ++c) {
        outgoing.push_back({group_leaders_[(node_id_ + 1) % nnodes_], RING_CROSS,
                            c, &cross_next_[c]});
        incoming.push_back({group_leaders_[(node_id_ - 1 + nnodes_) %
                                           nnodes_],
                            RING_CROSS, c, &cross_prev_[c]});
      }
    }
    for (auto& edge : outgoing) {
      *edge.slot = ConnectRetry(peer_hosts[edge.peer], peer_ports[edge.peer],
                                60000, &err);
      if (!edge.slot->valid()) {
        last_error_ = "ring connect to rank " + std::to_string(edge.peer) +
                      ": " + err;
        return 1;
      }
      int32_t hello[4] = {rank_, edge.ring, edge.channel,
                          static_cast<int32_t>(epoch_.load())};
      if (!edge.slot->SendAll(hello, sizeof(hello))) {
        last_error_ = "ring handshake send failed";
        return 1;
      }
    }
    // Bounded ring accepts: a neighbor that died between rendezvous and
    // wiring must surface as a clean init error, not park the accept
    // forever (Accept honors the listener timeout; see socket.cc).
    data_listener_.SetTimeouts(5);
    auto ring_deadline = std::chrono::steady_clock::now() +
                         std::chrono::seconds(rendezvous_timeout_sec_);
    for (size_t matched_edges = 0; matched_edges < incoming.size();) {
      Socket conn;
      while (!conn.valid()) {
        if (std::chrono::steady_clock::now() > ring_deadline) {
          last_error_ = "ring accept: timed out waiting for neighbor "
                        "connections — a peer likely died during wiring";
          return 1;
        }
        conn = Accept(data_listener_, &err);
        if (!conn.valid() && err != kAcceptTimedOut) {
          last_error_ = "ring accept: " + err;
          return 1;
        }
      }
      conn.SetTimeouts(10);
      int32_t hello[4] = {-1, -1, -1, -1};
      if (!conn.RecvAll(hello, sizeof(hello))) {
        last_error_ = "ring handshake recv failed";
        return 1;
      }
      if (hello[3] != static_cast<int32_t>(epoch_.load())) {
        // A dead incarnation's delayed wiring connect (elastic
        // re-rendezvous raced the old world's teardown): drop it and
        // keep accepting this epoch's channels.
        continue;
      }
      bool matched = false;
      for (auto& edge : incoming) {
        if (edge.peer == hello[0] && edge.ring == hello[1] &&
            edge.channel == hello[2] && !edge.slot->valid()) {
          *edge.slot = std::move(conn);
          matched = true;
          ++matched_edges;
          break;
        }
      }
      if (!matched) {
        last_error_ = "unexpected ring handshake from rank " +
                      std::to_string(hello[0]) + " ring " +
                      std::to_string(hello[1]) + " channel " +
                      std::to_string(hello[2]);
        return 1;
      }
    }

    // Robustness: bound every blocking transport op and probe idle peers
    // so a dead/hung process surfaces as a clean error, not a hang.  Ring
    // data sockets additionally get HOROVOD_SOCKET_BUF_BYTES so the
    // kernel can stream ahead while userland reduces.
    std::vector<Socket*> data_socks;
    for (auto& s : ring_next_) data_socks.push_back(&s);
    for (auto& s : ring_prev_) data_socks.push_back(&s);
    for (auto& s : cross_next_) data_socks.push_back(&s);
    for (auto& s : cross_prev_) data_socks.push_back(&s);
    // ArmSocketDeadlines = keepalive probing PLUS TCP_USER_TIMEOUT bound
    // to the (fault-capped) socket timeout: a silently-dead peer errors
    // the socket inside the fault bound — data channels get a
    // classifiable error the link-heal layer can act on, and control
    // conns (rendezvous/CTRL) stop depending solely on the coordinator's
    // patience for dead-peer detection.
    std::vector<Socket*> socks = data_socks;
    socks.push_back(&coordinator_conn_);
    for (Socket* s : socks) {
      if (s->valid()) {
        s->SetTimeouts(socket_timeout_sec_);
        ArmSocketDeadlines(*s, socket_timeout_sec_);
      }
    }
    for (Socket* s : data_socks) {
      if (s->valid()) s->SetBufSizes(socket_buf_bytes_);
    }
    for (auto& c : worker_conns_) {
      if (c.valid()) {
        c.SetTimeouts(socket_timeout_sec_);
        ArmSocketDeadlines(c, socket_timeout_sec_);
      }
    }
    // Hierarchical control edges get the control-plane transport bounds
    // (not the data-socket buffer sizing): a dead member/leader must
    // surface within the same patience budget as any control peer.
    if (leader_conn_.valid()) {
      leader_conn_.SetTimeouts(socket_timeout_sec_);
      ArmSocketDeadlines(leader_conn_, socket_timeout_sec_);
    }
    for (auto& c : member_conns_) {
      if (c.valid()) {
        c.SetTimeouts(socket_timeout_sec_);
        ArmSocketDeadlines(c, socket_timeout_sec_);
      }
    }
    // Shared-memory intra-host edges: the second channel kind.  Wired
    // AFTER the TCP rings so a failure here can still use BroadcastAbort-
    // free cleanup (init error on every rank via its own wiring timeout).
    if (shm_enabled_ && group_size_ > 1) {
      std::string shm_err;
      if (!WireShmEdges(&shm_err)) {
        last_error_ = "shm wiring: " + shm_err;
        CloseShmEdges();
        return 1;
      }
      shm_ring_active_ = true;
    }
    // Data-plane pool: one worker per channel drives channel shards,
    // concurrent responses, and large parallel reductions.
    pool_.Start(num_channels_);
    }  // committed size_ > 1: ring wiring + transport bounds
  } else {
    // Env-identity world of one (no rendezvous ran): commit a local epoch
    // so restarts still advance it and stats stay meaningful.
    epoch_.fetch_add(1);
  }

  // Timeline: initialized AFTER rendezvous so the file name reflects the
  // COMMITTED rank (an elastic re-rank would otherwise mislabel tracks)
  // and the header can carry the rendezvous-estimated clock offset.
  // Rank 0 keeps the exact HOROVOD_TIMELINE path (back-compat);
  // HOROVOD_TIMELINE_ALL_RANKS=1 adds "<path>.rank<r>" per worker so
  // `python -m horovod_tpu.timeline merge` can build the fleet view.
  if (const char* tl = std::getenv("HOROVOD_TIMELINE");
      tl != nullptr && tl[0] != '\0') {
    timeline_.SetMaxBytes(EnvInt64("HOROVOD_TIMELINE_MAX_MB", 0) << 20);
    if (rank_ == 0) {
      timeline_.Initialize(tl);
    } else if (EnvInt64("HOROVOD_TIMELINE_ALL_RANKS", 0) != 0) {
      timeline_.Initialize(std::string(tl) + ".rank" +
                           std::to_string(rank_));
    }
    timeline_.SetMeta(rank_, epoch_.load(), clock_offset_ns_);
  }
  // Flight recorder: ring is in-memory always (capacity knob); dumps
  // need a sink dir.  The fatal-signal handlers are installed only when
  // a sink exists — without one a dump is a no-op anyway, and default
  // signal dispositions stay untouched.
  {
    int cap =
        static_cast<int>(EnvInt64("HOROVOD_FLIGHT_RECORDER_EVENTS", 256));
    const char* dir = std::getenv("HOROVOD_FLIGHT_RECORDER_DIR");
    GlobalFlightRecorder().Configure(cap, dir ? dir : "", rank_,
                                     epoch_.load(), clock_offset_ns_);
    if (dir != nullptr && dir[0] != '\0') InstallFlightSignalHandlers();
    GlobalFlightRecorder().Record(
        "epoch", control_cycle_seq_,
        "committed epoch=%lld rank=%d size=%d hosts=%d",
        static_cast<long long>(epoch_.load()), rank_, size_, nnodes_);
  }
  last_stall_check_ = std::chrono::steady_clock::now();
  last_sub_stall_check_ = last_stall_check_;
  last_exec_time_ = std::chrono::steady_clock::now();
  fusion_buffers_.assign(std::max(1, num_channels_),
                         std::vector<uint8_t>());
  initialized_.store(true);
  background_ = std::thread(&Engine::BackgroundLoop, this);
  return 0;
}

// Tag on every JOIN frame ("HVJN"): the coordinator's listener is a
// well-known port, and an untagged stray connection (health probe, port
// scanner) must never be mistaken for a membership candidate — in the
// mid-run path that mistake would abort the whole world.
static constexpr uint32_t kJoinMagic = 0x4e4a5648u;

// Clock-sync ping ("HVPG"), folded into the JOIN/ASSIGN handshake: right
// after adopting its ASSIGN each worker runs kClockPings request/reply
// rounds against the coordinator's rendezvous conn and keeps the min-RTT
// midpoint estimate of rank 0's monotonic clock vs its own — the offset
// the merged timeline and the flight-recorder post-mortem align tracks
// with.  Serial per-worker service is fine: only a worker's FIRST round
// can queue behind another worker's service, and min-RTT discards it.
static constexpr uint32_t kPingMagic = 0x47505648u;
static constexpr int kClockPings = 5;

static int64_t MonoNowNs() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// Coordinator-led membership rendezvous (see engine.h).  The first init
// (and every non-elastic re-init) requires the full env world within
// HOROVOD_RENDEZVOUS_TIMEOUT_SEC; an elastic re-init instead waits a
// bounded HOROVOD_ELASTIC_GROW_TIMEOUT_SEC grace window for relaunched or
// new candidates and then commits the survivors — contiguous ranks sorted
// by persistent worker id, epoch + 1 — or rejects everyone with a clean
// terminal error below HOROVOD_ELASTIC_MIN_SIZE.
int Engine::CoordinatorRendezvous(const std::string& host, int port,
                                  const std::string& my_host, int data_port,
                                  std::vector<std::string>* peer_hosts,
                                  std::vector<int>* peer_ports) {
  std::string err;
  const bool regrow = elastic_enabled_ && epoch_.load() > 0;
  control_listener_ = Listen(host, port, world_size_ + 8, nullptr, &err);
  if (!control_listener_.valid()) {
    last_error_ = "coordinator listen on " + host + ":" +
                  std::to_string(port) + ": " + err;
    return 1;
  }
  // Tolerant accept loop: a restart can race a dying previous engine's
  // listener — workers whose connect landed there retry against this one,
  // so dead/garbled/duplicate connections are dropped (latest join per
  // worker id wins — safe because a worker id's old-world and new-world
  // incarnations act sequentially) rather than failing the init.  Accept
  // and each frame read are bounded so a silent remnant cannot park the
  // loop, and the whole wait has a deadline.
  control_listener_.SetTimeouts(2);  // Accept honors SO_RCVTIMEO
  struct JoinInfo {
    std::string host;
    std::string host_key;
    int data_port = 0;
    int32_t lr = 0, ls = 1;
    uint8_t shm_ok = 0;
    Socket conn;
  };
  std::map<int, JoinInfo> joined;  // worker id → latest join (sorted)
  const int64_t window_ms =
      (regrow ? grow_timeout_sec_ : rendezvous_timeout_sec_) * 1000ll;
  auto rdv_deadline = std::chrono::steady_clock::now() +
                      std::chrono::milliseconds(window_ms);
  while (static_cast<int>(joined.size()) < world_size_ - 1) {
    if (std::chrono::steady_clock::now() > rdv_deadline) {
      if (regrow) break;  // grace window over: commit whoever showed up
      last_error_ = "rendezvous timed out: heard from " +
                    std::to_string(joined.size()) + " of " +
                    std::to_string(world_size_ - 1) +
                    " workers — check the other ranks' logs";
      return 1;
    }
    Socket conn = Accept(control_listener_, &err);
    if (!conn.valid()) {
      continue;  // accept timeout tick; re-check the deadline
    }
    conn.SetTimeouts(10);
    std::vector<uint8_t> frame;
    if (!conn.RecvFrame(&frame)) {
      continue;  // peer gave up (retrying) or stale/silent remnant
    }
    Reader r(frame.data(), frame.size());
    uint32_t magic = r.u32();
    int32_t id = r.i32();
    std::string peer_host = r.str();
    int32_t peer_port = r.i32();
    int32_t lr = r.i32(), ls = r.i32();
    // Co-location fields (hostname#boot-id + a local /dev/shm probe
    // verdict): the coordinator groups ranks by host key and commits the
    // world-wide shm decision from the AND of every member's probe.
    std::string peer_key = r.str();
    uint8_t peer_shm = r.u8();
    if (!r.ok() || magic != kJoinMagic || id < 1 || id >= world_size_) {
      continue;  // not a join frame from this job
    }
    JoinInfo info;
    info.host = std::move(peer_host);
    info.host_key = std::move(peer_key);
    info.data_port = peer_port;
    info.lr = lr;
    info.ls = ls;
    info.shm_ok = peer_shm;
    info.conn = std::move(conn);
    joined[id] = std::move(info);
  }

  // Membership commit: contiguous ranks over {coordinator} ∪ survivors,
  // sorted by worker id (std::map iteration order).
  const int new_size = static_cast<int>(joined.size()) + 1;
  const int64_t new_epoch = epoch_.load() + 1;
  if (regrow && new_size < min_size_) {
    std::string msg =
        "elastic membership: the world shrank to " + std::to_string(new_size) +
        " worker(s), below HOROVOD_ELASTIC_MIN_SIZE=" +
        std::to_string(min_size_) + " (no replacement joined within the " +
        std::to_string(grow_timeout_sec_) +
        "s HOROVOD_ELASTIC_GROW_TIMEOUT_SEC window); terminating cleanly";
    Writer w;
    w.u8(1);  // reject
    w.str(msg);
    for (auto& kv : joined) kv.second.conn.SendFrame(w.bytes());
    last_error_ = msg;
    std::fprintf(stderr, "horovod_tpu coordinator: %s\n", msg.c_str());
    return 1;
  }
  peer_hosts->assign(new_size, "");
  peer_ports->assign(new_size, 0);
  std::vector<int32_t> peer_lr(new_size, 0), peer_ls(new_size, 1);
  std::vector<std::string> peer_keys(new_size);
  std::vector<int> member_ids(new_size, 0);
  std::vector<Socket> conns(new_size);
  bool shm_commit = shm_enabled_ && ShmAvailable();
  (*peer_hosts)[0] = my_host;
  (*peer_ports)[0] = data_port;
  peer_lr[0] = local_rank_;
  peer_ls[0] = local_size_;
  peer_keys[0] = HostKey();
  int next_rank = 1;
  for (auto& kv : joined) {
    (*peer_hosts)[next_rank] = kv.second.host;
    (*peer_ports)[next_rank] = kv.second.data_port;
    peer_lr[next_rank] = kv.second.lr;
    peer_ls[next_rank] = kv.second.ls;
    peer_keys[next_rank] = kv.second.host_key;
    shm_commit = shm_commit && kv.second.shm_ok != 0;
    member_ids[next_rank] = kv.first;
    conns[next_rank] = std::move(kv.second.conn);
    ++next_rank;
  }
  // Coordinator commits the host grouping GLOBALLY.  Default: group by
  // the JOIN frames' host keys (hostname#boot-id — genuinely co-located
  // ranks share one), ids assigned by first appearance in committed rank
  // order so every rank derives identical leader tables.
  // HOROVOD_HIERARCHICAL_ALLREDUCE=1 instead synthesizes a block grouping
  // rank/local_size (the reference's is_homogeneous layout,
  // operations.cc:1511-1525) — the way tests and single-host benches
  // force a multi-group topology — provided every member reports the
  // same local_size and block placement under the NEW ranks; a shrunken
  // world that broke the layout falls back to host keys automatically.
  std::vector<int32_t> groups(new_size, 0);
  bool want_hier = EnvInt64("HOROVOD_HIERARCHICAL_ALLREDUCE", 0) != 0;
  bool hier_ok = want_hier && local_size_ > 1 &&
                 new_size % local_size_ == 0 && new_size > local_size_;
  for (int i = 0; hier_ok && i < new_size; ++i) {
    hier_ok = peer_ls[i] == local_size_ && peer_lr[i] == i % local_size_;
  }
  if (want_hier && !hier_ok) {
    std::fprintf(stderr,
                 "horovod_tpu: HOROVOD_HIERARCHICAL_ALLREDUCE ignored — "
                 "needs a homogeneous block layout (equal local_size > 1 "
                 "dividing size, local_rank == rank %% local_size on "
                 "every rank); grouping by host key instead.\n");
  }
  if (hier_ok) {
    for (int i = 0; i < new_size; ++i) groups[i] = i / local_size_;
  } else {
    std::unordered_map<std::string, int32_t> key_ids;
    for (int i = 0; i < new_size; ++i) {
      auto it = key_ids.find(peer_keys[i]);
      if (it == key_ids.end()) {
        it = key_ids.emplace(peer_keys[i],
                             static_cast<int32_t>(key_ids.size())).first;
      }
      groups[i] = it->second;
    }
  }
  rank_host_ = groups;
  shm_enabled_ = shm_commit;
  if (backup_workers_ >= new_size) backup_workers_ = new_size - 1;
  // Control-plane hierarchy: the coordinator's env resolution is THE
  // resolution (default on; =0 restores the flat rank-0 star bit-for-
  // bit) — a per-rank split would leave leaders aggregating members
  // that still talk straight to rank 0.
  hier_coord_ = EnvInt64("HOROVOD_HIERARCHICAL_COORDINATOR", 1) != 0;
  // Crash-mid-wiring leftovers from dead incarnations: no current-epoch
  // segment exists yet (members create edges only after ASSIGN), so
  // everything under this job's prefix is stale.
  if (shm_enabled_) ShmSweepStale(shm_prefix_);
  // Peer-table compaction: the host strings are near-always a handful of
  // distinct values repeated across ranks — dictionary-encode them once
  // and reference by varint index, with ports/group ids as varints too,
  // so ASSIGN bytes grow with hosts + ranks·few-bytes instead of
  // ranks·(host string + 8).  assign_bytes_tx counts what actually went
  // out, per member, re-rendezvous included.
  std::vector<std::string> uniq_hosts;
  {
    std::unordered_map<std::string, uint32_t> seen_hosts;
    for (int i = 0; i < new_size; ++i) {
      if (seen_hosts.emplace((*peer_hosts)[i],
                             static_cast<uint32_t>(uniq_hosts.size()))
              .second) {
        uniq_hosts.push_back((*peer_hosts)[i]);
      }
    }
  }
  std::unordered_map<std::string, uint32_t> host_ids;
  for (uint32_t i = 0; i < uniq_hosts.size(); ++i) {
    host_ids[uniq_hosts[i]] = i;
  }
  for (int r = 1; r < new_size; ++r) {
    Writer w;
    w.u8(0);  // ok
    w.i64(new_epoch);
    w.i32(r);  // assigned rank
    w.i32(new_size);
    // Committed shm verdict (env escape hatch AND every member's runtime
    // probe): per-rank fallback would desync the wire pattern, so the
    // whole world runs shm or none of it does.
    w.u8(shm_enabled_ ? 1 : 0);
    // Committed control-plane hierarchy flag (see hier_coord_ above).
    w.u8(hier_coord_ ? 1 : 0);
    // The coordinator's data-plane fan-out is THE fan-out: every member
    // wires exactly this many channels per ring edge, so a rank whose
    // env disagrees cannot deadlock the channel accepts.  The wave width
    // rides along for the same reason: concurrent responses pick
    // channels by list index, so mismatched wave grouping would pair
    // different responses on one socket.  The algorithm-selection
    // crossover is committed here too — a size-based path split is a
    // different wire pattern, so every rank must agree on the threshold.
    w.i32(num_channels_);
    w.i32(wave_width_.load());
    w.i64(algo_threshold_.load());
    // Committed backup-worker over-provisioning (clamped to the
    // committed world): behavior is driven by the per-cycle participant
    // bitmaps, but stats()["config"] must agree on every rank.
    w.i32(backup_workers_);
    // Committed link-heal knobs: healing is a two-sided protocol (the
    // sender re-dials, the receiver accepts+ACKs), so one endpoint
    // healing an edge the other's env already abandoned must be
    // impossible by construction.
    w.i32(link_retries_);
    w.i64(link_heal_timeout_ms_);
    // Committed priority band width: response ORDER is wire pattern
    // (waves pick channels by list index), so the whole world bands
    // identically or not at all.
    w.i64(priority_bands_.load());
    w.vu(uniq_hosts.size());
    for (const auto& h : uniq_hosts) w.str(h);
    for (int i = 0; i < new_size; ++i) {
      w.vu(host_ids[(*peer_hosts)[i]]);
      w.vu(static_cast<uint64_t>((*peer_ports)[i]));
      w.vu(static_cast<uint64_t>(groups[i]));
    }
    if (!conns[r].SendFrame(w.bytes())) {
      last_error_ = "rendezvous assign to worker id " +
                    std::to_string(member_ids[r]) + " failed";
      return 1;
    }
    assign_bytes_tx_.fetch_add(static_cast<int64_t>(w.bytes().size()) + 8);
  }
  // Clock-sync service (see kPingMagic): each worker pings right after
  // parsing its ASSIGN; serve every member's rounds before the cycle
  // loop takes over the conns.
  for (int r = 1; r < new_size; ++r) {
    for (int k = 0; k < kClockPings; ++k) {
      std::vector<uint8_t> pf;
      if (!conns[r].RecvFrame(&pf)) {
        last_error_ = "clock-sync ping from worker id " +
                      std::to_string(member_ids[r]) + " failed";
        return 1;
      }
      Reader pr(pf.data(), pf.size());
      uint32_t magic = pr.u32();
      (void)pr.i64();  // worker's t0 (only the worker needs it)
      if (!pr.ok() || magic != kPingMagic) {
        last_error_ = "bad clock-sync ping frame";
        return 1;
      }
      Writer pw;
      pw.i64(MonoNowNs());
      if (!conns[r].SendFrame(pw.bytes())) {
        last_error_ = "clock-sync reply to worker id " +
                      std::to_string(member_ids[r]) + " failed";
        return 1;
      }
    }
  }
  clock_offset_ns_ = 0;  // rank 0 IS the reference clock
  worker_conns_.clear();
  worker_conns_.resize(new_size);
  for (int r = 1; r < new_size; ++r) worker_conns_[r] = std::move(conns[r]);
  if (regrow || new_size != world_size_) {
    std::string members;
    for (int i = 0; i < new_size; ++i) {
      if (!members.empty()) members += ",";
      members += std::to_string(member_ids[i]);
    }
    std::fprintf(stderr,
                 "horovod_tpu coordinator: committed membership epoch %lld: "
                 "size %d (worker ids %s)\n",
                 static_cast<long long>(new_epoch), new_size,
                 members.c_str());
  }
  rank_ = 0;
  size_ = new_size;
  epoch_.store(new_epoch);
  return 0;
}

int Engine::WorkerRendezvous(const std::string& host, int port,
                             const std::string& my_host, int data_port,
                             std::vector<std::string>* peer_hosts,
                             std::vector<int>* peer_ports) {
  std::string err;
  // Retry the whole connect+exchange: after a restart, the first connect
  // can land on the PREVIOUS engine's closing listener and die with EOF
  // before the assignment arrives — the new listener is up moments later.
  // A mid-run join candidate's first exchange dies the same way when the
  // coordinator tears the running world down to admit it.
  int64_t join_ms = static_cast<int64_t>(rendezvous_timeout_sec_) * 1000;
  if (elastic_enabled_) {
    join_ms += static_cast<int64_t>(grow_timeout_sec_) * 2000 + 30000;
  }
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::milliseconds(join_ms);
  std::string lasterr = "rendezvous timed out";
  while (std::chrono::steady_clock::now() < deadline) {
    auto left = std::chrono::duration_cast<std::chrono::milliseconds>(
                    deadline - std::chrono::steady_clock::now())
                    .count();
    coordinator_conn_ = ConnectRetry(host, port, static_cast<int>(left),
                                     &err);
    if (!coordinator_conn_.valid()) {
      lasterr = err;
      break;
    }
    // Bound the exchange: a connect that landed on a wedged previous
    // listener must time out and retry, not block forever.
    coordinator_conn_.SetTimeouts(10);
    Writer w;
    w.u32(kJoinMagic);
    w.i32(worker_id_);
    w.str(my_host);
    w.i32(data_port);
    w.i32(local_rank_);
    w.i32(local_size_);
    // Co-location identity + this host's shm capability: the coordinator
    // groups by the key and ANDs the probes into the committed verdict.
    w.str(HostKey());
    w.u8(shm_enabled_ && ShmAvailable() ? 1 : 0);
    std::vector<uint8_t> frame;
    // The assignment legitimately takes as long as the slowest member's
    // arrival plus — elastic — the entire grow grace window the
    // coordinator holds open for further candidates.
    int idle_rounds = 11 + (elastic_enabled_ ? grow_timeout_sec_ / 10 + 2
                                             : 0);
    if (!coordinator_conn_.SendFrame(w.bytes()) ||
        !coordinator_conn_.RecvFrame(&frame, idle_rounds)) {
      lasterr = "rendezvous exchange failed";
      coordinator_conn_.Close();
      std::this_thread::sleep_for(std::chrono::milliseconds(50));
      continue;
    }
    Reader r(frame.data(), frame.size());
    uint8_t status = r.u8();
    if (status != 0) {
      // Terminal membership rejection (e.g. the surviving world is below
      // HOROVOD_ELASTIC_MIN_SIZE): no retry will change the verdict.
      std::string msg = r.str();
      last_error_ = (r.ok() && !msg.empty())
                        ? msg
                        : "membership rejected by the coordinator";
      std::fprintf(stderr, "horovod_tpu worker id %d: %s\n", worker_id_,
                   last_error_.c_str());
      return 1;
    }
    int64_t new_epoch = r.i64();
    int32_t new_rank = r.i32();
    int32_t new_size = r.i32();
    uint8_t shm_on = r.u8();
    uint8_t hier_on = r.u8();
    int32_t committed_channels = r.i32();
    int32_t committed_wave = r.i32();
    int64_t committed_algo = r.i64();
    int32_t committed_backup = r.i32();
    int32_t committed_link_retries = r.i32();
    int64_t committed_heal_ms = r.i64();
    int64_t committed_bands = r.i64();
    if (!r.ok() || new_size < 1 || new_rank < 0 || new_rank >= new_size ||
        committed_channels < 1 || committed_channels > 16 ||
        committed_wave < 1 || committed_wave > 16 || committed_algo < 0 ||
        committed_backup < 0 || committed_backup >= new_size ||
        committed_link_retries < 0 || committed_link_retries > 1000 ||
        committed_heal_ms < 1 || committed_bands < 0 ||
        committed_bands > (1 << 20)) {
      lasterr = "bad membership assignment frame";
      break;
    }
    // Dictionary-coded peer table (see CoordinatorRendezvous): unique
    // host strings once, then per-rank (host index, port, group id)
    // varint triples.
    uint64_t nhosts = r.vu();
    if (!r.ok() || nhosts < 1 ||
        nhosts > static_cast<uint64_t>(new_size)) {
      lasterr = "bad membership assignment frame";
      break;
    }
    std::vector<std::string> uniq_hosts(nhosts);
    for (uint64_t i = 0; i < nhosts; ++i) uniq_hosts[i] = r.str();
    peer_hosts->assign(new_size, "");
    peer_ports->assign(new_size, 0);
    rank_host_.assign(new_size, 0);
    bool groups_ok = true;
    for (int i = 0; i < new_size; ++i) {
      uint64_t hidx = r.vu();
      if (hidx >= nhosts) {
        groups_ok = false;
        break;
      }
      (*peer_hosts)[i] = uniq_hosts[hidx];
      (*peer_ports)[i] = static_cast<int>(r.vu());
      rank_host_[i] = static_cast<int32_t>(r.vu());
      // Group ids index leader tables (AdoptTopology) — an out-of-range
      // id from a garbled frame must fail here like the fields above,
      // not as an OOB write or a multi-GB nnodes_ allocation there.
      groups_ok = groups_ok && rank_host_[i] >= 0 && rank_host_[i] < new_size;
    }
    if (!r.ok() || !groups_ok) {
      lasterr = "bad rendezvous table";
      break;
    }
    shm_enabled_ = shm_on != 0;
    hier_coord_ = hier_on != 0;
    num_channels_ = committed_channels;
    wave_width_.store(committed_wave);
    algo_threshold_.store(committed_algo);
    backup_workers_ = committed_backup;
    link_retries_ = committed_link_retries;
    priority_bands_.store(committed_bands);
    // The committed deadline re-clamps against THIS rank's socket
    // timeout: the coordinator clamped against its own, but "healing
    // must finish strictly inside every other rank's no-progress
    // patience" is a per-rank property — under heterogeneous
    // HOROVOD_SOCKET_TIMEOUT_SEC, a worker with tighter patience would
    // otherwise abort 'link: no progress' mid-way through a peer's
    // committed-length heal.
    link_heal_timeout_ms_ = committed_heal_ms;
    if (socket_timeout_sec_ > 0) {
      link_heal_timeout_ms_ = std::min<int64_t>(
          link_heal_timeout_ms_,
          static_cast<int64_t>(socket_timeout_sec_) * 1000 * 3 / 4);
      if (link_heal_timeout_ms_ < 1) link_heal_timeout_ms_ = 1;
    }
    if (new_rank != worker_id_ || new_size != world_size_) {
      std::fprintf(stderr,
                   "horovod_tpu worker id %d: joined membership epoch %lld "
                   "as rank %d of %d\n",
                   worker_id_, static_cast<long long>(new_epoch), new_rank,
                   new_size);
    }
    // Clock-offset estimation against the coordinator (see kPingMagic):
    // min-RTT midpoint over kClockPings rounds on the still-open
    // rendezvous conn.  rank0_mono ≈ my_mono + clock_offset_ns_.
    {
      int64_t best_rtt = std::numeric_limits<int64_t>::max();
      int64_t best_off = 0;
      for (int k = 0; k < kClockPings; ++k) {
        Writer pw;
        pw.u32(kPingMagic);
        pw.i64(MonoNowNs());
        const int64_t t0 = MonoNowNs();
        std::vector<uint8_t> pf;
        if (!coordinator_conn_.SendFrame(pw.bytes()) ||
            !coordinator_conn_.RecvFrame(&pf)) {
          last_error_ = "clock-sync exchange with the coordinator failed";
          return 1;
        }
        const int64_t t1 = MonoNowNs();
        Reader pr(pf.data(), pf.size());
        const int64_t tc = pr.i64();
        if (!pr.ok()) {
          last_error_ = "bad clock-sync reply frame";
          return 1;
        }
        const int64_t rtt = t1 - t0;
        if (rtt < best_rtt) {
          best_rtt = rtt;
          best_off = tc - (t0 + rtt / 2);
        }
      }
      clock_offset_ns_ = best_off;
    }
    rank_ = new_rank;
    size_ = new_size;
    epoch_.store(new_epoch);
    return 0;
  }
  last_error_ = lasterr;
  return 1;
}

// Coordinator, elastic mode, once per cycle: a relaunched/new worker
// connecting to the control listener mid-run is a join candidate.  Its
// join triggers a collective abort so every member falls back into
// run_elastic's recovery loop and the next rendezvous admits the
// candidate under epoch+1 — the "rejoin without whole-job restart" half
// of in-place elastic membership.
bool Engine::PollJoinCandidate() {
  if (!elastic_enabled_ || worker_id_ != 0 || !control_listener_.valid()) {
    return false;
  }
  if (!HasPendingConnection(control_listener_)) return false;
  std::string err;
  Socket conn = Accept(control_listener_, &err);
  if (!conn.valid()) return false;
  // A genuine candidate sends its JOIN immediately after connecting; a
  // silent stray (health probe, scanner) must not park the negotiation
  // loop — bound the speculative read to a fraction of a cycle's budget
  // and require the join magic before this connection may abort a
  // running world.
  if (!WaitReadable(conn, 250)) return false;
  conn.SetTimeouts(1);
  std::vector<uint8_t> frame;
  if (!conn.RecvFrame(&frame)) return false;  // stray/garbled: drop it
  Reader r(frame.data(), frame.size());
  uint32_t magic = r.u32();
  int32_t id = r.i32();
  if (!r.ok() || magic != kJoinMagic || id < 1 || id >= world_size_) {
    return false;
  }
  // The candidate's connection is dropped here; it retries its join and
  // lands on the re-formed world's listener.
  BroadcastAbort(
      -1, "elastic re-rendezvous: worker id " + std::to_string(id) +
              " is waiting to join (epoch " +
              std::to_string(epoch_.load()) + ", size " +
              std::to_string(size_) +
              "); aborting in-flight collectives to re-form the world");
  return true;
}

void Engine::Shutdown() {
  if (!initialized_.load()) return;
  // The background loop may have ALREADY exited (a peer's shutdown
  // broadcast, or a transport abort) with shut_down_ set while
  // initialized_ is still true — join and clear state regardless, or a
  // subsequent Init() would see initialized_ and no-op on a dead engine.
  shutdown_requested_.store(true);
  cycle_cv_.notify_all();  // wake the event-driven cycle wait immediately
  if (background_.joinable()) background_.join();
  // The background loop waits out its in-flight waves before exiting, so
  // the pool is quiescent here; stop it so a re-Init starts fresh.
  pool_.Stop();
  initialized_.store(false);
}

void Engine::ClearCacheState() {
  cache_by_name_.clear();
  cache_entries_.clear();
  pending_cache_hits_.clear();
  cache_resubmits_.clear();
  coord_slot_bits_.clear();
  coord_slot_names_.clear();
  coord_slot_by_name_.clear();
  free_slots_.clear();
  next_slot_ = 0;
  sub_slot_bits_.clear();
  // Backup-worker skip tokens ride along: they reference the dead (or
  // about-to-be-recommitted) world's partial commits.
  skip_tokens_.clear();
}

// ---------------------------------------------------------------------------
// Background negotiation loop
// ---------------------------------------------------------------------------

// message_table_ is background-thread-only by design (no mu_); this makes
// the invariant self-checking at every access site instead of
// comment-enforced.  Deliberately NOT assert(): downstream builds override
// CXXFLAGS (?=) with -DNDEBUG and would silently compile the check out.
void Engine::AssertBackgroundThread() const {
  if (std::this_thread::get_id() != bg_thread_id_.load()) {
    std::fprintf(stderr,
                 "horovod_tpu: FATAL: message_table_ accessed off the "
                 "background thread\n");
    std::abort();
  }
}

void Engine::BackgroundLoop() {
  bg_thread_id_.store(std::this_thread::get_id());
  while (RunLoopOnce()) {
  }
  // Fail anything still in flight (reference SHUT_DOWN_ERROR,
  // operations.cc:1647-1662).  A transport abort carries the specific
  // reason (which peer died, during what) to every waiter.
  std::string reason = abort_reason_.empty()
      ? "Horovod has been shut down. This was caused by an exception on one "
        "of the ranks or an attempt to enqueue after shutdown."
      : abort_reason_;
  if (!abort_reason_.empty()) {
    // The world is dying abnormally: flush the last timeline events (the
    // cycle before a crash must never be lost to stdio buffering) and
    // dump the flight recorder for the post-mortem CLI.  A clean
    // shutdown dumps nothing — the recorder is a crash artifact.
    GlobalFlightRecorder().Record("abort", control_cycle_seq_, "%s",
                                  abort_reason_.c_str());
    GlobalFlightRecorder().Dump(abort_reason_.c_str());
    timeline_.Flush();
  }
  std::vector<TensorTableEntry> leftovers;
  {
    std::lock_guard<std::mutex> lk(mu_);
    for (auto& kv : tensor_table_) leftovers.push_back(std::move(kv.second));
    tensor_table_.clear();
    message_queue_.clear();
  }
  for (auto& e : leftovers) {
    FinishEntry(e, Status::Aborted(reason));
  }
  // Drop half-negotiated state so a re-Init after an abort (the elastic
  // recovery path) starts from an empty table instead of poisoning the new
  // world's readiness counts with the dead world's pending entries.
  // Thread-correct: this is still the background thread.
  message_table_.clear();
  // Same for the response cache: a recovered world must never replay the
  // dead world's slot ids (the new coordinator numbers slots from zero).
  ClearCacheState();
  // Drop the fusion-scratch high-water allocations: a dead/stopped engine
  // must not pin up to threshold-sized buffers per channel slot.
  ReleaseScratch();
  // Close every connection so peers blocked in recv see EOF immediately and
  // the failure propagates around the ring instead of stranding them until
  // their own timeout.
  CloseSockets();
  shut_down_.store(true);
  // Second drain, after the store: an Enqueue racing the first drain can
  // have inserted between it and the store (its pre-insert liveness check
  // passed).  Enqueue checks shut_down_ under mu_, so any insert not
  // caught here observed the store and was rejected — no waiter can be
  // stranded on a never-finished entry.
  std::vector<TensorTableEntry> stragglers;
  {
    std::lock_guard<std::mutex> lk(mu_);
    for (auto& kv : tensor_table_) stragglers.push_back(std::move(kv.second));
    tensor_table_.clear();
    message_queue_.clear();
  }
  for (auto& e : stragglers) {
    FinishEntry(e, Status::Aborted(reason));
  }
}

std::string Engine::AbortReason() const {
  // Publication order: BackgroundLoop writes abort_reason_, then
  // release-stores shut_down_; acquiring shut_down_ here makes the string
  // read race-free from API threads.
  if (!shut_down_.load()) return std::string();
  return abort_reason_;
}

void Engine::CloseSockets() {
  for (auto& s : ring_next_) s.Close();
  for (auto& s : ring_prev_) s.Close();
  for (auto& s : cross_next_) s.Close();
  for (auto& s : cross_prev_) s.Close();
  // shm edges ride along: Close() flips the shared `closed` word, so a
  // peer blocked in a ring wait fails fast — the shm analogue of the EOF
  // these socket closes propagate.
  CloseShmEdges();
  coordinator_conn_.Close();
  for (auto& c : worker_conns_) c.Close();
  leader_conn_.Close();
  for (auto& c : member_conns_) c.Close();
  control_listener_.Close();
  data_listener_.Close();
  // Parked RESUME connections belong to the incarnation being torn down.
  HealInboxClear();
}

// -- link self-healing bookkeeping --

void Engine::RecordLinkHealNs(int64_t ns) {
  std::lock_guard<std::mutex> lk(heal_ns_mu_);
  constexpr size_t kCap = 1024;
  if (heal_ns_samples_.size() < kCap) {
    heal_ns_samples_.push_back(ns);
  } else {
    heal_ns_samples_[heal_ns_next_ % kCap] = ns;
  }
  ++heal_ns_next_;
}

int64_t Engine::LinkHealNsPercentile(double p) const {
  std::vector<int64_t> snap;
  {
    std::lock_guard<std::mutex> lk(heal_ns_mu_);
    snap = heal_ns_samples_;
  }
  if (snap.empty()) return 0;
  size_t idx = static_cast<size_t>(p * (snap.size() - 1) + 0.5);
  if (idx >= snap.size()) idx = snap.size() - 1;
  std::nth_element(snap.begin(), snap.begin() + idx, snap.end());
  return snap[idx];
}

void Engine::HealInboxPut(int32_t ring, int32_t channel,
                          const LinkResume& lr, Socket conn) {
  std::lock_guard<std::mutex> lk(heal_mu_);
  auto key = std::make_pair(ring, channel);
  auto it = heal_inbox_.find(key);
  if (it != heal_inbox_.end()) {
    // Newest wins: the sender retries with fresh connects and abandons
    // old ones, so a parked older conn is at best dead weight.
    it->second = std::make_pair(lr, std::move(conn));
    return;
  }
  heal_inbox_.emplace(key, std::make_pair(lr, std::move(conn)));
  heal_inbox_size_.fetch_add(1);
}

bool Engine::HealInboxTake(int32_t ring, int32_t channel, LinkResume* lr,
                           Socket* conn) {
  if (heal_inbox_size_.load() == 0) return false;
  std::lock_guard<std::mutex> lk(heal_mu_);
  auto it = heal_inbox_.find(std::make_pair(ring, channel));
  if (it == heal_inbox_.end()) return false;
  *lr = it->second.first;
  *conn = std::move(it->second.second);
  heal_inbox_.erase(it);
  heal_inbox_size_.fetch_sub(1);
  return true;
}

void Engine::HealInboxClear() {
  std::lock_guard<std::mutex> lk(heal_mu_);
  heal_inbox_.clear();
  heal_inbox_size_.store(0);
}

// ---------------------------------------------------------------------------
// Shared-memory edges (intra-host transport + hierarchy)
// ---------------------------------------------------------------------------

void Engine::CloseShmEdges() {
  for (auto& r : shm_ring_tx_) r.Close();
  for (auto& r : shm_ring_rx_) r.Close();
  for (auto& e : shm_star_) {
    e.tx.Close();
    e.rx.Close();
  }
  shm_ring_tx_.clear();
  shm_ring_rx_.clear();
  shm_star_.clear();
  shm_ring_active_ = false;
}

void Engine::CountShmBytes(int64_t tx, int64_t rx) {
  if (tx > 0) {
    shm_bytes_tx_.fetch_add(tx);
    data_bytes_tx_.fetch_add(tx);
  }
  if (rx > 0) {
    shm_bytes_rx_.fetch_add(rx);
    data_bytes_rx_.fetch_add(rx);
  }
  if (tx + rx > 0) intra_host_bytes_.fetch_add(tx + rx);
}

void Engine::CountPortBytes(const RingPort& port, int64_t tx, int64_t rx,
                            bool compressed) {
  if (compressed && tx > 0) compressed_bytes_tx_.fetch_add(tx);
  if (port.is_shm()) {
    CountShmBytes(tx, rx);
    return;
  }
  if (tx > 0) data_bytes_tx_.fetch_add(tx);
  if (rx > 0) data_bytes_rx_.fetch_add(rx);
}

// Wire the group's shm edges for the committed epoch.  Name scheme (all
// under the job prefix, all epoch-stamped so a dead incarnation can never
// collide):  ring edge from group position i toward (i+1)%L on channel c:
//   /<prefix>e<epoch>_g<gid>_r<i>_c<c>
// star edge member i <-> leader, one ring per direction:
//   /<prefix>e<epoch>_g<gid>_u<i>   (member produces, leader consumes)
//   /<prefix>e<epoch>_g<gid>_d<i>   (leader produces, member consumes)
// Creation order is deadlock-free: every process creates ALL its segments
// first, then attaches (Attach retries until the creator's segment
// appears), then waits for its own segments' attach confirmations and
// unlinks the names — after wiring, /dev/shm holds nothing for this
// group, so a SIGKILL cannot leak entries for wired edges.
bool Engine::WireShmEdges(std::string* err) {
  const int L = group_size_;
  const int i = local_index_;
  char tag[96];
  std::snprintf(tag, sizeof(tag), "/%se%lld_g%d_", shm_prefix_.c_str(),
                static_cast<long long>(epoch_.load()), node_id_);
  // A crash DURING a previous wiring attempt on THIS host leaves named
  // segments behind; the group leader sweeps everything under the job
  // prefix that is not stamped with the current epoch (current-epoch
  // names are live peers mid-wiring and must survive the sweep).
  char keep[32];
  std::snprintf(keep, sizeof(keep), "e%lld_",
                static_cast<long long>(epoch_.load()));
  if (i == 0) ShmSweepStale(shm_prefix_, keep);
  const int64_t epoch = epoch_.load();
  const uint64_t cap = static_cast<uint64_t>(shm_ring_bytes_);
  auto name = [&](const char* kind, int idx, int ch) {
    char buf[160];
    if (ch >= 0) {
      std::snprintf(buf, sizeof(buf), "%s%s%d_c%d", tag, kind, idx, ch);
    } else {
      std::snprintf(buf, sizeof(buf), "%s%s%d", tag, kind, idx);
    }
    return std::string(buf);
  };
  shm_ring_tx_.clear();
  shm_ring_rx_.clear();
  shm_star_.clear();
  shm_ring_tx_.resize(num_channels_);
  shm_ring_rx_.resize(num_channels_);
  shm_star_.resize(i == 0 ? L : 1);
  // 1. Create everything this rank produces.
  for (int c = 0; c < num_channels_; ++c) {
    if (!shm_ring_tx_[c].Create(name("r", i, c), cap, epoch, err)) {
      return false;
    }
  }
  if (i == 0) {
    for (int m = 1; m < L; ++m) {
      if (!shm_star_[m].tx.Create(name("d", m, -1), cap, epoch, err)) {
        return false;
      }
    }
  } else {
    if (!shm_star_[0].tx.Create(name("u", i, -1), cap, epoch, err)) {
      return false;
    }
  }
  // 2. Attach everything this rank consumes (bounded by the rendezvous
  // timeout: a peer death mid-wiring surfaces as a clean init error).
  const int timeout_ms = rendezvous_timeout_sec_ * 1000;
  const int prev = (i - 1 + L) % L;
  for (int c = 0; c < num_channels_; ++c) {
    if (!shm_ring_rx_[c].Attach(name("r", prev, c), epoch, timeout_ms,
                                err)) {
      return false;
    }
  }
  if (i == 0) {
    for (int m = 1; m < L; ++m) {
      if (!shm_star_[m].rx.Attach(name("u", m, -1), epoch, timeout_ms,
                                  err)) {
        return false;
      }
    }
  } else {
    if (!shm_star_[0].rx.Attach(name("d", i, -1), epoch, timeout_ms, err)) {
      return false;
    }
  }
  // 3. Unlink-after-map: once the consumer confirmed its mapping the
  // filesystem name — the only thing a kill could leak — goes away.
  for (int c = 0; c < num_channels_; ++c) {
    if (!shm_ring_tx_[c].UnlinkAfterAttach(timeout_ms)) {
      *err = "peer never attached ring segment (died during wiring?)";
      return false;
    }
  }
  for (auto& e : shm_star_) {
    if (e.tx.valid() && !e.tx.UnlinkAfterAttach(timeout_ms)) {
      *err = "peer never attached star segment (died during wiring?)";
      return false;
    }
  }
  return true;
}

// Ring bookkeeping convention (vrank = position - 1): after a ring's
// reduce-scatter phase, (physical) position s owns fully-reduced
// segment s — so the RS half IS a first-class reducescatter (rank r
// keeps exactly its committed shard r), and segment s accumulates in
// ring order s+1, s+2, ..., s+N (mod N; outermost operand = position
// s's raw data).  Any CONSISTENT vrank assignment yields a correct
// allreduce — the choice only fixes the fold order — so the allgather
// phase and every parity anchor (transport, channels, star fold,
// two-level) follow this one convention.
Engine::RingSpec Engine::TcpRingSpec() {
  RingSpec spec;
  spec.vrank = (rank_ - 1 + size_) % size_;
  spec.rsize = size_;
  spec.span = "RING_CH";
  spec.ports.resize(num_channels_);
  for (int c = 0; c < num_channels_; ++c) {
    spec.ports[c].next = &ring_next_[c];
    spec.ports[c].prev = &ring_prev_[c];
  }
  spec.ring_id = RING_GLOBAL;
  spec.next_peer = (rank_ + 1) % size_;
  spec.prev_peer = (rank_ - 1 + size_) % size_;
  spec.seq = &link_seq_global_;
  return spec;
}

Engine::RingSpec Engine::ShmRingSpec() {
  RingSpec spec;
  spec.vrank = (local_index_ - 1 + group_size_) % group_size_;
  spec.rsize = group_size_;
  spec.span = "SHM_CH";
  spec.ports.resize(num_channels_);
  for (int c = 0; c < num_channels_; ++c) {
    spec.ports[c].shm_tx = &shm_ring_tx_[c];
    spec.ports[c].shm_rx = &shm_ring_rx_[c];
  }
  return spec;
}

Engine::RingSpec Engine::CrossRingSpec() {
  RingSpec spec;
  spec.vrank = (node_id_ - 1 + nnodes_) % nnodes_;
  spec.rsize = nnodes_;
  spec.span = "RING_CH";
  spec.ports.resize(num_channels_);
  for (int c = 0; c < num_channels_; ++c) {
    spec.ports[c].next = &cross_next_[c];
    spec.ports[c].prev = &cross_prev_[c];
  }
  spec.ring_id = RING_CROSS;
  spec.next_peer = group_leaders_[(node_id_ + 1) % nnodes_];
  spec.prev_peer = group_leaders_[(node_id_ - 1 + nnodes_) % nnodes_];
  spec.seq = &link_seq_cross_;
  return spec;
}

Engine::RingSpec Engine::FlatRingSpec() {
  // One host group spanning the whole committed world: every flat ring
  // edge is intra-host, so the shm rings carry it (group positions equal
  // committed ranks, so vrank/rsize — and therefore the segment fold
  // order — are IDENTICAL to the TCP spec's; transport never changes
  // bits).  Anything else flat runs over TCP.
  if (shm_ring_active_ && !two_level_ && group_size_ == size_) {
    return ShmRingSpec();
  }
  return TcpRingSpec();
}

std::string Engine::TransportError(const std::string& op,
                                   const std::string& name,
                                   const std::string& detail, int next_rank,
                                   int prev_rank) const {
  // SendRecvAll prefixes every peer-attributable error with the direction
  // that failed ("send"/"recv"); "link" means both directions stalled
  // (either neighbor could be the culprit).  Anything else (poll, local
  // resource errors) is a local failure — blaming a neighbor would send
  // the operator to the wrong machine's logs.
  if (detail.rfind("recv", 0) == 0) {
    return "rank " + std::to_string(prev_rank) + " disconnected during " +
           op + " of '" + name + "': " + detail;
  }
  if (detail.rfind("send", 0) == 0) {
    return "rank " + std::to_string(next_rank) + " disconnected during " +
           op + " of '" + name + "': " + detail;
  }
  if (detail.rfind("link", 0) == 0) {
    return "ring neighbor rank " + std::to_string(next_rank) + " or rank " +
           std::to_string(prev_rank) + " stalled during " + op + " of '" +
           name + "': " + detail;
  }
  return "local transport failure during " + op + " of '" + name +
         "': " + detail;
}

void Engine::BroadcastAbort(int culprit, const std::string& message) {
  abort_reason_ = message;
  std::fprintf(stderr, "horovod_tpu coordinator: %s\n", message.c_str());
  GlobalFlightRecorder().Record("abort", control_cycle_seq_,
                                "culprit=%d %s", culprit, message.c_str());
  ResponseList abort_list;
  abort_list.epoch = epoch_.load();
  abort_list.abort = true;
  abort_list.abort_rank = culprit;
  abort_list.abort_message = message;
  Writer w;
  SerializeResponseList(abort_list, &w);
  for (int r = 1; r < size_; ++r) {
    if (r == culprit || !worker_conns_[r].valid()) continue;
    // Best effort: a worker that died alongside the culprit just fails the
    // send; everyone reachable learns the culprit in one frame instead of
    // discovering the death via their own transport timeouts.
    worker_conns_[r].SendFrame(w.bytes());
  }
  // Hierarchical mode: rank 0's own group members read leader_conn_ (the
  // member_conns_ pair), not the direct worker conn the loop above wrote
  // — relay the verdict there too.  Other groups' members get it from
  // their leader, which receives this frame as its response.
  RelayToMembers(w.bytes());
}

// Epoch-gated control-frame read shared by every control gather point:
// rank 0 ← leaders (or ← workers on the flat path), leaders ← members.
bool Engine::RecvRequestListGated(Socket& conn, int patience,
                                  const char* who, RequestList* out,
                                  std::string* what) {
  for (int stale = 0;; ++stale) {
    std::vector<uint8_t> frame;
    if (!conn.RecvFrame(&frame, patience, who)) {
      *what = "lost";
      return false;
    }
    negotiation_bytes_rx_.fetch_add(static_cast<int64_t>(frame.size()) + 8);
    Reader reader(frame.data(), frame.size());
    if (!ParseRequestList(&reader, out)) {
      *what = "corrupt";
      return false;
    }
    if (out->epoch == epoch_.load()) return true;
    stale_epoch_msgs_.fetch_add(1);
    std::fprintf(stderr,
                 "horovod_tpu rank %d: dropped a stale %s (epoch %lld, "
                 "current epoch %lld)\n",
                 rank_, who, static_cast<long long>(out->epoch),
                 static_cast<long long>(epoch_.load()));
    *out = RequestList();
    if (stale >= 15) {
      *what = "stale-flood";
      return false;
    }
  }
}

void Engine::AggregateGroup(RequestList* agg) {
  AssertBackgroundThread();
  if (group_size_ <= 1) return;
  // Fold the leader's OWN hit bits through the same sub table as its
  // members' — a slot's bit goes up only when the whole group is ready,
  // the leader included (rank 0 counts GROUP grants, not rank grants).
  std::vector<uint32_t> own_hits;
  own_hits.swap(agg->cache_hits);
  auto note_hits = [&](const std::vector<uint32_t>& hits, int pos) {
    for (uint32_t slot : hits) {
      auto& sp = sub_slot_bits_[slot];
      if (sp.seen.empty()) {
        sp.seen.assign(group_size_, false);
        sp.first_seen = std::chrono::steady_clock::now();
      }
      if (!sp.seen[pos]) {
        sp.seen[pos] = true;
        sp.count++;
      }
    }
  };
  note_hits(own_hits, 0);
  std::set<uint32_t> evicts(agg->cache_evicts.begin(),
                            agg->cache_evicts.end());
  for (int m = 1; m < group_size_; ++m) {
    RequestList ml;
    std::string what;
    std::string who =
        "control frame from rank " + std::to_string(group_members_[m]);
    if (!member_conns_[m].valid() ||
        !RecvRequestListGated(member_conns_[m], control_patience_rounds_,
                              who.c_str(), &ml, &what)) {
      // Report the first dead member upward instead of failing the
      // cycle here: rank 0 broadcasts the abort naming the member, so
      // every rank — other groups included — gets the true culprit.
      if (agg->fail_rank < 0) {
        agg->fail_rank = group_members_[m];
        agg->fail_message =
            "sub-coordinator rank " + std::to_string(rank_) +
            " lost its group member rank " +
            std::to_string(group_members_[m]) +
            " — that process crashed, hung, or dropped its connection; "
            "check its logs. Aborting all ranks.";
      }
      continue;
    }
    if (ml.shutdown) agg->shutdown = true;
    if (ml.fail_rank >= 0 && agg->fail_rank < 0) {
      agg->fail_rank = ml.fail_rank;
      agg->fail_message = std::move(ml.fail_message);
    }
    for (auto& q : ml.requests) agg->requests.push_back(std::move(q));
    for (auto& te : ml.telem) agg->telem.push_back(std::move(te));
    for (uint32_t s : ml.cache_evicts) evicts.insert(s);
    note_hits(ml.cache_hits, m);
  }
  // Telemetry aggregation: SUM the group's TELEM deltas into ONE
  // per-host entry (deltas make this exact — each member's delta is
  // absorbed exactly once whether it traveled merged or alone), keep
  // the worst step-time gauge and its owning rank as the host's
  // slowest-member attribution.  Rank 0 thereby receives O(hosts)
  // telemetry bytes per telemetry cycle, same shape as the readiness
  // aggregation above.
  if (!agg->telem.empty()) {
    TelemEntry host;
    host.rank = rank_;
    host.host = node_id_;
    host.nranks = 0;
    host.deltas.assign(TC_COUNT, 0);
    for (const auto& te : agg->telem) {
      host.nranks += te.nranks;
      const size_t n = std::min<size_t>(te.deltas.size(), TC_COUNT);
      for (size_t i = 0; i < n; ++i) host.deltas[i] += te.deltas[i];
      if (te.step_p50 > host.step_p50) host.step_p50 = te.step_p50;
      if (te.step_p99 > host.step_p99) host.step_p99 = te.step_p99;
      if (te.slow_p99 >= host.slow_p99) {
        host.slow_p99 = te.slow_p99;
        host.slow_rank = te.slow_rank;
      }
    }
    agg->telem.assign(1, std::move(host));
  }
  agg->cache_evicts.assign(evicts.begin(), evicts.end());
  // A slot evicted this very cycle can never fire: drop its held bits
  // (the evict broadcast makes pending-hit members resubmit in full, so
  // nothing strands — and a freed id reassigned to a NEW tensor must not
  // inherit a stale group grant).
  for (uint32_t s : agg->cache_evicts) sub_slot_bits_.erase(s);
  for (auto it = sub_slot_bits_.begin(); it != sub_slot_bits_.end();) {
    if (it->second.count == group_size_) {
      agg->cache_hits.push_back(it->first);
      it = sub_slot_bits_.erase(it);
    } else {
      ++it;
    }
  }
}

bool Engine::RelayToMembers(const std::vector<uint8_t>& frame) {
  bool ok = true;
  for (int m = 1; m < static_cast<int>(member_conns_.size()); ++m) {
    if (!member_conns_[m].valid() || !member_conns_[m].SendFrame(frame)) {
      // Non-fatal: a member that died after reporting is detected by
      // the next cycle's gather (or by the collective's own transport
      // error) — the rest of the group still gets the frame.
      ok = false;
      continue;
    }
    negotiation_bytes_tx_.fetch_add(static_cast<int64_t>(frame.size()) + 8);
  }
  return ok;
}

void Engine::RelayAbortToMembers(const std::string& message) {
  if (member_conns_.empty()) return;
  ResponseList rl;
  rl.epoch = epoch_.load();
  rl.abort = true;
  rl.abort_rank = -1;
  rl.abort_message = message;
  Writer w;
  SerializeResponseList(rl, &w);
  RelayToMembers(w.bytes());
}

// Leader-side stall detection over held partial readiness bits (see
// engine.h): without it, a slot whose group never completes stalls
// SILENTLY under hierarchical coordination — the leader forwards
// nothing, so rank 0's detector sees count == 0 for it and skips.
void Engine::CheckForStalledSubBits() {
  if (stall_check_disabled_ || sub_slot_bits_.empty()) return;
  auto now = std::chrono::steady_clock::now();
  if (now - last_sub_stall_check_ <
      std::chrono::seconds(stall_warning_sec_)) {
    return;
  }
  last_sub_stall_check_ = now;
  AssertBackgroundThread();
  for (auto& kv : sub_slot_bits_) {
    if (kv.second.count == 0) continue;
    auto age = std::chrono::duration_cast<std::chrono::seconds>(
                   now - kv.second.first_seen)
                   .count();
    if (age < stall_warning_sec_) continue;
    std::string missing;
    for (int m = 0; m < group_size_ &&
                    m < static_cast<int>(kv.second.seen.size()); ++m) {
      if (!kv.second.seen[m]) {
        if (!missing.empty()) missing += ", ";
        missing += std::to_string(group_members_[m]);
      }
    }
    std::fprintf(stderr,
                 "horovod_tpu sub-coordinator rank %d (host %d): cached "
                 "slot %u has waited %llds for local ranks %s to "
                 "re-enqueue — a subset of this host's ranks is "
                 "submitting the tensor, which will cause deadlock.\n",
                 rank_, node_id_, kv.first, static_cast<long long>(age),
                 missing.c_str());
    stall_warnings_.fetch_add(1);
    GlobalFlightRecorder().Record(
        "stall", control_cycle_seq_, "sub slot=%u age=%llds missing=%s",
        kv.first, static_cast<long long>(age), missing.c_str());
  }
}

// ---------------------------------------------------------------------------
// Fleet telemetry (HOROVOD_TELEMETRY_CYCLES)
// ---------------------------------------------------------------------------

const char* const kTelemCounterNames[TC_COUNT] = {
    "data_bytes_tx",        "data_bytes_rx",
    "allreduce_bytes",      "reducescatter_bytes",
    "negotiation_bytes_tx", "negotiation_bytes_rx",
    "control_round_trips",  "cache_hits",
    "cache_misses",         "tensors",
    "responses",            "cycles",
    "shm_bytes_tx",         "compressed_bytes_tx",
    "wire_bytes_saved",     "backup_skips",
    "stale_epoch_msgs",     "stall_warnings",
    "priority_inversions",  "alltoall_bytes",
    "moe_tokens_dropped",
};

TelemEntry Engine::BuildTelemEntry() {
  AssertBackgroundThread();
  TelemEntry t;
  t.rank = rank_;
  t.host = node_id_;
  t.nranks = 1;
  t.step_p50 = step_time_ns_p50();
  t.step_p99 = step_time_ns_p99();
  t.slow_rank = rank_;
  t.slow_p99 = t.step_p99;
  const int64_t cur[TC_COUNT] = {
      data_bytes_tx_.load(),        data_bytes_rx_.load(),
      allreduce_bytes_.load(),      reducescatter_bytes_.load(),
      negotiation_bytes_tx_.load(), negotiation_bytes_rx_.load(),
      control_round_trips_.load(),  cache_hits_.load(),
      cache_misses_.load(),         tensors_executed_.load(),
      responses_executed_.load(),   exec_cycles_.load(),
      shm_bytes_tx_.load(),         compressed_bytes_tx_.load(),
      wire_bytes_saved_.load(),     backup_skips_.load(),
      stale_epoch_msgs_.load(),     stall_warnings_.load(),
      priority_inversions_.load(),  alltoall_bytes_.load(),
      moe_tokens_dropped_.load(),
  };
  t.deltas.resize(TC_COUNT);
  for (int i = 0; i < TC_COUNT; ++i) {
    t.deltas[i] = cur[i] - telem_last_[i];
    telem_last_[i] = cur[i];
  }
  return t;
}

void Engine::MaybeAttachTelem(RequestList* list, bool force) {
  if (telemetry_cycles_ <= 0) return;
  ++telem_cycle_count_;
  if (!force && telem_cycle_count_ % telemetry_cycles_ != 0) return;
  list->telem.push_back(BuildTelemEntry());
}

void Engine::FleetAbsorb(const TelemEntry& t) {
  std::lock_guard<std::mutex> lk(fleet_mu_);
  FleetRow& row = fleet_rows_[t.rank];
  row.nranks = t.nranks;
  row.host = t.host;
  const size_t n = std::min<size_t>(t.deltas.size(), TC_COUNT);
  for (size_t i = 0; i < n; ++i) row.counters[i] += t.deltas[i];
  row.step_p50 = t.step_p50;
  row.step_p99 = t.step_p99;
  row.slow_rank = t.slow_rank;
  row.slow_p99 = t.slow_p99;
  row.updates++;
  row.last_update_mono_ns =
      std::chrono::duration_cast<std::chrono::nanoseconds>(
          std::chrono::steady_clock::now().time_since_epoch())
          .count();
}

std::string Engine::FleetJson() const {
  std::lock_guard<std::mutex> lk(fleet_mu_);
  std::string out;
  out.reserve(1024 + fleet_rows_.size() * 640);
  char buf[256];
  auto num = [&](const char* key, long long v, bool comma = true) {
    std::snprintf(buf, sizeof(buf), "\"%s\": %lld%s", key, v,
                  comma ? ", " : "");
    out += buf;
  };
  out += "{";
  num("ranks_reporting", static_cast<long long>(fleet_rows_.size()));
  num("world_size", size_);
  num("hosts", nnodes_);
  num("epoch", static_cast<long long>(epoch_.load()));
  num("telemetry_cycles", static_cast<long long>(telemetry_cycles_));
  num("quorum_lag_ns_p50",
      static_cast<long long>(QuorumLagNsPercentile(0.50)));
  num("quorum_lag_ns_p99",
      static_cast<long long>(QuorumLagNsPercentile(0.99)));
  // Slowest-rank attribution across every row's gauge.
  int32_t slow_rank = -1;
  int64_t slow_p99 = 0;
  int64_t totals[TC_COUNT] = {0};
  for (const auto& kv : fleet_rows_) {
    for (int i = 0; i < TC_COUNT; ++i) totals[i] += kv.second.counters[i];
    if (kv.second.slow_p99 >= slow_p99) {
      slow_p99 = kv.second.slow_p99;
      slow_rank = kv.second.slow_rank;
    }
  }
  out += "\"slowest\": {";
  num("rank", slow_rank);
  num("step_time_ns_p99", static_cast<long long>(slow_p99), false);
  out += "}, \"totals\": {";
  for (int i = 0; i < TC_COUNT; ++i) {
    num(kTelemCounterNames[i], static_cast<long long>(totals[i]),
        i + 1 < TC_COUNT);
  }
  out += "}, \"quorum_lag_by_rank\": {";
  {
    bool first = true;
    for (const auto& kv : quorum_attr_) {
      if (!first) out += ", ";
      first = false;
      std::snprintf(buf, sizeof(buf),
                    "\"%d\": {\"attributions\": %lld, \"max_ns\": %lld}",
                    kv.first, static_cast<long long>(kv.second.count),
                    static_cast<long long>(kv.second.max_ns));
      out += buf;
    }
  }
  out += "}, \"rows\": [";
  bool first = true;
  for (const auto& kv : fleet_rows_) {
    if (!first) out += ", ";
    first = false;
    out += "{";
    num("rank", kv.first);
    num("nranks", kv.second.nranks);
    num("host", kv.second.host);
    num("updates", static_cast<long long>(kv.second.updates));
    num("step_time_ns_p50", static_cast<long long>(kv.second.step_p50));
    num("step_time_ns_p99", static_cast<long long>(kv.second.step_p99));
    num("slow_rank", kv.second.slow_rank);
    num("slow_step_ns_p99", static_cast<long long>(kv.second.slow_p99));
    num("last_update_mono_ns",
        static_cast<long long>(kv.second.last_update_mono_ns));
    out += "\"counters\": {";
    for (int i = 0; i < TC_COUNT; ++i) {
      num(kTelemCounterNames[i],
          static_cast<long long>(kv.second.counters[i]), i + 1 < TC_COUNT);
    }
    out += "}}";
  }
  out += "]}";
  return out;
}

int64_t Engine::fleet_rows() const {
  std::lock_guard<std::mutex> lk(fleet_mu_);
  return static_cast<int64_t>(fleet_rows_.size());
}

void Engine::NoteQuorumLag(
    const std::vector<std::chrono::steady_clock::time_point>& times,
    const std::vector<int>& voter_ranks) {
  if (times.size() < 2 || times.size() != voter_ranks.size()) return;
  // Last voter and second-to-last: one pass, no sort.
  size_t last = 0;
  for (size_t i = 1; i < times.size(); ++i) {
    if (times[i] > times[last]) last = i;
  }
  auto second = std::chrono::steady_clock::time_point::min();
  for (size_t i = 0; i < times.size(); ++i) {
    if (i != last && times[i] > second) second = times[i];
  }
  const int64_t lag =
      std::chrono::duration_cast<std::chrono::nanoseconds>(times[last] -
                                                           second)
          .count();
  {
    std::lock_guard<std::mutex> lk(quorum_mu_);
    constexpr size_t kCap = 4096;
    if (quorum_lag_samples_.size() < kCap) {
      quorum_lag_samples_.push_back(lag);
    } else {
      quorum_lag_samples_[quorum_lag_next_ % kCap] = lag;
    }
    ++quorum_lag_next_;
  }
  std::lock_guard<std::mutex> lk(fleet_mu_);
  QuorumAttr& attr = quorum_attr_[voter_ranks[last]];
  attr.count++;
  if (lag > attr.max_ns) attr.max_ns = lag;
}

void Engine::NoteSkippedQuorumLag(int64_t lag_ns) {
  std::lock_guard<std::mutex> lk(quorum_mu_);
  constexpr size_t kCap = 4096;
  if (quorum_lag_samples_.size() < kCap) {
    quorum_lag_samples_.push_back(lag_ns);
  } else {
    quorum_lag_samples_[quorum_lag_next_ % kCap] = lag_ns;
  }
  ++quorum_lag_next_;
}

int64_t Engine::QuorumLagNsPercentile(double p) const {
  std::vector<int64_t> snap;
  {
    std::lock_guard<std::mutex> lk(quorum_mu_);
    snap = quorum_lag_samples_;
  }
  if (snap.empty()) return 0;
  size_t idx = static_cast<size_t>(p * (snap.size() - 1) + 0.5);
  if (idx >= snap.size()) idx = snap.size() - 1;
  std::nth_element(snap.begin(), snap.begin() + idx, snap.end());
  return snap[idx];
}

void Engine::RecordCoordCycleNs(int64_t ns) {
  std::lock_guard<std::mutex> lk(cycle_ns_mu_);
  constexpr size_t kCap = 4096;
  if (cycle_ns_samples_.size() < kCap) {
    cycle_ns_samples_.push_back(ns);
  } else {
    cycle_ns_samples_[cycle_ns_next_ % kCap] = ns;
  }
  ++cycle_ns_next_;
}

int64_t Engine::CoordCycleNsPercentile(double p) const {
  std::vector<int64_t> snap;
  {
    std::lock_guard<std::mutex> lk(cycle_ns_mu_);
    snap = cycle_ns_samples_;
  }
  if (snap.empty()) return 0;
  size_t idx = static_cast<size_t>(p * (snap.size() - 1) + 0.5);
  if (idx >= snap.size()) idx = snap.size() - 1;
  std::nth_element(snap.begin(), snap.begin() + idx, snap.end());
  return snap[idx];
}

// "Did this control frame carry negotiation payload?" — the shared rule
// behind control_round_trips_ on coordinator and workers (idle heartbeat
// exchanges don't count; see engine.h).  Any new wire field that carries
// work belongs here, or the stat skews between rank 0 and workers.
static bool HasPayload(const RequestList& l) {
  return !l.requests.empty() || !l.cache_hits.empty() ||
         !l.cache_evicts.empty() || l.shutdown || l.fail_rank >= 0;
}

static bool HasPayload(const ResponseList& l) {
  return !l.responses.empty() || !l.cached_slots.empty() ||
         !l.evict_slots.empty() || l.shutdown || l.abort || l.tune;
}

bool Engine::RunLoopOnce() {
  if (fault_hang_.load()) {
    // Injected wedge: stay alive but stop cycling.  Control frames cease;
    // peers must detect the hang via HOROVOD_FAULT_TIMEOUT_SEC /
    // HOROVOD_CONTROL_PATIENCE_SEC, exactly like a real stuck process.
    // Same event-driven primitive as the cycle gate below (no fixed
    // sleep anywhere in the loop), with no predicate: a wedge ignores
    // enqueues and shutdown by design, it only stops burning a fixed
    // 100 ms floor per poll when something else wakes the cv.
    std::unique_lock<std::mutex> lk(mu_);
    cycle_cv_.wait_for(lk, std::chrono::milliseconds(100));
    return true;
  }
  if (fault_drop_.load()) {
    abort_reason_ =
        "fault injection: dropped all connections (HOROVOD_FAULT_INJECT)";
    CloseSockets();  // abrupt: no shutdown handshake, peers see raw EOF
    return false;
  }
  // Event-driven cycle gate (replaces the unconditional
  // sleep_for(cycle_time_ms_)): wake the instant work is enqueued, or
  // after cycle_time_ms_ as an idle heartbeat so peers' control frames
  // keep flowing.  HOROVOD_CYCLE_TIME is thereby an UPPER bound on
  // negotiation latency instead of a floor under it — a single eager
  // allreduce negotiates in one control round trip, not in >= 5 ms.
  {
    std::unique_lock<std::mutex> lk(mu_);
    cycle_cv_.wait_for(lk, std::chrono::milliseconds(cycle_time_ms_.load()),
                       [&] {
      return !message_queue_.empty() || shutdown_requested_.load() ||
             tune_pending_.load() ||  // idle world ships TUNE promptly
             fault_hang_.load() || fault_drop_.load();
    });
  }
  if (fault_hang_.load() || fault_drop_.load()) return true;  // next pass

  // Idle high-water release: no collective for a while ⇒ hand the fusion
  // scratch back to the allocator (steady-state training re-executes
  // every few ms and never hits this).
  MaybeReleaseScratch();

  // Elastic rejoin: a candidate knocking on the control listener aborts
  // this world so the next rendezvous can admit it (checked before the
  // size-1 fast path — a world shrunk to one must still grow back).
  if (PollJoinCandidate()) return false;

  RequestList my_list;
  DrainMessageQueue(&my_list);
  my_list.epoch = epoch_.load();
  my_list.shutdown = shutdown_requested_.load();
  // Fleet telemetry rides the regular control frame (idle heartbeats
  // included, so a quiesced fleet's counters still converge); the
  // shutdown frame force-flushes the final deltas.
  MaybeAttachTelem(&my_list, my_list.shutdown);

  if (size_ == 1) {
    for (const auto& te : my_list.telem) FleetAbsorb(te);
    my_list.telem.clear();
    // Single process: every tensor is instantly "globally ready".
    AssertBackgroundThread();
    for (auto& q : my_list.requests) {
      timeline_.NegotiateStart(q.tensor_name);
      timeline_.NegotiateRankReady(q.tensor_name, 0);
      auto& info = message_table_[q.tensor_name];
      info.requests.assign(1, q);
      info.seen.assign(1, true);
      info.count = 1;
    }
    std::vector<Response> responses;
    for (auto& q : my_list.requests) {
      timeline_.NegotiateEnd(q.tensor_name);
      responses.push_back(BuildResponse(q.tensor_name));
      if (responses.back().type != ResponseType::ERROR) {
        timeline_.FlowSend(q.tensor_name, epoch_.load());
      }
    }
    if (priority_bands_.load() > 0) OrderResponsesByPriority(responses);
    FuseResponses(responses);
    CountPriorityInversions(responses, {});
    if (!responses.empty()) exec_cycles_.fetch_add(1);
    ExecuteResponses(responses);
    // World of one: no frame flows, so drain + apply the pending TUNE
    // locally at the same between-cycles point the wire path uses.
    ResponseList local_tune;
    if (DrainPendingTune(&local_tune)) ApplyTune(local_tune);
    return !my_list.shutdown;
  }

  if (rank_ == 0) {
    const auto cyc0 = std::chrono::steady_clock::now();
    const bool hier = HierActive();
    // A peer's next frame only arrives after it finished executing the
    // previous cycle's collectives, which can legitimately span several
    // socket-timeout rounds on slow links — hence the idle allowance,
    // bounded by HOROVOD_CONTROL_PATIENCE_SEC rather than scaling with
    // world size (a crashed peer still fails immediately via
    // EOF/keepalive).
    //
    // Hierarchical coordination: rank 0 gathers ONE aggregated frame per
    // host group (its own group's members folded in via AggregateGroup)
    // instead of one per rank — the control plane's per-cycle work and
    // bytes scale with hosts, not ranks.  The epoch gate is inside
    // RecvRequestListGated either way.
    std::vector<RequestList> lists(hier ? nnodes_ : size_);
    lists[0] = std::move(my_list);
    if (hier) AggregateGroup(&lists[0]);
    for (int v = 1; v < static_cast<int>(lists.size()); ++v) {
      const int peer = hier ? group_leaders_[v] : v;
      std::string what;
      std::string who = "control frame from rank " + std::to_string(peer);
      if (!RecvRequestListGated(worker_conns_[peer],
                                control_patience_rounds_, who.c_str(),
                                &lists[v], &what)) {
        BroadcastAbort(
            peer,
            what == "corrupt"
                ? ("coordinator received a corrupt control frame from "
                   "rank " + std::to_string(peer) + ". Aborting all ranks.")
            : what == "stale-flood"
                ? ("rank " + std::to_string(peer) +
                   " keeps sending control frames from a stale membership "
                   "epoch. Aborting all ranks.")
                : ("coordinator lost connection to rank " +
                   std::to_string(peer) +
                   " — that process crashed, hung, or dropped its "
                   "connection; check its logs. Aborting all ranks."));
        return false;
      }
    }
    // A sub-coordinator that lost one of its members reports the culprit
    // in its aggregate; the abort broadcast names the member, not the
    // leader that noticed.
    for (auto& l : lists) {
      if (l.fail_rank >= 0) {
        BroadcastAbort(l.fail_rank,
                       l.fail_message.empty()
                           ? ("rank " + std::to_string(l.fail_rank) +
                              " failed. Aborting all ranks.")
                           : l.fail_message);
        return false;
      }
    }
    // Fold every gathered TELEM entry (rank 0's own included — its
    // frame never hits the wire but carries the entry all the same)
    // into the fleet table.
    for (auto& l : lists) {
      for (const auto& te : l.telem) FleetAbsorb(te);
    }
    ResponseList response_list = CoordinatorStep(lists);
    // Piggyback a queued autotune proposal on this cycle's broadcast;
    // every rank (the coordinator included) applies it after executing
    // the cycle's responses, so the knobs flip atomically between
    // cycles on the whole world.
    DrainPendingTune(&response_list);
    // Slots the coordinator evicted beyond the gathered evict lists
    // (full-request-implies-evict): drop any readiness bits this
    // sub-coordinator still holds for them — a freed id reassigned to a
    // new tensor must not inherit a stale group grant.
    if (hier) {
      for (uint32_t s : response_list.evict_slots) sub_slot_bits_.erase(s);
      // A partially committed slot's held bits are stale: the skipped
      // group's ready members just had their entries finished "skipped"
      // and will re-report fresh hit bits for their NEXT step.
      for (const auto& ps : response_list.partial_slots) {
        sub_slot_bits_.erase(ps.slot);
      }
    }
    Writer w;
    SerializeResponseList(response_list, &w);
    const int nsends = hier ? nnodes_ : size_;
    for (int v = 1; v < nsends; ++v) {
      const int peer = hier ? group_leaders_[v] : v;
      if (!worker_conns_[peer].SendFrame(w.bytes())) {
        BroadcastAbort(
            peer, "coordinator could not reach rank " +
                      std::to_string(peer) +
                      " — that process likely crashed; check its logs. "
                      "Aborting all ranks.");
        return false;
      }
      negotiation_bytes_tx_.fetch_add(
          static_cast<int64_t>(w.bytes().size()) + 8);
    }
    // Hier: rank 0 is its own group's sub-coordinator — relay the frame
    // down to its local members exactly like every other leader.
    if (hier) RelayToMembers(w.bytes());
    // Count NEGOTIATION round trips only — cycles where some rank shipped
    // requests/hit-bits/evicts or the frame carried work back.  Idle
    // heartbeats (empty frames while every rank computes) would otherwise
    // drown the per-step signal bench and CI gate on.
    bool carried_payload = HasPayload(response_list);
    for (size_t v = 0; v < lists.size() && !carried_payload; ++v) {
      carried_payload = HasPayload(lists[v]);
    }
    if (carried_payload) {
      control_round_trips_.fetch_add(1);
      // Control-plane cycle time: gather + negotiate + distribute, the
      // quantity the big-world scale harness tracks against world size
      // (execution below is data-plane time, excluded on purpose).
      RecordCoordCycleNs(
          std::chrono::duration_cast<std::chrono::nanoseconds>(
              std::chrono::steady_clock::now() - cyc0)
              .count());
      ++control_cycle_seq_;
      size_t nreq = 0;
      for (const auto& l : lists) nreq += l.requests.size();
      GlobalFlightRecorder().Record(
          "cycle", control_cycle_seq_,
          "reqs=%zu resp=%zu cached=%zu evict=%zu partial=%zu", nreq,
          response_list.responses.size(),
          response_list.cached_slots.size(),
          response_list.evict_slots.size(),
          response_list.partial_slots.size());
    }
    // The coordinator is a cache participant like any worker: update the
    // local replica from the list it just broadcast, execute the fully
    // negotiated responses, then the agreed cached slots.
    ApplyCacheUpdates(response_list);
    // Apply a TUNE BEFORE executing this cycle's responses, not after:
    // execution wakes API threads the moment a tensor finishes
    // (FinishEntry), and an enqueue racing a post-execution apply could
    // resolve its wire dtype from the not-yet-flipped knob on one rank
    // and the flipped one on another — a clean negotiated mismatch, but
    // a failed step (a rare-but-real flake of the live wire sweep).
    // This point is equally atomic: every rank applies the same frame
    // at the same cycle boundary with no response in flight, and this
    // cycle's responses execute under the NEW knobs on every rank alike
    // (their wire formats were committed per response at negotiation;
    // chunk/wave/algo knobs flip identically everywhere).
    if (response_list.tune) ApplyTune(response_list);
    bool executed_any = false;
    if (!DispatchCycleResponses(response_list, &executed_any)) return false;
    if (executed_any) exec_cycles_.fetch_add(1);
    if (!stall_check_disabled_) CheckForStalledTensors();
    if (hier) CheckForStalledSubBits();  // rank 0 leads group 0 too
    return !response_list.shutdown;
  }

  // Non-coordinator ranks.  Three roles:
  //   * flat worker       — ship requests to rank 0, execute its response
  //   * hier group leader — aggregate the group's frames, ship ONE frame
  //     to rank 0, relay the response down verbatim, then execute
  //   * hier member       — ship requests to the group leader, execute
  //     the relayed response
  // The leader aggregates BEFORE sending (one frame carries the whole
  // group), and relays BEFORE executing (members start their data-plane
  // work in the same wave as the leader).
  const bool leader = HierActive() && IsGroupLeader();
  const bool member = HierActive() && !IsGroupLeader();
  if (leader) AggregateGroup(&my_list);
  Socket& up = member ? leader_conn_ : coordinator_conn_;
  const std::string lost_upstream =
      member ? ("lost connection to the sub-coordinator (rank " +
                std::to_string(group_members_[0]) +
                ") — it crashed, or the world is aborting; check rank " +
                std::to_string(group_members_[0]) + "'s and rank 0's logs.")
             : "lost connection to the coordinator (rank 0) — it likely "
               "crashed or another rank failed; check rank 0's logs.";
  // A member that lost its leader may still salvage the REAL verdict:
  // rank 0 broadcasts aborts DIRECTLY to every rank's rendezvous conn
  // (BroadcastAbort), so the culprit-naming frame is (or shortly will
  // be) in coordinator_conn_'s buffer even though the relay path died.
  auto salvage_abort = [&](bool wait_direct) {
    std::vector<uint8_t> frame;
    ResponseList rl;
    if (up.valid() && up.RecvFrame(&frame)) {
      Reader r(frame.data(), frame.size());
      if (ParseResponseList(&r, &rl) && rl.abort) {
        abort_reason_ = rl.abort_message;
        return;
      }
    }
    if (member && coordinator_conn_.valid() &&
        (!wait_direct || WaitReadable(coordinator_conn_, 3000))) {
      frame.clear();
      if (coordinator_conn_.RecvFrame(&frame)) {
        Reader r(frame.data(), frame.size());
        rl = ResponseList();
        if (ParseResponseList(&r, &rl) && rl.abort) {
          abort_reason_ = rl.abort_message;
        }
      }
    }
  };
  // Telemetry wire accounting: what the TELEM piggyback itself costs on
  // this rank's upstream frame (leaders count their merged entry once).
  if (!my_list.telem.empty()) {
    Writer tw;
    for (const auto& te : my_list.telem) SerializeTelemEntry(te, &tw);
    telem_bytes_tx_.fetch_add(static_cast<int64_t>(tw.bytes().size()) + 2);
  }
  Writer w;
  SerializeRequestList(my_list, &w);
  if (fault_stale_epoch_.exchange(false)) {
    // Injected dead-incarnation replay (HOROVOD_FAULT_INJECT
    // kind=stale-epoch): the same payload stamped with the PREVIOUS epoch
    // precedes the real frame; the receiver must drop and count it
    // (stale_epoch_msgs) and negotiate from the genuine frame only.
    RequestList ghost = my_list;
    ghost.epoch = my_list.epoch - 1;
    Writer gw;
    SerializeRequestList(ghost, &gw);
    up.SendFrame(gw.bytes());
  }
  negotiation_bytes_tx_.fetch_add(static_cast<int64_t>(w.bytes().size()) + 8);
  if (!up.SendFrame(w.bytes())) {
    salvage_abort(/*wait_direct=*/false);
    if (abort_reason_.empty()) abort_reason_ = lost_upstream;
    if (leader) RelayAbortToMembers(abort_reason_);
    std::fprintf(stderr, "horovod_tpu rank %d: %s\n", rank_,
                 abort_reason_.c_str());
    return false;
  }
  ResponseList response_list;
  std::vector<uint8_t> accepted_frame;
  // Epoch gate, downstream side: a response frame — including an abort
  // verdict — stamped with a different membership epoch is a dead
  // incarnation's delayed message; drop, count, read the next frame.
  // The member's allowance exceeds the leader's (which exceeds the
  // coordinator's): each relay hop must out-wait the one above it so the
  // most-informative verdict wins the race.
  const int up_patience =
      member ? worker_patience_rounds_ + control_patience_rounds_
             : worker_patience_rounds_;
  const char* up_label = member
      ? "response frame from the sub-coordinator"
      : "response frame from the coordinator (rank 0)";
  for (int stale = 0;; ++stale) {
    std::vector<uint8_t> frame;
    if (!up.RecvFrame(&frame, up_patience, up_label)) {
      salvage_abort(/*wait_direct=*/true);
      if (abort_reason_.empty()) abort_reason_ = lost_upstream;
      if (leader) RelayAbortToMembers(abort_reason_);
      std::fprintf(stderr, "horovod_tpu rank %d: %s\n", rank_,
                   abort_reason_.c_str());
      return false;
    }
    negotiation_bytes_rx_.fetch_add(static_cast<int64_t>(frame.size()) + 8);
    Reader reader(frame.data(), frame.size());
    if (!ParseResponseList(&reader, &response_list)) {
      abort_reason_ = "corrupt control frame from upstream.";
      if (leader) RelayAbortToMembers(abort_reason_);
      std::fprintf(stderr, "horovod_tpu rank %d: bad response frame\n",
                   rank_);
      return false;
    }
    if (response_list.epoch == epoch_.load()) {
      accepted_frame = std::move(frame);
      break;
    }
    stale_epoch_msgs_.fetch_add(1);
    std::fprintf(stderr,
                 "horovod_tpu rank %d: dropped a stale response frame "
                 "(epoch %lld, current epoch %lld)\n",
                 rank_, static_cast<long long>(response_list.epoch),
                 static_cast<long long>(epoch_.load()));
    response_list = ResponseList();
    if (stale >= 15) {
      abort_reason_ = "upstream keeps sending control frames from a "
                      "stale membership epoch.";
      if (leader) RelayAbortToMembers(abort_reason_);
      std::fprintf(stderr, "horovod_tpu rank %d: %s\n", rank_,
                   abort_reason_.c_str());
      return false;
    }
  }
  // Leader: relay the accepted frame verbatim — identical bytes, so
  // members parse exactly what rank 0 serialized (aborts, TUNE payloads
  // and shutdown flags included) — BEFORE processing it locally.
  if (leader) {
    RelayToMembers(accepted_frame);
    // Evicted slots drop any readiness bits still held in the sub table
    // (see AggregateGroup): pending-hit members resubmit on this very
    // frame, so nothing strands and no stale grant survives.
    for (uint32_t s : response_list.evict_slots) sub_slot_bits_.erase(s);
    // Same for partially committed slots: held bits from the skipped
    // step must not count toward the next step's group grant.
    for (const auto& ps : response_list.partial_slots) {
      sub_slot_bits_.erase(ps.slot);
    }
  }
  if (response_list.abort) {
    // Coordinator-initiated collective abort: another rank failed.
    abort_reason_ = response_list.abort_message.empty()
        ? ("coordinator aborted the job: rank " +
           std::to_string(response_list.abort_rank) + " failed")
        : response_list.abort_message;
    std::fprintf(stderr, "horovod_tpu rank %d: %s\n", rank_,
                 abort_reason_.c_str());
    return false;
  }
  // Negotiation round trips only (same HasPayload rule as the
  // coordinator): idle heartbeat exchanges are not counted.
  if (HasPayload(my_list) || HasPayload(response_list)) {
    control_round_trips_.fetch_add(1);
    ++control_cycle_seq_;
    GlobalFlightRecorder().Record(
        "cycle", control_cycle_seq_,
        "reqs=%zu hits=%zu resp=%zu cached=%zu evict=%zu",
        my_list.requests.size(), my_list.cache_hits.size(),
        response_list.responses.size(), response_list.cached_slots.size(),
        response_list.evict_slots.size());
  }
  ApplyCacheUpdates(response_list);
  // TUNE before execution — same reasoning (and the same ordering) as
  // the coordinator path above: a completion-woken enqueue must never
  // read a pre-TUNE knob after a peer already applied it.
  if (response_list.tune) ApplyTune(response_list);
  bool executed_any = false;
  if (!DispatchCycleResponses(response_list, &executed_any)) return false;
  if (executed_any) exec_cycles_.fetch_add(1);
  if (leader) CheckForStalledSubBits();
  return !response_list.shutdown;
}

// ---------------------------------------------------------------------------
// Online autotune (TUNE broadcast)
// ---------------------------------------------------------------------------

int Engine::QueueTune(int64_t chunk_bytes, int64_t fusion_threshold,
                      int64_t cycle_time_ms, int64_t wave_width,
                      int64_t algo_threshold, int64_t wire_dtype,
                      int64_t priority_bands,
                      const std::vector<int64_t>& fusion_ladder,
                      bool commit) {
  if (!initialized_.load() || shut_down_.load()) return -1;
  // Only the coordinator may propose: TUNE rides its response broadcast.
  if (size_ > 1 && rank_ != 0) return -1;
  std::lock_guard<std::mutex> lk(tune_mu_);
  pending_tune_.trial_id = tune_trial_seq_.fetch_add(1) + 1;
  pending_tune_.chunk_bytes = chunk_bytes;
  pending_tune_.fusion_threshold = fusion_threshold;
  pending_tune_.cycle_time_ms = static_cast<int32_t>(cycle_time_ms);
  pending_tune_.wave_width = static_cast<int32_t>(wave_width);
  pending_tune_.algo_threshold = algo_threshold;
  pending_tune_.wire_dtype = static_cast<int32_t>(wire_dtype);
  pending_tune_.priority_bands = priority_bands;
  // Clamp to the engine's ladder capacity BEFORE the wire: the frame
  // parser rejects oversized ladders as corrupt (a whole-world abort),
  // and entries past kFusionLadderMax could never apply anyway.
  pending_tune_.fusion_ladder = fusion_ladder;
  if (pending_tune_.fusion_ladder.size() >
      static_cast<size_t>(kFusionLadderMax)) {
    pending_tune_.fusion_ladder.resize(kFusionLadderMax);
  }
  pending_tune_.commit = commit;
  tune_pending_.store(true);
  cycle_cv_.notify_one();  // an idle world still ships the frame promptly
  return 0;
}

bool Engine::DrainPendingTune(ResponseList* out) {
  std::lock_guard<std::mutex> lk(tune_mu_);
  if (!tune_pending_.load()) return false;
  out->tune = true;
  out->tune_commit = pending_tune_.commit;
  out->tune_trial_id = pending_tune_.trial_id;
  out->tune_chunk_bytes = pending_tune_.chunk_bytes;
  out->tune_fusion_threshold = pending_tune_.fusion_threshold;
  out->tune_cycle_time_ms = pending_tune_.cycle_time_ms;
  out->tune_wave_width = pending_tune_.wave_width;
  out->tune_algo_threshold = pending_tune_.algo_threshold;
  out->tune_wire_dtype = pending_tune_.wire_dtype;
  out->tune_priority_bands = pending_tune_.priority_bands;
  out->tune_fusion_ladder = pending_tune_.fusion_ladder;
  tune_pending_.store(false);
  return true;
}

void Engine::ApplyTune(const ResponseList& list) {
  // Runs between cycles on the background thread of every rank, BEFORE
  // the carrying cycle's responses execute — no collective is in
  // flight, so the knob flip can never split one op across configs,
  // and a completion-woken enqueue can never read a pre-TUNE knob a
  // peer already flipped (the wire-dtype race the live sweep test
  // caught).  Clamps mirror Init exactly: every rank computes identical
  // effective values from the identical broadcast.
  if (list.tune_chunk_bytes > 0) {
    int64_t chunk = std::max<int64_t>(4096, list.tune_chunk_bytes);
    chunk_bytes_.store(chunk & ~int64_t{7});
  }
  if (list.tune_fusion_threshold > 0) {
    fusion_threshold_.store(list.tune_fusion_threshold);
  }
  if (list.tune_cycle_time_ms > 0) {
    cycle_time_ms_.store(std::max(1, static_cast<int>(
        list.tune_cycle_time_ms)));
  }
  if (list.tune_wave_width > 0) {
    wave_width_.store(std::min(16, std::max(1, static_cast<int>(
        list.tune_wave_width))));
  }
  // 0 is a REAL value for the algorithm crossover (small path off), so
  // "leave unchanged" is < 0 — matching the Init clamp (negatives → 0).
  if (list.tune_algo_threshold >= 0) {
    algo_threshold_.store(list.tune_algo_threshold);
  }
  // Same convention for the wire knob: 0 (fp32) is real, < 0 unchanged.
  // The new default governs enqueues AFTER this boundary; anything
  // already negotiated keeps its committed wire format, and the
  // signature change evicts the affected cache slots on first re-use.
  if (list.tune_wire_dtype >= 0 && list.tune_wire_dtype <= 4) {
    wire_dtype_.store(static_cast<int>(list.tune_wire_dtype));
  }
  // Priority band width (0 real = bands off, < 0 unchanged) — applied
  // at the same between-cycles boundary as every other knob, so the
  // whole world flips its response ordering atomically.  NOTE: the
  // Python side gates priority STAMPING on bands>0, so a live flip can
  // race one step's enqueue-time sampling across ranks (one rank stamps
  // before applying, a peer after) — that surfaces as the clean
  // "Mismatched priorities" error, never a garbled dispatch, and the
  // autotuner never sweeps this knob (only the per-band ladder, which
  // cannot change stamping).
  if (list.tune_priority_bands >= 0) {
    priority_bands_.store(
        std::min<int64_t>(1 << 20, list.tune_priority_bands));
  }
  // Per-band fusion-threshold ladder: positive entries overwrite their
  // band's threshold; <= 0 leaves the band unchanged.
  for (size_t b = 0;
       b < list.tune_fusion_ladder.size() &&
       b < static_cast<size_t>(kFusionLadderMax);
       ++b) {
    if (list.tune_fusion_ladder[b] > 0) {
      fusion_ladder_[b].store(list.tune_fusion_ladder[b]);
    }
  }
  tune_trials_.fetch_add(1);
  char desc[256];
  std::snprintf(desc, sizeof(desc),
                "chunk=%lld,fusion=%lld,cycle=%d,wave=%d,algo=%lld,wire=%s,"
                "bands=%lld",
                static_cast<long long>(chunk_bytes_.load()),
                static_cast<long long>(fusion_threshold_.load()),
                cycle_time_ms_.load(), wave_width_.load(),
                static_cast<long long>(algo_threshold_.load()),
                WireDtypeName(static_cast<WireDtype>(wire_dtype_.load())),
                static_cast<long long>(priority_bands_.load()));
  timeline_.TuneTrial(desc, list.tune_commit);
  GlobalFlightRecorder().Record("tune", control_cycle_seq_, "%s%s", desc,
                                list.tune_commit ? " (commit)" : "");
}

// Request types whose responses are pure functions of the validated
// cross-rank signature — safe to replay from the cache.  ALLGATHER is
// excluded: its response embeds every rank's RUNTIME dim-0, renegotiated
// each step.
static bool IsCacheableType(RequestType t) {
  return t == RequestType::ALLREDUCE || t == RequestType::BROADCAST ||
         t == RequestType::REDUCESCATTER || t == RequestType::ALLTOALL;
}

static bool IsCacheableResponse(ResponseType t) {
  return t == ResponseType::ALLREDUCE || t == ResponseType::BROADCAST ||
         t == ResponseType::REDUCESCATTER || t == ResponseType::ALLTOALL;
}

// Queue drain + cache classification (every rank, coordinator included).
// A request whose name maps to a live slot with a matching signature
// collapses to one hit bit; a signature CHANGE evicts the slot locally
// and travels as evict + full replacement Request in the same frame;
// everything else is a full request.
void Engine::DrainMessageQueue(RequestList* my_list) {
  AssertBackgroundThread();
  // Requests bounced back to full negotiation by a remote evict go first
  // (they have already been waiting a cycle).
  for (auto& q : cache_resubmits_) {
    cache_misses_.fetch_add(1);
    my_list->requests.push_back(std::move(q));
  }
  cache_resubmits_.clear();
  std::deque<Request> pending;
  {
    std::lock_guard<std::mutex> lk(mu_);
    pending.swap(message_queue_);
  }
  for (auto& q : pending) {
    // Backup-worker skip token: this tensor was partially committed
    // WITHOUT us before we enqueued it — consume the token and finish
    // the entry with the clean skipped status; nothing goes on the wire
    // (the coordinator already forgot the tensor).
    if (!skip_tokens_.empty()) {
      auto st = skip_tokens_.find(q.tensor_name);
      if (st != skip_tokens_.end()) {
        if (--st->second <= 0) skip_tokens_.erase(st);
        TensorTableEntry e;
        bool have = false;
        {
          std::lock_guard<std::mutex> lk(mu_);
          auto tit = tensor_table_.find(q.tensor_name);
          if (tit != tensor_table_.end()) {
            e = std::move(tit->second);
            tensor_table_.erase(tit);
            have = true;
          }
        }
        if (have) {
          FinishEntry(e, Status::PreconditionError(kSkippedStepError), 0);
        }
        continue;
      }
    }
    if (cache_enabled_ && !q.probe) {
      auto it = cache_by_name_.find(q.tensor_name);
      if (it != cache_by_name_.end()) {
        uint32_t slot = it->second;
        if (cache_entries_[slot].sig.Matches(q)) {
          cache_hits_.fetch_add(1);
          my_list->cache_hits.push_back(slot);
          pending_cache_hits_[slot] = q.tensor_name;
          continue;
        }
        // Same name, new shape/dtype/op/root: drop the slot everywhere
        // and renegotiate from scratch (airtight invalidation — the
        // fusion buffer must never see the old layout again).
        my_list->cache_evicts.push_back(slot);
        cache_entries_.erase(slot);
        cache_by_name_.erase(it);
        cache_evictions_.fetch_add(1);
      }
      if (IsCacheableType(q.type)) cache_misses_.fetch_add(1);
    }
    my_list->requests.push_back(std::move(q));
  }
}

static Request RequestFromEntry(const TensorTableEntry& e, int rank) {
  Request q;
  q.request_rank = rank;
  q.type = e.type;
  q.dtype = e.dtype;
  q.tensor_name = e.name;
  q.root_rank = e.root_rank;
  q.red_op = e.red_op;
  q.wire_dtype = e.wire_dtype;
  q.wire_default = e.wire_default;
  q.priority = e.priority;
  for (int d = 0; d < e.shape.ndim(); ++d) q.shape.push_back(e.shape.dim(d));
  q.splits = e.splits;
  return q;
}

void Engine::ApplyCacheUpdates(const ResponseList& list) {
  if (list.evict_slots.empty() && list.responses.empty()) return;
  AssertBackgroundThread();
  // Evictions FIRST: a freed slot id may be reassigned by a response in
  // this very frame.
  for (uint32_t slot : list.evict_slots) {
    auto it = cache_entries_.find(slot);
    if (it != cache_entries_.end()) {
      cache_by_name_.erase(it->second.response.tensor_names[0]);
      cache_entries_.erase(it);
      cache_evictions_.fetch_add(1);
    }
    auto pit = pending_cache_hits_.find(slot);
    if (pit != pending_cache_hits_.end()) {
      // Our hit bit rode a slot that just died; renegotiate the tensor
      // fully next cycle so it cannot strand (if the signatures really
      // diverged across ranks, full validation reports the mismatch).
      std::lock_guard<std::mutex> lk(mu_);
      auto tit = tensor_table_.find(pit->second);
      if (tit != tensor_table_.end()) {
        cache_resubmits_.push_back(RequestFromEntry(tit->second, rank_));
      }
      pending_cache_hits_.erase(pit);
    }
  }
  if (!cache_enabled_) return;
  // New slot assignments: store this rank's own signature plus the
  // single-tensor response to replay on future hits.
  for (const auto& resp : list.responses) {
    for (size_t i = 0; i < resp.tensor_names.size(); ++i) {
      if (i >= resp.cache_slots.size() || resp.cache_slots[i] < 0) continue;
      uint32_t slot = static_cast<uint32_t>(resp.cache_slots[i]);
      const std::string& name = resp.tensor_names[i];
      CacheEntry entry;
      {
        std::lock_guard<std::mutex> lk(mu_);
        auto tit = tensor_table_.find(name);
        if (tit == tensor_table_.end()) continue;  // defensive
        const TensorTableEntry& e = tit->second;
        entry.sig.type = e.type;
        entry.sig.dtype = e.dtype;
        entry.sig.root_rank = e.root_rank;
        entry.sig.red_op = e.red_op;
        entry.sig.wire_dtype = e.wire_dtype;
        entry.sig.priority = e.priority;
        for (int d = 0; d < e.shape.ndim(); ++d) {
          entry.sig.shape.push_back(e.shape.dim(d));
        }
        entry.sig.splits = e.splits;
      }
      Response single;
      single.type = resp.type;
      single.tensor_names.push_back(name);
      single.tensor_sizes = resp.tensor_sizes;
      single.root_rank = resp.root_rank;
      single.red_op = resp.red_op;
      single.wire_dtype = resp.wire_dtype;
      single.priority = entry.sig.priority;
      single.cache_slots.assign(1, -1);
      entry.response = std::move(single);
      cache_by_name_[name] = slot;
      cache_entries_[slot] = std::move(entry);
    }
  }
}

// Resolve a response's scheduling priority on THIS rank: the
// coordinator stamped it at build time, cached replays copy it from
// the replica signature, and worker-side fresh responses received the
// committed NONZERO values in the frame's trailing priority section —
// absence means the committed priority was 0.  Never read the local
// tensor-table entry: a rank that joined a negotiation via a layout
// PROBE stamped 0 locally while its peers stamped the committed value,
// and a locally-resolved order would desync the wave/channel pairing
// across ranks.  Errors and sparse retries stay unknown (-1): they
// dispatch by response content, outside the priority order.
int Engine::ResolveResponsePriority(Response& resp) {
  if (resp.priority >= 0) return resp.priority;
  if (resp.tensor_names.empty() || resp.type == ResponseType::ERROR ||
      resp.type == ResponseType::SPARSE_RETRY) {
    return -1;
  }
  if (!resp.participants.empty() &&
      !RankInParticipants(resp.participants)) {
    return -1;  // ghost ride: dispatch placement ignores priority anyway
  }
  resp.priority = 0;  // committed zero (nonzero would be in the frame)
  return resp.priority;
}

// (priority, name) dispatch order for one cycle.  Three classes, each
// placeable from CROSS-RANK-IDENTICAL information only (the lists must
// sort identically on every rank or wave/channel pairing desyncs):
// errors + sparse retries first (local finishes, no wire — they cannot
// block anything), full-commit responses sorted by (priority, first
// name) — priorities validated equal everywhere — and backup-worker
// partial commits last in arrival order (a ghost rank cannot know their
// priority, so the rule must not depend on it).
void Engine::OrderResponsesByPriority(std::vector<Response>& responses) {
  std::vector<Response> front, mid, back;
  for (auto& r : responses) {
    if (r.type == ResponseType::ERROR ||
        r.type == ResponseType::SPARSE_RETRY) {
      front.push_back(std::move(r));
    } else if (!r.participants.empty()) {
      back.push_back(std::move(r));
    } else {
      mid.push_back(std::move(r));
    }
  }
  std::stable_sort(
      mid.begin(), mid.end(), [](const Response& x, const Response& y) {
        const int px = x.priority < 0 ? 0 : x.priority;
        const int py = y.priority < 0 ? 0 : y.priority;
        if (px != py) return px < py;
        const std::string& nx =
            x.tensor_names.empty() ? std::string() : x.tensor_names[0];
        const std::string& ny =
            y.tensor_names.empty() ? std::string() : y.tensor_names[0];
        return nx < ny;
      });
  responses.clear();
  for (auto& r : front) responses.push_back(std::move(r));
  for (auto& r : mid) responses.push_back(std::move(r));
  for (auto& r : back) responses.push_back(std::move(r));
}

// Dispatch-order priority inversions for one cycle (`first` dispatches
// before `second`): a committed response whose priority is strictly
// more urgent (smaller) than one already dispatched counts once.
// Deterministic — dispatch-LIST order, not wall clock — so reruns of
// the same world read the same value; 0 by construction once the
// banded ordering is on.
void Engine::CountPriorityInversions(const std::vector<Response>& first,
                                     const std::vector<Response>& second) {
  int max_seen = -1;
  int64_t inversions = 0;
  auto scan = [&](const std::vector<Response>& rs) {
    for (const auto& r : rs) {
      if (r.type == ResponseType::ERROR ||
          r.type == ResponseType::SPARSE_RETRY ||
          !r.participants.empty() || r.priority < 0) {
        continue;
      }
      if (max_seen >= 0 && r.priority < max_seen) ++inversions;
      if (r.priority > max_seen) max_seen = r.priority;
    }
  };
  scan(first);
  scan(second);
  if (inversions > 0) priority_inversions_.fetch_add(inversions);
}

bool Engine::BuildCachedResponses(const ResponseList& list,
                                  std::vector<Response>* out) {
  out->clear();
  if (list.cached_slots.empty()) return true;
  AssertBackgroundThread();
  std::vector<Response>& cached = *out;
  cached.reserve(list.cached_slots.size());
  for (uint32_t slot : list.cached_slots) {
    auto it = cache_entries_.find(slot);
    if (it == cache_entries_.end()) {
      // Replica divergence: executing anything further would desync the
      // ring ordering across ranks — abort loudly instead of stranding
      // tensors or corrupting buffers.
      abort_reason_ = "negotiation cache protocol error: coordinator "
                      "agreed on cache slot " + std::to_string(slot) +
                      " which this rank does not hold";
      std::fprintf(stderr, "horovod_tpu rank %d: %s\n", rank_,
                   abort_reason_.c_str());
      return false;
    }
    pending_cache_hits_.erase(slot);
    timeline_.NegotiateCached(it->second.response.tensor_names[0]);
    Response resp = it->second.response;
    resp.priority = it->second.sig.priority;
    // Backup-worker partial commit on the cached path: graft the
    // cycle's committed participant set onto the replayed response, and
    // the payload geometry from the replica signature (a skipped rank
    // holds the replica even when it holds no tensor entry).
    for (const auto& ps : list.partial_slots) {
      if (ps.slot != slot) continue;
      resp.participants = ps.participants;
      int64_t elems = 1;
      for (auto d : it->second.sig.shape) elems *= d;
      resp.partial_elems = elems;
      resp.partial_dtype = static_cast<uint8_t>(it->second.sig.dtype);
      break;
    }
    cached.push_back(std::move(resp));
  }
  // Deterministic across ranks: identical slot order (from the frame) and
  // identical per-tensor dtypes/sizes/priorities (signature-agreed) ⇒
  // identical ordering ⇒ identical fusion ⇒ identical ring execution
  // order (and identical wave/channel assignment in ExecuteResponses).
  // With bands on, both ends re-order the replays by (priority, name)
  // from their replica signatures before fusing.
  if (priority_bands_.load() > 0) OrderResponsesByPriority(cached);
  FuseResponses(cached);
  return true;
}

// One cycle's full dispatch: fresh responses + cached replays.  Bands
// off: the legacy order exactly (fresh in frame order, then cached in
// ascending-slot order) — bit-identical to the pre-priority engine,
// with the inversions counter still observing what banded ordering
// WOULD have fixed.  Bands on: one merged (priority, name)-ordered
// dispatch, so a cached slot can neither head-of-line-block nor be
// blocked by an urgent fresh response.
bool Engine::DispatchCycleResponses(ResponseList& list,
                                    bool* executed_any) {
  std::vector<Response> cached;
  if (!BuildCachedResponses(list, &cached)) return false;
  for (auto& resp : list.responses) ResolveResponsePriority(resp);
  *executed_any = !list.responses.empty() || !cached.empty();
  if (priority_bands_.load() > 0) {
    std::vector<Response> all;
    all.reserve(list.responses.size() + cached.size());
    for (auto& r : list.responses) all.push_back(std::move(r));
    for (auto& r : cached) all.push_back(std::move(r));
    list.responses.clear();
    OrderResponsesByPriority(all);
    CountPriorityInversions(all, {});
    ExecuteResponses(all);
  } else {
    CountPriorityInversions(list.responses, cached);
    ExecuteResponses(list.responses);
    ExecuteResponses(cached);
  }
  return true;
}

void Engine::CoordinatorEvictSlot(uint32_t slot, ResponseList* out) {
  AssertBackgroundThread();
  auto it = coord_slot_names_.find(slot);
  if (it == coord_slot_names_.end()) return;  // duplicate evict this cycle
  GlobalFlightRecorder().Record("evict", control_cycle_seq_, "slot=%u %s",
                                slot, it->second.c_str());
  coord_slot_by_name_.erase(it->second);
  coord_slot_names_.erase(it);
  coord_slot_bits_.erase(slot);
  free_slots_.insert(slot);
  out->evict_slots.push_back(slot);
}

// Readiness counting + response construction + fusion, on the coordinator.
// Reference: IncrementTensorCount (operations.cc:282-307) +
// ConstructMPIResponse (315-517) + fusion (1815-1842); the cache-slot
// readiness bits are the reference 0.21 response-cache bitvector idea
// mapped onto this coordinator.
ResponseList Engine::CoordinatorStep(std::vector<RequestList>& lists) {
  AssertBackgroundThread();
  // One entry per VOTER: ranks on the flat path, host groups under
  // hierarchical coordination (each group's leader aggregated its
  // members, so a voter's hit bit means "my whole group is ready").
  // Full Requests carry their true request_rank either way, so
  // validation and per-rank readiness stay rank-granular.
  const int nvoters = static_cast<int>(lists.size());
  ResponseList out;
  out.epoch = epoch_.load();
  // Cache evictions first — readiness bits and slot reassignments below
  // must see the slot freed, and bits arriving for a slot evicted in the
  // same cycle are dropped (their senders renegotiate on receipt of the
  // evict broadcast).
  for (int v = 0; v < nvoters; ++v) {
    for (uint32_t slot : lists[v].cache_evicts) {
      CoordinatorEvictSlot(slot, &out);
    }
  }
  std::vector<std::string> became_ready;
  for (int v = 0; v < nvoters; ++v) {
    if (lists[v].shutdown) out.shutdown = true;
    for (auto& q : lists[v].requests) {
      const int r = q.request_rank;
      if (r < 0 || r >= size_) continue;  // garbled frame: ignore
      // A full request for a name that still holds a slot means some rank
      // invalidated it (or a replica missed the assignment): drop the
      // slot globally and fall through to full renegotiation.
      auto cs = coord_slot_by_name_.find(q.tensor_name);
      if (cs != coord_slot_by_name_.end()) {
        CoordinatorEvictSlot(cs->second, &out);
      }
      auto it = message_table_.find(q.tensor_name);
      if (it == message_table_.end()) {
        timeline_.NegotiateStart(q.tensor_name);
        PendingInfo info;
        info.requests.resize(size_);
        info.seen.assign(size_, false);
        info.seen_time.resize(size_);
        info.first_seen = std::chrono::steady_clock::now();
        it = message_table_.emplace(q.tensor_name, std::move(info)).first;
      }
      PendingInfo& info = it->second;
      if (!info.seen[r]) {
        info.seen[r] = true;
        info.seen_time[r] = std::chrono::steady_clock::now();
        info.requests[r] = q;
        info.count++;
        timeline_.NegotiateRankReady(q.tensor_name, r);
      }
      if (info.count == size_) {
        became_ready.push_back(q.tensor_name);
      }
    }
  }
  // Readiness bits against live slots; when every voter's bit is in, the
  // slot fires this cycle as a slot id — ConstructResponse is skipped
  // entirely (the validated response is replayed from each replica).
  std::vector<uint32_t> agreed;
  for (int v = 0; v < nvoters; ++v) {
    for (uint32_t slot : lists[v].cache_hits) {
      if (coord_slot_names_.find(slot) == coord_slot_names_.end()) continue;
      SlotPending& sp = coord_slot_bits_[slot];
      if (sp.seen.empty()) {
        sp.seen.assign(nvoters, false);
        sp.seen_time.resize(nvoters);
        sp.first_seen = std::chrono::steady_clock::now();
      }
      if (!sp.seen[v]) {
        sp.seen[v] = true;
        sp.seen_time[v] = std::chrono::steady_clock::now();
        sp.count++;
      }
      if (sp.count == nvoters) agreed.push_back(slot);
    }
  }
  std::sort(agreed.begin(), agreed.end());
  for (uint32_t slot : agreed) {
    // Quorum-lag sample (how far the last voter trailed the rest) before
    // the readiness bits are dropped; under hierarchical coordination a
    // voter is a host group, attributed to its leader rank.
    auto bit = coord_slot_bits_.find(slot);
    if (bit != coord_slot_bits_.end()) {
      std::vector<std::chrono::steady_clock::time_point> vt;
      std::vector<int> vr;
      for (size_t v = 0; v < bit->second.seen.size(); ++v) {
        if (bit->second.seen[v]) {
          vt.push_back(bit->second.seen_time[v]);
          vr.push_back(HierActive() ? group_leaders_[v]
                                    : static_cast<int>(v));
        }
      }
      NoteQuorumLag(vt, vr);
    }
    coord_slot_bits_.erase(slot);
    out.cached_slots.push_back(slot);
    auto nit = coord_slot_names_.find(slot);
    if (nit != coord_slot_names_.end()) {
      timeline_.FlowSend(nit->second, epoch_.load());
    }
  }
  for (auto& name : became_ready) {
    timeline_.NegotiateEnd(name);
    bool any_probe = false;
    {
      auto it = message_table_.find(name);
      for (int r = 0; it != message_table_.end() && r < size_; ++r) {
        if (it->second.requests[r].probe) any_probe = true;
      }
      // Quorum-lag sample at rank granularity (full requests carry
      // per-rank arrival times even under hierarchical coordination).
      if (it != message_table_.end() && size_ > 1) {
        std::vector<std::chrono::steady_clock::time_point> vt;
        std::vector<int> vr;
        for (int r = 0; r < size_; ++r) {
          if (it->second.seen[r]) {
            vt.push_back(it->second.seen_time[r]);
            vr.push_back(r);
          }
        }
        NoteQuorumLag(vt, vr);
      }
    }
    Response resp = BuildResponse(name);
    resp.cache_slots.assign(resp.tensor_names.size(), -1);
    // Cross-rank flow trace: the negotiation's commit is the flow SOURCE
    // ("s"); every rank's execution span carries the matching sink ("f")
    // — see Timeline::FlowSend/FlowRecv.  Errors never execute, so they
    // never open a flow.
    if (resp.type != ResponseType::ERROR) {
      timeline_.FlowSend(name, epoch_.load());
    }
    if (cache_enabled_ && !any_probe && resp.type != ResponseType::ERROR &&
        IsCacheableResponse(resp.type) &&
        static_cast<int64_t>(coord_slot_names_.size()) < cache_capacity_) {
      uint32_t slot;
      if (!free_slots_.empty()) {
        slot = *free_slots_.begin();
        free_slots_.erase(free_slots_.begin());
      } else {
        slot = next_slot_++;
      }
      coord_slot_names_[slot] = name;
      coord_slot_by_name_[name] = slot;
      resp.cache_slots[0] = static_cast<int32_t>(slot);
    }
    out.responses.push_back(std::move(resp));
  }

  // Backup-worker straggler tolerance: commit SUM allreduces that are
  // still short of full readiness but past the nvoters-k threshold and
  // the grace window (full commits above always win the race — a tensor
  // every rank reported this cycle never reaches this scan).
  if (backup_workers_ > 0 || backup_auto_) MaybePartialCommits(&out);

  // Sparse-layout rendezvous: a pending entry whose received requests are
  // ALL layout probes (ranks with no local gradient), coexisting with a
  // pending sparse gather of the same tensor ("<name>.idx"), would
  // deadlock — the probing ranks wait for peers to join the dense
  // allreduce while the peers wait for them to join the allgathers.
  // Resolve it by telling the probing ranks to retry sparsely; their
  // re-enqueued zero-entry '<name>.idx'/'.vals' complete the gathers.
  // (A NON-probe dense request conflicting with a sparse gather is a real
  // layout inconsistency across ranks and is left to the stall warning.)
  std::vector<std::pair<std::string, int64_t>> sparse_retries;
  for (auto& kv : message_table_) {
    const PendingInfo& info = kv.second;
    bool all_probe = info.count > 0;
    for (int r = 0; r < size_ && all_probe; ++r) {
      if (info.seen[r] && !info.requests[r].probe) all_probe = false;
    }
    if (!all_probe) continue;
    auto sp = message_table_.find(kv.first + ".idx");
    if (sp == message_table_.end() || sp->second.count == 0) continue;
    for (int r = 0; r < size_; ++r) {
      if (sp->second.seen[r]) {
        const auto& shape = sp->second.requests[r].shape;
        sparse_retries.emplace_back(kv.first,
                                    shape.size() > 1 ? shape[1] : 1);
        break;
      }
    }
  }
  for (auto& [name, sparse_dim] : sparse_retries) {
    timeline_.NegotiateEnd(name);
    message_table_.erase(name);
    Response resp;
    resp.type = ResponseType::SPARSE_RETRY;
    resp.tensor_names.push_back(name);
    resp.tensor_sizes.push_back(sparse_dim);
    out.responses.push_back(std::move(resp));
  }

  // Priority scheduling (HOROVOD_PRIORITY_BANDS > 0): commit the
  // cycle's responses in (priority, name) order instead of arrival
  // order, so a front-layer gradient that negotiated late in the cycle
  // still dispatches ahead of the tail — the ByteScheduler insight at
  // the coordinator's seam.  Bands off: arrival order, bit-identical to
  // the pre-priority engine.
  if (priority_bands_.load() > 0) OrderResponsesByPriority(out.responses);
  FuseResponses(out.responses);
  return out;
}

// Cross-rank validation: dtype / op / shape / root consistency.  Mismatch
// yields an ERROR response delivered to every rank instead of undefined
// collective behavior — the reference's most important failure-containment
// feature (operations.cc:315-517).
Response Engine::BuildResponse(const std::string& name) {
  // message_table_ is background-thread-only (see engine.h); no lock.
  AssertBackgroundThread();
  PendingInfo info;
  {
    auto it = message_table_.find(name);
    info = std::move(it->second);
    message_table_.erase(it);
  }
  const Request& first = info.requests[0];
  Response resp;
  resp.tensor_names.push_back(name);
  std::ostringstream err;
  // Wire-dtype reference for validation/commit: the first NON-probe
  // request with an EXPLICIT per-tensor override, else the first
  // non-probe request's knob-derived value.  A layout probe (no local
  // gradient) resolves its wire from the global knob, not the
  // per-tensor override its peers may be using — holding it to the
  // peers' format would fail the very step the probe machinery exists
  // to survive.  Knob-derived requests are advisory the same way
  // (Request::wire_default): enqueue-time knob sampling races TUNE
  // application across ranks, so the coordinator COMMITS one value
  // instead of erroring.  Execution is safe in every case: every rank
  // executes the RESPONSE's committed wire, never its own request's.
  const Request* wire_ref = nullptr;
  const Request* knob_ref = nullptr;
  for (int r = 0; r < size_; ++r) {
    const Request& q = info.requests[r];
    if (q.probe) continue;
    if (knob_ref == nullptr) knob_ref = &q;
    if (!q.wire_default) {
      wire_ref = &q;
      break;
    }
  }
  if (wire_ref == nullptr) {
    wire_ref = knob_ref != nullptr ? knob_ref : &first;
  }
  // Committed scheduling priority: the first non-probe request's value
  // (frontends stamp identically from registration order; probes adopt
  // the committed one like they adopt the wire).  Validated cross-rank
  // below, like dtype/wire.
  const Request* prio_ref = knob_ref != nullptr ? knob_ref : &first;
  resp.priority = prio_ref->priority;

  for (int r = 1; r < size_; ++r) {
    const Request& q = info.requests[r];
    if (q.type != first.type) {
      err << "Mismatched collective operations: rank 0 requested "
          << RequestTypeName(first.type) << " but rank " << r << " requested "
          << RequestTypeName(q.type) << " for tensor " << name << ".";
      resp.type = ResponseType::ERROR;
      resp.error_message = err.str();
      return resp;
    }
    if ((first.type == RequestType::ALLREDUCE ||
         first.type == RequestType::REDUCESCATTER) &&
        q.red_op != first.red_op) {
      err << "Mismatched reduction operators: rank 0 requested "
          << ReduceOpName(first.red_op) << " but rank " << r
          << " requested " << ReduceOpName(q.red_op) << " for tensor "
          << name << ".";
      resp.type = ResponseType::ERROR;
      resp.error_message = err.str();
      return resp;
    }
    if (q.dtype != first.dtype) {
      err << "Mismatched data types: rank 0 has " << DataTypeName(first.dtype)
          << " but rank " << r << " has " << DataTypeName(q.dtype)
          << " for tensor " << name << ".";
      resp.type = ResponseType::ERROR;
      resp.error_message = err.str();
      return resp;
    }
    // The L1 dtype validation extended to the WIRE format: the data
    // plane quantizes on one committed format per response, so EXPLICIT
    // overrides disagreeing must fail cleanly here — never garble bytes
    // on the ring.  Probes and knob-derived (wire_default) requests are
    // exempt — they adopt the committed wire (see wire_ref above).
    if ((first.type == RequestType::ALLREDUCE ||
         first.type == RequestType::REDUCESCATTER ||
         first.type == RequestType::ALLTOALL) &&
        !q.probe && !q.wire_default && !wire_ref->wire_default &&
        q.wire_dtype != wire_ref->wire_dtype) {
      err << "Mismatched wire dtypes: rank " << wire_ref->request_rank
          << " requested " << WireDtypeName(wire_ref->wire_dtype)
          << " but rank " << r << " requested "
          << WireDtypeName(q.wire_dtype) << " for tensor " << name
          << " (set HOROVOD_WIRE_DTYPE identically on every rank, or use "
             "the same per-tensor override).";
      resp.type = ResponseType::ERROR;
      resp.error_message = err.str();
      return resp;
    }
    // Scheduling priority is cross-rank metadata like the dtype: the
    // committed response order derives from it, so disagreeing stamps
    // must fail cleanly here — never split the dispatch order.  Probes
    // adopt the committed value (they never stamped one meaningfully).
    if (!q.probe && q.priority != prio_ref->priority) {
      err << "Mismatched priorities: rank " << prio_ref->request_rank
          << " stamped priority " << prio_ref->priority << " but rank "
          << r << " stamped " << q.priority << " for tensor " << name
          << " (pass the same priority= on every rank — frontends "
             "stamping from registration order do this automatically).";
      resp.type = ResponseType::ERROR;
      resp.error_message = err.str();
      return resp;
    }
  }

  if (first.type == RequestType::ALLTOALL) {
    // Split geometry negotiated like the dim-0 allgather's: dims 1+ must
    // match on every rank, dim 0 may differ (each rank routes its own
    // rows).  Per-rank `splits` — when present — must be size_
    // non-negative entries summing to that rank's dim 0; an EMPTY splits
    // vector is the legacy equal-split contract (dim 0 divisible by the
    // world size).  The committed size×size split matrix rides
    // tensor_sizes row-major: row r = rank r's send splits, so rank j's
    // recv geometry is column j.
    if (first.shape.empty()) {
      err << "alltoall requires a tensor with at least one dimension for "
             "tensor " << name << ".";
      resp.type = ResponseType::ERROR;
      resp.error_message = err.str();
      return resp;
    }
    for (int r = 1; r < size_; ++r) {
      const auto& s = info.requests[r].shape;
      bool ok = s.size() == first.shape.size() && !s.empty();
      for (size_t d = 1; ok && d < s.size(); ++d) ok = s[d] == first.shape[d];
      if (!ok) {
        err << "Mismatched alltoall tensor shapes: all dimensions except "
               "the first must match across ranks for tensor "
            << name << ".";
        resp.type = ResponseType::ERROR;
        resp.error_message = err.str();
        return resp;
      }
    }
    for (int r = 0; r < size_; ++r) {
      const Request& q = info.requests[r];
      const int64_t rows = q.shape[0];
      if (q.splits.empty()) {
        if (rows % size_ != 0) {
          err << "alltoall requires dimension 0 (" << rows
              << ") to be divisible by the number of ranks (" << size_
              << ") for tensor " << name
              << " when no explicit splits are passed.";
          resp.type = ResponseType::ERROR;
          resp.error_message = err.str();
          return resp;
        }
        for (int d = 0; d < size_; ++d) {
          resp.tensor_sizes.push_back(rows / size_);
        }
        continue;
      }
      if (static_cast<int>(q.splits.size()) != size_) {
        err << "alltoall splits for tensor " << name << " on rank " << r
            << " has " << q.splits.size() << " entries; expected one per "
            << "rank (" << size_ << ").";
        resp.type = ResponseType::ERROR;
        resp.error_message = err.str();
        return resp;
      }
      int64_t sum = 0;
      for (int64_t s : q.splits) {
        if (s < 0) {
          err << "alltoall splits for tensor " << name << " on rank " << r
              << " contain a negative entry (" << s << ").";
          resp.type = ResponseType::ERROR;
          resp.error_message = err.str();
          return resp;
        }
        sum += s;
      }
      if (sum != rows) {
        err << "alltoall splits for tensor " << name << " on rank " << r
            << " sum to " << sum << " but dimension 0 is " << rows << ".";
        resp.type = ResponseType::ERROR;
        resp.error_message = err.str();
        return resp;
      }
      for (int64_t s : q.splits) resp.tensor_sizes.push_back(s);
    }
    resp.type = ResponseType::ALLTOALL;
    // Committed wire format: alltoall rides the same codec seam as the
    // reductions (fp16/bf16 half staging, int8/fp8 block quantization of
    // the routed activations).
    resp.wire_dtype = wire_ref->wire_dtype;
    return resp;
  }
  if (first.type == RequestType::REDUCESCATTER) {
    // Needs identical shapes on every rank (the output partitioning is
    // computed from the common shape).
    for (int r = 1; r < size_; ++r) {
      if (info.requests[r].shape != first.shape) {
        err << "Mismatched " << RequestTypeName(first.type)
            << " tensor shapes: all ranks must pass identical shapes for "
               "tensor " << name << ".";
        resp.type = ResponseType::ERROR;
        resp.error_message = err.str();
        return resp;
      }
    }
    if (first.shape.empty()) {
      err << RequestTypeName(first.type) << " requires a tensor with at "
          << "least one dimension for tensor " << name << ".";
      resp.type = ResponseType::ERROR;
      resp.error_message = err.str();
      return resp;
    }
    // Reducescatter: rows split as evenly as possible, earlier ranks get
    // the remainder (largest-first — the same convention as the ring
    // segments, which is exactly what makes the 1-D shard geometry
    // coincide with the allreduce's EvenSegments and the RS half
    // bit-parity hold by construction).
    resp.type = ResponseType::REDUCESCATTER;
    resp.red_op = first.red_op;
    // Committed wire format, negotiated + validated like the allreduce's
    // (the RS data plane shares the codec seam).
    resp.wire_dtype = wire_ref->wire_dtype;
    int64_t rows = first.shape[0];
    for (int r = 0; r < size_; ++r) {
      resp.tensor_sizes.push_back(rows / size_ +
                                  (r < rows % size_ ? 1 : 0));
    }
    return resp;
  }
  if (first.type == RequestType::ALLREDUCE ||
      first.type == RequestType::BROADCAST) {
    for (int r = 1; r < size_; ++r) {
      if (info.requests[r].shape != first.shape) {
        TensorShape s0, sr;
        for (auto d : first.shape) s0.AddDim(d);
        for (auto d : info.requests[r].shape) sr.AddDim(d);
        err << "Mismatched " << RequestTypeName(first.type)
            << " tensor shapes: rank 0 has shape " << s0.DebugString()
            << " but rank " << r << " has shape " << sr.DebugString()
            << " for tensor " << name << ".";
        resp.type = ResponseType::ERROR;
        resp.error_message = err.str();
        return resp;
      }
    }
  }
  if (first.type == RequestType::BROADCAST) {
    for (int r = 1; r < size_; ++r) {
      if (info.requests[r].root_rank != first.root_rank) {
        err << "Mismatched broadcast root ranks: rank 0 has root "
            << first.root_rank << " but rank " << r << " has root "
            << info.requests[r].root_rank << " for tensor " << name << ".";
        resp.type = ResponseType::ERROR;
        resp.error_message = err.str();
        return resp;
      }
    }
    resp.type = ResponseType::BROADCAST;
    resp.root_rank = first.root_rank;
    return resp;
  }
  if (first.type == RequestType::ALLGATHER) {
    // dim0 may differ per rank (the negotiated dynamic shape); the rest
    // must match.  tensor_sizes carries every rank's dim0.
    for (int r = 1; r < size_; ++r) {
      const auto& s = info.requests[r].shape;
      bool ok = s.size() == first.shape.size() && !s.empty();
      for (size_t d = 1; ok && d < s.size(); ++d) {
        ok = s[d] == first.shape[d];
      }
      if (first.shape.empty() || !ok) {
        err << "Mismatched allgather tensor shapes: all dimensions except "
               "the first must match across ranks for tensor "
            << name << ".";
        resp.type = ResponseType::ERROR;
        resp.error_message = err.str();
        return resp;
      }
    }
    resp.type = ResponseType::ALLGATHER;
    for (int r = 0; r < size_; ++r) {
      resp.tensor_sizes.push_back(info.requests[r].shape[0]);
    }
    return resp;
  }
  resp.type = ResponseType::ALLREDUCE;
  resp.red_op = first.red_op;
  // Committed wire: the non-probe ranks' (validated identical) format —
  // probing ranks adopt it from this response.
  resp.wire_dtype = wire_ref->wire_dtype;
  return resp;
}

// -- backup-worker partial commits (HOROVOD_BACKUP_WORKERS=k) --

bool Engine::RankInParticipants(const std::vector<uint32_t>& parts) const {
  for (uint32_t p : parts) {
    if (static_cast<int>(p) == rank_) return true;
  }
  return false;
}

static std::string RankListString(const std::vector<bool>& in_set, int size,
                                  bool invert) {
  std::string s;
  for (int r = 0; r < size; ++r) {
    if (in_set[r] == invert) continue;
    if (!s.empty()) s += ",";
    s += std::to_string(r);
  }
  return s;
}

// Validate + build a single-tensor partial response over `participants`
// (every one of them has a seen request).  Mirrors BuildResponse's
// ALLREDUCE validation but only across the committed set; the entry is
// consumed either way.  Partial commits are SUM-only (callers checked),
// so red_op needs no mismatch message of its own.
Response Engine::BuildPartialResponse(
    const std::string& name, const std::vector<uint32_t>& participants) {
  AssertBackgroundThread();
  PendingInfo info;
  {
    auto it = message_table_.find(name);
    info = std::move(it->second);
    message_table_.erase(it);
  }
  timeline_.NegotiateEnd(name);
  Response resp;
  resp.tensor_names.push_back(name);
  resp.cache_slots.assign(1, -1);
  resp.participants = participants;
  const Request& first = info.requests[participants[0]];
  // Committed wire: the first participant with an EXPLICIT override
  // wins, else the first participant's knob-derived value (same rule
  // as BuildResponse).
  const Request* wire_ref = &first;
  for (uint32_t p : participants) {
    if (!info.requests[p].wire_default) {
      wire_ref = &info.requests[p];
      break;
    }
  }
  std::ostringstream err;
  for (size_t i = 1; i < participants.size(); ++i) {
    const Request& q = info.requests[participants[i]];
    if (q.dtype != first.dtype) {
      err << "Mismatched data types: rank " << first.request_rank << " has "
          << DataTypeName(first.dtype) << " but rank " << q.request_rank
          << " has " << DataTypeName(q.dtype) << " for tensor " << name
          << ".";
      resp.type = ResponseType::ERROR;
      resp.error_message = err.str();
      return resp;
    }
    if (q.shape != first.shape) {
      err << "Mismatched allreduce tensor shapes for tensor " << name
          << " (partial commit).";
      resp.type = ResponseType::ERROR;
      resp.error_message = err.str();
      return resp;
    }
    // Same wire rule as BuildResponse: explicit overrides must agree;
    // knob-derived wires adopt the committed one (TUNE-race immunity).
    if (!q.wire_default && !wire_ref->wire_default &&
        q.wire_dtype != wire_ref->wire_dtype) {
      err << "Mismatched wire dtypes: rank " << wire_ref->request_rank
          << " requested " << WireDtypeName(wire_ref->wire_dtype)
          << " but rank " << q.request_rank << " requested "
          << WireDtypeName(q.wire_dtype) << " for tensor " << name << ".";
      resp.type = ResponseType::ERROR;
      resp.error_message = err.str();
      return resp;
    }
  }
  resp.priority = first.priority;
  int64_t elems = 1;
  for (auto d : first.shape) elems *= d;
  resp.partial_elems = elems;
  resp.partial_dtype = static_cast<uint8_t>(first.dtype);
  if (first.type == RequestType::REDUCESCATTER) {
    // Partial reduce-scatter: same committed shard geometry as the full
    // path (largest-first dim-0 split over the WHOLE world — ghosts
    // drive the full-world cascade, so the geometry never shrinks).
    if (first.shape.empty()) {
      err << "reducescatter requires a tensor with at least one "
             "dimension for tensor " << name << " (partial commit).";
      resp.type = ResponseType::ERROR;
      resp.error_message = err.str();
      return resp;
    }
    resp.type = ResponseType::REDUCESCATTER;
    resp.red_op = ReduceOp::SUM;
    resp.wire_dtype = wire_ref->wire_dtype;
    const int64_t rows = first.shape[0];
    for (int r = 0; r < size_; ++r) {
      resp.tensor_sizes.push_back(rows / size_ +
                                  (r < rows % size_ ? 1 : 0));
    }
    return resp;
  }
  resp.type = ResponseType::ALLREDUCE;
  resp.red_op = ReduceOp::SUM;
  resp.wire_dtype = wire_ref->wire_dtype;
  return resp;
}

// End-of-cycle scan for partially committable work.  Eligibility: SUM
// allreduce (zero is the identity the skipped ranks' ghost buffers
// contribute; MIN/MAX/PROD and every other collective wait for the full
// world — which is also what makes a MAX allreduce a reliable barrier
// under k > 0), no probes, pending longer than the grace window, and at
// least nvoters-k ready voters.  Under hierarchical coordination a voter
// is a HOST GROUP: a group counts only when every member reported, so a
// whole late host is one late voter and one slow member sidelines its
// host — exactly the sub-coordinator readiness-aggregation contract.
void Engine::MaybePartialCommits(ResponseList* out) {
  AssertBackgroundThread();
  int k = backup_workers_;
  if (backup_auto_) {
    bool armed;
    if (backup_auto_rule_ == 1) {
      // HOROVOD_BACKUP_AUTO_RULE=steptime (the PR 12 rule, kept as the
      // documented fallback): the coordinator's own completion-latency
      // window — cheap, but blind to rank 0 itself straggling (its own
      // enqueue delay inflates every sample equally).
      size_t nsamp;
      {
        std::lock_guard<std::mutex> lk(step_ns_mu_);
        nsamp = step_ns_samples_.size();
      }
      const int64_t p50 = step_time_ns_p50();
      const int64_t p99 = step_time_ns_p99();
      armed = nsamp >= 64 && p50 > 0 &&
              static_cast<double>(p99) >
                  backup_auto_ratio_ * static_cast<double>(p50);
    } else {
      // Default rule: per-entry QUORUM LAG (last voter's arrival minus
      // the second-to-last's, sampled on every committed negotiation).
      // It measures exactly what a k=1 partial commit would save — and
      // because arrival times are observed at the coordinator for EVERY
      // rank's requests, a straggling rank 0 shows up like any other
      // (closing the steptime rule's coordinator blind spot,
      // docs/performance.md).  The threshold is the GRACE WINDOW, not a
      // p99/p50 ratio: a persistent straggler makes lag p50 ≈ p99 (a
      // ratio test would never fire), and grace is the exact point
      // where an armed partial commit becomes actionable — median lag
      // above it means the last voter would be skipped on a typical
      // step, below it arming changes nothing.
      size_t nsamp;
      {
        std::lock_guard<std::mutex> lk(quorum_mu_);
        nsamp = quorum_lag_samples_.size();
      }
      const int64_t p50 = quorum_lag_ns_p50();
      armed = nsamp >= 64 &&
              static_cast<double>(p50) >
                  static_cast<double>(backup_grace_ms_) * 1e6;
    }
    backup_armed_.store(armed);
    k = armed ? 1 : 0;
  }
  if (k <= 0 || size_ <= 1) return;
  const bool hier = HierActive();
  const int nvoters = hier ? nnodes_ : size_;
  const int need = std::max(1, nvoters - k);
  if (need >= nvoters) return;  // k over-clamped on a tiny world
  const auto now = std::chrono::steady_clock::now();
  const auto grace = std::chrono::milliseconds(backup_grace_ms_);
  // Grace is measured from QUORUM formation: the commit may fire only
  // when the (nvoters-k)-th voter has been ready for >= the grace
  // window — i.e. a rank is skipped only when it lags the QUORUM by
  // more than the grace, never because one early-bird request (a
  // one-shot straggler catching up ahead of peers) aged the entry.
  // Returns how long the quorum has been waiting (ns) when the commit
  // may fire, -1 otherwise.  The wait doubles as the synthetic quorum-
  // lag sample stamped at commit time (NoteSkippedQuorumLag): a partial
  // commit means the skipped voter trails the quorum by AT LEAST this
  // long, and recording it keeps the backup=auto arming window
  // deterministic while skips are occurring (committed-without-the-
  // straggler entries otherwise stop feeding the window).
  auto quorum_wait_ns =
      [&](std::vector<std::chrono::steady_clock::time_point> times)
      -> int64_t {
        if (static_cast<int>(times.size()) < need) return -1;
        std::nth_element(times.begin(), times.begin() + (need - 1),
                         times.end());
        const auto waited = now - times[need - 1];
        if (waited < grace) return -1;
        return std::chrono::duration_cast<std::chrono::nanoseconds>(
                   waited)
            .count();
      };

  // Full-request pending entries.  Names first: the commit erases them.
  // Eligibility covers SUM allreduces AND SUM reducescatters (PR 12's
  // follow-on): an RS ghost contributes the same zero buffer to the
  // same full-world cascade, and the participants divisor flows through
  // the handle exactly like the allreduce's.
  std::vector<std::string> names;
  for (auto& kv : message_table_) {
    const PendingInfo& info = kv.second;
    if (info.count <= 0 || info.count >= size_) continue;
    if (now - info.first_seen < grace) continue;
    bool eligible = true;
    RequestType seen_type = RequestType::ALLREDUCE;
    bool first_seen_req = true;
    for (int r = 0; r < size_ && eligible; ++r) {
      if (!info.seen[r]) continue;
      const Request& q = info.requests[r];
      if (first_seen_req) {
        seen_type = q.type;
        first_seen_req = false;
      }
      eligible = (q.type == RequestType::ALLREDUCE ||
                  q.type == RequestType::REDUCESCATTER) &&
                 q.type == seen_type &&
                 q.red_op == ReduceOp::SUM && !q.probe;
    }
    if (eligible) names.push_back(kv.first);
  }
  for (const auto& name : names) {
    const PendingInfo& info = message_table_[name];
    std::vector<bool> rank_in(size_, false);
    std::vector<std::chrono::steady_clock::time_point> ready_times;
    int ready = 0;
    if (hier) {
      // A voter is a host group, ready when EVERY member reported;
      // its ready time is its slowest member's.
      std::vector<char> group_ready(nnodes_, 1);
      std::vector<std::chrono::steady_clock::time_point> group_time(
          nnodes_);
      for (int r = 0; r < size_; ++r) {
        const int g = rank_host_[r];
        if (!info.seen[r]) {
          group_ready[g] = 0;
        } else if (info.seen_time[r] > group_time[g]) {
          group_time[g] = info.seen_time[r];
        }
      }
      for (int g = 0; g < nnodes_; ++g) {
        if (group_ready[g]) {
          ready++;
          ready_times.push_back(group_time[g]);
        }
      }
      if (ready < need) continue;
      for (int r = 0; r < size_; ++r) rank_in[r] = group_ready[rank_host_[r]];
    } else {
      ready = info.count;
      if (ready < need) continue;
      for (int r = 0; r < size_; ++r) {
        rank_in[r] = info.seen[r];
        if (info.seen[r]) ready_times.push_back(info.seen_time[r]);
      }
    }
    const int64_t waited_ns = quorum_wait_ns(std::move(ready_times));
    if (waited_ns < 0) continue;
    std::vector<uint32_t> participants;
    for (int r = 0; r < size_; ++r) {
      if (rank_in[r]) participants.push_back(static_cast<uint32_t>(r));
    }
    if (participants.empty() ||
        static_cast<int>(participants.size()) >= size_) {
      continue;
    }
    timeline_.PartialCommit(name, RankListString(rank_in, size_, true));
    timeline_.FlowSend(name, epoch_.load());
    GlobalFlightRecorder().Record(
        "partial", control_cycle_seq_, "%s skipped=%s", name.c_str(),
        RankListString(rank_in, size_, true).c_str());
    out->responses.push_back(BuildPartialResponse(name, participants));
    NoteSkippedQuorumLag(waited_ns);
  }

  // Cached-slot readiness bits: same voter threshold, the replayed
  // response comes from each rank's replica (the coordinator's own
  // replica supplies the eligibility check — SUM allreduce only).
  std::vector<std::pair<uint32_t, int64_t>> pslots;
  for (auto& kv : coord_slot_bits_) {
    if (kv.second.count < need || kv.second.count >= nvoters) continue;
    std::vector<std::chrono::steady_clock::time_point> vt;
    for (size_t v = 0; v < kv.second.seen.size(); ++v) {
      if (kv.second.seen[v]) vt.push_back(kv.second.seen_time[v]);
    }
    const int64_t waited_ns = quorum_wait_ns(std::move(vt));
    if (waited_ns < 0) continue;
    auto ce = cache_entries_.find(kv.first);
    if (ce == cache_entries_.end()) continue;  // defensive
    if ((ce->second.response.type != ResponseType::ALLREDUCE &&
         ce->second.response.type != ResponseType::REDUCESCATTER) ||
        ce->second.response.red_op != ReduceOp::SUM) {
      continue;
    }
    pslots.emplace_back(kv.first, waited_ns);
  }
  std::sort(pslots.begin(), pslots.end());
  for (const auto& [slot, slot_waited_ns] : pslots) {
    const SlotPending& sp = coord_slot_bits_[slot];
    std::vector<bool> rank_in(size_, false);
    if (hier) {
      for (int r = 0; r < size_; ++r) {
        int g = rank_host_[r];
        rank_in[r] = g < static_cast<int>(sp.seen.size()) && sp.seen[g];
      }
    } else {
      for (int r = 0; r < size_ && r < static_cast<int>(sp.seen.size());
           ++r) {
        rank_in[r] = sp.seen[r];
      }
    }
    std::vector<uint32_t> participants;
    for (int r = 0; r < size_; ++r) {
      if (rank_in[r]) participants.push_back(static_cast<uint32_t>(r));
    }
    if (participants.empty() ||
        static_cast<int>(participants.size()) >= size_) {
      continue;
    }
    auto nit = coord_slot_names_.find(slot);
    const std::string pname =
        nit == coord_slot_names_.end() ? "?" : nit->second;
    timeline_.PartialCommit(pname, RankListString(rank_in, size_, true));
    timeline_.FlowSend(pname, epoch_.load());
    GlobalFlightRecorder().Record(
        "partial", control_cycle_seq_, "%s slot=%u skipped=%s",
        pname.c_str(), slot,
        RankListString(rank_in, size_, true).c_str());
    coord_slot_bits_.erase(slot);
    out->cached_slots.push_back(slot);
    ResponseList::PartialSlot ps;
    ps.slot = slot;
    ps.participants = std::move(participants);
    out->partial_slots.push_back(std::move(ps));
    NoteSkippedQuorumLag(slot_waited_ns);
  }
}

// Consecutive same-dtype allreduces merge into one response executed as a
// single ring collective over the fusion buffer.
void Engine::FuseResponses(std::vector<Response>& responses) {
  // One load per call: a TUNE can only land between cycles, but stats
  // readers race this, and a single snapshot keeps the merge self-
  // consistent regardless.
  const int64_t fusion_threshold = fusion_threshold_.load();
  if (fusion_threshold <= 0) return;
  // Priority bands: fusion only merges within a band (a 64 MB fused
  // buffer of tail gradients must never swallow an urgent front-layer
  // tensor), and each band may carry its own autotuner-learned fusion
  // threshold (the per-band ladder).  Bands off: one global threshold,
  // the legacy merge exactly.
  const int64_t bands = priority_bands_.load();
  auto band_threshold = [&](const Response& r) -> int64_t {
    if (bands <= 0) return fusion_threshold;
    const int64_t lad = fusion_ladder(
        static_cast<int>(ResponseBand(r)));
    return lad > 0 ? lad : fusion_threshold;
  };
  auto entry_bytes = [this](const std::string& name) -> int64_t {
    std::lock_guard<std::mutex> lk(mu_);
    auto it = tensor_table_.find(name);
    if (it == tensor_table_.end()) return 0;
    return it->second.shape.num_elements() *
           static_cast<int64_t>(DataTypeSize(it->second.dtype));
  };
  auto entry_dtype = [this](const std::string& name) -> DataType {
    std::lock_guard<std::mutex> lk(mu_);
    auto it = tensor_table_.find(name);
    if (it == tensor_table_.end()) return DataType::FLOAT32;
    return it->second.dtype;
  };
  std::vector<Response> fused;
  for (auto& resp : responses) {
    // Keep the slot-assignment vector parallel to tensor_names through
    // the merge (paths that never assign slots leave it empty).
    resp.cache_slots.resize(resp.tensor_names.size(), -1);
    // Partial (backup-worker) responses never fuse: the participant set
    // and ghost-buffer geometry are per-response, and fusing two
    // different survivor sets would mix zero-contribution semantics.
    if (resp.type == ResponseType::ALLREDUCE && !fused.empty() &&
        resp.participants.empty() &&
        fused.back().participants.empty() &&
        fused.back().type == ResponseType::ALLREDUCE &&
        fused.back().red_op == resp.red_op &&
        fused.back().wire_dtype == resp.wire_dtype &&
        (bands <= 0 ||
         ResponseBand(fused.back()) == ResponseBand(resp)) &&
        entry_dtype(fused.back().tensor_names[0]) ==
            entry_dtype(resp.tensor_names[0])) {
      int64_t total = 0;
      for (auto& n : fused.back().tensor_names) total += entry_bytes(n);
      if (total + entry_bytes(resp.tensor_names[0]) <=
          band_threshold(fused.back())) {
        fused.back().tensor_names.push_back(resp.tensor_names[0]);
        fused.back().cache_slots.push_back(resp.cache_slots[0]);
        continue;
      }
    }
    fused.push_back(std::move(resp));
  }
  responses = std::move(fused);
}

// ---------------------------------------------------------------------------
// Execution (the host data plane)
// ---------------------------------------------------------------------------

// Chunk size for streamed (pipelined) relay transfers: broadcast rings and
// the hierarchical local chains.  Large enough to amortize syscalls, small
// enough that a relay's first-byte latency is hops·chunk_time, not
// hops·full_transfer.
static constexpr size_t kRelayChunk = 4u << 20;

void Engine::ExecuteResponses(std::vector<Response>& responses) {
  if (responses.empty()) return;
  // Backup-worker skip bookkeeping runs HERE, on the background thread,
  // BEFORE any wave dispatch: skip_tokens_ and pending_cache_hits_ are
  // background-thread-only (AssertBackgroundThread-checked), and a
  // partial response landing at wave index >= 1 would otherwise mutate
  // them from a pool thread.  PerformResponse then only ghost-executes
  // (it never pops entries for a response that skipped this rank — an
  // entry enqueued AFTER this sweep keeps its banked token and is
  // finished by the next DrainMessageQueue, never stranded).
  for (auto& resp : responses) {
    if (resp.participants.empty() ||
        RankInParticipants(resp.participants)) {
      continue;
    }
    std::vector<TensorTableEntry> entries;
    {
      std::lock_guard<std::mutex> lk(mu_);
      for (const auto& name : resp.tensor_names) {
        auto it = tensor_table_.find(name);
        if (it != tensor_table_.end()) {
          entries.push_back(std::move(it->second));
          tensor_table_.erase(it);
        }
      }
    }
    NoteSkippedResponse(resp, entries);
  }
  last_exec_time_ = std::chrono::steady_clock::now();
  // Concurrency degree: the flat ring (TCP or shm — both wire
  // num_channels_ disjoint port pairs) can run up to that many
  // INDEPENDENT responses at once, each claiming one channel (assignment
  // by list index — the list is identical on every rank, so rank r's
  // channel c always talks to rank r+1's channel c about the same
  // response).  The two-level topology executes serially — its star
  // edges and leader gather are single-instance — but still hands the
  // serial context the full channel range so the intra reduce-scatter
  // and the leader cross ring shard across channels.
  const int fanout = (size_ > 1 && pool_.size() > 0) ? num_channels_ : 1;
  // Wave width: how many independent responses run concurrently, each on
  // one disjoint channel.  Capped by the channel fan-out; live-tuned via
  // TUNE frames (every rank applies the same value at the same cycle
  // boundary, so cross-rank channel assignment stays in lockstep).
  const int C =
      two_level_ ? 1 : std::min(fanout, wave_width_.load());
  if (C <= 1 || responses.size() <= 1) {
    ExecCtx all{0, std::max(1, fanout)};
    for (auto& resp : responses) PerformResponse(resp, all);
    last_exec_time_ = std::chrono::steady_clock::now();
    return;
  }
  // Band-ordered wave dispatch (HOROVOD_PRIORITY_BANDS > 0): a wave
  // never spans a band boundary — a low-priority 64 MB fusion buffer
  // cannot co-schedule with (and therefore head-of-line-block) a more
  // urgent response, which instead dispatches in its own earlier wave
  // with the full channel fan-out when it rides alone.  Partial
  // (backup-worker) responses always ride alone: their priority is
  // unknowable on ghost ranks, and the boundary rule must derive from
  // the response content every rank can see.  Bands off: fixed waves of
  // C in list order, the legacy grouping exactly.
  const int64_t bands = priority_bands_.load();
  for (size_t base = 0; base < responses.size();) {
    int wave = static_cast<int>(
        std::min<size_t>(C, responses.size() - base));
    if (bands > 0) {
      if (!responses[base].participants.empty()) {
        wave = 1;
      } else {
        const int64_t b0 = ResponseBand(responses[base]);
        int w = 1;
        while (w < wave &&
               responses[base + w].participants.empty() &&
               ResponseBand(responses[base + w]) == b0) {
          ++w;
        }
        wave = w;
      }
    }
    const size_t wave_base = base;
    base += static_cast<size_t>(wave);
    if (wave == 1) {
      // Lone response (trailing, band-isolated, or partial): give it
      // the full fan-out.
      PerformResponse(responses[wave_base], ExecCtx{0, fanout, nullptr});
      continue;
    }
    std::vector<int64_t> slice_walls(wave, 0);
    TaskLatch latch(wave - 1);
    for (int j = 1; j < wave; ++j) {
      pool_.Submit([this, &responses, &slice_walls, wave_base, j, &latch] {
        PerformResponse(responses[wave_base + j],
                        ExecCtx{j, 1, &slice_walls[j]});
        latch.Done();
      });
    }
    PerformResponse(responses[wave_base], ExecCtx{0, 1, &slice_walls[0]});
    // Wave barrier: a channel must be quiet before the next wave reuses
    // it, or two responses' streams would interleave on one socket.
    latch.Wait();
    // One wall-clock sample per wave: the longest allreduce slice
    // (bytes were summed per response, so the derived bus bandwidth
    // reflects real elapsed time, undiluted by co-scheduled
    // non-allreduce responses).
    int64_t wall = *std::max_element(slice_walls.begin(),
                                     slice_walls.end());
    if (wall > 0) allreduce_ns_.fetch_add(wall);
  }
  last_exec_time_ = std::chrono::steady_clock::now();
}

void Engine::ReleaseScratch() {
  for (auto& b : fusion_buffers_) std::vector<uint8_t>().swap(b);
}

void Engine::MaybeReleaseScratch() {
  bool any = false;
  for (auto& b : fusion_buffers_) any = any || b.capacity() > 0;
  if (!any) return;
  auto now = std::chrono::steady_clock::now();
  if (now - last_exec_time_ < std::chrono::seconds(2)) return;
  ReleaseScratch();
}

void Engine::ReduceIntoTimed(void* dst, const void* src, int64_t count,
                             DataType dtype, ReduceOp op) {
  auto t0 = std::chrono::steady_clock::now();
  const int64_t bytes = count * static_cast<int64_t>(DataTypeSize(dtype));
  // Large reductions split across IDLE pool workers (disjoint element
  // ranges of an elementwise kernel — bit-identical to the serial call
  // for any split).  TrySubmitIfIdle never queues behind a busy channel
  // task, so a shard either runs on a genuinely free core or inline here
  // — the pool cannot deadlock on its own reductions.  The cut sits
  // ABOVE the ring pipeline chunk (chunk_bytes_): chunk reduces are
  // already overlapped with the wire, and splitting them again just buys
  // latch traffic; only the big monolithic reduces (hierarchical chain
  // relays, oversized chunks) benefit.
  const int64_t kParallelCut =
      std::max<int64_t>(2 << 20, chunk_bytes_.load() * 2);
  if (bytes >= kParallelCut && pool_.size() > 0 && count >= 4) {
    int parts = std::min<int64_t>(pool_.size() + 1, bytes / (kParallelCut / 2));
    parts = std::min(parts, 4);
    if (parts > 1) {
      uint8_t* d = static_cast<uint8_t*>(dst);
      const uint8_t* s = static_cast<const uint8_t*>(src);
      const size_t esize = DataTypeSize(dtype);
      const int64_t per = count / parts;
      TaskLatch latch(parts - 1);
      for (int p = 1; p < parts; ++p) {
        int64_t off = per * p;
        int64_t n = (p == parts - 1) ? count - off : per;
        auto shard = [d, s, off, n, esize, dtype, op, &latch] {
          ReduceInto(d + off * esize, s + off * esize, n, dtype, op);
          latch.Done();
        };
        if (!pool_.TrySubmitIfIdle(shard)) shard();
      }
      ReduceInto(d, s, per, dtype, op);
      latch.Wait();
      reduce_ns_.fetch_add(
          std::chrono::duration_cast<std::chrono::nanoseconds>(
              std::chrono::steady_clock::now() - t0)
              .count());
      return;
    }
  }
  ReduceInto(dst, src, count, dtype, op);
  reduce_ns_.fetch_add(std::chrono::duration_cast<std::chrono::nanoseconds>(
                           std::chrono::steady_clock::now() - t0)
                           .count());
}

// The codec combine kernel: dequantize both operands' blocks to fp32
// staging, combine (same operand order as ReduceInto: dst op src),
// rescale and requantize into dst.  Per-hop requantization accumulates
// bounded quantization error — the wire contract for int8/fp8 is
// loss-parity convergence, not bitwise equality.  Counted as reduction
// time (reduce_ns); the buffer-edge quantize/dequantize passes are what
// quantize_ns measures.
void Engine::WireReduceBlocksTimed(uint8_t* dst, const uint8_t* src,
                                   int64_t nblocks, const WireCodec& codec,
                                   ReduceOp op) {
  auto t0 = std::chrono::steady_clock::now();
  // Thread-local staging: this runs on channel drivers and pool workers
  // concurrently, and a per-chunk heap allocation would dominate small
  // blocks.
  thread_local std::vector<float> a, b;
  const size_t n = static_cast<size_t>(codec.block_elems);
  if (a.size() < n) {
    a.resize(n);
    b.resize(n);
  }
  for (int64_t blk = 0; blk < nblocks; ++blk) {
    uint8_t* d = dst + blk * codec.block_bytes;
    const uint8_t* s = src + blk * codec.block_bytes;
    DequantizeBlock(d, codec.block_elems, codec.wire, a.data());
    DequantizeBlock(s, codec.block_elems, codec.wire, b.data());
    ReduceInto(a.data(), b.data(), codec.block_elems, DataType::FLOAT32, op);
    QuantizeBlock(a.data(), codec.block_elems, codec.wire, d,
                  codec.block_elems);
  }
  reduce_ns_.fetch_add(std::chrono::duration_cast<std::chrono::nanoseconds>(
                           std::chrono::steady_clock::now() - t0)
                           .count());
}

// Quantized (int8/fp8) allreduce over `spec`: quantize the fp32 payload
// into per-chunk-scaled blocks, run the SAME channel-sharded ring (the
// stepped legacy path or the streaming cascade, TCP or shm — the codec
// rides the spec) over the wire buffer, dequantize back into `base`.
// Blocks are sized to HOROVOD_CHUNK_BYTES worth of fp32 elements, so
// "per-chunk scales" and the pipeline chunk coincide; the last block is
// zero-padded to keep ring elements uniform.
bool Engine::CompressedRingAllreduce(uint8_t* base, int64_t count,
                                     WireDtype wire, ReduceOp op,
                                     RingSpec spec, const ExecCtx& ctx,
                                     const std::string& tname,
                                     std::string* err) {
  WireCodec codec;
  codec.wire = wire;
  codec.block_elems =
      std::min<int64_t>(std::max<int64_t>(64, chunk_bytes_.load() / 4),
                        count);
  codec.block_bytes = 4 + static_cast<size_t>(codec.block_elems);
  const int64_t nblocks =
      (count + codec.block_elems - 1) / codec.block_elems;
  std::vector<uint8_t> wirebuf(static_cast<size_t>(nblocks) *
                               codec.block_bytes);
  const float* src = reinterpret_cast<const float*>(base);
  auto q0 = std::chrono::steady_clock::now();
  for (int64_t blk = 0; blk < nblocks; ++blk) {
    const int64_t off = blk * codec.block_elems;
    const int64_t n = std::min(codec.block_elems, count - off);
    QuantizeBlock(src + off, n, wire,
                  wirebuf.data() + blk * codec.block_bytes,
                  codec.block_elems);
  }
  quantize_ns_.fetch_add(
      std::chrono::duration_cast<std::chrono::nanoseconds>(
          std::chrono::steady_clock::now() - q0)
          .count());
  // Clamped at zero: a tiny tensor's wire form (scale header + padding)
  // can exceed its logical bytes, and a cumulative "saved" counter must
  // never run backwards over many small collectives.
  wire_bytes_saved_.fetch_add(std::max<int64_t>(
      0, count * 4 - static_cast<int64_t>(wirebuf.size())));
  spec.codec = &codec;
  spec.compressed = true;
  bool ok = ChanneledRingAllreduce(wirebuf.data(), nblocks,
                                   DataType::FLOAT32, op, spec, ctx, tname,
                                   err);
  if (!ok) return false;
  float* dst = reinterpret_cast<float*>(base);
  q0 = std::chrono::steady_clock::now();
  for (int64_t blk = 0; blk < nblocks; ++blk) {
    const int64_t off = blk * codec.block_elems;
    const int64_t n = std::min(codec.block_elems, count - off);
    DequantizeBlock(wirebuf.data() + blk * codec.block_bytes, n, wire,
                    dst + off);
  }
  quantize_ns_.fetch_add(
      std::chrono::duration_cast<std::chrono::nanoseconds>(
          std::chrono::steady_clock::now() - q0)
          .count());
  return true;
}

void Engine::NoteSkippedResponse(const Response& response,
                                 std::vector<TensorTableEntry>& entries) {
  AssertBackgroundThread();  // skip_tokens_/pending_cache_hits_ owner
  backup_skips_.fetch_add(1);
  GlobalFlightRecorder().Record(
      "skipped", control_cycle_seq_, "%s",
      response.tensor_names.empty() ? "?"
                                    : response.tensor_names[0].c_str());
  std::set<std::string> held;
  for (auto& e : entries) held.insert(e.name);
  for (const auto& name : response.tensor_names) {
    if (held.count(name) != 0) continue;
    // Not even enqueued yet (the straggler's API thread is behind):
    // bank a token; the future enqueue consumes it and finishes
    // "skipped" locally instead of shipping a request the coordinator
    // already committed without us.
    skip_tokens_[name] += 1;
  }
  if (!held.empty()) {
    // The entry exists but its request raced this cycle's frame (it is
    // still in message_queue_, unsent): purge it, or the next cycle
    // would plant a stale pending entry on the coordinator.
    std::lock_guard<std::mutex> lk(mu_);
    for (auto it = message_queue_.begin(); it != message_queue_.end();) {
      if (held.count(it->tensor_name) != 0) {
        it = message_queue_.erase(it);
      } else {
        ++it;
      }
    }
  }
  // A hit bit we already sent for this tensor was consumed by the
  // partial slot commit (hier: one slow group member sidelines the
  // whole group, ready members included) — drop the pending record so
  // an evict can't resubmit a tensor that no longer exists.
  for (auto it = pending_cache_hits_.begin();
       it != pending_cache_hits_.end();) {
    if (held.count(it->second) != 0) {
      it = pending_cache_hits_.erase(it);
    } else {
      ++it;
    }
  }
  for (auto& e : entries) {
    FinishEntry(e, Status::PreconditionError(kSkippedStepError), 0);
  }
}

void Engine::PerformResponse(const Response& response, const ExecCtx& ctx) {
  // Backup-worker partial commit that left THIS rank out: the skip
  // bookkeeping (finish-skipped entries, banked tokens) already ran in
  // ExecuteResponses on the background thread — here (possibly a wave
  // pool thread) we only ghost-drive the collective so the ring still
  // spans the whole world (the ghost contributes zeros, the SUM
  // identity).  A ghost never pops entries: one enqueued after the
  // bookkeeping sweep is consumed by its banked token at the next
  // DrainMessageQueue, never stranded here.
  const bool ghost = !response.participants.empty() &&
                     !RankInParticipants(response.participants);
  if (ghost && ((response.type != ResponseType::ALLREDUCE &&
                 response.type != ResponseType::REDUCESCATTER) ||
                response.partial_elems <= 0)) {
    return;  // partial ERROR (or degenerate): nothing to ghost-run
  }
  std::vector<TensorTableEntry> entries;
  if (!ghost) {
    std::lock_guard<std::mutex> lk(mu_);
    for (const auto& name : response.tensor_names) {
      auto it = tensor_table_.find(name);
      if (it != tensor_table_.end()) {
        entries.push_back(std::move(it->second));
        tensor_table_.erase(it);
      }
    }
  }
  if (response.type == ResponseType::ERROR) {
    for (auto& e : entries) {
      FinishEntry(e, Status::PreconditionError(response.error_message));
    }
    return;
  }
  if (response.type == ResponseType::SPARSE_RETRY) {
    // Only ranks that enqueued the layout probe hold an entry; they fail
    // the handle with the magic message so the frontend re-enqueues
    // zero-entry sparse gathers.  Ranks without an entry ignore it.
    int64_t sd = response.tensor_sizes.empty() ? 1 : response.tensor_sizes[0];
    for (auto& e : entries) {
      FinishEntry(e, Status::PreconditionError(
          "__sparse_retry__:" + std::to_string(sd)));
    }
    return;
  }
  if (entries.empty() && !ghost) return;
  if (!ghost) {
    responses_executed_.fetch_add(1);
    tensors_executed_.fetch_add(static_cast<int64_t>(entries.size()));
  }
  // Flow sink: every executing rank closes the flow the coordinator's
  // commit opened — one "f" per tensor name (fusion preserves the name
  // set, so per-name flow counters stay aligned with the per-name "s"
  // counters on rank 0).  Ghost rides execute the response too: the
  // flow arrow correctly lands on the ghost's RING span.
  for (const auto& name : response.tensor_names) {
    timeline_.FlowRecv(name, epoch_.load());
  }
  // Priority scheduling: annotate which band this response dispatched
  // in (trace forensics for the overlap work — PRIO_BAND0 is the most
  // urgent).  Bands off or priority unknown (ghost ride): no marker.
  if (!response.tensor_names.empty() && response.priority >= 0 &&
      priority_bands_.load() > 0) {
    char pm[32];
    std::snprintf(pm, sizeof(pm), "PRIO_BAND%lld",
                  static_cast<long long>(ResponseBand(response)));
    timeline_.Algo(response.tensor_names[0], pm);
  }
  switch (response.type) {
    case ResponseType::ALLREDUCE:
      ExecAllreduce(response, entries, ctx);
      break;
    case ResponseType::ALLGATHER:
      ExecAllgather(response, entries, ctx);
      break;
    case ResponseType::BROADCAST:
      ExecBroadcast(response, entries, ctx);
      break;
    case ResponseType::REDUCESCATTER:
      ExecReducescatter(response, entries, ctx);
      break;
    case ResponseType::ALLTOALL:
      ExecAlltoall(response, entries, ctx);
      break;
    default:
      break;
  }
}

// Ring segment arithmetic, shared by every ring and by the star fold that
// emulates it.  `vrank` is the rank used for segment bookkeeping: after
// the reduce-scatter phase, vrank v owns the fully-reduced segment
// (v + 1) mod size.  Under the engine-wide convention vrank =
// position - 1 (see TcpRingSpec), PHYSICAL position s therefore owns
// segment s — the RS half terminates at each rank's own shard — and
// segment s is accumulated in ring order s+1, s+2, ..., s+size (mod
// size), the fold order StarFoldAllreduce reproduces exactly.
static void EvenSegments(int64_t count, int size,
                         std::vector<int64_t>* seg_count,
                         std::vector<int64_t>* seg_off) {
  seg_count->resize(size);
  seg_off->resize(size);
  int64_t off = 0;
  for (int s = 0; s < size; ++s) {
    (*seg_count)[s] = count / size + (s < count % size ? 1 : 0);
    (*seg_off)[s] = off;
    off += (*seg_count)[s];
  }
}

// Transport-generic duplex chunked transfer on one ring port: the TCP
// pair goes through the poll-multiplexed SendRecvChunked, an shm edge
// through its ring-buffer twin — same callback contract, same timeout
// semantics, so every phase below runs unchanged over either kind.
bool Engine::PortSendRecvChunked(
    const RingPort& port, const void* send_buf, size_t sn, void* recv_buf,
    size_t rn, size_t chunk,
    const std::function<void(size_t, size_t)>& on_chunk, int timeout_ms,
    std::string* err, int64_t* wire_ns) {
  if (port.is_shm()) {
    return ShmSendRecvChunked(*port.shm_tx, send_buf, sn, *port.shm_rx,
                              recv_buf, rn, chunk, on_chunk, timeout_ms,
                              err, wire_ns);
  }
  return SendRecvChunked(*port.next, send_buf, sn, *port.prev, recv_buf,
                         rn, chunk, on_chunk, timeout_ms, err, wire_ns);
}

bool Engine::PortSendAll(const RingPort& port, const void* p, size_t n,
                         std::string* err) {
  if (port.is_shm()) {
    std::string detail;
    if (!port.shm_tx->WriteAll(p, n, socket_timeout_sec_ * 1000, &detail)) {
      // "send" prefix so TransportError blames the ring-next neighbor,
      // exactly like the TCP branch below.
      *err = "send to peer: " + detail;
      return false;
    }
    return true;
  }
  if (!port.next->SendAll(p, n)) {
    *err = "send to peer: transport failure";
    return false;
  }
  return true;
}

bool Engine::PortRecvAllPatient(const RingPort& port, void* p, size_t n,
                                int patience_rounds, std::string* err) {
  if (port.is_shm()) {
    // Same patience contract as RecvAllPatient: `rounds` consecutive
    // no-progress windows of one socket timeout each before giving up
    // (0 timeout = wait forever, exactly like the disabled-socket-timeout
    // TCP path).
    int64_t ms = static_cast<int64_t>(std::max(1, patience_rounds)) *
                 socket_timeout_sec_ * 1000;
    std::string detail;
    if (!port.shm_rx->ReadAll(p, n, static_cast<int>(ms), &detail)) {
      *err = "recv from peer: " + detail;
      return false;
    }
    return true;
  }
  if (!port.prev->RecvAllPatient(p, n, patience_rounds)) {
    *err = "recv from peer: transport failure";
    return false;
  }
  return true;
}

// One channel's reduce-scatter phase over explicit per-segment slices,
// chunk-pipelined: the recv of chunk k+1 streams through the kernel
// buffers while ReduceInto processes chunk k (the chunked transfer fires
// the reduction from its progress loop the moment a chunk's bytes are
// in).  Runs over whichever ring `spec` describes — flat TCP, flat shm,
// the intra-host shm ring, or the leader cross ring.
bool Engine::RingReduceScatterPhaseCh(uint8_t* base,
                                      const std::vector<int64_t>& seg_count,
                                      const std::vector<int64_t>& seg_off,
                                      DataType dtype, ReduceOp op,
                                      const RingSpec& spec, int ch,
                                      std::string* err) {
  // Under a wire codec the ring element is one quantized BLOCK
  // (seg_count/seg_off are block-granular) and the combine kernel is the
  // dequant-add-requant block reduce; everything else is unchanged.
  const size_t esize =
      spec.codec ? spec.codec->block_bytes : DataTypeSize(dtype);
  const int rsize = spec.rsize;
  const int vrank = spec.vrank;
  int64_t max_seg = 0;
  for (auto c : seg_count) max_seg = std::max(max_seg, c);
  // Raw allocation: vector's value-init would memset up to segment-size
  // bytes per collective for data every chunk immediately overwrites.
  std::unique_ptr<uint8_t[]> tmp(
      new uint8_t[static_cast<size_t>(max_seg) * esize]);
  size_t chunk =
      static_cast<size_t>(chunk_bytes_.load()) / esize * esize;  // aligned
  if (chunk == 0) chunk = esize;  // a wire block can exceed the chunk knob
  const int timeout_ms = socket_timeout_sec_ * 1000;
  for (int step = 0; step < rsize - 1; ++step) {
    int send_seg = (vrank - step + 2 * rsize) % rsize;
    int recv_seg = (vrank - step - 1 + 2 * rsize) % rsize;
    const size_t sn = static_cast<size_t>(seg_count[send_seg]) * esize;
    const size_t rn = static_cast<size_t>(seg_count[recv_seg]) * esize;
    uint8_t* rbase = base + seg_off[recv_seg] * esize;
    int64_t wns = 0;
    bool ok = PortSendRecvChunked(
        spec.ports[ch], base + seg_off[send_seg] * esize, sn, tmp.get(), rn,
        chunk,
        [&](size_t off, size_t len) {
          if (spec.codec != nullptr) {
            WireReduceBlocksTimed(rbase + off, tmp.get() + off,
                                  static_cast<int64_t>(len / esize),
                                  *spec.codec, op);
          } else {
            ReduceIntoTimed(rbase + off, tmp.get() + off,
                            static_cast<int64_t>(len / esize), dtype, op);
          }
        },
        timeout_ms, err, &wns);
    wire_ns_.fetch_add(wns);
    if (!ok) return false;
    CountPortBytes(spec.ports[ch], static_cast<int64_t>(sn),
                   static_cast<int64_t>(rn), spec.compressed);
  }
  return true;
}


bool Engine::RingAllgatherPhaseCh(uint8_t* base,
                                  const std::vector<int64_t>& seg_count,
                                  const std::vector<int64_t>& seg_off,
                                  size_t esize, const RingSpec& spec, int ch,
                                  std::string* err) {
  const int timeout_ms = socket_timeout_sec_ * 1000;
  const int rsize = spec.rsize;
  const int vrank = spec.vrank;
  for (int step = 0; step < rsize - 1; ++step) {
    int send_seg = (vrank - step + 1 + rsize) % rsize;
    int recv_seg = (vrank - step + rsize) % rsize;
    const size_t sn = static_cast<size_t>(seg_count[send_seg]) * esize;
    const size_t rn = static_cast<size_t>(seg_count[recv_seg]) * esize;
    int64_t wns = 0;
    bool ok = PortSendRecvChunked(spec.ports[ch],
                                  base + seg_off[send_seg] * esize, sn,
                                  base + seg_off[recv_seg] * esize, rn,
                                  /*chunk=*/0, nullptr, timeout_ms, err,
                                  &wns);
    wire_ns_.fetch_add(wns);
    if (!ok) return false;
    CountPortBytes(spec.ports[ch], static_cast<int64_t>(sn),
                   static_cast<int64_t>(rn), spec.compressed);
  }
  return true;
}

// The streaming cascade (see engine.h): sender and receiver cursors walk
// the unified step schedule s = 0..2(N-1)-1 — reduce-scatter steps then
// allgather steps — with per-step eligibility fed by the receiver.
// ready[s] counts bytes of step s's send segment that may ship: step 0 is
// fully ready at start (local data); step s+1's segment IS the segment
// received at step s, so the receiver credits ready[s+1] as bytes land
// (allgather: raw bytes — final on arrival) or as chunks finish reducing
// (reduce-scatter: a chunk is sendable only once combined).  Both sides
// walk steps in the same order, so the two FIFO directions stay framed
// without any headers.
bool Engine::StreamingRingChannels(uint8_t* base,
                                   const std::vector<ChannelSegs>& channels,
                                   DataType dtype, ReduceOp op,
                                   const RingSpec& spec,
                                   const std::string& tname,
                                   std::string* err, bool rs_only) {
  const size_t esize =
      spec.codec ? spec.codec->block_bytes : DataTypeSize(dtype);
  const int N = spec.rsize;
  const int vrank = spec.vrank;
  // rs_only: the schedule simply stops after the reduce-scatter half —
  // an identical prefix of the full cascade, so the owned segment's
  // bits cannot differ from the full allreduce's.
  const int nsteps = rs_only ? (N - 1) : 2 * (N - 1);
  const int last_rs = N - 2;  // steps [0, last_rs] reduce; rest allgather
  // Step schedule (segment ids, shared by every channel).  RS step s:
  // send (vrank-s), recv (vrank-s-1), reduce.  AG step s' = s-(N-1):
  // send (vrank-s'+1), recv (vrank-s') — the continuation of the same
  // per-chunk dependency chain.
  std::vector<int> send_seg(nsteps), recv_seg(nsteps);
  for (int s = 0; s < nsteps; ++s) {
    if (s <= last_rs) {
      send_seg[s] = (vrank - s + 2 * N) % N;
      recv_seg[s] = (vrank - s - 1 + 2 * N) % N;
    } else {
      int sp = s - (N - 1);
      send_seg[s] = (vrank - sp + 1 + 2 * N) % N;
      recv_seg[s] = (vrank - sp + 2 * N) % N;
    }
  }
  size_t chunk =
      static_cast<size_t>(chunk_bytes_.load()) / esize * esize;  // aligned
  if (chunk == 0) chunk = esize;  // a wire block can exceed the chunk knob

  // Per-channel cascade state.
  struct ChState {
    const ChannelSegs* segs = nullptr;
    const RingPort* port = nullptr;
    std::vector<size_t> ready;
    int ss = 0;          // sender step
    size_t so = 0;       // bytes of step ss already sent
    int rs = 0;          // receiver step
    size_t ro = 0;       // bytes of step rs already received
    size_t reduced = 0;  // bytes of step rs already reduced (RS steps)
    size_t tx = 0, rx = 0;
    // RS receive scratch (chunks are reduced out of it as they
    // complete); raw allocation — value-init would memset a segment per
    // collective.
    std::unique_ptr<uint8_t[]> tmp;
  };
  // A spec's ports are homogeneous (a ring is wholly TCP or wholly shm),
  // so the transport branch is taken once, not per chunk.
  const bool is_shm = spec.ports[channels[0].ch].is_shm();
  std::vector<ChState> st(channels.size());
  for (size_t i = 0; i < channels.size(); ++i) {
    ChState& c = st[i];
    c.segs = &channels[i];
    c.port = &spec.ports[c.segs->ch];
    c.ready.assign(nsteps + 1, 0);
    int64_t max_seg = 0;
    for (auto n : c.segs->seg_count) max_seg = std::max(max_seg, n);
    c.tmp.reset(new uint8_t[static_cast<size_t>(max_seg) * esize]);
  }
  // Cascade stream sequences: one bump per channel per invocation.  Both
  // endpoints of an edge execute the same deterministic response sequence
  // over the same channels, so the counters agree — a link-heal RESUME's
  // seq names exactly one in-flight cascade on both sides.
  std::vector<int64_t> ch_seq(st.size(), 0);
  if (!is_shm && spec.seq != nullptr) {
    for (size_t i = 0; i < st.size(); ++i) {
      int ch = st[i].segs->ch;
      if (ch >= 0 && ch < static_cast<int>(spec.seq->size())) {
        ch_seq[i] = ++(*spec.seq)[ch];
      }
    }
  }
  // Link self-healing is a TCP-ring affair: shm edges have no socket to
  // heal, and HOROVOD_LINK_RETRIES=0 restores the fail-fast path exactly.
  const bool heal_on =
      !is_shm && link_retries_ > 0 && spec.ring_id >= 0 &&
      spec.seq != nullptr && spec.next_peer >= 0 && spec.prev_peer >= 0 &&
      spec.next_peer < static_cast<int>(peer_hosts_.size()) &&
      spec.prev_peer < static_cast<int>(peer_hosts_.size());
  auto seg_bytes = [&](const ChState& c, int seg) {
    return static_cast<size_t>(c.segs->seg_count[seg]) * esize;
  };
  auto advance_sender = [&](ChState& c) {
    while (c.ss < nsteps && c.so == seg_bytes(c, send_seg[c.ss])) {
      ++c.ss;
      c.so = 0;
    }
  };
  auto advance_receiver = [&](ChState& c) {
    while (c.rs < nsteps && c.ro == seg_bytes(c, recv_seg[c.rs])) {
      ++c.rs;
      c.ro = 0;
      c.reduced = 0;
    }
  };
  for (auto& c : st) {
    c.ready[0] = seg_bytes(c, send_seg[0]);
    advance_sender(c);
    advance_receiver(c);
  }
  const int timeout_ms = socket_timeout_sec_ * 1000;
  auto t0 = std::chrono::steady_clock::now();
  int64_t local_reduce_ns = 0;
  bool ok = true;
  // Receive-side bookkeeping shared by both transports: after `k` fresh
  // bytes of step c.rs landed, reduce every COMPLETED chunk (RS steps) or
  // credit the raw bytes downstream (allgather steps — final on arrival),
  // then advance the cursor past any finished/empty steps.
  auto credit_recv = [&](ChState& c, size_t k) {
    if (c.rs <= last_rs) {
      uint8_t* sb = base + c.segs->seg_off[recv_seg[c.rs]] * esize;
      const size_t total = seg_bytes(c, recv_seg[c.rs]);
      while (c.reduced < c.ro &&
             (c.ro - c.reduced >= chunk || c.ro == total)) {
        size_t len = std::min(chunk, c.ro - c.reduced);
        auto r0 = std::chrono::steady_clock::now();
        if (spec.codec != nullptr) {
          WireReduceBlocksTimed(sb + c.reduced, c.tmp.get() + c.reduced,
                                static_cast<int64_t>(len / esize),
                                *spec.codec, op);
        } else {
          ReduceIntoTimed(sb + c.reduced, c.tmp.get() + c.reduced,
                          static_cast<int64_t>(len / esize), dtype, op);
        }
        local_reduce_ns +=
            std::chrono::duration_cast<std::chrono::nanoseconds>(
                std::chrono::steady_clock::now() - r0)
                .count();
        c.reduced += len;
        if (c.rs + 1 < nsteps) c.ready[c.rs + 1] += len;
      }
    } else if (c.rs + 1 < nsteps) {
      c.ready[c.rs + 1] += k;
    }
    advance_receiver(c);
  };
  if (is_shm) {
    // Shm cascade: the SPSC rings are progressed with nonblocking
    // TryWrite/TryRead — no pollable fd, so idleness parks on a
    // spin-then-yield-then-nap ladder (the WaitSeqSlice futex path serves
    // single-ring waits; a multi-ring cascade would need one futex word
    // per ring and gVisor's coverage is spotty anyway).  timeout_ms
    // bounds time with NO forward progress across every channel, exactly
    // like the TCP poll timeout.
    auto last_progress = std::chrono::steady_clock::now();
    int idle = 0;
    while (ok) {
      bool all_done = true, progressed = false;
      for (auto& c : st) {
        while (c.ss < nsteps && c.so < c.ready[c.ss]) {
          const uint8_t* p =
              base + c.segs->seg_off[send_seg[c.ss]] * esize + c.so;
          size_t k = c.port->shm_tx->TryWrite(p, c.ready[c.ss] - c.so);
          if (k > 0) {
            c.so += k;
            c.tx += k;
            progressed = true;
            advance_sender(c);
          } else {
            if (c.port->shm_tx->Closed()) {
              *err = "send to peer: shm ring closed (peer exited?)";
              ok = false;
            }
            break;
          }
        }
        if (!ok) break;
        while (c.rs < nsteps) {
          const bool reducing = c.rs <= last_rs;
          const size_t want = seg_bytes(c, recv_seg[c.rs]) - c.ro;
          uint8_t* dst =
              reducing ? c.tmp.get() + c.ro
                       : base + c.segs->seg_off[recv_seg[c.rs]] * esize +
                             c.ro;
          size_t k = c.port->shm_rx->TryRead(dst, want);
          if (k > 0) {
            c.ro += k;
            c.rx += k;
            progressed = true;
            credit_recv(c, k);
          } else {
            if (c.port->shm_rx->Closed()) {
              *err = "recv from peer: shm ring closed (peer exited?)";
              ok = false;
            }
            break;
          }
        }
        if (!ok) break;
        if (c.ss < nsteps || c.rs < nsteps) all_done = false;
      }
      if (!ok || all_done) break;
      if (progressed) {
        last_progress = std::chrono::steady_clock::now();
        idle = 0;
        continue;
      }
      if (++idle < 64) {
        std::this_thread::yield();
      } else {
        std::this_thread::sleep_for(std::chrono::microseconds(50));
      }
      if (timeout_ms > 0 &&
          std::chrono::steady_clock::now() - last_progress >
              std::chrono::milliseconds(timeout_ms)) {
        *err = "link: no progress for " + std::to_string(timeout_ms / 1000) +
               "s (peer hung?)";
        ok = false;
      }
    }
  } else {
  // -- TCP branch: poll-multiplexed cascade with link self-healing --
  //
  // A hard socket failure on a ring edge is classified SUSPECT instead of
  // fatal when heal_on: the channel's cascade parks at its exact
  // step/offset cursor while the edge re-establishes — the SENDER
  // re-dials the receiver's data listener with a RESUME hello (bounded
  // attempts/backoff), the RECEIVER ACKs its authoritative cursor, the
  // sender rewinds, and the stream resumes bit-identically (un-received
  // bytes are still intact in `base`: overwriting a chunk requires the
  // ring to have cycled it all the way around, which implies the
  // downstream receiver already consumed it).  Exhaustion escalates to
  // the unchanged abort path carrying the ORIGINAL transport error, so
  // culprit attribution is exactly what it was before healing existed.
  struct Heal {
    bool snd = false, rcv = false;  // per-direction suspect flags
    std::string snd_err, rcv_err;   // the original (attributable) errors
    std::chrono::steady_clock::time_point snd_t0, rcv_t0;
    std::chrono::steady_clock::time_point snd_next;  // next re-dial
    int snd_attempts = 0;
    // The re-dial in flight: first a nonblocking connect awaiting
    // POLLOUT (pending_connecting), then — hello sent — awaiting the
    // ACK on POLLIN.  Both phases bounded by pending_deadline; neither
    // ever blocks the driver's other channels.
    Socket pending;
    bool pending_connecting = false;
    std::chrono::steady_clock::time_point pending_deadline;
    bool span_open = false;
  };
  std::vector<Heal> heal(st.size());
  const int64_t heal_ms = link_heal_timeout_ms_;
  auto ms_since = [](std::chrono::steady_clock::time_point t) {
    return std::chrono::duration_cast<std::chrono::milliseconds>(
               std::chrono::steady_clock::now() - t)
        .count();
  };
  // Backoff jitter (±25%): rank-keyed LCG so simultaneous two-sided
  // failures don't re-dial in lockstep.
  uint32_t jseed = static_cast<uint32_t>(rank_) * 2654435761u + 12345u;
  auto jittered = [&jseed](int msv) {
    jseed = jseed * 1664525u + 1013904223u;
    int span = msv / 2;
    return msv - msv / 4 + (span > 0 ? static_cast<int>(jseed % span) : 0);
  };
  auto set_nonblock = [](int fd) {
    int fl = ::fcntl(fd, F_GETFL, 0);
    if (fl >= 0) ::fcntl(fd, F_SETFL, fl | O_NONBLOCK);
  };
  auto set_block = [](int fd) {
    int fl = ::fcntl(fd, F_GETFL, 0);
    if (fl >= 0) ::fcntl(fd, F_SETFL, fl & ~O_NONBLOCK);
  };
  for (auto& c : st) {
    set_nonblock(c.port->next->fd());
    set_nonblock(c.port->prev->fd());
  }
  auto last_progress = std::chrono::steady_clock::now();
  // Injected recv-stall (rank:step:recv-stall:ms): stop draining the
  // first channel until the deadline — a transient stall, not a failure.
  std::chrono::steady_clock::time_point stall_until = last_progress;
  size_t stall_idx = st.size();  // >= size: no stall armed
  if (spec.ring_id == RING_GLOBAL) {
    int64_t sms = fault_stall_ms_.exchange(0);
    if (sms > 0) {
      stall_idx = 0;
      stall_until = last_progress + std::chrono::milliseconds(sms);
      std::fprintf(stderr,
                   "horovod_tpu rank %d: fault injection: not draining "
                   "data channel %d for %lldms\n",
                   rank_, st[0].segs->ch, static_cast<long long>(sms));
    }
  }
  auto heal_span_open = [&](size_t i) {
    if (!heal[i].span_open) {
      timeline_.ActivityStartCh(tname, "LINK_HEAL", st[i].segs->ch + 1);
      heal[i].span_open = true;
    }
  };
  auto heal_span_close = [&](size_t i) {
    if (heal[i].span_open && !heal[i].snd && !heal[i].rcv) {
      timeline_.ActivityEndCh(tname, st[i].segs->ch + 1);
      heal[i].span_open = false;
    }
  };
  // Swap a freshly established connection into a ring port slot with the
  // full data-socket option set the wiring path applies.
  auto arm_healed = [&](Socket* slot, Socket conn) {
    *slot = std::move(conn);
    slot->SetTimeouts(socket_timeout_sec_);
    ArmSocketDeadlines(*slot, socket_timeout_sec_);
    slot->SetBufSizes(socket_buf_bytes_);
    set_nonblock(slot->fd());
  };
  // Classify a hard failure.  Returns false (fatal, *err set) when
  // healing is off — the pre-heal behavior, bit for bit.
  auto suspect_snd = [&](size_t i, const std::string& what) -> bool {
    if (!heal_on) {
      *err = what;
      return false;
    }
    Heal& h = heal[i];
    if (h.snd) return true;  // already healing this direction
    h.snd = true;
    h.snd_err = what;
    h.snd_t0 = std::chrono::steady_clock::now();
    h.snd_next = h.snd_t0;  // first re-dial immediately
    h.snd_attempts = 0;
    heal_span_open(i);
    GlobalFlightRecorder().Record(
        "link", control_cycle_seq_, "suspect snd ch=%d seq=%lld: %s",
        st[i].segs->ch, static_cast<long long>(ch_seq[i]),
        what.c_str());
    return true;
  };
  auto suspect_rcv = [&](size_t i, const std::string& what) -> bool {
    if (!heal_on) {
      *err = what;
      return false;
    }
    Heal& h = heal[i];
    if (h.rcv) return true;
    h.rcv = true;
    h.rcv_err = what;
    h.rcv_t0 = std::chrono::steady_clock::now();
    heal_span_open(i);
    GlobalFlightRecorder().Record(
        "link", control_cycle_seq_, "suspect rcv ch=%d seq=%lld: %s",
        st[i].segs->ch, static_cast<long long>(ch_seq[i]),
        what.c_str());
    return true;
  };
  auto escalate = [&](size_t i, bool snd_dir) {
    Heal& h = heal[i];
    const std::string& base_err = snd_dir ? h.snd_err : h.rcv_err;
    *err = base_err + " (link healing gave up after " +
           std::to_string(snd_dir ? h.snd_attempts : 0) + " reconnect "
           "attempts in " +
           std::to_string(ms_since(snd_dir ? h.snd_t0 : h.rcv_t0)) + "ms)";
    ok = false;
    link_heal_failures_.fetch_add(1);
    GlobalFlightRecorder().Record(
        "link", control_cycle_seq_, "escalate %s ch=%d: %s",
        snd_dir ? "snd" : "rcv", st[i].segs->ch, base_err.c_str());
  };
  // Abandon the in-flight re-dial (if any) and schedule the next one.
  auto redial_backoff = [&](Heal& h) {
    h.pending.Close();
    h.pending_connecting = false;
    h.snd_next =
        std::chrono::steady_clock::now() +
        std::chrono::milliseconds(jittered(
            std::min(1000, 50 << std::min(h.snd_attempts, 5))));
  };
  // Send the RESUME hello on a freshly connected socket and start the
  // ACK wait.  The 48-byte hello lands in an empty send buffer, so the
  // (bounded, 2 s) blocking send cannot actually park the loop.
  auto send_hello = [&](size_t i, Socket s) {
    Heal& h = heal[i];
    LinkResume lr;
    lr.origin = rank_;
    lr.ring = spec.ring_id;
    lr.channel = st[i].segs->ch;
    lr.epoch = epoch_.load();
    lr.seq = ch_seq[i];
    s.SetTimeouts(2);
    if (!s.SendAll(&lr, sizeof(lr))) {
      redial_backoff(h);
      return;
    }
    h.pending = std::move(s);
    h.pending_connecting = false;
    h.pending_deadline = std::chrono::steady_clock::now() +
                         std::chrono::milliseconds(2000);
  };
  // One sender-heal re-dial: NONBLOCKING connect (the in-flight fd joins
  // the poll set — a driver multiplexing several channels must not park
  // its healthy channels for a connect timeout) + RESUME hello; the ACK
  // is collected asynchronously too, so concurrent two-sided heals
  // (both neighbors re-dialing each other) cannot deadlock on each
  // other's ACK waits.
  auto try_redial = [&](size_t i) {
    Heal& h = heal[i];
    auto now = std::chrono::steady_clock::now();
    if (!h.snd || h.pending.valid() || now < h.snd_next ||
        h.snd_attempts >= link_retries_) {
      return;
    }
    ++h.snd_attempts;
    auto deadline = h.snd_t0 + std::chrono::milliseconds(heal_ms);
    int64_t left = std::chrono::duration_cast<std::chrono::milliseconds>(
                       deadline - now)
                       .count();
    if (left <= 0) return;  // the escalation sweep handles expiry
    std::string cerr;
    bool in_progress = false;
    Socket s = ConnectStart(peer_hosts_[spec.next_peer],
                            peer_ports_[spec.next_peer], &in_progress,
                            &cerr);
    if (!s.valid()) {
      redial_backoff(h);
      return;
    }
    h.pending_deadline =
        now + std::chrono::milliseconds(
                  std::min<int64_t>(1000, std::max<int64_t>(50, left)));
    if (in_progress) {
      h.pending = std::move(s);
      h.pending_connecting = true;
      return;
    }
    send_hello(i, std::move(s));
  };
  // Service a RESUME naming one of THIS cascade's prev edges: ACK the
  // authoritative receive cursor, swap the healed socket in.  Returns
  // false only when the peer's stream moved past ours — the missing tail
  // is unrecoverable and the rcv suspect escalates.
  auto handle_resume = [&](size_t i, const LinkResume& lr,
                           Socket conn) -> bool {
    ChState& c = st[i];
    Heal& h = heal[i];
    LinkResumeAck ack;
    ack.ok = (lr.seq == ch_seq[i]) ? 1 : 0;
    ack.seq = ch_seq[i];
    ack.step = c.rs;
    ack.offset = static_cast<int64_t>(c.ro);
    conn.SetTimeouts(2);
    if (!conn.SendAll(&ack, sizeof(ack))) {
      return true;  // sender abandoned this conn; it will re-dial
    }
    if (ack.ok == 0) {
      if (lr.seq > ch_seq[i] && h.rcv) {
        escalate(i, /*snd_dir=*/false);
        *err = h.rcv_err +
               " (link heal failed: peer moved to a newer stream — the "
               "lost bytes are no longer replayable)";
        return false;
      }
      return true;  // stale resume for an older stream: declined
    }
    arm_healed(c.port->prev, std::move(conn));
    link_reconnects_.fetch_add(1);
    auto now = std::chrono::steady_clock::now();
    if (h.rcv) {
      RecordLinkHealNs(
          std::chrono::duration_cast<std::chrono::nanoseconds>(now -
                                                               h.rcv_t0)
              .count());
      h.rcv = false;
      heal_span_close(i);
      GlobalFlightRecorder().Record(
          "link", control_cycle_seq_,
          "healed rcv ch=%d seq=%lld step=%lld off=%lld", st[i].segs->ch,
          static_cast<long long>(ch_seq[i]),
          static_cast<long long>(ack.step),
          static_cast<long long>(ack.offset));
    } else {
      // Asymmetric failure: the sender detected a break our side never
      // saw (e.g. its TCP_USER_TIMEOUT fired while our direction only
      // went silent).  Adopt the fresh edge — the ACK cursor makes the
      // rewind exact either way.
      GlobalFlightRecorder().Record(
          "link", control_cycle_seq_,
          "peer-initiated resume ch=%d seq=%lld", st[i].segs->ch,
          static_cast<long long>(ch_seq[i]));
    }
    last_progress = now;
    return true;
  };
  std::vector<pollfd> fds;
  // (channel idx, kind): 0 = send, 1 = recv, 2 = pending ACK,
  // 3 = data listener, 4 = send-socket liveness probe (a broken edge is
  // only visible to an idle sender through the reverse direction's
  // EOF/error — without the probe, a receiver whose sender has nothing
  // left to send would park for the full heal budget and escalate).
  std::vector<std::pair<int, int>> owner;
  while (ok) {
    auto now = std::chrono::steady_clock::now();
    // Injected conn-reset: fire once bytes have moved (mid-cascade).
    if (spec.ring_id == RING_GLOBAL && fault_conn_reset_.load()) {
      int64_t moved = 0;
      for (auto& c : st) moved += static_cast<int64_t>(c.tx + c.rx);
      if (moved > 0 && fault_conn_reset_.exchange(false)) {
        ChState& c0 = st[0];
        int fd = fault_reset_prev_ ? c0.port->prev->fd()
                                   : c0.port->next->fd();
        std::fprintf(stderr,
                     "horovod_tpu rank %d: fault injection: shutting down "
                     "data channel %d %s socket mid-cascade\n",
                     rank_, c0.segs->ch,
                     fault_reset_prev_ ? "recv" : "send");
        GlobalFlightRecorder().Record(
            "link", control_cycle_seq_,
            "fault-inject conn-reset ch=%d side=%s", c0.segs->ch,
            fault_reset_prev_ ? "recv" : "send");
        ::shutdown(fd, SHUT_RDWR);
      }
    }
    // Escalate suspects that exhausted their budget.
    for (size_t i = 0; ok && i < st.size(); ++i) {
      Heal& h = heal[i];
      if (h.snd &&
          (ms_since(h.snd_t0) > heal_ms ||
           (h.snd_attempts >= link_retries_ && !h.pending.valid()))) {
        escalate(i, /*snd_dir=*/true);
      }
      if (ok && h.rcv && ms_since(h.rcv_t0) > heal_ms) {
        escalate(i, /*snd_dir=*/false);
      }
      // Per-attempt bound on the in-flight re-dial (connect or ACK
      // phase): expire it and let the backoff schedule the next one.
      if (ok && h.pending.valid() && now > h.pending_deadline) {
        redial_backoff(h);
      }
    }
    if (!ok) break;
    for (size_t i = 0; i < st.size(); ++i) try_redial(i);
    // Parked resumes deposited by other cascades/drivers.
    if (heal_on && heal_inbox_size_.load() > 0) {
      for (size_t i = 0; ok && i < st.size(); ++i) {
        LinkResume lr;
        Socket conn;
        if (HealInboxTake(spec.ring_id, st[i].segs->ch, &lr, &conn)) {
          if (lr.epoch == epoch_.load() && lr.origin == spec.prev_peer) {
            ok = handle_resume(i, lr, std::move(conn));
          }
        }
      }
      if (!ok) break;
    }
    bool all_done = true;
    for (auto& c : st) {
      if (c.ss < nsteps || c.rs < nsteps) {
        all_done = false;
        break;
      }
    }
    if (all_done) break;
    const bool stall_active = stall_idx < st.size() && now < stall_until;
    bool heals_active = false;
    fds.clear();
    owner.clear();
    for (size_t i = 0; i < st.size(); ++i) {
      ChState& c = st[i];
      Heal& h = heal[i];
      heals_active = heals_active || h.snd || h.rcv;
      if (!h.snd) {
        if (c.ss < nsteps && c.so < c.ready[c.ss]) {
          fds.push_back({c.port->next->fd(), POLLOUT, 0});
          owner.emplace_back(static_cast<int>(i), 0);
        } else if (heal_on && c.ss < nsteps) {
          // Liveness probe: nothing eligible to send, but the edge still
          // owes bytes — a reverse-direction EOF/error is the only
          // prompt signal that the connection died under an idle sender.
          fds.push_back({c.port->next->fd(),
                         static_cast<short>(POLLIN | POLLRDHUP), 0});
          owner.emplace_back(static_cast<int>(i), 4);
        }
      }
      if (h.pending.valid()) {
        fds.push_back({h.pending.fd(),
                       static_cast<short>(h.pending_connecting ? POLLOUT
                                                               : POLLIN),
                       0});
        owner.emplace_back(static_cast<int>(i), 2);
      }
      if (!h.rcv && c.rs < nsteps && !(stall_active && i == stall_idx)) {
        fds.push_back({c.port->prev->fd(), POLLIN, 0});
        owner.emplace_back(static_cast<int>(i), 1);
      }
    }
    if (heal_on && data_listener_.valid()) {
      fds.push_back({data_listener_.fd(), POLLIN, 0});
      owner.emplace_back(-1, 3);
    }
    // No-progress budget (the pre-heal "link:" abort): suspended while a
    // suspect's own deadline governs, restored the moment healing ends.
    int64_t budget_left = -1;
    if (timeout_ms > 0) {
      budget_left = timeout_ms - ms_since(last_progress);
      if (budget_left <= 0 && !heals_active) {
        *err = "link: no progress for " +
               std::to_string(timeout_ms / 1000) + "s (peer hung?)";
        ok = false;
        break;
      }
    }
    int64_t slice = timeout_ms > 0 ? std::max<int64_t>(budget_left, 1)
                                   : -1;
    if (heal_on) {
      // Bounded slices keep inbox pickup, re-dial backoff timers and
      // suspect deadlines responsive even when no fd fires.
      slice = slice < 0 ? 250 : std::min<int64_t>(slice, 250);
    }
    if (stall_active) {
      int64_t stall_left =
          std::chrono::duration_cast<std::chrono::milliseconds>(
              stall_until - now)
              .count() +
          1;
      slice = slice < 0 ? stall_left
                        : std::min<int64_t>(slice, stall_left);
    }
    if (fds.empty()) {
      // Everything pending is parked (suspect waits / stall): nap one
      // slice and re-evaluate — deadlines above bound the loop.
      std::this_thread::sleep_for(
          std::chrono::milliseconds(std::max<int64_t>(
              1, std::min<int64_t>(slice < 0 ? 50 : slice, 50))));
      continue;
    }
    int rc = ::poll(fds.data(), static_cast<nfds_t>(fds.size()),
                    static_cast<int>(slice));
    if (rc < 0) {
      if (errno == EINTR) continue;
      *err = std::string("poll: ") + strerror(errno);
      ok = false;
      break;
    }
    if (rc == 0) {
      if (!heal_on && !stall_active) {
        *err = "link: no progress for " +
               std::to_string(timeout_ms / 1000) + "s (peer hung?)";
        ok = false;
        break;
      }
      continue;  // deadline sweeps at the loop top decide what's next
    }
    // Drain loops: after one poll wakeup, move bytes until EAGAIN (or a
    // cursor runs out of eligible work) — poll syscalls are the
    // expensive part on sandboxed kernels, so each should amortize as
    // much IO as the buffers will take.
    for (size_t f = 0; ok && f < fds.size(); ++f) {
      const int kind = owner[f].second;
      if (kind == 3) {
        if ((fds[f].revents & POLLIN) == 0) continue;
        // Accept every ready connection: RESUME hellos for my channels
        // are serviced here; anyone else's are parked in the inbox.
        // Bounded per drain pass: a genuine RESUME arrives with its
        // hello bytes already in flight (the sender writes it right
        // after connect), so a connection with nothing readable within
        // a fraction of a slice is a silent stray (health probe,
        // scanner) — drop it instead of parking the cascade, the
        // PollJoinCandidate discipline applied to the data listener.
        // Worst-case synchronous stall: 2 × 50 ms per pass, only while
        // someone is actively dialing the data port.
        for (int accepts = 0; accepts < 2; ++accepts) {
          Socket conn = TryAcceptNow(data_listener_);
          if (!conn.valid()) break;
          if (!WaitReadable(conn, 50)) continue;  // silent stray: drop
          // Peek-validate before committing to a read: a genuine RESUME
          // arrives as one 48-byte write right behind the connect, so
          // anything shorter after the readability wait is a stray (a
          // prober that sent a byte) or a torn hello (the sender will
          // re-dial) — drop it rather than park the drain loop in a
          // blocking read on an untrusted connection.
          LinkResume lr;
          ssize_t pk = ::recv(conn.fd(), &lr, sizeof(lr),
                              MSG_PEEK | MSG_DONTWAIT);
          if (pk != static_cast<ssize_t>(sizeof(lr)) ||
              !ValidLinkResume(lr)) {
            continue;
          }
          conn.SetTimeouts(1);
          if (!conn.RecvAll(&lr, sizeof(lr))) {  // consume; cannot block
            continue;
          }
          if (lr.epoch != epoch_.load()) continue;  // dead incarnation
          bool mine = false;
          for (size_t i = 0; i < st.size(); ++i) {
            if (st[i].segs->ch == lr.channel &&
                spec.ring_id == lr.ring && spec.prev_peer == lr.origin) {
              ok = handle_resume(i, lr, std::move(conn));
              mine = true;
              break;
            }
          }
          if (!mine && conn.valid()) {
            HealInboxPut(static_cast<int32_t>(lr.ring),
                         static_cast<int32_t>(lr.channel), lr,
                         std::move(conn));
          }
          if (!ok) break;
        }
        continue;
      }
      ChState& c = st[owner[f].first];
      Heal& h = heal[owner[f].first];
      // A swap earlier in THIS drain pass (listener-serviced resume)
      // invalidates poll entries that captured the replaced fd — touching
      // them would recv/send on a closed (or reused) descriptor.
      if ((kind == 0 || kind == 4) && fds[f].fd != c.port->next->fd()) {
        continue;
      }
      if (kind == 1 && fds[f].fd != c.port->prev->fd()) continue;
      if (kind == 2 &&
          (!h.pending.valid() || fds[f].fd != h.pending.fd())) {
        continue;
      }
      if (kind == 2 && h.pending_connecting) {
        if ((fds[f].revents & (POLLOUT | POLLERR | POLLHUP)) == 0) {
          continue;
        }
        std::string cerr;
        if (!ConnectFinish(h.pending, &cerr)) {
          redial_backoff(h);
          continue;
        }
        send_hello(owner[f].first, std::move(h.pending));
        continue;  // the ACK arrives through a later POLLIN
      }
      if (kind == 2) {
        if ((fds[f].revents & (POLLIN | POLLERR | POLLHUP)) == 0) {
          continue;
        }
        LinkResumeAck ack;
        bool got = h.pending.RecvAll(&ack, sizeof(ack)) &&
                   ValidLinkResumeAck(ack);
        if (got && ack.ok == 1 && ack.seq == ch_seq[owner[f].first] &&
            ack.step >= 0 && ack.step <= nsteps &&
            (ack.step == nsteps ||
             static_cast<size_t>(ack.offset) <=
                 seg_bytes(c, send_seg[ack.step]))) {
          // REWIND to the receiver's authoritative cursor: everything at
          // or past it is still intact in `base` (credit-chain
          // guarantee), so the resent bytes are identical.
          c.ss = static_cast<int>(ack.step);
          c.so = ack.step == nsteps ? 0
                                    : static_cast<size_t>(ack.offset);
          advance_sender(c);
          auto healed_at = std::chrono::steady_clock::now();
          arm_healed(c.port->next, std::move(h.pending));
          link_reconnects_.fetch_add(1);
          RecordLinkHealNs(
              std::chrono::duration_cast<std::chrono::nanoseconds>(
                  healed_at - h.snd_t0)
                  .count());
          h.snd = false;
          heal_span_close(owner[f].first);
          GlobalFlightRecorder().Record(
              "link", control_cycle_seq_,
              "healed snd ch=%d seq=%lld rewind step=%lld off=%lld",
              c.segs->ch,
              static_cast<long long>(ch_seq[owner[f].first]),
              static_cast<long long>(ack.step),
              static_cast<long long>(ack.offset));
          last_progress = healed_at;
        } else if (got && (ack.ok == 0 ||
                           ack.seq != ch_seq[owner[f].first])) {
          if (ack.seq < ch_seq[owner[f].first]) {
            // The receiver is still on an OLDER cascade of this channel
            // (e.g. draining the broken socket's buffered tail of the
            // previous collective — a FIN'd socket keeps delivering
            // buffered bytes).  It will catch up to our stream; back
            // off and re-dial instead of aborting a healable blip.
            redial_backoff(h);
          } else {
            // The receiver's stream moved PAST ours: the bytes it
            // still owed us are unrecoverable — escalate with the
            // original attribution.
            h.pending.Close();
            escalate(owner[f].first, /*snd_dir=*/true);
          }
        } else {
          // Dead or garbled ACK conn: back off and re-dial.
          h.pending.Close();
          h.snd_next = std::chrono::steady_clock::now() +
                       std::chrono::milliseconds(jittered(std::min(
                           1000, 50 << std::min(h.snd_attempts, 5))));
        }
        continue;
      }
      if (kind == 4) {
        if ((fds[f].revents &
             (POLLIN | POLLRDHUP | POLLERR | POLLHUP)) == 0) {
          continue;
        }
        // The send socket should never become readable: EOF/error means
        // the edge died while this sender had nothing eligible to send.
        char probe;
        ssize_t k = ::recv(c.port->next->fd(), &probe, 1, 0);
        if (k == 0 ||
            (k < 0 && errno != EAGAIN && errno != EWOULDBLOCK &&
             errno != EINTR)) {
          ok = suspect_snd(
              owner[f].first,
              std::string("send to peer: ") +
                  (k == 0 ? "connection closed (peer process exited?)"
                          : strerror(errno)));
        }
        continue;
      }
      if (kind == 0) {
        if ((fds[f].revents & (POLLOUT | POLLERR | POLLHUP)) == 0) {
          continue;
        }
        while (c.ss < nsteps && c.so < c.ready[c.ss]) {
          const uint8_t* p =
              base + c.segs->seg_off[send_seg[c.ss]] * esize + c.so;
          ssize_t k = ::send(c.port->next->fd(), p,
                             c.ready[c.ss] - c.so, MSG_NOSIGNAL);
          if (k > 0) {
            c.so += static_cast<size_t>(k);
            c.tx += static_cast<size_t>(k);
            last_progress = std::chrono::steady_clock::now();
            advance_sender(c);
          } else if (k < 0 && (errno == EAGAIN || errno == EWOULDBLOCK ||
                               errno == EINTR)) {
            break;
          } else {
            ok = suspect_snd(owner[f].first,
                             std::string("send to peer: ") +
                                 strerror(errno));
            break;
          }
        }
      } else {
        if ((fds[f].revents & (POLLIN | POLLERR | POLLHUP)) == 0) continue;
        while (c.rs < nsteps) {
          const bool reducing = c.rs <= last_rs;
          const size_t want = seg_bytes(c, recv_seg[c.rs]) - c.ro;
          uint8_t* dst =
              reducing ? c.tmp.get() + c.ro
                       : base + c.segs->seg_off[recv_seg[c.rs]] * esize +
                             c.ro;
          ssize_t k = ::recv(c.port->prev->fd(), dst, want, 0);
          if (k > 0) {
            c.ro += static_cast<size_t>(k);
            c.rx += static_cast<size_t>(k);
            last_progress = std::chrono::steady_clock::now();
            credit_recv(c, static_cast<size_t>(k));
          } else if (k == 0) {
            ok = suspect_rcv(
                owner[f].first,
                "recv from peer: connection closed (peer process "
                "exited?)");
            break;
          } else if (errno == EAGAIN || errno == EWOULDBLOCK ||
                     errno == EINTR) {
            break;
          } else {
            ok = suspect_rcv(owner[f].first,
                             std::string("recv from peer: ") +
                                 strerror(errno));
            break;
          }
        }
      }
    }
  }
  // Close any mid-flight re-dial and restore blocking mode on the ring
  // sockets (frame-based ops — broadcast relays, allgather steps — rely
  // on blocking reads).  A failed cascade's sockets may already be dead;
  // restoring flags on them is harmless.
  for (auto& h : heal) h.pending.Close();
  for (auto& c : st) {
    if (c.port->next->valid()) set_block(c.port->next->fd());
    if (c.port->prev->valid()) set_block(c.port->prev->fd());
  }
  }  // transport branch
  wire_ns_.fetch_add(std::chrono::duration_cast<std::chrono::nanoseconds>(
                         std::chrono::steady_clock::now() - t0)
                         .count() -
                     local_reduce_ns);
  for (auto& c : st) {
    CountPortBytes(*c.port, static_cast<int64_t>(c.tx),
                   static_cast<int64_t>(c.rx), spec.compressed);
  }
  return ok;
}

// Minimum payload per extra channel: below this, sharding just multiplies
// per-message overhead (syscalls, poll wakeups) without any wire to hide,
// so the fan-out degrades gracefully toward 1 for small collectives.
static constexpr int64_t kMinBytesPerChannel = 256 * 1024;

bool Engine::ChanneledRingAllreduce(uint8_t* base, int64_t count,
                                    DataType dtype, ReduceOp op,
                                    const RingSpec& spec,
                                    const ExecCtx& ctx,
                                    const std::string& tname,
                                    std::string* err, bool rs_only) {
  // Under a wire codec, `count` is the number of quantized BLOCKS and
  // the element size is the block size — segment and channel-shard
  // arithmetic runs unchanged over uniform block elements.
  const size_t esize =
      spec.codec ? spec.codec->block_bytes : DataTypeSize(dtype);
  std::vector<int64_t> seg_count, seg_off;
  EvenSegments(count, spec.rsize, &seg_count, &seg_off);
  // Effective fan-out, deterministic across ranks (count, esize, and the
  // committed channel count all agree).  Any value is VALUE-safe: channel
  // shards slice WITHIN each ring segment, so an element's segment id —
  // hence the rank order its reduction applies in — never depends on the
  // fan-out, and results are bit-identical for channels = 1..N.
  int nch = std::max(1, ctx.nchannels);
  const int64_t bytes = count * static_cast<int64_t>(esize);
  while (nch > 1 && bytes / nch < kMinBytesPerChannel) --nch;
  // Per-channel slices of every segment: channel c owns
  // seg_count[s]/nch (+1 for the first seg_count[s]%nch channels)
  // elements at a contiguous offset inside segment s.
  auto channel_segs = [&](int c, std::vector<int64_t>* cnt,
                          std::vector<int64_t>* off) {
    cnt->resize(spec.rsize);
    off->resize(spec.rsize);
    for (int s = 0; s < spec.rsize; ++s) {
      int64_t n = seg_count[s], q = n / nch, r = n % nch;
      (*cnt)[s] = q + (c < r ? 1 : 0);
      (*off)[s] = seg_off[s] + q * c + std::min<int64_t>(c, r);
    }
  };
  if (nch == 1 && ctx.nchannels == 1 && num_channels_ == 1) {
    // HOROVOD_NUM_CHANNELS=1 restores the pre-channel discipline exactly:
    // the stepped reduce-scatter phase (with its within-step chunked
    // recv/reduce overlap) followed by the stepped allgather, one port
    // pair, per-step barriers.  The streaming cascade below is the
    // multi-channel data plane.
    const int ch = ctx.channel;
    timeline_.ActivityStartCh(tname, spec.span + std::to_string(ch), ch + 1);
    bool ok = RingReduceScatterPhaseCh(base, seg_count, seg_off, dtype, op,
                                       spec, ch, err);
    if (ok && !rs_only) {
      ok = RingAllgatherPhaseCh(base, seg_count, seg_off, esize, spec, ch,
                                err);
    }
    timeline_.ActivityEndCh(tname, ch + 1);
    return ok;
  }
  std::vector<ChannelSegs> all(nch);
  for (int c = 0; c < nch; ++c) {
    all[c].ch = ctx.channel + c;
    channel_segs(c, &all[c].seg_count, &all[c].seg_off);
  }
  // Driver threads: channels are cheap (a socket pair + cursor state) but
  // threads are not — one driver can multiplex several channels' cascades
  // in its poll loop, so the thread count follows the CORE budget
  // (HOROVOD_CHANNEL_DRIVERS), not the channel count.  A 2-core box runs
  // 4 channels on 1 driver; a 16-core host splits them across 4.
  const int drivers =
      std::max(1, std::min({nch, channel_drivers_, pool_.size() + 1}));
  auto run_part = [&](const std::vector<ChannelSegs>& part,
                      std::string* derr) -> bool {
    for (const auto& cs : part) {
      timeline_.ActivityStartCh(tname, spec.span + std::to_string(cs.ch),
                                cs.ch + 1);
    }
    bool ok = StreamingRingChannels(base, part, dtype, op, spec, tname,
                                    derr, rs_only);
    for (const auto& cs : part) timeline_.ActivityEndCh(tname, cs.ch + 1);
    return ok;
  };
  if (drivers <= 1) {
    return run_part(all, err);
  }
  std::vector<std::vector<ChannelSegs>> parts(drivers);
  for (int c = 0; c < nch; ++c) {
    parts[c % drivers].push_back(std::move(all[c]));
  }
  std::vector<std::string> derrs(drivers);
  std::vector<uint8_t> dok(drivers, 0);
  TaskLatch latch(drivers - 1);
  for (int d = 1; d < drivers; ++d) {
    pool_.Submit([&, d] {
      dok[d] = run_part(parts[d], &derrs[d]) ? 1 : 0;
      latch.Done();
    });
  }
  dok[0] = run_part(parts[0], &derrs[0]) ? 1 : 0;
  latch.Wait();
  for (int d = 0; d < drivers; ++d) {
    if (!dok[d]) {
      // First failed driver wins the attribution; a peer death EOFs
      // every channel to that neighbor, so the messages agree.
      *err = derrs[d];
      return false;
    }
  }
  return true;
}

bool Engine::UseSmallAlgo(int64_t nbytes, const ExecCtx& ctx) const {
  if (!shm_ring_active_ || shm_star_.empty() || group_size_ <= 1) {
    return false;
  }
  const int64_t thr = algo_threshold_.load();
  if (thr <= 0 || nbytes > thr) return false;
  // Serial execution context only: a concurrent wave slice owns ONE
  // channel, not the star edges (two responses folding on the same star
  // ring would interleave their streams).  The serial path always passes
  // the full committed fan-out, so for a given response list this
  // predicate evaluates identically on every member of the group — the
  // wire patterns cannot split.
  return ctx.nchannels >= num_channels_;
}

bool Engine::StarBroadcast(uint8_t* base, size_t nbytes, std::string* err) {
  const int to_ms = socket_timeout_sec_ * 1000;
  const int L = group_size_;
  // Chunk round-robin ACROSS members (chunk sized to half the ring so a
  // write never has to wait for a full drain): members consume
  // concurrently, so the leader's wall time is ~one buffer, not
  // (L-1) sequential full sends.
  const size_t chunk =
      std::min(kRelayChunk, static_cast<size_t>(shm_ring_bytes_ / 2));
  if (local_index_ == 0) {
    for (size_t off = 0; off < nbytes; off += chunk) {
      const size_t n = std::min(chunk, nbytes - off);
      for (int m = 1; m < L; ++m) {
        std::string detail;
        if (!shm_star_[m].tx.WriteAll(base + off, n, to_ms, &detail)) {
          *err = "rank " + std::to_string(group_members_[m]) +
                 " failed during star broadcast: send to member: " + detail;
          return false;
        }
        CountShmBytes(static_cast<int64_t>(n), 0);
      }
    }
  } else {
    // The first chunk's legitimate wait covers the leader's whole
    // cross-host ring (2(H-1) steps), hence the nnodes-scaled budget.
    const int wait_ms =
        to_ms > 0 ? to_ms * (2 * nnodes_ + group_size_ + 2) : 0;
    for (size_t off = 0; off < nbytes; off += chunk) {
      const size_t n = std::min(chunk, nbytes - off);
      std::string detail;
      if (!shm_star_[0].rx.ReadAll(base + off, n, wait_ms, &detail)) {
        *err = "rank " + std::to_string(group_members_[0]) +
               " failed during star broadcast: recv from leader: " + detail;
        return false;
      }
      CountShmBytes(0, static_cast<int64_t>(n));
    }
  }
  return true;
}

bool Engine::StarFoldAllreduce(uint8_t* base, int64_t count, DataType dtype,
                               ReduceOp op, bool broadcast_result,
                               std::string* err) {
  const size_t esize = DataTypeSize(dtype);
  const size_t nbytes = static_cast<size_t>(count) * esize;
  const int L = group_size_;
  const int to_ms = socket_timeout_sec_ * 1000;
  const int gather_ms = to_ms > 0 ? to_ms * (L + 2) : 0;
  if (local_index_ != 0) {
    std::string detail;
    if (!shm_star_[0].tx.WriteAll(base, nbytes, gather_ms, &detail)) {
      *err = "rank " + std::to_string(group_members_[0]) +
             " failed during star gather: send to leader: " + detail;
      return false;
    }
    CountShmBytes(static_cast<int64_t>(nbytes), 0);
    if (broadcast_result) return StarBroadcast(base, nbytes, err);
    return true;
  }
  // Leader: gather every member's RAW buffer, then reproduce the ring
  // reduce-scatter's fold segment by segment.  Segment s accumulates
  // contributions in group-position order s+1, s+2, ..., s+L (mod L) —
  // the order the ring's step schedule applies them in under the
  // vrank = position - 1 convention (see TcpRingSpec/EvenSegments) —
  // AND with the ring's exact operand roles (dst = the incoming
  // position's raw data, src = the running accumulator), because
  // ReduceInto's min/max tie-breaking and NaN propagation are operand-
  // ORDER-sensitive even where the math is commutative.  Identical
  // kernel, identical segment boundaries, identical operand sequence ⇒
  // the algo switch can never change a bit.
  std::vector<std::unique_ptr<uint8_t[]>> contrib(L);
  contrib[0].reset(new uint8_t[nbytes]);
  memcpy(contrib[0].get(), base, nbytes);
  for (int m = 1; m < L; ++m) {
    contrib[m].reset(new uint8_t[nbytes]);
    std::string detail;
    if (!shm_star_[m].rx.ReadAll(contrib[m].get(), nbytes, gather_ms,
                                 &detail)) {
      *err = "rank " + std::to_string(group_members_[m]) +
             " failed during star gather: recv from member: " + detail;
      return false;
    }
    CountShmBytes(0, static_cast<int64_t>(nbytes));
  }
  std::vector<int64_t> seg_count, seg_off;
  EvenSegments(count, L, &seg_count, &seg_off);
  int64_t max_seg = 0;
  for (auto c : seg_count) max_seg = std::max(max_seg, c);
  std::unique_ptr<uint8_t[]> acc(new uint8_t[max_seg * esize]);
  std::unique_ptr<uint8_t[]> nxt(new uint8_t[max_seg * esize]);
  for (int s = 0; s < L; ++s) {
    if (seg_count[s] == 0) continue;
    const size_t sb = static_cast<size_t>(seg_count[s]) * esize;
    const size_t boff = static_cast<size_t>(seg_off[s]) * esize;
    memcpy(acc.get(), contrib[(s + 1) % L].get() + boff, sb);
    for (int k = 1; k < L; ++k) {
      memcpy(nxt.get(), contrib[(s + 1 + k) % L].get() + boff, sb);
      ReduceIntoTimed(nxt.get(), acc.get(), seg_count[s], dtype, op);
      acc.swap(nxt);
    }
    memcpy(base + boff, acc.get(), sb);
  }
  if (broadcast_result) return StarBroadcast(base, nbytes, err);
  return true;
}

// Two-level allreduce over the committed topology: intra-host ring
// reduce-scatter over shm (or the star fold under the small-tensor algo) →
// owned-segment gather to the group leader → leaders' channel-sharded TCP
// ring across hosts → star broadcast back down.  The reference
// decomposition (NCCL reduce → cross-node MPI → NCCL broadcast,
// operations.cc:1025-1187), generalized from the eager
// HOROVOD_HIERARCHICAL_ALLREDUCE into the native engine.  Deterministic
// per topology; transport, channel count, and the algo threshold never
// change bits within one topology.
bool Engine::TwoLevelIntraReduce(uint8_t* base, int64_t count,
                                 DataType dtype, ReduceOp op,
                                 const std::string& name, const ExecCtx& ctx,
                                 bool compressed_payload, std::string* err) {
  const size_t esize = DataTypeSize(dtype);
  const size_t nbytes = static_cast<size_t>(count) * esize;
  const int L = group_size_;
  const int p = local_index_;
  const int to_ms = socket_timeout_sec_ * 1000;
  const int gather_ms = to_ms > 0 ? to_ms * (L + 2) : 0;
  std::string detail;
  if (L <= 1) return true;
  if (UseSmallAlgo(static_cast<int64_t>(nbytes), ctx)) {
    // Small path: 2 shm hops of latency instead of 2(L-1) ring steps;
    // leaves the leader holding the host-reduced buffer.
    return StarFoldAllreduce(base, count, dtype, op,
                             /*broadcast_result=*/false, err);
  }
  std::vector<int64_t> seg_count, seg_off;
  EvenSegments(count, L, &seg_count, &seg_off);
  RingSpec shm = ShmRingSpec();
  shm.compressed = compressed_payload;
  timeline_.ActivityStartCh(name, "SHM_CH0", 1);
  bool ok = RingReduceScatterPhaseCh(base, seg_count, seg_off, dtype,
                                     op, shm, 0, &detail);
  timeline_.ActivityEndCh(name, 1);
  if (!ok) {
    *err = TransportError("two-level allreduce (intra ring)", name,
                          detail, group_members_[(p + 1) % L],
                          group_members_[(p - 1 + L) % L]);
    return false;
  }
  // Gather the host-reduced segments onto the leader: position q owns
  // segment q after the reduce-scatter (the vrank = position - 1
  // convention, see EvenSegments), so the leader's buffer becomes the
  // full host sum (its own segment 0 is already in place).
  if (p == 0) {
    for (int q = 1; q < L; ++q) {
      const int s = q;
      if (seg_count[s] == 0) continue;
      const size_t n = static_cast<size_t>(seg_count[s]) * esize;
      if (!shm_star_[q].rx.ReadAll(base + seg_off[s] * esize, n,
                                   gather_ms, &detail)) {
        *err = "rank " + std::to_string(group_members_[q]) +
               " failed during two-level allreduce of '" + name +
               "' (segment gather): " + detail;
        return false;
      }
      CountShmBytes(0, static_cast<int64_t>(n));
    }
  } else {
    const int s = p;
    if (seg_count[s] > 0) {
      const size_t n = static_cast<size_t>(seg_count[s]) * esize;
      if (!shm_star_[0].tx.WriteAll(base + seg_off[s] * esize, n,
                                    gather_ms, &detail)) {
        *err = "rank " + std::to_string(group_members_[0]) +
               " failed during two-level allreduce of '" + name +
               "' (segment gather): " + detail;
        return false;
      }
      CountShmBytes(static_cast<int64_t>(n), 0);
    }
  }
  return true;
}

bool Engine::TwoLevelAllreduce(uint8_t* base, int64_t count, DataType dtype,
                               ReduceOp op, const std::string& name,
                               const ExecCtx& ctx, WireDtype wire,
                               bool compressed_payload, std::string* err) {
  const size_t esize = DataTypeSize(dtype);
  const size_t nbytes = static_cast<size_t>(count) * esize;
  const int L = group_size_;
  const int p = local_index_;
  std::string detail;
  if (L > 1) {
    if (!TwoLevelIntraReduce(base, count, dtype, op, name, ctx,
                             compressed_payload, err)) {
      return false;
    }
  }
  if (p == 0 && nnodes_ > 1) {
    RingSpec cross = CrossRingSpec();
    // Quantized wire compresses exactly the hop that crosses a real
    // network: the leaders' cross-host ring.  The intra-host shm phases
    // above stay at the buffer's dtype (intra-host bandwidth is cheap;
    // skipping their requantization also halves the accumulated error).
    bool ok;
    if ((wire == WireDtype::INT8 || wire == WireDtype::FP8) &&
        dtype == DataType::FLOAT32) {
      ok = CompressedRingAllreduce(base, count, wire, op, cross, ctx, name,
                                   &detail);
    } else {
      cross.compressed = compressed_payload;
      ok = ChanneledRingAllreduce(base, count, dtype, op, cross, ctx, name,
                                  &detail);
    }
    if (!ok) {
      *err = TransportError(
          "two-level allreduce (cross ring)", name, detail,
          group_leaders_[(node_id_ + 1) % nnodes_],
          group_leaders_[(node_id_ - 1 + nnodes_) % nnodes_]);
      return false;
    }
  }
  if (L > 1) {
    if (!StarBroadcast(base, nbytes, err)) return false;
  }
  return true;
}

bool Engine::StarScatterShards(uint8_t* base,
                               const std::vector<int64_t>& shard_count,
                               const std::vector<int64_t>& shard_off,
                               size_t esize, std::string* err) {
  const int to_ms = socket_timeout_sec_ * 1000;
  const int L = group_size_;
  if (L <= 1) return true;
  if (local_index_ == 0) {
    for (int m = 1; m < L; ++m) {
      if (shard_count[m] <= 0) continue;
      const size_t n = static_cast<size_t>(shard_count[m]) * esize;
      std::string detail;
      if (!shm_star_[m].tx.WriteAll(base + shard_off[m] * esize, n,
                                    to_ms > 0 ? to_ms * (L + 2) : 0,
                                    &detail)) {
        *err = "rank " + std::to_string(group_members_[m]) +
               " failed during star shard scatter: send to member: " +
               detail;
        return false;
      }
      CountShmBytes(static_cast<int64_t>(n), 0);
    }
  } else {
    // The legitimate wait covers the leader's whole cross-host ring,
    // like StarBroadcast's first chunk.
    const int wait_ms =
        to_ms > 0 ? to_ms * (2 * nnodes_ + group_size_ + 2) : 0;
    if (shard_count[local_index_] > 0) {
      const size_t n =
          static_cast<size_t>(shard_count[local_index_]) * esize;
      std::string detail;
      if (!shm_star_[0].rx.ReadAll(base + shard_off[local_index_] * esize,
                                   n, wait_ms, &detail)) {
        *err = "rank " + std::to_string(group_members_[0]) +
               " failed during star shard scatter: recv from leader: " +
               detail;
        return false;
      }
      CountShmBytes(0, static_cast<int64_t>(n));
    }
  }
  return true;
}

bool Engine::TwoLevelReduceScatter(uint8_t* base, int64_t count,
                                   DataType dtype, ReduceOp op,
                                   const std::vector<int64_t>& shard_count,
                                   const std::vector<int64_t>& shard_off,
                                   const std::string& name,
                                   const ExecCtx& ctx,
                                   bool compressed_payload,
                                   std::string* err) {
  // Preconditions (checked by ExecReducescatter): count % size == 0,
  // node-major contiguous host grouping, equal group sizes — together
  // they make the committed per-rank shards subdivide the cross ring's
  // EvenSegments(count, H) exactly, so every hop below slices along the
  // fold's own geometry and the bits equal the two-level allreduce's.
  const size_t esize = DataTypeSize(dtype);
  if (group_size_ > 1) {
    if (!TwoLevelIntraReduce(base, count, dtype, op, name, ctx,
                             compressed_payload, err)) {
      return false;
    }
  }
  if (local_index_ == 0 && nnodes_ > 1) {
    RingSpec cross = CrossRingSpec();
    cross.compressed = compressed_payload;
    // Engine-wide vrank convention: this leader ends the RS half owning
    // cross segment node_id — its own hosts' shard block.
    std::string detail;
    if (!ChanneledRingAllreduce(base, count, dtype, op, cross, ctx, name,
                                &detail, /*rs_only=*/true)) {
      *err = TransportError(
          "two-level reducescatter (cross ring)", name, detail,
          group_leaders_[(node_id_ + 1) % nnodes_],
          group_leaders_[(node_id_ - 1 + nnodes_) % nnodes_]);
      return false;
    }
  }
  if (group_size_ > 1) {
    // Leader → members: each member gets exactly its own global shard
    // (indexed by group position).
    std::vector<int64_t> mcount(group_size_), moff(group_size_);
    for (int m = 0; m < group_size_; ++m) {
      const int r = group_members_[m];
      mcount[m] = shard_count[r];
      moff[m] = shard_off[r];
    }
    if (!StarScatterShards(base, mcount, moff, esize, err)) return false;
  }
  return true;
}

bool Engine::RunAllreduceCascade(uint8_t* exec_buf, int64_t total,
                                 DataType exec_dtype, ReduceOp op,
                                 WireDtype wire, bool quantized,
                                 bool half_wire, bool small,
                                 const char* op_label,
                                 const std::string& tname,
                                 const ExecCtx& ctx, std::string* msg) {
  if (two_level_) {
    return TwoLevelAllreduce(exec_buf, total, exec_dtype, op, tname, ctx,
                             quantized ? wire : WireDtype::FP32,
                             half_wire, msg);
  }
  if (small) {
    // Whole-world host group: the star fold IS the collective —
    // 2 shm hops instead of 2(N-1) ring steps, bit-equal by the fold-
    // order emulation.
    return StarFoldAllreduce(exec_buf, total, exec_dtype, op,
                             /*broadcast_result=*/true, msg);
  }
  std::string err;
  RingSpec spec = FlatRingSpec();
  bool ok;
  if (quantized) {
    ok = CompressedRingAllreduce(exec_buf, total, wire, op, spec, ctx,
                                 tname, &err);
  } else {
    spec.compressed = half_wire;
    ok = ChanneledRingAllreduce(exec_buf, total, exec_dtype, op, spec,
                                ctx, tname, &err);
  }
  if (!ok) {
    *msg = TransportError(op_label, tname, err, (rank_ + 1) % size_,
                          (rank_ - 1 + size_) % size_);
  }
  return ok;
}

void Engine::ExecAllreduce(const Response& response,
                           std::vector<TensorTableEntry>& entries,
                           const ExecCtx& ctx) {
  // Ghost execution (backup workers): a rank OUTSIDE a partial commit's
  // participant set holds no entries but still drives the identical
  // full-world ring over a zeroed buffer — zero is the SUM identity, so
  // participants' results are exactly the survivors' sum while the wire
  // pattern (and therefore every rank's socket schedule) is unchanged.
  const bool ghost = entries.empty();
  const std::string tname =
      ghost ? response.tensor_names[0] : entries[0].name;
  for (auto& e : entries) timeline_.Start(e.name);
  DataType dtype = ghost ? static_cast<DataType>(response.partial_dtype)
                         : entries[0].dtype;
  int64_t total = response.partial_elems;
  if (!ghost) {
    total = 0;
    for (auto& e : entries) total += e.shape.num_elements();
  }
  // Divisor-correct averaging: the frontends divide by the COMMITTED
  // participant count, not blindly by size.
  const int nparticipants = response.participants.empty()
      ? size_ : static_cast<int>(response.participants.size());

  if (size_ > 1) {
    const size_t esize = DataTypeSize(dtype);
    std::vector<uint8_t> ghost_buf;
    void* buf;
    if (ghost) {
      ghost_buf.assign(static_cast<size_t>(total) * esize, 0);
      buf = ghost_buf.data();
    } else {
      buf = entries[0].data;
    }
    // Per-slot fusion scratch: ctx.channel doubles as the scratch slot so
    // concurrent wave responses never share a buffer.
    std::vector<uint8_t>& fusion_buffer = fusion_buffers_[ctx.channel];
    if (entries.size() > 1) {
      timeline_.ActivityStart(tname, "MEMCPY_IN_FUSION_BUFFER");
      if (fusion_buffer.size() < static_cast<size_t>(total) * esize) {
        fusion_buffer.resize(static_cast<size_t>(total) * esize);
      }
      int64_t off = 0;
      for (auto& e : entries) {
        size_t n = static_cast<size_t>(e.shape.num_elements()) * esize;
        memcpy(fusion_buffer.data() + off, e.data, n);
        off += n;
      }
      buf = fusion_buffer.data();
      timeline_.ActivityEnd(tname);
    }
    bool ok;
    std::string msg;
    auto t0 = std::chrono::steady_clock::now();
    // Committed wire format for this response (negotiated + validated;
    // FP32 unless every rank requested otherwise for an fp32 allreduce).
    WireDtype wire = dtype == DataType::FLOAT32 ? response.wire_dtype
                                                : WireDtype::FP32;
    const bool quantized =
        wire == WireDtype::INT8 || wire == WireDtype::FP8;
    const bool half_wire =
        wire == WireDtype::FP16 || wire == WireDtype::BF16;
    // fp16/bf16 wire: RNE-convert the whole payload to a half staging
    // buffer ONCE, run the ordinary collective at the half dtype (flat
    // ring, star fold, or the full two-level hierarchy — every transport
    // and path works unchanged), convert back at the end.  Wire traffic,
    // fusion staging and reduction all halve.
    std::vector<uint16_t> halfbuf;
    uint8_t* exec_buf = static_cast<uint8_t*>(buf);
    DataType exec_dtype = dtype;
    if (half_wire) {
      halfbuf.resize(static_cast<size_t>(total));
      const float* fp = static_cast<const float*>(buf);
      auto q0 = std::chrono::steady_clock::now();
      if (wire == WireDtype::FP16) {
        for (int64_t i = 0; i < total; ++i) halfbuf[i] = FloatToHalf(fp[i]);
      } else {
        for (int64_t i = 0; i < total; ++i) halfbuf[i] = FloatToBF16(fp[i]);
      }
      quantize_ns_.fetch_add(
          std::chrono::duration_cast<std::chrono::nanoseconds>(
              std::chrono::steady_clock::now() - q0)
              .count());
      wire_bytes_saved_.fetch_add(total * 2);  // 4 -> 2 bytes per element
      exec_buf = reinterpret_cast<uint8_t*>(halfbuf.data());
      exec_dtype = wire == WireDtype::FP16 ? DataType::FLOAT16
                                           : DataType::BFLOAT16;
    }
    switch (wire) {
      case WireDtype::FP16: wire_fp16_count_.fetch_add(1); break;
      case WireDtype::BF16: wire_bf16_count_.fetch_add(1); break;
      case WireDtype::INT8: wire_int8_count_.fetch_add(1); break;
      case WireDtype::FP8: wire_fp8_count_.fetch_add(1); break;
      case WireDtype::FP32: break;
    }
    if (wire != WireDtype::FP32) {
      // Per-response WIRE<dtype> marker: compressed responses are
      // visible in traces next to their ALGO marker.
      char wm[16];
      std::snprintf(wm, sizeof(wm), "WIRE_%s", WireDtypeName(wire));
      for (char* c = wm; *c; ++c) *c = static_cast<char>(toupper(*c));
      timeline_.Algo(tname, wm);
    }
    const int64_t exec_bytes =
        total * static_cast<int64_t>(DataTypeSize(exec_dtype));
    // Quantized responses skip the star fold: its gather/fold path has
    // no block semantics, and sub-threshold payloads gain nothing from
    // compression anyway.  Deterministic across ranks — the wire format
    // is committed per response.
    const bool small = UseSmallAlgo(exec_bytes, ctx) && !quantized;
    // One ALGO marker per response: which path this allreduce took (the
    // two-level intra phase applies the same size-based selection).
    timeline_.Algo(tname, small ? "ALGO_SMALL" : "ALGO_RING");
    (small ? algo_small_count_ : algo_ring_count_).fetch_add(1);
    timeline_.ActivityStart(tname, two_level_ ? "TWO_LEVEL_ALLREDUCE"
                                   : small   ? "STAR_ALLREDUCE"
                                             : "RING_ALLREDUCE");
    ok = RunAllreduceCascade(exec_buf, total, exec_dtype,
                             response.red_op, wire, quantized, half_wire,
                             small, "allreduce", tname, ctx, &msg);
    if (ok && half_wire) {
      float* fp = static_cast<float*>(buf);
      auto q0 = std::chrono::steady_clock::now();
      if (wire == WireDtype::FP16) {
        for (int64_t i = 0; i < total; ++i) fp[i] = HalfToFloat(halfbuf[i]);
      } else {
        for (int64_t i = 0; i < total; ++i) fp[i] = BF16ToFloat(halfbuf[i]);
      }
      quantize_ns_.fetch_add(
          std::chrono::duration_cast<std::chrono::nanoseconds>(
              std::chrono::steady_clock::now() - q0)
              .count());
    }
    int64_t wall = std::chrono::duration_cast<std::chrono::nanoseconds>(
                       std::chrono::steady_clock::now() - t0)
                       .count();
    if (ctx.wave_allreduce_wall_ns != nullptr) {
      *ctx.wave_allreduce_wall_ns = wall;  // wave accounts the max once
    } else {
      allreduce_ns_.fetch_add(wall);
    }
    allreduce_bytes_.fetch_add(total * static_cast<int64_t>(esize));
    timeline_.ActivityEnd(tname);
    if (!ok) {
      for (auto& e : entries) FinishEntry(e, Status::Aborted(msg));
      return;
    }
    if (entries.size() > 1) {
      timeline_.ActivityStart(tname, "MEMCPY_OUT_FUSION_BUFFER");
      int64_t off = 0;
      for (auto& e : entries) {
        size_t n = static_cast<size_t>(e.shape.num_elements()) * esize;
        memcpy(e.data, fusion_buffer.data() + off, n);
        off += n;
      }
      timeline_.ActivityEnd(tname);
      // High-water cap: a one-off oversized batch (> the fusion
      // threshold) must not pin its allocation for the process lifetime.
      if (static_cast<int64_t>(fusion_buffer.capacity()) >
          fusion_threshold_.load()) {
        std::vector<uint8_t>().swap(fusion_buffer);
      }
    }
  }
  for (auto& e : entries) {
    timeline_.End(e.name, e.dtype, e.shape.DebugString());
    FinishEntry(e, Status::OK(), nparticipants);
  }
}

void Engine::ExecAllgather(const Response& response,
                           std::vector<TensorTableEntry>& entries,
                           const ExecCtx& ctx) {
  // Allgather is never fused (matches the reference); one entry.
  TensorTableEntry& e = entries[0];
  timeline_.Start(e.name);
  const size_t esize = DataTypeSize(e.dtype);
  int64_t slice = 1;
  for (int d = 1; d < e.shape.ndim(); ++d) slice *= e.shape.dim(d);

  int64_t total_dim0 = 0;
  for (auto v : response.tensor_sizes) total_dim0 += v;

  auto hs = GetHandle(e.handle);
  if (hs == nullptr) return;
  hs->result.resize(static_cast<size_t>(total_dim0 * slice) * esize);
  hs->result_shape.clear();
  hs->result_shape.push_back(total_dim0);
  for (int d = 1; d < e.shape.ndim(); ++d) {
    hs->result_shape.push_back(e.shape.dim(d));
  }

  std::vector<int64_t> block_bytes(size_), block_off(size_);
  int64_t off = 0;
  for (int r = 0; r < size_; ++r) {
    block_bytes[r] = response.tensor_sizes[r] * slice *
                     static_cast<int64_t>(esize);
    block_off[r] = off;
    off += block_bytes[r];
  }
  memcpy(hs->result.data() + block_off[rank_], e.data,
         static_cast<size_t>(block_bytes[rank_]));

  if (size_ > 1) {
    // The sharded optimizer's parameter/update allgather gets its own
    // span so ZeRO steps are attributable in traces next to "RS", and
    // the FSDP plane's just-in-time parameter gathers get "FSDP_AG" so
    // prefetch overlap is visible against compute.
    timeline_.ActivityStart(e.name,
                            e.name.rfind("fsdp.", 0) == 0 ? "FSDP_AG"
                            : e.name.rfind("sharded.ag.", 0) == 0
                                ? "AG_PARAMS" : "RING_ALLGATHER");
    // Circulate blocks around the flat ring (shm on a whole-world host
    // group, TCP otherwise); after size-1 steps everyone has all.
    RingSpec spec = FlatRingSpec();
    const RingPort& port = spec.ports[ctx.channel];
    std::string err;
    bool failed = false;
    for (int step = 0; step < size_ - 1 && !failed; ++step) {
      int send_block = (rank_ - step + size_) % size_;
      int recv_block = (rank_ - step - 1 + size_) % size_;
      int64_t wns = 0;
      failed = !PortSendRecvChunked(
          port, hs->result.data() + block_off[send_block],
          static_cast<size_t>(block_bytes[send_block]),
          hs->result.data() + block_off[recv_block],
          static_cast<size_t>(block_bytes[recv_block]), /*chunk=*/0, nullptr,
          socket_timeout_sec_ * 1000, &err, &wns);
      wire_ns_.fetch_add(wns);
      if (!failed) {
        CountPortBytes(port, block_bytes[send_block],
                       block_bytes[recv_block]);
      }
    }
    timeline_.ActivityEnd(e.name);
    if (failed) {
      FinishEntry(e, Status::Aborted(TransportError(
          "allgather", e.name, err, (rank_ + 1) % size_,
          (rank_ - 1 + size_) % size_)));
      return;
    }
  }
  timeline_.End(e.name, e.dtype, e.shape.DebugString());
  FinishEntry(e, Status::OK());
}

void Engine::ExecBroadcast(const Response& response,
                           std::vector<TensorTableEntry>& entries,
                           const ExecCtx& ctx) {
  TensorTableEntry& e = entries[0];
  timeline_.Start(e.name);
  if (size_ > 1) {
    timeline_.ActivityStart(e.name, "RING_BROADCAST");
    RingSpec spec = FlatRingSpec();
    const RingPort& port = spec.ports[ctx.channel];
    size_t nbytes = static_cast<size_t>(e.shape.num_elements()) *
                    DataTypeSize(e.dtype);
    int root = response.root_rank;
    bool ok = true;
    std::string detail;
    // Pipeline root → root+1 → ... → root-1 along the ring, STREAMED in
    // chunks: each relay forwards chunk k while chunk k+1 is in flight
    // upstream, so (a) total time ≈ one transfer + hops·chunk_time instead
    // of hops·transfer, and (b) the longest legitimate zero-byte wait is
    // hops·chunk_time, comfortably inside one socket-timeout round even on
    // slow links (RecvAllPatient rides out skew; EOF from a crashed peer
    // still fails immediately).
    uint8_t* p = static_cast<uint8_t*>(e.data);
    bool forward = rank_ != root && (rank_ + 1) % size_ != root;
    int hops = (rank_ - root + size_) % size_;
    for (size_t off = 0; ok && off < nbytes; off += kRelayChunk) {
      size_t n = std::min(kRelayChunk, nbytes - off);
      if (rank_ == root) {
        ok = PortSendAll(port, p + off, n, &detail);
        if (ok) CountPortBytes(port, static_cast<int64_t>(n), 0);
      } else {
        ok = PortRecvAllPatient(port, p + off, n, hops + 2, &detail);
        if (ok) {
          CountPortBytes(port, 0, static_cast<int64_t>(n));
          if (forward) {
            ok = PortSendAll(port, p + off, n, &detail);
            if (ok) CountPortBytes(port, static_cast<int64_t>(n), 0);
          }
        }
      }
    }
    timeline_.ActivityEnd(e.name);
    if (!ok) {
      FinishEntry(e, Status::Aborted(TransportError(
          "broadcast", e.name, detail, (rank_ + 1) % size_,
          (rank_ - 1 + size_) % size_)));
      return;
    }
  }
  timeline_.End(e.name, e.dtype, e.shape.DebugString());
  FinishEntry(e, Status::OK());
}

void Engine::ExecReducescatter(const Response& response,
                               std::vector<TensorTableEntry>& entries,
                               const ExecCtx& ctx) {
  // Never fused; one entry.  First-class half of the allreduce cascade:
  // whenever the COMMITTED shard geometry coincides with the cascade's
  // own segment geometry (always for 1-D tensors — both use the same
  // largest-first split — and for multi-dim tensors with dim0 % size ==
  // 0), the data plane runs exactly the allreduce's reduce-scatter half
  // and stops: flat ring (TCP or shm, streaming multi-channel), star
  // fold + shard scatter under the small-tensor algo, or the two-level
  // hierarchy with a halved cross ring.  The anchor is bit-exactness:
  // reducescatter(x)[rank] == allreduce(x) sliced to the owned shard,
  // per dtype/op/transport — the allgather half only ever moves bytes
  // verbatim, so stopping after the fold cannot change them.  When the
  // geometry does NOT line up (unaligned multi-dim rows, block-
  // quantized int8/fp8 wire, or a hierarchy whose host blocks don't
  // subdivide the cross segments), the exact-parity FALLBACK runs the
  // full allreduce on a scratch buffer and slices the owned shard —
  // same bits by construction, no wire savings (counted in
  // reducescatter_fallback_count).
  // Ghost execution (backup workers): a rank OUTSIDE a partial RS
  // commit's participant set holds no entry but still drives the
  // IDENTICAL full-world cascade over a zeroed buffer (zero = the SUM
  // identity) and discards the shard it nominally owns — the wire
  // pattern never changes shape, exactly the allreduce ghost-ride
  // contract.  Geometry comes from the response alone: partial_dtype/
  // partial_elems + the committed per-rank row split in tensor_sizes.
  const bool ghost = entries.empty();
  TensorTableEntry* ep = ghost ? nullptr : &entries[0];
  const std::string tname = ghost ? response.tensor_names[0] : ep->name;
  if (!ghost) timeline_.Start(tname);
  const DataType in_dtype =
      ghost ? static_cast<DataType>(response.partial_dtype) : ep->dtype;
  const size_t esize = DataTypeSize(in_dtype);
  int64_t row_elems = 1;
  if (ghost) {
    int64_t rows_total = 0;
    for (auto v : response.tensor_sizes) rows_total += v;
    row_elems =
        rows_total > 0 ? response.partial_elems / rows_total : 1;
    if (row_elems <= 0) row_elems = 1;
  } else {
    for (int d = 1; d < ep->shape.ndim(); ++d) {
      row_elems *= ep->shape.dim(d);
    }
  }

  auto hs = ghost ? nullptr : GetHandle(ep->handle);
  if (!ghost && hs == nullptr) return;

  // Committed per-rank shard geometry (absolute element offsets).
  std::vector<int64_t> shard_count(size_), shard_off(size_);
  int64_t off = 0;
  for (int r = 0; r < size_; ++r) {
    shard_count[r] = response.tensor_sizes[r] * row_elems;
    shard_off[r] = off;
    off += shard_count[r];
  }
  const int64_t total = off;
  // Divisor-correct averaging under partial commits: the frontends
  // divide the shard by the COMMITTED participant count.
  const int nparticipants = response.participants.empty()
      ? size_ : static_cast<int>(response.participants.size());

  if (!ghost) {
    const int64_t my_rows = response.tensor_sizes[rank_];
    hs->result_shape.clear();
    hs->result_shape.push_back(my_rows);
    for (int d = 1; d < ep->shape.ndim(); ++d) {
      hs->result_shape.push_back(ep->shape.dim(d));
    }
  }

  std::vector<uint8_t> ghost_zeros;
  const uint8_t* input;
  if (ghost) {
    ghost_zeros.assign(static_cast<size_t>(total) * esize, 0);
    input = ghost_zeros.data();
  } else {
    input = static_cast<const uint8_t*>(ep->data);
  }
  if (size_ == 1 || total == 0) {
    if (!ghost) {
      hs->result.assign(
          input, input + static_cast<size_t>(shard_count[rank_]) * esize);
      timeline_.End(tname, in_dtype, ep->shape.DebugString());
      FinishEntry(*ep, Status::OK(), nparticipants);
    }
    return;
  }

  // Committed wire format (negotiated + validated like the allreduce's;
  // fp32 payloads only).
  const WireDtype wire = in_dtype == DataType::FLOAT32
                             ? response.wire_dtype : WireDtype::FP32;
  const bool quantized = wire == WireDtype::INT8 || wire == WireDtype::FP8;
  const bool half_wire = wire == WireDtype::FP16 || wire == WireDtype::BF16;

  // Alignment: the cascade's EvenSegments vs the committed shards.
  std::vector<int64_t> seg_count, seg_off;
  EvenSegments(total, size_, &seg_count, &seg_off);
  bool aligned = true;
  for (int r = 0; r < size_; ++r) {
    aligned = aligned && seg_count[r] == shard_count[r];
  }

  // Stage the payload: a scratch copy (the caller's input must survive —
  // reducescatter is out-of-place), or for the half wires an RNE-
  // converted half buffer, exactly like ExecAllreduce's staging.
  std::vector<uint8_t> scratch;
  std::vector<uint16_t> halfbuf;
  uint8_t* exec_buf;
  DataType exec_dtype = in_dtype;
  if (half_wire) {
    halfbuf.resize(static_cast<size_t>(total));
    const float* fp = reinterpret_cast<const float*>(input);
    auto q0 = std::chrono::steady_clock::now();
    if (wire == WireDtype::FP16) {
      for (int64_t i = 0; i < total; ++i) halfbuf[i] = FloatToHalf(fp[i]);
    } else {
      for (int64_t i = 0; i < total; ++i) halfbuf[i] = FloatToBF16(fp[i]);
    }
    quantize_ns_.fetch_add(
        std::chrono::duration_cast<std::chrono::nanoseconds>(
            std::chrono::steady_clock::now() - q0)
            .count());
    wire_bytes_saved_.fetch_add(total * 2);
    exec_buf = reinterpret_cast<uint8_t*>(halfbuf.data());
    exec_dtype = wire == WireDtype::FP16 ? DataType::FLOAT16
                                         : DataType::BFLOAT16;
  } else {
    scratch.assign(input, input + static_cast<size_t>(total) * esize);
    exec_buf = scratch.data();
  }
  const size_t exec_esize = DataTypeSize(exec_dtype);
  const int64_t exec_bytes = total * static_cast<int64_t>(exec_esize);
  switch (wire) {
    case WireDtype::FP16: wire_fp16_count_.fetch_add(1); break;
    case WireDtype::BF16: wire_bf16_count_.fetch_add(1); break;
    case WireDtype::INT8: wire_int8_count_.fetch_add(1); break;
    case WireDtype::FP8: wire_fp8_count_.fetch_add(1); break;
    case WireDtype::FP32: break;
  }
  if (wire != WireDtype::FP32) {
    char wm[16];
    std::snprintf(wm, sizeof(wm), "WIRE_%s", WireDtypeName(wire));
    for (char* c = wm; *c; ++c) *c = static_cast<char>(toupper(*c));
    timeline_.Algo(tname, wm);
  }

  // Two-level eligibility: host blocks (node-major contiguous grouping)
  // must equal the cross ring's EvenSegments so the leaders' RS half
  // delivers exactly their members' shards.
  bool two_level_ok = false;
  if (two_level_ && aligned && !quantized) {
    bool contiguous = true;
    for (int r = 1; r < size_; ++r) {
      contiguous = contiguous && rank_host_[r] >= rank_host_[r - 1];
    }
    if (contiguous) {
      std::vector<int64_t> host_block(nnodes_, 0);
      for (int r = 0; r < size_; ++r) {
        host_block[rank_host_[r]] += shard_count[r];
      }
      std::vector<int64_t> cseg_count, cseg_off;
      EvenSegments(total, nnodes_, &cseg_count, &cseg_off);
      two_level_ok = true;
      for (int h = 0; h < nnodes_; ++h) {
        two_level_ok = two_level_ok && host_block[h] == cseg_count[h];
      }
    }
  }
  const bool small =
      !two_level_ && UseSmallAlgo(exec_bytes, ctx) && !quantized;
  const bool half_path =
      (two_level_ ? two_level_ok : (aligned || small)) && !quantized;

  bool ok;
  std::string msg;
  auto t0 = std::chrono::steady_clock::now();
  // FSDP grad reduce-scatters get their own span (like FSDP_AG) so a
  // ZeRO-3 step's backward cascade is attributable in traces.
  timeline_.ActivityStart(tname,
                          tname.rfind("fsdp.", 0) == 0 ? "FSDP_RS" : "RS");
  if (!half_path) {
    // Exact-parity fallback: the full allreduce cascade on the staged
    // buffer — the SAME RunAllreduceCascade selection ExecAllreduce
    // runs, so the bitwise anchor can never drift — then slice the
    // owned shard locally.
    reducescatter_fallback_count_.fetch_add(1);
    timeline_.Algo(tname, "RS_FALLBACK");
    ok = RunAllreduceCascade(exec_buf, total, exec_dtype,
                             response.red_op, wire, quantized, half_wire,
                             UseSmallAlgo(exec_bytes, ctx) && !quantized,
                             "reducescatter", tname, ctx, &msg);
  } else if (two_level_) {
    timeline_.Algo(tname, "RS_TWO_LEVEL");
    ok = TwoLevelReduceScatter(exec_buf, total, exec_dtype,
                               response.red_op, shard_count, shard_off,
                               tname, ctx, half_wire, &msg);
  } else if (small) {
    // Star fold + shard scatter: the leader reproduces the ring's exact
    // fold (bit-equal for ANY shard geometry), members get their slices.
    timeline_.Algo(tname, "RS_STAR");
    ok = StarFoldAllreduce(exec_buf, total, exec_dtype, response.red_op,
                           /*broadcast_result=*/false, &msg);
    if (ok) {
      // Shards by GROUP position (the whole-world host group's order,
      // identity on a single host but mapped for safety).
      std::vector<int64_t> mcount(group_size_), moff(group_size_);
      for (int m = 0; m < group_size_; ++m) {
        const int r = group_members_[m];
        mcount[m] = shard_count[r];
        moff[m] = shard_off[r];
      }
      ok = StarScatterShards(exec_buf, mcount, moff, exec_esize, &msg);
    }
  } else {
    // Flat ring RS half: under the engine-wide vrank convention this
    // rank ends owning segment `rank` — its committed shard, because
    // aligned geometry made the two splits identical — and the fold
    // order per segment is EXACTLY the allreduce's.
    timeline_.Algo(tname, "RS_HALF");
    std::string err;
    RingSpec spec = FlatRingSpec();
    spec.compressed = half_wire;
    ok = ChanneledRingAllreduce(exec_buf, total, exec_dtype,
                                response.red_op, spec, ctx, tname, &err,
                                /*rs_only=*/true);
    if (!ok) {
      msg = TransportError("reducescatter", tname, err,
                           (rank_ + 1) % size_,
                           (rank_ - 1 + size_) % size_);
    }
  }
  timeline_.ActivityEnd(tname);
  reducescatter_ns_.fetch_add(
      std::chrono::duration_cast<std::chrono::nanoseconds>(
          std::chrono::steady_clock::now() - t0)
          .count());
  reducescatter_bytes_.fetch_add(total * static_cast<int64_t>(esize));
  if (!ok) {
    if (!ghost) FinishEntry(*ep, Status::Aborted(msg));
    return;
  }
  if (ghost) return;  // wire driven; the shard is nobody's result

  // Extract the owned shard (converting back from the half staging
  // buffer when the wire was fp16/bf16 — shard only: the rest of the
  // buffer is not this rank's to report).
  hs->result.resize(static_cast<size_t>(shard_count[rank_]) * esize);
  if (half_wire) {
    float* out = reinterpret_cast<float*>(hs->result.data());
    const uint16_t* hb = halfbuf.data() + shard_off[rank_];
    auto q0 = std::chrono::steady_clock::now();
    if (wire == WireDtype::FP16) {
      for (int64_t i = 0; i < shard_count[rank_]; ++i) {
        out[i] = HalfToFloat(hb[i]);
      }
    } else {
      for (int64_t i = 0; i < shard_count[rank_]; ++i) {
        out[i] = BF16ToFloat(hb[i]);
      }
    }
    quantize_ns_.fetch_add(
        std::chrono::duration_cast<std::chrono::nanoseconds>(
            std::chrono::steady_clock::now() - q0)
            .count());
  } else {
    memcpy(hs->result.data(), exec_buf + shard_off[rank_] * esize,
           static_cast<size_t>(shard_count[rank_]) * esize);
  }
  timeline_.End(tname, in_dtype, ep->shape.DebugString());
  FinishEntry(*ep, Status::OK(), nparticipants);
}

void Engine::ExecAlltoall(const Response& response,
                          std::vector<TensorTableEntry>& entries,
                          const ExecCtx& ctx) {
  // Variable-split ring-rotation alltoall: circulate each rank's full
  // (wire-form) input around the ring; at step t a rank holds the input
  // of rank (rank - t - 1) and extracts the block addressed to it.
  // Link traffic is (size-1)·input — fine for the host control/data
  // plane this engine serves (the accelerator alltoall is an XLA
  // collective, ops/collective_ops.py); a pairwise exchange would need
  // all-to-all sockets the ring deliberately avoids.  The committed
  // size×size split matrix rides response.tensor_sizes row-major (row s
  // = rank s's send splits), so every rank derives every peer's buffer
  // geometry — including encoded sizes under a block-quantized wire —
  // without any extra negotiation.  Out-of-place: recv dim0 = Σ over
  // sources of split(src → this rank), which generally differs from the
  // send dim0.
  TensorTableEntry& e = entries[0];
  timeline_.Start(e.name);
  const size_t esize = DataTypeSize(e.dtype);
  int64_t row = 1;  // elements per dim-0 row (dims 1+ match cross-rank)
  for (int d = 1; d < e.shape.ndim(); ++d) row *= e.shape.dim(d);

  // Committed split matrix; synthesized for the legacy equal-split
  // contract if a (defensively handled) matrix-less response shows up.
  std::vector<int64_t> matrix = response.tensor_sizes;
  if (matrix.size() != static_cast<size_t>(size_) * size_) {
    matrix.assign(static_cast<size_t>(size_) * size_,
                  e.shape.ndim() > 0 ? e.shape.dim(0) / size_ : 0);
  }
  auto split = [&](int s, int d) -> int64_t {
    return matrix[static_cast<size_t>(s) * size_ + d];
  };

  // Geometry: per-source send dim0 and this rank's recv layout.
  std::vector<int64_t> src_rows(size_, 0);
  int64_t recv_rows = 0;
  for (int s = 0; s < size_; ++s) {
    for (int d = 0; d < size_; ++d) src_rows[s] += split(s, d);
    recv_rows += split(s, rank_);
  }
  // Output offsets (bytes): source blocks land in source-rank order.
  std::vector<int64_t> out_off(size_, 0);
  for (int s = 1; s < size_; ++s) {
    out_off[s] = out_off[s - 1] +
                 split(s - 1, rank_) * row * static_cast<int64_t>(esize);
  }

  auto hs = GetHandle(e.handle);
  if (hs == nullptr) return;
  hs->result.resize(static_cast<size_t>(recv_rows * row) * esize);
  hs->result_shape.clear();
  hs->result_shape.push_back(recv_rows);
  for (int d = 1; d < e.shape.ndim(); ++d) {
    hs->result_shape.push_back(e.shape.dim(d));
  }

  const uint8_t* input = static_cast<const uint8_t*>(e.data);
  const int64_t my_bytes = src_rows[rank_] * row *
                           static_cast<int64_t>(esize);
  alltoall_bytes_.fetch_add(my_bytes);
  auto t0 = std::chrono::steady_clock::now();

  if (size_ == 1) {
    // World of one: identity (the MoE plane's single-rank bit-exact
    // reference path — no wire, no codec).
    memcpy(hs->result.data(), input, static_cast<size_t>(my_bytes));
    alltoall_ns_.fetch_add(
        std::chrono::duration_cast<std::chrono::nanoseconds>(
            std::chrono::steady_clock::now() - t0)
            .count());
    timeline_.End(e.name, e.dtype, e.shape.DebugString());
    FinishEntry(e, Status::OK());
    return;
  }

  // Committed wire format (fp32 payloads only, like the reductions).
  const WireDtype wire = e.dtype == DataType::FLOAT32
                             ? response.wire_dtype : WireDtype::FP32;
  const bool quantized = wire == WireDtype::INT8 || wire == WireDtype::FP8;
  const bool half_wire = wire == WireDtype::FP16 || wire == WireDtype::BF16;
  switch (wire) {
    case WireDtype::FP16: wire_fp16_count_.fetch_add(1); break;
    case WireDtype::BF16: wire_bf16_count_.fetch_add(1); break;
    case WireDtype::INT8: wire_int8_count_.fetch_add(1); break;
    case WireDtype::FP8: wire_fp8_count_.fetch_add(1); break;
    case WireDtype::FP32: break;
  }
  if (wire != WireDtype::FP32) {
    char wm[16];
    std::snprintf(wm, sizeof(wm), "WIRE_%s", WireDtypeName(wire));
    for (char* c = wm; *c; ++c) *c = static_cast<char>(toupper(*c));
    timeline_.Algo(e.name, wm);
  }

  // Per-source WIRE buffer geometry, identical on every rank.  Blocks
  // are encoded per DESTINATION so a receiver decodes exactly its own
  // block; under int8/fp8 each block is an independent run of
  // fixed-size scaled sub-blocks (deterministic encoded length from the
  // committed matrix + the committed chunk knob).
  const size_t wire_esize = half_wire ? 2 : esize;
  const int64_t qblock_elems =
      std::max<int64_t>(64, chunk_bytes_.load() / 4);
  const size_t qblock_bytes = 4 + static_cast<size_t>(qblock_elems);
  auto enc_bytes = [&](int64_t nelems) -> int64_t {
    if (!quantized) return nelems * static_cast<int64_t>(wire_esize);
    if (nelems == 0) return 0;
    return (nelems + qblock_elems - 1) / qblock_elems *
           static_cast<int64_t>(qblock_bytes);
  };
  std::vector<int64_t> buf_bytes(size_, 0);
  // blk_off[s*size_+d]: byte offset of block (s → d) in source s's wire
  // buffer.
  std::vector<int64_t> blk_off(static_cast<size_t>(size_) * size_, 0);
  int64_t max_buf = 0;
  for (int s = 0; s < size_; ++s) {
    int64_t off = 0;
    for (int d = 0; d < size_; ++d) {
      blk_off[static_cast<size_t>(s) * size_ + d] = off;
      off += enc_bytes(split(s, d) * row);
    }
    buf_bytes[s] = off;
    max_buf = std::max(max_buf, off);
  }

  // Stage this rank's input into wire form.  The codec round-trips the
  // OWN block too, so a block's bytes never depend on which rank it
  // stayed on — fp32 wire stays bitwise-verbatim, lossy wires are
  // uniformly lossy.
  std::vector<uint8_t> cur(static_cast<size_t>(max_buf));
  std::vector<uint8_t> nxt(static_cast<size_t>(max_buf));
  if (wire == WireDtype::FP32) {
    memcpy(cur.data(), input, static_cast<size_t>(my_bytes));
  } else {
    const float* fp = reinterpret_cast<const float*>(input);
    auto q0 = std::chrono::steady_clock::now();
    if (half_wire) {
      uint16_t* hb = reinterpret_cast<uint16_t*>(cur.data());
      const int64_t n = src_rows[rank_] * row;
      if (wire == WireDtype::FP16) {
        for (int64_t i = 0; i < n; ++i) hb[i] = FloatToHalf(fp[i]);
      } else {
        for (int64_t i = 0; i < n; ++i) hb[i] = FloatToBF16(fp[i]);
      }
    } else {
      int64_t elem_off = 0;
      for (int d = 0; d < size_; ++d) {
        const int64_t n = split(rank_, d) * row;
        uint8_t* dst =
            cur.data() + blk_off[static_cast<size_t>(rank_) * size_ + d];
        for (int64_t o = 0; o < n; o += qblock_elems) {
          QuantizeBlock(fp + elem_off + o, std::min(qblock_elems, n - o),
                        wire, dst + o / qblock_elems * qblock_bytes,
                        qblock_elems);
        }
        elem_off += n;
      }
    }
    quantize_ns_.fetch_add(
        std::chrono::duration_cast<std::chrono::nanoseconds>(
            std::chrono::steady_clock::now() - q0)
            .count());
    wire_bytes_saved_.fetch_add(
        std::max<int64_t>(0, my_bytes - buf_bytes[rank_]));
  }

  // Decode block (src → this rank) out of src's wire buffer into the
  // output slot.
  auto extract = [&](int src, const uint8_t* buf) {
    const int64_t n = split(src, rank_) * row;
    if (n == 0) return;
    const uint8_t* blk =
        buf + blk_off[static_cast<size_t>(src) * size_ + rank_];
    uint8_t* out = hs->result.data() + out_off[src];
    if (wire == WireDtype::FP32) {
      memcpy(out, blk, static_cast<size_t>(n) * esize);
      return;
    }
    float* fout = reinterpret_cast<float*>(out);
    auto q0 = std::chrono::steady_clock::now();
    if (half_wire) {
      const uint16_t* hb = reinterpret_cast<const uint16_t*>(blk);
      if (wire == WireDtype::FP16) {
        for (int64_t i = 0; i < n; ++i) fout[i] = HalfToFloat(hb[i]);
      } else {
        for (int64_t i = 0; i < n; ++i) fout[i] = BF16ToFloat(hb[i]);
      }
    } else {
      for (int64_t o = 0; o < n; o += qblock_elems) {
        DequantizeBlock(blk + o / qblock_elems * qblock_bytes,
                        std::min(qblock_elems, n - o), wire, fout + o);
      }
    }
    quantize_ns_.fetch_add(
        std::chrono::duration_cast<std::chrono::nanoseconds>(
            std::chrono::steady_clock::now() - q0)
            .count());
  };
  extract(rank_, cur.data());

  // MoE token routing gets its own span (like FSDP_AG) so expert
  // dispatch/combine traffic is attributable against compute in traces.
  timeline_.ActivityStart(e.name, e.name.rfind("moe.", 0) == 0
                                      ? "MOE_DISPATCH" : "ALLTOALL");
  RingSpec spec = FlatRingSpec();
  const RingPort& port = spec.ports[ctx.channel];
  bool failed = false;
  std::string err;
  for (int step = 0; step < size_ - 1 && !failed; ++step) {
    const int send_src = (rank_ - step + size_) % size_;
    const int recv_src = (rank_ - step - 1 + size_) % size_;
    int64_t wns = 0;
    failed = !PortSendRecvChunked(
        port, cur.data(), static_cast<size_t>(buf_bytes[send_src]),
        nxt.data(), static_cast<size_t>(buf_bytes[recv_src]),
        /*chunk=*/0, nullptr, socket_timeout_sec_ * 1000, &err, &wns);
    wire_ns_.fetch_add(wns);
    if (!failed) {
      CountPortBytes(port, buf_bytes[send_src], buf_bytes[recv_src]);
      if (wire != WireDtype::FP32) {
        compressed_bytes_tx_.fetch_add(buf_bytes[send_src]);
      }
      extract(recv_src, nxt.data());
      cur.swap(nxt);
    }
  }
  timeline_.ActivityEnd(e.name);
  alltoall_ns_.fetch_add(
      std::chrono::duration_cast<std::chrono::nanoseconds>(
          std::chrono::steady_clock::now() - t0)
          .count());
  if (failed) {
    FinishEntry(e, Status::Aborted(TransportError(
        "alltoall", e.name, err, (rank_ + 1) % size_,
        (rank_ - 1 + size_) % size_)));
    return;
  }
  timeline_.End(e.name, e.dtype, e.shape.DebugString());
  FinishEntry(e, Status::OK());
}

void Engine::FinishEntry(TensorTableEntry& e, const Status& s,
                         int participants) {
  // Step-time sample: allreduce completion latency (enqueue → finish),
  // successful entries only — skipped/errored entries would poison the
  // percentiles the straggler gate compares.
  if (s.ok() && e.type == RequestType::ALLREDUCE) {
    RecordStepTimeNs(std::chrono::duration_cast<std::chrono::nanoseconds>(
                         std::chrono::steady_clock::now() - e.enqueue_time)
                         .count());
  }
  auto hs = GetHandle(e.handle);
  if (hs == nullptr) return;
  {
    std::lock_guard<std::mutex> lk(handle_mu_);
    hs->error = s.reason();
    hs->participants = participants >= 0 ? participants : size_;
    hs->done.store(s.ok() ? 1 : -1);
  }
  handle_cv_.notify_all();
}

void Engine::RecordStepTimeNs(int64_t ns) {
  std::lock_guard<std::mutex> lk(step_ns_mu_);
  constexpr size_t kCap = 4096;
  if (step_ns_samples_.size() < kCap) {
    step_ns_samples_.push_back(ns);
  } else {
    step_ns_samples_[step_ns_next_ % kCap] = ns;
  }
  ++step_ns_next_;
}

int64_t Engine::StepTimeNsPercentile(double p) const {
  std::vector<int64_t> snap;
  {
    std::lock_guard<std::mutex> lk(step_ns_mu_);
    snap = step_ns_samples_;
  }
  if (snap.empty()) return 0;
  size_t idx = static_cast<size_t>(p * (snap.size() - 1) + 0.5);
  if (idx >= snap.size()) idx = snap.size() - 1;
  std::nth_element(snap.begin(), snap.begin() + idx, snap.end());
  return snap[idx];
}

int Engine::ResultParticipants(int64_t handle) {
  auto hs = GetHandle(handle);
  if (hs == nullptr) return 0;
  std::lock_guard<std::mutex> lk(handle_mu_);
  return hs->participants;
}

// Rank-0-only stall warnings naming the missing ranks (reference
// CheckForStalledTensors, operations.cc:1366-1412).
void Engine::CheckForStalledTensors() {
  auto now = std::chrono::steady_clock::now();
  if (now - last_stall_check_ < std::chrono::seconds(stall_warning_sec_)) {
    return;
  }
  last_stall_check_ = now;
  // message_table_ is background-thread-only (see engine.h); no lock.
  AssertBackgroundThread();
  bool preamble = false;
  auto warn_preamble = [&] {
    if (preamble) return;
    std::fprintf(
        stderr,
        "One or more tensors were submitted to be reduced, gathered or "
        "broadcasted by subset of ranks and are waiting for remainder of "
        "ranks for more than %d seconds. This may indicate that different "
        "ranks are trying to submit different tensors or that only subset "
        "of ranks is submitting tensors, which will cause deadlock.\n",
        stall_warning_sec_);
    std::fprintf(stderr, "Stalled ops:\n");
    preamble = true;
  };
  // Once host grouping is active, a stalled negotiation names the slow
  // HOST alongside each rank — at fleet scale "rank 37" sends the
  // operator grepping rendezvous logs, "host 4" names the machine.
  auto missing_ranks = [&](const std::vector<bool>& seen) {
    std::string missing;
    for (int r = 0; r < size_; ++r) {
      if (!seen[r]) {
        if (!missing.empty()) missing += ", ";
        missing += std::to_string(r);
        if (nnodes_ > 1 && r < static_cast<int>(rank_host_.size())) {
          missing += " (host " + std::to_string(rank_host_[r]) + ")";
        }
      }
    }
    return missing;
  };
  // Under hierarchical coordination slot-readiness bits are GROUP
  // granular: name the silent hosts (and their leader ranks) directly.
  auto missing_voters = [&](const std::vector<bool>& seen) {
    if (!HierActive()) return missing_ranks(seen);
    std::string missing;
    for (int g = 0; g < nnodes_ && g < static_cast<int>(seen.size()); ++g) {
      if (!seen[g]) {
        if (!missing.empty()) missing += ", ";
        missing += "host " + std::to_string(g) + " (leader rank " +
                   std::to_string(group_leaders_[g]) + ")";
      }
    }
    return missing;
  };
  // Per-tensor rate limit (at most one warning per HOROVOD_STALL_WARNING
  // _SEC per tensor, independent of the scan cadence), with every emitted
  // warning counted (horovod_stall_warnings_total) and mirrored into the
  // flight recorder.  A tensor stalled past TWICE the warning interval
  // escalates: one flight-recorder dump per process, so the operator gets
  // the control-plane history even when the job later limps on.
  auto rate_limited = [&](const std::string& name) {
    auto it = stall_last_warned_.find(name);
    if (it != stall_last_warned_.end() &&
        now - it->second < std::chrono::seconds(stall_warning_sec_)) {
      return true;
    }
    stall_last_warned_[name] = now;
    return false;
  };
  auto escalate = [&](const std::string& name, long long age) {
    if (flight_escalated_ || age < 2ll * stall_warning_sec_) return;
    flight_escalated_ = true;
    GlobalFlightRecorder().Dump(
        ("stall-warning escalation: '" + name + "' stalled " +
         std::to_string(age) + "s")
            .c_str());
  };
  for (auto& kv : message_table_) {
    auto age = std::chrono::duration_cast<std::chrono::seconds>(
                   now - kv.second.first_seen)
                   .count();
    if (age < stall_warning_sec_ || rate_limited(kv.first)) continue;
    warn_preamble();
    const std::string missing = missing_ranks(kv.second.seen);
    std::fprintf(stderr, "%s [missing ranks: %s]\n", kv.first.c_str(),
                 missing.c_str());
    stall_warnings_.fetch_add(1);
    GlobalFlightRecorder().Record("stall", control_cycle_seq_,
                                  "%s age=%llds missing=%s",
                                  kv.first.c_str(),
                                  static_cast<long long>(age),
                                  missing.c_str());
    escalate(kv.first, age);
  }
  // Cache-hit readiness bits stall the same way full requests do (a
  // subset of ranks re-enqueued a cached tensor, the rest never did).
  const int nvoters = HierActive() ? nnodes_ : size_;
  for (auto& kv : coord_slot_bits_) {
    if (kv.second.count == 0 || kv.second.count == nvoters) continue;
    auto age = std::chrono::duration_cast<std::chrono::seconds>(
                   now - kv.second.first_seen)
                   .count();
    if (age < stall_warning_sec_) continue;
    auto nit = coord_slot_names_.find(kv.first);
    const std::string name =
        nit == coord_slot_names_.end() ? "?" : nit->second;
    if (rate_limited(name)) continue;
    warn_preamble();
    const std::string missing = missing_voters(kv.second.seen);
    std::fprintf(stderr, "%s [cached slot %u; missing: %s]\n", name.c_str(),
                 kv.first, missing.c_str());
    stall_warnings_.fetch_add(1);
    GlobalFlightRecorder().Record("stall", control_cycle_seq_,
                                  "%s slot=%u age=%llds missing=%s",
                                  name.c_str(), kv.first,
                                  static_cast<long long>(age),
                                  missing.c_str());
    escalate(name, age);
  }
  // Entries that resolved (or died with the world) drop out of the
  // rate-limit map so it cannot grow without bound across a long job.
  for (auto it = stall_last_warned_.begin();
       it != stall_last_warned_.end();) {
    if (now - it->second > std::chrono::seconds(4 * stall_warning_sec_)) {
      it = stall_last_warned_.erase(it);
    } else {
      ++it;
    }
  }
}

// ---------------------------------------------------------------------------
// Public enqueue / handle API
// ---------------------------------------------------------------------------

// Fires the armed HOROVOD_FAULT_INJECT action when this rank's enqueue
// counter reaches the configured step.  Runs in the enqueueing (API)
// thread; HANG/DROP_CONN only set flags the background loop acts on, so
// every effect lands at a deterministic point regardless of cycle timing.
void Engine::MaybeInjectFault() {
  if (fault_kind_ == FaultKind::NONE) return;
  int64_t idx = enqueue_count_.fetch_add(1);
  if (fault_kind_ == FaultKind::CONN_RESET && fault_step_ == -2) {
    // Flap schedule (step '*'): arm a reset every K-th enqueue, skipping
    // enqueue 0 so wiring warms up.  Recurring by design — never sets
    // fault_fired_, so a flap soak keeps flapping across the whole run.
    if (idx > 0 && idx % fault_reset_period_ == 0) {
      fault_conn_reset_.store(true);
    }
    return;
  }
  if (fault_step_ != -2 && idx != fault_step_) return;  // -2: every step
  if (fault_kind_ == FaultKind::SLOW) {
    // Straggler injection: delay THIS enqueue in the API thread (the
    // background loop keeps cycling, so control frames keep flowing and
    // peers see a slow rank, not a dead one).  '*' schedules recur —
    // they never set fault_fired_, so an elastic re-Init keeps the rank
    // slow, which is what a chaos soak wants.
    if (fault_step_ != -2) fault_fired_ = true;
    std::fprintf(stderr,
                 "horovod_tpu rank %d: fault injection: delaying enqueue "
                 "%lld by %lldms\n",
                 rank_, static_cast<long long>(idx),
                 static_cast<long long>(fault_slow_ms_));
    std::this_thread::sleep_for(std::chrono::milliseconds(fault_slow_ms_));
    return;
  }
  fault_fired_ = true;  // once per process, not per engine incarnation
  switch (fault_kind_) {
    case FaultKind::EXIT:
      std::fprintf(stderr,
                   "horovod_tpu rank %d: fault injection: exiting at "
                   "enqueue %lld\n",
                   rank_, static_cast<long long>(idx));
      _exit(41);
    case FaultKind::HANG:
      std::fprintf(stderr,
                   "horovod_tpu rank %d: fault injection: freezing the "
                   "background loop at enqueue %lld\n",
                   rank_, static_cast<long long>(idx));
      fault_hang_.store(true);
      break;
    case FaultKind::DROP_CONN:
      std::fprintf(stderr,
                   "horovod_tpu rank %d: fault injection: dropping all "
                   "connections at enqueue %lld\n",
                   rank_, static_cast<long long>(idx));
      fault_drop_.store(true);
      break;
    case FaultKind::SLOW:
      break;  // handled above
    case FaultKind::CONN_RESET:
      std::fprintf(stderr,
                   "horovod_tpu rank %d: fault injection: arming a data-"
                   "channel %s-socket reset at enqueue %lld\n",
                   rank_, fault_reset_prev_ ? "recv" : "send",
                   static_cast<long long>(idx));
      fault_conn_reset_.store(true);
      break;
    case FaultKind::RECV_STALL:
      std::fprintf(stderr,
                   "horovod_tpu rank %d: fault injection: arming a %lldms "
                   "recv stall at enqueue %lld\n",
                   rank_, static_cast<long long>(fault_stall_len_ms_),
                   static_cast<long long>(idx));
      fault_stall_ms_.store(fault_stall_len_ms_);
      break;
    case FaultKind::STALE_EPOCH:
      // Worker-only (the coordinator sends no RequestList frames): the
      // next control frame is preceded by a duplicate stamped epoch-1,
      // exercising the receiver's structural stale-epoch rejection.
      std::fprintf(stderr,
                   "horovod_tpu rank %d: fault injection: sending a "
                   "stale-epoch control frame at enqueue %lld\n",
                   rank_, static_cast<long long>(idx));
      fault_stale_epoch_.store(true);
      break;
    case FaultKind::NONE:
      break;
  }
}

int64_t Engine::Enqueue(RequestType type, const std::string& name,
                        DataType dtype, const std::vector<int64_t>& shape,
                        void* data, int root_rank, ReduceOp red_op,
                        bool probe, int wire_dtype, int priority,
                        bool wire_advisory,
                        const std::vector<int64_t>& splits) {
  MaybeInjectFault();
  if (!initialized_.load() || shutdown_requested_.load() ||
      shut_down_.load()) {
    return -2;
  }
  // Resolve the wire format at enqueue time: per-tensor override wins,
  // else the live global knob; compression only ever applies to FLOAT32
  // allreduce/reducescatter payloads (probes included — they are dense
  // allreduces).  Reducescatter rides the same codec seam: fp16/bf16
  // run the half-staged RS half, int8/fp8 take the exact-parity
  // fallback (full quantized ring + local slice).
  WireDtype wire = WireDtype::FP32;
  if ((type == RequestType::ALLREDUCE ||
       type == RequestType::REDUCESCATTER ||
       type == RequestType::ALLTOALL) &&
      dtype == DataType::FLOAT32) {
    int wv = wire_dtype >= 0 ? wire_dtype : wire_dtype_.load();
    if (wv >= 1 && wv <= 4) wire = static_cast<WireDtype>(wv);
  }
  // Knob-derived resolutions are advisory (the coordinator commits one
  // format at negotiation): sampling the live knob here inherently
  // races a TUNE landing on peers — see Request::wire_default.  An
  // explicit override may OPT INTO the advisory semantics too
  // (wire_advisory): the statistics-driven wire policy stamps formats
  // from per-rank gradient stats, which may legitimately disagree for a
  // step — the coordinator commits the first value instead of erroring.
  const bool wire_default = wire_dtype < 0 || wire_advisory;
  if (priority < 0) priority = 0;
  if (priority > (1 << 30)) priority = 1 << 30;
  int64_t handle = next_handle_.fetch_add(1);
  auto hs = std::make_shared<HandleState>();
  {
    std::lock_guard<std::mutex> lk(handle_mu_);
    handles_[handle] = hs;
  }
  TensorTableEntry e;
  e.name = name;
  e.type = type;
  e.dtype = dtype;
  for (auto d : shape) e.shape.AddDim(d);
  e.data = data;
  e.root_rank = root_rank;
  e.red_op = red_op;
  e.wire_dtype = wire;
  e.wire_default = wire_default;
  e.priority = static_cast<int32_t>(priority);
  if (type == RequestType::ALLTOALL) e.splits = splits;
  e.handle = handle;
  e.enqueue_time = std::chrono::steady_clock::now();

  Request q;
  q.request_rank = rank_;
  q.type = type;
  q.dtype = dtype;
  q.tensor_name = name;
  q.root_rank = root_rank;
  q.red_op = red_op;
  q.probe = probe;
  q.wire_dtype = wire;
  q.wire_default = wire_default;
  q.priority = static_cast<int32_t>(priority);
  q.shape = shape;
  if (type == RequestType::ALLTOALL) q.splits = splits;

  {
    std::lock_guard<std::mutex> lk(mu_);
    // Re-check liveness under mu_: the background loop's teardown drains
    // the table, stores shut_down_, then drains again — so an insert that
    // slipped past the entry check either lands before the second drain
    // (and is failed by it) or observes shut_down_ here and is rejected.
    if (shut_down_.load()) {
      std::lock_guard<std::mutex> hlk(handle_mu_);
      handles_.erase(handle);
      return -2;
    }
    if (tensor_table_.count(name) != 0) {
      std::lock_guard<std::mutex> hlk(handle_mu_);
      handles_.erase(handle);
      return -1;  // duplicate name in flight
    }
    tensor_table_.emplace(name, std::move(e));
    message_queue_.push_back(std::move(q));
  }
  // Wake the background loop immediately (event-driven cycle): the tensor
  // negotiates on the next control round trip instead of waiting out the
  // remainder of HOROVOD_CYCLE_TIME.
  cycle_cv_.notify_one();
  return handle;
}

std::shared_ptr<HandleState> Engine::GetHandle(int64_t handle) {
  std::lock_guard<std::mutex> lk(handle_mu_);
  auto it = handles_.find(handle);
  return it == handles_.end() ? nullptr : it->second;
}

int Engine::Poll(int64_t handle) {
  auto hs = GetHandle(handle);
  if (hs == nullptr) return -1;
  return hs->done.load();
}

int Engine::Wait(int64_t handle) {
  auto hs = GetHandle(handle);
  if (hs == nullptr) return -1;
  std::unique_lock<std::mutex> lk(handle_mu_);
  handle_cv_.wait(lk, [&] { return hs->done.load() != 0; });
  return hs->done.load();
}

std::string Engine::ErrorMessage(int64_t handle) {
  auto hs = GetHandle(handle);
  if (hs == nullptr) return "unknown handle";
  std::lock_guard<std::mutex> lk(handle_mu_);
  return hs->error;
}

int64_t Engine::ResultNumDims(int64_t handle) {
  auto hs = GetHandle(handle);
  if (hs == nullptr) return -1;
  return static_cast<int64_t>(hs->result_shape.size());
}

int64_t Engine::ResultDim(int64_t handle, int i) {
  auto hs = GetHandle(handle);
  if (hs == nullptr || i < 0 ||
      i >= static_cast<int>(hs->result_shape.size())) {
    return -1;
  }
  return hs->result_shape[i];
}

int64_t Engine::ResultByteSize(int64_t handle) {
  auto hs = GetHandle(handle);
  if (hs == nullptr) return -1;
  return static_cast<int64_t>(hs->result.size());
}

int Engine::CopyResult(int64_t handle, void* dst, int64_t nbytes) {
  auto hs = GetHandle(handle);
  if (hs == nullptr || nbytes < static_cast<int64_t>(hs->result.size())) {
    return -1;
  }
  memcpy(dst, hs->result.data(), hs->result.size());
  return 0;
}

void Engine::ReleaseHandle(int64_t handle) {
  std::lock_guard<std::mutex> lk(handle_mu_);
  handles_.erase(handle);
}

}  // namespace hvd
