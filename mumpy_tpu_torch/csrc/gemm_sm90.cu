// bf16 GEMM for Hopper (sm_90a): wgmma.mma_async on operand tiles in shared
// memory, fed by a ring of cp.async stages.  The products of the training
// kernels' bf16 path (swin_block_train, and the backward halves it shares
// with attn_ln_train and ln_mlp_train):
//
//   mumpy_gemm_sm90, A (M, K) row-major, B (K, N) row-major or, with b_kmajor,
//   B^T (N, K) row-major (a torch Linear weight as stored):
//     v = A B + bias
//     v = gelu_erf(v)                           (act 1)
//       = v * gelu_erf'(aux[m, n])              (act 2: the GELU backward; with
//         aux_out, also aux_out[m, n] = T(gelu_erf(aux)), the activation the
//         fc2 weight gradient reads)
//     y[m, n]   = T(v)                          (y != null)
//     out[m, n] = T(res[m, n] + T(v))           (out != null; res required)
//               = T(res[m, n] + s[m / d] * v)   (with a row scale s, f32, divisor
//                 d: the stochastic-depth keep; row_scale_on = 0 ignores s, the
//                 planted fault of the checks)
//   mumpy_gemm_sm90_tn, A (K, M) and B (K, N) row-major, the sum over the K rows:
//     dW[m, n] = sum_k A[k, m] B[k, n],  db[m] = sum_k A[k, m]
//     (A a layer's output gradient, B its input: dW in torch Linear's (out,
//     in) layout, db the bias gradient.)  The rows are split over grid.z; every
//     split writes f32 partials to its slice of ws, [dW | db], which
//     wgrad.cu's reduce_splits adds in split order, so the result does not
//     depend on the schedule; with one split the kernel writes T directly.
//
// Replaces the matrix products inside mumpy_tpu/ops/pallas/swin_block_vjp.py
// (_train_fwd_kernel, _train_bwd_kernel, _train_bwd_dw_kernel), which keep
// whole weight sets in VMEM, and the weight-gradient sums of
// attn_ln_vjp.py / ln_mlp_vjp.py that the JAX package leaves to XLA.  At the
// flagship's widths (C 96-1024, hidden 4C) and rows (588 to 112,896 per
// call) the products with K = C are bound by bytes at the large row counts
// and the others by the tensor cores' rate.  A block owns a 64 x 128 (one
// consumer warpgroup) or 128 x 128 (two) output tile: wgmma m64n128k16 with
// f32 accumulators in registers, K in steps of 64 through a ring of
// shared-memory stages that every thread fills with 16-byte cp.async copies
// one or two steps ahead of the products, each stage laid out in the 128-byte
// swizzle wgmma reads: A K-major (the normal form) or M-major (the TN form),
// B N-major or K-major (b_kmajor), so neither a weight nor an activation is
// ever transposed in memory.  The epilogue stages the accumulators through
// shared memory and applies bias, activation and residual on rows of 8
// columns with 16-byte loads and stores, as gemm.cu's tensor-core loop does.
// Edges (M, N, K and the split's rows) are zero-filled by the copies and
// masked in the epilogue.  It takes bf16 with N, K (normal form) or M, N (TN
// form) multiples of 8 and 16-byte aligned operands, and refuses others.
#include "common.cuh"

namespace mumpy {

constexpr int kBN = 128, kBK = 64;

// Stages of the ring: three for 128-row tiles, so that two blocks (96 KB of
// ring each, at most 128 registers a thread) share an SM and one's prologue
// and epilogue overlap the other's products; four for 64-row tiles, which
// fit two to an SM with four.
template <int kWg> __host__ __device__ constexpr int stages() { return kWg == 2 ? 3 : 4; }
constexpr int kPanel = 64 * 128;  // one 64-row x 128-byte swizzle panel, bytes
constexpr int kStageB = kBK * kBN * 2;
constexpr int kStgPitch = kBN + 4;  // f32 epilogue staging pitch

struct Sm90Args {
  const __nv_bfloat16* a; const __nv_bfloat16* b; const __nv_bfloat16* bias;
  const __nv_bfloat16* res; const float* row_scale; const __nv_bfloat16* aux;
  __nv_bfloat16* y; __nv_bfloat16* out; __nv_bfloat16* aux_out;
  float* ws; __nv_bfloat16* dw; __nv_bfloat16* db;
  int M, N, K, act, scale_div, row_scale_on, rows_per_split;
};

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accumulator reads or writes across the
// asynchronous products
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets, each in 16-byte units.  K-major: rows of
// 128 bytes (64 K values), 8-row groups 1024 bytes apart (stride), the
// leading offset unused.  M/N-major: rows of 128 bytes (64 M or N values) per
// K index, 8-K groups 1024 bytes apart (stride), 64-wide panels `lead` bytes
// apart.
__device__ __forceinline__ uint64_t smem_desc(unsigned addr, unsigned lead, unsigned stride) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lead & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((stride & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// d (64 x 128, f32) += A (64 x 16) B (16 x 128); A K-major (kTransA = 0) or
// M-major (1), B K-major (kTransB = 0) or N-major (1).  Lane l of warp w
// holds rows 16w + l/4 and 16w + l/4 + 8, columns 8j + 2(l%4) and the next,
// in d[4j..4j+3].
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %67, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %66, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "n"(kTransA), "r"(1), "n"(kTransB));
}

// One k-step of 64 into stage memory sa (A) / sb (B), 16-byte chunk c of
// row r of a panel at r * 128 + ((c ^ (r % 8)) * 16): the 128-byte swizzle.
template <bool kTn, int kWg, bool kKB>
__device__ __forceinline__ void load_stage(const Sm90Args& p, unsigned char* sa,
                                           unsigned char* sb, int m0, int n0, int k0,
                                           int k_end) {
  constexpr int kBM = 64 * kWg, kThreads = 128 * kWg;
  const int tid = threadIdx.x;
  if (!kTn) {  // A (M, K): kBM rows of 8 chunks, K-major
    for (int e = tid; e < kBM * 8; e += kThreads) {
      const int r = e >> 3, c = e & 7, m = m0 + r, k = k0 + c * 8;
      const bool ok = m < p.M && k < k_end;
      cp_async16(sa + r * 128 + ((c ^ (r & 7)) << 4), p.a + (ok ? (size_t)m * p.K + k : 0), ok);
    }
  } else {  // A (K, M): 64 rows of kBM / 8 chunks, M-major, panels of 64 columns
    for (int e = tid; e < 64 * (kBM / 8); e += kThreads) {
      const int r = e / (kBM / 8), cc = e % (kBM / 8), c = cc & 7;
      const int k = k0 + r, m = m0 + cc * 8;
      const bool ok = k < k_end && m < p.M;
      cp_async16(sa + (cc >> 3) * kPanel + r * 128 + ((c ^ (r & 7)) << 4),
                 p.a + (ok ? (size_t)k * p.M + m : 0), ok);
    }
  }
  if (kKB) {  // B^T (N, K): kBN rows of 8 chunks, K-major
    for (int e = tid; e < kBN * 8; e += kThreads) {
      const int r = e >> 3, c = e & 7, n = n0 + r, k = k0 + c * 8;
      const bool ok = n < p.N && k < k_end;
      cp_async16(sb + r * 128 + ((c ^ (r & 7)) << 4), p.b + (ok ? (size_t)n * p.K + k : 0), ok);
    }
  } else {  // B (K, N): 64 rows of 16 chunks, N-major, panels of 64 columns
    for (int e = tid; e < kBK * (kBN / 8); e += kThreads) {
      const int r = e >> 4, cc = e & 15, c = cc & 7;
      const int k = k0 + r, n = n0 + cc * 8;
      const bool ok = k < k_end && n < p.N;
      cp_async16(sb + (cc >> 3) * kPanel + r * 128 + ((c ^ (r & 7)) << 4),
                 p.b + (ok ? (size_t)k * p.N + n : 0), ok);
    }
  }
}

template <bool kTn, int kWg, bool kKB>
__global__ void __launch_bounds__(128 * kWg, kWg == 2 ? 2 : 1)
    gemm_sm90_kernel(Sm90Args p) {
  constexpr int kBM = 64 * kWg, kThreads = 128 * kWg, kStages = stages<kWg>();
  constexpr int kStageA = kBM * 128, kStage = kStageA + kStageB;
  extern __shared__ unsigned char smem_raw[];
  // the swizzle repeats every 1024 bytes: stages start on such a boundary
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

  const int tid = threadIdx.x, wg = tid >> 7;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  int k_begin = 0, k_end = p.K;
  if (kTn) {
    k_begin = blockIdx.z * p.rows_per_split;
    k_end = min(p.K, k_begin + p.rows_per_split);
  }
  const int steps = (k_end - k_begin + kBK - 1) / kBK;
  const bool sums = kTn && blockIdx.x == 0 && tid < kBM;  // db: the first column of tiles
  float csum = 0.f;

  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  fence_acc(d);

  for (int s = 0; s < kStages - 2; ++s) {
    if (s < steps)
      load_stage<kTn, kWg, kKB>(p, smem + s * kStage, smem + s * kStage + kStageA, m0, n0,
                                k_begin + s * kBK, k_end);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 3>();  // this thread's copies of this step have landed
    fence_proxy_async();           // ... and are visible to the tensor cores
    __syncthreads();  // everyone's have; every warpgroup is done with step - 2's stage
    const int next = step + kStages - 2;
    if (next < steps)
      load_stage<kTn, kWg, kKB>(p, smem + (next % kStages) * kStage,
                                smem + (next % kStages) * kStage + kStageA, m0, n0,
                                k_begin + next * kBK, k_end);
    cp_async_commit();
    unsigned char* sa = smem + (step % kStages) * kStage;
    const unsigned a0 = smem_u32(sa) + wg * kPanel;  // this warpgroup's 64 rows of A
    const unsigned b0 = smem_u32(sa + kStageA);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t da = kTn ? smem_desc(a0 + kk * 2048, kPanel, 1024)
                              : smem_desc(a0 + kk * 32, 16, 1024);
      const uint64_t db = kKB ? smem_desc(b0 + kk * 32, 16, 1024)
                              : smem_desc(b0 + kk * 2048, kPanel, 1024);
      wgmma_m64n128k16<kTn ? 1 : 0, kKB ? 0 : 1>(d, da, db);
    }
    wgmma_commit();
    if (sums) {  // column tid of this step's A rows, read while the products run
      const unsigned char* col = sa + (tid >> 6) * kPanel + (tid & 7) * 2;
      const int c = (tid & 63) >> 3;
#pragma unroll 8
      for (int r = 0; r < kBK; ++r)
        csum += __bfloat162float(
            *reinterpret_cast<const __nv_bfloat16*>(col + r * 128 + ((c ^ (r & 7)) << 4)));
    }
    wgmma_wait<1>();
    fence_acc(d);
  }
  wgmma_wait<0>();
  fence_acc(d);
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: stage the accumulators through it

  float* stg = reinterpret_cast<float*>(smem);
  {
    const int lane = tid & 31, row = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
      *reinterpret_cast<float2*>(stg + row * kStgPitch + col) = make_float2(d[4 * j], d[4 * j + 1]);
      *reinterpret_cast<float2*>(stg + (row + 8) * kStgPitch + col) =
          make_float2(d[4 * j + 2], d[4 * j + 3]);
    }
  }
  __syncthreads();
  for (int e = tid; e < kBM * (kBN / 8); e += kThreads) {
    const int r = e >> 4, c = (e & 15) * 8, m = m0 + r, n = n0 + c;
    if (m >= p.M || n >= p.N) continue;
    float f[8], t[8];
    *reinterpret_cast<float4*>(f) = *reinterpret_cast<const float4*>(stg + r * kStgPitch + c);
    *reinterpret_cast<float4*>(f + 4) =
        *reinterpret_cast<const float4*>(stg + r * kStgPitch + c + 4);
    const size_t idx = (size_t)m * p.N + n;
    if (kTn) {
      if (p.ws != nullptr) {
        float* w = p.ws + (size_t)blockIdx.z * ((size_t)p.M * p.N + p.M) + idx;
        *reinterpret_cast<float4*>(w) = *reinterpret_cast<float4*>(f);
        *reinterpret_cast<float4*>(w + 4) = *reinterpret_cast<float4*>(f + 4);
      } else {
        *reinterpret_cast<uint4*>(p.dw + idx) = pack8(f);
      }
      continue;
    }
    if (p.bias != nullptr) {
      unpack8(ldg8(p.bias + n), t);
#pragma unroll
      for (int i = 0; i < 8; ++i) f[i] += t[i];
    }
    if (p.act == kActGelu) {
#pragma unroll
      for (int i = 0; i < 8; ++i) f[i] = gelu_erf(f[i]);
    } else if (p.act == kActGeluGrad) {
      unpack8(ldg8(p.aux + idx), t);
#pragma unroll
      for (int i = 0; i < 8; ++i) f[i] *= gelu_erf_grad(t[i]);
      if (p.aux_out != nullptr) {
#pragma unroll
        for (int i = 0; i < 8; ++i) t[i] = gelu_erf(t[i]);
        *reinterpret_cast<uint4*>(p.aux_out + idx) = pack8(t);
      }
    }
    const uint4 yv = pack8(f);
    if (p.y != nullptr) *reinterpret_cast<uint4*>(p.y + idx) = yv;
    if (p.out != nullptr) {
      // without a row scale the branch is rounded to T first, as the serving
      // kernels do; with one, res + s * v is rounded once
      float s = 1.f;
      if (p.row_scale != nullptr) {
        if (p.row_scale_on) s = p.row_scale[m / p.scale_div];
      } else {
        unpack8(yv, f);
      }
      unpack8(ldg8(p.res + idx), t);
#pragma unroll
      for (int i = 0; i < 8; ++i) f[i] = t[i] + s * f[i];
      *reinterpret_cast<uint4*>(p.out + idx) = pack8(f);
    }
  }
  if (sums && m0 + tid < p.M) {
    if (p.ws != nullptr)
      p.ws[(size_t)blockIdx.z * ((size_t)p.M * p.N + p.M) + (size_t)p.M * p.N + m0 + tid] = csum;
    else
      p.db[m0 + tid] = __float2bfloat16(csum);
  }
}

template <bool kTn, int kWg, bool kKB>
int launch_sm90(const Sm90Args& p, int splits, cudaStream_t s) {
  constexpr int kBM = 64 * kWg, kStages = stages<kWg>();
  constexpr size_t smem = (size_t)kStages * (kBM * 128 + kStageB) + 1024;
  static_assert(kBM * kStgPitch * sizeof(float) <= kStages * (kBM * 128 + kStageB),
                "the epilogue staging fits in the ring");
  static bool attr = false;  // once per process (one device)
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        gemm_sm90_kernel<kTn, kWg, kKB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  const dim3 grid((p.N + kBN - 1) / kBN, (p.M + kBM - 1) / kBM, splits);
  gemm_sm90_kernel<kTn, kWg, kKB><<<grid, 128 * kWg, smem, s>>>(p);
  return (int)cudaGetLastError();
}

constexpr int kSms = 132;  // H100 SXM

}  // namespace mumpy

extern "C" int mumpy_gemm_sm90(const void* a, const void* b, const void* bias, const void* res,
                               const float* row_scale, const void* aux, void* y, void* out,
                               void* aux_out, int M, int N, int K, int b_kmajor, int act,
                               int scale_div, int row_scale_on, void* stream) {
  using namespace mumpy;
  if (M <= 0 || N <= 0 || K <= 0 || N % 8 || K % 8 || act < kActNone || act > kActGeluGrad ||
      (act == kActGeluGrad && aux == nullptr) || (aux_out != nullptr && act != kActGeluGrad) ||
      (out != nullptr && res == nullptr) || (row_scale != nullptr && scale_div <= 0) ||
      !aligned16(a) || !aligned16(b) || !aligned16(bias) || !aligned16(res) ||
      !aligned16(aux) || !aligned16(y) || !aligned16(out) || !aligned16(aux_out))
    return (int)cudaErrorInvalidValue;
  Sm90Args p{static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
             static_cast<const __nv_bfloat16*>(bias), static_cast<const __nv_bfloat16*>(res),
             row_scale, static_cast<const __nv_bfloat16*>(aux),
             static_cast<__nv_bfloat16*>(y), static_cast<__nv_bfloat16*>(out),
             static_cast<__nv_bfloat16*>(aux_out), nullptr, nullptr, nullptr,
             M, N, K, act, scale_div, row_scale_on, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 128-row tiles (two warpgroups) once they fill every SM twice; else 64-row
  // tiles, two blocks to an SM
  const long tiles = (long)((M + 127) / 128) * ((N + kBN - 1) / kBN);
  if (tiles >= 2 * kSms)
    return b_kmajor ? launch_sm90<false, 2, true>(p, 1, s) : launch_sm90<false, 2, false>(p, 1, s);
  return b_kmajor ? launch_sm90<false, 1, true>(p, 1, s) : launch_sm90<false, 1, false>(p, 1, s);
}

extern "C" int mumpy_gemm_sm90_tn(const void* a, const void* b, float* ws, void* dw, void* db,
                                  int rows, int M, int N, int rows_per_split, void* stream) {
  using namespace mumpy;
  if (rows <= 0 || M <= 0 || N <= 0 || M % 8 || N % 8 || rows_per_split <= 0 ||
      dw == nullptr || db == nullptr || (ws == nullptr && rows_per_split < rows) ||
      !aligned16(a) || !aligned16(b) || !aligned16(ws) || !aligned16(dw))
    return (int)cudaErrorInvalidValue;
  Sm90Args p{static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
             nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, ws,
             static_cast<__nv_bfloat16*>(dw), static_cast<__nv_bfloat16*>(db),
             M, N, rows, kActNone, 1, 1, rows_per_split};
  const int splits = (rows + rows_per_split - 1) / rows_per_split;
  // 64-row tiles of dW, two blocks to an SM: the rows are split for parallelism
  return launch_sm90<true, 1, false>(p, splits, static_cast<cudaStream_t>(stream));
}
