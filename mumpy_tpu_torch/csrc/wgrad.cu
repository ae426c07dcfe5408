// Weight-gradient kernels of the training kernels' backward passes
// (swin_block_train, attn_ln_train, ln_mlp_train):
//
//   gemm_tn:       dW[o, i] = sum_m A[m, o] * B[m, i]   (A the layer's output
//                  gradient (M, O), B its input (M, I): dW in torch Linear's
//                  (out, in) layout), and the bias gradient
//                  db[o] = sum_m A[m, o]
//   col_sums:      dg[c] = sum_m dh[m, c] * xhat[m, c],  db[c] = sum_m dh[m, c]:
//                  the LayerNorm scale and bias gradients, xhat from x and the
//                  f32 row statistics ln_rows wrote
//   reduce_splits: out = T(sum_s ws[s, :]), the sum of the row splits' partials,
//                  for up to kMaxSums workspaces, each with its own T, in one
//                  launch
//
// Replace the weight-gradient sums of
// mumpy_tpu/ops/pallas/swin_block_vjp.py:_train_bwd_dw_kernel, which
// accumulates dW, the bias sums and the LayerNorm-scale sums in VMEM over the
// row tiles of its grid.  Here the rows (every token of every window) are
// many and O x I is small, so each kernel splits the rows over grid.z (or
// grid.y) and every split writes an f32 partial to a workspace;
// reduce_splits adds the partials in split order, so the result does not
// depend on the schedule.  With one split the kernel writes T directly.
// gemm_tn here is the f32 form, a SIMT loop with fmaf; the bf16 weight
// gradients run on the tensor cores in gemm_sm90.cu's TN form, whose row
// splits reduce_splits adds the same way.  col_sums and reduce_splits take
// both types and accumulate in f32.
#include "common.cuh"

namespace mumpy {

struct TnArgs {
  const void* a; const void* b;
  float* ws; void* dw; void* db;
  int M, O, I, rows_per_split;
};

// Value v of flat index idx of [dW (O*I) | db (O)]: to this split's slice of
// the workspace, or rounded to T into dW / db when there is no workspace.
template <typename T>
__device__ __forceinline__ void tn_store(const TnArgs& p, size_t idx, float v) {
  const size_t oi = (size_t)p.O * p.I;
  if (p.ws != nullptr) {
    p.ws[(size_t)blockIdx.z * (oi + p.O) + idx] = v;
  } else if (idx < oi) {
    static_cast<T*>(p.dw)[idx] = from_f<T>(v);
  } else {
    static_cast<T*>(p.db)[idx - oi] = from_f<T>(v);
  }
}

// ---- f32 SIMT: 64x64 tiles of dW, 16 rows of M per step ----
constexpr int kTnBM = 64, kTnBK = 16, kTnThreads = 256;

__global__ void __launch_bounds__(kTnThreads) gemm_tn_f32_kernel(TnArgs p) {
  __shared__ float As[kTnBK][kTnBM + 4];  // [m][o]
  __shared__ float Bs[kTnBK][kTnBM + 4];  // [m][i]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int o0 = blockIdx.y * kTnBM, i0 = blockIdx.x * kTnBM;
  const int m_begin = blockIdx.z * p.rows_per_split;
  const int m_end = min(p.M, m_begin + p.rows_per_split);
  const bool sums = blockIdx.x == 0;  // the first column of tiles sums A's columns
  const float* A = static_cast<const float*>(p.a);
  const float* B = static_cast<const float*>(p.b);
  float acc[4][4] = {};
  float csum = 0.f;
  for (int k0 = m_begin; k0 < m_end; k0 += kTnBK) {
#pragma unroll
    for (int e = tid; e < kTnBK * kTnBM; e += kTnThreads) {
      const int kk = e / kTnBM, c = e % kTnBM, m = k0 + kk;
      As[kk][c] = (m < m_end && o0 + c < p.O) ? A[(size_t)m * p.O + o0 + c] : 0.f;
      Bs[kk][c] = (m < m_end && i0 + c < p.I) ? B[(size_t)m * p.I + i0 + c] : 0.f;
    }
    __syncthreads();
    if (sums && tid < kTnBM) {
#pragma unroll
      for (int kk = 0; kk < kTnBK; ++kk) csum += As[kk][tid];
    }
#pragma unroll
    for (int kk = 0; kk < kTnBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = o0 + ty + 16 * i, c = i0 + tx + 16 * j;
      if (o < p.O && c < p.I) tn_store<float>(p, (size_t)o * p.I + c, acc[i][j]);
    }
  if (sums && tid < kTnBM && o0 + tid < p.O)
    tn_store<float>(p, (size_t)p.O * p.I + o0 + tid, csum);
}

// ---- LayerNorm parameter gradients: 32 columns x one row split per block ----
constexpr int kColThreads = 256, kColWarps = kColThreads / 32;

template <typename T>
__global__ void __launch_bounds__(kColThreads)
col_sums_kernel(const T* __restrict__ dh, const T* __restrict__ x, const float* __restrict__ mu,
                const float* __restrict__ rstd, float* __restrict__ ws, T* __restrict__ dg,
                T* __restrict__ db, int rows, int C, int rows_per_split) {
  __shared__ float s_g[kColWarps][32], s_b[kColWarps][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * 32 + lane;
  const int m0 = blockIdx.y * rows_per_split, m1 = min(rows, m0 + rows_per_split);
  float sg = 0.f, sb = 0.f;
  if (c < C) {
    for (int m = m0 + warp; m < m1; m += kColWarps) {
      const size_t idx = (size_t)m * C + c;
      const float d = to_f<T>(dh[idx]);
      sg += d * (to_f<T>(x[idx]) - mu[m]) * rstd[m];
      sb += d;
    }
  }
  s_g[warp][lane] = sg;
  s_b[warp][lane] = sb;
  __syncthreads();
  if (warp == 0 && c < C) {
    float g = 0.f, b = 0.f;
#pragma unroll
    for (int w = 0; w < kColWarps; ++w) {
      g += s_g[w][lane];
      b += s_b[w][lane];
    }
    if (ws != nullptr) {
      ws[(size_t)blockIdx.y * 2 * C + c] = g;
      ws[(size_t)blockIdx.y * 2 * C + C + c] = b;
    } else {
      dg[c] = from_f<T>(g);
      db[c] = from_f<T>(b);
    }
  }
}

// The workspaces one reduce_splits launch adds: entry i holds `splits`
// partials of len1 + len2 floats from element off of ws, summed in split
// order and rounded to its type (f32 or bf16) into out1 (len1) and out2
// (len2, may be 0); start is the running count of elements, start[n] the
// total.
constexpr int kMaxSums = 8;
struct SplitSums {
  long long off[kMaxSums];
  int splits[kMaxSums], len1[kMaxSums], len2[kMaxSums], bf16[kMaxSums], start[kMaxSums + 1];
  void* out1[kMaxSums];
  void* out2[kMaxSums];
  int n;
};

__global__ void __launch_bounds__(256) reduce_splits_kernel(const float* __restrict__ ws,
                                                            SplitSums p) {
  const int total = p.start[p.n];
  for (int g = blockIdx.x * blockDim.x + threadIdx.x; g < total; g += gridDim.x * blockDim.x) {
    int i = 0;
    while (g >= p.start[i + 1]) ++i;
    const int e = g - p.start[i], len = p.len1[i] + p.len2[i];
    const float* w = ws + p.off[i] + e;
    float s = 0.f;
    for (int k = 0; k < p.splits[i]; ++k) s += w[(size_t)k * len];
    void* out = e < p.len1[i] ? p.out1[i] : p.out2[i];
    const int at = e < p.len1[i] ? e : e - p.len1[i];
    if (p.bf16[i]) static_cast<__nv_bfloat16*>(out)[at] = __float2bfloat16(s);
    else static_cast<float*>(out)[at] = s;
  }
}

}  // namespace mumpy

extern "C" int mumpy_gemm_tn(const void* a, const void* b, float* ws, void* dw, void* db,
                             int M, int O, int I, int rows_per_split, int dtype,
                             void* stream) {
  using namespace mumpy;
  if (M <= 0 || O <= 0 || I <= 0 || rows_per_split <= 0 || dw == nullptr || db == nullptr ||
      (ws == nullptr && rows_per_split < M))
    return (int)cudaErrorInvalidValue;
  TnArgs p{a, b, ws, dw, db, M, O, I, rows_per_split};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int splits = (M + rows_per_split - 1) / rows_per_split;
  if (dtype != kF32) return (int)cudaErrorInvalidValue;  // bf16: mumpy_gemm_sm90_tn
  dim3 grid((I + kTnBM - 1) / kTnBM, (O + kTnBM - 1) / kTnBM, splits);
  gemm_tn_f32_kernel<<<grid, kTnThreads, 0, s>>>(p);
  return (int)cudaGetLastError();
}

extern "C" int mumpy_col_sums(const void* dh, const void* x, const float* mu, const float* rstd,
                              float* ws, void* dg, void* db, int rows, int C,
                              int rows_per_split, int dtype, void* stream) {
  using namespace mumpy;
  if (rows <= 0 || C <= 0 || rows_per_split <= 0 || (ws == nullptr && rows_per_split < rows))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((C + 31) / 32, (rows + rows_per_split - 1) / rows_per_split);
  if (dtype == kBF16)
    col_sums_kernel<__nv_bfloat16><<<grid, kColThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(dh), static_cast<const __nv_bfloat16*>(x), mu, rstd,
        ws, static_cast<__nv_bfloat16*>(dg), static_cast<__nv_bfloat16*>(db), rows, C,
        rows_per_split);
  else
    col_sums_kernel<float><<<grid, kColThreads, 0, st>>>(
        static_cast<const float*>(dh), static_cast<const float*>(x), mu, rstd, ws,
        static_cast<float*>(dg), static_cast<float*>(db), rows, C, rows_per_split);
  return (int)cudaGetLastError();
}

// desc holds (off, splits, len1, len2, dtype) for each of the n entries,
// outs their (out1, out2); both are host arrays, read here.
extern "C" int mumpy_reduce_splits(const float* ws, int n, const long long* desc,
                                   void* const* outs, void* stream) {
  using namespace mumpy;
  if (ws == nullptr || n <= 0 || n > kMaxSums) return (int)cudaErrorInvalidValue;
  SplitSums p{};
  p.n = n;
  long long total = 0;
  for (int i = 0; i < n; ++i) {
    p.off[i] = desc[5 * i];
    p.splits[i] = (int)desc[5 * i + 1];
    p.len1[i] = (int)desc[5 * i + 2];
    p.len2[i] = (int)desc[5 * i + 3];
    p.bf16[i] = desc[5 * i + 4] == kBF16;
    p.out1[i] = outs[2 * i];
    p.out2[i] = outs[2 * i + 1];
    if (p.splits[i] <= 0 || p.len1[i] <= 0 || p.len2[i] < 0 || p.out1[i] == nullptr ||
        (p.len2[i] > 0 && p.out2[i] == nullptr))
      return (int)cudaErrorInvalidValue;
    p.start[i] = (int)total;
    total += p.len1[i] + p.len2[i];
  }
  if (total > 0x7fffffff) return (int)cudaErrorInvalidValue;
  p.start[n] = (int)total;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long need = (total + 255) / 256;
  const int blocks = need < 1024 ? (int)need : 1024;
  reduce_splits_kernel<<<blocks, 256, 0, st>>>(ws, p);
  return (int)cudaGetLastError();
}
