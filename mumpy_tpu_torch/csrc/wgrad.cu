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
//   reduce_splits: out = T(sum_s ws[s, :]), the sum of the row splits' partials
//
// Replace the weight-gradient sums of
// mumpy_tpu/ops/pallas/swin_block_vjp.py:_train_bwd_dw_kernel, which
// accumulates dW, the bias sums and the LayerNorm-scale sums in VMEM over the
// row tiles of its grid.  Here the rows (every token of every window) are
// many and O x I is small, so each kernel splits the rows over grid.z (or
// grid.y) and every split writes an f32 partial to a workspace;
// reduce_splits adds the partials in split order, so the result does not
// depend on the schedule.  With one split the kernel writes T directly.
// Accumulation is f32; bf16 runs on the tensor cores (wmma 16x16x16, A read
// column-major from its row-major tile), f32 on a SIMT loop with fmaf.
#include <mma.h>

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

// ---- bf16 tensor cores: 128x128 tiles of dW, 32 rows of M per step ----
// O and I multiples of 8, 16-byte aligned operands.  Each step stages the
// (32 x 128) slices of A and B row-major in shared memory; the MMAs read A's
// slice as a column-major 128 x 32 matrix (A^T), B's as row-major 32 x 128.
// 8 warps of 64x32 (4x2 fragments), the next slices prefetched into
// registers during the MMAs, and a per-warp epilogue through a staging tile.
constexpr int kTcBM = 128, kTcBK = 32, kTcThreads = 256;
constexpr int kLd = kTcBM + 8, kLdS = 16 + 4;  // padded pitches

__global__ void __launch_bounds__(kTcThreads, 2) gemm_tn_bf16_kernel(TnArgs p) {
  using namespace nvcuda;
  __shared__ __align__(128) __nv_bfloat16 As[kTcBK * kLd];  // [m][o]
  __shared__ __align__(128) __nv_bfloat16 Bs[kTcBK * kLd];  // [m][i]
  __shared__ __align__(128) float stage[kTcThreads / 32][16 * kLdS];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;  // warp's 64x32 sub-tile
  const int o0 = blockIdx.y * kTcBM, i0 = blockIdx.x * kTcBM;
  const int m_begin = blockIdx.z * p.rows_per_split;
  const int m_end = min(p.M, m_begin + p.rows_per_split);
  const bool sums = blockIdx.x == 0;
  const __nv_bfloat16* A = static_cast<const __nv_bfloat16*>(p.a);
  const __nv_bfloat16* B = static_cast<const __nv_bfloat16*>(p.b);
  // this thread's vectors: rows kr and kr + 16 of the step, 8 columns at nc
  const int kr = tid >> 4, nc = (tid & 15) * 8;
  auto load = [&](const __nv_bfloat16* src, int ld, int c0, int m) {
    if (m >= m_end || c0 + nc >= ld) return make_uint4(0, 0, 0, 0);
    return ldg8(src + (size_t)m * ld + c0 + nc);
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  float csum = 0.f;

  uint4 a0 = load(A, p.O, o0, m_begin + kr), a1 = load(A, p.O, o0, m_begin + kr + 16);
  uint4 b0 = load(B, p.I, i0, m_begin + kr), b1 = load(B, p.I, i0, m_begin + kr + 16);
  for (int k0 = m_begin; k0 < m_end; k0 += kTcBK) {
    *reinterpret_cast<uint4*>(As + kr * kLd + nc) = a0;
    *reinterpret_cast<uint4*>(As + (kr + 16) * kLd + nc) = a1;
    *reinterpret_cast<uint4*>(Bs + kr * kLd + nc) = b0;
    *reinterpret_cast<uint4*>(Bs + (kr + 16) * kLd + nc) = b1;
    __syncthreads();
    const int k1 = k0 + kTcBK;
    if (k1 < m_end) {  // next slices in flight during the MMAs
      a0 = load(A, p.O, o0, k1 + kr);
      a1 = load(A, p.O, o0, k1 + kr + 16);
      b0 = load(B, p.I, i0, k1 + kr);
      b1 = load(B, p.I, i0, k1 + kr + 16);
    }
    if (sums && tid < kTcBM) {
#pragma unroll 8
      for (int kk = 0; kk < kTcBK; ++kk) csum += __bfloat162float(As[kk * kLd + tid]);
    }
#pragma unroll
    for (int ks = 0; ks < kTcBK; ks += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], As + ks * kLd + wm + 16 * i, kLd);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + ks * kLd + wn + 16 * j, kLd);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // per-warp epilogue: stage one 16x16 fragment, each lane finishes 8 columns
  float* st = stage[warp];
  const int sr = lane >> 1, sc = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], kLdS, wmma::mem_row_major);
      __syncwarp();
      const int o = o0 + wm + 16 * i + sr, c = i0 + wn + 16 * j + sc;
      if (o < p.O && c < p.I) {
        float f[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) f[e] = st[sr * kLdS + sc + e];
        const size_t idx = (size_t)o * p.I + c;
        if (p.ws != nullptr) {
#pragma unroll
          for (int e = 0; e < 8; ++e) tn_store<__nv_bfloat16>(p, idx + e, f[e]);
        } else {
          *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(p.dw) + idx) = pack8(f);
        }
      }
      __syncwarp();
    }
  }
  if (sums && tid < kTcBM && o0 + tid < p.O)
    tn_store<__nv_bfloat16>(p, (size_t)p.O * p.I + o0 + tid, csum);
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

template <typename T>
__global__ void __launch_bounds__(256)
reduce_splits_kernel(const float* __restrict__ ws, int splits, int len1, T* __restrict__ out1,
                     int len2, T* __restrict__ out2) {
  const int len = len1 + len2;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < len; e += gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += ws[(size_t)k * len + e];
    if (e < len1) out1[e] = from_f<T>(s);
    else out2[e - len1] = from_f<T>(s);
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
  if (dtype == kBF16) {
    if (O % 8 || I % 8 || !aligned16(a) || !aligned16(b) || !aligned16(dw) || !aligned16(ws))
      return (int)cudaErrorInvalidValue;
    dim3 grid((I + kTcBM - 1) / kTcBM, (O + kTcBM - 1) / kTcBM, splits);
    gemm_tn_bf16_kernel<<<grid, kTcThreads, 0, s>>>(p);
  } else {
    dim3 grid((I + kTnBM - 1) / kTnBM, (O + kTnBM - 1) / kTnBM, splits);
    gemm_tn_f32_kernel<<<grid, kTnThreads, 0, s>>>(p);
  }
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

extern "C" int mumpy_reduce_splits(const float* ws, int splits, int len1, void* out1, int len2,
                                   void* out2, int dtype, void* stream) {
  using namespace mumpy;
  if (splits <= 0 || len1 <= 0 || len2 <= 0 || out1 == nullptr || out2 == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int need = (len1 + len2 + 255) / 256, blocks = need < 1024 ? need : 1024;
  if (dtype == kBF16)
    reduce_splits_kernel<__nv_bfloat16><<<blocks, 256, 0, st>>>(
        ws, splits, len1, static_cast<__nv_bfloat16*>(out1), len2,
        static_cast<__nv_bfloat16*>(out2));
  else
    reduce_splits_kernel<float><<<blocks, 256, 0, st>>>(
        ws, splits, len1, static_cast<float*>(out1), len2, static_cast<float*>(out2));
  return (int)cudaGetLastError();
}
