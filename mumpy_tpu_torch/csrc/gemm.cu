// Tiled GEMM with a LayerNorm or row-fold prologue and a bias / GELU /
// residual epilogue: the matrix-product core of the ln_mlp, attn_ln,
// swin_block, swin_pair, cva and vit3 kernels.
//
//   A[m, :] = LN(x[a(m), :]) rounded to T     (ln_g != null)
//           = sum_t x[row(m, t), :]            (a_sum > 1: the CVA ratio fold,
//             row(m, t) = ((m / a_seg) * a_sum + t) * a_seg + m % a_seg)
//           = x[a(m), :]                       (otherwise)
//   v      = A @ W + bias,  W is (K, N) row-major
//   v      = gelu_erf(v)                       (act 1)
//          = v * gelu_erf'(aux[c(m), n])       (act 2: the GELU backward, aux = f1;
//            with aux_out, also aux_out[c(m), n] = T(gelu_erf(aux)), the
//            activation the fc2 weight gradient reads)
//   y[c(m), n] = T(v)                          (y != null)
//   out[c(m), n] = T(res[c(m), n] + T(v))     (out != null; res required)
//                = T(res[c(m), n] + s[m / d] * v)   (with a row scale s, f32,
//                  divisor d: the stochastic-depth keep of the training kernels)
//
// a(m) and c(m) are optional row maps of period L (map_len): a(m) =
// (m / L) * L + a_map[m % L], and likewise c(m) with c_map; without a map the
// row is m.  They turn the cyclic shift of a shifted Swin block into a row
// gather in the qkv GEMM's loads and a row scatter in the projection GEMM's
// residual loads and stores (swin_pair), so the shift moves no bytes of its
// own.
//
// Replaces the matrix products inside the Pallas kernels
// mumpy_tpu/ops/pallas/{ln_mlp,attn_ln,swin_block,swin_pair,cva,vit3}.py in
// f32; every bf16 product runs on the persistent wgmma GEMM of gemm_sm90.cu
// (cuda_lib.gemm routes it there), and the bf16 CVA folds its ratio in the
// attention core or in its fused kernel (cva_sm90.cu).  A block owns one
// output tile and streams K through shared memory; the LayerNorm statistics
// of the tile's rows are computed in-block before the K loop.  A 64x64 SIMT
// loop with fmaf (no TF32); it takes f32 only and refuses bf16.
#include "common.cuh"

namespace mumpy {

constexpr int kBM = 64, kBN = 64;

struct GemmArgs {
  const void* x; const void* w; const void* bias;
  const void* ln_g; const void* ln_b; const void* res;
  const int* a_map; const int* c_map;
  void* y; void* out;
  const float* row_scale; const void* aux; void* aux_out;
  int M, N, K, a_sum, a_seg, act, map_len, scale_div;
};

// Row m through a row map of period len (no map: m itself).
__device__ __forceinline__ int map_row(const int* map, int len, int m) {
  return map == nullptr ? m : (m / len) * len + map[m % len];
}

// LayerNorm statistics of the tile's rows: two passes (mean, then centred
// variance), one warp per row.
__device__ void row_stats(const GemmArgs& p, int m0, int rows, float* s_mu, float* s_rs) {
  const float* x = static_cast<const float*>(p.x);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += blockDim.x / 32) {
    const int m = m0 + r;
    float mu = 0.f, rs = 0.f;
    if (m < p.M) {
      const float* xr = x + (size_t)map_row(p.a_map, p.map_len, m) * p.K;
      float s = 0.f;
      for (int k = lane; k < p.K; k += 32) s += xr[k];
      mu = warp_sum(s) / p.K;
      float v = 0.f;
      for (int k = lane; k < p.K; k += 32) {
        const float d = xr[k] - mu;
        v += d * d;
      }
      rs = rsqrtf(warp_sum(v) / p.K + 1e-5f);
    }
    if (lane == 0) { s_mu[r] = mu; s_rs[r] = rs; }
  }
}

// Element (m, k) of A after the prologue; r = m - m0 indexes the row stats.
__device__ __forceinline__ float a_elem(const GemmArgs& p, int m, int k, int r,
                                        const float* s_mu, const float* s_rs) {
  if (m >= p.M || k >= p.K) return 0.f;
  const float* x = static_cast<const float*>(p.x);
  if (p.a_sum > 1) {
    const size_t base = (size_t)(m / p.a_seg) * p.a_sum * p.a_seg + m % p.a_seg;
    float a = 0.f;
    for (int t = 0; t < p.a_sum; ++t) a += x[(base + (size_t)t * p.a_seg) * p.K + k];
    return a;
  }
  const float a = x[(size_t)map_row(p.a_map, p.map_len, m) * p.K + k];
  if (p.ln_g == nullptr) return a;
  return (a - s_mu[r]) * s_rs[r] * static_cast<const float*>(p.ln_g)[k] +
         static_cast<const float*>(p.ln_b)[k];
}

__device__ __forceinline__ float b_elem(const GemmArgs& p, int k, int n) {
  return (k < p.K && n < p.N) ? static_cast<const float*>(p.w)[(size_t)k * p.N + n] : 0.f;
}

__device__ __forceinline__ void epilogue(const GemmArgs& p, int m, int n, float v) {
  if (m >= p.M || n >= p.N) return;
  if (p.bias != nullptr) v += static_cast<const float*>(p.bias)[n];
  const size_t idx = (size_t)map_row(p.c_map, p.map_len, m) * p.N + n;
  if (p.act == kActGelu) v = gelu_erf(v);
  else if (p.act == kActGeluGrad) {
    const float f1 = static_cast<const float*>(p.aux)[idx];
    v *= gelu_erf_grad(f1);
    if (p.aux_out != nullptr) static_cast<float*>(p.aux_out)[idx] = gelu_erf(f1);
  }
  if (p.y != nullptr) static_cast<float*>(p.y)[idx] = v;
  if (p.out != nullptr) {
    const float s = p.row_scale != nullptr ? p.row_scale[m / p.scale_div] : 1.f;
    static_cast<float*>(p.out)[idx] = static_cast<const float*>(p.res)[idx] + s * v;
  }
}

// ---- f32 SIMT main loop ----
constexpr int kSimtBK = 16, kSimtThreads = 256;

__global__ void __launch_bounds__(kSimtThreads) gemm_f32_simt_kernel(GemmArgs p) {
  __shared__ float As[kSimtBK][kBM + 4];  // A tile, k-major
  __shared__ float Bs[kSimtBK][kBN + 4];
  __shared__ float s_mu[kBM], s_rs[kBM];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  if (p.ln_g != nullptr) {
    row_stats(p, m0, kBM, s_mu, s_rs);
    __syncthreads();
  }
  const int tx = tid & 15, ty = tid >> 4;  // thread owns rows ty+16i, cols tx+16j
  float acc[4][4] = {};
  for (int k0 = 0; k0 < p.K; k0 += kSimtBK) {
#pragma unroll
    for (int i = 0; i < (kBM * kSimtBK) / kSimtThreads; ++i) {
      const int e = tid + i * kSimtThreads;
      const int r = e / kSimtBK, kk = e % kSimtBK;
      As[kk][r] = a_elem(p, m0 + r, k0 + kk, r, s_mu, s_rs);
    }
#pragma unroll
    for (int i = 0; i < (kSimtBK * kBN) / kSimtThreads; ++i) {
      const int e = tid + i * kSimtThreads;
      const int kk = e / kBN, c = e % kBN;
      Bs[kk][c] = b_elem(p, k0 + kk, n0 + c);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSimtBK; ++kk) {
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
    for (int j = 0; j < 4; ++j) epilogue(p, m0 + ty + 16 * i, n0 + tx + 16 * j, acc[i][j]);
}

}  // namespace mumpy

extern "C" int mumpy_gemm(const void* x, const void* w, const void* bias,
                          const void* ln_g, const void* ln_b, const void* res,
                          const int* a_map, const int* c_map, void* y, void* out,
                          const float* row_scale, const void* aux, void* aux_out,
                          int M, int N, int K,
                          int a_sum, int a_seg, int act, int map_len, int scale_div,
                          int dtype, void* stream) {
  using namespace mumpy;
  if ((a_map != nullptr || c_map != nullptr) && (map_len <= 0 || M % map_len || a_sum > 1))
    return (int)cudaErrorInvalidValue;
  if ((row_scale != nullptr && scale_div <= 0) || (act == kActGeluGrad && aux == nullptr) ||
      act < kActNone || act > kActGeluGrad || (aux_out != nullptr && act != kActGeluGrad))
    return (int)cudaErrorInvalidValue;
  if (dtype != kF32) return (int)cudaErrorInvalidValue;  // bf16: gemm_sm90.cu
  GemmArgs p{x, w, bias, ln_g, ln_b, res, a_map, c_map, y, out, row_scale, aux, aux_out,
             M, N, K, a_sum, a_seg, act, map_len, scale_div};
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  gemm_f32_simt_kernel<<<grid, kSimtThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* mumpy_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
