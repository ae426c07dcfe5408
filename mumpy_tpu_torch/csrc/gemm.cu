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
// f32, and in bf16 the CVA ratio fold alone: every other bf16 product runs on
// the persistent wgmma GEMM of gemm_sm90.cu (cuda_lib.gemm routes it there),
// whose loads gather single rows and cannot sum a_sum of them.  A block owns
// one output tile and streams K through shared memory; the LayerNorm
// statistics of the tile's rows are computed in-block before the K loop.
// f32 runs a 64x64 SIMT loop with fmaf (no TF32).  bf16 runs the fold alone
// (y = sum of rows, times W, plus bias) on the tensor cores: 128x128 tiles,
// wmma 16x16x16 with f32 accumulation, 16-byte loads, the next k-tile
// prefetched into registers; it takes K and N multiples of 8 and 16-byte
// aligned operands and refuses other calls.  The fold's product (the CVA
// projection, B1 rows) is small beside the rest of the forward, so its loop
// stays as it is.
#include <mma.h>

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

// ---- bf16 tensor-core main loop: the CVA ratio fold ----
// 128x128 output tile, 8 warps of 64x32 (4x2 wmma 16x16x16 fragments), K in
// steps of 32.  Every global access moves 8 bf16 (16 bytes); the next k-tile
// is fetched into registers while the MMAs run on the current one.  Each warp
// runs its own epilogue (bias, y) through a 16x16 f32 staging tile.
constexpr int kTcBM = 128, kTcBN = 128, kTcBK = 32, kTcThreads = 256;
constexpr int kLdA = kTcBK + 8, kLdB = kTcBN + 8, kLdS = 16 + 4;  // padded pitches

// 8 consecutive A elements (m, k..k+7): the sum of the a_sum rows folded
// into row m
__device__ __forceinline__ uint4 a_fold(const GemmArgs& p, int m, int k) {
  if (m >= p.M || k >= p.K) return make_uint4(0, 0, 0, 0);
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p.x);
  const size_t base = (size_t)(m / p.a_seg) * p.a_sum * p.a_seg + m % p.a_seg;
  float acc[8] = {}, f[8];
  for (int t = 0; t < p.a_sum; ++t) {
    unpack8(ldg8(x + (base + (size_t)t * p.a_seg) * p.K + k), f);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] += f[i];
  }
  return pack8(acc);
}

__device__ __forceinline__ uint4 b_vec(const GemmArgs& p, int k, int n) {
  if (k >= p.K || n >= p.N) return make_uint4(0, 0, 0, 0);
  return ldg8(static_cast<const __nv_bfloat16*>(p.w) + (size_t)k * p.N + n);
}

__global__ void __launch_bounds__(kTcThreads, 2) gemm_bf16_fold_kernel(GemmArgs p) {
  using namespace nvcuda;
  // wmma wants 32-byte aligned fragment origins: the pitches (80, 272 and 80
  // bytes) keep every 16-row / 16-column origin on one
  __shared__ __align__(128) __nv_bfloat16 As[kTcBM * kLdA];
  __shared__ __align__(128) __nv_bfloat16 Bs[kTcBK * kLdB];
  __shared__ __align__(128) float stage[kTcThreads / 32][16 * kLdS];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;  // warp's 64x32 sub-tile
  const int m0 = blockIdx.y * kTcBM, n0 = blockIdx.x * kTcBN;
  // this thread's vectors: A rows ra / ra + 64 at column ka; B rows kb / kb + 16 at nb
  const int ra = tid >> 2, ka = (tid & 3) * 8;
  const int kb = tid >> 4, nb = (tid & 15) * 8;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  uint4 a0 = a_fold(p, m0 + ra, ka);
  uint4 a1 = a_fold(p, m0 + ra + 64, ka);
  uint4 b0 = b_vec(p, kb, n0 + nb);
  uint4 b1 = b_vec(p, kb + 16, n0 + nb);
  for (int k0 = 0; k0 < p.K; k0 += kTcBK) {
    *reinterpret_cast<uint4*>(As + ra * kLdA + ka) = a0;
    *reinterpret_cast<uint4*>(As + (ra + 64) * kLdA + ka) = a1;
    *reinterpret_cast<uint4*>(Bs + kb * kLdB + nb) = b0;
    *reinterpret_cast<uint4*>(Bs + (kb + 16) * kLdB + nb) = b1;
    __syncthreads();
    const int k1 = k0 + kTcBK;
    if (k1 < p.K) {  // next k-tile in flight during the MMAs
      a0 = a_fold(p, m0 + ra, k1 + ka);
      a1 = a_fold(p, m0 + ra + 64, k1 + ka);
      b0 = b_vec(p, k1 + kb, n0 + nb);
      b1 = b_vec(p, k1 + kb + 16, n0 + nb);
    }
#pragma unroll
    for (int ks = 0; ks < kTcBK; ks += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], As + (wm + 16 * i) * kLdA + ks, kLdA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + ks * kLdB + wn + 16 * j, kLdB);
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
  const __nv_bfloat16* bias = static_cast<const __nv_bfloat16*>(p.bias);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], kLdS, wmma::mem_row_major);
      __syncwarp();
      const int m = m0 + wm + 16 * i + sr, n = n0 + wn + 16 * j + sc;
      if (m < p.M && n < p.N) {
        float f[8], t[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) f[e] = st[sr * kLdS + sc + e];
        if (bias != nullptr) {
          unpack8(ldg8(bias + n), t);
#pragma unroll
          for (int e = 0; e < 8; ++e) f[e] += t[e];
        }
        *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(p.y) + (size_t)m * p.N + n) =
            pack8(f);
      }
      __syncwarp();
    }
  }
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
  GemmArgs p{x, w, bias, ln_g, ln_b, res, a_map, c_map, y, out, row_scale, aux, aux_out,
             M, N, K, a_sum, a_seg, act, map_len, scale_div};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {  // the fold alone: y = (sum of rows) W + bias
    const bool fold = a_sum > 1 && ln_g == nullptr && res == nullptr && out == nullptr &&
                      y != nullptr && row_scale == nullptr && act == kActNone &&
                      K % 8 == 0 && N % 8 == 0 && aligned16(x) && aligned16(w) &&
                      aligned16(bias) && aligned16(y);
    if (!fold) return (int)cudaErrorInvalidValue;
    dim3 grid((N + kTcBN - 1) / kTcBN, (M + kTcBM - 1) / kTcBM);
    gemm_bf16_fold_kernel<<<grid, kTcThreads, 0, s>>>(p);
  } else {
    dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
    gemm_f32_simt_kernel<<<grid, kSimtThreads, 0, s>>>(p);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* mumpy_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
