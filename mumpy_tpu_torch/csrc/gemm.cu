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
// mumpy_tpu/ops/pallas/{ln_mlp,attn_ln,swin_block,swin_pair,cva,vit3}.py,
// which keep whole weight sets in VMEM.  On Hopper a block owns one output
// tile and streams K through shared memory; the LayerNorm statistics of the
// tile's rows are computed in-block before the K loop, so the normalised
// activations never go to device memory.  bf16 runs on the tensor cores:
// 128x128 tiles, wmma 16x16x16 with f32 accumulation, 16-byte loads, the next
// k-tile prefetched into registers; it takes K and N multiples of 8, 16-byte
// aligned operands and LayerNorm rows of at most 1024 (every flagship GEMM)
// and refuses other shapes.  f32 runs a 64x64 SIMT loop with fmaf (no TF32).
// Both are bound by issuing the tile loads and their prologue, not by the
// tensor-core rate (PERF.md, Findings); cp.async / TMA pipelines and wgmma are
// later work.
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

enum Act : int { kActNone = 0, kActGelu = 1, kActGeluGrad = 2 };

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// d gelu_erf / dv = Phi(v) + v * phi(v)
__device__ __forceinline__ float gelu_erf_grad(float v) {
  return 0.5f * (1.f + erff(v * 0.70710678118654752f)) +
         v * 0.39894228040143268f * expf(-0.5f * v * v);
}

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

// ---- bf16 tensor-core main loop (K and N multiples of 8, 16-byte aligned) ----
// 128x128 output tile, 8 warps of 64x32 (4x2 wmma 16x16x16 fragments), K in
// steps of 32.  Every global access moves 8 bf16 (16 bytes); the next k-tile
// is fetched into registers while the MMAs run on the current one.  Each warp
// runs its own epilogue through a 16x16 f32 staging tile.
constexpr int kTcBM = 128, kTcBN = 128, kTcBK = 32, kTcThreads = 256;
constexpr int kLdA = kTcBK + 8, kLdB = kTcBN + 8, kLdS = 16 + 4;  // padded pitches
constexpr int kTcMaxLnK = 1024;  // LayerNorm rows held in registers: 4 x 8 per lane

// LayerNorm statistics of the tile's rows from one vectorised pass: each
// lane keeps up to 32 values of its row in registers (K <= kTcMaxLnK).
__device__ void row_stats_vec(const GemmArgs& p, int m0, float* s_mu, float* s_rs) {
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p.x);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < kTcBM; r += kTcThreads / 32) {
    const int m = m0 + r;
    float mu = 0.f, rs = 0.f;
    if (m < p.M) {
      const int src = map_row(p.a_map, p.map_len, m);
      float v[4][8];
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = (lane + 32 * i) * 8;
        if (k < p.K) {
          unpack8(ldg8(x + (size_t)src * p.K + k), v[i]);
#pragma unroll
          for (int j = 0; j < 8; ++j) s += v[i][j];
        }
      }
      mu = warp_sum(s) / p.K;
      float q = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if ((lane + 32 * i) * 8 < p.K) {
#pragma unroll
          for (int j = 0; j < 8; ++j) q += (v[i][j] - mu) * (v[i][j] - mu);
        }
      }
      rs = rsqrtf(warp_sum(q) / p.K + 1e-5f);
    }
    if (lane == 0) { s_mu[r] = mu; s_rs[r] = rs; }
  }
}

// 8 consecutive A elements (m, k..k+7) after the prologue; src = a(m).
__device__ __forceinline__ uint4 a_vec(const GemmArgs& p, int m, int src, int k, int r,
                                       const float* s_mu, const float* s_rs) {
  if (m >= p.M || k >= p.K) return make_uint4(0, 0, 0, 0);
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p.x);
  if (p.a_sum > 1) {
    const size_t base = (size_t)(m / p.a_seg) * p.a_sum * p.a_seg + m % p.a_seg;
    float acc[8] = {}, f[8];
    for (int t = 0; t < p.a_sum; ++t) {
      unpack8(ldg8(x + (base + (size_t)t * p.a_seg) * p.K + k), f);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] += f[i];
    }
    return pack8(acc);
  }
  const uint4 u = ldg8(x + (size_t)src * p.K + k);
  if (p.ln_g == nullptr) return u;
  float f[8], g[8], b[8];
  unpack8(u, f);
  unpack8(ldg8(static_cast<const __nv_bfloat16*>(p.ln_g) + k), g);
  unpack8(ldg8(static_cast<const __nv_bfloat16*>(p.ln_b) + k), b);
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = (f[i] - s_mu[r]) * s_rs[r] * g[i] + b[i];
  return pack8(f);
}

__device__ __forceinline__ uint4 b_vec(const GemmArgs& p, int k, int n) {
  if (k >= p.K || n >= p.N) return make_uint4(0, 0, 0, 0);
  return ldg8(static_cast<const __nv_bfloat16*>(p.w) + (size_t)k * p.N + n);
}

__global__ void __launch_bounds__(kTcThreads, 2) gemm_bf16_tc_kernel(GemmArgs p) {
  using namespace nvcuda;
  // wmma wants 32-byte aligned fragment origins: the pitches (80, 272 and 80
  // bytes) keep every 16-row / 16-column origin on one
  __shared__ __align__(128) __nv_bfloat16 As[kTcBM * kLdA];
  __shared__ __align__(128) __nv_bfloat16 Bs[kTcBK * kLdB];
  __shared__ __align__(128) float stage[kTcThreads / 32][16 * kLdS];
  __shared__ float s_mu[kTcBM], s_rs[kTcBM];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;  // warp's 64x32 sub-tile
  const int m0 = blockIdx.y * kTcBM, n0 = blockIdx.x * kTcBN;
  if (p.ln_g != nullptr) {
    row_stats_vec(p, m0, s_mu, s_rs);
    __syncthreads();
  }
  // this thread's vectors: A rows ra / ra + 64 at column ka; B rows kb / kb + 16 at nb
  const int ra = tid >> 2, ka = (tid & 3) * 8;
  const int kb = tid >> 4, nb = (tid & 15) * 8;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  // source rows of this thread's two A rows, read once (the map is periodic,
  // so rows past M still index it in bounds; a_vec never loads them)
  const int sa0 = map_row(p.a_map, p.map_len, m0 + ra);
  const int sa1 = map_row(p.a_map, p.map_len, m0 + ra + 64);
  uint4 a0 = a_vec(p, m0 + ra, sa0, ka, ra, s_mu, s_rs);
  uint4 a1 = a_vec(p, m0 + ra + 64, sa1, ka, ra + 64, s_mu, s_rs);
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
      a0 = a_vec(p, m0 + ra, sa0, k1 + ka, ra, s_mu, s_rs);
      a1 = a_vec(p, m0 + ra + 64, sa1, k1 + ka, ra + 64, s_mu, s_rs);
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
        const size_t idx = (size_t)map_row(p.c_map, p.map_len, m) * p.N + n;
        if (p.act == kActGelu) {
#pragma unroll
          for (int e = 0; e < 8; ++e) f[e] = gelu_erf(f[e]);
        } else if (p.act == kActGeluGrad) {
          unpack8(ldg8(static_cast<const __nv_bfloat16*>(p.aux) + idx), t);
#pragma unroll
          for (int e = 0; e < 8; ++e) f[e] *= gelu_erf_grad(t[e]);
          if (p.aux_out != nullptr) {
#pragma unroll
            for (int e = 0; e < 8; ++e) t[e] = gelu_erf(t[e]);
            *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(p.aux_out) + idx) = pack8(t);
          }
        }
        const uint4 yv = pack8(f);
        if (p.y != nullptr)
          *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(p.y) + idx) = yv;
        if (p.out != nullptr) {
          // without a row scale the branch is rounded to T first, as the
          // serving kernels do; with one, res + s * v is rounded once
          float s = 1.f;
          if (p.row_scale != nullptr) s = p.row_scale[m / p.scale_div];
          else unpack8(yv, f);
          unpack8(ldg8(static_cast<const __nv_bfloat16*>(p.res) + idx), t);
#pragma unroll
          for (int e = 0; e < 8; ++e) f[e] = t[e] + s * f[e];
          *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(p.out) + idx) = pack8(f);
        }
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
  if (dtype == kBF16) {
    const bool tc = K % 8 == 0 && N % 8 == 0 && (ln_g == nullptr || K <= kTcMaxLnK) &&
                    aligned16(x) && aligned16(w) && aligned16(bias) && aligned16(ln_g) &&
                    aligned16(ln_b) && aligned16(res) && aligned16(y) && aligned16(out) &&
                    aligned16(aux) && aligned16(aux_out);
    if (!tc) return (int)cudaErrorInvalidValue;
    dim3 grid((N + kTcBN - 1) / kTcBN, (M + kTcBM - 1) / kTcBM);
    gemm_bf16_tc_kernel<<<grid, kTcThreads, 0, s>>>(p);
  } else {
    dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
    gemm_f32_simt_kernel<<<grid, kSimtThreads, 0, s>>>(p);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* mumpy_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
