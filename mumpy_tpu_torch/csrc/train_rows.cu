// Row kernels of the training kernels' backward passes (attn_ln_train,
// ln_mlp_train): one warp per row of C channels, 8 rows per block.
//
//   ln_rows:        h = T(xhat * g + b), with the row statistics mu and rstd
//                   written out in f32 (xhat = (x - mu) * rstd, eps 1e-5);
//                   stats_on = 0 takes mu = 0 and rstd = 1, the planted fault
//                   of the checks (the serving sequences' LayerNorms)
//   ln_bwd_rows:    dx = T(dres + (dxh - mean(dxh) - xhat * mean(dxh * xhat)) * rstd),
//                   dxh = dh * g: the LayerNorm backward plus the residual's
//                   pass-through gradient
//   scale_add_rows: out = T(a + s[row / div] * b)   (a may be null): the
//                   keep-scaled cotangent of a stochastic-depth branch
//
// Replace the row-wise parts of the Pallas backward kernels
// mumpy_tpu/ops/pallas/attn_ln_vjp.py:_bwd_kernel and ln_mlp_vjp.py:_bwd_kernel
// (_ln_stats, _ln_bwd and the dyt / df2 scaling), which run in VMEM beside the
// matrix products.  Each reads and writes every element once or twice and is
// bound by device-memory bytes; statistics are kept in f32.
#include "common.cuh"

namespace mumpy {

constexpr int kRowThreads = 256, kRowsPerBlock = kRowThreads / 32;

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
ln_rows_kernel(const T* __restrict__ x, const T* __restrict__ g, const T* __restrict__ b,
               T* __restrict__ h, float* __restrict__ mu_out, float* __restrict__ rstd_out,
               int rows, int C, int stats_on) {
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* xr = x + (size_t)row * C;
  float s = 0.f;
  for (int k = lane; k < C; k += 32) s += to_f<T>(xr[k]);
  float mu = warp_sum(s) / C;
  float v = 0.f;
  for (int k = lane; k < C; k += 32) {
    const float d = to_f<T>(xr[k]) - mu;
    v += d * d;
  }
  float rs = rsqrtf(warp_sum(v) / C + 1e-5f);
  if (!stats_on) {
    mu = 0.f;
    rs = 1.f;
  }
  T* hr = h + (size_t)row * C;
  for (int k = lane; k < C; k += 32)
    hr[k] = from_f<T>((to_f<T>(xr[k]) - mu) * rs * to_f<T>(g[k]) + to_f<T>(b[k]));
  if (lane == 0) {
    mu_out[row] = mu;
    rstd_out[row] = rs;
  }
}

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
ln_bwd_rows_kernel(const T* __restrict__ x, const float* __restrict__ mu,
                   const float* __restrict__ rstd, const T* __restrict__ g,
                   const T* __restrict__ dh, const T* __restrict__ dres, T* __restrict__ dx,
                   int rows, int C) {
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  const size_t base = (size_t)row * C;
  const float m = mu[row], rs = rstd[row];
  float s1 = 0.f, s2 = 0.f;
  for (int k = lane; k < C; k += 32) {
    const float dxh = to_f<T>(dh[base + k]) * to_f<T>(g[k]);
    const float xh = (to_f<T>(x[base + k]) - m) * rs;
    s1 += dxh;
    s2 += dxh * xh;
  }
  const float m1 = warp_sum(s1) / C, m2 = warp_sum(s2) / C;
  for (int k = lane; k < C; k += 32) {
    const float dxh = to_f<T>(dh[base + k]) * to_f<T>(g[k]);
    const float xh = (to_f<T>(x[base + k]) - m) * rs;
    float v = (dxh - m1 - xh * m2) * rs;
    if (dres != nullptr) v += to_f<T>(dres[base + k]);
    dx[base + k] = from_f<T>(v);
  }
}

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
scale_add_rows_kernel(const T* __restrict__ a, const T* __restrict__ b,
                      const float* __restrict__ s, T* __restrict__ out, int rows, int C,
                      int div) {
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  const size_t base = (size_t)row * C;
  const float sr = s[row / div];
  for (int k = lane; k < C; k += 32) {
    float v = sr * to_f<T>(b[base + k]);
    if (a != nullptr) v += to_f<T>(a[base + k]);
    out[base + k] = from_f<T>(v);
  }
}

inline dim3 row_grid(int rows) { return dim3((rows + kRowsPerBlock - 1) / kRowsPerBlock); }

}  // namespace mumpy

extern "C" int mumpy_ln_rows(const void* x, const void* g, const void* b, void* h, float* mu,
                             float* rstd, int rows, int C, int stats_on, int dtype,
                             void* stream) {
  using namespace mumpy;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == kBF16)
    ln_rows_kernel<__nv_bfloat16><<<row_grid(rows), kRowThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(g),
        static_cast<const __nv_bfloat16*>(b), static_cast<__nv_bfloat16*>(h), mu, rstd,
        rows, C, stats_on);
  else
    ln_rows_kernel<float><<<row_grid(rows), kRowThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(g),
        static_cast<const float*>(b), static_cast<float*>(h), mu, rstd, rows, C, stats_on);
  return (int)cudaGetLastError();
}

extern "C" int mumpy_ln_bwd_rows(const void* x, const float* mu, const float* rstd,
                                 const void* g, const void* dh, const void* dres, void* dx,
                                 int rows, int C, int dtype, void* stream) {
  using namespace mumpy;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == kBF16)
    ln_bwd_rows_kernel<__nv_bfloat16><<<row_grid(rows), kRowThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), mu, rstd, static_cast<const __nv_bfloat16*>(g),
        static_cast<const __nv_bfloat16*>(dh), static_cast<const __nv_bfloat16*>(dres),
        static_cast<__nv_bfloat16*>(dx), rows, C);
  else
    ln_bwd_rows_kernel<float><<<row_grid(rows), kRowThreads, 0, st>>>(
        static_cast<const float*>(x), mu, rstd, static_cast<const float*>(g),
        static_cast<const float*>(dh), static_cast<const float*>(dres),
        static_cast<float*>(dx), rows, C);
  return (int)cudaGetLastError();
}

extern "C" int mumpy_scale_add_rows(const void* a, const void* b, const float* s, void* out,
                                    int rows, int C, int div, int dtype, void* stream) {
  using namespace mumpy;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || C <= 0 || div <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == kBF16)
    scale_add_rows_kernel<__nv_bfloat16><<<row_grid(rows), kRowThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b), s,
        static_cast<__nv_bfloat16*>(out), rows, C, div);
  else
    scale_add_rows_kernel<float><<<row_grid(rows), kRowThreads, 0, st>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), s,
        static_cast<float*>(out), rows, C, div);
  return (int)cudaGetLastError();
}
