// Per-group bilinear sampling of the CVA partner windows.
//
//   s[r, i, g*gc + c] = sum over the 4 taps (y, x) of bilinear weight
//                       * x2[r, y*ws + x, g*gc + c]
//
// at the absolute pixel coordinates (gy, gx)[g, r % B1, i]; taps outside the
// ws x ws window contribute zero (torch grid_sample padding_mode='zeros',
// align_corners=True once the caller has unnormalised the grid).  Row r of the
// ratio-tiled partner pairs with query window r % B1, as jnp.tile orders it.
// sample_on = 0 takes the one tap at the floor of each coordinate with
// weight 1 (the bilinear weights ignored), a planted fault of the checks.
//
// Replaces the sampling stage of mumpy_tpu/ops/pallas/cva.py:_cva_kernel,
// which builds (N, N) weight matrices from one-hot expanders so the gather
// runs on the MXU.  On Hopper a gather of four taps is cheaper than a 49x49
// product: one thread per output element, channels fastest so a warp reads
// contiguous channels of each tap.  Bound by device-memory bytes: each output
// reads at most 4 partner values that mostly hit L1/L2.
#include "common.cuh"

namespace mumpy {

template <typename T>
__global__ void cva_sample_kernel(const T* __restrict__ x2, const float* __restrict__ gy,
                                  const float* __restrict__ gx, T* __restrict__ s,
                                  int R, int B1, int N, int C, int groups, int ws,
                                  int sample_on) {
  const size_t total = (size_t)R * N * C;
  const int gc = C / groups;
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    const int c = (int)(e % C);
    const size_t row = e / C;
    const int i = (int)(row % N);
    const int r = (int)(row / N);
    const int g = c / gc;
    const size_t ci = ((size_t)g * B1 + (r % B1)) * N + i;
    const float cy = gy[ci], cx = gx[ci];
    const float y0 = floorf(cy), x0 = floorf(cx);
    const float fy = sample_on ? cy - y0 : 0.f, fx = sample_on ? cx - x0 : 0.f;
    const int iy = (int)y0, ix = (int)x0;
    const T* base = x2 + (size_t)r * N * C + c;
    float acc = 0.f;
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const int yy = iy + dy;
      if (yy < 0 || yy >= ws) continue;
      const float wy = dy ? fy : 1.f - fy;
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const int xx = ix + dx;
        if (xx < 0 || xx >= ws) continue;
        const float wx = dx ? fx : 1.f - fx;
        acc = fmaf(wy * wx, to_f<T>(base[(size_t)(yy * ws + xx) * C]), acc);
      }
    }
    s[e] = from_f<T>(acc);
  }
}

}  // namespace mumpy

extern "C" int mumpy_cva_sample(const void* x2, const void* gy, const void* gx, void* s,
                                int R, int B1, int N, int C, int groups, int ws, int sample_on,
                                int dtype, void* stream) {
  using namespace mumpy;
  const size_t total = (size_t)R * N * C;
  const int threads = 256;
  const size_t want = (total + threads - 1) / threads;
  const int blocks = (int)(want < 65536 ? want : 65536);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* y = static_cast<const float*>(gy);
  const float* x = static_cast<const float*>(gx);
  if (dtype == kBF16)
    cva_sample_kernel<__nv_bfloat16><<<blocks, threads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x2), y, x, static_cast<__nv_bfloat16*>(s), R, B1,
        N, C, groups, ws, sample_on);
  else
    cva_sample_kernel<float><<<blocks, threads, 0, st>>>(
        static_cast<const float*>(x2), y, x, static_cast<float*>(s), R, B1, N, C, groups,
        ws, sample_on);
  return (int)cudaGetLastError();
}
