// Attention of the global temporal ViT over n = 3 time-major tokens: one warp
// per (row, head).
//
//   o[i, r, h] = sum_j softmax_j(q[i, r, h] . k[j, r, h] * scale) v[j, r, h]
//
// for i, j in {0, 1, 2}.  qkv is (3, R, 3C) time-major (token i's slab holds
// rows i*R .. i*R+R-1, each q | k | v of C = H*hd columns); o is (3, R, C).
//
// Replaces the unrolled 3x3 attention of the Pallas kernel
// mumpy_tpu/ops/pallas/vit3.py:_vit3_kernel (with its head reducer and
// expander matmuls); the LN + qkv, projection and MLP products around it run
// through csrc/gemm.cu.  A warp holds q, k and v of its row and head for all
// three tokens in registers (hd <= 128: up to 4 values per lane), forms the
// nine dot products by warp shuffles and the softmax over three keys in f32,
// and writes o_i = sum_j p_ij v_j.  It does 36 R C flops against 24 R C bytes
// in bf16, so it is bound by device-memory bytes, not by arithmetic.
#include "common.cuh"

namespace mumpy {

constexpr int kVitThreads = 128;
constexpr int kVitMaxPer = 4;  // values per lane: hd <= 128

template <typename T>
__global__ void __launch_bounds__(kVitThreads)
vit3_attention_kernel(const T* __restrict__ qkv, T* __restrict__ o, int R, int H, int hd,
                      float scale) {
  const int wid = blockIdx.x * (kVitThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (wid >= R * H) return;  // no barrier follows
  const int r = wid / H, h = wid % H;
  const int C = H * hd;
  float q[3][kVitMaxPer], k[3][kVitMaxPer], v[3][kVitMaxPer];
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    const T* row = qkv + ((size_t)t * R + r) * 3 * C + h * hd;
#pragma unroll
    for (int e = 0; e < kVitMaxPer; ++e) {
      const int d = lane + 32 * e;
      const bool ok = d < hd;
      q[t][e] = ok ? to_f<T>(row[d]) * scale : 0.f;
      k[t][e] = ok ? to_f<T>(row[C + d]) : 0.f;
      v[t][e] = ok ? to_f<T>(row[2 * C + d]) : 0.f;
    }
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float s[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < kVitMaxPer; ++e) part = fmaf(q[i][e], k[j][e], part);
      s[j] = warp_sum(part);
    }
    const float mx = fmaxf(fmaxf(s[0], s[1]), s[2]);
    float p[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) p[j] = expf(s[j] - mx);
    const float inv = 1.f / (p[0] + p[1] + p[2]);
    T* orow = o + ((size_t)i * R + r) * C + h * hd;
#pragma unroll
    for (int e = 0; e < kVitMaxPer; ++e) {
      const int d = lane + 32 * e;
      if (d < hd) {
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < 3; ++j) acc = fmaf(p[j] * inv, v[j][e], acc);
        orow[d] = from_f<T>(acc);
      }
    }
  }
}

}  // namespace mumpy

extern "C" int mumpy_vit3_attention(const void* qkv, void* o, int R, int H, int hd,
                                    float scale, int dtype, void* stream) {
  using namespace mumpy;
  if (hd > 32 * kVitMaxPer || R <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int warps_per_block = kVitThreads / 32;
  const long long blocks = ((long long)R * H + warps_per_block - 1) / warps_per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (dtype == kBF16)
    vit3_attention_kernel<__nv_bfloat16><<<(unsigned)blocks, kVitThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(qkv), static_cast<__nv_bfloat16*>(o), R, H, hd,
        scale);
  else
    vit3_attention_kernel<float><<<(unsigned)blocks, kVitThreads, 0, s>>>(
        static_cast<const float*>(qkv), static_cast<float*>(o), R, H, hd, scale);
  return (int)cudaGetLastError();
}
