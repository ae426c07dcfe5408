// The register-resident attention tile shared by the bf16 window-attention
// cores (window_attention.cu, window_attention_bwd.cu): one warp's 16 query
// rows of a window of at most 64 keys and a head width of 32, on mma.sync
// m16n8k16 with f32 accumulators.  q, k, v (and dO) of a window sit in
// shared memory as (64, kTcPitch) bf16 tiles, rows >= N zero.
#pragma once

#include "common.cuh"

namespace mumpy {

constexpr int kMaxN = 64;

// The additive mask+bias, (P, H, N, N) in f32 or bf16 with element
// strides s[4] (a permuted or expanded view reads as it is), or none (p null).
struct MaskBias {
  const void* p;
  int bf16;
  int s[4];
  __device__ __forceinline__ float at(int slot, int h, int i, int j) const {
    const size_t e = (size_t)slot * s[0] + (size_t)h * s[1] + (size_t)i * s[2] + (size_t)j * s[3];
    return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[e])
                : static_cast<const float*>(p)[e];
  }
};
constexpr int kTcHd = 32;
constexpr int kTcPitch = kTcHd + 8;  // 80-byte rows: the 8 rows of an ldmatrix hit distinct banks
constexpr int kTcTile = kMaxN * kTcPitch;

// The additive term of rows (i0 + g, i0 + g + 8), keys 8j + 2t, 8j + 2t + 1
// in the accumulator layout of mma_bf16: mb[slot, h], and -1e30 at the keys
// past N (the pad mask).  Rows past N read 0 (their P is dropped).
__device__ __forceinline__ void load_mask_bias(float (&m)[kMaxN / 8][4], const MaskBias& mb,
                                               int slot, int h, int N, int i0, int g, int t) {
#pragma unroll
  for (int j = 0; j < kMaxN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = i0 + g + (e >> 1) * 8, key = 8 * j + 2 * t + (e & 1);
      m[j][e] = key >= N ? -1e30f
                         : (mb.p != nullptr && row < N ? mb.at(slot, h, row, key) : 0.f);
    }
  }
}

// P = softmax(S * scale + m) over the 64 keys of rows g and g + 8 of the
// warp's tile (in place, f32; rows past N give 0), the row split over the
// lane's quad.
__device__ __forceinline__ void softmax_rows(float (&s)[kMaxN / 8][4],
                                             const float (&m)[kMaxN / 8][4], float scale,
                                             bool ok0, bool ok1) {
  float mx0 = -3.0e38f, mx1 = -3.0e38f;
#pragma unroll
  for (int j = 0; j < kMaxN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = s[j][e] * scale + m[j][e];
    mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
    mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
  }
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxN / 8; ++j) {
    s[j][0] = expf(s[j][0] - mx0);
    s[j][1] = expf(s[j][1] - mx0);
    s[j][2] = expf(s[j][2] - mx1);
    s[j][3] = expf(s[j][3] - mx1);
    sum0 += s[j][0] + s[j][1];
    sum1 += s[j][2] + s[j][3];
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, o);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, o);
  }
  const float inv0 = ok0 ? 1.f / sum0 : 0.f, inv1 = ok1 ? 1.f / sum1 : 0.f;
#pragma unroll
  for (int j = 0; j < kMaxN / 8; ++j) {
    s[j][0] *= inv0;
    s[j][1] *= inv0;
    s[j][2] *= inv1;
    s[j][3] *= inv1;
  }
}

// S = Q K^T for the warp's 16 query rows (from row i0 of qs) against the 64
// keys of ks, both (64, kTcPitch) bf16 tiles.
__device__ __forceinline__ void scores(float (&s)[kMaxN / 8][4], const __nv_bfloat16* qs,
                                       const __nv_bfloat16* ks, int i0, int lane) {
  unsigned qa[2][4];
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
    ldsm_x4(qa[kk], qs + (i0 + (lane & 15)) * kTcPitch + 16 * kk + (lane >> 4) * 8);
#pragma unroll
  for (int j = 0; j < kMaxN / 8; ++j) {
    unsigned kb[4];  // keys 8j..8j+7, head columns 0, 8, 16, 24
    ldsm_x4(kb, ks + (8 * j + (lane & 7)) * kTcPitch + (lane >> 3) * 8);
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    mma_bf16(s[j], qa[0], kb[0], kb[1]);
    mma_bf16(s[j], qa[1], kb[2], kb[3]);
  }
}

// acc (16 x 32) += A B with A the warp's (16 x 64) bf16 fragments a[kk] over
// the 64 rows of the (64, kTcPitch) tile bs, read through ldmatrix.trans.
__device__ __forceinline__ void times_tile(float (&acc)[kTcHd / 8][4], const unsigned (&a)[4][4],
                                           const __nv_bfloat16* bs, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int jp = 0; jp < 2; ++jp) {
      unsigned b[4];  // rows 16kk..16kk+15, columns 16jp..16jp+15
      ldsm_x4_t(b, bs + (16 * kk + (lane & 15)) * kTcPitch + 16 * jp + (lane >> 4) * 8);
      mma_bf16(acc[2 * jp], a[kk], b[0], b[1]);
      mma_bf16(acc[2 * jp + 1], a[kk], b[2], b[3]);
    }
  }
}

// The A fragments of a (16 x 64) accumulator tile scaled by f, rounded to bf16.
__device__ __forceinline__ void to_a_frags(unsigned (&a)[4][4], const float (&s)[kMaxN / 8][4],
                                           float f) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16x2(s[2 * kk][0] * f, s[2 * kk][1] * f);
    a[kk][1] = pack_bf16x2(s[2 * kk][2] * f, s[2 * kk][3] * f);
    a[kk][2] = pack_bf16x2(s[2 * kk + 1][0] * f, s[2 * kk + 1][1] * f);
    a[kk][3] = pack_bf16x2(s[2 * kk + 1][2] * f, s[2 * kk + 1][3] * f);
  }
}

}  // namespace mumpy
