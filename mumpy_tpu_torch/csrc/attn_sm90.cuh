// The per-head machinery of the fused Hopper attention kernels at head width
// 32 and windows of at most 64 tokens (attn_sm90.cu, #3's attention half;
// cva_sm90.cu, #5's CVA core): one consumer warpgroup holds a window's 64
// rows (M = 64 for wgmma; rows past N are padding).  Per head it takes q, k
// and v as f32 accumulators (the m64n96 layout: 8-column groups j = 0..3 q,
// 4..7 k, 8..11 v), adds the biases and rounds to bf16: q into wgmma A
// fragments, k into a K-major key tile, v transposed into a K-major V^T
// tile, both in the warpgroup's own shared memory (128-byte swizzle); then
// S = q k^T with q from registers, the softmax in f32 registers, P as bf16
// A fragments into o = P v, and o as bf16 A fragments for the projection.
#pragma once

#include "sm90.cuh"

namespace mumpy {

constexpr int kArHd = 32;                          // the head width
constexpr int kArKeys = 64 * 128;                  // a consumer's key tile: 64 keys x 128 bytes
constexpr int kArScratch = kArKeys + kArHd * 128;  // and its V^T tile: 32 x 64 keys

// d (64 x 96, f32) += A (64 x 16) B (16 x 96), A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_m64n96k16(float (&d)[48], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "%48, %49, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(1));
}
// d (64 x 32, f32) += A (64 x 16) B (16 x 32), A from registers, B K-major
__device__ __forceinline__ void wgmma_rs_m64n32k16(float (&d)[16], const unsigned (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// S * scale + m in place over the 64 keys of rows r0 and r0 + 8 of the
// window (the m64n64 accumulator layout: s[4j..4j+3] hold rows r0, r0,
// r0 + 8, r0 + 8 at keys 8j + 2t and the next): keys >= N take -1e30 (with
// key_mask_on = 0, the planted fault, 0), rows >= N 0, the others
// mask(j, e, row, key), the kernel's additive term.
template <class Mask>
__device__ __forceinline__ void scale_mask_tile(float (&s)[32], float scale, int N,
                                                int key_mask_on, int r0, int t,
                                                const Mask& mask) {
  const float pad = key_mask_on ? -1e30f : 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + (e >> 1) * 8, key = 8 * j + 2 * t + (e & 1);
      const float m = key >= N ? pad : row < N ? mask(j, e, row, key) : 0.f;
      s[4 * j + e] = s[4 * j + e] * scale + m;
    }
}

// P = softmax(s) in place over the 64 keys of rows r0 and r0 + 8 (layout as
// scale_mask_tile's), f32, the row split over the lane's quad; rows >= N
// give 0.  The fast exponential: P is rounded to bf16 after.
__device__ __forceinline__ void softmax_tile(float (&s)[32], int N, int r0) {
  float mx0 = -3.0e38f, mx1 = -3.0e38f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
  }
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s[4 * j] = __expf(s[4 * j] - mx0);
    s[4 * j + 1] = __expf(s[4 * j + 1] - mx0);
    s[4 * j + 2] = __expf(s[4 * j + 2] - mx1);
    s[4 * j + 3] = __expf(s[4 * j + 3] - mx1);
    sum0 += s[4 * j] + s[4 * j + 1];
    sum1 += s[4 * j + 2] + s[4 * j + 3];
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, o);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, o);
  }
  const float inv0 = r0 < N ? 1.f / sum0 : 0.f, inv1 = r0 + 8 < N ? 1.f / sum1 : 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s[4 * j] *= inv0;
    s[4 * j + 1] *= inv0;
    s[4 * j + 2] *= inv1;
    s[4 * j + 3] *= inv1;
  }
}

// The bf16 A fragments of a (64 x 16 K) accumulator stretch: K-step kk of an
// accumulator with 8-column groups d[4j..4j+3], j = 2kk and 2kk + 1.
template <int N, int M>
__device__ __forceinline__ void acc_to_frags(unsigned (&a)[N][4], const float (&d)[M]) {
#pragma unroll
  for (int kk = 0; kk < N; ++kk) {
    a[kk][0] = pack_bf16x2(d[8 * kk], d[8 * kk + 1]);
    a[kk][1] = pack_bf16x2(d[8 * kk + 2], d[8 * kk + 3]);
    a[kk][2] = pack_bf16x2(d[8 * kk + 4], d[8 * kk + 5]);
    a[kk][3] = pack_bf16x2(d[8 * kk + 6], d[8 * kk + 7]);
  }
}

// A head's q | k | v accumulators (rows r0, r0 + 8; head columns 8j' + 2t
// and the next) + the biases bq, bk, bv (the head's 32 entries each), bf16:
// q to A fragments qa, k to the key tile, v to the V^T tile (128-byte
// swizzled rows).
__device__ __forceinline__ void qkv_to_tiles(const float (&qkv)[48], const __nv_bfloat16* bq,
                                             const __nv_bfloat16* bk, const __nv_bfloat16* bv,
                                             unsigned (&qa)[2][4], unsigned char* keys,
                                             unsigned char* vt, int r0, int t) {
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    const int part = j >> 2, col = 8 * (j & 3) + 2 * t;
    const __nv_bfloat16* bias = part == 0 ? bq : part == 1 ? bk : bv;
    const float2 bb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + col));
    const float v0 = qkv[4 * j] + bb.x, v1 = qkv[4 * j + 1] + bb.y;
    const float v2 = qkv[4 * j + 2] + bb.x, v3 = qkv[4 * j + 3] + bb.y;
    if (part == 0) {
      qa[j >> 1][2 * (j & 1)] = pack_bf16x2(v0, v1);
      qa[j >> 1][2 * (j & 1) + 1] = pack_bf16x2(v2, v3);
    } else if (part == 1) {  // key r, columns col, col + 1: 128-byte swizzled rows
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = r0 + 8 * hh;
        *reinterpret_cast<unsigned*>(keys + r * 128 + (((j & 3) ^ (r & 7)) << 4) + 4 * t) =
            pack_bf16x2(hh ? v2 : v0, hh ? v3 : v1);
      }
    } else {  // V^T: row col (and col + 1), key r
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = col + (e & 1), r = r0 + 8 * (e >> 1);
        *reinterpret_cast<__nv_bfloat16*>(vt + d * 128 + (((r >> 3) ^ (d & 7)) << 4) +
                                          (r & 7) * 2) =
            __float2bfloat16(e == 0 ? v0 : e == 1 ? v1 : e == 2 ? v2 : v3);
      }
    }
  }
}

// o = P v for the head whose q fragments qa and key and V^T tiles are in
// place: S = q k^T on wgmma, softmax(S) by `probs` (in place on the f32
// scores: scale_mask_tile with the kernel's term, then softmax_tile), P
// rounded to bf16 into A fragments, o = P v; o rounded to bf16 into oa
// (the A fragments of the head's projection).
template <class Probs>
__device__ __forceinline__ void head_attention(unsigned (&qa)[2][4], unsigned char* keys,
                                               unsigned char* vt, unsigned (&oa)[2][4],
                                               const Probs& probs) {
  float sc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;
  fence_acc(sc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
    wgmma_rs_m64n64k16<0>(sc, qa[kk], smem_desc(smem_u32(keys) + kk * 32, 16, 1024));
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(sc);
  fence_frags(qa);
  probs(sc);
  unsigned pa[4][4];
  acc_to_frags(pa, sc);  // P rounded to bf16 before P V, as the launch routes do

  float o[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) o[i] = 0.f;
  fence_acc(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs_m64n32k16(o, pa[kk], smem_desc(smem_u32(vt) + kk * 32, 16, 1024));
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(o);
  fence_frags(pa);
  acc_to_frags(oa, o);  // o rounded to bf16, as the launch routes store it
}

}  // namespace mumpy
