// The MLP half of a serving Swin block at C <= 256, fused for Hopper (sm_90a),
// bf16:
//
//   h = T(LN(x))                        (row statistics in f32, eps 1e-5)
//   g = T(gelu_erf(h W1 + b1))          (hidden chunk by chunk, never stored)
//   y = T(x + T(g W2 + b2))
//
// x, y (M, C) row-major; W1 (C, hidden) and W2 (hidden, C) row-major, (in,
// out) as the serving operands store them.  ln_stats_on = 0 takes mean 0 and
// rstd 1 and gelu_on = 0 replaces GELU by the identity: the planted faults of
// the checks.
//
// Replaces the MLP half of mumpy_tpu/ops/pallas/swin_block.py:_block_kernel
// (:245-270), which chunks fc1 -> GELU -> fc2 over windows with the hidden in
// VMEM.  The two-GEMM route (gemm_sm90.cu) stores the 4C-wide hidden and reads
// it back: at C <= 256 that traffic and the GELU epilogue over 4C columns set
// most of fc1's time (K is only 1.5-4 steps of 64; PERF.md, Findings),
// while the work is bound by the tensor cores' rate (about 2C flops per byte
// of x and y) and, at C <= 128, by the CUDA cores' issue of the exact-erf GELU
// over the 4C hidden.  Here the hidden stays on chip: one block per SM walks
// 128-row tiles (persistent).  Warpgroup 0 is the producer: one thread loads
// each tile's rows of x by TMA into the K-major A tile, once both consumers'
// last fc1 of the previous tile has read it, and streams each 64-wide chunk of
// W1 (C x 64) and W2 (64 x C) by TMA into two rings (128-byte swizzle,
// completion on mbarriers).  Warpgroups 1 and 2 are the consumers, 64 rows of
// the tile each: each normalises its rows in place in the A tile once (no
// ln_rows pass, no h in device memory); then per chunk acc1 = h W1[:, chunk]
// on wgmma (A and B from shared memory), + b1 and GELU in registers, rounded
// to bf16 straight into the A fragments of acc2 += g W2[chunk, :] (wgmma with
// A from registers), the (64 x C) f32 acc2 held in registers across the
// chunks; the epilogue adds b2 and the residual x (an 8-row half's loads
// issued together), 8 rows at a time through a per-warp staging slice
// (16-byte stores).
// A hidden that is not a whole number of chunks reads zeros past its end (the
// TMA's fill; b1 is masked).  Measured against this (PERF.md, Findings),
// each slower: the consumers loading their own rows for the LayerNorm;
// overlapping a warpgroup's GELU with its next fc1 (two acc1 buffers, waits
// chosen at run time, which made ptxas serialise every wgmma); the
// consumers taking turns at issuing (named barriers).
#include <algorithm>

#include "sm90.cuh"

namespace mumpy {

constexpr int kMlpBM = 128, kMlpHC = 64, kMlpThreads = 384;
constexpr int kEPitch = 64 + 4;  // f32 epilogue staging pitch (64 columns at a time)
constexpr int kEStg = 8 * 8 * kEPitch * 4;  // 8 rows of staging per consumer warp

// Shared memory of the instance for acc2 widths NC (C rounded up to 64): the
// A tile ((NC / 64) K panels of 128 rows x 128 bytes), two rings of kStages
// stages (a W1 chunk: C K rows x 128 bytes; a W2 chunk: NC / 64 N panels of 64
// K rows x 128 bytes), the staging and the barriers.
template <int NC> struct MlpSmem {
  static constexpr int kA = NC * 256, kStage = NC * 128;
  static constexpr int kFixed = 1024 + kA + kEStg + 256;
  static constexpr int kStages = std::min(4, (232448 - kFixed) / (2 * kStage));
  static constexpr int kBytes = kFixed + 2 * kStages * kStage;
  static_assert(kStages >= 2, "two stages of each ring fit");
};

struct MlpArgs {
  const __nv_bfloat16 *x, *ln_g, *ln_b, *b1, *b2;
  __nv_bfloat16* y;
  int M, C, hidden, ln_stats_on, gelu_on, tiles;
};

// d (64 x 64, f32) += A (64 x 16) B (16 x 64), A K-major in shared memory, B
// N-major; the accumulator layout of wgmma_m64n128k16 (gemm_sm90.cu) with
// j < 8.
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <int NC>
__global__ void __launch_bounds__(kMlpThreads, 1)
    mlp_rows_kernel(const __grid_constant__ CUtensorMap x_tmap,
                    const __grid_constant__ CUtensorMap w1_tmap,
                    const __grid_constant__ CUtensorMap w2_tmap, MlpArgs p) {
  using S = MlpSmem<NC>;
  constexpr int kStages = S::kStages, kNq = NC / 64;
  extern __shared__ unsigned char smem_raw[];
  // the swizzle repeats every 1024 bytes: the tile and the stages start on such a boundary
  unsigned char* a_tile = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* w1s = a_tile + S::kA;
  unsigned char* w2s = w1s + kStages * S::kStage;
  float* stg_all = reinterpret_cast<float*>(w2s + kStages * S::kStage);
  uint64_t* bars = reinterpret_cast<uint64_t*>(reinterpret_cast<unsigned char*>(stg_all) + kEStg);
  const unsigned full1 = smem_u32(bars), empty1 = full1 + 8 * kStages;
  const unsigned full2 = empty1 + 8 * kStages, empty2 = full2 + 8 * kStages;
  const unsigned a_full = empty2 + 8 * kStages, a_empty = a_full + 8;  // the A tile

  const int tid = threadIdx.x, wg = tid >> 7;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full1 + 8 * s, 1);  // the producer's expect_tx
      mbar_init(full2 + 8 * s, 1);
      mbar_init(empty1 + 8 * s, 8);  // one per consumer warp
      mbar_init(empty2 + 8 * s, 8);
    }
    mbar_init(a_full, 1);
    mbar_init(a_empty, 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int chunks = (p.hidden + kMlpHC - 1) / kMlpHC;

  if (wg == 0) {  // ---- the producer: one thread streams the weight chunks ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      int it = 0, tp = 0;
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, tp ^= 1) {
        // the tile's raw rows into the A tile once both consumers' last fc1 is done
        mbar_wait(a_empty, tp ^ 1);
        mbar_expect_tx(a_full, kNq * kMlpBM * 128);
#pragma unroll
        for (int q = 0; q < kNq; ++q)
          tma_load_2d(smem_u32(a_tile + q * (kMlpBM * 128)), &x_tmap, a_full, 64 * q,
                      tile * kMlpBM);
        for (int j = 0; j < chunks; ++j, ++it) {
          const int s = it % kStages;
          const unsigned ph = ((it / kStages) & 1) ^ 1;
          mbar_wait(empty1 + 8 * s, ph);
          mbar_expect_tx(full1 + 8 * s, p.C * 128);
          tma_load_2d(smem_u32(w1s + s * S::kStage), &w1_tmap, full1 + 8 * s, kMlpHC * j, 0);
          mbar_wait(empty2 + 8 * s, ph);
          mbar_expect_tx(full2 + 8 * s, NC * 128);
#pragma unroll
          for (int q = 0; q < kNq; ++q)
            tma_load_2d(smem_u32(w2s + s * S::kStage + q * kPanel), &w2_tmap, full2 + 8 * s,
                        64 * q, kMlpHC * j);
        }
      }
    }
  } else {  // ---- the consumers: 64 rows of the tile each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1, warp = (tid >> 5) & 3, lane = tid & 31, t = lane & 3;
    float* stg = stg_all + (cw * 4 + warp) * 8 * kEPitch;  // this warp's staging slice
    const unsigned a0 = smem_u32(a_tile) + cw * kPanel;  // this warpgroup's rows of the A tile
    unsigned a[4][4] = {};  // g of the chunk in flight, as fc2's A fragments
    int it = 0, tp = 0;
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, tp ^= 1) {
      const int m0 = tile * kMlpBM;
      mbar_wait(a_full, tp);
      ln_tile_rows(a_tile, kMlpBM, cw * 64 + 16 * warp, p.M - m0 - cw * 64 - 16 * warp, p.C,
                   p.ln_g, p.ln_b, p.ln_stats_on, lane);
      fence_proxy_async();  // the rows, to the tensor cores
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");  // this warpgroup's rows

      float acc2[kNq][32];
#pragma unroll
      for (int q = 0; q < kNq; ++q)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc2[q][i] = 0.f;
#pragma unroll
      for (int q = 0; q < kNq; ++q) fence_acc(acc2[q]);
      for (int j = 0; j < chunks; ++j, ++it) {
        const int s = it % kStages;
        const unsigned ph = (it / kStages) & 1;
        // acc1 = h W1[:, chunk]
        float acc1[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) acc1[i] = 0.f;
        fence_acc(acc1);
        mbar_wait(full1 + 8 * s, ph);
        wgmma_fence();
        const unsigned b1s = smem_u32(w1s + s * S::kStage);
        for (int kk = 0; kk < p.C / 16; ++kk)
          wgmma_ss_m64n64k16(acc1, smem_desc(a0 + (kk >> 2) * (kMlpBM * 128) + (kk & 3) * 32, 16,
                                             1024),
                             smem_desc(b1s + kk * 2048, kPanel, 1024));
        wgmma_commit();
        wgmma_wait<0>();  // this chunk's fc1 and the previous chunk's fc2 are done
        fence_acc(acc1);
#pragma unroll
        for (int q = 0; q < kNq; ++q) fence_acc(acc2[q]);
        fence_frags(a);
        if (lane == 0) {
          mbar_arrive(empty1 + 8 * s);
          if (j > 0) mbar_arrive(empty2 + 8 * ((it - 1) % kStages));
          if (j + 1 == chunks) mbar_arrive(a_empty);  // the last fc1 read the A tile
        }
        // + b1, GELU, bf16: row l/4 (+8), columns 8jj + 2t, +1 of the chunk
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int col = kMlpHC * j + 8 * jj + 2 * t;
          float2 bb = make_float2(0.f, 0.f);
          if (col < p.hidden)
            bb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p.b1 + col));
          float v[4] = {acc1[4 * jj] + bb.x, acc1[4 * jj + 1] + bb.y, acc1[4 * jj + 2] + bb.x,
                        acc1[4 * jj + 3] + bb.y};
          if (p.gelu_on) {
#pragma unroll
            for (int e = 0; e < 4; ++e) v[e] = gelu_erf(v[e]);
          }
          // k16 step jj / 2: columns 2t (jj even) or 2t + 8 (jj odd), rows g and g + 8
          a[jj >> 1][2 * (jj & 1)] = pack_bf16x2(v[0], v[1]);
          a[jj >> 1][2 * (jj & 1) + 1] = pack_bf16x2(v[2], v[3]);
        }
        // acc2 += g W2[chunk, :]
        mbar_wait(full2 + 8 * s, ph);
        wgmma_fence();
        const unsigned b2s = smem_u32(w2s + s * S::kStage);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int q = 0; q < kNq; ++q)
            wgmma_rs_m64n64k16<1>(acc2[q], a[kk], smem_desc(b2s + q * kPanel + kk * 2048, kPanel,
                                                         1024));
        wgmma_commit();
      }
      wgmma_wait<0>();
#pragma unroll
      for (int q = 0; q < kNq; ++q) fence_acc(acc2[q]);
      fence_frags(a);
      if (lane == 0) mbar_arrive(empty2 + 8 * ((it - 1) % kStages));

      // the epilogue: this warp's 16 rows, 8 at a time, 64 columns at a time,
      // every load of b2 and of an 8-row half's residual in flight together
      const int mw = m0 + cw * 64 + 16 * warp;
      uint4 bv[kNq];
#pragma unroll
      for (int q = 0; q < kNq; ++q) {
        const int n = 64 * q + (lane & 7) * 8;
        bv[q] = n < p.C ? ldg8(p.b2 + n) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint4 rv[kNq][2];
#pragma unroll
        for (int q = 0; q < kNq; ++q)
#pragma unroll
          for (int i = 0; i < 2; ++i) {  // row 4i + l/8 of the half, columns 8(l%8)..+7
            const int m = mw + 8 * h + 4 * i + (lane >> 3), n = 64 * q + (lane & 7) * 8;
            rv[q][i] = m < p.M && n < p.C ? ldg8(p.x + (size_t)m * p.C + n)
                                          : make_uint4(0, 0, 0, 0);
          }
#pragma unroll
        for (int q = 0; q < kNq; ++q) {
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
            *reinterpret_cast<float2*>(stg + (lane >> 2) * kEPitch + 8 * jj + 2 * t) =
                make_float2(acc2[q][4 * jj + 2 * h], acc2[q][4 * jj + 2 * h + 1]);
          __syncwarp();
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int r = 4 * i + (lane >> 3), c8 = (lane & 7) * 8;
            const int m = mw + 8 * h + r, n = 64 * q + c8;
            if (m >= p.M || n >= p.C) continue;
            float f[8], res[8], bias[8];
            *reinterpret_cast<float4*>(f) =
                *reinterpret_cast<const float4*>(stg + r * kEPitch + c8);
            *reinterpret_cast<float4*>(f + 4) =
                *reinterpret_cast<const float4*>(stg + r * kEPitch + c8 + 4);
            unpack8(bv[q], bias);
#pragma unroll
            for (int e = 0; e < 8; ++e) f[e] += bias[e];
            unpack8(pack8(f), f);  // the branch rounded to T first, as the serving kernels do
            unpack8(rv[q][i], res);
#pragma unroll
            for (int e = 0; e < 8; ++e) f[e] += res[e];
            *reinterpret_cast<uint4*>(p.y + (size_t)m * p.C + n) = pack8(f);
          }
          __syncwarp();
        }
      }
    }
  }
}

template <int NC>
int launch_mlp(const MlpArgs& p, const void* w1, const void* w2, cudaStream_t stream) {
  using S = MlpSmem<NC>;
  static SmemAttr attr;  // once per device
  if (const int err = attr.raise(mlp_rows_kernel<NC>, S::kBytes)) return err;
  // W1 (C, hidden): boxes of 64 hidden columns x C rows; W2 (hidden, C): 64 x 64
  // x (M, C): boxes of 64 columns x 128 rows, the A tile's panels
  CUtensorMap x_tmap, w1_tmap, w2_tmap;
  int err = tensor_map(&x_tmap, p.x, p.M, p.C, kMlpBM);
  if (err == 0) err = tensor_map(&w1_tmap, w1, p.C, p.hidden, p.C);
  if (err == 0) err = tensor_map(&w2_tmap, w2, p.hidden, p.C, 64);
  if (err != 0) return err;
  mlp_rows_kernel<NC><<<std::min(p.tiles, sm_count()), kMlpThreads, S::kBytes, stream>>>(
      x_tmap, w1_tmap, w2_tmap, p);
  return (int)cudaGetLastError();
}

}  // namespace mumpy

extern "C" int mumpy_mlp_rows(const void* x, const void* ln_g, const void* ln_b, const void* w1,
                              const void* b1, const void* w2, const void* b2, void* y, int M,
                              int C, int hidden, int ln_stats_on, int gelu_on, void* stream) {
  using namespace mumpy;
  if (M <= 0 || C < 16 || C > 256 || C % 16 || hidden <= 0 || hidden % 8 || !aligned16(x) ||
      !aligned16(ln_g) || !aligned16(ln_b) || !aligned16(w1) || !aligned16(b1) ||
      !aligned16(w2) || !aligned16(b2) || !aligned16(y) || x == y)
    return (int)cudaErrorInvalidValue;
  const MlpArgs p{static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(ln_g),
                  static_cast<const __nv_bfloat16*>(ln_b), static_cast<const __nv_bfloat16*>(b1),
                  static_cast<const __nv_bfloat16*>(b2), static_cast<__nv_bfloat16*>(y), M, C,
                  hidden, ln_stats_on, gelu_on, (M + kMlpBM - 1) / kMlpBM};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((C + 63) / 64) {
    case 1: return launch_mlp<64>(p, w1, w2, st);
    case 2: return launch_mlp<128>(p, w1, w2, st);
    case 3: return launch_mlp<192>(p, w1, w2, st);
    default: return launch_mlp<256>(p, w1, w2, st);
  }
}
