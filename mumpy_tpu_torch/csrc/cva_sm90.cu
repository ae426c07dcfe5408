// #5, the deformable cross-view attention core, for Hopper (sm_90a), bf16:
//
//   q_j = T(x1[j % B1] Wq + bq)                       (per head, never stored)
//   s_j = T(sample(x2[j], gy/gx[:, j % B1]))           per group, four taps, zero padding
//   k_j, v_j = T(s_j Wk + bk), T(s_j Wv + bv)          (per head, never stored)
//   o_j = T(T(softmax(q_j k_j^T / sqrt(hd))) v_j)      keys >= N masked, no additive term
//   out[b] = T(sum_t sum_heads o_{b*ratio + t} Wproj[head rows, :])   no proj_out bias
//
// x1 (B1, N, C) query windows, x2 (R = ratio * B1, N, C) partner windows,
// gy / gx (groups, B1, N) f32 absolute pixel coordinates of window j % B1
// (jnp.tile order: partner window j pairs with query window j % B1, while
// the fold sums the ratio CONSECUTIVE windows b * ratio + t), out (B1, N, C).
// Wq and Wk|Wv as torch stores them, (C, C) and (2C, C) (the operands'
// w_q_rows, w_kv_rows: a head's 32 q, k or v columns are 32 K-major rows);
// Wproj (C, C) as the serving operands store it, (in, out).  T rounds to
// bf16.
//
// Replaces mumpy_tpu/ops/pallas/cva.py:_cva_kernel (:79), which keeps q, s,
// k, v and o in VMEM scratch and folds the ratio inside the tile (:173-176).
// The five-launch route (q, the sampler, k|v, the attention core, the folded
// projection) wrote s, k|v and o for every partner window to device memory:
// ~0.56 GB a forward at stage 0, ratio 3, against ~0.1 GB of x1, x2, the
// coordinates and out.  mumpy_cva_rows (cva_rows_kernel), at head width 32
// and C <= 256 (the flagship's stages 0 and 1), moves only those: one block
// per SM walks tiles of kCons output windows (one a consumer warpgroup, M =
// 64 for wgmma; rows N..63 are padding).  Warpgroup 0 is the producer: per
// ratio step t one thread loads, for each consumer's output window b,
// x1[j % B1] and x2[j] (j = b * ratio + t) by TMA into the window's 64-row
// slots of two K-major A tiles (once every consumer's last products of the
// step before read them), and streams each head's 96 rows of Wq|Wk|Wv and 32
// rows of Wproj through two rings (128-byte swizzle, mbarriers).  Each
// consumer samples s from its partner rows in shared memory (eight channels
// a task, the four taps of cva_sample.cu in its order; rows past N zero, so
// the partner's pad rows are never sampled) into registers, and writes it
// over the same slot; then per head: q = x1 Wq_h and k|v = s Wkv_h on
// m64n32 and m64n64 wgmma, and the per-head machinery of attn_sm90.cuh
// (shared with #3's fused attention half): bias and rounding, S = q k^T, the
// softmax with the pad keys masked, o = P v, and acc += o Wproj_h with the
// (64 x C) f32 accumulator held in registers across the heads AND the ratio
// steps, which is the fold (exact by linearity).  Rounding: the five-launch
// route rounded each window's o, summed the ratio windows' rounded rows in
// f32 and rounded the sum before the product; here each head's o is rounded
// and the products summed in f32, rounded once at the store.  The epilogue
// stores out (N rows of C, bf16) through a per-warp slice of the key tile.
// Its products are 8C^2 + 4NC flops a partner token (like #3's attention
// half), so it is bound by the tensor cores' rate and, like #3's, by each
// consumer's per-head chain of dependent products.  sample_on = 0 (the
// bilinear weights ignored: one tap at the floor, weight 1), fold_on = 0
// (only each output window's first partner window) and key_mask_on = 0 (the
// pad keys unmasked) are the planted faults of the checks.
//
// mumpy_cva_fwd runs #5 from one host call: this kernel where it takes the
// widths, else five launches: the q and k|v products on gemm_sm90.cu (the
// weights read as stored), cva_sample.cu, the attention core with the fold
// (window_attention.cu's mumpy_window_attention_fold: o summed over each
// output window's ratio partner windows) and the projection on gemm_sm90.cu.
#include <algorithm>
#include <cmath>

#include "attn_sm90.cuh"
#include "launches.h"

namespace mumpy {

constexpr int kCvEPitch = 64 + 4;  // f32 epilogue staging pitch

// The instance for widths NC (C rounded up to 64): kCons consumer
// warpgroups, one output window each (as many as registers and shared
// memory allow), and its shared memory: the x1 tile and the x2 / s tile
// (each NC / 64 K panels of kBM rows x 128 bytes), two rings of kStages
// stages (a head's Wq, Wk and Wv rows: NC / 64 K panels of 96 rows x 128
// bytes; its Wproj rows: NC / 64 N panels of 32 K rows x 128 bytes), each
// consumer's key and V^T tiles (its epilogue staging after the last head)
// and the barriers.
template <int NC> struct CvaSmem {
  static constexpr int kCons = NC <= 128 ? 3 : NC <= 192 ? 2 : 1, kBM = 64 * kCons;
  static constexpr int kThreads = 128 * (kCons + 1);
  // registers a thread: the producer's and the consumers' (65536 in all)
  static constexpr int kProdRegs = kCons == 3 ? 24 : 40;
  static constexpr int kConsRegs = kCons == 3 ? 160 : kCons == 2 ? 232 : 240;
  static constexpr int kA = NC * 2 * kBM, kStage1 = NC * 192, kStage2 = NC * 64;
  static constexpr int kFixed = 1024 + 2 * kA + kCons * kArScratch + 256;
  static constexpr int kStages = std::min(4, (232448 - kFixed) / (kStage1 + kStage2));
  static constexpr int kBytes = kFixed + kStages * (kStage1 + kStage2);
  static_assert(kStages >= 2, "two stages of each ring fit");
  static_assert(8 * 4 * kCvEPitch * 4 <= kArScratch, "the staging fits the tiles");
  static_assert(128 * (kProdRegs + kCons * kConsRegs) <= 65536, "the registers fit");
};

struct CvaArgs {
  const float *gy, *gx;
  const __nv_bfloat16 *b_q, *b_kv;
  __nv_bfloat16* out;
  int B1, N, C, H, ratio, steps, groups, ws, sample_on, key_mask_on, tiles;
  float scale;
};

// d (64 x 32, f32) += A (64 x 16) B (16 x 32), A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_m64n32k16(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}
// d (64 x 64, f32) += A (64 x 16) B (16 x 64), A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_m64n64k16(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// The sample of the consumer's partner window j (query window qw = j % B1),
// in place in its slot of the s tile (kBM rows to a K panel, 128-byte
// swizzle), which holds x2[j]'s 64 rows as TMA landed them: each thread
// forms its chunks of 8 channels (row i, chunk c8) into registers, then the
// warpgroup writes them over the raw rows.  Rows >= N are written zero.
template <int NC, int kBM>
__device__ __forceinline__ void sample_slot(unsigned char* slot, const CvaArgs& p, int qw,
                                            int tid, int cw) {
  constexpr int kTasks = NC / 16;  // 64 rows x NC / 8 chunks over 128 threads
  const int nch = p.C / 8, gc = p.C / p.groups;
  uint4 val[kTasks];
#pragma unroll
  for (int k = 0; k < kTasks; ++k) {
    const int e = tid + 128 * k, i = e / nch, c8 = e % nch;
    val[k] = make_uint4(0, 0, 0, 0);
    if (i < p.N && e < 64 * nch) {
      const size_t ci = ((size_t)((8 * c8) / gc) * p.B1 + qw) * p.N + i;
      const float cy = p.gy[ci], cx = p.gx[ci];
      const float y0 = floorf(cy), x0 = floorf(cx);
      const float fy = p.sample_on ? cy - y0 : 0.f, fx = p.sample_on ? cx - x0 : 0.f;
      const int iy = (int)y0, ix = (int)x0;
      const unsigned char* panel = slot + (c8 >> 3) * (kBM * 128);
      float acc[8] = {};
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
        const int yy = iy + dy;
        if (yy < 0 || yy >= p.ws) continue;
        const float wy = dy ? fy : 1.f - fy;
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) {
          const int xx = ix + dx;
          if (xx < 0 || xx >= p.ws) continue;
          const float w = wy * (dx ? fx : 1.f - fx);
          const int tap = yy * p.ws + xx;
          float f[8];
          unpack8(*reinterpret_cast<const uint4*>(panel + tap * 128 +
                                                  (((c8 & 7) ^ (tap & 7)) << 4)), f);
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[c] = fmaf(w, f[c], acc[c]);
        }
      }
      val[k] = pack8(acc);
    }
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");  // every tap is read
#pragma unroll
  for (int k = 0; k < kTasks; ++k) {
    const int e = tid + 128 * k, i = e / nch, c8 = e % nch;
    if (e < 64 * nch)
      *reinterpret_cast<uint4*>(slot + (c8 >> 3) * (kBM * 128) + i * 128 +
                                (((c8 & 7) ^ (i & 7)) << 4)) = val[k];
  }
  fence_proxy_async();  // the sample, to the tensor cores
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
}

template <int NC>
__global__ void __launch_bounds__(CvaSmem<NC>::kThreads, 1)
    cva_rows_kernel(const __grid_constant__ CUtensorMap x1_tmap,
                    const __grid_constant__ CUtensorMap x2_tmap,
                    const __grid_constant__ CUtensorMap wq_tmap,
                    const __grid_constant__ CUtensorMap wkv_tmap,
                    const __grid_constant__ CUtensorMap wproj_tmap, CvaArgs p) {
  using S = CvaSmem<NC>;
  constexpr int kStages = S::kStages, kNq = NC / 64, kCons = S::kCons, kBM = S::kBM;
  extern __shared__ unsigned char smem_raw[];
  // the swizzle repeats every 1024 bytes: the tiles and stages start on such a boundary
  unsigned char* x1_tile = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* s_tile = x1_tile + S::kA;
  unsigned char* w1s = s_tile + S::kA;
  unsigned char* w2s = w1s + kStages * S::kStage1;
  unsigned char* scratch = w2s + kStages * S::kStage2;
  uint64_t* bars = reinterpret_cast<uint64_t*>(scratch + kCons * kArScratch);
  const unsigned full1 = smem_u32(bars), empty1 = full1 + 8 * kStages;
  const unsigned full2 = empty1 + 8 * kStages, empty2 = full2 + 8 * kStages;
  const unsigned a_full = empty2 + 8 * kStages, a_empty = a_full + 8;  // the two A tiles

  const int tid = threadIdx.x, wg = tid >> 7;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full1 + 8 * s, 1);  // the producer's expect_tx
      mbar_init(full2 + 8 * s, 1);
      mbar_init(empty1 + 8 * s, 4 * kCons);  // one per consumer warp
      mbar_init(empty2 + 8 * s, 4 * kCons);
    }
    mbar_init(a_full, 1);
    mbar_init(a_empty, 4 * kCons);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // ---- the producer: one thread ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(S::kProdRegs));
    if (tid == 0) {
      int it = 0, sp = 0;
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        const int w0 = kCons * tile, nw = min(kCons, p.B1 - w0);
        for (int t = 0; t < p.steps; ++t, sp ^= 1) {
          // each window's query and partner rows once every consumer's last
          // products of the step before read the slots
          mbar_wait(a_empty, sp ^ 1);
          mbar_expect_tx(a_full, 2 * nw * kNq * kPanel);
          for (int c = 0; c < nw; ++c) {
            const int j = (w0 + c) * p.ratio + t, qw = j % p.B1;
#pragma unroll
            for (int q = 0; q < kNq; ++q) {
              tma_load_2d(smem_u32(x1_tile + q * (kBM * 128) + c * kPanel), &x1_tmap, a_full,
                          64 * q, qw * p.N);
              tma_load_2d(smem_u32(s_tile + q * (kBM * 128) + c * kPanel), &x2_tmap, a_full,
                          64 * q, j * p.N);
            }
          }
          for (int h = 0; h < p.H; ++h, ++it) {
            const int s = it % kStages;
            const unsigned ph = ((it / kStages) & 1) ^ 1;
            // the head's q rows of Wq, then its k and v rows of Wk|Wv, in each K panel
            mbar_wait(empty1 + 8 * s, ph);
            mbar_expect_tx(full1 + 8 * s, S::kStage1);
#pragma unroll
            for (int q = 0; q < kNq; ++q) {
              const unsigned dst = smem_u32(w1s + s * S::kStage1 + q * (96 * 128));
              tma_load_2d(dst, &wq_tmap, full1 + 8 * s, 64 * q, kArHd * h);
              tma_load_2d(dst + kArHd * 128, &wkv_tmap, full1 + 8 * s, 64 * q, kArHd * h);
              tma_load_2d(dst + 2 * kArHd * 128, &wkv_tmap, full1 + 8 * s, 64 * q,
                          p.C + kArHd * h);
            }
            mbar_wait(empty2 + 8 * s, ph);
            mbar_expect_tx(full2 + 8 * s, S::kStage2);
#pragma unroll
            for (int q = 0; q < kNq; ++q)
              tma_load_2d(smem_u32(w2s + s * S::kStage2 + q * (kArHd * 128)), &wproj_tmap,
                          full2 + 8 * s, 64 * q, kArHd * h);
          }
        }
      }
    }
  } else {  // ---- the consumers: one output window of the tile each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(S::kConsRegs));
    const int cw = wg - 1, warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
    unsigned char* keys = scratch + cw * kArScratch;  // the key tile, then V^T
    unsigned char* vt = keys + kArKeys;
    unsigned char* slot = s_tile + cw * kPanel;       // this window's slot of the s tile
    const unsigned x1a = smem_u32(x1_tile) + cw * kPanel, sa = smem_u32(slot);
    const int r0 = 16 * warp + g;  // this thread's rows of the window: r0 and r0 + 8
    float acc[kNq][32];
    unsigned qa[2][4] = {}, oa[2][4] = {};  // q and o of the head in flight, as A fragments
    int it = 0, sp = 0;
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const int b = kCons * tile + cw;
      if (b >= p.B1) {  // no window: keep the barriers in step
        for (int t = 0; t < p.steps; ++t, sp ^= 1) {
          mbar_wait(a_full, sp);
          for (int h = 0; h < p.H; ++h, ++it) {
            const int s = it % kStages;
            const unsigned ph = (it / kStages) & 1;
            mbar_wait(full1 + 8 * s, ph);
            if (lane == 0) {
              mbar_arrive(empty1 + 8 * s);
              if (h + 1 == p.H) mbar_arrive(a_empty);
            }
            mbar_wait(full2 + 8 * s, ph);
            if (lane == 0) mbar_arrive(empty2 + 8 * s);
          }
        }
        continue;
      }
#pragma unroll
      for (int q = 0; q < kNq; ++q)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[q][i] = 0.f;
#pragma unroll
      for (int q = 0; q < kNq; ++q) fence_acc(acc[q]);
      for (int t = 0; t < p.steps; ++t, sp ^= 1) {
        const int qw = (b * p.ratio + t) % p.B1;
        mbar_wait(a_full, sp);
        sample_slot<NC, kBM>(slot, p, qw, tid & 127, cw);
        for (int h = 0; h < p.H; ++h, ++it) {
          const int s = it % kStages;
          const unsigned ph = (it / kStages) & 1;
          // q = x1 Wq[:, head] and k | v = s Wkv[:, head]: the m64n96 layout
          float qkv[48];
#pragma unroll
          for (int i = 0; i < 48; ++i) qkv[i] = 0.f;
          fence_acc(qkv);
          mbar_wait(full1 + 8 * s, ph);
          wgmma_fence();
          const unsigned b1s = smem_u32(w1s + s * S::kStage1);
          for (int kk = 0; kk < p.C / 16; ++kk) {
            const int pa = (kk >> 2) * (kBM * 128) + (kk & 3) * 32;
            const int pb = (kk >> 2) * (96 * 128) + (kk & 3) * 32;
            wgmma_ss_m64n32k16(qkv, smem_desc(x1a + pa, 16, 1024), smem_desc(b1s + pb, 16, 1024));
            wgmma_ss_m64n64k16(qkv + 16, smem_desc(sa + pa, 16, 1024),
                               smem_desc(b1s + pb + kArHd * 128, 16, 1024));
          }
          wgmma_commit();
          wgmma_wait<0>();  // this head's q, k, v and the previous head's proj are done
          fence_acc(qkv);
#pragma unroll
          for (int q = 0; q < kNq; ++q) fence_acc(acc[q]);
          fence_frags(oa);
          if (lane == 0) {
            mbar_arrive(empty1 + 8 * s);
            if (h > 0) mbar_arrive(empty2 + 8 * ((it - 1) % kStages));
            if (h + 1 == p.H) mbar_arrive(a_empty);  // the step's last products read the slots
          }
          // every warp is past the previous head's products on the key and V^T tiles
          asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
          qkv_to_tiles(qkv, p.b_q + kArHd * h, p.b_kv + kArHd * h, p.b_kv + p.C + kArHd * h,
                       qa, keys, vt, r0, t4);
          fence_proxy_async();  // the key and V^T tiles, to the tensor cores
          asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");

          // S = q k^T (no additive term), P, o = P v
          head_attention(qa, keys, vt, oa, [&](float (&sc)[32]) {
            scale_mask_tile(sc, p.scale, p.N, p.key_mask_on, r0, t4,
                            [](int, int, int, int) { return 0.f; });
            softmax_tile(sc, p.N, r0);
          });

          // acc += o Wproj[head rows, :], left running under the next head's products
          mbar_wait(full2 + 8 * s, ph);
          wgmma_fence();
          const unsigned b2s = smem_u32(w2s + s * S::kStage2);
#pragma unroll
          for (int kk = 0; kk < 2; ++kk)
#pragma unroll
            for (int q = 0; q < kNq; ++q)
              wgmma_rs_m64n64k16<1>(acc[q], oa[kk],
                                    smem_desc(b2s + q * (kArHd * 128) + kk * 2048, kArHd * 128,
                                              1024));
          wgmma_commit();
        }
        // the step's last projection is done before the next step samples
        wgmma_wait<0>();
#pragma unroll
        for (int q = 0; q < kNq; ++q) fence_acc(acc[q]);
        fence_frags(oa);
        if (lane == 0) mbar_arrive(empty2 + 8 * ((it - 1) % kStages));
      }
      // every warp is past its products on the key tile, which stages the epilogue
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");

      // the epilogue: this warp's 16 rows, 8 at a time, 64 columns at a time
      float* stg = reinterpret_cast<float*>(keys) + warp * 8 * kCvEPitch;
      const size_t row0 = (size_t)b * p.N;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
        for (int q = 0; q < kNq; ++q) {
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
            *reinterpret_cast<float2*>(stg + g * kCvEPitch + 8 * jj + 2 * t4) =
                make_float2(acc[q][4 * jj + 2 * hh], acc[q][4 * jj + 2 * hh + 1]);
          __syncwarp();
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int r = 4 * i + (lane >> 3), c8 = (lane & 7) * 8;
            const int tok = 16 * warp + 8 * hh + r, n = 64 * q + c8;
            if (tok < p.N && n < p.C) {
              float f[8];
              *reinterpret_cast<float4*>(f) =
                  *reinterpret_cast<const float4*>(stg + r * kCvEPitch + c8);
              *reinterpret_cast<float4*>(f + 4) =
                  *reinterpret_cast<const float4*>(stg + r * kCvEPitch + c8 + 4);
              *reinterpret_cast<uint4*>(p.out + (row0 + tok) * p.C + n) = pack8(f);
            }
          }
          __syncwarp();
        }
      }
    }
  }
}

template <int NC>
int launch_cva(CvaArgs p, const void* x1, const void* x2, const void* w_q, const void* w_kv,
               const void* w_proj, int R, cudaStream_t stream) {
  using S = CvaSmem<NC>;
  p.tiles = (p.B1 + S::kCons - 1) / S::kCons;
  static SmemAttr attr;  // once per device
  if (const int err = attr.raise(cva_rows_kernel<NC>, S::kBytes)) return err;
  // x1 (B1 N, C) and x2 (R N, C): boxes of 64 columns x 64 rows, a window's
  // slot; Wq (C, C) and Wk|Wv (2C, C): 64 x 32, a head's q, k or v rows;
  // Wproj (C, C): 64 columns x 32 rows
  CUtensorMap x1_tmap, x2_tmap, wq_tmap, wkv_tmap, wproj_tmap;
  int err = tensor_map(&x1_tmap, x1, p.B1 * p.N, p.C, 64);
  if (err == 0) err = tensor_map(&x2_tmap, x2, R * p.N, p.C, 64);
  if (err == 0) err = tensor_map(&wq_tmap, w_q, p.C, p.C, kArHd);
  if (err == 0) err = tensor_map(&wkv_tmap, w_kv, 2 * p.C, p.C, kArHd);
  if (err == 0) err = tensor_map(&wproj_tmap, w_proj, p.C, p.C, kArHd);
  if (err != 0) return err;
  cva_rows_kernel<NC><<<std::min(p.tiles, sm_count()), S::kThreads, S::kBytes, stream>>>(
      x1_tmap, x2_tmap, wq_tmap, wkv_tmap, wproj_tmap, p);
  return (int)cudaGetLastError();
}

}  // namespace mumpy

// may #5 run on the fused kernel (head width 32, C <= 256, windows of ws x ws
// <= 64 tokens, groups of whole 8-channel chunks)?
static bool cva_fused(int N, int C, int H, int groups, int ws) {
  return H > 0 && C == mumpy::kArHd * H && C <= 256 && N <= 64 && N == ws * ws && groups > 0 &&
         C % groups == 0 && (C / groups) % 8 == 0;
}

extern "C" int mumpy_cva_rows(const void* x1, const void* x2, const void* gy, const void* gx,
                              const void* w_q, const void* b_q, const void* w_kv,
                              const void* b_kv, const void* w_proj, void* out, int B1, int R,
                              int N, int C, int H, int groups, int ws, int sample_on,
                              int fold_on, int key_mask_on, void* stream) {
  using namespace mumpy;
  if (B1 <= 0 || R <= 0 || R % B1 || !cva_fused(N, C, H, groups, ws) ||
      (long long)R * N > 0x7fffffff || !aligned16(x1) || !aligned16(x2) || !aligned16(w_q) ||
      !aligned16(b_q) || !aligned16(w_kv) || !aligned16(b_kv) || !aligned16(w_proj) ||
      !aligned16(out) || gy == nullptr || gx == nullptr || out == x1 || out == x2)
    return (int)cudaErrorInvalidValue;
  const int ratio = R / B1;
  const CvaArgs p{static_cast<const float*>(gy), static_cast<const float*>(gx),
                  static_cast<const __nv_bfloat16*>(b_q), static_cast<const __nv_bfloat16*>(b_kv),
                  static_cast<__nv_bfloat16*>(out), B1, N, C, H, ratio, fold_on ? ratio : 1,
                  groups, ws, sample_on, key_mask_on, 0, 1.f / sqrtf((float)kArHd)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((C + 63) / 64) {
    case 1: return launch_cva<64>(p, x1, x2, w_q, w_kv, w_proj, R, st);
    case 2: return launch_cva<128>(p, x1, x2, w_q, w_kv, w_proj, R, st);
    case 3: return launch_cva<192>(p, x1, x2, w_q, w_kv, w_proj, R, st);
    default: return launch_cva<256>(p, x1, x2, w_q, w_kv, w_proj, R, st);
  }
}

namespace {

struct CvaScratch {
  bf16 *q, *s, *kv, *o;
};

CvaScratch cva_layout(Arena& a, int B1, int R, int N, int C, int H, int groups, int ws) {
  CvaScratch r{};
  if (cva_fused(N, C, H, groups, ws)) return r;
  r.q = a.take<bf16>((long long)B1 * N * C);
  r.s = a.take<bf16>((long long)R * N * C);
  r.kv = a.take<bf16>((long long)R * N * 2 * C);
  r.o = a.take<bf16>((long long)B1 * N * C);
  return r;
}

}  // namespace

// #5's scratch: none on the fused route
extern "C" long long mumpy_cva_scratch(int B1, int R, int N, int C, int H, int groups, int ws) {
  if (B1 <= 0 || R <= 0 || N <= 0 || C <= 0 || H <= 0 || groups <= 0 || ws <= 0) return -1;
  Arena a{nullptr, 0};
  cva_layout(a, B1, R, N, C, H, groups, ws);
  return (long long)a.used + 256;
}

// #5 in one call: w holds w_q_rows (C, C), b_q, w_kv_rows (2C, C), b_kv and
// w_proj (C, C) (in, out).  One launch of the fused kernel where it takes the
// widths, else five; sample_on and fold_on plant their faults on both routes,
// key_mask_on on the fused one (the attention core always masks).
extern "C" int mumpy_cva_fwd(const void* x1, const void* x2, const void* gy, const void* gx,
                             const void* const* w, void* out, void* scratch, int B1, int R,
                             int N, int C, int H, int groups, int ws, int sample_on, int fold_on,
                             int key_mask_on, void* stream) {
  if (B1 <= 0 || R <= 0 || R % B1 || N <= 0 || N > 64 || C <= 0 || H <= 0 || C % H ||
      C / H > 32 || C % 8 || groups <= 0 || C % groups || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  if (cva_fused(N, C, H, groups, ws))
    return mumpy_cva_rows(x1, x2, gy, gx, w[0], w[1], w[2], w[3], w[4], out, B1, R, N, C, H,
                          groups, ws, sample_on, fold_on, key_mask_on, stream);
  Arena a{aligned256(scratch), 0};
  const CvaScratch r = cva_layout(a, B1, R, N, C, H, groups, ws);
  const int hd = C / H;
  TRY(mumpy_gemm_rows(x1, w[0], w[1], nullptr, nullptr, nullptr, r.q, nullptr, nullptr, nullptr,
                      nullptr, 0, B1 * N, C, C, 1, 0, 1, 1, stream));
  TRY(mumpy_cva_sample(x2, gy, gx, r.s, R, B1, N, C, groups, ws, sample_on, kBF16, stream));
  TRY(mumpy_gemm_rows(r.s, w[2], w[3], nullptr, nullptr, nullptr, r.kv, nullptr, nullptr,
                      nullptr, nullptr, 0, R * N, 2 * C, C, 1, 0, 1, 1, stream));
  TRY(mumpy_window_attention_fold(r.q, r.kv, r.kv + C, r.o, R, N, H, hd, B1, C, 2 * C, 2 * C, C,
                                  R / B1, fold_on, 1.f / std::sqrt((float)hd), kBF16, stream));
  return mumpy_gemm_rows(r.o, w[4], nullptr, nullptr, nullptr, nullptr, out, nullptr, nullptr,
                         nullptr, nullptr, 0, B1 * N, C, C, 0, 0, 1, 1, stream);
}
