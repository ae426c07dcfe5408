// The attention half of a cross-view Swin block at C <= 256, fused for
// Hopper (sm_90a), bf16, head width 32:
//
//   h = T(LN(x))                                   (f32 statistics, eps 1e-5)
//   q, k, v = T(h Wqkv[:, head] + bqkv[head])       (per head, never stored)
//   P = T(softmax(q k^T / sqrt(32) + mb[r % P, head]))   (keys >= N masked)
//   o = T(P v)
//   y = T(sum_heads o Wproj[head, :] + bproj),  out = T(x + y)
//
// x, y, out (R windows x N tokens, C) row-major; Wqkv as torch stores it,
// (3C, C): a head's q, k and v columns are 96 rows of 128-byte K lines;
// Wproj (C, C) as the serving operands store it, (in, out); mb (P, H, N, N)
// in f32 or bf16 through its element strides.  T is the rounding to bf16 the
// four-launch route applies at the same points.  ln_stats_on = 0 takes mean 0
// and rstd 1, key_mask_on = 0 leaves the pad keys N..63 unmasked: the planted
// faults of the checks (the pad rows hold the next window's first rows).
//
// Replaces mumpy_tpu/ops/pallas/attn_ln.py:_attn_kernel (:51), which keeps
// qkv and the head outputs in VMEM scratch; the four-launch route
// (ln_rows, the qkv GEMM, window_attention.cu, the proj GEMM) writes qkv (3C
// a token) and o (C) to device memory and reads them back, and at C <= 256
// its products have K of 1.5-4 steps of 64, so each launch is set by its
// epilogue (PERF.md, Findings).  The whole half moves only x in and y, out
// out (6C bytes a token); its products (8C^2 + 4NC flops a token) then bound
// it at the tensor cores' rate from C = 192 up.  Here nothing but x, y and
// out leaves the SM.  One block per SM walks tiles of two or three windows
// (persistent).  Warpgroup 0 is the producer: one thread loads 64 rows of x
// from each window's first by TMA into the window's 64-row slot of the
// K-major A tile (its N rows and the next window's first, zero past the last
// row; once every consumer's last qkv product of the previous tile read it)
// and streams each head's 96 rows of Wqkv and 32 rows of Wproj by TMA
// through two rings (128-byte swizzle, completion on mbarriers); all the
// weights, 4C^2 bf16, are read once a tile, from L2.  The other warpgroups
// are the consumers, one window each (M = 64 for wgmma; rows N..63 are
// padding, masked as keys and never stored).  Each normalises its 64 rows in
// place once a tile (no ln_rows pass); then per head: q|k|v = h Wqkv[head]
// on one m64n96 wgmma (A and B in shared memory), + bqkv and rounded in
// registers: q into A fragments, k into a K-major key tile and v transposed
// into a K-major V^T tile of the warpgroup's own shared memory; S = q k^T
// on wgmma with q from registers; + mb and the softmax in f32 registers; P
// as bf16 A fragments into o = P v; o as bf16 A fragments into
// acc += o Wproj[head rows, :], the (64 x C) f32 acc held in registers across
// the heads (issued without a wait, so it runs under the next head's qkv
// product).  The epilogue adds bproj, re-reads the residual x (the A tile
// holds LN x) and stores y and out, 8 rows at a time through a per-warp
// staging slice of the key tile (16-byte stores).  A window count that is
// not a whole number of tiles leaves the last tile's last consumers without
// a window: they only keep the rings' barriers in step.  The per-head steps
// (bias and rounding into the key and V^T tiles, scores, softmax, P v) are
// attn_sm90.cuh's, shared with the fused CVA core (cva_sm90.cu).
#include <algorithm>

#include "attn_sm90.cuh"
#include "window_attention_mma.cuh"

namespace mumpy {

constexpr int kArEPitch = 64 + 4;             // f32 epilogue staging pitch

// The instance for widths NC (C rounded up to 64): kCons consumer
// warpgroups, one window each (three where their registers allow, C <= 128:
// the consumers wait on each product in turn, so more of them keep the
// tensor cores and the SM's other units busy), and its shared memory: the A
// tile ((NC / 64) K panels of kBM rows x 128 bytes), two rings of kStages
// stages (a head's Wqkv rows: NC / 64 K panels of 96 rows x 128 bytes; its
// Wproj rows: NC / 64 N panels of 32 K rows x 128 bytes), each consumer's key
// and V^T tiles (its epilogue staging after the last head), the barriers and,
// at C <= 128, room for a period-1 mask+bias of every head at N <= 49 in f32
// (staged once, for every tile: read from global, each element's index
// arithmetic cost more than its product; PERF.md, Findings).
template <int NC> struct AttnSmem {
  static constexpr int kCons = NC <= 128 ? 3 : 2, kBM = 64 * kCons;
  static constexpr int kThreads = 128 * (kCons + 1);
  // registers a thread: the producer's and the consumers' (65536 in all)
  static constexpr int kProdRegs = kCons == 3 ? 24 : 40, kConsRegs = kCons == 3 ? 160 : 232;
  static constexpr int kA = NC * 2 * kBM, kStage1 = NC * 192, kStage2 = NC * 64;
  static constexpr int kMask =
      NC <= 128 ? ((NC / 32) * 49 * 49 * 4 + 256 + 1023) / 1024 * 1024 : 0;  // + read slack
  static constexpr int kFixed = 1024 + kA + kCons * kArScratch + 256 + kMask;
  static constexpr int kStages = std::min(4, (232448 - kFixed) / (kStage1 + kStage2));
  static constexpr int kBytes = kFixed + kStages * (kStage1 + kStage2);
  static_assert(kStages >= 2, "two stages of each ring fit");
  static_assert(8 * 4 * kArEPitch * 4 <= kArScratch, "the staging fits the tiles");
  static_assert(128 * (kProdRegs + kCons * kConsRegs) <= 65536, "the registers fit");
};

struct AttnArgs {
  const __nv_bfloat16 *x, *ln_g, *ln_b, *b_qkv, *b_proj;
  __nv_bfloat16 *y, *out;
  MaskBias mb;
  int R, N, C, H, P, ln_stats_on, key_mask_on, tiles, mask_smem;
  float scale;
};

template <int NC>
__global__ void __launch_bounds__(AttnSmem<NC>::kThreads, 1)
    attn_rows_kernel(const __grid_constant__ CUtensorMap x_tmap,
                     const __grid_constant__ CUtensorMap wqkv_tmap,
                     const __grid_constant__ CUtensorMap wproj_tmap, AttnArgs p) {
  using S = AttnSmem<NC>;
  constexpr int kStages = S::kStages, kNq = NC / 64, kCons = S::kCons, kBM = S::kBM;
  extern __shared__ unsigned char smem_raw[];
  // the swizzle repeats every 1024 bytes: the tiles and stages start on such a boundary
  unsigned char* a_tile = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* w1s = a_tile + S::kA;
  unsigned char* w2s = w1s + kStages * S::kStage1;
  unsigned char* scratch = w2s + kStages * S::kStage2;
  uint64_t* bars = reinterpret_cast<uint64_t*>(scratch + kCons * kArScratch);
  const unsigned full1 = smem_u32(bars), empty1 = full1 + 8 * kStages;
  const unsigned full2 = empty1 + 8 * kStages, empty2 = full2 + 8 * kStages;
  const unsigned a_full = empty2 + 8 * kStages, a_empty = a_full + 8;  // the A tile

  const int tid = threadIdx.x, wg = tid >> 7;
  // the period-1 mask+bias, staged once for every tile (the host checked that it fits)
  float* ms = p.mask_smem ? reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(bars) + 256)
                          : nullptr;
  if (ms != nullptr)
    for (int i = tid; i < p.H * p.N * p.N; i += S::kThreads)
      ms[i] = p.mb.at(0, i / (p.N * p.N), i / p.N % p.N, i % p.N);
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
      int it = 0, tp = 0;
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, tp ^= 1) {
        const int w0 = kCons * tile, nw = min(kCons, p.R - w0);
        // the windows' raw rows into their slots once both consumers' last qkv is done
        mbar_wait(a_empty, tp ^ 1);
        mbar_expect_tx(a_full, nw * kNq * kPanel);
        for (int c = 0; c < nw; ++c)
#pragma unroll
          for (int q = 0; q < kNq; ++q)
            tma_load_2d(smem_u32(a_tile + q * (kBM * 128) + c * kPanel), &x_tmap, a_full,
                        64 * q, (w0 + c) * p.N);
        for (int h = 0; h < p.H; ++h, ++it) {
          const int s = it % kStages;
          const unsigned ph = ((it / kStages) & 1) ^ 1;
          // the head's q, k and v rows of Wqkv, one after the other in each K panel
          mbar_wait(empty1 + 8 * s, ph);
          mbar_expect_tx(full1 + 8 * s, S::kStage1);
#pragma unroll
          for (int q = 0; q < kNq; ++q)
#pragma unroll
            for (int part = 0; part < 3; ++part)
              tma_load_2d(smem_u32(w1s + s * S::kStage1 + q * (96 * 128) + part * (kArHd * 128)),
                          &wqkv_tmap, full1 + 8 * s, 64 * q, part * p.C + kArHd * h);
          mbar_wait(empty2 + 8 * s, ph);
          mbar_expect_tx(full2 + 8 * s, S::kStage2);
#pragma unroll
          for (int q = 0; q < kNq; ++q)
            tma_load_2d(smem_u32(w2s + s * S::kStage2 + q * (kArHd * 128)), &wproj_tmap,
                        full2 + 8 * s, 64 * q, kArHd * h);
        }
      }
    }
  } else {  // ---- the consumers: one window of the tile each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(S::kConsRegs));
    const int cw = wg - 1, warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, t = lane & 3;
    unsigned char* keys = scratch + cw * kArScratch;  // the key tile, then V^T
    unsigned char* vt = keys + kArKeys;
    const unsigned a0 = smem_u32(a_tile) + cw * kPanel;  // this window's slot of the A tile
    const int r0 = 16 * warp + g;  // this thread's rows of the window: r0 and r0 + 8
    float acc[kNq][32];
    unsigned qa[2][4] = {}, oa[2][4] = {};  // q and o of the head in flight, as A fragments
    int it = 0, tp = 0;
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, tp ^= 1) {
      const int win = kCons * tile + cw;
      mbar_wait(a_full, tp);
      if (win >= p.R) {  // no window: keep the barriers in step
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
        continue;
      }
      const int slot = win % p.P;
      ln_tile_rows(a_tile + cw * kPanel, kBM, 16 * warp, 16, p.C, p.ln_g, p.ln_b,
                   p.ln_stats_on, lane);
      fence_proxy_async();  // the rows, to the tensor cores
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");  // this window's rows

#pragma unroll
      for (int q = 0; q < kNq; ++q)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[q][i] = 0.f;
#pragma unroll
      for (int q = 0; q < kNq; ++q) fence_acc(acc[q]);
      for (int h = 0; h < p.H; ++h, ++it) {
        const int s = it % kStages;
        const unsigned ph = (it / kStages) & 1;
        // q | k | v = h Wqkv[:, head]
        float qkv[48];
#pragma unroll
        for (int i = 0; i < 48; ++i) qkv[i] = 0.f;
        fence_acc(qkv);
        mbar_wait(full1 + 8 * s, ph);
        wgmma_fence();
        const unsigned b1s = smem_u32(w1s + s * S::kStage1);
        for (int kk = 0; kk < p.C / 16; ++kk)
          wgmma_ss_m64n96k16(qkv, smem_desc(a0 + (kk >> 2) * (kBM * 128) + (kk & 3) * 32, 16,
                                            1024),
                             smem_desc(b1s + (kk >> 2) * (96 * 128) + (kk & 3) * 32, 16, 1024));
        wgmma_commit();
        wgmma_wait<0>();  // this head's qkv and the previous head's proj are done
        fence_acc(qkv);
#pragma unroll
        for (int q = 0; q < kNq; ++q) fence_acc(acc[q]);
        fence_frags(oa);
        if (lane == 0) {
          mbar_arrive(empty1 + 8 * s);
          if (h > 0) mbar_arrive(empty2 + 8 * ((it - 1) % kStages));
          if (h + 1 == p.H) mbar_arrive(a_empty);  // the last qkv read the A tile
        }
        // every warp is past the previous head's products on the key and V^T tiles
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
        // + bqkv, bf16: q to A fragments, k to the key tile, v to V^T
        const __nv_bfloat16* bq = p.b_qkv + kArHd * h;
        qkv_to_tiles(qkv, bq, bq + p.C, bq + 2 * p.C, qa, keys, vt, r0, t);
        fence_proxy_async();  // the key and V^T tiles, to the tensor cores
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");

        // S = q k^T + mb, P, o = P v
        head_attention(qa, keys, vt, oa, [&](float (&sc)[32]) {
          if (ms != nullptr) {  // rows r0, r0 + 8 from key 2t: every element at a fixed offset
            const float* m0 = ms + (h * p.N + min(r0, p.N - 1)) * p.N + 2 * t;
            const float* m1 = ms + (h * p.N + min(r0 + 8, p.N - 1)) * p.N + 2 * t;
            scale_mask_tile(sc, p.scale, p.N, p.key_mask_on, r0, t, [&](int j, int e, int, int) {
              return (e < 2 ? m0 : m1)[8 * j + (e & 1)];
            });
          } else {
            scale_mask_tile(sc, p.scale, p.N, p.key_mask_on, r0, t,
                            [&](int, int, int row, int key) { return p.mb.at(slot, h, row, key); });
          }
          softmax_tile(sc, p.N, r0);
        });

        // acc += o Wproj[head rows, :], left running under the next head's qkv
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
      wgmma_wait<0>();
#pragma unroll
      for (int q = 0; q < kNq; ++q) fence_acc(acc[q]);
      fence_frags(oa);
      if (lane == 0) mbar_arrive(empty2 + 8 * ((it - 1) % kStages));
      // every warp is past its products on the key tile, which stages the epilogue
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");

      // the epilogue: this warp's 16 rows, 8 at a time, 64 columns at a time
      float* stg = reinterpret_cast<float*>(keys) + warp * 8 * kArEPitch;
      const size_t row0 = (size_t)win * p.N;
      uint4 bv[kNq];
#pragma unroll
      for (int q = 0; q < kNq; ++q) {
        const int n = 64 * q + (lane & 7) * 8;
        bv[q] = n < p.C ? ldg8(p.b_proj + n) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        uint4 rv[kNq][2];
#pragma unroll
        for (int q = 0; q < kNq; ++q)
#pragma unroll
          for (int i = 0; i < 2; ++i) {  // token 4i + l/8 of the half, columns 8(l%8)..+7
            const int tok = 16 * warp + 8 * hh + 4 * i + (lane >> 3), n = 64 * q + (lane & 7) * 8;
            rv[q][i] = tok < p.N && n < p.C ? ldg8(p.x + (row0 + tok) * p.C + n)
                                            : make_uint4(0, 0, 0, 0);
          }
#pragma unroll
        for (int q = 0; q < kNq; ++q) {
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
            *reinterpret_cast<float2*>(stg + g * kArEPitch + 8 * jj + 2 * t) =
                make_float2(acc[q][4 * jj + 2 * hh], acc[q][4 * jj + 2 * hh + 1]);
          __syncwarp();
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int r = 4 * i + (lane >> 3), c8 = (lane & 7) * 8;
            const int tok = 16 * warp + 8 * hh + r, n = 64 * q + c8;
            if (tok >= p.N || n >= p.C) continue;
            float f[8], res[8], bias[8];
            *reinterpret_cast<float4*>(f) =
                *reinterpret_cast<const float4*>(stg + r * kArEPitch + c8);
            *reinterpret_cast<float4*>(f + 4) =
                *reinterpret_cast<const float4*>(stg + r * kArEPitch + c8 + 4);
            unpack8(bv[q], bias);
#pragma unroll
            for (int e = 0; e < 8; ++e) f[e] += bias[e];
            const uint4 yv = pack8(f);
            const size_t idx = (row0 + tok) * p.C + n;
            *reinterpret_cast<uint4*>(p.y + idx) = yv;
            unpack8(yv, f);  // out = T(x + T(y)), as the projection GEMM's epilogue
            unpack8(rv[q][i], res);
#pragma unroll
            for (int e = 0; e < 8; ++e) f[e] += res[e];
            *reinterpret_cast<uint4*>(p.out + idx) = pack8(f);
          }
          __syncwarp();
        }
      }
    }
  }
}

template <int NC>
int launch_attn(AttnArgs p, const void* w_qkv, const void* w_proj, cudaStream_t stream) {
  using S = AttnSmem<NC>;
  p.tiles = (p.R + S::kCons - 1) / S::kCons;
  p.mask_smem = p.P == 1 && p.H * p.N * p.N * 4 + 256 <= S::kMask;
  static SmemAttr attr;  // once per device
  if (const int err = attr.raise(attn_rows_kernel<NC>, S::kBytes)) return err;
  // x (R N, C): boxes of 64 columns x 64 rows, a window's slot; Wqkv (3C, C):
  // 64 x 32, a head's q, k or v rows; Wproj (C, C): 64 columns x 32 rows
  CUtensorMap x_tmap, wqkv_tmap, wproj_tmap;
  int err = tensor_map(&x_tmap, p.x, p.R * p.N, p.C, 64);
  if (err == 0) err = tensor_map(&wqkv_tmap, w_qkv, 3 * p.C, p.C, kArHd);
  if (err == 0) err = tensor_map(&wproj_tmap, w_proj, p.C, p.C, kArHd);
  if (err != 0) return err;
  attn_rows_kernel<NC><<<std::min(p.tiles, sm_count()), S::kThreads, S::kBytes, stream>>>(
      x_tmap, wqkv_tmap, wproj_tmap, p);
  return (int)cudaGetLastError();
}

}  // namespace mumpy

extern "C" int mumpy_attn_rows(const void* x, const void* ln_g, const void* ln_b,
                               const void* w_qkv, const void* b_qkv, const void* w_proj,
                               const void* b_proj, const void* mb, int mb_dtype, int mb_s0,
                               int mb_s1, int mb_s2, int mb_s3, int P, void* y, void* out, int R,
                               int N, int C, int H, int ln_stats_on, int key_mask_on,
                               void* stream) {
  using namespace mumpy;
  if (R <= 0 || N <= 0 || N > kMaxN || C < kArHd || C > 256 || C != kArHd * H || P <= 0 ||
      R % P || mb == nullptr || (long long)R * N > 0x7fffffff || !aligned16(x) ||
      !aligned16(ln_g) || !aligned16(ln_b) || !aligned16(w_qkv) || !aligned16(b_qkv) ||
      !aligned16(w_proj) || !aligned16(b_proj) || !aligned16(y) || !aligned16(out) || x == y ||
      x == out || y == out)
    return (int)cudaErrorInvalidValue;
  const AttnArgs p{static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(ln_g),
                   static_cast<const __nv_bfloat16*>(ln_b),
                   static_cast<const __nv_bfloat16*>(b_qkv),
                   static_cast<const __nv_bfloat16*>(b_proj), static_cast<__nv_bfloat16*>(y),
                   static_cast<__nv_bfloat16*>(out),
                   MaskBias{mb, mb_dtype == kBF16, {mb_s0, mb_s1, mb_s2, mb_s3}},
                   R, N, C, H, P, ln_stats_on, key_mask_on, 0, 0,
                   1.f / sqrtf((float)kArHd)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((C + 63) / 64) {
    case 1: return launch_attn<64>(p, w_qkv, w_proj, st);
    case 2: return launch_attn<128>(p, w_qkv, w_proj, st);
    case 3: return launch_attn<192>(p, w_qkv, w_proj, st);
    default: return launch_attn<256>(p, w_qkv, w_proj, st);
  }
}
