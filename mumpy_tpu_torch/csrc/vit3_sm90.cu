// #6, one layer of the global temporal ViT over n = 3 time-major tokens, for
// Hopper (sm_90a), bf16, head width 64:
//
//   h = T(LN1(x))                                   (ln_rows, one pass)
//   q, k, v = T(h Wqkv[:, head] + bqkv[head])        (per slab and head, never stored)
//   o_i = T(sum_j softmax_j(q_i . k_j / 8) v_j)       i, j over the three slabs
//   y = T(x + T(o Wproj + bproj))                    (gemm_sm90.cu)
//   out = T(y + T(fc2(gelu(fc1(LN2 y)))))            (mumpy_ln_mlp_fwd: ln_rows, two products)
//
// x, y, out (3, R, C) time-major: slab i holds rows i*R .. i*R + R - 1 (the
// token of time slice i of every (clip, patch) row r).  Wqkv as torch stores
// it, (3C, C): a head's q, k and v columns are 3 x 64 rows of C-value K
// lines (the operands' w_qkv_rows); Wproj (C, C), W1 (C, hidden), W2
// (hidden, C) as the serving operands store them, (in, out).  T is the
// rounding to bf16 the seven-launch route applies at the same points.
//
// Replaces mumpy_tpu/ops/pallas/vit3.py:_vit3_kernel (:77), which holds the
// layer's weights in VMEM and its qkv slabs in VMEM scratch (:216).  The
// seven-launch route (ln_rows, the qkv GEMM, vit3_attention.cu, proj, the
// MLP's three) wrote qkv to device memory (3C bf16 a row, 21.7 MB a layer at
// batch 32) and read it back one warp per (row, head) with 2-byte loads.
// Here mumpy_vit3_qkv_attn (vit3_qkv_attn_kernel) keeps qkv on chip: one
// block per SM walks work tiles of (64 rows r0..r0+63 of each of the three
// slabs) x (one head), heads fastest so the blocks in flight share a row
// block of LN1 x in L2.  Warpgroup 0 is the producer: one thread loads each
// K step (64 columns) of the three slabs' 64 rows of LN1 x and of the head's
// 192 rows of Wqkv by TMA (128-byte swizzle) into a ring of three stages.
// Warpgroups 1-3 are the consumers, one per slab: each runs m64n192k16 on
// wgmma over K = C (q | k | v of the head, 96 f32 registers a thread), adds
// the bias in f32, rounds, and puts its slab's k and v into shared memory.
// After one barrier of the three, each forms its rows' three scores q_i .
// k_j from the accumulator layout (a quad of lanes holds a row's 64 columns,
// 16 each: the dot products are joined by two shuffles), takes the softmax
// over three in f32 (__expf, as the fused attention half), forms o_i =
// sum_j p_ij v_j and stores it in bf16 through a per-warp staging slice with
// 16-byte stores.  Rows past R (the last row block) are computed on the next
// slab's rows (or TMA's zero fill) and never stored.  The layer's products
// are 24 R C^2 + 12 R C hidden flops: it is bound by the tensor cores'
// rate; the qkv product here is a quarter of them.  mumpy_vit3_fwd runs the
// layer's six launches from one host call (widths the fused kernel refuses
// take the qkv GEMM and vit3_attention.cu instead, seven launches).
#include <algorithm>
#include <cmath>

#include "launches.h"
#include "sm90.cuh"

namespace mumpy {

constexpr int kVHd = 64;                        // the head width
constexpr int kVCons = 3;                       // consumer warpgroups: one per slab
constexpr int kVThreads = 128 * (kVCons + 1);
constexpr int kVProdRegs = 24, kVConsRegs = 160;  // setmaxnreg: 128 * (24 + 3 * 160) <= 65536
constexpr int kVStages = 3;
constexpr int kVStageA = kVCons * kPanel;        // the three slabs' 64 rows x 64 K
constexpr int kVStage = kVStageA + 3 * kPanel;   // and the head's 192 rows of Wqkv x 64 K
constexpr int kVKv = 2 * kPanel;                 // a slab's k and v tiles, 64 x 64 each
constexpr int kVStg = 16 * 128;                  // a warp's staging: 16 rows x 64 bf16
constexpr int kVSmem = 1024 + kVStages * kVStage + kVCons * kVKv + kVCons * 4 * kVStg + 256;
static_assert(kVSmem <= 232448, "the ring, the k/v tiles and the staging fit in 227 KB");
static_assert(128 * (kVProdRegs + kVCons * kVConsRegs) <= 65536, "the registers fit");

struct Vit3Args {
  const __nv_bfloat16* b_qkv;
  __nv_bfloat16* o;
  int R, C, H, tiles;
};

// d (64 x 192, f32) += A (64 x 16) B (16 x 192), A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_m64n192k16(float (&d)[96], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
      "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
      "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "%96, %97, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
        "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),
        "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),
        "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(1));
}

// Byte offset of the 4 bytes at row r, columns 2c..2c+1 (c < 32) of a
// 64-row x 64-column bf16 tile of 128-byte rows, its 16-byte chunks
// swizzled by the row (conflict-free for a warp's accumulator layout, where
// lanes 4g..4g+3 hold rows 8k + g)
__device__ __forceinline__ int tile_off(int r, int c) {
  return r * 128 + ((((c >> 2) ^ r) & 7) << 4) + (c & 3) * 4;
}

__global__ void __launch_bounds__(kVThreads, 1)
    vit3_qkv_attn_kernel(const __grid_constant__ CUtensorMap h_tmap,
                         const __grid_constant__ CUtensorMap w_tmap, Vit3Args p) {
  extern __shared__ unsigned char smem_raw[];
  // the swizzle repeats every 1024 bytes: the stages start on such a boundary
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* kv = ring + kVStages * kVStage;  // slab i: k at i * kVKv, v kPanel after
  unsigned char* stg = kv + kVCons * kVKv;
  uint64_t* bars = reinterpret_cast<uint64_t*>(stg + kVCons * 4 * kVStg);
  const unsigned full0 = smem_u32(bars), empty0 = full0 + 8 * kVStages;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int ksteps = p.C / 64;
  if (tid == 0) {
    for (int s = 0; s < kVStages; ++s) {
      mbar_init(full0 + 8 * s, 1);                // the producer's expect_tx
      mbar_init(empty0 + 8 * s, 4 * kVCons);      // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // ---- the producer: one thread ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kVProdRegs));
    if (tid == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        const int r0 = (tile / p.H) * 64, h = tile % p.H;
        for (int ks = 0; ks < ksteps; ++ks, ++it) {
          const int s = it % kVStages;
          mbar_wait(empty0 + 8 * s, ((it / kVStages) & 1) ^ 1);
          const unsigned st = smem_u32(ring + s * kVStage), full = full0 + 8 * s;
          mbar_expect_tx(full, kVStage);
#pragma unroll
          for (int i = 0; i < 3; ++i)  // slab i's rows, then the head's q, k, v rows
            tma_load_2d(st + i * kPanel, &h_tmap, full, 64 * ks, i * p.R + r0);
#pragma unroll
          for (int part = 0; part < 3; ++part)
            tma_load_2d(st + kVStageA + part * kPanel, &w_tmap, full, 64 * ks,
                        part * p.C + kVHd * h);
        }
      }
    }
  } else {  // ---- the consumers: slab cw of each tile ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kVConsRegs));
    const int cw = wg - 1, warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int rw = 16 * warp + g;  // this thread's rows of the tile: rw and rw + 8
    unsigned char* mine = kv + cw * kVKv;
    unsigned char* wstg = stg + (cw * 4 + warp) * kVStg;
    int it = 0;
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const int r0 = (tile / p.H) * 64, h = tile % p.H;
      float d[96];
#pragma unroll
      for (int i = 0; i < 96; ++i) d[i] = 0.f;
      fence_acc(d);
      for (int ks = 0; ks < ksteps; ++ks, ++it) {
        const int s = it % kVStages;
        mbar_wait(full0 + 8 * s, (it / kVStages) & 1);
        const unsigned a0 = smem_u32(ring + s * kVStage) + cw * kPanel;
        const unsigned b0 = smem_u32(ring + s * kVStage + kVStageA);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss_m64n192k16(d, smem_desc(a0 + kk * 32, 16, 1024),
                              smem_desc(b0 + kk * 32, 16, 1024));
        wgmma_commit();
        wgmma_wait<1>();  // the previous step's products are done: release its stage
        fence_acc(d);
        if (ks > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((it - 1) % kVStages));
      }
      wgmma_wait<0>();
      fence_acc(d);
      if (lane == 0) mbar_arrive(empty0 + 8 * ((it - 1) % kVStages));

      // every slab is past the previous tile's reads of the k and v tiles
      asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kVCons) : "memory");
      // + bias, bf16: k and v of rows rw, rw + 8 (columns 8j + 2t and the
      // next) into this slab's tiles; q kept in registers, times 1/8
      const __nv_bfloat16* bq = p.b_qkv + kVHd * h;
      float q[8][4];
#pragma unroll
      for (int j = 0; j < 24; ++j) {
        const int part = j >> 3, col = 8 * (j & 7) + 2 * t;
        const float2 bb =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bq + part * p.C + col));
        if (part == 0) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            q[j & 7][e] = round_to<__nv_bfloat16>(d[4 * j + e] + (e & 1 ? bb.y : bb.x)) * 0.125f;
        } else {
          unsigned char* tl = mine + (part - 1) * kPanel;
          *reinterpret_cast<unsigned*>(tl + tile_off(rw, 4 * (j & 7) + t)) =
              pack_bf16x2(d[4 * j] + bb.x, d[4 * j + 1] + bb.y);
          *reinterpret_cast<unsigned*>(tl + tile_off(rw + 8, 4 * (j & 7) + t)) =
              pack_bf16x2(d[4 * j + 2] + bb.x, d[4 * j + 3] + bb.y);
        }
      }
      asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kVCons) : "memory");  // every k, v written

      // the scores of rows rw (e = 0) and rw + 8 (e = 1) against the three slabs' keys
      float sc[2][3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const unsigned char* kt = kv + i * kVKv;
        float s0 = 0.f, s1 = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 k0 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(kt + tile_off(rw, 4 * j + t)));
          const float2 k1 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(kt + tile_off(rw + 8, 4 * j + t)));
          s0 = fmaf(q[j][0], k0.x, fmaf(q[j][1], k0.y, s0));
          s1 = fmaf(q[j][2], k1.x, fmaf(q[j][3], k1.y, s1));
        }
#pragma unroll
        for (int o = 1; o <= 2; o <<= 1) {
          s0 += __shfl_xor_sync(0xffffffffu, s0, o);
          s1 += __shfl_xor_sync(0xffffffffu, s1, o);
        }
        sc[0][i] = s0;
        sc[1][i] = s1;
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {  // softmax over the three keys, f32
        const float mx = fmaxf(fmaxf(sc[e][0], sc[e][1]), sc[e][2]);
#pragma unroll
        for (int i = 0; i < 3; ++i) sc[e][i] = __expf(sc[e][i] - mx);
        const float inv = 1.f / (sc[e][0] + sc[e][1] + sc[e][2]);
#pragma unroll
        for (int i = 0; i < 3; ++i) sc[e][i] *= inv;
      }
      // o = sum_i p_i v_i, bf16, into the warp's staging slice (rows g, g + 8)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float o0 = 0.f, o1 = 0.f, o2 = 0.f, o3 = 0.f;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const unsigned char* vt = kv + i * kVKv + kPanel;
          const float2 v0 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(vt + tile_off(rw, 4 * j + t)));
          const float2 v1 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(vt + tile_off(rw + 8, 4 * j + t)));
          o0 = fmaf(sc[0][i], v0.x, o0);
          o1 = fmaf(sc[0][i], v0.y, o1);
          o2 = fmaf(sc[1][i], v1.x, o2);
          o3 = fmaf(sc[1][i], v1.y, o3);
        }
        *reinterpret_cast<unsigned*>(wstg + tile_off(g, 4 * j + t)) = pack_bf16x2(o0, o1);
        *reinterpret_cast<unsigned*>(wstg + tile_off(g + 8, 4 * j + t)) = pack_bf16x2(o2, o3);
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // 16 rows of eight 16-byte chunks
        const int e = lane + 32 * i, row = e >> 3, c = e & 7;
        const int r = r0 + 16 * warp + row;
        if (r < p.R)
          *reinterpret_cast<uint4*>(p.o + ((size_t)cw * p.R + r) * p.C + kVHd * h + 8 * c) =
              *reinterpret_cast<const uint4*>(wstg + row * 128 + ((c ^ row) & 7) * 16);
      }
      __syncwarp();
    }
  }
}

}  // namespace mumpy

// may #6's qkv and attention run fused (head width 64, C a multiple of 64)?
static bool vit3_fused(int C, int H) { return H > 0 && C == mumpy::kVHd * H; }

// o (3, R, C) = the n = 3 attention of the head-width-64 heads of h Wqkv +
// bqkv; h (3, R, C) the normalised rows, w_qkv (3C, C) as torch stores it
extern "C" int mumpy_vit3_qkv_attn(const void* h, const void* w_qkv, const void* b_qkv, void* o,
                                   int R, int C, int H, void* stream) {
  using namespace mumpy;
  if (R <= 0 || !vit3_fused(C, H) || 3LL * R * C > 0x7fffffffLL || 3LL * R + 64 > 0x7fffffffLL ||
      !aligned16(h) || !aligned16(w_qkv) || !aligned16(b_qkv) || !aligned16(o) || h == o)
    return (int)cudaErrorInvalidValue;
  static SmemAttr attr;  // once per device
  if (const int err = attr.raise(vit3_qkv_attn_kernel, kVSmem)) return err;
  // h (3R, C) and Wqkv (3C, C): boxes of 64 columns (K) x 64 rows
  CUtensorMap h_tmap, w_tmap;
  int err = tensor_map(&h_tmap, h, 3 * R, C, 64);
  if (err == 0) err = tensor_map(&w_tmap, w_qkv, 3 * C, C, 64);
  if (err != 0) return err;
  const int tiles = ((R + 63) / 64) * H;
  const Vit3Args p{static_cast<const __nv_bfloat16*>(b_qkv), static_cast<__nv_bfloat16*>(o), R,
                   C, H, tiles};
  vit3_qkv_attn_kernel<<<std::min(tiles, sm_count()), kVThreads, kVSmem,
                         static_cast<cudaStream_t>(stream)>>>(h_tmap, w_tmap, p);
  return (int)cudaGetLastError();
}

namespace {

struct Vit3Scratch {
  bf16 *h, *qkv, *o, *y;
  float *mu, *rstd;
  char* mlp;  // mumpy_ln_mlp_fwd's own scratch
};

Vit3Scratch vit3_layout(Arena& a, int R, int C, int hidden, int H) {
  const long long rows = 3LL * R;
  Vit3Scratch s{};
  s.h = a.take<bf16>(rows * C);
  if (!vit3_fused(C, H)) s.qkv = a.take<bf16>(rows * 3 * C);
  s.o = a.take<bf16>(rows * C);
  s.y = a.take<bf16>(rows * C);
  s.mu = a.take<float>(rows);
  s.rstd = a.take<float>(rows);
  s.mlp = a.take<char>(mumpy_ln_mlp_scratch((int)rows, C, hidden));
  return s;
}

}  // namespace

extern "C" long long mumpy_vit3_scratch(int R, int C, int hidden, int H) {
  if (R <= 0 || C <= 0 || hidden <= 0 || H <= 0 || 3LL * R > 0x7fffffffLL) return -1;
  Arena a{nullptr, 0};
  vit3_layout(a, R, C, hidden, H);
  return (long long)a.used + 256;
}

// #6 on x (3, R, C) in one call: w holds the layer's 12 weights in
// launches.h's Weight order, Wqkv as torch stores it (3C, C), the others
// (in, out); out (3, R, C).  Six launches (seven where the fused kernel
// refuses the widths).
extern "C" int mumpy_vit3_fwd(const void* x, const void* const* w, void* out, void* scratch,
                              int R, int C, int hidden, int H, void* stream) {
  if (R <= 0 || C <= 0 || hidden <= 0 || H <= 0 || C % H || C % 8 || hidden % 8 ||
      C / H > 128 || scratch == nullptr || 3LL * R > 0x7fffffffLL || x == out)
    return (int)cudaErrorInvalidValue;
  Arena a{aligned256(scratch), 0};
  const Vit3Scratch s = vit3_layout(a, R, C, hidden, H);
  const int rows = 3 * R, hd = C / H;
  TRY(mumpy_ln_rows(x, w[kLn1G], w[kLn1B], s.h, s.mu, s.rstd, rows, C, 1, kBF16, stream));
  if (vit3_fused(C, H)) {
    TRY(mumpy_vit3_qkv_attn(s.h, w[kWqkv], w[kBqkv], s.o, R, C, H, stream));
  } else {
    TRY(mumpy_gemm_rows(s.h, w[kWqkv], w[kBqkv], nullptr, nullptr, nullptr, s.qkv, nullptr,
                        nullptr, nullptr, nullptr, 0, rows, 3 * C, C, 1, 0, 1, 1, stream));
    TRY(mumpy_vit3_attention(s.qkv, s.o, R, H, hd, 1.f / std::sqrt((float)hd), kBF16, stream));
  }
  TRY(mumpy_gemm_rows(s.o, w[kWproj], w[kBproj], x, nullptr, nullptr, nullptr, s.y, nullptr,
                      nullptr, nullptr, 0, rows, C, C, 0, 0, 1, 1, stream));
  return mumpy_ln_mlp_fwd(s.y, w + kLn2G, out, s.mlp, rows, C, hidden, 1, 1, stream);
}
