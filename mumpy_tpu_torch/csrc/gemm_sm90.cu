// bf16 GEMMs for Hopper (sm_90a) on wgmma.mma_async: every bf16 product of
// the port but the CVA ratio fold (gemm.cu).
//
//   mumpy_gemm_rows, the normal form: x (M, K) row-major, B (K, N) row-major
//   or, with b_kmajor, B^T (N, K) row-major (a torch Linear weight as stored):
//     v = x[a(m), :] B + bias
//     v = gelu_erf(v)                           (act 1)
//       = v * gelu_erf'(aux[m, n])              (act 2: the GELU backward; with
//         aux_out, also aux_out[m, n] = T(gelu_erf(aux)), the activation the
//         fc2 weight gradient reads)
//     y[c(m), n]   = T(v)                       (y != null)
//     out[c(m), n] = T(res[c(m), n] + T(v))     (out != null; res required)
//                  = T(res[c(m), n] + s[m / d] * v)   (with a row scale s, f32,
//                    divisor d: the stochastic-depth keep; row_scale_on = 0
//                    ignores s, the planted fault of the checks)
//     a(m) and c(m) are gemm.cu's row maps of period L (map_len): (m / L) * L
//     + map[m % L], m itself without a map.  They gather the shifted Swin
//     block's rows into its qkv product and scatter its projection (and read
//     its residual) back, so the cyclic shift moves no bytes of its own.
//   mumpy_gemm_sm90, the same without the maps (the training kernels' ABI).
//   mumpy_gemm_sm90_tn, A (K, M) and B (K, N) row-major, the sum over the K rows:
//     dW[m, n] = sum_k A[k, m] B[k, n],  db[m] = sum_k A[k, m]
//     (A a layer's output gradient, B its input: dW in torch Linear's (out,
//     in) layout, db the bias gradient.)  The rows are split over grid.z; every
//     split writes f32 partials to its slice of ws, [dW | db], which
//     wgrad.cu's reduce_splits adds in split order, so the result does not
//     depend on the schedule; with one split the kernel writes T directly.
//
// Replaces the matrix products inside the Pallas kernels
// mumpy_tpu/ops/pallas/{swin_block,swin_pair,attn_ln,ln_mlp,vit3,
// ln_mlp_vjp,attn_ln_vjp,swin_block_vjp}.py, which keep whole weight sets in
// VMEM, and the weight-gradient sums the JAX package leaves to XLA.  The
// products run C = 96-1024 (K = C or 4C) over 588 to 112,896 rows; those of
// 6k rows and more are bound by the tensor cores' rate.  The normal form is
// persistent and warp-specialised (below): one block per SM, a producer
// warpgroup (B by TMA; A by TMA, or by cp.async through a row map; both in
// the 128-byte swizzle wgmma reads, completion on mbarriers) and two
// consumer warpgroups of wgmma m64n128k16, with setmaxnreg moving registers
// from the producer to them.  A LayerNorm before a product is one
// row pass of train_rows.cu (ln_rows) that writes the normalised rows once;
// the product gathers them through its map (normalising the landed A tiles
// in shared memory instead cost more: PERF.md, Findings).  Edges (M, N, K and
// the split's rows) are zero-filled by the copies and masked in the
// epilogue.  Each form takes bf16 with N, K (normal form) or M, N (TN form)
// multiples of 8 and 16-byte aligned operands, and refuses others.
#include <algorithm>

#include "sm90.cuh"

namespace mumpy {

// d (64 x 128, f32) += A (64 x 16) B (16 x 128); A K-major (kTransA = 0) or
// M-major (1), B K-major (kTransB = 0) or N-major (1).  Lane l of warp w
// holds rows 16w + l/4 and 16w + l/4 + 8, columns 8j + 2(l%4) and the next,
// in d[4j..4j+3].
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %67, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %66, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "n"(kTransA), "r"(1), "n"(kTransB));
}

// ---- the TN form (the weight gradients): one 64 x 128 tile of dW a block ----
//
// A (K, M) M-major and B (K, N) N-major, 64 K rows a step through a ring of
// four stages that every thread fills with 16-byte cp.async copies two steps
// ahead of the products; one consumer warpgroup, two blocks to an SM.
constexpr int kTnBM = 64, kTnBN = 128, kTnBK = 64, kTnStages = 4;
constexpr int kTnStageA = kTnBM * 128, kTnStage = kTnStageA + kTnBK * kTnBN * 2;
constexpr int kStgPitch = kTnBN + 4;  // f32 epilogue staging pitch

struct TnArgs {
  const __nv_bfloat16* a; const __nv_bfloat16* b;
  float* ws; __nv_bfloat16* dw; __nv_bfloat16* db;
  int M, N, K, rows_per_split;
};

// One k-step of 64 rows into stage memory sa (A) / sb (B): M-major A and
// N-major B in panels of 64 columns, 16-byte chunk c of row r of a panel at
// r * 128 + ((c ^ (r % 8)) * 16), the 128-byte swizzle.
__device__ __forceinline__ void load_tn_stage(const TnArgs& p, unsigned char* sa,
                                              unsigned char* sb, int m0, int n0, int k0,
                                              int k_end) {
  const int tid = threadIdx.x;
  for (int e = tid; e < kTnBK * (kTnBM / 8); e += 128) {
    const int r = e / (kTnBM / 8), cc = e % (kTnBM / 8), c = cc & 7;
    const int k = k0 + r, m = m0 + cc * 8;
    const bool ok = k < k_end && m < p.M;
    cp_async16(sa + (cc >> 3) * kPanel + r * 128 + ((c ^ (r & 7)) << 4),
               p.a + (ok ? (size_t)k * p.M + m : 0), ok);
  }
  for (int e = tid; e < kTnBK * (kTnBN / 8); e += 128) {
    const int r = e >> 4, cc = e & 15, c = cc & 7;
    const int k = k0 + r, n = n0 + cc * 8;
    const bool ok = k < k_end && n < p.N;
    cp_async16(sb + (cc >> 3) * kPanel + r * 128 + ((c ^ (r & 7)) << 4),
               p.b + (ok ? (size_t)k * p.N + n : 0), ok);
  }
}

__global__ void __launch_bounds__(128, 1) gemm_tn_kernel(TnArgs p) {
  extern __shared__ unsigned char smem_raw[];
  // the swizzle repeats every 1024 bytes: stages start on such a boundary
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kTnBM, n0 = blockIdx.x * kTnBN;
  const int k_begin = blockIdx.z * p.rows_per_split;
  const int k_end = min(p.K, k_begin + p.rows_per_split);
  const int steps = (k_end - k_begin + kTnBK - 1) / kTnBK;
  const bool sums = blockIdx.x == 0 && tid < kTnBM;  // db: the first column of tiles
  float csum = 0.f;

  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  fence_acc(d);

  for (int s = 0; s < kTnStages - 2; ++s) {
    if (s < steps)
      load_tn_stage(p, smem + s * kTnStage, smem + s * kTnStage + kTnStageA, m0, n0,
                    k_begin + s * kTnBK, k_end);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kTnStages - 3>();  // this thread's copies of this step have landed
    fence_proxy_async();             // ... and are visible to the tensor cores
    __syncthreads();  // everyone's have; the products of step - 2 are done with its stage
    const int next = step + kTnStages - 2;
    if (next < steps)
      load_tn_stage(p, smem + (next % kTnStages) * kTnStage,
                    smem + (next % kTnStages) * kTnStage + kTnStageA, m0, n0,
                    k_begin + next * kTnBK, k_end);
    cp_async_commit();
    unsigned char* sa = smem + (step % kTnStages) * kTnStage;
    const unsigned a0 = smem_u32(sa), b0 = smem_u32(sa + kTnStageA);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTnBK / 16; ++kk)
      wgmma_m64n128k16<1, 1>(d, smem_desc(a0 + kk * 2048, kPanel, 1024),
                             smem_desc(b0 + kk * 2048, kPanel, 1024));
    wgmma_commit();
    if (sums) {  // column tid of this step's A rows, read while the products run
      const unsigned char* col = sa + (tid >> 6) * kPanel + (tid & 7) * 2;
      const int c = (tid & 63) >> 3;
#pragma unroll 8
      for (int r = 0; r < kTnBK; ++r)
        csum += __bfloat162float(
            *reinterpret_cast<const __nv_bfloat16*>(col + r * 128 + ((c ^ (r & 7)) << 4)));
    }
    wgmma_wait<1>();
    fence_acc(d);
  }
  wgmma_wait<0>();
  fence_acc(d);
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: stage the accumulators through it

  float* stg = reinterpret_cast<float*>(smem);
  {
    const int lane = tid & 31, row = (tid >> 5) * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < kTnBN / 8; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
      *reinterpret_cast<float2*>(stg + row * kStgPitch + col) = make_float2(d[4 * j], d[4 * j + 1]);
      *reinterpret_cast<float2*>(stg + (row + 8) * kStgPitch + col) =
          make_float2(d[4 * j + 2], d[4 * j + 3]);
    }
  }
  __syncthreads();
  for (int e = tid; e < kTnBM * (kTnBN / 8); e += 128) {
    const int r = e >> 4, c = (e & 15) * 8, m = m0 + r, n = n0 + c;
    if (m >= p.M || n >= p.N) continue;
    float f[8];
    *reinterpret_cast<float4*>(f) = *reinterpret_cast<const float4*>(stg + r * kStgPitch + c);
    *reinterpret_cast<float4*>(f + 4) =
        *reinterpret_cast<const float4*>(stg + r * kStgPitch + c + 4);
    const size_t idx = (size_t)m * p.N + n;
    if (p.ws != nullptr) {
      float* w = p.ws + (size_t)blockIdx.z * ((size_t)p.M * p.N + p.M) + idx;
      *reinterpret_cast<float4*>(w) = *reinterpret_cast<float4*>(f);
      *reinterpret_cast<float4*>(w + 4) = *reinterpret_cast<float4*>(f + 4);
    } else {
      *reinterpret_cast<uint4*>(p.dw + idx) = pack8(f);
    }
  }
  if (sums && m0 + tid < p.M) {
    if (p.ws != nullptr)
      p.ws[(size_t)blockIdx.z * ((size_t)p.M * p.N + p.M) + (size_t)p.M * p.N + m0 + tid] = csum;
    else
      p.db[m0 + tid] = __float2bfloat16(csum);
  }
}

// ---- the persistent, warp-specialised GEMM (the normal form) ----
//
// One block per SM walks the 128 x 128 output tiles, column tiles fastest, so
// a row panel of A is read from device memory once and reused from L2 across
// its column tiles.  Warpgroup 0 is the producer: its thread 0 loads B's K
// step by TMA (128-byte swizzle, the mbarrier's transaction count) and, with
// no row map, A's the same way; with a row map a(m) all 128 threads gather
// A's rows by cp.async into the same swizzle and cp.async.mbarrier.arrive.noinc
// reports them to the stage's full barrier.  Warpgroups 1 and 2 are the
// consumers, 64 rows of the tile each: each runs wgmma on the landed stage
// and releases it to the producer through its empty barrier once the
// products that read it are done.  The epilogue runs per warp, 8 rows at a
// time through the warp's own slice of shared memory, with 16-byte stores
// and no block barrier, while the producer fills the ring (six stages) with
// the next tile's steps.  64- and 256-wide column tiles, an epilogue of
// 4-byte stores straight from the accumulators, and the two consumers taking
// whole tiles in turns were measured against this design and were not
// faster (PERF.md, Findings).
constexpr int kPBM = 128, kPBN = 128, kPThreads = 384, kPStages = 6;
constexpr int kPStageA = kPBM * 128, kPStage = kPStageA + kPBN * 128;
constexpr int kStgBytes = 8 * 8 * kStgPitch * 4;  // 8 rows of f32 staging per consumer warp
constexpr size_t kPSmem = (size_t)kPStages * kPStage + kStgBytes + 2 * kPStages * 8 + 1024;

struct RowArgs {
  const __nv_bfloat16* a; const __nv_bfloat16* bias; const __nv_bfloat16* res;
  const float* row_scale; const __nv_bfloat16* aux;
  __nv_bfloat16* y; __nv_bfloat16* out; __nv_bfloat16* aux_out;
  const int* a_map; const int* c_map;
  int M, N, K, act, scale_div, row_scale_on, map_len, b_kmajor, tiles_n, tiles;
};

// Row m through a row map of period len (no map: m itself), as gemm.cu's.
__device__ __forceinline__ int map_row(const int* map, int len, int m) {
  return map == nullptr ? m : (m / len) * len + map[m % len];
}

// The epilogue of 8 columns (m, n..n+7) from their f32 sums f: bias,
// activation, y, and out = T(res + T(v)) or, with a row scale, T(res + s v),
// the residual's 8 values rv loaded ahead; the stored rows through c(m).
__device__ __forceinline__ void epilogue8(const RowArgs& p, int m, int n, float* f, uint4 rv) {
  float t[8];
  const size_t idx = (size_t)map_row(p.c_map, p.map_len, m) * p.N + n;
  if (p.bias != nullptr) {
    unpack8(ldg8(p.bias + n), t);
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] += t[i];
  }
  if (p.act == kActGelu) {
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = gelu_erf(f[i]);
  } else if (p.act == kActGeluGrad) {
    unpack8(ldg8(p.aux + idx), t);
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] *= gelu_erf_grad(t[i]);
    if (p.aux_out != nullptr) {
#pragma unroll
      for (int i = 0; i < 8; ++i) t[i] = gelu_erf(t[i]);
      *reinterpret_cast<uint4*>(p.aux_out + idx) = pack8(t);
    }
  }
  const uint4 yv = pack8(f);
  if (p.y != nullptr) *reinterpret_cast<uint4*>(p.y + idx) = yv;
  if (p.out != nullptr) {
    // without a row scale the branch is rounded to T first, as the serving
    // kernels do; with one, res + s * v is rounded once
    float s = 1.f;
    if (p.row_scale != nullptr) {
      if (p.row_scale_on) s = p.row_scale[m / p.scale_div];
    } else {
      unpack8(yv, f);
    }
    unpack8(rv, t);
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = t[i] + s * f[i];
    *reinterpret_cast<uint4*>(p.out + idx) = pack8(f);
  }
}

__global__ void __launch_bounds__(kPThreads, 1)
    gemm_rows_kernel(const __grid_constant__ CUtensorMap a_tmap,
                     const __grid_constant__ CUtensorMap b_tmap, RowArgs p) {
  extern __shared__ unsigned char smem_raw[];
  // the swizzle repeats every 1024 bytes: stages start on such a boundary
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kPStages * kPStage + kStgBytes);
  const unsigned full0 = smem_u32(bars), empty0 = smem_u32(bars + kPStages);
  const bool gather = p.a_map != nullptr;  // A's rows by cp.async through the map

  const int tid = threadIdx.x, wg = tid >> 7;
  if (tid == 0) {
    for (int s = 0; s < kPStages; ++s) {
      // the TMA thread's expect_tx, and with the gather 128 cp.async arrivals
      mbar_init(full0 + 8 * s, gather ? 128 + 1 : 1);
      mbar_init(empty0 + 8 * s, 8);  // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int ksteps = (p.K + 63) / 64;

  if (wg == 0) {  // ---- the producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const int c = tid & 7, r0 = tid >> 3;  // the gather: chunk c of tile rows r0 + 16 i
    int it = 0;
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const int m0 = (tile / p.tiles_n) * kPBM, n0 = (tile % p.tiles_n) * kPBN;
      int src[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int m = m0 + r0 + 16 * i;
        src[i] = gather && m < p.M ? map_row(p.a_map, p.map_len, m) : -1;
      }
      for (int ks = 0; ks < ksteps; ++ks, ++it) {
        const int s = it % kPStages;
        mbar_wait(empty0 + 8 * s, ((it / kPStages) & 1) ^ 1);
        unsigned char* sa = smem + s * kPStage;
        const unsigned sb = smem_u32(sa + kPStageA), full = full0 + 8 * s;
        const int k0 = ks * 64;
        if (tid == 0) {
          mbar_expect_tx(full, kPBN * 128 + (gather ? 0 : kPStageA));
          if (!gather) tma_load_2d(smem_u32(sa), &a_tmap, full, k0, m0);
          if (p.b_kmajor) {
            tma_load_2d(sb, &b_tmap, full, k0, n0);
          } else {
#pragma unroll
            for (int q = 0; q < kPBN / 64; ++q)
              tma_load_2d(sb + q * kPanel, &b_tmap, full, n0 + 64 * q, k0);
          }
        }
        if (gather) {
          const int k = k0 + 8 * c;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int r = r0 + 16 * i;
            const bool ok = src[i] >= 0 && k < p.K;
            cp_async16(sa + r * 128 + ((c ^ (r & 7)) << 4),
                       p.a + (ok ? (size_t)src[i] * p.K + k : 0), ok);
          }
          cp_async_mbar_arrive(full);
        }
      }
    }
    cp_async_wait<0>();
  } else {  // ---- the consumers: 64 rows of the tile each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1, warp = (tid >> 5) & 3, lane = tid & 31;
    float* stg =  // this warp's staging slice
        reinterpret_cast<float*>(smem + kPStages * kPStage) + (cw * 4 + warp) * 8 * kStgPitch;
    int it = 0;
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const int m0 = (tile / p.tiles_n) * kPBM, n0 = (tile % p.tiles_n) * kPBN;
      float d[kPBN / 2];
#pragma unroll
      for (int i = 0; i < kPBN / 2; ++i) d[i] = 0.f;
      fence_acc(d);
      for (int ks = 0; ks < ksteps; ++ks, ++it) {
        const int s = it % kPStages;
        mbar_wait(full0 + 8 * s, (it / kPStages) & 1);
        unsigned char* sa = smem + s * kPStage;
        if (gather) fence_proxy_async();  // the landed cp.async rows, to the tensor cores
        const unsigned a0 = smem_u32(sa) + cw * kPanel, b0 = smem_u32(sa + kPStageA);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t da = smem_desc(a0 + kk * 32, 16, 1024);
          if (p.b_kmajor)
            wgmma_m64n128k16<0, 0>(d, da, smem_desc(b0 + kk * 32, 16, 1024));
          else
            wgmma_m64n128k16<0, 1>(d, da, smem_desc(b0 + kk * 2048, kPanel, 1024));
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous step's products are done: release its stage
        fence_acc(d);
        if (ks > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((it - 1) % kPStages));
      }
      wgmma_wait<0>();
      fence_acc(d);
      if (lane == 0) mbar_arrive(empty0 + 8 * ((it - 1) % kPStages));
      // the epilogue: this warp's 16 rows, 8 at a time, through its own
      // staging slice (16-byte stores), no block barrier
      const int mw = m0 + cw * 64 + 16 * warp;  // the warp's first row
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // rows l/4 (d[4j], d[4j+1]), then l/4 + 8
#pragma unroll
        for (int j = 0; j < kPBN / 8; ++j)
          *reinterpret_cast<float2*>(stg + (lane >> 2) * kStgPitch + 8 * j + 2 * (lane & 3)) =
              make_float2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
        __syncwarp();
        constexpr int kIt = 8 * (kPBN / 8) / 32;  // chunks of 8 columns a lane
        uint4 rv[kIt];  // the residual first, every load of it in flight together
#pragma unroll
        for (int i = 0; i < kIt; ++i) {
          const int e = lane + 32 * i, m = mw + 8 * h + e / (kPBN / 8);
          const int n = n0 + (e % (kPBN / 8)) * 8;
          rv[i] = make_uint4(0, 0, 0, 0);
          if (p.res != nullptr && m < p.M && n < p.N)
            rv[i] = ldg8(p.res + (size_t)map_row(p.c_map, p.map_len, m) * p.N + n);
        }
#pragma unroll
        for (int i = 0; i < kIt; ++i) {
          const int e = lane + 32 * i, r = e / (kPBN / 8), c8 = (e % (kPBN / 8)) * 8;
          const int m = mw + 8 * h + r, n = n0 + c8;
          if (m >= p.M || n >= p.N) continue;
          float f[8];
          *reinterpret_cast<float4*>(f) =
              *reinterpret_cast<const float4*>(stg + r * kStgPitch + c8);
          *reinterpret_cast<float4*>(f + 4) =
              *reinterpret_cast<const float4*>(stg + r * kStgPitch + c8 + 4);
          epilogue8(p, m, n, f, rv[i]);
        }
        __syncwarp();
      }
    }
  }
}

}  // namespace mumpy

extern "C" int mumpy_gemm_rows(const void* a, const void* b, const void* bias, const void* res,
                               const float* row_scale, const void* aux, void* y, void* out,
                               void* aux_out, const int* a_map, const int* c_map, int map_len,
                               int M, int N, int K, int b_kmajor, int act, int scale_div,
                               int row_scale_on, void* stream) {
  using namespace mumpy;
  if (M <= 0 || N <= 0 || K <= 0 || N % 8 || K % 8 || act < kActNone || act > kActGeluGrad ||
      (act == kActGeluGrad && aux == nullptr) || (aux_out != nullptr && act != kActGeluGrad) ||
      (out != nullptr && res == nullptr) || (row_scale != nullptr && scale_div <= 0) ||
      ((a_map != nullptr || c_map != nullptr) && (map_len <= 0 || M % map_len)) ||
      !aligned16(a) || !aligned16(b) || !aligned16(bias) || !aligned16(res) ||
      !aligned16(aux) || !aligned16(y) || !aligned16(out) || !aligned16(aux_out))
    return (int)cudaErrorInvalidValue;
  static_assert(kPSmem <= 232448, "the ring, the staging and the barriers fit in 227 KB");
  static SmemAttr attr;  // once per device
  if (const int err = attr.raise(gemm_rows_kernel, (int)kPSmem)) return err;
  // B: K-major (N, K) boxes of 64 K x 128 rows, or N-major (K, N) boxes of
  // 64 N x 64 K; A (unmapped): (M, K) boxes of 64 K x 128 rows
  CUtensorMap a_tmap{}, b_tmap;
  int err = b_kmajor ? tensor_map(&b_tmap, b, N, K, kPBN) : tensor_map(&b_tmap, b, K, N, 64);
  if (err == 0 && a_map == nullptr) err = tensor_map(&a_tmap, a, M, K, kPBM);
  if (err != 0) return err;
  const int tiles_n = (N + kPBN - 1) / kPBN, tiles = ((M + kPBM - 1) / kPBM) * tiles_n;
  RowArgs p{static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(bias),
            static_cast<const __nv_bfloat16*>(res), row_scale,
            static_cast<const __nv_bfloat16*>(aux), static_cast<__nv_bfloat16*>(y),
            static_cast<__nv_bfloat16*>(out), static_cast<__nv_bfloat16*>(aux_out), a_map, c_map,
            M, N, K, act, scale_div, row_scale_on, map_len, b_kmajor, tiles_n, tiles};
  gemm_rows_kernel<<<std::min(tiles, sm_count()), kPThreads, kPSmem,
                     static_cast<cudaStream_t>(stream)>>>(a_tmap, b_tmap, p);
  return (int)cudaGetLastError();
}

extern "C" int mumpy_gemm_sm90(const void* a, const void* b, const void* bias, const void* res,
                               const float* row_scale, const void* aux, void* y, void* out,
                               void* aux_out, int M, int N, int K, int b_kmajor, int act,
                               int scale_div, int row_scale_on, void* stream) {
  return mumpy_gemm_rows(a, b, bias, res, row_scale, aux, y, out, aux_out, nullptr, nullptr, 0,
                         M, N, K, b_kmajor, act, scale_div, row_scale_on, stream);
}

extern "C" int mumpy_gemm_sm90_tn(const void* a, const void* b, float* ws, void* dw, void* db,
                                  int rows, int M, int N, int rows_per_split, void* stream) {
  using namespace mumpy;
  if (rows <= 0 || M <= 0 || N <= 0 || M % 8 || N % 8 || rows_per_split <= 0 ||
      dw == nullptr || db == nullptr || (ws == nullptr && rows_per_split < rows) ||
      !aligned16(a) || !aligned16(b) || !aligned16(ws) || !aligned16(dw))
    return (int)cudaErrorInvalidValue;
  TnArgs p{static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b), ws,
           static_cast<__nv_bfloat16*>(dw), static_cast<__nv_bfloat16*>(db), M, N, rows,
           rows_per_split};
  constexpr size_t smem = (size_t)kTnStages * kTnStage + 1024;
  static_assert(kTnBM * kStgPitch * sizeof(float) <= kTnStages * kTnStage,
                "the epilogue staging fits in the ring");
  static SmemAttr attr;  // once per device
  if (const int err = attr.raise(gemm_tn_kernel, (int)smem)) return err;
  const dim3 grid((N + kTnBN - 1) / kTnBN, (M + kTnBM - 1) / kTnBM,
                  (rows + rows_per_split - 1) / rows_per_split);
  gemm_tn_kernel<<<grid, 128, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
