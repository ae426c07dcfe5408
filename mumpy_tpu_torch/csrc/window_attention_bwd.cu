// Window attention backward: one block per (head h, mask slot p, chunk of
// windows), the windows of a chunk taken in turn.
//
// For window r (r % P == p) and head h, with q/k/v read from the packed qkv
// rows (q at column h*hd, k at C + h*hd, v at 2C + h*hd) and dO from do_:
//
//   P   = softmax(q k^T * scale + mb[p, h])      recomputed, f32
//   dP  = dO V^T
//   dS  = P * (dP - rowsum(P * dP))               rowsum(P * dP) = rowsum(dO * O)
//   dQ  = dS K * scale,  dK = dS^T Q * scale,  dV = P^T dO
//   dmb[p, h] += dS                               (f32, the mask+bias gradient)
//
// dQ, dK, dV are written into dqkv at the columns of q, k and v; with o given
// (non-null, (R*N, C) like dO) also the forward's head outputs O = T(P) V from
// the P the backward forms anyway (the attention half's weight gradient reads
// them, so its recompute runs no forward core).  mb is the
// (P, H, N, N) additive term of the forward in f32 or bf16 (mb_dtype) with
// element strides mb_s0..3; dmb is (P, H, N, N) f32, contiguous, and must be
// zeroed by the caller.  A block
// sums dS over its windows in f32 (shared memory in the SIMT kernel,
// registers in the tensor-core one) and adds the sum to dmb with one atomic
// per element at the end, so a (p, h) slot takes one atomic per element per
// chunk, not per window.  `rowsum` = 0 drops the rowsum term: the planted
// fault of the kernel's checks, never set on the training path.
//
// Replaces the per-head backward loop of the Pallas kernel
// mumpy_tpu/ops/pallas/attn_ln_vjp.py:_bwd_kernel (dp, dsum, ds, the per-tile
// dmb sums, dq, dk, dv) and the XLA VJP of
// mumpy_tpu/ops/pallas/window_attention.py:window_attention_ad.  As there, P
// is rounded to T before dV = P^T dO and dS * scale before dQ and dK.  A
// window holds N <= 64 tokens and hd <= 32, so q, k, v, dO, P and dS of one
// head fit in shared memory.  bf16 at hd = 32 (every flagship head) runs the
// five products (six with O) on the tensor cores (window_attention_bwd_tc_kernel, below):
// at N = 49 that work is bound by device-memory bytes (about 28 flops per
// byte of qkv, dO, dqkv and mask+bias in bf16).  f32 and other head widths
// run the SIMT kernel, where each warp owns whole query rows (lanes j and
// j + 32 take key j), then whole key rows for dK and dV; it is bound by
// issuing instructions (about 8 N^2 hd flops per window and head).
#include "window_attention_mma.cuh"

namespace mumpy {

constexpr int kBwdThreads = 128, kBwdWarps = kBwdThreads / 32;
constexpr int kBwdMaxN = kMaxN, kPPitch = kBwdMaxN + 1;

inline size_t bwd_smem_floats(int N, int hd) {
  return (size_t)4 * N * (hd + 1) + 2 * (size_t)N * kPPitch + (size_t)N * N;
}

template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
window_attention_bwd_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                            MaskBias mb, T* __restrict__ dqkv, T* __restrict__ o,
                            float* __restrict__ dmb, int R, int N, int H, int hd, int P,
                            int wpb, float scale, int rowsum) {
  extern __shared__ float sm[];
  const int hp = hd + 1;
  float* qs = sm;
  float* ks = qs + N * hp;
  float* vs = ks + N * hp;
  float* ds_ = vs + N * hp;   // dO
  float* ps = ds_ + N * hp;   // P rounded to T, pitch kPPitch
  float* gs = ps + N * kPPitch;  // dS * scale rounded to T
  float* acc = gs + N * kPPitch;  // sum of dS over the block's windows

  const int h = blockIdx.x, p = blockIdx.y;
  const int C = H * hd, ld = 3 * C;
  const int per_slot = R / P;
  const int j0 = blockIdx.z * wpb, j1 = min(per_slot, j0 + wpb);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int e = tid; e < N * N; e += kBwdThreads) acc[e] = 0.f;

  for (int j = j0; j < j1; ++j) {
    const int r = p + j * P;
    const T* base = qkv + (size_t)r * N * ld + h * hd;
    const T* dob = dout + (size_t)r * N * C + h * hd;
    for (int e = tid; e < N * hd; e += kBwdThreads) {
      const int i = e / hd, d = e % hd;
      qs[i * hp + d] = to_f<T>(base[(size_t)i * ld + d]);
      ks[i * hp + d] = to_f<T>(base[(size_t)i * ld + C + d]);
      vs[i * hp + d] = to_f<T>(base[(size_t)i * ld + 2 * C + d]);
      ds_[i * hp + d] = to_f<T>(dob[(size_t)i * C + d]);
    }
    __syncthreads();

    // P, dP and dS, a query row per warp
    for (int i = warp; i < N; i += kBwdWarps) {
      const float* qi = qs + i * hp;
      const float* di = ds_ + i * hp;
      const bool ok0 = lane < N, ok1 = lane + 32 < N;
      const float* k0 = ks + (ok0 ? lane : 0) * hp;
      const float* k1 = ks + (ok1 ? lane + 32 : 0) * hp;
      const float* v0 = vs + (ok0 ? lane : 0) * hp;
      const float* v1 = vs + (ok1 ? lane + 32 : 0) * hp;
      float s0 = 0.f, s1 = 0.f, g0 = 0.f, g1 = 0.f;
      for (int d = 0; d < hd; ++d) {
        s0 = fmaf(qi[d], k0[d], s0);
        s1 = fmaf(qi[d], k1[d], s1);
        g0 = fmaf(di[d], v0[d], g0);
        g1 = fmaf(di[d], v1[d], g1);
      }
      s0 = s0 * scale + (ok0 ? mb.at(p, h, i, lane) : 0.f);
      s1 = s1 * scale + (ok1 ? mb.at(p, h, i, lane + 32) : 0.f);
      if (!ok0) s0 = -1e30f;
      if (!ok1) s1 = -1e30f;
      const float mx = warp_max(fmaxf(s0, s1));
      const float e0 = expf(s0 - mx), e1 = expf(s1 - mx);
      const float inv = 1.f / warp_sum(e0 + e1);
      const float p0 = ok0 ? e0 * inv : 0.f, p1 = ok1 ? e1 * inv : 0.f;
      const float dsum = rowsum ? warp_sum(p0 * g0 + p1 * g1) : 0.f;
      const float d0 = p0 * (g0 - dsum), d1 = p1 * (g1 - dsum);
      ps[i * kPPitch + lane] = round_to<T>(p0);
      ps[i * kPPitch + lane + 32] = round_to<T>(p1);
      gs[i * kPPitch + lane] = round_to<T>(d0 * scale);
      gs[i * kPPitch + lane + 32] = round_to<T>(d1 * scale);
      if (ok0) acc[i * N + lane] += d0;
      if (ok1) acc[i * N + lane + 32] += d1;
    }
    __syncthreads();

    T* out = dqkv + (size_t)r * N * ld + h * hd;
    if (o != nullptr) {  // O = T(P) V: query row i per warp, column d per lane
      for (int i = warp; i < N; i += kBwdWarps) {
        for (int d = lane; d < hd; d += 32) {
          float a = 0.f;
          for (int k = 0; k < N; ++k) a = fmaf(ps[i * kPPitch + k], vs[k * hp + d], a);
          o[((size_t)r * N + i) * C + h * hd + d] = from_f<T>(a);
        }
      }
    }
    // dQ: query row i per warp, column d per lane
    for (int i = warp; i < N; i += kBwdWarps) {
      for (int d = lane; d < hd; d += 32) {
        float a = 0.f;
        for (int k = 0; k < N; ++k) a = fmaf(gs[i * kPPitch + k], ks[k * hp + d], a);
        out[(size_t)i * ld + d] = from_f<T>(a);
      }
    }
    // dK and dV: key row k per warp
    for (int k = warp; k < N; k += kBwdWarps) {
      for (int d = lane; d < hd; d += 32) {
        float a = 0.f, b = 0.f;
        for (int i = 0; i < N; ++i) {
          a = fmaf(gs[i * kPPitch + k], qs[i * hp + d], a);
          b = fmaf(ps[i * kPPitch + k], ds_[i * hp + d], b);
        }
        out[(size_t)k * ld + C + d] = from_f<T>(a);
        out[(size_t)k * ld + 2 * C + d] = from_f<T>(b);
      }
    }
    __syncthreads();  // the next window overwrites q, k, v, dO, P and dS
  }
  float* dst = dmb + ((size_t)p * H + h) * N * N;
  for (int e = tid; e < N * N; e += kBwdThreads) atomicAdd(dst + e, acc[e]);
}

// ---- bf16 at hd = 32 on the tensor cores (mma.sync m16n8k16) ----
// As the forward core: a block takes one head and the windows of one slot in
// turn, with the slot's mask+bias in registers; each window's q, k, v and dO
// come in by cp.async into the second of two buffers while the first one
// computes.  Warp w first owns query rows 16w..16w+15: S and P recomputed in
// registers, dP = dO V^T, the rowsum, dS = P (dP - rowsum), dS added to the
// per-slot f32 sums (registers: each element of the (N, N) tile belongs to one
// lane, so the sums over the block's windows take no shared memory and reach
// dmb with one atomic per element per block), and dQ = T(dS * scale) K from
// registers.  T(P) and T(dS * scale) go to shared memory; warp w then owns
// key rows 16w..16w+15 for dK = T(dS * scale)^T Q and dV = T(P)^T dO, their
// transposed operands read through ldmatrix.trans.
constexpr int kGPitch = kMaxN + 8;  // 144-byte rows: conflict-free ldmatrix and stores

__global__ void __launch_bounds__(kBwdThreads)
window_attention_bwd_tc_kernel(const __nv_bfloat16* __restrict__ qkv,
                               const __nv_bfloat16* __restrict__ dout,
                               MaskBias mb, __nv_bfloat16* __restrict__ dqkv,
                               __nv_bfloat16* __restrict__ o, float* __restrict__ dmb,
                               int R, int N, int H, int P, int wpb, float scale, int rowsum) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // buffers [2][q, k, v, dO][kTcTile], then T(P) and T(dS * scale) [kMaxN][kGPitch]
  __nv_bfloat16* bufs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ps = bufs + 2 * 4 * kTcTile;
  __nv_bfloat16* gs = ps + kMaxN * kGPitch;

  const int h = blockIdx.x, p = blockIdx.y;
  const int C = H * kTcHd, ld = 3 * C;
  const int j0 = blockIdx.z * wpb, j1 = min(R / P, j0 + wpb);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, i0 = warp * 16;
  for (int e = tid; e < 2 * kMaxN * kGPitch / 8; e += kBwdThreads)  // rows past N stay 0
    reinterpret_cast<uint4*>(ps)[e] = make_uint4(0, 0, 0, 0);

  auto load = [&](int j, int b) {
    const int r = p + j * P;
    const __nv_bfloat16* base = qkv + (size_t)r * N * ld + h * kTcHd;
    const __nv_bfloat16* dob = dout + (size_t)r * N * C + h * kTcHd;
    __nv_bfloat16* dst = bufs + b * 4 * kTcTile;
    for (int e = tid; e < kMaxN * 4; e += kBwdThreads) {
      const int i = e >> 2, c = (e & 3) * 8;
      const bool ok = i < N;
      const size_t ii = ok ? i : 0;
      cp_async16(dst + i * kTcPitch + c, base + ii * ld + c, ok);
      cp_async16(dst + kTcTile + i * kTcPitch + c, base + ii * ld + C + c, ok);
      cp_async16(dst + 2 * kTcTile + i * kTcPitch + c, base + ii * ld + 2 * C + c, ok);
      cp_async16(dst + 3 * kTcTile + i * kTcPitch + c, dob + ii * C + c, ok);
    }
    cp_async_commit();
  };

  float m[kMaxN / 8][4], dsum[kMaxN / 8][4] = {};
  load_mask_bias(m, mb, p, h, N, i0, g, t);
  if (j0 < j1) load(j0, 0);
  for (int j = j0; j < j1; ++j) {
    const int b = (j - j0) & 1;
    if (j + 1 < j1) {
      load(j + 1, b ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* qs = bufs + b * 4 * kTcTile;
    const __nv_bfloat16 *ks = qs + kTcTile, *vs = ks + kTcTile, *dos = vs + kTcTile;
    __nv_bfloat16* out = dqkv + (size_t)(p + j * P) * N * ld + h * kTcHd;
    if (i0 < N) {  // query rows i0..i0+15
      float s[kMaxN / 8][4], dp[kMaxN / 8][4];
      scores(s, qs, ks, i0, lane);
      scores(dp, dos, vs, i0, lane);  // dP = dO V^T
      softmax_rows(s, m, scale, i0 + g < N, i0 + g + 8 < N);
      float d0 = 0.f, d1 = 0.f;
      if (rowsum) {
#pragma unroll
        for (int jk = 0; jk < kMaxN / 8; ++jk) {
          d0 += s[jk][0] * dp[jk][0] + s[jk][1] * dp[jk][1];
          d1 += s[jk][2] * dp[jk][2] + s[jk][3] * dp[jk][3];
        }
#pragma unroll
        for (int o = 1; o <= 2; o <<= 1) {
          d0 += __shfl_xor_sync(0xffffffffu, d0, o);
          d1 += __shfl_xor_sync(0xffffffffu, d1, o);
        }
      }
#pragma unroll
      for (int jk = 0; jk < kMaxN / 8; ++jk) {
        dp[jk][0] = s[jk][0] * (dp[jk][0] - d0);  // dS
        dp[jk][1] = s[jk][1] * (dp[jk][1] - d0);
        dp[jk][2] = s[jk][2] * (dp[jk][2] - d1);
        dp[jk][3] = s[jk][3] * (dp[jk][3] - d1);
#pragma unroll
        for (int e = 0; e < 4; ++e) dsum[jk][e] += dp[jk][e];
        const int col = 8 * jk + 2 * t;
        *reinterpret_cast<unsigned*>(ps + (i0 + g) * kGPitch + col) =
            pack_bf16x2(s[jk][0], s[jk][1]);
        *reinterpret_cast<unsigned*>(ps + (i0 + g + 8) * kGPitch + col) =
            pack_bf16x2(s[jk][2], s[jk][3]);
        *reinterpret_cast<unsigned*>(gs + (i0 + g) * kGPitch + col) =
            pack_bf16x2(dp[jk][0] * scale, dp[jk][1] * scale);
        *reinterpret_cast<unsigned*>(gs + (i0 + g + 8) * kGPitch + col) =
            pack_bf16x2(dp[jk][2] * scale, dp[jk][3] * scale);
      }
      unsigned ga[4][4];
      to_a_frags(ga, dp, scale);  // T(dS * scale), as the Pallas kernel rounds it
      float dq[kTcHd / 8][4] = {};
      times_tile(dq, ga, ks, lane);  // dQ = T(dS * scale) K
#pragma unroll
      for (int jd = 0; jd < kTcHd / 8; ++jd) {
        const int col = 8 * jd + 2 * t;
        if (i0 + g < N)
          *reinterpret_cast<unsigned*>(out + (size_t)(i0 + g) * ld + col) =
              pack_bf16x2(dq[jd][0], dq[jd][1]);
        if (i0 + g + 8 < N)
          *reinterpret_cast<unsigned*>(out + (size_t)(i0 + g + 8) * ld + col) =
              pack_bf16x2(dq[jd][2], dq[jd][3]);
      }
      if (o != nullptr) {  // O = T(P) V, as the forward core forms it
        unsigned pa[4][4];
        to_a_frags(pa, s, 1.f);
        float acc[kTcHd / 8][4] = {};
        times_tile(acc, pa, vs, lane);
        __nv_bfloat16* ob = o + (size_t)(p + j * P) * N * C + h * kTcHd;
#pragma unroll
        for (int jd = 0; jd < kTcHd / 8; ++jd) {
          const int col = 8 * jd + 2 * t;
          if (i0 + g < N)
            *reinterpret_cast<unsigned*>(ob + (size_t)(i0 + g) * C + col) =
                pack_bf16x2(acc[jd][0], acc[jd][1]);
          if (i0 + g + 8 < N)
            *reinterpret_cast<unsigned*>(ob + (size_t)(i0 + g + 8) * C + col) =
                pack_bf16x2(acc[jd][2], acc[jd][3]);
        }
      }
    }
    __syncthreads();  // T(P) and T(dS * scale) complete
    const int k0 = i0;  // key rows k0..k0+15
    if (k0 < N) {
      unsigned ga[4][4], pa[4][4];  // (16 keys x 64 queries) fragments of the transposes
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int row = 16 * kk + (lane & 7) + ((lane >> 4) << 3);
        const int col = k0 + ((lane >> 3) & 1) * 8;
        ldsm_x4_t(ga[kk], gs + row * kGPitch + col);
        ldsm_x4_t(pa[kk], ps + row * kGPitch + col);
      }
      float dk[kTcHd / 8][4] = {}, dv[kTcHd / 8][4] = {};
      times_tile(dk, ga, qs, lane);   // dK = T(dS * scale)^T Q
      times_tile(dv, pa, dos, lane);  // dV = T(P)^T dO
#pragma unroll
      for (int jd = 0; jd < kTcHd / 8; ++jd) {
        const int col = 8 * jd + 2 * t;
        if (k0 + g < N) {
          __nv_bfloat16* row = out + (size_t)(k0 + g) * ld + col;
          *reinterpret_cast<unsigned*>(row + C) = pack_bf16x2(dk[jd][0], dk[jd][1]);
          *reinterpret_cast<unsigned*>(row + 2 * C) = pack_bf16x2(dv[jd][0], dv[jd][1]);
        }
        if (k0 + g + 8 < N) {
          __nv_bfloat16* row = out + (size_t)(k0 + g + 8) * ld + col;
          *reinterpret_cast<unsigned*>(row + C) = pack_bf16x2(dk[jd][2], dk[jd][3]);
          *reinterpret_cast<unsigned*>(row + 2 * C) = pack_bf16x2(dv[jd][2], dv[jd][3]);
        }
      }
    }
    __syncthreads();  // the next window refills this buffer and T(P), T(dS * scale)
  }
  if (i0 < N) {
    float* dst = dmb + ((size_t)p * H + h) * N * N;
#pragma unroll
    for (int jk = 0; jk < kMaxN / 8; ++jk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = i0 + g + (e >> 1) * 8, key = 8 * jk + 2 * t + (e & 1);
        if (row < N && key < N) atomicAdd(dst + row * N + key, dsum[jk][e]);
      }
    }
  }
}

}  // namespace mumpy

extern "C" int mumpy_window_attention_bwd(const void* qkv, const void* dout, const void* mb,
                                          void* dqkv, void* o, float* dmb, int R, int N,
                                          int H, int hd, int P, int mb_dtype, int mb_s0, int mb_s1,
                                          int mb_s2, int mb_s3, int chunks, float scale,
                                          int rowsum, int dtype, void* stream) {
  using namespace mumpy;
  if (N <= 0 || N > kBwdMaxN || hd <= 0 || hd > 32 || P <= 0 || R % P || chunks <= 0 ||
      mb == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const MaskBias m{mb, mb_dtype == kBF16, {mb_s0, mb_s1, mb_s2, mb_s3}};
  const int per_slot = R / P;
  const int wpb = (per_slot + chunks - 1) / chunks;
  const dim3 grid(H, P, (per_slot + wpb - 1) / wpb);
  const size_t smem = bwd_smem_floats(N, hd) * sizeof(float);
  cudaError_t err;
  if (dtype == kBF16 && hd == kTcHd && aligned16(qkv) && aligned16(dout) && aligned16(dqkv) &&
      aligned16(o)) {
    const size_t tc_smem = (2 * 4 * kTcTile + 2 * kMaxN * kGPitch) * sizeof(__nv_bfloat16);
    err = cudaFuncSetAttribute(window_attention_bwd_tc_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)tc_smem);
    if (err != cudaSuccess) return (int)err;
    window_attention_bwd_tc_kernel<<<grid, kBwdThreads, tc_smem, s>>>(
        static_cast<const __nv_bfloat16*>(qkv), static_cast<const __nv_bfloat16*>(dout), m,
        static_cast<__nv_bfloat16*>(dqkv), static_cast<__nv_bfloat16*>(o), dmb, R, N, H, P, wpb,
        scale, rowsum);
  } else if (dtype == kBF16) {
    auto k = window_attention_bwd_kernel<__nv_bfloat16>;
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    k<<<grid, kBwdThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(qkv), static_cast<const __nv_bfloat16*>(dout), m,
        static_cast<__nv_bfloat16*>(dqkv), static_cast<__nv_bfloat16*>(o), dmb, R, N, H, hd, P,
        wpb, scale, rowsum);
  } else {
    auto k = window_attention_bwd_kernel<float>;
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    k<<<grid, kBwdThreads, smem, s>>>(
        static_cast<const float*>(qkv), static_cast<const float*>(dout), m,
        static_cast<float*>(dqkv), static_cast<float*>(o), dmb, R, N, H, hd, P, wpb, scale,
        rowsum);
  }
  return (int)cudaGetLastError();
}
