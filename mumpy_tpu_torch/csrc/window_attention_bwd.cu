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
// dQ, dK, dV are written into dqkv at the columns of q, k and v.  mb is the
// (P, H, N, 64) f32 additive term of the forward, its key-pad columns at
// -1e30; dmb is (P, H, N, N) f32 and must be zeroed by the caller.  A block
// sums dS over its windows in shared memory and adds the sum to dmb with one
// atomic per element at the end, so a (p, h) slot takes one atomic per
// element per chunk, not per window.  `rowsum` = 0 drops the rowsum term:
// the planted fault of the kernel's checks, never set on the training path.
//
// Replaces the per-head backward loop of the Pallas kernel
// mumpy_tpu/ops/pallas/attn_ln_vjp.py:_bwd_kernel (dp, dsum, ds, the per-tile
// dmb sums, dq, dk, dv).  As there, P is rounded to T before dV = P^T dO and
// dS * scale before dQ and dK.  A window holds N <= 64 tokens and hd <= 32,
// so q, k, v, dO, P and dS of one head fit in shared memory; each warp owns
// whole query rows (lanes j and j + 32 take key j), then whole key rows for
// dK and dV.  It is a SIMT kernel, bound by issuing instructions (about 8
// N^2 hd flops per window and head), not by bytes.
#include "common.cuh"

namespace mumpy {

constexpr int kBwdThreads = 128, kBwdWarps = kBwdThreads / 32;
constexpr int kBwdMaxN = 64, kPPitch = kBwdMaxN + 1;

inline size_t bwd_smem_floats(int N, int hd) {
  return (size_t)4 * N * (hd + 1) + 2 * (size_t)N * kPPitch + (size_t)N * N;
}

template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
window_attention_bwd_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                            const float* __restrict__ mb, T* __restrict__ dqkv,
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
  const float* mbh = mb + ((size_t)p * H + h) * N * kBwdMaxN;

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
      s0 = s0 * scale + mbh[i * kBwdMaxN + lane];
      s1 = s1 * scale + mbh[i * kBwdMaxN + lane + 32];
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

}  // namespace mumpy

extern "C" int mumpy_window_attention_bwd(const void* qkv, const void* dout, const float* mb,
                                          void* dqkv, float* dmb, int R, int N, int H, int hd,
                                          int P, int chunks, float scale, int rowsum,
                                          int dtype, void* stream) {
  using namespace mumpy;
  if (N <= 0 || N > kBwdMaxN || hd <= 0 || hd > 32 || P <= 0 || R % P || chunks <= 0 ||
      mb == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int per_slot = R / P;
  const int wpb = (per_slot + chunks - 1) / chunks;
  const dim3 grid(H, P, (per_slot + wpb - 1) / wpb);
  const size_t smem = bwd_smem_floats(N, hd) * sizeof(float);
  cudaError_t err;
  if (dtype == kBF16) {
    auto k = window_attention_bwd_kernel<__nv_bfloat16>;
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    k<<<grid, kBwdThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(qkv), static_cast<const __nv_bfloat16*>(dout), mb,
        static_cast<__nv_bfloat16*>(dqkv), dmb, R, N, H, hd, P, wpb, scale, rowsum);
  } else {
    auto k = window_attention_bwd_kernel<float>;
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    k<<<grid, kBwdThreads, smem, s>>>(
        static_cast<const float*>(qkv), static_cast<const float*>(dout), mb,
        static_cast<float*>(dqkv), dmb, R, N, H, hd, P, wpb, scale, rowsum);
  }
  return (int)cudaGetLastError();
}
