// Window attention core.
//
//   o[r, i, h] = softmax_j(q[r % q_mod, i, h] . k[r, j, h] * scale + mb[r % P, h, i, j]) v[r, j, h]
//
// q/k/v/o are token rows with their own row strides (ld*) and point at head
// 0's column; head h starts hd columns further.  mb is (P, H, N, N) in f32
// or bf16 (mb_dtype) with element strides mb_s0..3, or null for no additive
// term (the CVA core); a window is padded to 64 keys and the keys j >= N are
// masked by the kernel.  mumpy_window_attention_fold also sums each run of
// `fold` consecutive windows (the CVA's ratio fold, out[b] = sum_t
// T(o[b * fold + t]) in f32, rounded once more, as the projection's fold
// prologue summed the stored o rows), writing R / fold windows; fold_on = 0
// keeps only each run's first window, the planted fault of the checks.
//
// Replaces the per-head attention loops of the Pallas kernels
// mumpy_tpu/ops/pallas/{swin_block,attn_ln,cva}.py.  A window holds N <= 64
// tokens and hd <= 32, so q, k and v of one head fit in shared memory.  bf16
// at hd = 32 (every flagship head) runs both products on the tensor cores
// (window_attention_tc_kernel, below); f32 and other head widths run the SIMT
// kernel, one block per (window, head), where each warp owns whole query
// rows: lane j and j+32 score one key each, the softmax is two warp
// reductions, and lane d accumulates output column d.  At N = 49 and hd = 32
// the work is bound by device-memory bytes (about 25 flops per byte of q, k,
// v, o and mask+bias in bf16, against the H100's ~295 for its tensor cores);
// the tensor-core kernel reads each byte once, keeps scores and
// probabilities in registers and overlaps the next window's loads with the
// current one's products.  The SIMT kernel is bound by its instruction issue.
#include "window_attention_mma.cuh"

namespace mumpy {

constexpr int kAttnThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kAttnThreads)
window_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ o,
                        MaskBias mb, int N, int H, int hd,
                        int q_mod, int ldq, int ldk, int ldv, int ldo, int P,
                        int fold, int fold_on, float scale) {
  extern __shared__ float sm[];
  const int hp = hd + 1;  // odd row pitch: lane-indexed rows hit distinct banks
  float* qs = sm;
  float* ks = qs + kMaxN * hp;
  float* vs = ks + kMaxN * hp;
  float* ps = vs + kMaxN * hp;  // one probability row per warp

  const int ob = blockIdx.x / H, h = blockIdx.x % H;  // the output window and head
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* pw = ps + warp * kMaxN;
  float fsum[kMaxN / (kAttnThreads / 32)] = {};  // the fold's sums: rows warp + 4i, column lane
  for (int t = 0; t < fold; ++t) {
    const int r = ob * fold + t;
    const T* qb = q + (size_t)(r % q_mod) * N * ldq + h * hd;
    const T* kb = k + (size_t)r * N * ldk + h * hd;
    const T* vb = v + (size_t)r * N * ldv + h * hd;
    if (t > 0) __syncthreads();  // the previous window's rows are read
    for (int e = tid; e < kMaxN * hd; e += kAttnThreads) {
      const int i = e / hd, d = e % hd;
      const bool ok = i < N;
      qs[i * hp + d] = ok ? to_f<T>(qb[(size_t)i * ldq + d]) : 0.f;
      ks[i * hp + d] = ok ? to_f<T>(kb[(size_t)i * ldk + d]) : 0.f;
      vs[i * hp + d] = ok ? to_f<T>(vb[(size_t)i * ldv + d]) : 0.f;
    }
    __syncthreads();

    for (int i = warp; i < N; i += kAttnThreads / 32) {
      const float* qi = qs + i * hp;
      const float* k0 = ks + lane * hp;
      const float* k1 = ks + (lane + 32) * hp;
      float s0 = 0.f, s1 = 0.f;
      for (int d = 0; d < hd; ++d) {
        s0 = fmaf(qi[d], k0[d], s0);
        s1 = fmaf(qi[d], k1[d], s1);
      }
      s0 *= scale;
      s1 *= scale;
      if (mb.p != nullptr) {
        if (lane < N) s0 += mb.at(r % P, h, i, lane);
        if (lane + 32 < N) s1 += mb.at(r % P, h, i, lane + 32);
      }
      if (lane >= N) s0 = -1e30f;
      if (lane + 32 >= N) s1 = -1e30f;
      const float mx = warp_max(fmaxf(s0, s1));
      const float e0 = expf(s0 - mx), e1 = expf(s1 - mx);
      const float inv = 1.f / warp_sum(e0 + e1);
      // probabilities are rounded to T before P.V, as the Pallas kernels do
      pw[lane] = round_to<T>(e0 * inv);
      pw[lane + 32] = round_to<T>(e1 * inv);
      __syncwarp();
      if (lane < hd) {  // hd <= 32: one column a lane
        float acc = 0.f;
        for (int j = 0; j < N; ++j) acc = fmaf(pw[j], vs[j * hp + lane], acc);
        if (fold == 1)
          o[((size_t)r * N + i) * ldo + h * hd + lane] = from_f<T>(acc);
        else if (fold_on || t == 0)
          fsum[i / (kAttnThreads / 32)] += round_to<T>(acc);
      }
      __syncwarp();
    }
  }
  if (fold > 1 && lane < hd)
    for (int i = warp; i < N; i += kAttnThreads / 32)
      o[((size_t)ob * N + i) * ldo + h * hd + lane] = from_f<T>(fsum[i / (kAttnThreads / 32)]);
}

// bf16 at hd = 32 (every flagship head) on the tensor cores, mma.sync
// m16n8k16.  A block takes one head and the windows of one mask slot in turn
// (r = p, p + P, ...), so the slot's mask+bias is read once, into registers,
// for all of them.  Each window's q, k and v (64-byte runs of the token rows)
// come in by cp.async into the second of two buffers while the first one
// computes; rows >= N are zero-filled.  Each of the 4 warps owns 16 query
// rows: S = Q K^T lands in registers (16 x 64 f32: a whole row of keys, so no
// online softmax), the softmax runs there in f32, P rounded to bf16 is the A
// operand of P V straight from those registers (an m16n8 accumulator pair is
// an m16n8k16 A fragment), and the 16 x 32 output leaves through a per-warp
// shared tile as 16-byte stores.  K^T and V reach the B operand through
// ldmatrix (V with .trans).
constexpr int kTcBlocks = 1056;  // about 8 blocks per SM of an H100 (132 SMs)

__global__ void __launch_bounds__(kAttnThreads)
window_attention_tc_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                           MaskBias mb, int R, int N, int H, int q_mod,
                           int ldq, int ldk, int ldv, int ldo, int P, int wpb, int fold,
                           int fold_on, float scale) {
  __shared__ __align__(128) __nv_bfloat16 buf[2][3][kTcTile];  // q, k, v of two windows
  __shared__ __align__(128) __nv_bfloat16 ost[kAttnThreads / 32][16 * kTcPitch];

  const int h = blockIdx.x, p = blockIdx.y;
  const int j0 = blockIdx.z * wpb, j1 = min(R / P, j0 + wpb);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, i0 = warp * 16;

  auto load = [&](int j, int b) {
    const int r = p + j * P;
    const __nv_bfloat16* qb = q + (size_t)(r % q_mod) * N * ldq + h * kTcHd;
    const __nv_bfloat16* kb = k + (size_t)r * N * ldk + h * kTcHd;
    const __nv_bfloat16* vb = v + (size_t)r * N * ldv + h * kTcHd;
    for (int e = tid; e < kMaxN * 4; e += kAttnThreads) {
      const int i = e >> 2, c = (e & 3) * 8;
      const bool ok = i < N;
      const size_t ii = ok ? i : 0;
      cp_async16(&buf[b][0][i * kTcPitch + c], qb + ii * ldq + c, ok);
      cp_async16(&buf[b][1][i * kTcPitch + c], kb + ii * ldk + c, ok);
      cp_async16(&buf[b][2][i * kTcPitch + c], vb + ii * ldv + c, ok);
    }
    cp_async_commit();
  };

  float m[kMaxN / 8][4];
  float fsum[kTcHd / 8][4];  // the fold run's sum (fold > 1)
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
    if (i0 < N) {
      float s[kMaxN / 8][4];
      scores(s, buf[b][0], buf[b][1], i0, lane);
      softmax_rows(s, m, scale, i0 + g < N, i0 + g + 8 < N);
      unsigned pa[4][4];
      to_a_frags(pa, s, 1.f);  // P rounded to bf16 before P V, as the Pallas kernels do
      float acc[kTcHd / 8][4] = {};
      times_tile(acc, pa, buf[b][2], lane);
      const int tf = j % fold;  // the window's place in its fold run
      if (fold > 1) {  // the run's sum of T(o), f32
#pragma unroll
        for (int jd = 0; jd < kTcHd / 8; ++jd)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float v = tf == 0 || fold_on ? round_to<__nv_bfloat16>(acc[jd][e]) : 0.f;
            fsum[jd][e] = tf == 0 ? v : fsum[jd][e] + v;
            acc[jd][e] = fsum[jd][e];
          }
      }
      if (tf == fold - 1) {  // store o (the run's sum) of window r / fold
        __nv_bfloat16* st = ost[warp];
#pragma unroll
        for (int jd = 0; jd < kTcHd / 8; ++jd) {
          *reinterpret_cast<unsigned*>(st + g * kTcPitch + 8 * jd + 2 * t) =
              pack_bf16x2(acc[jd][0], acc[jd][1]);
          *reinterpret_cast<unsigned*>(st + (g + 8) * kTcPitch + 8 * jd + 2 * t) =
              pack_bf16x2(acc[jd][2], acc[jd][3]);
        }
        __syncwarp();
        const int r = (p + j * P) / fold;
        for (int e = lane; e < 16 * 4; e += 32) {  // 16 rows of four 16-byte runs
          const int row = e >> 2, c = (e & 3) * 8;
          if (i0 + row < N)
            *reinterpret_cast<uint4*>(o + ((size_t)r * N + i0 + row) * ldo + h * kTcHd + c) =
                *reinterpret_cast<const uint4*>(st + row * kTcPitch + c);
        }
      }
    }
    __syncthreads();  // the next load refills this buffer
  }
}

}  // namespace mumpy

namespace {

int launch_window_attention(const void* q, const void* k, const void* v, void* o,
                            const mumpy::MaskBias& m, int R, int N, int H, int hd, int q_mod,
                            int ldq, int ldk, int ldv, int ldo, int P, int fold, int fold_on,
                            float scale, int dtype, cudaStream_t s) {
  using namespace mumpy;
  if (N <= 0 || N > kMaxN || hd <= 0 || hd > 32 || P <= 0 || R % P || fold <= 0 ||
      R % fold || (fold > 1 && (P != 1 || m.p != nullptr)))
    return (int)cudaErrorInvalidValue;
  const bool tc = dtype == kBF16 && hd == kTcHd && ldq % 8 == 0 && ldk % 8 == 0 &&
                  ldv % 8 == 0 && ldo % 8 == 0 && aligned16(q) && aligned16(k) &&
                  aligned16(v) && aligned16(o);
  if (tc) {  // chunks of whole fold runs (P = 1 where fold > 1)
    const int runs = R / P / fold;
    const int chunks = max(1, min(runs, (kTcBlocks + H * P - 1) / (H * P)));
    const int wpb = (runs + chunks - 1) / chunks * fold;
    const dim3 grid(H, P, (R / P + wpb - 1) / wpb);
    window_attention_tc_kernel<<<grid, kAttnThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), m, R, N, H,
        q_mod, ldq, ldk, ldv, ldo, P, wpb, fold, fold_on, scale);
    return (int)cudaGetLastError();
  }
  const size_t smem = (size_t)(3 * kMaxN * (hd + 1) + (kAttnThreads / 32) * kMaxN) * sizeof(float);
  const int blocks = R / fold * H;
  if (dtype == kBF16)
    window_attention_kernel<__nv_bfloat16><<<blocks, kAttnThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), m, N, H,
        hd, q_mod, ldq, ldk, ldv, ldo, P, fold, fold_on, scale);
  else
    window_attention_kernel<float><<<blocks, kAttnThreads, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), m, N, H, hd, q_mod,
        ldq, ldk, ldv, ldo, P, fold, fold_on, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mumpy_window_attention(const void* q, const void* k, const void* v,
                                      void* o, const void* mb, int R, int N, int H,
                                      int hd, int q_mod, int ldq, int ldk, int ldv,
                                      int ldo, int P, int mb_dtype, int mb_s0,
                                      int mb_s1, int mb_s2, int mb_s3, float scale,
                                      int dtype, void* stream) {
  const mumpy::MaskBias m{mb, mb_dtype == mumpy::kBF16, {mb_s0, mb_s1, mb_s2, mb_s3}};
  return launch_window_attention(q, k, v, o, m, R, N, H, hd, q_mod, ldq, ldk, ldv, ldo, P, 1,
                                 1, scale, dtype, static_cast<cudaStream_t>(stream));
}

// The core without an additive term, each run of `fold` windows summed:
// o holds R / fold windows (row stride ldo)
extern "C" int mumpy_window_attention_fold(const void* q, const void* k, const void* v, void* o,
                                           int R, int N, int H, int hd, int q_mod, int ldq,
                                           int ldk, int ldv, int ldo, int fold, int fold_on,
                                           float scale, int dtype, void* stream) {
  const mumpy::MaskBias m{nullptr, 0, {0, 0, 0, 0}};
  return launch_window_attention(q, k, v, o, m, R, N, H, hd, q_mod, ldq, ldk, ldv, ldo, 1, fold,
                                 fold_on, scale, dtype, static_cast<cudaStream_t>(stream));
}
