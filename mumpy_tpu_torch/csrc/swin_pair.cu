// The bf16 launch sequences of the serving Swin blocks: #2's pair (a shifted
// block, then a plain one) and #1's plain block, one call from Python each,
// which launches every kernel of the sequence in turn on the caller's stream,
// the intermediates in one scratch buffer that the caller allocates
// (mumpy_swin_blocks_scratch gives its size).
//
// Replaces, with the kernels it launches, mumpy_tpu/ops/pallas/swin_pair.py:
// fused_pair_prepared (_pair_kernel) and swin_block.py:fused_swin_block_prepared
// (_block_kernel), which run a whole pair or block in one launch with its
// weights in VMEM.  Each block on x (R*N, C), its 12 weights as the serving
// operands store them (ln1_g, ln1_b, w_qkv (C, 3C), b_qkv, w_proj (C, C),
// b_proj, ln2_g, ln2_b, w1 (C, hidden), b1, w2 (hidden, C), b2) and its
// (P, H, N, N) mask+bias:
//   h = LN1(x)                             (train_rows.cu's ln_rows, one pass)
//   qkv = h[a(m)] Wqkv + bqkv              (gemm_sm90.cu, rows through a)
//   o = attention(qkv, mb)                 (window_attention.cu)
//   x2[c(m)] = x[c(m)] + (o Wproj + bproj) (rows scattered back through c = a)
//   y = x2 + fc2(gelu(fc1(LN2(x2))))       (at C <= 256, a multiple of 16:
//                                           mlp_sm90.cu, one launch with the
//                                           hidden on chip; else ln_rows and
//                                           two gemm_sm90.cu products, h =
//                                           LN2(x2), g = gelu(h W1 + b1), y =
//                                           x2 + (g W2 + b2))
// LayerNorm is row-local, so it runs on the unshifted rows and the qkv
// product gathers the normalised ones.
// The first block of a call takes the shift's row map (period map_len) as
// a and c, so it runs on the shifted windows while its input and output stay
// in the unshifted layout; the second takes none.  Five or seven launches a
// block from one host call (from Python, five a block cost tens of
// microseconds of host time each).  ln_stats_on = 0 is a planted fault of the
// checks: every LayerNorm with mu = 0, rstd = 1; gelu_on = 0 another, GELU
// replaced by the identity in the fused MLP.  #1's blocks at stages 0 and 1
// (C 96-256) take the fused MLP; #2's pairs (C 384 and 512) and #1's stages 2
// and 3 the two products.
#include <cmath>
#include <cstddef>

#include <cuda_runtime.h>

#include "launches.h"

namespace {

constexpr int kWeights = 12;  // a block's, in the order of launches.h's Weight

struct Scratch {
  bf16 *h, *qkv, *o, *x2, *g, *mid;
  float *mu, *rstd;
};

// may the MLP half run on the fused kernel (mlp_sm90.cu)?
bool fused_mlp(int C, int hidden) { return C <= 256 && C % 16 == 0 && hidden % 8 == 0; }

Scratch layout(Arena& a, long long rows, int C, int hidden, int blocks) {
  Scratch r;
  r.h = a.take<bf16>(rows * C);
  r.qkv = a.take<bf16>(3 * rows * C);
  r.o = a.take<bf16>(rows * C);
  r.x2 = a.take<bf16>(rows * C);
  r.g = fused_mlp(C, hidden) ? nullptr : a.take<bf16>(rows * hidden);
  r.mid = blocks > 1 ? a.take<bf16>(rows * C) : nullptr;
  r.mu = a.take<float>(rows);
  r.rstd = a.take<float>(rows);
  return r;
}

// One block, x -> y (R*N rows of C); mbd = (dtype, s0, s1, s2, s3, P) of mb
int block(const void* x, const void* const* w, const void* mb, const int* mbd, const int* map,
          int map_len, void* y, const Scratch& r, int R, int N, int C, int hidden, int H,
          int ln_stats_on, int gelu_on, void* stream) {
  const int rows = R * N, hd = C / H;
  TRY(mumpy_ln_rows(x, w[kLn1G], w[kLn1B], r.h, r.mu, r.rstd, rows, C, ln_stats_on, kBF16,
                    stream));
  TRY(mumpy_gemm_rows(r.h, w[kWqkv], w[kBqkv], nullptr, nullptr, nullptr, r.qkv, nullptr, nullptr,
                      map, nullptr, map_len, rows, 3 * C, C, 0, 0, 1, 1, stream));
  TRY(mumpy_window_attention(r.qkv, r.qkv + C, r.qkv + 2 * C, r.o, mb, R, N, H, hd, R, 3 * C,
                             3 * C, 3 * C, C, mbd[5], mbd[0], mbd[1], mbd[2], mbd[3], mbd[4],
                             1.f / std::sqrt((float)hd), kBF16, stream));
  TRY(mumpy_gemm_rows(r.o, w[kWproj], w[kBproj], x, nullptr, nullptr, nullptr, r.x2, nullptr,
                      nullptr, map, map_len, rows, C, C, 0, 0, 1, 1, stream));
  if (fused_mlp(C, hidden))
    return mumpy_mlp_rows(r.x2, w[kLn2G], w[kLn2B], w[kW1], w[kB1], w[kW2], w[kB2], y, rows, C,
                          hidden, ln_stats_on, gelu_on, stream);
  TRY(mumpy_ln_rows(r.x2, w[kLn2G], w[kLn2B], r.h, r.mu, r.rstd, rows, C, ln_stats_on, kBF16,
                    stream));
  TRY(mumpy_gemm_sm90(r.h, w[kW1], w[kB1], nullptr, nullptr, nullptr, r.g, nullptr, nullptr, rows,
                      hidden, C, 0, 1, 1, 1, stream));
  TRY(mumpy_gemm_sm90(r.g, w[kW2], w[kB2], r.x2, nullptr, nullptr, nullptr, y, nullptr, rows, C,
                      hidden, 0, 0, 1, 1, stream));
  return 0;
}

}  // namespace

extern "C" long long mumpy_swin_blocks_scratch(int R, int N, int C, int hidden, int blocks) {
  if (R <= 0 || N <= 0 || C <= 0 || hidden <= 0 || blocks < 1 || blocks > 2) return -1;
  Arena a{nullptr, 0};
  layout(a, (long long)R * N, C, hidden, blocks);
  return (long long)a.used + 256;  // and the base's alignment
}

// `blocks` (1 or 2) Swin blocks in turn on x (R windows of N tokens, C
// channels, H heads): w holds 12 weights a block, mb one mask+bias a block,
// mb_desc six ints a block (dtype, the four element strides, the period P);
// map (null, or map_len rows) is the first block's row map.
extern "C" int mumpy_swin_blocks_fwd(const void* x, int blocks, const void* const* w,
                                     const void* const* mb, const int* mb_desc, const int* map,
                                     int map_len, void* y, void* scratch, int R, int N, int C,
                                     int hidden, int H, int ln_stats_on, int gelu_on,
                                     void* stream) {
  if (R <= 0 || N <= 0 || C <= 0 || hidden <= 0 || H <= 0 || C % H || blocks < 1 ||
      blocks > 2 || scratch == nullptr || (map != nullptr && map_len <= 0))
    return (int)cudaErrorInvalidValue;
  Arena a{aligned256(scratch), 0};
  const Scratch r = layout(a, (long long)R * N, C, hidden, blocks);
  const void* in = x;
  for (int b = 0; b < blocks; ++b) {
    void* out = b + 1 < blocks ? static_cast<void*>(r.mid) : y;
    TRY(block(in, w + kWeights * b, mb[b], mb_desc + 6 * b, b == 0 ? map : nullptr, map_len, out,
              r, R, N, C, hidden, H, ln_stats_on, gelu_on, stream));
    in = out;
  }
  return 0;
}
