// The bf16 launch sequences of the serving Swin blocks: #2's pair (a shifted
// block, then a plain one), #1's plain block, and the two halves of the
// cross-view blocks, #3 (the attention half) and #4 (the MLP tail), one call
// from Python each, which launches every kernel of the sequence in turn on
// the caller's stream, the intermediates in one scratch buffer that the
// caller allocates (the *_scratch entry points give its size).
//
// Replaces, with the kernels it launches, mumpy_tpu/ops/pallas/swin_pair.py:
// fused_pair_prepared (_pair_kernel), swin_block.py:fused_swin_block_prepared
// (_block_kernel), attn_ln.py:fused_attn_ln_prepared (_attn_kernel) and
// ln_mlp.py:fused_ln_mlp (_kernel), which run a whole pair, block or half in
// one launch with its weights in VMEM.  Each block on x (R*N, C), its 12
// weights as the serving operands store them (ln1_g, ln1_b, w_qkv (C, 3C),
// b_qkv, w_proj (C, C), b_proj, ln2_g, ln2_b, w1 (C, hidden), b1, w2 (hidden,
// C), b2) and its (P, H, N, N) mask+bias:
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
// #3 is the attention half with its weights (ln_g, ln_b, w_qkv as torch
// stores it (3C, C), b_qkv, w_proj (C, C), b_proj), writing y = o Wproj +
// bproj and out = x + y: at C <= 256 (head width 32, N <= 64) one launch of
// attn_sm90.cu, qkv and o on chip; wider, the block's four launches.  #4 is
// the MLP half alone: the fused MLP where the block takes it, else its three
// launches.  key_mask_on = 0 (the fused attention only) leaves the pad keys
// unmasked, a planted fault.
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

// may #3's attention half run on the fused kernel (attn_sm90.cu)?
bool fused_attn(int N, int C, int H) { return N <= 64 && C <= 256 && C == 32 * H; }

enum Part { kAttn = 1, kMlp = 2, kBlock = 4, kPair = 8 };

// the scratch of the launches `parts` needs on `rows` rows
Scratch layout(Arena& a, long long rows, int C, int hidden, int parts) {
  Scratch r{};
  r.h = a.take<bf16>(rows * C);
  if (parts & kAttn) {
    r.qkv = a.take<bf16>(3 * rows * C);
    r.o = a.take<bf16>(rows * C);
  }
  if (parts & kBlock) r.x2 = a.take<bf16>(rows * C);
  if ((parts & kMlp) && !fused_mlp(C, hidden)) r.g = a.take<bf16>(rows * hidden);
  if (parts & kPair) r.mid = a.take<bf16>(rows * C);
  r.mu = a.take<float>(rows);
  r.rstd = a.take<float>(rows);
  return r;
}

// The attention half's four launches on x (R*N rows of C), w its six weights
// (w_qkv (3C, C) with qkv_kmajor, else (C, 3C)), mbd = (dtype, s0, s1, s2,
// s3, P) of mb: y = o Wproj + bproj and out = x + y, each where not null,
// both rows through the map's c
int attention_half(const void* x, const void* const* w, int qkv_kmajor, const void* mb,
                   const int* mbd, const int* map, int map_len, void* y, void* out,
                   const Scratch& r, int R, int N, int C, int H, int ln_stats_on, void* stream) {
  const int rows = R * N, hd = C / H;
  TRY(mumpy_ln_rows(x, w[0], w[1], r.h, r.mu, r.rstd, rows, C, ln_stats_on, kBF16, stream));
  TRY(mumpy_gemm_rows(r.h, w[2], w[3], nullptr, nullptr, nullptr, r.qkv, nullptr, nullptr, map,
                      nullptr, map_len, rows, 3 * C, C, qkv_kmajor, 0, 1, 1, stream));
  TRY(mumpy_window_attention(r.qkv, r.qkv + C, r.qkv + 2 * C, r.o, mb, R, N, H, hd, R, 3 * C,
                             3 * C, 3 * C, C, mbd[5], mbd[0], mbd[1], mbd[2], mbd[3], mbd[4],
                             1.f / std::sqrt((float)hd), kBF16, stream));
  return mumpy_gemm_rows(r.o, w[4], w[5], x, nullptr, nullptr, y, out, nullptr, nullptr, map,
                         map_len, rows, C, C, 0, 0, 1, 1, stream);
}

// The MLP half on x (rows of C), w its six weights: y = x + fc2(gelu(fc1(LN
// x))), on the fused MLP where it takes the widths, else in three launches
int mlp_half(const void* x, const void* const* w, void* y, const Scratch& r, int rows, int C,
             int hidden, int ln_stats_on, int gelu_on, void* stream) {
  if (fused_mlp(C, hidden))
    return mumpy_mlp_rows(x, w[0], w[1], w[2], w[3], w[4], w[5], y, rows, C, hidden,
                          ln_stats_on, gelu_on, stream);
  TRY(mumpy_ln_rows(x, w[0], w[1], r.h, r.mu, r.rstd, rows, C, ln_stats_on, kBF16, stream));
  TRY(mumpy_gemm_sm90(r.h, w[2], w[3], nullptr, nullptr, nullptr, r.g, nullptr, nullptr, rows,
                      hidden, C, 0, 1, 1, 1, stream));
  return mumpy_gemm_sm90(r.g, w[4], w[5], x, nullptr, nullptr, nullptr, y, nullptr, rows, C,
                         hidden, 0, 0, 1, 1, stream);
}

// One block, x -> y (R*N rows of C); mbd = (dtype, s0, s1, s2, s3, P) of mb
int block(const void* x, const void* const* w, const void* mb, const int* mbd, const int* map,
          int map_len, void* y, const Scratch& r, int R, int N, int C, int hidden, int H,
          int ln_stats_on, int gelu_on, void* stream) {
  TRY(attention_half(x, w, 0, mb, mbd, map, map_len, nullptr, r.x2, r, R, N, C, H, ln_stats_on,
                     stream));
  return mlp_half(r.x2, w + kLn2G, y, r, R * N, C, hidden, ln_stats_on, gelu_on, stream);
}

}  // namespace

extern "C" long long mumpy_swin_blocks_scratch(int R, int N, int C, int hidden, int blocks) {
  if (R <= 0 || N <= 0 || C <= 0 || hidden <= 0 || blocks < 1 || blocks > 2) return -1;
  Arena a{nullptr, 0};
  layout(a, (long long)R * N, C, hidden, kAttn | kMlp | kBlock | (blocks > 1 ? kPair : 0));
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
  const Scratch r =
      layout(a, (long long)R * N, C, hidden, kAttn | kMlp | kBlock | (blocks > 1 ? kPair : 0));
  const void* in = x;
  for (int b = 0; b < blocks; ++b) {
    void* out = b + 1 < blocks ? static_cast<void*>(r.mid) : y;
    TRY(block(in, w + kWeights * b, mb[b], mb_desc + 6 * b, b == 0 ? map : nullptr, map_len, out,
              r, R, N, C, hidden, H, ln_stats_on, gelu_on, stream));
    in = out;
  }
  return 0;
}

// #3's scratch: none on the fused route
extern "C" long long mumpy_attn_ln_scratch(int R, int N, int C, int H) {
  if (R <= 0 || N <= 0 || C <= 0 || H <= 0) return -1;
  Arena a{nullptr, 0};
  if (!fused_attn(N, C, H)) layout(a, (long long)R * N, C, 0, kAttn);
  return (long long)a.used + 256;
}

// #3 on x (R windows of N tokens, C channels, H heads): y = proj(MSA(LN x) +
// mb) and out = x + y.  w: ln_g, ln_b, w_qkv (3C, C), b_qkv, w_proj (C, C)
// (in, out), b_proj; mb (P, H, N, N) in mb_dtype through its strides.
extern "C" int mumpy_attn_ln_fwd(const void* x, const void* const* w, const void* mb,
                                 int mb_dtype, int mb_s0, int mb_s1, int mb_s2, int mb_s3, int P,
                                 void* y, void* out, void* scratch, int R, int N, int C, int H,
                                 int ln_stats_on, int key_mask_on, void* stream) {
  if (R <= 0 || N <= 0 || C <= 0 || H <= 0 || C % H || P <= 0 || R % P || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  if (fused_attn(N, C, H))
    return mumpy_attn_rows(x, w[0], w[1], w[2], w[3], w[4], w[5], mb, mb_dtype, mb_s0, mb_s1,
                           mb_s2, mb_s3, P, y, out, R, N, C, H, ln_stats_on, key_mask_on, stream);
  Arena a{aligned256(scratch), 0};
  const Scratch r = layout(a, (long long)R * N, C, 0, kAttn);
  const int mbd[6] = {mb_dtype, mb_s0, mb_s1, mb_s2, mb_s3, P};
  return attention_half(x, w, 1, mb, mbd, nullptr, 0, y, out, r, R, N, C, H, ln_stats_on,
                        stream);
}

// #4's scratch: none on the fused route
extern "C" long long mumpy_ln_mlp_scratch(int M, int C, int hidden) {
  if (M <= 0 || C <= 0 || hidden <= 0) return -1;
  Arena a{nullptr, 0};
  if (!fused_mlp(C, hidden)) layout(a, M, C, hidden, kMlp);
  return (long long)a.used + 256;
}

// #4 on x (M rows of C): y = x + fc2(gelu(fc1(LN x))).  w: ln_g, ln_b, w1
// (C, hidden), b1, w2 (hidden, C), b2, (in, out) as the serving operands
// store them.
extern "C" int mumpy_ln_mlp_fwd(const void* x, const void* const* w, void* y, void* scratch,
                                int M, int C, int hidden, int ln_stats_on, int gelu_on,
                                void* stream) {
  if (M <= 0 || C <= 0 || hidden <= 0 || scratch == nullptr) return (int)cudaErrorInvalidValue;
  Arena a{aligned256(scratch), 0};
  const Scratch r = layout(a, M, C, hidden, kMlp);
  return mlp_half(x, w, y, r, M, C, hidden, ln_stats_on, gelu_on, stream);
}
