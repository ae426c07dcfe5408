// The bf16 launch sequences of the whole-block training kernel
// (ops/swin_block_train.py, #8), of attn_ln_train (ops/attn_ln_train.py, #9)
// and of ln_mlp_train (ops/ln_mlp_train.py, #10), forward and backward: one
// call from Python each, which launches every kernel of the sequence in turn
// on the caller's stream, the intermediates in one scratch buffer that the
// caller allocates (mumpy_swin_block_train_scratch,
// mumpy_attn_ln_train_scratch and mumpy_ln_mlp_train_scratch give its size).
// #8's backward is #9's (attn_bwd) and #10's (mlp_bwd) backward halves; #9
// and #10 each add their own reduce_splits launch.  #9 replaces
// mumpy_tpu/ops/pallas/attn_ln_vjp.py:fused_attn_ln_train (_fwd_kernel,
// _bwd_kernel), #10 mumpy_tpu/ops/pallas/ln_mlp_vjp.py:fused_ln_mlp_train
// (_fwd_kernel, _bwd_kernel).
//
// Replaces, with the kernels it launches, mumpy_tpu/ops/pallas/
// swin_block_vjp.py:fused_block_train (_train_fwd_kernel, _train_bwd_kernel,
// _train_bwd_dw_kernel).  The sequences are the ones ops/swin_block_train.py,
// ops/attn_ln_train.py and ops/ln_mlp_train.py compose in Python for f32;
// bf16 takes them from here because a 12-clip step runs the block 48 times
// forward and backward, some 30 launches each, and #9 12 times with some 20,
// and from Python every launch costs tens of microseconds of host time, more
// than the device time of most of them (PERF.md §6).  Here a launch costs a
// few microseconds.  Every product reads the torch weights as stored.
//
// Forward (x (R*N, C), the (P, H, N, N) mask+bias mb, the keep factors keep1
// and keep2 per window of N rows, the 12 weights as torch stores them):
//   h1 = LN1(x); qkv = h1 Wqkv^T + bqkv; o = attention(qkv, mb);
//   x2 = x + keep1 * (o Wproj^T + bproj); h2 = LN2(x2);
//   g = gelu(h2 W1^T + b1); y = x2 + keep2 * (g W2^T + b2)
// (#9's forward is its first line and (y, out) = (o Wproj^T + bproj, x + keep
// * y).)
// Backward (dy), recomputing h1, qkv, o, x2, h2 and f1 = h2 W1^T + b1:
//   df2 = keep2 * dy; df1 = (df2 W2) * gelu'(f1), g = gelu(f1); dh2 = df1 W1;
//   dx2 = dy + LN2'(dh2); dproj = keep1 * dx2; do = dproj Wproj;
//   dqkv, d(mb) = the attention backward; dh1 = dqkv Wqkv; dx = dx2 + LN1'(dh1);
//   then both halves' LayerNorm, weight and bias gradients as row-split sums
//   (col_sums, the TN GEMM) that one reduce_splits launch adds in split
//   order, with d(mb), summed over the windows in f32, cast to mb's dtype in
//   the same launch.
// (#9's backward recomputes h1 and qkv only: dproj = dy + keep * dout, and
// the attention backward's core also gives o = T(P) V, which the projection's
// weight gradient reads, from the P it forms anyway: no forward core runs.)
// The planted faults of the checks: rowsum = 0 (the softmax backward without
// its rowsum term), gelu_grad = 0 (gelu' replaced by 1 and g left 0),
// row_scale_on = 0 (the recompute of x2 ignoring keep1).
#include <algorithm>
#include <cmath>
#include <cstddef>

#include <cuda_runtime.h>

#include "launches.h"

namespace {

constexpr int kSplitBlocks = 264;  // cuda_lib._SPLIT_BLOCKS: blocks a row-split sum aims for
constexpr int kAttnBlocks = 1056;  // cuda_lib.window_attention_bwd's blocks
// cuda_lib._rows_per_split: enough splits that `blocks` blocks per split fill
// about kSplitBlocks, each split at least 256 rows
int rows_per_split(long long rows, int blocks) {
  const long long splits =
      std::max(1LL, std::min((long long)(kSplitBlocks + blocks - 1) / blocks, rows / 256));
  return (int)((rows + splits - 1) / splits);
}

struct Dims {
  int R, N, C, hidden, H, P;
  long long rows() const { return (long long)R * N; }
};

// One row-split sum of the backward: `splits` f32 partials of `len` floats
// in ws (none with one split: the launch then writes the gradient itself)
struct Sum {
  int per, splits;
  long long len;
  float* ws;
};

Sum plan_sum(Arena& a, long long rows, long long len, int blocks) {
  Sum s;
  s.per = rows_per_split(rows, blocks);
  s.splits = (int)((rows + s.per - 1) / s.per);
  s.len = len;
  s.ws = s.splits > 1 ? a.take<float>((size_t)s.splits * len) : nullptr;
  return s;
}

int tn_blocks(int o, int i) { return ((o + 63) / 64) * ((i + 127) / 128); }  // 64 x 128 tiles

struct Fwd {
  bf16 *h, *qkv, *o, *x2, *g;
  float *mu, *rstd;
};

Fwd fwd_layout(Arena& a, const Dims& d) {
  const size_t rc = d.rows() * d.C;
  Fwd r;
  r.h = a.take<bf16>(rc);  // LN1(x), then LN2(x2)
  r.qkv = a.take<bf16>(3 * rc);
  r.o = a.take<bf16>(rc);
  r.x2 = a.take<bf16>(rc);
  r.g = a.take<bf16>(d.rows() * d.hidden);
  r.mu = a.take<float>(d.rows());
  r.rstd = a.take<float>(d.rows());
  return r;
}

// The MLP half's backward (ln_mlp_train's, and swin_block_train's second
// half): its recomputed and gradient rows and its three row-split sums
struct MlpBwd {
  bf16 *h, *f1, *df2, *g, *df1, *dh;
  float *mu, *rstd;
  Sum ln, w1, w2;
};

MlpBwd mlp_bwd_layout(Arena& a, long long rows, int C, int hid) {
  const size_t rc = rows * C, rh = rows * hid;
  MlpBwd r;
  r.h = a.take<bf16>(rc);
  r.f1 = a.take<bf16>(rh);
  r.df2 = a.take<bf16>(rc);
  r.g = a.take<bf16>(rh);
  r.df1 = a.take<bf16>(rh);
  r.dh = a.take<bf16>(rc);
  r.mu = a.take<float>(rows);
  r.rstd = a.take<float>(rows);
  r.ln = plan_sum(a, rows, 2LL * C, (C + 31) / 32);
  r.w1 = plan_sum(a, rows, (long long)hid * C + hid, tn_blocks(hid, C));  // dW1 (hidden, C)
  r.w2 = plan_sum(a, rows, (long long)C * hid + C, tn_blocks(C, hid));    // dW2 (C, hidden)
  return r;
}

// The attention half's backward (attn_ln_train's, and swin_block_train's
// first half): its recomputed and gradient rows, d(mb) in f32 and its three
// row-split sums
struct AttnBwd {
  bf16 *h1, *qkv, *o, *dproj, *dout, *dqkv, *dh1;
  float *mu, *rstd, *dmb;
  Sum ln, wqkv, wproj;
};

AttnBwd attn_bwd_layout(Arena& a, const Dims& d) {
  const long long rows = d.rows();
  const size_t rc = rows * d.C;
  const int C = d.C;
  AttnBwd r;
  r.h1 = a.take<bf16>(rc);
  r.qkv = a.take<bf16>(3 * rc);
  r.o = a.take<bf16>(rc);
  r.dproj = a.take<bf16>(rc);
  r.dout = a.take<bf16>(rc);
  r.dqkv = a.take<bf16>(3 * rc);
  r.dh1 = a.take<bf16>(rc);
  r.mu = a.take<float>(rows);
  r.rstd = a.take<float>(rows);
  r.dmb = a.take<float>((size_t)d.P * d.H * d.N * d.N);
  r.ln = plan_sum(a, rows, 2LL * C, (C + 31) / 32);
  r.wqkv = plan_sum(a, rows, 3LL * C * C + 3 * C, tn_blocks(3 * C, C));
  r.wproj = plan_sum(a, rows, (long long)C * C + C, tn_blocks(C, C));
  return r;
}

struct Bwd {
  AttnBwd attn;
  bf16 *x2, *dx2;
  MlpBwd mlp;
};

Bwd bwd_layout(Arena& a, const Dims& d) {
  const size_t rc = d.rows() * d.C;
  Bwd r;
  r.attn = attn_bwd_layout(a, d);
  r.x2 = a.take<bf16>(rc);
  r.dx2 = a.take<bf16>(rc);
  r.mlp = mlp_bwd_layout(a, d.rows(), d.C, d.hidden);
  return r;
}

// the attention half's dimensions (hidden unused), then the whole block's
bool bad_attn_dims(const Dims& d) {
  return d.R <= 0 || d.N <= 0 || d.C <= 0 || d.H <= 0 || d.C % d.H || d.P <= 0 || d.R % d.P;
}
bool bad_dims(const Dims& d) { return bad_attn_dims(d) || d.hidden <= 0; }

// o = attention(qkv, mb) on the packed (R*N, 3C) rows, as
// cuda_lib.packed_window_attention launches it
int attention(const bf16* qkv, bf16* o, const Dims& d, const void* mb, int mb_dtype,
              const int* s, void* stream) {
  const int C = d.C, hd = C / d.H;
  return mumpy_window_attention(qkv, qkv + C, qkv + 2 * C, o, mb, d.R, d.N, d.H, hd, d.R,
                                3 * C, 3 * C, 3 * C, C, d.P, mb_dtype, s[0], s[1], s[2], s[3],
                                1.f / std::sqrt((float)hd), kBF16, stream);
}


// The MLP half's backward (ln_mlp_train's), from its input x (rows, C) and
// output gradient dy with the keep factor per `div` rows, its six weights
// w and gradients dw in the order (ln_g, ln_b, w1, b1, w2, b2), torch
// layouts: recompute h = LN(x) and f1 = h W1^T + b1; df2 = keep * dy;
// df1 = (df2 W2) * gelu'(f1), g = gelu(f1); dh = df1 W1; dx = dy + LN'(dh);
// the LayerNorm, weight and bias sums into m's row splits (or into dw with
// one split), which the caller's reduce_splits launch adds.
int mlp_bwd(const void* x, const void* dy, const float* keep, int div, const void* const* w,
            void* dx, void* const* dw, const MlpBwd& m, int rows, int C, int hidden,
            int gelu_grad, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  TRY(mumpy_ln_rows(x, w[0], w[1], m.h, m.mu, m.rstd, rows, C, 1, kBF16, stream));
  TRY(mumpy_gemm_sm90(m.h, w[2], w[3], nullptr, nullptr, nullptr, m.f1, nullptr, nullptr, rows,
                      hidden, C, 1, 0, 1, 1, stream));
  TRY(mumpy_scale_add_rows(nullptr, dy, keep, m.df2, rows, C, div, kBF16, stream));
  if (gelu_grad) {
    TRY(mumpy_gemm_sm90(m.df2, w[4], nullptr, nullptr, nullptr, m.f1, m.df1, nullptr, m.g, rows,
                        hidden, C, 0, 2, 1, 1, stream));
  } else {  // the planted fault: gelu' = 1, and g left 0
    TRY(cudaMemsetAsync(m.g, 0, (size_t)rows * hidden * sizeof(bf16), st));
    TRY(mumpy_gemm_sm90(m.df2, w[4], nullptr, nullptr, nullptr, nullptr, m.df1, nullptr, nullptr,
                        rows, hidden, C, 0, 0, 1, 1, stream));
  }
  TRY(mumpy_gemm_sm90(m.df1, w[2], nullptr, nullptr, nullptr, nullptr, m.dh, nullptr, nullptr,
                      rows, C, hidden, 0, 0, 1, 1, stream));
  TRY(mumpy_ln_bwd_rows(x, m.mu, m.rstd, w[0], m.dh, dy, dx, rows, C, kBF16, stream));
  TRY(mumpy_col_sums(m.dh, x, m.mu, m.rstd, m.ln.ws, dw[0], dw[1], rows, C, m.ln.per, kBF16,
                     stream));
  TRY(mumpy_gemm_sm90_tn(m.df1, m.h, m.w1.ws, dw[2], dw[3], rows, hidden, C, m.w1.per, stream));
  TRY(mumpy_gemm_sm90_tn(m.df2, m.g, m.w2.ws, dw[4], dw[5], rows, C, hidden, m.w2.per, stream));
  return 0;
}

// The attention half's recompute from its input x: h1 = LN1(x) with its row
// statistics, qkv = h1 Wqkv^T + bqkv (w: the block's weights, from kLn1G)
int attn_recompute(const void* x, const void* const* w, const AttnBwd& r, const Dims& d,
                   void* stream) {
  const int rows = d.R * d.N, C = d.C;
  TRY(mumpy_ln_rows(x, w[kLn1G], w[kLn1B], r.h1, r.mu, r.rstd, rows, C, 1, kBF16, stream));
  return mumpy_gemm_sm90(r.h1, w[kWqkv], w[kBqkv], nullptr, nullptr, nullptr, r.qkv, nullptr,
                         nullptr, rows, 3 * C, C, 1, 0, 1, 1, stream);
}

// The attention half's backward (attn_ln_train's) from its recompute in r
// (attn_recompute, and o unless o_from_core) and the output gradient dproj =
// a + keep * b per window (a may be null: #9 a = dy, b = dout; #8 a = null, b
// = dx2): do = dproj Wproj; dqkv and d(mb) from the attention backward (with
// o_from_core also o = T(P) V, which the projection's weight gradient reads);
// dh1 = dqkv Wqkv; dx = b + LN1'(dh1); the LayerNorm, weight and bias sums
// into r's row splits (or into dw with one split) and d(mb) in f32 into r.dmb,
// which the caller's reduce_splits launch adds and casts.
int attn_bwd(const void* x, const void* a, const void* b, const float* keep, const void* mb,
             int mb_dtype, const int* s, const void* const* w, void* dx, void* const* dw,
             const AttnBwd& r, const Dims& d, bool o_from_core, int rowsum, void* stream) {
  const int rows = d.R * d.N, C = d.C, hd = C / d.H;
  TRY(mumpy_scale_add_rows(a, b, keep, r.dproj, rows, C, d.N, kBF16, stream));
  TRY(mumpy_gemm_sm90(r.dproj, w[kWproj], nullptr, nullptr, nullptr, nullptr, r.dout, nullptr,
                      nullptr, rows, C, C, 0, 0, 1, 1, stream));
  TRY(cudaMemsetAsync(r.dmb, 0, (size_t)d.P * d.H * d.N * d.N * sizeof(float),
                      static_cast<cudaStream_t>(stream)));
  const int chunks =
      std::max(1, std::min(d.R / d.P, (kAttnBlocks + d.H * d.P - 1) / (d.H * d.P)));
  TRY(mumpy_window_attention_bwd(r.qkv, r.dout, mb, r.dqkv, o_from_core ? r.o : nullptr, r.dmb,
                                 d.R, d.N, d.H, hd, d.P, mb_dtype, s[0], s[1], s[2], s[3], chunks,
                                 1.f / std::sqrt((float)hd), rowsum, kBF16, stream));
  TRY(mumpy_gemm_sm90(r.dqkv, w[kWqkv], nullptr, nullptr, nullptr, nullptr, r.dh1, nullptr,
                      nullptr, rows, C, 3 * C, 0, 0, 1, 1, stream));
  TRY(mumpy_ln_bwd_rows(x, r.mu, r.rstd, w[kLn1G], r.dh1, b, dx, rows, C, kBF16, stream));
  TRY(mumpy_col_sums(r.dh1, x, r.mu, r.rstd, r.ln.ws, dw[kLn1G], dw[kLn1B], rows, C, r.ln.per,
                     kBF16, stream));
  TRY(mumpy_gemm_sm90_tn(r.dqkv, r.h1, r.wqkv.ws, dw[kWqkv], dw[kBqkv], rows, 3 * C, C,
                         r.wqkv.per, stream));
  return mumpy_gemm_sm90_tn(r.dproj, r.o, r.wproj.ws, dw[kWproj], dw[kBproj], rows, C, C,
                            r.wproj.per, stream);
}

// The workspaces one reduce_splits launch adds, in split order: each with
// its two outputs (a weight and its bias, or a LayerNorm's scale and bias)
struct Reduce {
  const char* base;
  long long desc[5 * 8];
  void* outs[2 * 8];
  int n = 0;
  void add(const float* ws, int splits, long long len1, long long len2, int dtype, void* out1,
           void* out2) {
    const long long v[5] = {(long long)((const char*)ws - base) / 4, splits, len1, len2, dtype};
    std::copy(v, v + 5, desc + 5 * n);
    outs[2 * n] = out1;
    outs[2 * n + 1] = out2;
    ++n;
  }
  // a sum of more than one split; its first output holds len1 of its floats
  void add(const Sum& s, long long len1, void* out1, void* out2) {
    if (s.splits > 1) add(s.ws, s.splits, len1, s.len - len1, kBF16, out1, out2);
  }
  void add_mlp(const MlpBwd& m, int C, int hidden, void* const* dw) {
    add(m.ln, C, dw[0], dw[1]);
    add(m.w1, (long long)hidden * C, dw[2], dw[3]);
    add(m.w2, (long long)C * hidden, dw[4], dw[5]);
  }
  // the attention half's sums and d(mb), cast to mb's dtype
  void add_attn(const AttnBwd& r, const Dims& d, void* const* dw, void* dmb, int mb_dtype) {
    const int C = d.C;
    add(r.ln, C, dw[kLn1G], dw[kLn1B]);
    add(r.wqkv, 3LL * C * C, dw[kWqkv], dw[kBqkv]);
    add(r.wproj, (long long)C * C, dw[kWproj], dw[kBproj]);
    add(r.dmb, 1, (long long)d.P * d.H * d.N * d.N, 0, mb_dtype, dmb, nullptr);
  }
  int launch(void* stream) const {
    return n == 0 ? 0
                  : mumpy_reduce_splits(reinterpret_cast<const float*>(base), n, desc, outs,
                                        stream);
  }
};

}  // namespace

extern "C" long long mumpy_swin_block_train_scratch(int R, int N, int C, int hidden, int H,
                                                    int P, int backward) {
  const Dims d{R, N, C, hidden, H, P};
  if (bad_dims(d)) return -1;
  Arena a{nullptr, 0};
  if (backward) bwd_layout(a, d);
  else fwd_layout(a, d);
  return (long long)a.used + 256;  // and the base's alignment
}

extern "C" int mumpy_swin_block_train_fwd(const void* x, const void* mb, int mb_dtype,
                                          int mb_s0, int mb_s1, int mb_s2, int mb_s3,
                                          const float* keep1, const float* keep2,
                                          const void* const* w, void* y, void* scratch, int R,
                                          int N, int C, int hidden, int H, int P,
                                          void* stream) {
  const Dims d{R, N, C, hidden, H, P};
  if (bad_dims(d) || scratch == nullptr) return (int)cudaErrorInvalidValue;
  Arena a{aligned256(scratch), 0};
  const Fwd r = fwd_layout(a, d);
  const int rows = R * N, s[4] = {mb_s0, mb_s1, mb_s2, mb_s3};
  TRY(mumpy_ln_rows(x, w[kLn1G], w[kLn1B], r.h, r.mu, r.rstd, rows, C, 1, kBF16, stream));
  TRY(mumpy_gemm_sm90(r.h, w[kWqkv], w[kBqkv], nullptr, nullptr, nullptr, r.qkv, nullptr,
                      nullptr, rows, 3 * C, C, 1, 0, 1, 1, stream));
  TRY(attention(r.qkv, r.o, d, mb, mb_dtype, s, stream));
  TRY(mumpy_gemm_sm90(r.o, w[kWproj], w[kBproj], x, keep1, nullptr, nullptr, r.x2, nullptr,
                      rows, C, C, 1, 0, N, 1, stream));
  TRY(mumpy_ln_rows(r.x2, w[kLn2G], w[kLn2B], r.h, r.mu, r.rstd, rows, C, 1, kBF16, stream));
  TRY(mumpy_gemm_sm90(r.h, w[kW1], w[kB1], nullptr, nullptr, nullptr, r.g, nullptr, nullptr,
                      rows, hidden, C, 1, 1, 1, 1, stream));
  TRY(mumpy_gemm_sm90(r.g, w[kW2], w[kB2], r.x2, keep2, nullptr, nullptr, y, nullptr, rows, C,
                      hidden, 1, 0, N, 1, stream));
  return 0;
}

extern "C" int mumpy_swin_block_train_bwd(const void* x, const void* dy, const void* mb,
                                          int mb_dtype, int mb_s0, int mb_s1, int mb_s2,
                                          int mb_s3, const float* keep1, const float* keep2,
                                          const void* const* w, void* dx, void* dmb,
                                          void* const* dw, void* scratch, int R, int N, int C,
                                          int hidden, int H, int P, int rowsum, int gelu_grad,
                                          int row_scale_on, void* stream) {
  const Dims d{R, N, C, hidden, H, P};
  if (bad_dims(d) || scratch == nullptr) return (int)cudaErrorInvalidValue;
  char* base = aligned256(scratch);
  Arena a{base, 0};
  const Bwd r = bwd_layout(a, d);
  const int rows = R * N, s[4] = {mb_s0, mb_s1, mb_s2, mb_s3};

  // recompute the attention half from x, and x2 (keep1 as the row scale)
  TRY(attn_recompute(x, w, r.attn, d, stream));
  TRY(attention(r.attn.qkv, r.attn.o, d, mb, mb_dtype, s, stream));
  TRY(mumpy_gemm_sm90(r.attn.o, w[kWproj], w[kBproj], x, keep1, nullptr, nullptr, r.x2, nullptr,
                      rows, C, C, 1, 0, N, row_scale_on, stream));

  // the MLP half (ln_mlp_train's backward with keep2 per window)
  TRY(mlp_bwd(r.x2, dy, keep2, N, w + kLn2G, r.dx2, dw + kLn2G, r.mlp, rows, C, hidden,
              gelu_grad, stream));

  // the attention half (attn_ln_train's backward with dproj = keep1 * dx2)
  TRY(attn_bwd(x, nullptr, r.dx2, keep1, mb, mb_dtype, s, w, dx, dw, r.attn, d, false, rowsum,
               stream));

  // one launch: every split sum in split order, and d(mb) cast to mb's dtype
  Reduce red{base};
  red.add_mlp(r.mlp, C, hidden, dw + kLn2G);
  red.add_attn(r.attn, d, dw, dmb, mb_dtype);
  return red.launch(stream);
}

// ---- attn_ln_train (#9): (y, x + keep * y), y = proj(MSA(LN x) + mb), bf16 ----

extern "C" long long mumpy_attn_ln_train_scratch(int R, int N, int C, int H, int P,
                                                 int backward) {
  const Dims d{R, N, C, 0, H, P};
  if (bad_attn_dims(d)) return -1;
  Arena a{nullptr, 0};
  if (backward) {
    attn_bwd_layout(a, d);
  } else {
    const size_t rc = d.rows() * C;
    a.take<bf16>(rc);      // h
    a.take<bf16>(3 * rc);  // qkv
    a.take<bf16>(rc);      // o
    a.take<float>(2 * (size_t)d.rows());  // mu, rstd
  }
  return (long long)a.used + 256;
}

// The forward: h = LN(x) (one row pass), qkv = h Wqkv^T + bqkv, o =
// attention(qkv, mb), then the projection's epilogue writes y = T(o Wproj^T +
// bproj) and out = T(x + keep[window] * (o Wproj^T + bproj)); w holds the six
// weights (ln_g, ln_b, w_qkv, b_qkv, w_proj, b_proj) as torch stores them.
extern "C" int mumpy_attn_ln_train_fwd(const void* x, const void* mb, int mb_dtype, int mb_s0,
                                       int mb_s1, int mb_s2, int mb_s3, const float* keep,
                                       const void* const* w, void* y, void* out, void* scratch,
                                       int R, int N, int C, int H, int P, void* stream) {
  const Dims d{R, N, C, 0, H, P};
  if (bad_attn_dims(d) || scratch == nullptr) return (int)cudaErrorInvalidValue;
  Arena a{aligned256(scratch), 0};
  const size_t rc = d.rows() * C;
  bf16* h = a.take<bf16>(rc);
  bf16* qkv = a.take<bf16>(3 * rc);
  bf16* o = a.take<bf16>(rc);
  float* mu = a.take<float>(d.rows());
  float* rstd = a.take<float>(d.rows());
  const int rows = R * N, s[4] = {mb_s0, mb_s1, mb_s2, mb_s3};
  TRY(mumpy_ln_rows(x, w[kLn1G], w[kLn1B], h, mu, rstd, rows, C, 1, kBF16, stream));
  TRY(mumpy_gemm_sm90(h, w[kWqkv], w[kBqkv], nullptr, nullptr, nullptr, qkv, nullptr, nullptr,
                      rows, 3 * C, C, 1, 0, 1, 1, stream));
  TRY(attention(qkv, o, d, mb, mb_dtype, s, stream));
  return mumpy_gemm_sm90(o, w[kWproj], w[kBproj], x, keep, nullptr, y, out, nullptr, rows, C, C,
                         1, 0, N, 1, stream);
}

// The backward from (dy, dout) (dy may be null), recomputing h1 and qkv
// (attn_recompute) with o from the backward's core (attn_bwd), then one
// reduce_splits launch; the gradients of x, mb (its dtype) and the six
// weights.
extern "C" int mumpy_attn_ln_train_bwd(const void* x, const void* dy, const void* dout,
                                       const void* mb, int mb_dtype, int mb_s0, int mb_s1,
                                       int mb_s2, int mb_s3, const float* keep,
                                       const void* const* w, void* dx, void* dmb, void* const* dw,
                                       void* scratch, int R, int N, int C, int H, int P,
                                       int rowsum, void* stream) {
  const Dims d{R, N, C, 0, H, P};
  if (bad_attn_dims(d) || scratch == nullptr || dout == nullptr)
    return (int)cudaErrorInvalidValue;
  char* base = aligned256(scratch);
  Arena a{base, 0};
  const AttnBwd r = attn_bwd_layout(a, d);
  const int s[4] = {mb_s0, mb_s1, mb_s2, mb_s3};
  TRY(attn_recompute(x, w, r, d, stream));
  TRY(attn_bwd(x, dy, dout, keep, mb, mb_dtype, s, w, dx, dw, r, d, true, rowsum, stream));
  Reduce red{base};
  red.add_attn(r, d, dw, dmb, mb_dtype);
  return red.launch(stream);
}

// ---- ln_mlp_train (#10): x + keep * fc2(gelu(fc1(LN x))), bf16 ----

extern "C" long long mumpy_ln_mlp_train_scratch(int rows, int C, int hidden, int backward) {
  if (rows <= 0 || C <= 0 || hidden <= 0) return -1;
  Arena a{nullptr, 0};
  if (backward) {
    mlp_bwd_layout(a, rows, C, hidden);
  } else {
    a.take<bf16>((size_t)rows * C);       // h
    a.take<bf16>((size_t)rows * hidden);  // g
    a.take<float>(2 * (size_t)rows);      // mu, rstd
  }
  return (long long)a.used + 256;
}

// The forward: h = LN(x) (one row pass), g = gelu(h W1^T + b1), out =
// T(x + keep[m / div] (g W2^T + b2)); the weights read as stored.
extern "C" int mumpy_ln_mlp_train_fwd(const void* x, const float* keep, const void* const* w,
                                      void* out, void* scratch, int rows, int C, int hidden,
                                      int div, void* stream) {
  if (rows <= 0 || C <= 0 || hidden <= 0 || div <= 0 || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  Arena a{aligned256(scratch), 0};
  bf16* h = a.take<bf16>((size_t)rows * C);
  bf16* g = a.take<bf16>((size_t)rows * hidden);
  float* mu = a.take<float>(rows);
  float* rstd = a.take<float>(rows);
  TRY(mumpy_ln_rows(x, w[0], w[1], h, mu, rstd, rows, C, 1, kBF16, stream));
  TRY(mumpy_gemm_sm90(h, w[2], w[3], nullptr, nullptr, nullptr, g, nullptr, nullptr, rows, hidden,
                      C, 1, 1, 1, 1, stream));
  TRY(mumpy_gemm_sm90(g, w[4], w[5], x, keep, nullptr, nullptr, out, nullptr, rows, C, hidden, 1,
                      0, div, 1, stream));
  return 0;
}

// The backward, recomputing from x (mlp_bwd), then one reduce_splits launch.
extern "C" int mumpy_ln_mlp_train_bwd(const void* x, const void* dy, const float* keep,
                                      const void* const* w, void* dx, void* const* dw,
                                      void* scratch, int rows, int C, int hidden, int div,
                                      int gelu_grad, void* stream) {
  if (rows <= 0 || C <= 0 || hidden <= 0 || div <= 0 || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  char* base = aligned256(scratch);
  Arena a{base, 0};
  const MlpBwd m = mlp_bwd_layout(a, rows, C, hidden);
  TRY(mlp_bwd(x, dy, keep, div, w, dx, dw, m, rows, C, hidden, gelu_grad, stream));
  Reduce red{base};
  red.add_mlp(m, C, hidden, dw);
  return red.launch(stream);
}
