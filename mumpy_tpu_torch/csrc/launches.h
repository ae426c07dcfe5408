// The C entry points of the kernel sources that swin_block_train.cu,
// swin_pair.cu, vit3_sm90.cu and cva_sm90.cu launch in sequence (each defined
// in the source named beside it).  Every one launches on `stream` and returns cudaGetLastError().  Then
// what both sequence files use: the weight order of a Swin block, the scratch
// arena and the error check.
#pragma once

#include <cstddef>

extern "C" {

// train_rows.cu
int mumpy_ln_rows(const void* x, const void* g, const void* b, void* h, float* mu, float* rstd,
                  int rows, int C, int stats_on, int dtype, void* stream);
int mumpy_ln_bwd_rows(const void* x, const float* mu, const float* rstd, const void* g,
                      const void* dh, const void* dres, void* dx, int rows, int C, int dtype,
                      void* stream);
int mumpy_scale_add_rows(const void* a, const void* b, const float* s, void* out, int rows,
                         int C, int div, int dtype, void* stream);

// gemm_sm90.cu
int mumpy_gemm_rows(const void* a, const void* b, const void* bias, const void* res,
                    const float* row_scale, const void* aux, void* y, void* out, void* aux_out,
                    const int* a_map, const int* c_map, int map_len, int M, int N, int K,
                    int b_kmajor, int act, int scale_div, int row_scale_on, void* stream);
int mumpy_gemm_sm90(const void* a, const void* b, const void* bias, const void* res,
                    const float* row_scale, const void* aux, void* y, void* out, void* aux_out,
                    int M, int N, int K, int b_kmajor, int act, int scale_div, int row_scale_on,
                    void* stream);
int mumpy_gemm_sm90_tn(const void* a, const void* b, float* ws, void* dw, void* db, int rows,
                       int M, int N, int rows_per_split, void* stream);

// mlp_sm90.cu
int mumpy_mlp_rows(const void* x, const void* ln_g, const void* ln_b, const void* w1,
                   const void* b1, const void* w2, const void* b2, void* y, int M, int C,
                   int hidden, int ln_stats_on, int gelu_on, void* stream);

// swin_pair.cu: #4 in one call (its scratch, then the launches)
long long mumpy_ln_mlp_scratch(int M, int C, int hidden);
int mumpy_ln_mlp_fwd(const void* x, const void* const* w, void* y, void* scratch, int M, int C,
                     int hidden, int ln_stats_on, int gelu_on, void* stream);

// vit3_attention.cu, cva_sample.cu
int mumpy_vit3_attention(const void* qkv, void* o, int R, int H, int hd, float scale, int dtype,
                         void* stream);
int mumpy_cva_sample(const void* x2, const void* gy, const void* gx, void* s, int R, int B1,
                     int N, int C, int groups, int ws, int sample_on, int dtype, void* stream);

// attn_sm90.cu
int mumpy_attn_rows(const void* x, const void* ln_g, const void* ln_b, const void* w_qkv,
                    const void* b_qkv, const void* w_proj, const void* b_proj, const void* mb,
                    int mb_dtype, int mb_s0, int mb_s1, int mb_s2, int mb_s3, int P, void* y,
                    void* out, int R, int N, int C, int H, int ln_stats_on, int key_mask_on,
                    void* stream);

// window_attention.cu, window_attention_bwd.cu
int mumpy_window_attention(const void* q, const void* k, const void* v, void* o, const void* mb,
                           int R, int N, int H, int hd, int q_mod, int ldq, int ldk, int ldv,
                           int ldo, int P, int mb_dtype, int mb_s0, int mb_s1, int mb_s2,
                           int mb_s3, float scale, int dtype, void* stream);
int mumpy_window_attention_fold(const void* q, const void* k, const void* v, void* o, int R,
                                int N, int H, int hd, int q_mod, int ldq, int ldk, int ldv,
                                int ldo, int fold, int fold_on, float scale, int dtype,
                                void* stream);
int mumpy_window_attention_bwd(const void* qkv, const void* dout, const void* mb, void* dqkv,
                               void* o, float* dmb, int R, int N, int H, int hd, int P,
                               int mb_dtype, int mb_s0, int mb_s1, int mb_s2, int mb_s3, int chunks,
                               float scale, int rowsum, int dtype, void* stream);

// wgrad.cu
int mumpy_col_sums(const void* dh, const void* x, const float* mu, const float* rstd,
                   float* ws, void* dg, void* db, int rows, int C, int rows_per_split,
                   int dtype, void* stream);
int mumpy_reduce_splits(const float* ws, int n, const long long* desc, void* const* outs,
                        void* stream);
}

namespace {

constexpr int kBF16 = 1;
// a Swin block's 12 weights, in the order the sequences take them
enum Weight { kLn1G, kLn1B, kWqkv, kBqkv, kWproj, kBproj, kLn2G, kLn2B, kW1, kB1, kW2, kB2 };

using bf16 = unsigned short;  // storage only: the launches take void*

// 256-byte aligned regions of the scratch buffer; with a null base it only
// counts the bytes
struct Arena {
  char* base;
  size_t used;
  template <typename T> T* take(size_t n) {
    const size_t off = (used + 255) & ~size_t(255);
    used = off + n * sizeof(T);
    return base == nullptr ? nullptr : reinterpret_cast<T*>(base + off);
  }
};

char* aligned256(void* p) {
  const size_t a = reinterpret_cast<size_t>(p);
  return reinterpret_cast<char*>((a + 255) & ~size_t(255));
}

#define TRY(call)                        \
  do {                                   \
    const int err_ = (int)(call);        \
    if (err_ != 0) return err_;          \
  } while (0)

}  // namespace
