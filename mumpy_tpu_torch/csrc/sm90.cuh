// Hopper (sm_90a) building blocks shared by the persistent wgmma kernels
// (gemm_sm90.cu, mlp_sm90.cu, attn_sm90.cu): the wgmma synchronisation and
// shared-memory descriptors, mbarriers, TMA loads, the LayerNorm of rows in a
// landed A tile, and on the host the tensor maps (encoded
// through the runtime's driver entry point, so nothing new is linked), and
// the per-device SM count and shared-memory attribute.
#pragma once

#include <atomic>

#include <cuda.h>  // CUtensorMap and its encoder's types (found through the runtime)

#include "common.cuh"

namespace mumpy {

constexpr int kPanel = 64 * 128;  // one 64-row x 128-byte swizzle panel, bytes

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int N> __device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// keep wgmma A fragments (K-steps of 4 registers) in their registers until here
template <int N> __device__ __forceinline__ void fence_frags(unsigned (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// d (64 x 64, f32) += A (64 x 16) B (16 x 64), A from registers (warp w's
// rows 16w..16w+15 in mma_bf16's A-fragment layout), B K-major (kTransB = 0)
// or N-major (1) in shared memory.  A's registers must not change until the
// product is done.
template <int kTransB>
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32], const unsigned (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(kTransB));
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets, each in 16-byte units.  K-major: rows of
// 128 bytes (64 K values), 8-row groups 1024 bytes apart (stride), the
// leading offset unused.  M/N-major: rows of 128 bytes (64 M or N values) per
// K index, 8-K groups 1024 bytes apart (stride), 64-wide panels `lead` bytes
// apart.
__device__ __forceinline__ uint64_t smem_desc(unsigned addr, unsigned lead, unsigned stride) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lead & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((stride & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void mbar_init(unsigned addr, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(addr), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned addr, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(addr),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned addr) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(addr) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(unsigned addr, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(addr),
               "r"(bytes)
               : "memory");
}
// an arrive on the barrier once this thread's earlier cp.async copies land
__device__ __forceinline__ void cp_async_mbar_arrive(unsigned addr) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(addr) : "memory");
}
__device__ __forceinline__ void tma_load_2d(unsigned dst, const CUtensorMap* map, unsigned mbar,
                                           int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(mbar), "r"(c0), "r"(c1)
      : "memory");
}

// LayerNorm (f32 statistics, eps 1e-5) in place of the 16 rows row0..row0+15
// of a K-major A tile (tile_rows rows to a 64-column panel, 128-byte swizzle)
// whose raw bf16 rows a TMA landed: the first n_ok of them are real rows, the
// others are written zero.  Eight lanes take a row, four rows at a time: lane
// l holds 16-byte chunks l%8, l%8 + 8, ... (C <= 256, a multiple of 8) of row
// row0 + 4i + l/8, the sums joined by three shuffles.  stats_on = 0 takes mean
// 0 and rstd 1, the planted fault of the checks.  (A row across the whole
// warp, one row at a time, was a chain of ~700 cycles a row and a third of
// the fused attention half at C <= 128; two threads a row holding it in
// registers was slower at C = 256: PERF.md, Findings.)
__device__ __forceinline__ void ln_tile_rows(unsigned char* a_tile, int tile_rows, int row0,
                                             int n_ok, int C, const __nv_bfloat16* ln_g,
                                             const __nv_bfloat16* ln_b, int stats_on,
                                             int lane) {
  const int sub = lane & 7, nc = C / 8;
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int i = 4 * it + (lane >> 3), r = row0 + i;
    auto cell = [&](int c) {
      return reinterpret_cast<uint4*>(a_tile + (c >> 3) * (tile_rows * 128) + r * 128 +
                                      (((c & 7) ^ (r & 7)) << 4));
    };
    uint4 v[4];
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[k] = sub + 8 * k < nc ? *cell(sub + 8 * k) : make_uint4(0, 0, 0, 0);
      float f[8];
      unpack8(v[k], f);
#pragma unroll
      for (int e = 0; e < 8; ++e) s += f[e];
    }
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    float mu = s / C, q = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (sub + 8 * k < nc) {
        float f[8];
        unpack8(v[k], f);
#pragma unroll
        for (int e = 0; e < 8; ++e) q += (f[e] - mu) * (f[e] - mu);
      }
    }
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) q += __shfl_xor_sync(0xffffffffu, q, o);
    float rs = rsqrtf(q / C + 1e-5f);
    if (!stats_on) {
      mu = 0.f;
      rs = 1.f;
    }
    const bool row_ok = i < n_ok;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = sub + 8 * k;
      if (c < nc) {
        float f[8], g[8], b[8];
        unpack8(v[k], f);
        unpack8(ldg8(ln_g + 8 * c), g);
        unpack8(ldg8(ln_b + 8 * c), b);
#pragma unroll
        for (int e = 0; e < 8; ++e) f[e] = row_ok ? (f[e] - mu) * rs * g[e] + b[e] : 0.f;
        *cell(c) = pack8(f);
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found through the runtime's entry-point query so
// that nothing new is linked; null where it is missing.  Looked up once, in
// a static initialiser, which two launching threads cannot race through.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                             cudaEnableDefault, &q);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// Per-device launch state is indexed by the calling thread's current device
// (cudaGetDevice), so that one process may launch on several cards, from a
// thread each or in turn.
constexpr int kMaxDevices = 64;

// The SM count of the current device, read once per device (132 where it
// cannot be read: the grids only cap at it)
inline int sm_count() {
  static std::atomic<int> counts[kMaxDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return 132;
  int n = counts[dev].load(std::memory_order_relaxed);
  if (n == 0) {
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n <= 0)
      n = 132;
    counts[dev].store(n, std::memory_order_relaxed);
  }
  return n;
}

// A kernel's dynamic shared-memory limit, raised once on each device: the
// attribute belongs to the kernel as loaded on the current device, so a
// launch on a second card needs a call of its own.  Two threads on one
// device may both make the call (with the same value); the flag is set only
// after a call succeeded, and a failed call's error is returned, launch by
// launch.
struct SmemAttr {
  std::atomic<bool> done[kMaxDevices];

  template <typename Kernel>
  int raise(Kernel* kernel, int bytes) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
    if (done[dev].load(std::memory_order_acquire)) return 0;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    done[dev].store(true, std::memory_order_release);
    return 0;
  }
};

// A 2-D tensor map of a row-major (rows, cols) bf16 matrix, boxes of 64
// columns (one 128-byte swizzled line) by box_rows rows
inline int tensor_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                         strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace mumpy
