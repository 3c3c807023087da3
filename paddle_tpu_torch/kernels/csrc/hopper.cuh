// Hopper (sm_90a) building blocks of the port's tensor-core kernels:
// TMA tensor maps over [B, T, H, D] bf16 tensors, mbarriers, and the
// warpgroup matrix multiply `wgmma.mma_async` m64n64k16 bf16 -> f32 with
// its shared-memory descriptors.
//
// Shared-memory tiles are "atoms" of ROWS x 64 bf16: one 128-byte row per
// token, 64 head-dim columns, in the 128-byte swizzle that TMA writes
// (CU_TENSOR_MAP_SWIZZLE_128B) and the wgmma descriptors name (layout
// type 1). A head dim above 64 takes several atoms side by side; a head
// dim that is not a multiple of 64 is padded with the zeros TMA fills
// past the tensor's last column. Every atom starts on 1024 bytes, the
// period of the swizzle.
//
// The tensor map is encoded on the host by cuTensorMapEncodeTiled, whose
// address the CUDA runtime looks up at run time, so the library links
// no -lcuda.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ptt {
namespace hopper {

constexpr int kAtomCols = 64;                 // bf16 columns of an atom
constexpr int kRowBytes = kAtomCols * 2;      // 128
constexpr int kBoxRows = 64;                  // rows of one TMA box

// -- host: the tensor map of a [B, T, H, D] bf16 tensor ---------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) != cudaSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess)
      p = nullptr;
#endif
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// Boxes of 64 columns x 64 rows of head h of batch b, at column d0 and
// row t0 (coordinates {d0, h, t0, b}); columns past D and rows past T
// read as zeros. Returns 0 or a cudaError_t.
inline int make_map(CUtensorMap* map, const void* base, int batch, int t,
                    int heads, int head_dim) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[4] = {(cuuint64_t)head_dim, (cuuint64_t)heads,
                              (cuuint64_t)t, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)head_dim * 2,
                                 (cuuint64_t)heads * head_dim * 2,
                                 (cuuint64_t)t * heads * head_dim * 2};
  const cuuint32_t box[4] = {kAtomCols, 1, kBoxRows, 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(base), dims, strides, box, estride,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// -- device: shared-memory addresses and mbarriers --------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Wait until the phase of parity `parity` has completed. A copy that
// never lands (a fault of the kernel) traps after ~2^34 cycles (seconds)
// instead of hanging the card; the launch then fails.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > (1ll << 34)) __trap();
  }
}

// One 64 x 64 box of `map` at {d0, h, t0, b} into the atom at dst; it
// completes `bytes` of the transaction count of bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int d0, int h, int t0,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(d0),
      "r"(h), "r"(t0), "r"(b)
      : "memory");
}

// -- device: wgmma -----------------------------------------------------------

// Descriptor of a 128-byte-swizzled operand at `addr`. K-major (the
// reduction dimension contiguous, rows of 128 bytes): the 8-row groups
// are 1024 bytes apart (SBO). MN-major (the output dimension contiguous,
// rows are reduction steps): the 8-step groups are 1024 bytes apart
// (SBO) and the next 64 output columns `lbo` bytes on.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo) {
  uint64_t d = (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((1024 >> 4) & 0x3FFF) << 32;
  d |= 1ull << 62;  // 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define PTT_WGMMA_D32                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define PTT_WGMMA_OUT32(d)                                                  \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])

// d (+)= A B, m64 n64 k16, A and B from shared memory, both K-major.
// accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " PTT_WGMMA_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : PTT_WGMMA_OUT32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B, m64 n64 k16, A from registers (the m16n8k16 A fragment of
// each warp's 16 rows), B from shared memory MN-major.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " PTT_WGMMA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : PTT_WGMMA_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef PTT_WGMMA_D32
#undef PTT_WGMMA_OUT32

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^x by ex2.approx (about 2 ulp in f32; 2^-huge = 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace hopper
}  // namespace ptt
