// Hopper (sm_90a) building blocks shared by the tensor-core kernels K3
// (sdf_mlp.cu) and P3 (gather_probe.cu): mbarriers, 2-D TMA loads with the
// 128- or 64-byte swizzle, 4-byte cp.async, wgmma descriptors for K-major
// operands in those swizzles, the two register-A wgmma shapes the kernels
// use, the TF32 rounding and the host-side encoding of a TMA descriptor.
//
// cuTensorMapEncodeTiled is not part of the CUDA runtime. The libraries
// link no libcuda; the entry point is looked up in the libcuda.so.1 the
// CUDA runtime has already loaded, once per process.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace hopper {

// -- shared memory, barriers, TMA ---------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The 128-byte swizzle repeats every 1024 bytes: tiles start on that grain.
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of `bar` with this parity has completed. A pipeline
// fault (a barrier that never completes) traps after about 2^28 polls
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0, polls = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (++polls > (1u << 28)) __trap();
  }
}

// One box of a 2-D tensor map into shared memory; completion is counted in
// bytes on `bar`. (c0 inner, c1 outer coordinate, in elements.)
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}

// Four bytes from global to shared memory, asynchronously (zeros when
// !valid, reading nothing); a thread may have many in flight.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// -- wgmma --------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// until at most N committed groups of this warpgroup are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of registers across the
// wgmma fence / wait around them: the accumulators after the wait, and the
// A fragments before the fence (were their last writes left until just
// before each wgmma, ptxas would fence every wgmma on its own and serialise
// them).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int M, int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// Descriptor of a K-major B tile written by TMA with the 128-byte swizzle:
// rows of 128 bytes, 8-row groups 1024 bytes apart (SBO), the tile on a
// 1024-byte boundary (base offset 0). A k-step of 32 bytes further along K
// is the descriptor plus 2 (the address field counts 16-byte units).
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  const uint64_t addr = (smem_u32(tile) & 0x3FFFFu) >> 4;
  return addr | (1ull << 16) | ((1024ull >> 4) << 32) | (1ull << 62);
}
// The same with the 64-byte swizzle: rows of 64 bytes, 8-row groups 512
// bytes apart, the tile on a 512-byte boundary.
__device__ __forceinline__ uint64_t sw64_desc(const void* tile) {
  const uint64_t addr = (smem_u32(tile) & 0x3FFFFu) >> 4;
  return addr | (1ull << 16) | ((512ull >> 4) << 32) | (2ull << 62);
}

#define HOPPER_D4(i) \
  "+f"(d[i]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3])
#define HOPPER_D16(i) \
  HOPPER_D4(i), HOPPER_D4((i) + 4), HOPPER_D4((i) + 8), HOPPER_D4((i) + 12)
#define HOPPER_D64 HOPPER_D16(0), HOPPER_D16(16), HOPPER_D16(32), HOPPER_D16(48)

// d (64 x 136, f32) += a (64 x 8, tf32, registers) * b (8 x 136, tf32,
// K-major in shared memory). Per thread: a[0..3] = A(g, t), A(g + 8, t),
// A(g, t + 4), A(g + 8, t + 4) of its warp's 16 rows (g = lane / 4,
// t = lane % 4); d[4j + {0, 1}] = D(g, 8j + 2t + {0, 1}), d[4j + {2, 3}] the
// same columns of row g + 8.
__device__ __forceinline__ void wgmma_m64n136k8_tf32(float (&d)[68],
                                                     const uint32_t (&a)[4],
                                                     uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %73, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n136k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67}, "
      "{%68, %69, %70, %71}, %72, p, 1, 1;\n}"
      : HOPPER_D64, HOPPER_D4(64)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 128, f32) += a (64 x 16, bf16, registers) * b (16 x 128, bf16,
// K-major in shared memory). Per thread: a[0..3] hold the bf16 pairs
// A(g, 2t..2t+1), A(g + 8, 2t..), A(g, 2t + 8..), A(g + 8, 2t + 8..), the
// lower column in the lower half; d as above.
__device__ __forceinline__ void wgmma_m64n128k16_bf16(float (&d)[64],
                                                      const uint32_t (&a)[4],
                                                      uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}"
      : HOPPER_D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

#undef HOPPER_D64
#undef HOPPER_D16
#undef HOPPER_D4

// Round to TF32 (10 explicit mantissa bits) to nearest, ties away from zero:
// the bits of an f32 whose low 13 are zero.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// -- host: TMA descriptors ----------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// A row-major (outer, inner) tensor of `pitch` bytes a row, read in boxes of
// (box_outer, box_inner) with the given swizzle (the box's inner extent in
// bytes); box elements outside the tensor read as zero. Returns a
// cudaError_t code.
inline int encode_2d(CUtensorMap* map, CUtensorMapDataType type, void* base,
                     uint64_t inner, uint64_t outer, uint64_t pitch,
                     uint32_t box_inner, uint32_t box_outer,
                     CUtensorMapSwizzle swizzle) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib == nullptr)
      return static_cast<int>(cudaErrorSharedObjectInitFailed);
    encode = reinterpret_cast<EncodeTiled>(
        dlsym(lib, "cuTensorMapEncodeTiled"));
    if (encode == nullptr)
      return static_cast<int>(cudaErrorSharedObjectSymbolNotFound);
  }
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {pitch};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = encode(map, type, 2, base, dims, strides, box, steps,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace hopper
