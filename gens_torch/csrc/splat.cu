// K1: bilinear splat -- the adjoint of bilinear sampling -- for Hopper
// (sm_90a). The backward of the volume aggregation's feature sampling.
//
// Replaces gens_tpu/ops/pallas_splat.py::_splat_kernel (called through
// splat_bilinear from the custom VJP bilerp_agg_splat). Same function:
//
//   dimg[y, x, c] = sum_n hat(v_n - y) * hat(u_n - x) * ct[n, c]
//
// over the four bilinear corners of each query (u_n, v_n) = xy[n], with
// zeros padding (a corner outside the image contributes nothing) and
// hat(t) = max(0, 1 - |t|), evaluated as the TPU kernel does: 1 - |u - j|
// for the corner column j. A query whose cotangent row is all zero is
// skipped, as the TPU kernel's live test does. mm_bf16 reproduces the TPU
// kernel's operand rounding, which depends on its layout: the shipped
// "fused_u" layout rounds each term as bf16(hat_v) * bf16(hat_u * ct[n, c]),
// the r03 "per_channel" layout (per_channel = 1) as
// bf16(hat_v * ct[n, c]) * bf16(hat_u); both accumulate in f32. Without
// mm_bf16 every term is exact f32 and the layout plays no part.
//
// Why atomics and not the TPU's window: the TPU has no scatter, so its
// kernel turns the splat into dense windowed matmuls into a VMEM-resident
// image, which needs a per-rig window, required_window guards, and care with
// queries that straddle the frustum. A Hopper block's 227 KB of shared
// memory does not hold the 4.9 MB image (480 x 640 x 4 f32) and blocks run in
// no order, so the image stays in device memory and every corner is added
// with a float atomic, resolved in L2 (the 4.9 MB image fits the 50 MB L2).
// One thread per query; for C = 4 one vector float4 atomicAdd per corner
// (compute capability 9.x, global memory), scalar atomicAdd otherwise.
// Atomics sum in a run-dependent order, so the result matches the plain
// version to f32 rounding, not bit for bit.
//
// What bounds it: per query 8 B of xy and 4C B of ct are read once, and the
// image is written once; at the DTU shape that is 16.7M queries x 24 B =
// 0.40 GB per view at scale 0, about 0.12 ms at 3.35 TB/s. Neighbouring
// queries (one voxel row) land on neighbouring pixels, so atomics to one
// address serialise in L2; that contention, not DRAM, is what the simple
// design pays for.
//
// Built by gens_torch/ops/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes. The launch goes on the caller's stream, does not
// synchronise, allocates nothing (the wrapper passes a zeroed image), and the
// entry returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

#if CUDART_VERSION >= 12010
constexpr bool kVectorAtomics = true;
#else
constexpr bool kVectorAtomics = false;
#endif

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void add4(float* p, float4 v) {
#if CUDART_VERSION >= 12010 && defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  atomicAdd(reinterpret_cast<float4*>(p), v);
#else
  atomicAdd(p, v.x);
  atomicAdd(p + 1, v.y);
  atomicAdd(p + 2, v.z);
  atomicAdd(p + 3, v.w);
#endif
}

// The corners of one query: columns x0, x0 + 1 with hat weights wu[0..1],
// rows y0, y0 + 1 with wv[0..1]. False when no corner lies in the image
// (u outside (-1, W) or v outside (-1, H), NaN included): then every hat
// weight at an in-image corner is zero and the query adds nothing.
struct Corners {
  int x0, y0;
  float wu[2], wv[2];
};

__device__ __forceinline__ bool corners(float2 uv, int H, int W, Corners& c) {
  if (!(uv.x > -1.0f && uv.x < static_cast<float>(W) && uv.y > -1.0f &&
        uv.y < static_cast<float>(H)))
    return false;
  float x0f = floorf(uv.x), y0f = floorf(uv.y);
  c.x0 = static_cast<int>(x0f);
  c.y0 = static_cast<int>(y0f);
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    c.wu[d] = fmaxf(0.0f, 1.0f - fabsf(uv.x - (x0f + d)));
    c.wv[d] = fmaxf(0.0f, 1.0f - fabsf(uv.y - (y0f + d)));
  }
  return true;
}

// one term of the splat: the corner weights wv (row) and wu (column) times
// the cotangent g, with the operand rounding of the TPU layout
template <bool kBf16, bool kPerChannel>
__device__ __forceinline__ float term(float wv, float wu, float g) {
  if (!kBf16) return wv * (wu * g);
  if (kPerChannel) return round_bf16(wv * g) * round_bf16(wu);
  return round_bf16(wv) * round_bf16(wu * g);
}

template <bool kBf16, bool kPerChannel>
__global__ void __launch_bounds__(THREADS)
splat4_kernel(const float2* __restrict__ xy, const float4* __restrict__ ct,
              float* __restrict__ out, long long n, int H, int W) {
  long long i = blockIdx.x * static_cast<long long>(THREADS) + threadIdx.x;
  if (i >= n) return;
  float4 g = ct[i];
  if (g.x == 0.0f && g.y == 0.0f && g.z == 0.0f && g.w == 0.0f) return;
  Corners c;
  if (!corners(xy[i], H, W, c)) return;
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
    int iy = c.y0 + dy;
    if (iy < 0 || iy >= H) continue;
    float wv = c.wv[dy];
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      int ix = c.x0 + dx;
      if (ix < 0 || ix >= W) continue;
      float wu = c.wu[dx];
      float4 t = make_float4(term<kBf16, kPerChannel>(wv, wu, g.x),
                             term<kBf16, kPerChannel>(wv, wu, g.y),
                             term<kBf16, kPerChannel>(wv, wu, g.z),
                             term<kBf16, kPerChannel>(wv, wu, g.w));
      add4(out + 4 * (static_cast<long long>(iy) * W + ix), t);
    }
  }
}

template <bool kBf16, bool kPerChannel>
__global__ void __launch_bounds__(THREADS)
splat_kernel(const float2* __restrict__ xy, const float* __restrict__ ct,
             float* __restrict__ out, long long n, int H, int W, int C) {
  long long i = blockIdx.x * static_cast<long long>(THREADS) + threadIdx.x;
  if (i >= n) return;
  const float* g = ct + i * C;
  bool live = false;
  for (int k = 0; k < C; ++k) live |= (g[k] != 0.0f);
  if (!live) return;
  Corners c;
  if (!corners(xy[i], H, W, c)) return;
  for (int dy = 0; dy < 2; ++dy) {
    int iy = c.y0 + dy;
    if (iy < 0 || iy >= H) continue;
    float wv = c.wv[dy];
    for (int dx = 0; dx < 2; ++dx) {
      int ix = c.x0 + dx;
      if (ix < 0 || ix >= W) continue;
      float wu = c.wu[dx];
      float* p = out + C * (static_cast<long long>(iy) * W + ix);
      for (int k = 0; k < C; ++k)
        atomicAdd(p + k, term<kBf16, kPerChannel>(wv, wu, g[k]));
    }
  }
}

template <bool kBf16, bool kPerChannel>
void launch(const float* xy, const float* ct, float* out, long long n, int H,
            int W, int C, cudaStream_t stream) {
  long long blocks = (n + THREADS - 1) / THREADS;
  const float2* xy2 = reinterpret_cast<const float2*>(xy);
  if (C == 4)
    splat4_kernel<kBf16, kPerChannel><<<blocks, THREADS, 0, stream>>>(
        xy2, reinterpret_cast<const float4*>(ct), out, n, H, W);
  else
    splat_kernel<kBf16, kPerChannel><<<blocks, THREADS, 0, stream>>>(
        xy2, ct, out, n, H, W, C);
}

}  // namespace

extern "C" {

// 1 when float4 atomics were compiled in (CUDA 12.1+), else 0
int splat_vector_atomics() { return kVectorAtomics ? 1 : 0; }

// xy (n, 2) f32, ct (n, C) f32, out (H, W, C) f32 zeroed by the caller.
// xy must be 8-byte aligned, and for C = 4 ct and out 16-byte aligned (the
// wrapper checks). per_channel selects the r03 layout's rounding under
// mm_bf16.
int splat_bilinear_forward(const float* xy, const float* ct, float* out,
                           long long n, int H, int W, int C, int mm_bf16,
                           int per_channel, cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (!mm_bf16)
    launch<false, false>(xy, ct, out, n, H, W, C, stream);
  else if (per_channel)
    launch<true, true>(xy, ct, out, n, H, W, C, stream);
  else
    launch<true, false>(xy, ct, out, n, H, W, C, stream);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
