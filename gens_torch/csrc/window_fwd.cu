// K2: the bilinear forward of the volume aggregation under splat_impl
// "kernel2f", for Hopper (sm_90a).
//
// Replaces gens_tpu/ops/pallas_splat.py::_gather_window_kernel (called
// through bilerp_window_fwd from _bas_primal). Same function, for every
// query n with (u, v) = xy[n]:
//
//   vals[n, k] = sum_q hat_u(n, q) * sum_p R(hat_v(n, p)) * img[p, q, k]
//
// with hat(t) = max(0, 1 - |t|) against the integer column q or row p,
// zeros padding (a corner outside the image contributes nothing), and R the
// operand rounding: with a bf16 image (the shipped splat_mm_dtype), hat_v is
// rounded to bf16 with round-to-nearest-even, as astype(bfloat16) does, and
// the image is already bf16; hat_u is never rounded; every product and sum
// is f32. With an f32 image the function is the exact bilerp. Only the two
// rows and two columns around (u, v) carry weight, so each query sums
//
//   wu0 * (bv0 * i00 + bv1 * i10) + wu1 * (bv0 * i01 + bv1 * i11)
//
// in that order, where iRC is the pixel at row y0 + R, column x0 + C.
//
// Why no window: the TPU kernel reads a (16, 16)-voxel tile's projected
// window of a VMEM-resident image and evaluates the sum as hat-matrix
// matmuls, because a TPU gather is addressing-bound. On Hopper a query's
// four corners are four 8-byte loads (bf16, C = 4) that L2 serves: the
// 14.7 MB scale-0 map of a 1152 x 1600 view fits the 50 MB L2, and
// neighbouring voxels project to neighbouring pixels. Without a window
// there is nothing to cover, so the window bound and its guards are not
// ported, and every query -- live or not -- gets the windowless value.
//
// A query outside (-1, W) x (-1, H), or with a non-finite coordinate, gives
// exactly 0. The test comes before any float -> int conversion: voxels
// behind the camera project anywhere (xy = uvw / (w + 1e-8) can be +-inf or
// NaN), and 0 * NaN would poison the masked sum downstream.
//
// What bounds it: per query 8 B of xy are read and 4C B of output written,
// and the map is read once; at the finetune shape that is 16.8M queries x
// 24 B = 0.40 GB per view at scale 0, about 0.12 ms at 3.35 TB/s. The
// arithmetic (about 20 flops a query) is far below the f32 rate.
//
// Built by gens_torch/ops/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes. The launch goes on the caller's stream, does not
// synchronise, allocates nothing, and the entry returns cudaGetLastError().
// nvcc may contract a * b + c into an FMA, so the kernel matches its plain
// PyTorch version to f32 rounding, not bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The corner weights of one query: columns x0, x0 + 1 with hat weights
// wu[0..1], rows y0, y0 + 1 with wv[0..1] (rounded under kBf16). False when
// the query lies outside (-1, W) x (-1, H) or is not finite (NaN fails every
// comparison): then its value is 0.
template <bool kBf16>
struct Corners {
  int x0, y0;
  float wu[2], wv[2];

  __device__ __forceinline__ bool init(float2 uv, int H, int W) {
    if (!(uv.x > -1.0f && uv.x < static_cast<float>(W) && uv.y > -1.0f &&
          uv.y < static_cast<float>(H)))
      return false;
    float x0f = floorf(uv.x), y0f = floorf(uv.y);
    x0 = static_cast<int>(x0f);
    y0 = static_cast<int>(y0f);
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      wu[d] = fmaxf(0.0f, 1.0f - fabsf(uv.x - (x0f + d)));
      float w = fmaxf(0.0f, 1.0f - fabsf(uv.y - (y0f + d)));
      wv[d] = kBf16 ? round_bf16(w) : w;
    }
    return true;
  }

  __device__ __forceinline__ bool valid(int iy, int ix, int H, int W) const {
    return iy >= 0 && iy < H && ix >= 0 && ix < W;
  }
};

// four channels of one pixel as f32: 8 B of bf16 or 16 B of f32
__device__ __forceinline__ float4 load4(const __nv_bfloat16* img, long long p) {
  uint2 raw = reinterpret_cast<const uint2*>(img)[p];
  __nv_bfloat162 lo = *reinterpret_cast<__nv_bfloat162*>(&raw.x);
  __nv_bfloat162 hi = *reinterpret_cast<__nv_bfloat162*>(&raw.y);
  float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float4 load4(const float* img, long long p) {
  return reinterpret_cast<const float4*>(img)[p];
}

__device__ __forceinline__ float load1(const __nv_bfloat16* img, long long i) {
  return __bfloat162float(img[i]);
}

__device__ __forceinline__ float load1(const float* img, long long i) {
  return img[i];
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
window4_kernel(const float2* __restrict__ xy, const T* __restrict__ img,
               float4* __restrict__ out, long long n, int H, int W) {
  constexpr bool kBf16 = sizeof(T) == 2;
  long long i = blockIdx.x * static_cast<long long>(THREADS) + threadIdx.x;
  if (i >= n) return;
  Corners<kBf16> c;
  float4 r = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (c.init(xy[i], H, W)) {
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float4 q[2][2];  // q[row][col]
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        int iy = c.y0 + dy, ix = c.x0 + dx;
        q[dy][dx] = c.valid(iy, ix, H, W)
                        ? load4(img, static_cast<long long>(iy) * W + ix)
                        : zero;
      }
    }
    const float bv0 = c.wv[0], bv1 = c.wv[1], wu0 = c.wu[0], wu1 = c.wu[1];
    r.x = wu0 * (bv0 * q[0][0].x + bv1 * q[1][0].x) +
          wu1 * (bv0 * q[0][1].x + bv1 * q[1][1].x);
    r.y = wu0 * (bv0 * q[0][0].y + bv1 * q[1][0].y) +
          wu1 * (bv0 * q[0][1].y + bv1 * q[1][1].y);
    r.z = wu0 * (bv0 * q[0][0].z + bv1 * q[1][0].z) +
          wu1 * (bv0 * q[0][1].z + bv1 * q[1][1].z);
    r.w = wu0 * (bv0 * q[0][0].w + bv1 * q[1][0].w) +
          wu1 * (bv0 * q[0][1].w + bv1 * q[1][1].w);
  }
  out[i] = r;
}

// any channel count: one scalar load per corner and channel
template <typename T>
__global__ void __launch_bounds__(THREADS)
window_kernel(const float2* __restrict__ xy, const T* __restrict__ img,
              float* __restrict__ out, long long n, int H, int W, int C) {
  constexpr bool kBf16 = sizeof(T) == 2;
  long long i = blockIdx.x * static_cast<long long>(THREADS) + threadIdx.x;
  if (i >= n) return;
  float* o = out + i * C;
  Corners<kBf16> c;
  if (!c.init(xy[i], H, W)) {
    for (int k = 0; k < C; ++k) o[k] = 0.0f;
    return;
  }
  long long base[2][2];
  bool ok[2][2];
  for (int dy = 0; dy < 2; ++dy) {
    for (int dx = 0; dx < 2; ++dx) {
      int iy = c.y0 + dy, ix = c.x0 + dx;
      ok[dy][dx] = c.valid(iy, ix, H, W);
      base[dy][dx] = (static_cast<long long>(iy) * W + ix) * C;
    }
  }
  const float bv0 = c.wv[0], bv1 = c.wv[1], wu0 = c.wu[0], wu1 = c.wu[1];
  for (int k = 0; k < C; ++k) {
    float i00 = ok[0][0] ? load1(img, base[0][0] + k) : 0.0f;
    float i10 = ok[1][0] ? load1(img, base[1][0] + k) : 0.0f;
    float i01 = ok[0][1] ? load1(img, base[0][1] + k) : 0.0f;
    float i11 = ok[1][1] ? load1(img, base[1][1] + k) : 0.0f;
    o[k] = wu0 * (bv0 * i00 + bv1 * i10) + wu1 * (bv0 * i01 + bv1 * i11);
  }
}

template <typename T>
void launch(const float* xy, const void* img, float* out, long long n, int H,
            int W, int C, cudaStream_t stream) {
  long long blocks = (n + THREADS - 1) / THREADS;
  const float2* xy2 = reinterpret_cast<const float2*>(xy);
  const T* im = static_cast<const T*>(img);
  if (C == 4)
    window4_kernel<T><<<blocks, THREADS, 0, stream>>>(
        xy2, im, reinterpret_cast<float4*>(out), n, H, W);
  else
    window_kernel<T><<<blocks, THREADS, 0, stream>>>(xy2, im, out, n, H, W, C);
}

}  // namespace

extern "C" {

// xy (n, 2) f32; img (H, W, C) bf16 (img_bf16 = 1) or f32; out (n, C) f32.
// xy must be 8-byte aligned; for C = 4 the image 8-byte (bf16) or 16-byte
// (f32) aligned and out 16-byte aligned (the wrapper checks).
int bilerp_window_forward(const float* xy, const void* img, float* out,
                          long long n, int H, int W, int C, int img_bf16,
                          cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (img_bf16)
    launch<__nv_bfloat16>(xy, img, out, n, H, W, C, stream);
  else
    launch<float>(xy, img, out, n, H, W, C, stream);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
