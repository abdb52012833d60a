// K4: the SDF grid's cascade lookup and positional encoding, one kernel,
// ahead of K3 (csrc/sdf_mlp.cu).
//
// Replaces no Pallas kernel: gens_tpu runs this part of
// gens_tpu/ops/pallas_mlp.py::sdf_fused_fn in XLA
// (lookup_volume_cascade_packed and two positional_encoding calls). In torch
// ops it was about 600 launches a 64^3 chunk (5 scales x 8 corners of index
// arithmetic, gathers, weights and sums, then the sin/cos/cat of both
// encodings), each writing its result to device memory for the next to read
// back. For N points this kernel writes the two inputs of K3 in the layouts
// it takes:
//   x_pe     (N, 3 (1 + 2 multires)) f32: PE(pts * scale, multires);
//   feats_pe (N, sum C_i (1 + 2 feat_multires)) f32: PE(cat_i trilerp(vol_i,
//            pts), feat_multires).
// PE is [x, sin 2^0 x, cos 2^0 x, ..., sin 2^(m-1) x, cos 2^(m-1) x], each
// block as wide as x. The trilerp is ops/interp.py::trilerp's arithmetic
// step for step: the align-corners unnormalize ((c + 1) * 0.5) * (n - 1),
// corners in dx -> dy -> dz order with weight ((wx * wy) * wz) * valid, zeros
// outside the volume (the clamped corner is read and weighted 0), added in
// that order; every product and sum rounded on its own (__fmul_rn,
// __fadd_rn: no FMA contraction) and the accurate sinf / cosf, so the
// outputs equal the torch chain's bit for bit.
//
// What bounds it: bytes written. A point reads 40 corner rows (16 bytes each
// at C = 4 f32), mostly from L1 and L2, since neighbouring grid points share
// corners, and writes 508 bytes at the full config: 133 MB a 64^3 chunk,
// 40 us at 3.35 TB/s. After the stores, the sin/cos (104 a point) are the
// largest cost.
//
// Design: a CTA owns 128 points. In the lookup each thread takes one point,
// computes its 8 corners' indices and weights per scale and gathers the rows
// (one 16-byte load a corner for C = 4 f32, 8 bytes for bf16, a loop over
// channels for any other C or an unaligned base), and keeps the features and
// pts * scale in shared memory (odd row stride: no bank conflicts). Then the
// CTA writes its two output tiles, each contiguous in device memory, element
// by element in address order (coalesced stores): a per-CTA column map gives
// each output column its PE block and source column, and each thread steps
// (row, column) without a division.
//
// The cascade comes as a descriptor of up to 8 scales (pointer, X, Y, Z, C)
// read in place; all scales are f32 or all bf16 (widened exactly). Built by
// gens_torch/ops/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes. The launch goes on the caller's stream, does not
// synchronise, allocates nothing, and the entry returns a cudaError_t code.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_SCALES = 8;
constexpr int TP = 128;       // points per CTA, one thread each in the lookup
constexpr int THREADS = TP;
constexpr int MAX_MULTIRES = 30;  // 2^(m-1) and the column map's block field

struct Scale {
  const void* ptr;
  int X, Y, Z, C;
  int off;  // first feature column of this scale
  int vec;  // C == 4 and the base aligned for one 16- (8-) byte load a row
};

struct Cascade {
  Scale s[MAX_SCALES];
  int n_scales;
  int c_total;
};

__device__ __forceinline__ float unnormalize(float c, int n) {
  return __fmul_rn(__fmul_rn(__fadd_rn(c, 1.f), 0.5f),
                   static_cast<float>(n - 1));
}

__device__ __forceinline__ float bf16_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

template <bool BF16>
__device__ __forceinline__ float load1(const void* base, long long i) {
  if (BF16) {
    const uint16_t h = __ldg(static_cast<const unsigned short*>(base) + i);
    return __uint_as_float(static_cast<uint32_t>(h) << 16);
  }
  return __ldg(static_cast<const float*>(base) + i);
}

template <bool BF16>
__device__ __forceinline__ float4 load4(const void* base, long long row) {
  if (BF16) {
    const uint2 u = __ldg(static_cast<const uint2*>(base) + row);
    return make_float4(bf16_lo(u.x), bf16_hi(u.x), bf16_lo(u.y),
                       bf16_hi(u.y));
  }
  return __ldg(static_cast<const float4*>(base) + row);
}

// trilerp of one scale at one point into out[0, C)
template <bool BF16>
__device__ __forceinline__ void lookup(const Scale& sc, float px, float py,
                                       float pz, float* out) {
  const float x = unnormalize(px, sc.X);
  const float y = unnormalize(py, sc.Y);
  const float z = unnormalize(pz, sc.Z);
  const float x0f = floorf(x), y0f = floorf(y), z0f = floorf(z);
  const float wx1 = __fsub_rn(x, x0f), wy1 = __fsub_rn(y, y0f),
              wz1 = __fsub_rn(z, z0f);
  const float wx0 = __fsub_rn(1.f, wx1), wy0 = __fsub_rn(1.f, wy1),
              wz0 = __fsub_rn(1.f, wz1);
  const long long x0 = static_cast<long long>(x0f),
                  y0 = static_cast<long long>(y0f),
                  z0 = static_cast<long long>(z0f);
  long long row[8];
  float w[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int dx = k >> 2, dy = (k >> 1) & 1, dz = k & 1;
    const long long ix = x0 + dx, iy = y0 + dy, iz = z0 + dz;
    const bool valid = ix >= 0 && ix < sc.X && iy >= 0 && iy < sc.Y &&
                       iz >= 0 && iz < sc.Z;
    const long long cx = ix < 0 ? 0 : (ix >= sc.X ? sc.X - 1 : ix);
    const long long cy = iy < 0 ? 0 : (iy >= sc.Y ? sc.Y - 1 : iy);
    const long long cz = iz < 0 ? 0 : (iz >= sc.Z ? sc.Z - 1 : iz);
    row[k] = (cx * sc.Y + cy) * sc.Z + cz;
    w[k] = __fmul_rn(__fmul_rn(__fmul_rn(dx ? wx1 : wx0, dy ? wy1 : wy0),
                               dz ? wz1 : wz0),
                     valid ? 1.f : 0.f);
  }
  if (sc.vec) {
    float4 v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = load4<BF16>(sc.ptr, row[k]);
    float4 a = make_float4(__fmul_rn(v[0].x, w[0]), __fmul_rn(v[0].y, w[0]),
                           __fmul_rn(v[0].z, w[0]), __fmul_rn(v[0].w, w[0]));
#pragma unroll
    for (int k = 1; k < 8; ++k) {
      a.x = __fadd_rn(a.x, __fmul_rn(v[k].x, w[k]));
      a.y = __fadd_rn(a.y, __fmul_rn(v[k].y, w[k]));
      a.z = __fadd_rn(a.z, __fmul_rn(v[k].z, w[k]));
      a.w = __fadd_rn(a.w, __fmul_rn(v[k].w, w[k]));
    }
    out[0] = a.x;
    out[1] = a.y;
    out[2] = a.z;
    out[3] = a.w;
    return;
  }
  for (int c = 0; c < sc.C; ++c) {
    float a = __fmul_rn(load1<BF16>(sc.ptr, row[0] * sc.C + c), w[0]);
#pragma unroll
    for (int k = 1; k < 8; ++k)
      a = __fadd_rn(a, __fmul_rn(load1<BF16>(sc.ptr, row[k] * sc.C + c),
                                 w[k]));
    out[c] = a;
  }
}

// Write rows x width of PE(src) (row stride ld in shared memory) to the
// contiguous tile dst, in address order. colmap[col] = (block << 16) | source
// column; block 0 is x, block 2i + 1 sin(2^i x), block 2i + 2 cos(2^i x).
__device__ __forceinline__ void write_pe(float* __restrict__ dst,
                                         const float* src, int ld,
                                         const int* colmap, int width,
                                         int rows) {
  const int total = rows * width;
  const int drow = THREADS / width, dcol = THREADS % width;
  int row = threadIdx.x / width, col = threadIdx.x % width;
  for (int e = threadIdx.x; e < total; e += THREADS) {
    const int m = colmap[col];
    const int blk = m >> 16;
    const float v = src[row * ld + (m & 0xffff)];
    float o = v;
    if (blk != 0) {
      // 2^i exactly, i = (blk - 1) / 2 <= MAX_MULTIRES - 1
      const float a = __fmul_rn(v, __int_as_float((127 + ((blk - 1) >> 1))
                                                  << 23));
      o = (blk & 1) ? sinf(a) : cosf(a);
    }
    dst[e] = o;
    row += drow;
    col += dcol;
    if (col >= width) {
      col -= width;
      ++row;
    }
  }
}

template <bool BF16>
__global__ void __launch_bounds__(THREADS)
    cascade_pe_kernel(const float* __restrict__ pts, long long n,
                      const Cascade cas, float scale, int multires,
                      int feat_multires, float* __restrict__ x_pe,
                      float* __restrict__ feats_pe) {
  extern __shared__ float smem[];
  const int ld = cas.c_total | 1;
  const int wf = cas.c_total * (1 + 2 * feat_multires);
  const int wx = 3 * (1 + 2 * multires);
  float* feat = smem;               // TP x ld
  float* xs = feat + TP * ld;       // TP x 3: pts * scale
  int* colmap = reinterpret_cast<int*>(xs + TP * 3);  // wf + wx
  const long long row0 = static_cast<long long>(blockIdx.x) * TP;
  const int rows = n - row0 < TP ? static_cast<int>(n - row0) : TP;
  const int t = threadIdx.x;

  for (int c = t; c < wf; c += THREADS)
    colmap[c] = ((c / cas.c_total) << 16) | (c % cas.c_total);
  for (int c = t; c < wx; c += THREADS)
    colmap[wf + c] = ((c / 3) << 16) | (c % 3);

  if (t < rows) {
    const float* p = pts + (row0 + t) * 3;
    const float px = p[0], py = p[1], pz = p[2];
    xs[t * 3 + 0] = __fmul_rn(px, scale);
    xs[t * 3 + 1] = __fmul_rn(py, scale);
    xs[t * 3 + 2] = __fmul_rn(pz, scale);
    float* f = feat + t * ld;
#pragma unroll
    for (int s = 0; s < MAX_SCALES; ++s)
      if (s < cas.n_scales)
        lookup<BF16>(cas.s[s], px, py, pz, f + cas.s[s].off);
  }
  __syncthreads();
  write_pe(feats_pe + row0 * wf, feat, ld, colmap, wf, rows);
  write_pe(x_pe + row0 * wx, xs, 3, colmap + wf, wx, rows);
}

template <bool BF16>
cudaError_t launch(const float* pts, long long n, const Cascade& cas,
                   float scale, int multires, int feat_multires, float* x_pe,
                   float* feats_pe, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        cascade_pe_kernel<BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const long long grid = (n + TP - 1) / TP;
  cascade_pe_kernel<BF16><<<static_cast<unsigned>(grid), THREADS, smem,
                            stream>>>(pts, n, cas, scale, multires,
                                      feat_multires, x_pe, feats_pe);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// pts: (n, 3) f32. vols[s]: (dims[4s], dims[4s+1], dims[4s+2], dims[4s+3])
// = (X, Y, Z, C), contiguous, every one f32 (bf16 == 0) or bf16. x_pe and
// feats_pe as in the header, contiguous f32.
int cascade_pe_forward(const float* pts, long long n, int n_scales,
                       const void* const* vols, const int* dims, int bf16,
                       float scale, int multires, int feat_multires,
                       float* x_pe, float* feats_pe, void* stream) {
  if (n_scales < 1 || n_scales > MAX_SCALES || multires < 0 ||
      multires > MAX_MULTIRES || feat_multires < 0 ||
      feat_multires > MAX_MULTIRES || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Cascade cas = {};
  int off = 0;
  for (int s = 0; s < n_scales; ++s) {
    Scale& sc = cas.s[s];
    sc.ptr = vols[s];
    sc.X = dims[4 * s];
    sc.Y = dims[4 * s + 1];
    sc.Z = dims[4 * s + 2];
    sc.C = dims[4 * s + 3];
    if (sc.X < 1 || sc.Y < 1 || sc.Z < 1 || sc.C < 1)
      return static_cast<int>(cudaErrorInvalidValue);
    sc.off = off;
    off += sc.C;
    const uintptr_t align = bf16 ? 8 : 16;
    sc.vec = sc.C == 4 && reinterpret_cast<uintptr_t>(sc.ptr) % align == 0;
  }
  cas.n_scales = n_scales;
  cas.c_total = off;
  if (off >= (1 << 16)) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const int wf = off * (1 + 2 * feat_multires);
  const int wx = 3 * (1 + 2 * multires);
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(TP) * ((off | 1) + 3) + wf + wx);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      bf16 ? launch<true>(pts, n, cas, scale, multires, feat_multires, x_pe,
                          feats_pe, smem, st)
           : launch<false>(pts, n, cas, scale, multires, feat_multires, x_pe,
                           feats_pe, smem, st);
  return static_cast<int>(err);
}

}  // extern "C"
