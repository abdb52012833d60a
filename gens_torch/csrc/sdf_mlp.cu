// K3: fused, gradient-free forward of the GenS SDF MLP for Hopper (sm_90a),
// on the tensor cores in 3xTF32.
//
// Replaces gens_tpu/ops/pallas_mlp.py::_mlp_kernel (called through
// sdf_mlp_fused). Same function: input PE(x); PE(volume features)
// concatenated into every hidden layer; PE(x) concatenated again at the skip
// layers, the concatenation scaled by 1/sqrt(2); Softplus(beta=100) on every
// hidden layer; weight norm folded on the host. Output is the raw head
// (N, d_out) f32 -- the caller divides channel 0 by cfg.scale.
//
// What bounds it: operations. At the full config a row costs 345,264 FLOP
// against about 1 KB of device-memory traffic; in 3xTF32 every product is
// three tensor-core products (hi*hi + hi*lo + lo*hi, with hi = tf32_rna(v),
// lo = tf32_rna(v - hi), sums in f32), so a 64^3 chunk (262,144 rows) needs
// 3 x 90.5 GFLOP, 0.55 ms at the 495 TFLOP/s TF32 peak. One-pass TF32 (about
// 1e-3 relative) would miss the 1e-4 / 1e-5 limits the kernel is held to;
// the three products keep it near f32.
//
// Design: a CTA owns 128 rows and keeps their activations in shared memory,
// one f32 buffer [hidden | PE(feats) | zeros] whose row stride is 4 mod 8
// words (conflict-free A-fragment loads); each layer's outputs overwrite the
// hidden part. Two consumer warpgroups own 64 rows each; each thread loads
// its A fragment for a k-step from the buffer and splits it into hi and lo
// in registers (register-A wgmma.m64n136k8.tf32). The weights are split on
// the host (fused_mlp.py, ``fold_sdf_mlp``) into a packed buffer of hi and
// lo tiles, transposed to K-major and padded to 136 outputs: one producer
// warp streams 16 K-rows of hi and lo (17 KB, 64-byte swizzle) a stage
// through a TMA ring of 6 stages with mbarriers. The weights are the same
// for every CTA and are read from L2, about 1.6 MB a CTA; that stream, not
// the products, is the kernel's largest cost, so the ring is as deep as
// shared memory allows and the consumers keep one stage's products running
// while they load and start the next (wgmma.wait_group 1). The rows of the
// buffer a warp reads are the rows it fills and whose outputs it holds, so
// the epilogue (bias, softplus100, the skip's 1/sqrt(2) and the append of
// PE(x), re-read from device memory) needs only __syncwarp. The last layer
// stores the (N, d_out) head, masked at the ragged tile.
//
// Built by gens_torch/ops/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes. The launch goes on the caller's stream, does not
// synchronise, allocates nothing, and the entry returns a cudaError_t code.

#include <math.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int TM = 128;       // rows per CTA: two consumer warpgroups of 64
constexpr int NT = 136;       // outputs of every layer, padded (wgmma N)
constexpr int KS = 16;        // weight K-rows a stage: one 64-byte f32 row
constexpr int STAGES = 6;
constexpr int THREADS = 288;  // 2 consumer warpgroups + 1 producer warp
constexpr int TILE_BYTES = NT * KS * 4;       // 8,704 = 17 x 512
constexpr int STAGE_BYTES = 2 * TILE_BYTES;   // hi and lo
constexpr int MAX_LAYERS = 16;

struct MlpDesc {
  int n_layers;
  int d_x;       // PE(x) width
  int d_feat;    // PE(feats) width
  int d_hidden;  // width of the hidden part of every layer >= 1 input
  int ld;        // row stride of the activation buffer (4 mod 8 words)
  int k_pad[MAX_LAYERS];  // the layer's K rounded up to a k-step of 8
  int n_out[MAX_LAYERS];
  int skip[MAX_LAYERS];  // layer input is [h, x_pe] / sqrt(2) (+ feats)
};

// jax.nn.softplus(100 h) / 100 in its overflow-safe form. The epilogue is
// the kernel's largest cost after the products, so: the fast exp and log
// (log(1 + y) for y in (0, 1] within about 4e-7, 4e-9 after the / 100, far
// inside the kernel's limits) and x 0.01 rather than an IEEE division.
__device__ __forceinline__ float softplus100(float h) {
  const float z = 100.f * h;
  return (fmaxf(z, 0.f) + __logf(1.f + __expf(-fabsf(z)))) * 0.01f;
}

__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

// A fragments of one stage (NKS k-steps of 8): the thread's rows a and b
// of the buffer at columns k + 8 ks and + 4, split into hi and lo.
template <int NKS>
__device__ __forceinline__ void load_stage(uint32_t (&ah)[KS / 8][4],
                                           uint32_t (&al)[KS / 8][4],
                                           const float* act_a,
                                           const float* act_b, int k) {
#pragma unroll
  for (int ks = 0; ks < NKS; ++ks) {
    split(act_a[k + 8 * ks], ah[ks][0], al[ks][0]);
    split(act_b[k + 8 * ks], ah[ks][1], al[ks][1]);
    split(act_a[k + 8 * ks + 4], ah[ks][2], al[ks][2]);
    split(act_b[k + 8 * ks + 4], ah[ks][3], al[ks][3]);
  }
}

// hi*hi + hi*lo + lo*hi of one stage on its weight tiles, committed as one
// group and left running. NKS is a template argument so that no wgmma sits
// behind a branch.
template <int NKS>
__device__ __forceinline__ void run_stage(float (&acc)[4 * (NT / 8)],
                                            uint32_t (&ah)[KS / 8][4],
                                            uint32_t (&al)[KS / 8][4],
                                            const uint8_t* tile) {
  fence_regs(ah);
  fence_regs(al);
  fence_regs(acc);
  wgmma_fence();
  const uint64_t dh = sw64_desc(tile), dl = sw64_desc(tile + TILE_BYTES);
#pragma unroll
  for (int ks = 0; ks < NKS; ++ks) {
    wgmma_m64n136k8_tf32(acc, ah[ks], dh + 2 * ks);
    wgmma_m64n136k8_tf32(acc, ah[ks], dl + 2 * ks);
    wgmma_m64n136k8_tf32(acc, al[ks], dh + 2 * ks);
  }
  wgmma_commit();
}

__global__ void __launch_bounds__(THREADS, 1)
sdf_mlp_tc_kernel(const __grid_constant__ CUtensorMap wmap,
                  const float* __restrict__ x_pe,
                  const float* __restrict__ feats,
                  const float* __restrict__ bias, float* __restrict__ out,
                  long long n_rows, MlpDesc d) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align1024(smem_raw);  // STAGES x (hi tile, lo tile)
  float* act = reinterpret_cast<float*>(ring + STAGES * STAGE_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(act + TM * d.ld);
  uint64_t* empty = full + STAGES;
  const int tid = threadIdx.x, lane = tid % 32;
  // warp-uniform as far as the compiler can tell, so that the wgmma of
  // the consumer branch are not serialised as if in a divergent path
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const long long row0 = static_cast<long long>(blockIdx.x) * TM;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 8) {  // producer: the weights' hi and lo tiles, layer by layer
    if (lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int l = 0; l < d.n_layers; ++l) {
        for (int k0 = 0; k0 < d.k_pad[l]; k0 += KS) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], STAGE_BYTES);
          uint8_t* dst = ring + stage * STAGE_BYTES;
          tma_load_2d(dst, &wmap, k0, (2 * l) * NT, &full[stage]);
          tma_load_2d(dst + TILE_BYTES, &wmap, k0, (2 * l + 1) * NT,
                      &full[stage]);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // consumers. A warp owns 16 rows of the buffer: it fills them with
  // [PE(x) | zeros | PE(feats) | zeros] by asynchronous 4-byte copies, all
  // in flight at once, while the producer streams the first weights (the
  // ragged tile's rows read zeros), and it alone reads and writes them.
  for (int r = 16 * warp; r < 16 * warp + 16; ++r) {
    const long long g = row0 + r;
    const bool live = g < n_rows;
    const long long gs = live ? g : 0;  // an address inside the inputs
    float* dst = act + r * d.ld;
    for (int c = lane; c < d.ld; c += 32) {
      if (c < d.d_x)
        cp_async4(dst + c, x_pe + gs * d.d_x + c, live);
      else if (c >= d.d_hidden && c < d.d_hidden + d.d_feat)
        cp_async4(dst + c, feats + gs * d.d_feat + c - d.d_hidden, live);
      else
        dst[c] = 0.f;
    }
  }
  cp_async_wait_all();
  __syncwarp();

  // rows g and g + 8 of the warp's 16
  const int wg = warp / 4, g = lane / 4, t = lane % 4;
  const int ra = 64 * wg + 16 * (warp % 4) + g, rb = ra + 8;
  float* act_a = act + ra * d.ld;
  float* act_b = act + rb * d.ld;
  const long long ga = row0 + ra, gb = row0 + rb;
  const float inv_sqrt2 = 0.70710678118654752f;
  int stage = 0;
  uint32_t phase = 0;
  float acc[4 * (NT / 8)];
  uint32_t ah[2][KS / 8][4], al[2][KS / 8][4];  // two stages' A fragments

  for (int l = 0; l < d.n_layers; ++l) {
    const int kp = d.k_pad[l];
#pragma unroll
    for (int i = 0; i < 4 * (NT / 8); ++i) acc[i] = 0.f;

    // Software pipelined: stage i's products run while stage i + 1's A
    // fragments are loaded (into the other register buffer) and started;
    // then wait until only stage i + 1's group runs and release stage i.
    // The loop is unrolled by two so that the buffers are named at
    // compile time; a stage is 2 k-steps, or 1 at a layer's ragged end.
    const int n_st = (kp + KS - 1) / KS;
    int prev = -1;
    for (int i = 0; i < n_st; i += 2) {
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        if (b == 1 && i + 1 == n_st) break;
        const int k0 = (i + b) * KS;
        const uint8_t* tile = ring + stage * STAGE_BYTES;
        const bool full_stage = kp - k0 >= KS;
        if (full_stage)
          load_stage<KS / 8>(ah[b], al[b], act_a, act_b, k0 + t);
        else
          load_stage<1>(ah[b], al[b], act_a, act_b, k0 + t);
        mbar_wait(&full[stage], phase);
        if (full_stage)
          run_stage<KS / 8>(acc, ah[b], al[b], tile);
        else
          run_stage<1>(acc, ah[b], al[b], tile);
        if (prev >= 0) {
          wgmma_wait<1>();
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[prev]);
        }
        prev = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[prev]);

    const int N = d.n_out[l];
    const float* __restrict__ B = bias + l * NT;
    if (l == d.n_layers - 1) {
#pragma unroll
      for (int j = 0; j < NT / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * t + e;
          if (c < N) {
            if (ga < n_rows) out[ga * N + c] = acc[4 * j + e] + B[c];
            if (gb < n_rows) out[gb * N + c] = acc[4 * j + 2 + e] + B[c];
          }
        }
      }
    } else {
      const bool skip = d.skip[l + 1] != 0;
      const float s = skip ? inv_sqrt2 : 1.f;
      __syncwarp();  // every lane has loaded its last A fragment
#pragma unroll
      for (int j = 0; j < NT / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * t + e;
          if (c < N) {
            const float b = B[c];
            act_a[c] = softplus100(acc[4 * j + e] + b) * s;
            act_b[c] = softplus100(acc[4 * j + 2 + e] + b) * s;
          }
        }
      }
      if (skip) {  // PE(x) again, re-read from device memory
        for (int c = t; c < d.d_x; c += 4) {
          cp_async4(act_a + N + c, x_pe + (ga < n_rows ? ga : 0) * d.d_x + c,
                    ga < n_rows);
          cp_async4(act_b + N + c, x_pe + (gb < n_rows ? gb : 0) * d.d_x + c,
                    gb < n_rows);
        }
        cp_async_wait_all();
        for (int c = t; c < d.d_x; c += 4) {
          act_a[N + c] *= s;
          act_b[N + c] *= s;
        }
      }
      __syncwarp();
    }
  }
}

}  // namespace

extern "C" {

// Widest layer the kernel covers (its wgmma N); the Python side packs the
// weights to it and checks it.
int sdf_mlp_max_width() { return NT; }

// tc: the packed weights, (2 L NT, ka) f32 -- layer l's hi tile at rows
// [2l NT, (2l+1) NT), its lo tile after it, each (NT, ka) = W^T split, zero
// padded. bias: (L, NT) f32, zero padded.
int sdf_mlp_forward(const float* x_pe, const float* feats, const float* tc,
                    const float* bias, float* out, long long n_rows,
                    int n_layers, int d_x, int d_feat, int d_hidden, int ka,
                    const int* k_in, const int* n_out, const int* skip,
                    void* stream) {
  if (n_layers < 1 || n_layers > MAX_LAYERS || ka % KS != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  MlpDesc d;
  d.n_layers = n_layers;
  d.d_x = d_x;
  d.d_feat = d_feat;
  d.d_hidden = d_hidden;
  int kmax = 0;
  for (int l = 0; l < n_layers; ++l) {
    if (n_out[l] < 1 || n_out[l] > NT)
      return static_cast<int>(cudaErrorInvalidValue);
    d.k_pad[l] = (k_in[l] + 7) / 8 * 8;
    d.n_out[l] = n_out[l];
    d.skip[l] = skip[l];
    if (d.k_pad[l] > kmax) kmax = d.k_pad[l];
  }
  if (kmax > ka) return static_cast<int>(cudaErrorInvalidValue);
  // the buffer holds [hidden | feats] and the zeros up to the last k-step
  const int width = d_hidden + d_feat > kmax ? d_hidden + d_feat : kmax;
  d.ld = (width + 7) / 8 * 8 + 4;
  const size_t smem = 1024 + static_cast<size_t>(STAGES) * STAGE_BYTES +
                      sizeof(float) * TM * d.ld + 2 * STAGES * sizeof(uint64_t);
  CUtensorMap wmap;
  int rc = encode_2d(&wmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                     const_cast<float*>(tc), ka, 2ull * n_layers * NT,
                     sizeof(float) * ka, KS, NT, CU_TENSOR_MAP_SWIZZLE_64B);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      sdf_mlp_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_rows > 0) {
    const long long grid = (n_rows + TM - 1) / TM;
    sdf_mlp_tc_kernel<<<static_cast<unsigned>(grid), THREADS, smem,
                        static_cast<cudaStream_t>(stream)>>>(
        wmap, x_pe, feats, bias, out, n_rows, d);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
