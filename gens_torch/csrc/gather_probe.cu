// P1, P2 and P3: the gather probes, for Hopper (sm_90a).
//
// Replaces the Pallas kernels of the TPU gather-cost probes:
//   P1  scripts/gather_probe.py::vmem_gather_kernel   jnp.take(table, idx, 0)
//   P2  scripts/gather_probe2.py::k_tala              take_along_axis form
//   P3  scripts/gather_probe2.py::k_onehot            onehot(idx) @ table
//
// row_gather (P1 and P2): out[n] = table[clamp(idx[n], 0, rows - 1)].
// P1 and P2 compute the same function; they differ only in how Mosaic lowers
// a gather from VMEM, which has no Hopper counterpart, so one kernel serves
// both. An index outside [0, rows) is outside the probes' contract (every
// probe draws idx % rows); the kernel clamps it, as XLA's gather does, so it
// never reads outside the table.
//
// The TPU probe keeps the whole table VMEM-resident. Here the table is read
// through L2: every probe table (0.16-7.8 MB) fits the 50 MB L2, and only
// the (729, 108) bf16 one (157 KB) would fit 227 KB of shared memory, so
// "VMEM-resident" maps to "L2-resident". A group of G threads copies one
// output row (G a power of two up to a warp, from the row's width) with
// 16-byte vector loads and stores where the row allows them. A row whose
// byte width is a multiple of 8 but not 16 (a bf16 row of 108 is 216 B)
// takes 16-byte units when its source and destination share their phase
// mod 16 -- an 8-byte head or tail around a 16-byte body -- and 8-byte units
// otherwise.
//
// What bounds it: bytes. Per output row the index (4 B) is read and the row
// written once, and each touched table row read once: 2^20 rows of 128 f32
// are 0.54 GB, 0.16 ms at 3.35 TB/s. There is no arithmetic.
//
// onehot_gather (P3): out = (onehot(idx) as bf16) @ bf16(table), the sum in
// f32, cast to the table's dtype. The point of k_onehot is that the matrix
// unit does the addressing, so the product stays dense, as on the TPU: every
// k-chunk of the table is multiplied, including those no index hits.
//
// A pre-pass writes the table once as bf16 (rounded to nearest even, as
// astype), transposed to (width, rows) -- the K-major B operand -- with the
// width padded to 16 and the rows to the 64-row k-chunk with zeros, into
// scratch the wrapper allocates. The product kernel is warp-specialised: a
// CTA owns 256 output rows and 128 columns (grid.y walks wider tables); one
// producer thread streams the (128 columns x 64 rows) chunks of the table by
// TMA, 128-byte swizzled, through a ring of 4 stages with mbarriers; two
// consumer warpgroups of two m64 tiles each multiply them with
// wgmma.m64n128k16 (bf16, f32 accumulators in registers). The one-hot A
// operand never exists in memory: each thread holds the indices of its 4
// rows and builds its A fragments for a k-step by comparison, in registers.
// The output is stored from the accumulators, masked at the ragged rows and
// columns. The result is exact -- one nonzero term, f32 sums -- except that
// a non-finite table entry gives 0 * inf = NaN in its column. An index
// outside [0, rows) matches no table row and gives a zero row.
//
// What bounds it: operations. 2 N rows W flop of bf16 tensor-core work
// (2^20 x 4096 x 128: 1.1e12, 1.1 ms at 989 TFLOP/s) against the same bytes
// as a gather. A gather needs far less time for the same function; that is
// the probe's finding on this card, not a fault.
//
// Built by gens_torch/ops/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes. Launches go on the caller's stream, do not
// synchronise, allocate nothing, and each entry returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;

// -- row gather ---------------------------------------------------------------

template <int U>
struct Unit;
template <>
struct Unit<16> { using T = uint4; };
template <>
struct Unit<8> { using T = uint2; };
template <>
struct Unit<4> { using T = unsigned int; };
template <>
struct Unit<2> { using T = unsigned short; };

// lanes [0, G) of a group copy `count` units of U bytes from src to dst
template <int U, int G>
__device__ __forceinline__ void copy_units(const char* src, char* dst,
                                           int count, int lane) {
  using T = typename Unit<U>::T;
  const T* s = reinterpret_cast<const T*>(src);
  T* d = reinterpret_cast<T*>(dst);
  for (int i = lane; i < count; i += G) d[i] = s[i];
}

// one row of `bytes` (a multiple of 8) between 8-byte aligned addresses
template <int G>
__device__ __forceinline__ void copy_row8(const char* s, char* d, int bytes,
                                          int lane) {
  const uintptr_t ps = reinterpret_cast<uintptr_t>(s);
  const uintptr_t pd = reinterpret_cast<uintptr_t>(d);
  if (((ps ^ pd) & 15) != 0) {  // phases differ: 8-byte units throughout
    copy_units<8, G>(s, d, bytes / 8, lane);
    return;
  }
  const int head = (ps & 15) ? 8 : 0;
  const int body = (bytes - head) / 16;
  const int tail = head + body * 16;  // bytes - tail is 0 or 8
  if (head && lane == 0)
    *reinterpret_cast<uint2*>(d) = *reinterpret_cast<const uint2*>(s);
  copy_units<16, G>(s + head, d + head, body, lane);
  if (tail < bytes && lane == G - 1)
    *reinterpret_cast<uint2*>(d + tail) =
        *reinterpret_cast<const uint2*>(s + tail);
}

// GRAIN: the largest power of two <= 16 dividing the row's bytes and both
// base addresses (the wrapper computes it), so every row start is aligned
// to it. G threads per row.
template <int GRAIN, int G>
__global__ void __launch_bounds__(THREADS)
row_gather_kernel(const int* __restrict__ idx, const char* __restrict__ table,
                  char* __restrict__ out, long long n, int rows,
                  int row_bytes) {
  constexpr int kRowsPerBlock = THREADS / G;
  const int lane = threadIdx.x % G;
  const long long stride = static_cast<long long>(gridDim.x) * kRowsPerBlock;
  for (long long r = static_cast<long long>(blockIdx.x) * kRowsPerBlock +
                     threadIdx.x / G;
       r < n; r += stride) {
    const int i = min(max(idx[r], 0), rows - 1);
    const char* s = table + static_cast<long long>(i) * row_bytes;
    char* d = out + r * row_bytes;
    if (GRAIN == 8)
      copy_row8<G>(s, d, row_bytes, lane);
    else
      copy_units<GRAIN, G>(s, d, row_bytes / GRAIN, lane);
  }
}

template <int GRAIN>
void launch_row_gather(const int* idx, const char* table, char* out,
                       long long n, int rows, int row_bytes, int group,
                       cudaStream_t stream) {
  const long long rows_per_block = THREADS / group;
  long long blocks = (n + rows_per_block - 1) / rows_per_block;
  if (blocks > (1LL << 24)) blocks = 1LL << 24;  // the loop strides past it
  const dim3 grid(static_cast<unsigned>(blocks));
  switch (group) {
    case 4:
      row_gather_kernel<GRAIN, 4><<<grid, THREADS, 0, stream>>>(
          idx, table, out, n, rows, row_bytes);
      break;
    case 8:
      row_gather_kernel<GRAIN, 8><<<grid, THREADS, 0, stream>>>(
          idx, table, out, n, rows, row_bytes);
      break;
    case 16:
      row_gather_kernel<GRAIN, 16><<<grid, THREADS, 0, stream>>>(
          idx, table, out, n, rows, row_bytes);
      break;
    default:
      row_gather_kernel<GRAIN, 32><<<grid, THREADS, 0, stream>>>(
          idx, table, out, n, rows, row_bytes);
  }
}

// -- one-hot product ----------------------------------------------------------

namespace p3 {

constexpr int TM = 256;       // output rows of a CTA: 2 warpgroups x 2 m64
constexpr int BN = 128;       // output columns of a CTA (grid.y walks wider)
constexpr int KC = 64;        // table rows a stage: one 128-byte bf16 row
constexpr int STAGES = 4;
constexpr int THREADS = 288;  // 2 consumer warpgroups + 1 producer warp
constexpr int STAGE_BYTES = BN * KC * 2;  // 16 KB = 16 x 1024
constexpr int PRE = 32;       // pre-pass tile

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);  // exact: x is a bf16 value or 0
}
// two neighbours at an even element offset of an even-width row
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// tt (width_p, rows_p) = bf16(table)^T, rounded to nearest even as astype,
// zero outside the table: the K-major B operand of the product.
template <typename T>
__global__ void __launch_bounds__(PRE * 8)
onehot_prepass(const T* __restrict__ table, __nv_bfloat16* __restrict__ tt,
               int rows, int width, int rows_p, int width_p) {
  __shared__ float tile[PRE][PRE + 1];
  const int k0 = blockIdx.x * PRE, c0 = blockIdx.y * PRE;
  for (int i = threadIdx.y; i < PRE; i += 8) {
    const int k = k0 + i, c = c0 + threadIdx.x;
    tile[i][threadIdx.x] =
        k < rows && c < width
            ? to_float(table[static_cast<long long>(k) * width + c])
            : 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.y; i < PRE; i += 8) {
    const int c = c0 + i, k = k0 + threadIdx.x;
    if (c < width_p && k < rows_p)
      tt[static_cast<long long>(c) * rows_p + k] =
          __float2bfloat16_rn(tile[threadIdx.x][i]);
  }
}

// The pair of one-hot bf16 values at columns (c, c + 1) of a row whose
// index lies d = idx - c past c: 1.0 (0x3F80) where it matches.
__device__ __forceinline__ uint32_t onehot_pair(int d) {
  return (d == 0 ? 0x3F80u : 0u) | (d == 1 ? 0x3F800000u : 0u);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
onehot_tc_kernel(const __grid_constant__ CUtensorMap tmap,
                 const int* __restrict__ idx, T* __restrict__ out, long long n,
                 int width, int n_chunks) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  const int tid = threadIdx.x, lane = tid % 32;
  // warp-uniform as far as the compiler can tell, so that the wgmma of
  // the consumer branch are not serialised as if in a divergent path
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const long long m0 = static_cast<long long>(blockIdx.x) * TM;
  const int n0 = blockIdx.y * BN;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 8) {  // producer: (BN columns x KC table rows) a stage
    if (lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int c = 0; c < n_chunks; ++c) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_expect_tx(&full[stage], STAGE_BYTES);
        tma_load_2d(ring + stage * STAGE_BYTES, &tmap, c * KC, n0,
                    &full[stage]);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows [128 wg, 128 wg + 128) in two m64
  // tiles; a thread holds the indices of its rows g and g + 8 of each
  const int wg = warp / 4, g = lane / 4, t = lane % 4;
  int ix[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long m =
          m0 + 128 * wg + 64 * mt + 16 * (warp % 4) + g + 8 * h;
      ix[mt][h] = m < n ? idx[m] : -1;  // -1 matches no table row
    }
  float acc[2][64];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[mt][i] = 0.f;

  int stage = 0;
  uint32_t phase = 0;
  for (int c = 0; c < n_chunks; ++c) {
    // the one-hot A fragments of the chunk's 4 k-steps, built in registers
    uint32_t a[2 * (KC / 16)][4];  // [2 ks + mt]
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
      const int kb = c * KC + 16 * ks + 2 * t;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int d0 = ix[mt][0] - kb, d1 = ix[mt][1] - kb;
        a[2 * ks + mt][0] = onehot_pair(d0);
        a[2 * ks + mt][1] = onehot_pair(d1);
        a[2 * ks + mt][2] = onehot_pair(d0 - 8);
        a[2 * ks + mt][3] = onehot_pair(d1 - 8);
      }
    }
    mbar_wait(&full[stage], phase);
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    wgmma_fence();
    const uint64_t desc = sw128_desc(ring + stage * STAGE_BYTES);
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
      wgmma_m64n128k16_bf16(acc[0], a[2 * ks], desc + 2 * ks);
      wgmma_m64n128k16_bf16(acc[1], a[2 * ks + 1], desc + 2 * ks);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }

  // from the accumulators, masked at the ragged rows and columns
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long m =
          m0 + 128 * wg + 64 * mt + 16 * (warp % 4) + g + 8 * h;
      if (m >= n) continue;
      T* row = out + m * width;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * t;
        const float x = acc[mt][4 * j + 2 * h], y = acc[mt][4 * j + 2 * h + 1];
        if (col + 1 < width && width % 2 == 0) {
          store2(row + col, x, y);
        } else {
          if (col < width) store(row + col, x);
          if (col + 1 < width) store(row + col + 1, y);
        }
      }
    }
}

template <typename T>
int launch_onehot(const int* idx, const T* table, T* out, __nv_bfloat16* tt,
                  long long n, int rows, int width, cudaStream_t stream) {
  const int rows_p = (rows + KC - 1) / KC * KC;
  const int width_p = (width + 15) / 16 * 16;
  const dim3 pgrid(rows_p / PRE, (width_p + PRE - 1) / PRE);
  onehot_prepass<T><<<pgrid, dim3(PRE, 8), 0, stream>>>(table, tt, rows, width,
                                                        rows_p, width_p);
  CUtensorMap tmap;
  const int rc = hopper::encode_2d(&tmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, tt,
                                   rows_p, width_p, 2ull * rows_p, KC, BN,
                                   CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc != 0) return rc;
  const int smem = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;
  cudaError_t err = cudaFuncSetAttribute(
      onehot_tc_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((n + TM - 1) / TM),
                  static_cast<unsigned>((width + BN - 1) / BN));
  onehot_tc_kernel<T><<<grid, THREADS, smem, stream>>>(tmap, idx, out, n,
                                                       width, rows_p / KC);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace p3

}  // namespace

extern "C" {

// idx (n,) int32; table (rows, row_bytes) bytes of rows; out (n, row_bytes).
// grain (16, 8, 4 or 2) divides row_bytes and aligns table and out; group
// (4, 8, 16 or 32) threads copy a row (the wrapper picks both).
int row_gather(const int* idx, const void* table, void* out, long long n,
               int rows, int row_bytes, int grain, int group,
               cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const char* t = static_cast<const char*>(table);
  char* o = static_cast<char*>(out);
  switch (grain) {
    case 16:
      launch_row_gather<16>(idx, t, o, n, rows, row_bytes, group, stream);
      break;
    case 8:
      launch_row_gather<8>(idx, t, o, n, rows, row_bytes, group, stream);
      break;
    case 4:
      launch_row_gather<4>(idx, t, o, n, rows, row_bytes, group, stream);
      break;
    default:
      launch_row_gather<2>(idx, t, o, n, rows, row_bytes, group, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

// Bytes of the scratch onehot_gather needs: the bf16 table, transposed and
// padded (width to 16, rows to the k-chunk).
long long onehot_scratch_bytes(int rows, int width) {
  return 2LL * ((width + 15) / 16 * 16) *
         ((rows + p3::KC - 1) / p3::KC * p3::KC);
}

// idx (n,) int32; table (rows, width) and out (n, width), both bf16
// (bf16 = 1) or both f32; scratch: onehot_scratch_bytes(rows, width) bytes.
int onehot_gather(const int* idx, const void* table, void* out, void* scratch,
                  long long n, int rows, int width, int bf16,
                  cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  __nv_bfloat16* tt = static_cast<__nv_bfloat16*>(scratch);
  if (bf16)
    return p3::launch_onehot(idx, static_cast<const __nv_bfloat16*>(table),
                             static_cast<__nv_bfloat16*>(out), tt, n, rows,
                             width, stream);
  return p3::launch_onehot(idx, static_cast<const float*>(table),
                           static_cast<float*>(out), tt, n, rows, width,
                           stream);
}

}  // extern "C"
