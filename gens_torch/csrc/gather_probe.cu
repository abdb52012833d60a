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
// k-chunk of the table is multiplied, including those no index hits. A CTA
// owns 128 output rows and up to 128 columns (grid.y walks wider tables);
// per k-chunk of 64 table rows it builds the one-hot A tile (128 x 64 bf16)
// in shared memory from its indices, streams the chunk of the table into
// shared memory (both with rows padded by 16 bytes against bank conflicts)
// rounded f32 -> bf16 with round-to-nearest-even
// (__float2bfloat16_rn, as astype), and each of its 8 warps multiplies its
// 16 rows by the chunk on the tensor cores (nvcuda::wmma, bf16 m16n16k16
// with f32 accumulators). The width is padded to a multiple of 16 and the
// table rows to a multiple of 64 with zeros; ragged rows and columns are
// masked at the store. The result is exact -- one nonzero term, f32 sums --
// except that a non-finite table entry gives 0 * inf = NaN in its column.
// An index outside [0, rows) matches no table row and gives a zero row.
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
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// -- row gather ----------------------------------------------------------------

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

// -- one-hot product -------------------------------------------------------------

constexpr int TM = 128;  // output rows (indices) of a CTA: 8 warps x 16
constexpr int TN = 128;  // output columns of a CTA: 8 tiles of 16
constexpr int KC = 64;   // table rows per k-chunk
constexpr int NT = TN / 16;
// shared-memory row pitches, padded by 16 bytes so that the 16 rows of a
// wmma tile fall in different banks
constexpr int LDA = KC + 8;
constexpr int LDB = TN + 8;
static_assert(TM * KC / 2 % THREADS == 0 && KC * TN / 2 % THREADS == 0,
              "the tile builds split evenly over the threads");

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);  // exact: x is a bf16 value or 0
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
onehot_kernel(const int* __restrict__ idx, const T* __restrict__ table,
              T* __restrict__ out, long long n, int rows, int width) {
  using namespace nvcuda;
  __shared__ __align__(32) __nv_bfloat16 a_s[TM * LDA];  // 18 KB
  __shared__ __align__(32) __nv_bfloat16 b_s[KC * LDB];  // 17 KB
  __shared__ __align__(32) float c_s[THREADS / 32][16 * 16];  // 8 KB
  __shared__ int idx_s[TM];

  const long long m0 = static_cast<long long>(blockIdx.x) * TM;
  const int n0 = blockIdx.y * TN;
  const int ncols = min(TN, width - n0);
  const int ntiles = (ncols + 15) / 16;  // the same for every warp
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  for (int m = tid; m < TM; m += THREADS)
    idx_s[m] = m0 + m < n ? idx[m0 + m] : -1;  // -1 matches no table row

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) wmma::fill_fragment(acc[j], 0.0f);

  for (int k0 = 0; k0 < rows; k0 += KC) {
    __syncthreads();  // the last chunk's tiles are read (and idx_s written)
    // two bf16 per 4-byte store; the loops are unrolled so that a thread's
    // loads of the table chunk are all in flight at once
#pragma unroll
    for (int it = 0; it < TM * KC / 2 / THREADS; ++it) {
      const int e = tid + it * THREADS;
      const int m = e / (KC / 2), k = 2 * (e % (KC / 2));
      const int i = idx_s[m];
      *reinterpret_cast<__nv_bfloat162*>(a_s + m * LDA + k) =
          __floats2bfloat162_rn(i == k0 + k ? 1.0f : 0.0f,
                                i == k0 + k + 1 ? 1.0f : 0.0f);
    }
#pragma unroll
    for (int it = 0; it < KC * TN / 2 / THREADS; ++it) {
      const int e = tid + it * THREADS;
      const int k = e / (TN / 2), c = 2 * (e % (TN / 2));
      float v0 = 0.0f, v1 = 0.0f;
      if (k0 + k < rows) {
        const T* row = table + static_cast<long long>(k0 + k) * width + n0;
        if (c < ncols) v0 = to_float(row[c]);
        if (c + 1 < ncols) v1 = to_float(row[c + 1]);
      }
      *reinterpret_cast<__nv_bfloat162*>(b_s + k * LDB + c) =
          __floats2bfloat162_rn(v0, v1);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          a;
      wmma::load_matrix_sync(a, a_s + warp * 16 * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j < ntiles) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major>
              b;
          wmma::load_matrix_sync(b, b_s + kk * LDB + j * 16, LDB);
          wmma::mma_sync(acc[j], a, b, acc[j]);
        }
      }
    }
  }

  // through the warp's scratch tile to the masked, cast store
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j < ntiles) {
      wmma::store_matrix_sync(c_s[warp], acc[j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const long long m = m0 + warp * 16 + e / 16;
        const int col = j * 16 + e % 16;
        if (m < n && col < ncols) store(out + m * width + n0 + col, c_s[warp][e]);
      }
      __syncwarp();
    }
  }
}

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

// idx (n,) int32; table (rows, width) and out (n, width), both bf16
// (bf16 = 1) or both f32.
int onehot_gather(const int* idx, const void* table, void* out, long long n,
                  int rows, int width, int bf16, cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid(static_cast<unsigned>((n + TM - 1) / TM),
                  static_cast<unsigned>((width + TN - 1) / TN));
  if (bf16)
    onehot_kernel<__nv_bfloat16><<<grid, THREADS, 0, stream>>>(
        idx, static_cast<const __nv_bfloat16*>(table),
        static_cast<__nv_bfloat16*>(out), n, rows, width);
  else
    onehot_kernel<float><<<grid, THREADS, 0, stream>>>(
        idx, static_cast<const float*>(table), static_cast<float*>(out), n,
        rows, width);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
