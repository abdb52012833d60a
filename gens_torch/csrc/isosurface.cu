// K5: the isosurface of an SDF grid on the card -- marching tetrahedra, its
// output bit-equal to native/isosurface.cpp's on the same grid: the same
// vertices and triangles in the same order, with the same winding.
//
// Replaces no Pallas kernel: gens_tpu meshes on the host with
// native/isosurface.cpp (gens_tpu/mesh/isosurface.py), and so did the port
// until this kernel. The host code walks every cube on one thread and dedups
// each crossed edge's vertex through a hash map; at 512^3 that is ~5-6 s a
// scene, while the card reads the 512 MB grid in ~0.16 ms.
//
// The host's order, computed in parallel. Cubes go in x, y, z order (z
// fastest); a cube splits into 6 tetrahedra around its 0-7 diagonal (corner
// c = dx*4 + dy*2 + dz); a tetrahedron with corners on both sides of the level
// calls ev(a, b) on each of its crossed edges in a fixed order, then emits 1
// or 2 triangles. A vertex is made at the first ev call on its edge. Every
// cube whose decomposition holds a crossed edge is mixed and calls ev on it,
// so the vertex belongs to the lowest cube holding the edge (its owner), at
// the edge's first call there. A cube's 19 edges are (lo, hi = lo | d) with
// lo & d == 0; a cube owns an edge unless, on some axis where both of its
// ends sit at offset 0, the cube's coordinate is above 0 (then the cube one
// below on each such axis owns it). So each cube makes a fixed number of new
// vertices and triangles, and a vertex's index is its owner's first vertex
// index plus the count of owned edges first called before it in the owner's
// sequence. No hash table, and no atomic decides a position:
//   1. count: a CTA takes a tile of 1024 cubes in 4 rounds of 256; each
//      mixed cube counts its owned crossed edges and its triangles; a block
//      scan gives each mixed cube its vertex offset within the tile (uint16,
//      at most 19 * 1024) and the tile's two totals;
//   2. scan: one CTA turns the tiles' totals into exclusive offsets, the
//      grand totals after the last tile;
//   3. emit (after the host reads the totals and sizes the outputs): each
//      mixed cube walks its tetrahedra as the host does; a new owned vertex
//      is written at its owner offset + rank; an edge owned by a lower cube
//      takes that cube's offset + the edge's rank there, recomputed from
//      the owner's 8 corner values; triangles go at the cube's triangle
//      offset (the tile's, plus a block scan).
// The arithmetic is the host's, operation for operation, each rounded on its
// own (__fadd_rn, __fsub_rn, __fmul_rn, __fdiv_rn; nvcc would otherwise
// contract a product and a sum into an FMA, and a contracted sign test flips
// the winding of a near-degenerate triangle; the host's g++ -O3 has no FMA):
// t = (iso - va) / (vb - va), 0.5 where the denominator is 0, clamped to
// [0, 1]; a + t * (b - a) on the corners' float coordinates; emit_oriented's
// cross product, centroid and dot product.
//
// What bounds it: bytes. The count and emit passes each read the grid once
// (neighbouring cubes share corners through L1 and L2) and the mesh is
// written once: ~0.35 ms at 512^3 against the 0.16 ms of one read at
// 3.35 TB/s. Scratch: the uint16 tile offsets (2 bytes a cube) and the tiles'
// totals.
//
// Built by gens_torch/ops/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes (gens_torch/ops/isosurface.py). The launches go
// on the caller's stream, do not synchronise, allocate nothing, and each
// entry returns a cudaError_t code.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROUNDS = 4;
constexpr int TILE = THREADS * ROUNDS;  // cubes a CTA in the count and emit
constexpr int SCAN_THREADS = 1024;
constexpr int N_EDGES = 19;
// The middle corners of the 6 tetrahedra (0, m1, m2, 7) of native/
// isosurface.cpp's kTets, a nibble each: (5,1) (1,3) (3,2) (2,6) (6,4) (4,5).
constexpr unsigned long long mids(int t, int m1, int m2) {
  return static_cast<unsigned long long>(m1 | m2 << 4) << (8 * t);
}
constexpr unsigned long long TET_MID = mids(0, 5, 1) | mids(1, 1, 3) |
                                       mids(2, 3, 2) | mids(3, 2, 6) |
                                       mids(4, 6, 4) | mids(5, 4, 5);

struct Grid {
  const float* g;
  int ny, nz;
  unsigned cy, cz;     // cubes along y and z
  long long n_cubes;
  float iso;
};

__device__ __forceinline__ int tet_corner(int t, int i) {
  if (i == 0) return 0;
  if (i == 3) return 7;
  return static_cast<int>((TET_MID >> (4 * (2 * t + i - 1))) & 15);
}

// The slot (0..18) of the cube edge (lo, hi), hi = lo | d.
__device__ __forceinline__ int edge_slot(int lo, int hi) {
  switch (lo ^ hi) {
    case 4: return lo & 3;                               // x edges
    case 2: return 4 + (((lo >> 2) & 1) << 1 | (lo & 1));  // y edges
    case 1: return 8 + (lo >> 1);                        // z edges
    case 3: return 12 + (lo >> 2);                       // x-face diagonals
    case 5: return 14 + ((lo >> 1) & 1);                 // y-face diagonals
    case 6: return 16 + (lo & 1);                        // z-face diagonals
    default: return 18;                                  // 0-7
  }
}

// The axes (bit 4 x, 2 y, 1 z) on which an edge whose upper end is corner hi
// has both ends at offset 0, and the cube lies above 0 (pos): the owner is
// the cube one below on each. 0: the cube owns the edge.
__device__ __forceinline__ int owner_shift(int hi, int pos) {
  return ~hi & pos & 7;
}

__device__ __forceinline__ float pick(const float (&v)[8], int i) {
  float r = v[0];
#pragma unroll
  for (int k = 1; k < 8; ++k) r = i == k ? v[k] : r;
  return r;
}

__device__ __forceinline__ void cube_of(const Grid& G, long long idx, int& x,
                                        int& y, int& z) {
  const unsigned i = static_cast<unsigned>(idx);
  const unsigned r = i / G.cz;
  z = static_cast<int>(i - r * G.cz);
  x = static_cast<int>(r / G.cy);
  y = static_cast<int>(r - static_cast<unsigned>(x) * G.cy);
}

// The 8 corner values of cube (x, y, z); returns the mask of those below iso.
__device__ __forceinline__ int load_cube(const Grid& G, int x, int y, int z,
                                         float (&cv)[8]) {
  const long long sx = static_cast<long long>(G.ny) * G.nz, sy = G.nz;
  const float* p = G.g + x * sx + y * sy + z;
  int below = 0;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    cv[c] = __ldg(p + ((c >> 2) & 1) * sx + ((c >> 1) & 1) * sy + (c & 1));
    below |= (cv[c] < G.iso) << c;
  }
  return below;
}

__device__ __forceinline__ int pos_mask(int x, int y, int z) {
  return (x > 0) << 2 | (y > 0) << 1 | (z > 0);
}

// One tetrahedron's ev calls as the host's do_tet makes them: call k is
// (a, b) = nibble k of a and of b; n calls (0, 3 or 4), ntri triangles; the
// corners below iso, a nibble each, n_in of them.
struct Tet {
  unsigned a, b, ins;
  int n, ntri, n_in;
};

__device__ __forceinline__ Tet tet_calls(int t, int below) {
  unsigned ins = 0, outs = 0;
  int n_in = 0, n_out = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned c = tet_corner(t, i);
    if ((below >> c) & 1) {
      ins |= c << (4 * n_in++);
    } else {
      outs |= c << (4 * n_out++);
    }
  }
  Tet r;
  r.ins = ins;
  r.n_in = n_in;
  r.a = r.b = 0;
  if (n_in == 0 || n_in == 4) {
    r.n = r.ntri = 0;
  } else if (n_in & 1) {
    // the lone corner to each of the other three, in the tet's order
    const unsigned lone = (n_in == 1 ? ins : outs) & 15;
    int k = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned c = tet_corner(t, i);
      if (c != lone) r.b |= c << (4 * k++);
    }
    r.a = lone * 0x111u;
    r.n = 3;
    r.ntri = 1;
  } else {
    // (a, c1) (a, c2) (b, c2) (b, c1)
    const unsigned a = ins & 15, b = (ins >> 4) & 15;
    const unsigned c1 = outs & 15, c2 = (outs >> 4) & 15;
    r.a = a | a << 4 | b << 8 | b << 12;
    r.b = c1 | c2 << 4 | c2 << 8 | c1 << 12;
    r.n = 4;
    r.ntri = 2;
  }
  return r;
}

__device__ __forceinline__ int cube_tris(int below) {
  int n = 0;
#pragma unroll
  for (int t = 0; t < 6; ++t) {
    int n_in = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) n_in += (below >> tet_corner(t, i)) & 1;
    n += (n_in == 2) ? 2 : (n_in & 1);
  }
  return n;
}

// The crossed edges the cube owns: the vertices it makes.
__device__ __forceinline__ int cube_verts(int below, int pos) {
  int n = 0;
#pragma unroll
  for (int lo = 0; lo < 8; ++lo) {
#pragma unroll
    for (int d = 1; d < 8; ++d) {
      if (lo & d) continue;
      const int hi = lo | d;
      n += (((below >> lo) ^ (below >> hi)) & 1) && !owner_shift(hi, pos);
    }
  }
  return n;
}

// Exclusive block scan of two values over NT threads; every thread calls it.
template <int NT, typename T>
__device__ __forceinline__ void block_scan(T v, T w, T& ev, T& ew, T& sv,
                                           T& sw) {
  constexpr int NW = NT / 32;
  __shared__ T part_v[NW], part_w[NW];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T iv = v, iw = w;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T a = __shfl_up_sync(0xffffffffu, iv, o);
    const T b = __shfl_up_sync(0xffffffffu, iw, o);
    if (lane >= o) {
      iv += a;
      iw += b;
    }
  }
  if (lane == 31) {
    part_v[warp] = iv;
    part_w[warp] = iw;
  }
  __syncthreads();
  if (warp == 0) {
    T x = lane < NW ? part_v[lane] : T(0);
    T y = lane < NW ? part_w[lane] : T(0);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const T a = __shfl_up_sync(0xffffffffu, x, o);
      const T b = __shfl_up_sync(0xffffffffu, y, o);
      if (lane >= o) {
        x += a;
        y += b;
      }
    }
    if (lane < NW) {
      part_v[lane] = x;
      part_w[lane] = y;
    }
  }
  __syncthreads();
  const T bv = warp ? part_v[warp - 1] : T(0);
  const T bw = warp ? part_w[warp - 1] : T(0);
  ev = bv + iv - v;
  ew = bw + iw - w;
  sv = part_v[NW - 1];
  sw = part_w[NW - 1];
  __syncthreads();  // part_* is reused by the next call
}

// 1. Per tile: each mixed cube's vertex offset within the tile, and the
// tile's vertex and triangle totals into offs[2 tile], offs[2 tile + 1].
__global__ void __launch_bounds__(THREADS)
    count_kernel(Grid G, uint16_t* __restrict__ prefix,
                 long long* __restrict__ offs) {
  const long long tile0 = static_cast<long long>(blockIdx.x) * TILE;
  int carry_v = 0, carry_t = 0;
  for (int r = 0; r < ROUNDS; ++r) {
    const long long idx = tile0 + r * THREADS + threadIdx.x;
    int nv = 0, nt = 0;
    bool mixed = false;
    if (idx < G.n_cubes) {
      int x, y, z;
      cube_of(G, idx, x, y, z);
      float cv[8];
      const int below = load_cube(G, x, y, z, cv);
      mixed = below != 0 && below != 255;
      if (mixed) {
        nv = cube_verts(below, pos_mask(x, y, z));
        nt = cube_tris(below);
      }
    }
    int ev, et, sv, st;
    block_scan<THREADS>(nv, nt, ev, et, sv, st);
    if (mixed) prefix[idx] = static_cast<uint16_t>(carry_v + ev);
    carry_v += sv;
    carry_t += st;
  }
  if (threadIdx.x == 0) {
    offs[2 * blockIdx.x] = carry_v;
    offs[2 * blockIdx.x + 1] = carry_t;
  }
}

// 2. The tiles' totals to exclusive offsets in place; the grand totals into
// row n_tiles. One CTA.
__global__ void __launch_bounds__(SCAN_THREADS)
    scan_kernel(long long* __restrict__ offs, long long n_tiles) {
  long long carry_v = 0, carry_t = 0;
  for (long long base = 0; base < n_tiles; base += SCAN_THREADS) {
    const long long i = base + threadIdx.x;
    const long long v = i < n_tiles ? offs[2 * i] : 0;
    const long long w = i < n_tiles ? offs[2 * i + 1] : 0;
    long long ev, ew, sv, sw;
    block_scan<SCAN_THREADS>(v, w, ev, ew, sv, sw);
    if (i < n_tiles) {
      offs[2 * i] = carry_v + ev;
      offs[2 * i + 1] = carry_t + ew;
    }
    carry_v += sv;
    carry_t += sw;
  }
  if (threadIdx.x == 0) {
    offs[2 * n_tiles] = carry_v;
    offs[2 * n_tiles + 1] = carry_t;
  }
}

// The vertex on edge (a, b) of cube (x, y, z), as the host's edge_vertex
// makes it when ev(a, b) is the edge's first call.
__device__ __forceinline__ float3 edge_point(const Grid& G, int x, int y,
                                             int z, const float (&cv)[8],
                                             int a, int b) {
  const float va = pick(cv, a), vb = pick(cv, b);
  const float denom = __fsub_rn(vb, va);
  float t = denom == 0.0f ? 0.5f : __fdiv_rn(__fsub_rn(G.iso, va), denom);
  if (t < 0.0f) t = 0.0f;
  if (t > 1.0f) t = 1.0f;
  const int ax = x + ((a >> 2) & 1), ay = y + ((a >> 1) & 1), az = z + (a & 1);
  const int dx = ((b >> 2) & 1) - ((a >> 2) & 1);
  const int dy = ((b >> 1) & 1) - ((a >> 1) & 1);
  const int dz = (b & 1) - (a & 1);
  return make_float3(
      __fadd_rn(static_cast<float>(ax), __fmul_rn(t, static_cast<float>(dx))),
      __fadd_rn(static_cast<float>(ay), __fmul_rn(t, static_cast<float>(dy))),
      __fadd_rn(static_cast<float>(az), __fmul_rn(t, static_cast<float>(dz))));
}

// The rank of edge slot `target` among the vertices cube (x, y, z) makes (it
// owns the edge), and the corner its first call passes as a.
__device__ __noinline__ int owner_rank(const Grid& G, int x, int y, int z,
                                       int target, int* first_a) {
  float cv[8];
  const int below = load_cube(G, x, y, z, cv);
  const int pos = pos_mask(x, y, z);
  unsigned seen = 0;
  int rank = 0;
  for (int t = 0; t < 6; ++t) {
    const Tet T = tet_calls(t, below);
    for (int k = 0; k < T.n; ++k) {
      const int a = (T.a >> (4 * k)) & 15, b = (T.b >> (4 * k)) & 15;
      const int lo = min(a, b), hi = max(a, b);
      const int s = edge_slot(lo, hi);
      if ((seen >> s) & 1) continue;
      seen |= 1u << s;
      if (s == target) {
        *first_a = a;
        return rank;
      }
      rank += !owner_shift(hi, pos);
    }
  }
  return -1;  // unreachable: the owner of a crossed edge calls ev on it
}

// The host's emit_oriented: (p, q, r) or (p, r, q), the normal toward the
// below-iso side.
__device__ __forceinline__ bool wound_as_given(float3 va, float3 vb, float3 vc,
                                               float3 in) {
  const float ux = __fsub_rn(vb.x, va.x), uy = __fsub_rn(vb.y, va.y),
              uz = __fsub_rn(vb.z, va.z);
  const float wx = __fsub_rn(vc.x, va.x), wy = __fsub_rn(vc.y, va.y),
              wz = __fsub_rn(vc.z, va.z);
  const float nx = __fsub_rn(__fmul_rn(uy, wz), __fmul_rn(uz, wy));
  const float ny = __fsub_rn(__fmul_rn(uz, wx), __fmul_rn(ux, wz));
  const float nz = __fsub_rn(__fmul_rn(ux, wy), __fmul_rn(uy, wx));
  const float cx = __fsub_rn(
      __fdiv_rn(__fadd_rn(__fadd_rn(va.x, vb.x), vc.x), 3.0f), in.x);
  const float cy = __fsub_rn(
      __fdiv_rn(__fadd_rn(__fadd_rn(va.y, vb.y), vc.y), 3.0f), in.y);
  const float cz = __fsub_rn(
      __fdiv_rn(__fadd_rn(__fadd_rn(va.z, vb.z), vc.z), 3.0f), in.z);
  const float dot = __fadd_rn(__fadd_rn(__fmul_rn(nx, cx), __fmul_rn(ny, cy)),
                              __fmul_rn(nz, cz));
  return dot < 0.0f;
}

__device__ __forceinline__ float3 corner_point(int x, int y, int z, int c) {
  return make_float3(static_cast<float>(x + ((c >> 2) & 1)),
                     static_cast<float>(y + ((c >> 1) & 1)),
                     static_cast<float>(z + (c & 1)));
}

// Everything one mixed cube writes: its new vertices from index vbase, its
// triangles from index tbase.
__device__ void emit_cube(const Grid& G, int x, int y, int z,
                          const float (&cv)[8], int below, long long vbase,
                          long long tbase, const uint16_t* __restrict__ prefix,
                          const long long* __restrict__ offs,
                          float* __restrict__ verts, int* __restrict__ tris) {
  const int pos = pos_mask(x, y, z);
  unsigned seen = 0, first_lo = 0;  // first_lo: the first call's a is lo
  int ids[N_EDGES];
  int rank = 0;
  for (int t = 0; t < 6; ++t) {
    const Tet T = tet_calls(t, below);
    if (T.n == 0) continue;
    int loc[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k >= T.n) break;
      const int a = (T.a >> (4 * k)) & 15, b = (T.b >> (4 * k)) & 15;
      const int lo = min(a, b), hi = max(a, b);
      const int s = edge_slot(lo, hi);
      loc[k] = s;
      if ((seen >> s) & 1) continue;
      seen |= 1u << s;
      const int sh = owner_shift(hi, pos);
      if (!sh) {
        const long long id = vbase + rank++;
        ids[s] = static_cast<int>(id);
        first_lo |= static_cast<unsigned>(a == lo) << s;
        const float3 p = edge_point(G, x, y, z, cv, a, b);
        verts[3 * id] = p.x;
        verts[3 * id + 1] = p.y;
        verts[3 * id + 2] = p.z;
      } else {
        const int ox = x - ((sh >> 2) & 1), oy = y - ((sh >> 1) & 1),
                  oz = z - (sh & 1);
        int oa;
        const int r = owner_rank(G, ox, oy, oz, edge_slot(lo | sh, hi | sh),
                                 &oa);
        const long long o =
            (static_cast<long long>(ox) * G.cy + oy) * G.cz + oz;
        ids[s] = static_cast<int>(offs[2 * (o / TILE)] + prefix[o] + r);
        first_lo |= static_cast<unsigned>((oa & ~sh) == lo) << s;
      }
    }
    // the inside point: the mean of the corners below iso
    float3 in;
    if (T.ntri == 1) {
      in = make_float3(0.0f, 0.0f, 0.0f);
      const float n = static_cast<float>(T.n_in);
      for (int i = 0; i < T.n_in; ++i) {
        const float3 c = corner_point(x, y, z, (T.ins >> (4 * i)) & 15);
        in.x = __fadd_rn(in.x, __fdiv_rn(c.x, n));
        in.y = __fadd_rn(in.y, __fdiv_rn(c.y, n));
        in.z = __fadd_rn(in.z, __fdiv_rn(c.z, n));
      }
    } else {
      const float3 ca = corner_point(x, y, z, T.ins & 15);
      const float3 cb = corner_point(x, y, z, (T.ins >> 4) & 15);
      in = make_float3(__fmul_rn(__fadd_rn(ca.x, cb.x), 0.5f),
                       __fmul_rn(__fadd_rn(ca.y, cb.y), 0.5f),
                       __fmul_rn(__fadd_rn(ca.z, cb.z), 0.5f));
    }
    float3 p[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k >= T.n) break;
      const int s = loc[k];
      const int a = (T.a >> (4 * k)) & 15, b = (T.b >> (4 * k)) & 15;
      const int lo = min(a, b), hi = max(a, b);
      p[k] = (first_lo >> s) & 1 ? edge_point(G, x, y, z, cv, lo, hi)
                                 : edge_point(G, x, y, z, cv, hi, lo);
    }
    // triangles (0, 1, 2), then (0, 2, 3) of a quad
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (j >= T.ntri) break;
      const int q1 = j + 1, q2 = j + 2;
      const int i0 = ids[loc[0]], i1 = ids[loc[q1]], i2 = ids[loc[q2]];
      const bool keep = wound_as_given(p[0], p[q1], p[q2], in);
      int* out = tris + 3 * tbase++;
      out[0] = i0;
      out[1] = keep ? i1 : i2;
      out[2] = keep ? i2 : i1;
    }
  }
}

// 3. Each mixed cube's vertices and triangles.
__global__ void __launch_bounds__(THREADS)
    emit_kernel(Grid G, const uint16_t* __restrict__ prefix,
                const long long* __restrict__ offs, float* __restrict__ verts,
                int* __restrict__ tris) {
  const long long tbase0 = offs[2 * blockIdx.x + 1];
  if (offs[2 * blockIdx.x + 3] == tbase0) return;  // no mixed cube in the tile
  const long long vbase0 = offs[2 * blockIdx.x];
  const long long tile0 = static_cast<long long>(blockIdx.x) * TILE;
  long long carry_t = tbase0;
  for (int r = 0; r < ROUNDS; ++r) {
    const long long idx = tile0 + r * THREADS + threadIdx.x;
    int x = 0, y = 0, z = 0, below = 0, nt = 0;
    float cv[8];
    if (idx < G.n_cubes) {
      cube_of(G, idx, x, y, z);
      below = load_cube(G, x, y, z, cv);
      if (below != 0 && below != 255) nt = cube_tris(below);
    }
    int ev, et, sv, st;
    block_scan<THREADS>(0, nt, ev, et, sv, st);
    if (nt) {
      emit_cube(G, x, y, z, cv, below, vbase0 + prefix[idx], carry_t + et,
                prefix, offs, verts, tris);
    }
    carry_t += st;
  }
}

bool make_grid(const float* grid, int nx, int ny, int nz, float iso,
               Grid* G, long long* n_tiles) {
  if (nx < 0 || ny < 0 || nz < 0) return false;
  G->g = grid;
  G->ny = ny;
  G->nz = nz;
  G->iso = iso;
  const long long cx = nx > 1 ? nx - 1 : 0, cy = ny > 1 ? ny - 1 : 0,
                  cz = nz > 1 ? nz - 1 : 0;
  G->cy = static_cast<unsigned>(cy);
  G->cz = static_cast<unsigned>(cz);
  G->n_cubes = cx * cy * cz;
  if (G->n_cubes >= (1ll << 31)) return false;  // cube indices as unsigned
  *n_tiles = (G->n_cubes + TILE - 1) / TILE;
  return true;
}

}  // namespace

extern "C" {

// Passes 1 and 2 on grid (nx, ny, nz) f32, contiguous, on the device.
// prefix: one uint16 a cube; offs: (n_tiles + 1) x 2 int64, n_tiles =
// ceil((nx-1)(ny-1)(nz-1) / isosurface_tile()). After it, row n_tiles of
// offs holds the vertex and triangle totals.
int isosurface_count(const float* grid, int nx, int ny, int nz, float iso,
                     uint16_t* prefix, long long* offs, void* stream) {
  Grid G;
  long long n_tiles;
  if (!make_grid(grid, nx, ny, nz, iso, &G, &n_tiles))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_tiles > 0) {
    count_kernel<<<static_cast<unsigned>(n_tiles), THREADS, 0, s>>>(
        G, prefix, offs);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  scan_kernel<<<1, SCAN_THREADS, 0, s>>>(offs, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

// Pass 3, after isosurface_count on the same grid: verts (V, 3) f32 and tris
// (T, 3) int32, sized by the totals it left in offs.
int isosurface_emit(const float* grid, int nx, int ny, int nz, float iso,
                    const uint16_t* prefix, const long long* offs,
                    float* verts, int* tris, void* stream) {
  Grid G;
  long long n_tiles;
  if (!make_grid(grid, nx, ny, nz, iso, &G, &n_tiles))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_tiles == 0) return 0;
  emit_kernel<<<static_cast<unsigned>(n_tiles), THREADS, 0,
                static_cast<cudaStream_t>(stream)>>>(G, prefix, offs, verts,
                                                     tris);
  return static_cast<int>(cudaGetLastError());
}

int isosurface_tile() { return TILE; }

}  // extern "C"
