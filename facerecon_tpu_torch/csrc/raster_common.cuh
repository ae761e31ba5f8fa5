// The z-tests of the rasterizer kernels, kept in one header so that they
// cannot drift apart: band_ztest (one thread a pixel; raster_select.cu,
// raster_pos.cu) and tile_ztest below (micro-tiled; raster_shade.cu).
//
// Per pixel, the lexicographic minimum of (depth, original face id) over
// the triangles that cover the pixel center, walking the band's union
// window [blo, blo + bn) of 128-row chunks: the column's masked chunks of
// the window's first 64, then every chunk beyond them (spatially
// incoherent face orders). It computes what the z-test phase of
// facerecon_tpu/ops/rasterize_pallas.py::_kernel computes.
//
// Setup layout (B, 16, rows) f32, row-major: fields 0..5 affine w0/w1
// forms [wa0 wb0 wc0 wa1 wb1 wc1], 6..8 depth form [za zb z0], 9..10
// anchor [x0 y0], 12 the original face id (f32-exact). cmask (B, n_bands,
// n_cols, 2) i32: bit i of word w = chunk blo + 32w + i may cover a pixel
// of the column tile.
//
// The edge and depth forms keep the reference's operation order with
// explicit round-to-nearest intrinsics (and the build passes -fmad=false),
// so no multiply-add contraction moves a knife-edge pixel.

#pragma once

#include <cuda_runtime.h>

namespace raster {

constexpr int kChunk = 128;      // setup rows per chunk
constexpr int kWindow = 64;      // chunks covered by the column masks
constexpr int kMaskWords = 2;
constexpr int kSetupFields = 16;
constexpr int kRecFields = 24;
constexpr int kStaged = 12;      // setup fields 0..10 and the id (12)

__device__ __forceinline__ float affine(float a, float qx, float b, float qy,
                                        float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, qx), __fmul_rn(b, qy)), c);
}

struct Winner {
  float z;    // +inf when nothing covers the pixel
  float id;   // original face id of the winner
  int row;    // its raster row
};

// The band's z-test for the pixel (px, py) of column tile `c`. Every
// thread of the block calls it with the same band: chunks are staged in
// `s` with one cooperative load each (the loop trip counts are uniform).
__device__ __forceinline__ Winner band_ztest(
    float (&s)[kStaged][kChunk], const float* __restrict__ sb, int rows,
    int lo, int n, const int* __restrict__ cm, float px, float py) {
  const int tid = threadIdx.x;
  Winner w{__int_as_float(0x7f800000), 3e38f, 0};

  // Stage chunk `k` of the band window (rows (lo + k) * 128 ...) in
  // shared memory with one cooperative load, then test this thread's
  // pixel against its 128 triangles. `k` is uniform across the block.
  auto test_chunk = [&](int k) {
    const int r0 = (lo + k) * kChunk;
    __syncthreads();
    for (int i = tid; i < kStaged * kChunk; i += blockDim.x) {
      const int f = i / kChunk;
      const int field = f < 11 ? f : 12;
      s[f][i % kChunk] = sb[static_cast<size_t>(field) * rows + r0 +
                            i % kChunk];
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kChunk; ++j) {
      const float qx = __fsub_rn(px, s[9][j]);
      const float qy = __fsub_rn(py, s[10][j]);
      const float e0 = affine(s[0][j], qx, s[1][j], qy, s[2][j]);
      const float e1 = affine(s[3][j], qx, s[4][j], qy, s[5][j]);
      const float ez = affine(s[6][j], qx, s[7][j], qy, s[8][j]);
      const bool cov = (e0 >= 0.0f) && (e1 >= 0.0f) &&
                       (__fadd_rn(e0, e1) <= 1.0f);
      const float id = s[11][j];
      if (cov && (ez < w.z || (ez == w.z && id < w.id))) {
        w.z = ez;
        w.id = id;
        w.row = r0 + j;
      }
    }
  };

  // the column's masked chunks of the window's first 64 ...
  for (int word = 0; word < kMaskWords; ++word) {
    unsigned int m = static_cast<unsigned int>(cm[word]);
    while (m != 0u) {
      const int i = __ffs(m) - 1;
      m &= m - 1u;
      test_chunk(word * 32 + i);
    }
  }
  // ... and every chunk beyond them (spatially incoherent face orders)
  for (int k = kWindow; k < n; ++k) test_chunk(k);
  return w;
}

// ---------------------------------------------------------------------
// The micro-tiled z-test (K1; K2 and K4 still run band_ztest above).
//
// The same function as band_ztest, bit for bit, with the work of a test
// cut down:
//   - a lane owns an R x C micro-tile of pixels, so one shared-memory
//     read of a triangle (three float4 broadcasts and its row) serves
//     R*C tests, and the qx/qy subtractions and the a*qx / b*qy products
//     are shared along the tile's columns and rows (each pixel's edge
//     and depth forms keep band_ztest's operations in its order);
//   - the 32 lanes of a warp cover a pixel group of up to 32 micro-tiles
//     (a block covers a column tile of any size by looping over groups),
//     and the kTileWarps warps of the block split every chunk into
//     32-row segments: warp w stages, culls and tests segment w, and the
//     warps' winners are merged at the end (lexicographic (depth, id,
//     row): the lowest row wins exact ties, as in the chunk order walk);
//   - a lane stages one triangle of its warp's segment, and a triangle
//     that covers no pixel center of the group's rectangle for certain
//     is dropped before the tests (see cull_live), the rest compacted in
//     row order into the warp's slots;
//   - the next chunk's segment is loaded into registers while the
//     current one is tested, so staging overlaps the tests, and the only
//     barriers per chunk are two __syncwarp.
// ---------------------------------------------------------------------

constexpr int kTileWarps = 4;   // warps of a micro-tiled block

// A staged triangle, triangle-major: [wa0 wb0 wc0 wa1] [wb1 wc1 za zb]
// [z0 x0 y0 id].
struct Staged {
  float4 w0, w1, w2;
};

// The masked chunks of the window's first 64, then every chunk beyond
// them: band_ztest's walk, as a generator (next() is -1 at the end).
struct ChunkWalk {
  const int* cm;
  int n, word, k;
  unsigned int m;
  __device__ __forceinline__ ChunkWalk(const int* cm_, int n_)
      : cm(cm_), n(n_), word(0), k(kWindow),
        m(static_cast<unsigned int>(cm_[0])) {}
  __device__ __forceinline__ int next() {
    while (word < kMaskWords) {
      if (m != 0u) {
        const int i = __ffs(m) - 1;
        m &= m - 1u;
        return word * 32 + i;
      }
      if (++word < kMaskWords) m = static_cast<unsigned int>(cm[word]);
    }
    return k < n ? k++ : -1;
  }
};

__device__ __forceinline__ float mul_hi(float a, float l, float h) {
  return fmaxf(__fmul_rn(a, l), __fmul_rn(a, h));
}
__device__ __forceinline__ float mul_lo(float a, float l, float h) {
  return fminf(__fmul_rn(a, l), __fmul_rn(a, h));
}

// False only if the triangle covers no pixel center (px, py) with px in
// [gx0, gx1] and py in [gy0, gy1], as band_ztest's float test decides it.
// Exact, with no tolerance: every step of a pixel's e0 =
// fl(fl(fl(wa0*qx) + fl(wb0*qy)) + wc0), qx = fl(px - x0), is monotone
// in its operands under round-to-nearest, so e0 at any such pixel lies
// in [lo0, hi0], the same expression on the extreme products; likewise
// e1, and fl(e0 + e1) >= fl(lo0 + lo1). So hi0 < 0, hi1 < 0 or
// fl(lo0 + lo1) > 1 rules out every pixel. (Setup fields are finite;
// a dead triangle's wc = -3e38 gives hi < 0.)
__device__ __forceinline__ bool cull_live(const float (&f)[kStaged],
                                          float gx0, float gx1, float gy0,
                                          float gy1) {
  const float qxl = __fsub_rn(gx0, f[9]), qxh = __fsub_rn(gx1, f[9]);
  const float qyl = __fsub_rn(gy0, f[10]), qyh = __fsub_rn(gy1, f[10]);
  const float hi0 = __fadd_rn(__fadd_rn(mul_hi(f[0], qxl, qxh),
                                        mul_hi(f[1], qyl, qyh)), f[2]);
  const float hi1 = __fadd_rn(__fadd_rn(mul_hi(f[3], qxl, qxh),
                                        mul_hi(f[4], qyl, qyh)), f[5]);
  const float lo0 = __fadd_rn(__fadd_rn(mul_lo(f[0], qxl, qxh),
                                        mul_lo(f[1], qyl, qyh)), f[2]);
  const float lo1 = __fadd_rn(__fadd_rn(mul_lo(f[3], qxl, qxh),
                                        mul_lo(f[4], qyl, qyh)), f[5]);
  return !(hi0 < 0.0f || hi1 < 0.0f || __fadd_rn(lo0, lo1) > 1.0f);
}

// One lane's winners, pixel (r, c) of its micro-tile.
template <int R, int C>
struct TileWinners {
  float z[R][C];
  float id[R][C];
  int row[R][C];
};

// The z-test of one pixel group for this warp's segments of the band's
// chunks. `seg` holds the warp's 32 slots (shared memory), `px`/`py` the
// lane's pixel centers, [gx0, gx1] x [gy0, gy1] the group's rectangle of
// pixel centers (every lane's pixels lie in it). Called by every lane of
// the warp (the trip counts are warp-uniform).
template <int R, int C>
__device__ __forceinline__ TileWinners<R, C> tile_ztest(
    Staged* seg, int* seg_row, const float* __restrict__ sb, int rows,
    int lo, int n, const int* __restrict__ cm, const float (&px)[C],
    const float (&py)[R], float gx0, float gx1, float gy0, float gy1) {
  const int lane = threadIdx.x & 31;
  const int part = (threadIdx.x >> 5) * 32 + lane;   // row in the chunk
  TileWinners<R, C> w;
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      w.z[r][c] = __int_as_float(0x7f800000);
      w.id[r][c] = 3e38f;
      w.row[r][c] = 0;
    }
  }
  float f[kStaged];
  auto fetch = [&](int k) {
    if (k < 0) return;
    const size_t r0 = static_cast<size_t>(lo + k) * kChunk + part;
#pragma unroll
    for (int i = 0; i < kStaged; ++i) {
      f[i] = sb[static_cast<size_t>(i < 11 ? i : 12) * rows + r0];
    }
  };
  ChunkWalk walk(cm, n);
  int k = walk.next();
  fetch(k);
  while (k >= 0) {
    // stage: this lane's triangle, if it may cover a pixel of the group
    const int my_row = (lo + k) * kChunk + part;
    const bool live = cull_live(f, gx0, gx1, gy0, gy1);
    const unsigned int ballot = __ballot_sync(0xffffffffu, live);
    if (live) {
      const int slot = __popc(ballot & ((1u << lane) - 1u));
      seg[slot].w0 = make_float4(f[0], f[1], f[2], f[3]);
      seg[slot].w1 = make_float4(f[4], f[5], f[6], f[7]);
      seg[slot].w2 = make_float4(f[8], f[9], f[10], f[11]);
      seg_row[slot] = my_row;
    }
    __syncwarp();
    k = walk.next();
    fetch(k);   // in flight while the tests below run
    const int n_live = __popc(ballot);
    for (int i = 0; i < n_live; ++i) {
      const float4 a = seg[i].w0, b = seg[i].w1, d = seg[i].w2;
      const int rr = seg_row[i];
      float ax0[C], ax1[C], axz[C], by0[R], by1[R], byz[R];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float qx = __fsub_rn(px[c], d.y);
        ax0[c] = __fmul_rn(a.x, qx);
        ax1[c] = __fmul_rn(a.w, qx);
        axz[c] = __fmul_rn(b.z, qx);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float qy = __fsub_rn(py[r], d.z);
        by0[r] = __fmul_rn(a.y, qy);
        by1[r] = __fmul_rn(b.x, qy);
        byz[r] = __fmul_rn(b.w, qy);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float e0 = __fadd_rn(__fadd_rn(ax0[c], by0[r]), a.z);
          const float e1 = __fadd_rn(__fadd_rn(ax1[c], by1[r]), b.y);
          const float ez = __fadd_rn(__fadd_rn(axz[c], byz[r]), d.x);
          const bool cov = (e0 >= 0.0f) && (e1 >= 0.0f) &&
                           (__fadd_rn(e0, e1) <= 1.0f);
          if (cov && (ez < w.z[r][c] ||
                      (ez == w.z[r][c] && d.w < w.id[r][c]))) {
            w.z[r][c] = ez;
            w.id[r][c] = d.w;
            w.row[r][c] = rr;
          }
        }
      }
    }
    __syncwarp();   // the next chunk rewrites the slots
  }
  return w;
}

// (z, id, row) lexicographic: true if a beats b.
__device__ __forceinline__ bool beats(float za, float ida, int ra, float zb,
                                      float idb, int rb) {
  return za < zb || (za == zb && (ida < idb || (ida == idb && ra < rb)));
}

// The winner's original face id, or -1 (background, or a padding row).
__device__ __forceinline__ int winner_id(const Winner& w, int n_faces) {
  if (w.z < 3e37f) {
    const int v = static_cast<int>(w.id);
    if (v >= 0 && v < n_faces) return v;
  }
  return -1;
}

}  // namespace raster
