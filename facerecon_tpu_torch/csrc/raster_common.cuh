// The z-test of the rasterizer kernels and the block skeleton they share
// (tile_raster at the end): raster_shade.cu (K1), raster_select.cu (K2)
// and raster_pos.cu (K4) differ only in what they write for a pixel's
// winner, so one header keeps their z-tests from drifting apart.
//
// Per pixel, the lexicographic minimum of (depth, original face id) over
// the triangles that cover the pixel center, walking the band's union
// window [blo, blo + bn) of 128-row chunks: the column's masked chunks of
// the window's first 64, then every chunk beyond them (spatially
// incoherent face orders). Exact ties of (depth, id) go to the lowest
// raster row. It computes what the z-test phase of
// facerecon_tpu/ops/rasterize_pallas.py::_kernel computes.
//
// A pixel's test of one triangle, with qx = fl(px - x0), qy = fl(py - y0):
// e0 = fl(fl(fl(wa0 * qx) + fl(wb0 * qy)) + wc0), e1 and the depth ez the
// same on their forms; covered iff e0 >= 0, e1 >= 0 and fl(e0 + e1) <= 1.
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

// ---------------------------------------------------------------------
// The micro-tiled z-test: the per-pixel test above, bit for bit, with
// the work of a test cut down:
//   - a lane owns a kTileR x kTileC (2 x 2) micro-tile of pixels, so one
//     shared-memory read of a triangle (three float4 broadcasts and its
//     row) serves 4 tests, and the qx/qy subtractions and the a*qx / b*qy products
//     are shared along the tile's columns and rows (each pixel's edge
//     and depth forms keep the per-pixel test's operations in its order);
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
constexpr int kTileR = 2;       // micro-tile rows
constexpr int kTileC = 2;       // micro-tile columns
constexpr int kTileThreads = kTileWarps * 32;
constexpr int kGroupPx = 32 * kTileR * kTileC;   // pixels of a full group
static_assert(kGroupPx == kTileThreads, "one thread a group pixel");

// A staged triangle, triangle-major: [wa0 wb0 wc0 wa1] [wb1 wc1 za zb]
// [z0 x0 y0 id].
struct Staged {
  float4 w0, w1, w2;
};

// The masked chunks of the window's first 64, then every chunk beyond
// them, in ascending order, as a generator (next() is -1 at the end).
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
// [gx0, gx1] and py in [gy0, gy1], as the per-pixel float test decides it.
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
struct TileWinners {
  float z[kTileR][kTileC];
  float id[kTileR][kTileC];
  int row[kTileR][kTileC];
};

// The z-test of one pixel group for this warp's segments of the band's
// chunks. `seg` holds the warp's 32 slots (shared memory), `px`/`py` the
// lane's pixel centers, [gx0, gx1] x [gy0, gy1] the group's rectangle of
// pixel centers (every lane's pixels lie in it). Called by every lane of
// the warp (the trip counts are warp-uniform).
__device__ __forceinline__ TileWinners tile_ztest(
    Staged* seg, int* seg_row, const float* __restrict__ sb, int rows,
    int lo, int n, const int* __restrict__ cm, const float (&px)[kTileC],
    const float (&py)[kTileR], float gx0, float gx1, float gy0, float gy1) {
  constexpr int R = kTileR, C = kTileC;
  const int lane = threadIdx.x & 31;
  const int part = (threadIdx.x >> 5) * 32 + lane;   // row in the chunk
  TileWinners w;
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

// ---------------------------------------------------------------------
// The block skeleton of K1, K2 and K4: one block of kTileThreads threads
// for each (column tile c, band t, image b) = blockIdx, for a band of any
// size. It walks the column tile in pixel groups of gc x gr micro-tiles
// (gc * gr <= 32; the groups tile the column tile from its top-left
// corner, and the last row and column of groups may reach past it: those
// pixels are tested, never written). For each group, every warp runs
// tile_ztest on its segments, the warps' winners are merged in shared
// memory by `beats`, and then one thread a group pixel (tid < gw * gh,
// row-major, so stores to an image plane are coalesced) calls
//   epi(b, x, y, pix, winner)
// for each pixel (x, y) of the group inside the tile and the image, with
// pix = (b * height + y) * width + x. Static shared memory: 12,800 bytes.
// ---------------------------------------------------------------------
template <class Epi>
__device__ __forceinline__ void tile_raster(
    const float* __restrict__ setup, const int* __restrict__ blo,
    const int* __restrict__ bn, const int* __restrict__ cmask, int height,
    int width, int tile_h, int n_cols, int col_w, int n_bands, int rows,
    Epi&& epi) {
  __shared__ Staged s_seg[kTileWarps][32];
  __shared__ int s_segrow[kTileWarps][32];
  __shared__ float s_z[kTileWarps][kGroupPx];
  __shared__ float s_id[kTileWarps][kGroupPx];
  __shared__ int s_row[kTileWarps][kGroupPx];

  const int c = blockIdx.x;
  const int t = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int band = b * n_bands + t;
  const int lo = blo[band];
  const int n = bn[band];
  const int* cm = cmask + (static_cast<size_t>(band) * n_cols + c) *
                              kMaskWords;
  const float* sb = setup + static_cast<size_t>(b) * kSetupFields * rows;

  // pixel groups: gc x gr micro-tiles (gc * gr <= 32) of the column tile
  const int mcols = (col_w + kTileC - 1) / kTileC;
  const int mrows = (tile_h + kTileR - 1) / kTileR;
  const int gc = min(mcols, 32);
  const int gr = min(mrows, 32 / gc);
  const int gw = gc * kTileC;                 // group pixel columns
  const int gh = gr * kTileR;                 // group pixel rows
  const int x_tile = c * col_w;               // the tile's first pixel
  const int y_tile = t * tile_h;

  for (int gy = 0; gy < mrows; gy += gr) {
    for (int gx = 0; gx < mcols; gx += gc) {
      // this lane's micro-tile (lanes beyond the group test pixels that
      // are never written, so every lane stages a triangle)
      const int x0 = x_tile + (gx + lane % gc) * kTileC;
      const int y0 = y_tile + (gy + lane / gc) * kTileR;
      float px[kTileC], py[kTileR];
#pragma unroll
      for (int k = 0; k < kTileC; ++k) {
        px[k] = static_cast<float>(x0 + k) + 0.5f;
      }
#pragma unroll
      for (int k = 0; k < kTileR; ++k) {
        py[k] = static_cast<float>(y0 + k) + 0.5f;
      }
      const int gx_px = x_tile + gx * kTileC;
      const int gy_px = y_tile + gy * kTileR;
      const float gx0 = static_cast<float>(gx_px) + 0.5f;
      const float gy0 = static_cast<float>(gy_px) + 0.5f;
      const float gx1 = static_cast<float>(gx_px + gw - 1) + 0.5f;
      const float gy1 = static_cast<float>(gy_px + gh - 1) + 0.5f;
      const TileWinners w = tile_ztest(s_seg[warp], s_segrow[warp], sb,
                                       rows, lo, n, cm, px, py, gx0, gx1,
                                       gy0, gy1);

      // merge the warps' winners per group pixel
      if (lane < gc * gr) {
#pragma unroll
        for (int r = 0; r < kTileR; ++r) {
#pragma unroll
          for (int k = 0; k < kTileC; ++k) {
            const int p = ((lane / gc) * kTileR + r) * gw +
                          (lane % gc) * kTileC + k;
            s_z[warp][p] = w.z[r][k];
            s_id[warp][p] = w.id[r][k];
            s_row[warp][p] = w.row[r][k];
          }
        }
      }
      __syncthreads();
      if (tid < gw * gh) {
        Winner win{s_z[0][tid], s_id[0][tid], s_row[0][tid]};
#pragma unroll
        for (int v = 1; v < kTileWarps; ++v) {
          if (beats(s_z[v][tid], s_id[v][tid], s_row[v][tid], win.z, win.id,
                    win.row)) {
            win = Winner{s_z[v][tid], s_id[v][tid], s_row[v][tid]};
          }
        }
        const int xo = gx * kTileC + tid % gw;   // column in the tile
        const int yo = gy * kTileR + tid / gw;   // row in the band
        const int x = x_tile + xo;
        const int y = y_tile + yo;
        if (xo < col_w && yo < tile_h && x < width && y < height) {
          epi(b, x, y, (static_cast<size_t>(b) * height + y) * width + x,
              win);
        }
      }
      __syncthreads();   // the next group rewrites the merge arrays
    }
  }
}

}  // namespace raster
