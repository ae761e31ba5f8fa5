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
//
// Ablation switches (the port's form of the reference's RP_ABLATE hook,
// facerecon_tpu/ops/rasterize_pallas.py:171-175): a variant build
// (ops/_build.py `defines`) strips one phase of the skeleton so its share
// of the time can be measured on this code. Only the probe twin
// benchmarks/floor_probe.py and chip_smoke.py build them; with none set
// the source compiles as it always has. Their outputs are not the
// function (except RP_ABLATE_CULL's, which are). Each stripped phase
// leaves a sink the compiler cannot see through, so it does not delete
// the work that is meant to stay:
//   RP_ABLATE_DMA    the global loads of each chunk segment's setup rows:
//                    the walk's first segment is loaded once, and each
//                    later fetch only tells the compiler (an empty asm)
//                    that the rows changed, so the culls and tests run on
//                    real rows (the first segment's, in every chunk);
//   RP_ABLATE_EVAL   the z-tests of the lanes' lists (test_list), in every
//                    chunk of the walk: each pixel stays background; a
//                    branch on a runtime value that never holds (rows <
//                    0) reads the slots through the lane's list, so the
//                    staging, the micro-tile masks (tile_hits, whose
//                    coverage tests stay) and their transpose stay;
//   RP_ABLATE_CULL   both culls, the group's (cull_live) and the
//                    micro-tile masks (tile_hits): every fetched triangle
//                    is staged and every lane of a micro-tile in the tile
//                    tests all 32 (the result is the full kernel's, bit
//                    for bit, as both culls are exact);
//   RP_ABLATE_MERGE  the warps' merge: warp 0 alone writes its winners to
//                    shared memory, and each pixel takes warp 0's;
//   RP_ABLATE_SEL and RP_ABLATE_PACK strip the epilogue's record load and
//                    its arithmetic and stores, in each kernel's source.

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
// the tests issued cut to the triangles that can reach a lane's pixels:
//   - a lane owns a kTileR x kTileC (2 x 2) micro-tile of pixels and
//     keeps its winners in registers; one shared-memory read of a
//     triangle (three float4) serves its 4 tests, and the qx/qy
//     subtractions and the a*qx / b*qy products are shared along the
//     micro-tile's columns and rows (each pixel's edge and depth forms
//     keep the per-pixel test's operations in its order);
//   - the 32 lanes of a warp cover a pixel group of up to 32 micro-tiles
//     (a block covers a column tile of any size by looping over groups),
//     and the kTileWarps warps of the block split every chunk into
//     32-row segments: warp w stages, culls and tests segment w, and the
//     warps' winners are merged at the end (lexicographic (depth, id,
//     row): the lowest row wins exact ties, as in the chunk order walk);
//   - a lane takes one triangle of its warp's segment and, if it may
//     cover a pixel center of the group's rectangle (cull_live), finds
//     the group's micro-tiles where it covers a pixel center (tile_hits:
//     an exact interval cull of each micro-tile, then the coverage tests
//     of the ones left), and stages it in slot = lane (raster-row order)
//     if there is one; the warp transposes the 32 masks (five shuffles),
//     and each lane walks only its own list of slots, in ascending slot
//     order. Triangles are far smaller than a pixel group, and the 32
//     rows of a segment lie close together, so a segment issues (the
//     most micro-tiles a triangle is tested on + the longest list) x 32
//     lanes of tests, not (kept triangles) x 32;
//   - the next chunk's segment is loaded into registers while the
//     current one is tested, so staging overlaps the tests, and the only
//     barriers per chunk are two __syncwarp.
// ---------------------------------------------------------------------

constexpr int kTileWarps = 4;   // warps of a micro-tiled block
constexpr int kTileR = 2;       // micro-tile rows
constexpr int kTileC = 2;       // micro-tile columns
constexpr int kTileThreads = kTileWarps * 32;
// blocks a SM is asked to hold (the kernels' __launch_bounds__): 8 x 128
// threads at 64 registers each; left alone the compiler takes more and
// fits fewer blocks, which ran slower
constexpr int kTileBlocks = 8;
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

// Narrows [lo, hi) to the columns j of [0, n) where p(j) holds, for p
// monotone in j: dir > 0 false then true, dir < 0 true then false, dir
// == 0 constant. `guess` is any float near the flip (NaN and inf
// allowed): the walk from it finds the flip exactly, and a good guess
// makes it two evaluations of p.
template <class P>
__device__ __forceinline__ void narrow(int& lo, int& hi, int n, int dir,
                                       float guess, P p) {
  if (dir == 0) {
    if (!p(0)) hi = 0;
    return;
  }
  int t = static_cast<int>(
      fminf(fmaxf(ceilf(guess), 0.0f), static_cast<float>(n)));
  const bool up = dir > 0;
  while (t > 0 && p(t - 1) == up) --t;
  while (t < n && p(t) != up) ++t;
  if (up) {
    lo = max(lo, t);
  } else {
    hi = min(hi, t);
  }
}

// Bits i * gc + j of the micro-tiles (column j < jn, row i < gr) of the
// group where the triangle covers a pixel center, by the z-test's own
// float ops: e0, e1 and fl(e0 + e1) of each pixel exactly as test_list
// computes them, so the lanes that own those micro-tiles test the
// triangle, and no other lane does. Micro-tile (i, j) spans the pixel
// centers x in [X0 + 2j, X0 + 2j + 1] and y in [gy + 2i, gy + 2i + 1] +
// 0.5, its second row dropped where it lies at or past y_lim. Which
// micro-tiles to test, each step exact in the same direction (it never
// drops a micro-tile where a pixel center is covered):
//   - for each micro-row, the micro-tiles whose rectangles pass
//     cull_live's edge tests hi0 >= 0 and hi1 >= 0 and the third edge's
//     bound (edge_slack). Each is monotone in j: hi0 with the sign of
//     wa0 (the product of one extreme pixel column, rounded
//     monotonically), hi1 with wa1's, the bound with wa0 + wa1's. So
//     they pass on one interval of columns, found from three flips
//     (narrow);
//   - in it, each micro-tile whose rectangle passes cull_live's sum test
//     fl(lo0 + lo1) <= 1 (not monotone in j where wa0 and wa1 have
//     opposite signs), on the products its pixel tests then share.
// (ops/rasterize.py, microtile_mask, is its float32 twin: `tested` the
// micro-tiles whose pixels it tests, `hits` the result.)
//
// The third edge's bound. A pixel is covered only if fl(e0 + e1) <= 1,
// so e0 + e1 <= 1 + u (u = 2^-24, round to nearest). With a = fl(wa *
// qx), b = fl(wb * qy) and e = fl(fl(a + b) + wc), |e - (a + b + wc)| <=
// 2.01u (|a| + |b| + |wc|) and |a - wa qx| <= u |wa qx|, so a covered
// pixel has G = (wa0 + wa1) qx + (b0 + b1) + wc0 + wc1 - 1 <= u + 3.1u
// X, X = (|wa0| + |wa1|) |qx| + |b0| + |b1| + |wc0| + |wc1|. G is exact
// and monotone in qx; its float form fl(fl(w * qx) + k), w = fl(wa0 +
// wa1), k = fl(fl(fl(min_r fl(b0 + b1) + wc0) + wc1) - 1), errs by at
// most 5.1u (X + 1) where |qx| <= Qx. So a pixel column whose float form
// exceeds the slack u + 12u (X + 1), X taken at Qx (every pixel column
// of the group) and the micro-row's largest |b0| + |b1|, holds no covered
// pixel, nor does any column past it on the side where w grows. The
// slack is a few ulps of the forms' magnitudes.
__device__ __forceinline__ float edge_slack(float absw, float qx_max,
                                            float bmax, float absc) {
  constexpr float kU = 5.9604645e-08f;   // 2^-24
  return kU + 12.0f * kU * (absw * qx_max + bmax + absc + 1.0f) + 1e-30f;
}

__device__ __forceinline__ unsigned int tile_hits(const float (&f)[kStaged],
                                                  float X0, int gy, int gc,
                                                  int jn, int gr,
                                                  int y_lim) {
  const float wa0 = f[0], wb0 = f[1], wc0 = f[2];
  const float wa1 = f[3], wb1 = f[4], wc1 = f[5];
  const float ax = f[9], ay = f[10];
  const int dir0 = (wa0 > 0.0f) - (wa0 < 0.0f);
  const int dir1 = (wa1 > 0.0f) - (wa1 < 0.0f);
  // the pixel column whose product is hi's: the right one where the
  // slope is >= 0
  const float off0 = wa0 >= 0.0f ? 1.0f : 0.0f;
  const float off1 = wa1 >= 0.0f ? 1.0f : 0.0f;
  auto qx = [&](int j, float off) {
    return __fsub_rn(X0 + static_cast<float>(2 * j) + off, ax);
  };
  // the third edge: fl(w * qx) + k grows with qx where w > 0, so its
  // bound cuts the columns right of a flip (left of it where w < 0), and
  // a column is judged at its pixel nearer that side
  const float w = __fadd_rn(wa0, wa1);
  const int dirw = (w < 0.0f) - (w > 0.0f);
  const float offw = w > 0.0f ? 0.0f : 1.0f;
  const float absw = fabsf(wa0) + fabsf(wa1);
  const float absc = fabsf(wc0) + fabsf(wc1);
  const float qx_max = fmaxf(fabsf(qx(0, 0.0f)), fabsf(qx(jn - 1, 1.0f)));
  unsigned int hits = 0u;
  for (int i = 0; i < gr; ++i) {
    const int yt = gy + i * kTileR;
    if (yt >= y_lim) break;
    const bool two = yt + 1 < y_lim;
    const float yl = static_cast<float>(yt) + 0.5f;
    const float qyl = __fsub_rn(yl, ay);
    const float qyh = two ? __fsub_rn(yl + 1.0f, ay) : qyl;
    const float by0[kTileR] = {__fmul_rn(wb0, qyl), __fmul_rn(wb0, qyh)};
    const float by1[kTileR] = {__fmul_rn(wb1, qyl), __fmul_rn(wb1, qyh)};
    const float h0 = fmaxf(by0[0], by0[1]), l0 = fminf(by0[0], by0[1]);
    const float h1 = fmaxf(by1[0], by1[1]), l1 = fminf(by1[0], by1[1]);
    const float k = __fadd_rn(
        __fadd_rn(__fadd_rn(fminf(__fadd_rn(by0[0], by1[0]),
                                  __fadd_rn(by0[1], by1[1])), wc0), wc1),
        -1.0f);
    const float slack = edge_slack(
        absw, qx_max,
        fmaxf(fabsf(by0[0]) + fabsf(by1[0]), fabsf(by0[1]) + fabsf(by1[1])),
        absc);
    int lo = 0, hi = jn;
    narrow(lo, hi, jn, dirw,
           (ax + __fdividef(slack - k, w) - X0 - offw) * 0.5f, [&](int j) {
             return __fadd_rn(__fmul_rn(w, qx(j, offw)), k) <= slack;
           });
    narrow(lo, hi, jn, dir0,
           (ax - __fdividef(h0 + wc0, wa0) - X0 - off0) * 0.5f,
           [&](int j) {
             return __fadd_rn(__fadd_rn(__fmul_rn(wa0, qx(j, off0)), h0),
                              wc0) >= 0.0f;
           });
    if (lo < hi) {
      narrow(lo, hi, jn, dir1,
             (ax - __fdividef(h1 + wc1, wa1) - X0 - off1) * 0.5f,
             [&](int j) {
               return __fadd_rn(__fadd_rn(__fmul_rn(wa1, qx(j, off1)), h1),
                                wc1) >= 0.0f;
             });
    }
    for (int j = lo; j < hi; ++j) {
      const float q[kTileC] = {qx(j, 0.0f), qx(j, 1.0f)};
      const float a0[kTileC] = {__fmul_rn(wa0, q[0]), __fmul_rn(wa0, q[1])};
      const float a1[kTileC] = {__fmul_rn(wa1, q[0]), __fmul_rn(wa1, q[1])};
      const float lo0 = __fadd_rn(__fadd_rn(fminf(a0[0], a0[1]), l0), wc0);
      const float lo1 = __fadd_rn(__fadd_rn(fminf(a1[0], a1[1]), l1), wc1);
      if (__fadd_rn(lo0, lo1) > 1.0f) continue;
      bool cov = false;
#pragma unroll
      for (int r = 0; r < kTileR; ++r) {
        if (r > 0 && !two) break;
#pragma unroll
        for (int c = 0; c < kTileC; ++c) {
          const float e0 = __fadd_rn(__fadd_rn(a0[c], by0[r]), wc0);
          const float e1 = __fadd_rn(__fadd_rn(a1[c], by1[r]), wc1);
          cov |= fminf(e0, e1) >= 0.0f && __fadd_rn(e0, e1) <= 1.0f;
        }
      }
      if (cov) hits |= 1u << (i * gc + j);
    }
  }
  return hits;
}

// The 32 x 32 bit matrix of the warp's words (lane l's word = row l)
// transposed: bit l of lane t's result is bit t of lane l's word.
__device__ __forceinline__ unsigned int transpose32(unsigned int x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const int w = 16 >> s;
    // the bits whose index has bit w clear: 0x0000ffff, 0x00ff00ff, ...
    const unsigned int m = 0xffffffffu / ((1u << w) + 1u);
    const unsigned int y = __shfl_xor_sync(0xffffffffu, x, w);
    x = (lane & w) ? ((x & ~m) | ((y >> w) & m))
                   : ((x & m) | ((y << w) & ~m));
  }
  return x;
}

// One lane's winners, pixel (r, c) of its micro-tile.
struct TileWinners {
  float z[kTileR][kTileC];
  float id[kTileR][kTileC];
  int row[kTileR][kTileC];
};

// The lane's tests of the slots in `list` (bit s: slot s, raster row
// row0 + s), in ascending slot order, over the first R rows of its
// micro-tile.
template <int R>
__device__ __forceinline__ void test_list(unsigned int list,
                                          const Staged* seg, int row0,
                                          const float (&px)[kTileC],
                                          const float (&py)[kTileR],
                                          TileWinners& w) {
  constexpr int C = kTileC;
  while (list != 0u) {
    const int s = __ffs(list) - 1;
    list &= list - 1u;
    const float4 a = seg[s].w0, b = seg[s].w1, d = seg[s].w2;
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
        // e0, e1 are finite (finite setup fields), so one min tests both
        // signs
        const bool cov = fminf(e0, e1) >= 0.0f && __fadd_rn(e0, e1) <= 1.0f;
        if (cov && (ez < w.z[r][c] ||
                    (ez == w.z[r][c] && d.w < w.id[r][c]))) {
          w.z[r][c] = ez;
          w.id[r][c] = d.w;
          w.row[r][c] = row0 + s;
        }
      }
    }
  }
}

// The pixel group a warp tests: [gx0, gx1] x [gy0, gy1] the rectangle of
// its pixel centers inside the tile and the image (gx0 is also its first
// micro-tile column's first), gy the first pixel row, gc x gr
// micro-tiles, jn of whose columns start before the first column past
// the tile and the image, y_lim the first row past the tile and the
// image, valid the bits of the micro-tiles in them, one_row true
// where the group is a single pixel row of the tile.
struct Group {
  float gx0, gx1, gy0, gy1;
  int gy, gc, jn, gr, y_lim;
  unsigned int valid;
  bool one_row;
};

// The z-test of one pixel group for this warp's segments of the band's
// chunks. `seg` holds the warp's 32 slots (shared memory), `px`/`py` the
// lane's pixel centers. Called by every lane of the warp (the trip counts
// of the chunk loop are warp-uniform).
__device__ __forceinline__ TileWinners tile_ztest(
    Staged* seg, const float* __restrict__ sb, int rows, int lo, int n,
    const int* __restrict__ cm, const float (&px)[kTileC],
    const float (&py)[kTileR], const Group& g) {
  constexpr int R = kTileR, C = kTileC;
  const int lane = threadIdx.x & 31;
  const int part = (threadIdx.x >> 5) * 32;   // the segment's first row
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
#ifdef RP_ABLATE_DMA
  bool loaded = false;
#endif
  auto fetch = [&](int k) {
    if (k < 0) return;
#ifdef RP_ABLATE_DMA
    if (loaded) {
#pragma unroll
      for (int i = 0; i < kStaged; ++i) asm volatile("" : "+f"(f[i]));
      return;
    }
    loaded = true;
#endif
    const size_t r0 = static_cast<size_t>(lo + k) * kChunk + part + lane;
#pragma unroll
    for (int i = 0; i < kStaged; ++i) {
      f[i] = sb[static_cast<size_t>(i < 11 ? i : 12) * rows + r0];
    }
  };
  ChunkWalk walk(cm, n);
  int k = walk.next();
  fetch(k);
  while (k >= 0) {
    const int row0 = (lo + k) * kChunk + part;   // slot 0's raster row
    // stage: this lane's triangle, in slot `lane`, with the micro-tiles
    // of the group where it covers a pixel center
#ifdef RP_ABLATE_CULL
    const unsigned int mine = g.valid;
#else
    const unsigned int mine =
        cull_live(f, g.gx0, g.gx1, g.gy0, g.gy1)
            ? tile_hits(f, g.gx0, g.gy, g.gc, g.jn, g.gr, g.y_lim)
            : 0u;
#endif
    if (mine != 0u) {
      seg[lane].w0 = make_float4(f[0], f[1], f[2], f[3]);
      seg[lane].w1 = make_float4(f[4], f[5], f[6], f[7]);
      seg[lane].w2 = make_float4(f[8], f[9], f[10], f[11]);
    }
    const bool any = __any_sync(0xffffffffu, mine != 0u);
    const unsigned int list = any ? transpose32(mine) : 0u;
    __syncwarp();
    k = walk.next();
    fetch(k);   // in flight while the tests below run
#ifdef RP_ABLATE_EVAL
    if (rows < 0 && list != 0u) {
      const int s = __ffs(list) - 1;
      w.z[0][0] = seg[s].w0.x;
      w.row[0][0] = row0 + s;
    }
#else
    if (g.one_row) {
      test_list<1>(list, seg, row0, px, py, w);
    } else {
      test_list<R>(list, seg, row0, px, py, w);
    }
#endif
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
// micro-tiles are never tested or written, and a group wholly past the
// tile or the image is skipped). For each group, every warp runs
// tile_ztest on its segments, the warps' winners are merged in shared
// memory by `beats`, and then one thread a group pixel (tid < gw * gh,
// row-major, so stores to an image plane are coalesced) calls
//   epi(b, x, y, pix, winner)
// for each pixel (x, y) of the group inside the tile and the image, with
// pix = (b * height + y) * width + x. Static shared memory: 12,288 bytes.
// ---------------------------------------------------------------------
template <class Epi>
__device__ __forceinline__ void tile_raster(
    const float* __restrict__ setup, const int* __restrict__ blo,
    const int* __restrict__ bn, const int* __restrict__ cmask, int height,
    int width, int tile_h, int n_cols, int col_w, int n_bands, int rows,
    Epi&& epi) {
  __shared__ Staged s_seg[kTileWarps][32];
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
  const int x_lim = min(x_tile + col_w, width);    // first pixel past
  const int y_lim = min(y_tile + tile_h, height);  // the tile and image

  for (int gy = 0; gy < mrows; gy += gr) {
    for (int gx = 0; gx < mcols; gx += gc) {
      // this lane's micro-tile (lanes past the group or the tile get an
      // empty list)
      const int x0 = x_tile + (gx + lane % gc) * kTileC;
      const int y0 = y_tile + (gy + lane / gc) * kTileR;
      const int gx_px = x_tile + gx * kTileC;
      const int gy_px = y_tile + gy * kTileR;
      const unsigned int valid = __ballot_sync(
          0xffffffffu, lane < gc * gr && x0 < x_lim && y0 < y_lim);
      if (valid == 0u) continue;   // block-uniform: the group is past
      float px[kTileC], py[kTileR];
#pragma unroll
      for (int k = 0; k < kTileC; ++k) {
        px[k] = static_cast<float>(x0 + k) + 0.5f;
      }
#pragma unroll
      for (int k = 0; k < kTileR; ++k) {
        py[k] = static_cast<float>(y0 + k) + 0.5f;
      }
      Group g;
      g.gx0 = static_cast<float>(gx_px) + 0.5f;
      g.gy0 = static_cast<float>(gy_px) + 0.5f;
      g.gx1 = static_cast<float>(min(gx_px + gw, x_lim) - 1) + 0.5f;
      g.gy1 = static_cast<float>(min(gy_px + gh, y_lim) - 1) + 0.5f;
      g.gy = gy_px;
      g.gc = gc;
      g.jn = min(gc, (x_lim - gx_px + 1) / kTileC);
      g.gr = gr;
      g.y_lim = y_lim;
      g.valid = valid;
      g.one_row = y_lim - gy_px == 1;
      const TileWinners w = tile_ztest(s_seg[warp], sb, rows, lo, n, cm, px,
                                       py, g);

      // merge the warps' winners per group pixel
#ifdef RP_ABLATE_MERGE
      if (warp == 0 && lane < gc * gr) {
#else
      if (lane < gc * gr) {
#endif
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
#ifndef RP_ABLATE_MERGE
#pragma unroll
        for (int v = 1; v < kTileWarps; ++v) {
          if (beats(s_z[v][tid], s_id[v][tid], s_row[v][tid], win.z, win.id,
                    win.row)) {
            win = Winner{s_z[v][tid], s_id[v][tid], s_row[v][tid]};
          }
        }
#endif
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
