// GaussianAvatars' splatting for Hopper (sm_90a): FLAME-rigged 3D
// Gaussians, each bound to its triangle's frame, through 3D Gaussian
// Splatting's forward pass. Four kernels, one C entry each:
//
//   gauss_prep    one thread a Gaussian, looping over the B frames of a
//                 microbatch, so each Gaussian's 59 parameters are read
//                 once a microbatch: the triangle frame, the binding to
//                 world, the 3D covariance, the EWA projection, SH-3, the
//                 radius and the 16 x 16 tiles it touches;
//   gauss_emit    one thread a (frame, Gaussian): its (tile, depth) keys
//                 and its id, at its offset of the pair counts' prefix sum;
//   gauss_ranges  one thread a sorted pair: each (frame, tile)'s range of
//                 the sorted list, and the pair's Gaussian id in sorted
//                 order;
//   gauss_blend   one block a (frame, 16 x 16 tile), one thread a pixel:
//                 the tile's Gaussians staged in shared memory in batches
//                 of 256 and blended front to back.
//
// Replaces no TPU kernel: the JAX package renders no Gaussians. It was
// added for GaussianAvatars (Qian et al., arXiv:2312.02069; its code's
// flame_gaussian_model.py and utils/mesh's compute_face_orientation) and
// the rasterizer it ships, diff-gaussian-rasterization (Kerbl et al.,
// SIGGRAPH 2023: preprocessCUDA, duplicateWithKeys, identifyTileRanges,
// renderCUDA), whose rules these follow:
//   frame    a0 = n(v1 - v0), a1 = n(a0 x (v2 - v0)), a2 = -n(a1 x a0),
//            n(x) = x / sqrt(max(x.x, 1e-20)); origin T = (v0 + v1 + v2) (1/3);
//            scale k = (|v1 - v0| + |a2 . (v2 - v0)|) / 2;
//   binding  mean = (R mu) k + T; rotation R R(q / max(|q|, 1e-12)) (of
//            quat(R) (x) q); scale exp(s) k; opacity 1 / (1 + exp(-o));
//   project  cull at view z <= 0.2; Sigma = M^T M with M = S R^T; the EWA
//            J W Sigma W^T J^T with t.x / t.z and t.y / t.z clamped to
//            +-1.3 tan(fov / 2); +0.3 on the 2D diagonal; the conic;
//            radius ceil(3 sqrt(mid + sqrt(max(0.1, mid^2 - det))));
//            colour SH-3 in the direction from the camera centre, + 0.5,
//            at least 0;
//   blend    power = -0.5 (a dx^2 + c dy^2) - b dx dy, skipped where > 0;
//            alpha = min(0.99, o exp(power)), skipped where < 1/255; the
//            pixel stops before the first Gaussian that would take T
//            below 1e-4; out = C + T bg, alpha 1 - T.
// The plain versions are ops/gavatar.*_reference, op for op (-fmad=false).
//
// Bound on this card: bytes for the preprocess (the parameters once, the
// posed vertices, 60 B written a frame and Gaussian), the sort's passes
// for the pairs, and for the blend the exp of the pair tests each pixel
// needs up to its cut-off; the whole tile stops once all its pixels have
// (__syncthreads_count), as 3DGS's does.
//
// Layout (row-major, contiguous): verts (B, N, 3) f32; faces (F, 3) i32;
// binding (G,) i32; params (G, 11) f32 [mu 3 | q (w, x, y, z) | log s 3 |
// opacity logit]; sh (G, 16, 3) f32; cams (B, 14) f32 [world-to-camera
// 3 x 4 | fx | fy]; means (B, G, 3), rec (B, G, 9) f32 [x, y | conic a, b,
// c | opacity | r, g, b], depth (B, G) f32, radius, count (B, G) i32;
// offsets (B G,) i64 (inclusive prefix sum of count); keys (P,) i64
// ((frame tiles + tile) << 32 | depth bits), gid (P,) i32; order (P,) i64
// (the sort's permutation); ranges (B tiles, 2) i32; image (B, H, W, 3),
// alpha (B, H, W) f32.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 16;
constexpr int kBlendThreads = kTile * kTile;
constexpr int kPrepThreads = 128;
constexpr int kSh = 16;
// PyTorch's mean over 3 (and its division by a scalar) on the card
constexpr float kThird = 1.0f / 3.0f;

constexpr float kC0 = 0.28209479177387814f;
constexpr float kC1 = 0.4886025119029199f;
__constant__ float kC2[5] = {1.0925484305920792f, -1.0925484305920792f,
                          0.31539156525252005f, -1.0925484305920792f,
                          0.5462742152960396f};
__constant__ float kC3[7] = {-0.5900435899266435f, 2.890611442640554f,
                          -0.4570457994644658f, 0.3731763325901154f,
                          -0.4570457994644658f, 1.445305721320277f,
                          -0.5900435899266435f};

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }

__device__ __forceinline__ V3 vsub(V3 a, V3 b) {
  return {sub(a.x, b.x), sub(a.y, b.y), sub(a.z, b.z)};
}

__device__ __forceinline__ float dot(V3 a, V3 b) {
  return add(add(mul(a.x, b.x), mul(a.y, b.y)), mul(a.z, b.z));
}

__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {sub(mul(a.y, b.z), mul(a.z, b.y)), sub(mul(a.z, b.x), mul(a.x, b.z)),
          sub(mul(a.x, b.y), mul(a.y, b.x))};
}

// x / sqrt(max(x . x, 1e-20)), GaussianAvatars' safe_normalize
__device__ __forceinline__ V3 unit(V3 a) {
  const float n = __fsqrt_rn(fmaxf(dot(a, a), 1e-20f));
  return {div(a.x, n), div(a.y, n), div(a.z, n)};
}

__device__ __forceinline__ V3 load3(const float* p) { return {p[0], p[1], p[2]}; }

// 3DGS's getRect: the tiles [x0, x1) x [y0, y1) a radius touches
__device__ __forceinline__ void tile_rect(float px, float py, int r,
                                          int tiles_x, int tiles_y, int* x0,
                                          int* y0, int* x1, int* y1) {
  const float rf = static_cast<float>(r);
  const float k = static_cast<float>(kTile);
  *x0 = min(tiles_x, max(0, static_cast<int>(div(sub(px, rf), k))));
  *y0 = min(tiles_y, max(0, static_cast<int>(div(sub(py, rf), k))));
  *x1 = min(tiles_x,
            max(0, static_cast<int>(div(sub(add(add(px, rf), k), 1.0f), k))));
  *y1 = min(tiles_y,
            max(0, static_cast<int>(div(sub(add(add(py, rf), k), 1.0f), k))));
}

__global__ void __launch_bounds__(kPrepThreads)
gauss_prep_kernel(const float* __restrict__ verts, const int* __restrict__ faces,
                  const int* __restrict__ binding,
                  const float* __restrict__ params,
                  const float* __restrict__ shs, const float* __restrict__ cams,
                  float* __restrict__ means, float* __restrict__ rec,
                  float* __restrict__ depth, int* __restrict__ radius,
                  int* __restrict__ count, int batch, int n_vertices,
                  int n_gauss, int height, int width) {
  const int g = blockIdx.x * kPrepThreads + threadIdx.x;
  if (g >= n_gauss) return;
  const float* p = params + static_cast<size_t>(g) * 11;
  const V3 mu = {p[0], p[1], p[2]};
  // the local rotation's matrix, q normalised (3DGS's computeCov3D)
  const float qn = fmaxf(__fsqrt_rn(
      add(add(add(mul(p[3], p[3]), mul(p[4], p[4])), mul(p[5], p[5])),
          mul(p[6], p[6]))), 1e-12f);
  const float qr = div(p[3], qn), qx = div(p[4], qn), qy = div(p[5], qn),
              qz = div(p[6], qn);
  float rq[3][3];
  rq[0][0] = sub(1.0f, mul(2.0f, add(mul(qy, qy), mul(qz, qz))));
  rq[0][1] = mul(2.0f, sub(mul(qx, qy), mul(qr, qz)));
  rq[0][2] = mul(2.0f, add(mul(qx, qz), mul(qr, qy)));
  rq[1][0] = mul(2.0f, add(mul(qx, qy), mul(qr, qz)));
  rq[1][1] = sub(1.0f, mul(2.0f, add(mul(qx, qx), mul(qz, qz))));
  rq[1][2] = mul(2.0f, sub(mul(qy, qz), mul(qr, qx)));
  rq[2][0] = mul(2.0f, sub(mul(qx, qz), mul(qr, qy)));
  rq[2][1] = mul(2.0f, add(mul(qy, qz), mul(qr, qx)));
  rq[2][2] = sub(1.0f, mul(2.0f, add(mul(qx, qx), mul(qy, qy))));
  const float es[3] = {expf(p[7]), expf(p[8]), expf(p[9])};
  const float opac = div(1.0f, add(1.0f, expf(-p[10])));
  float sh[kSh * 3];
#pragma unroll
  for (int i = 0; i < kSh * 3; ++i) sh[i] = shs[static_cast<size_t>(g) * kSh * 3 + i];
  const int f = binding[g];
  const int i0 = faces[f * 3 + 0], i1 = faces[f * 3 + 1], i2 = faces[f * 3 + 2];
  const int tiles_x = (width + kTile - 1) / kTile;
  const int tiles_y = (height + kTile - 1) / kTile;

  for (int b = 0; b < batch; ++b) {
    const size_t o = static_cast<size_t>(b) * n_gauss + g;
    const float* vb = verts + static_cast<size_t>(b) * n_vertices * 3;
    const V3 v0 = load3(vb + i0 * 3), v1 = load3(vb + i1 * 3),
             v2 = load3(vb + i2 * 3);
    // the triangle's frame
    const V3 e1 = vsub(v1, v0), e2 = vsub(v2, v0);
    const V3 a0 = unit(e1);
    const V3 a1 = unit(cross(a0, e2));
    const V3 c2 = unit(cross(a1, a0));
    const V3 a2 = {-c2.x, -c2.y, -c2.z};
    const float k = mul(add(__fsqrt_rn(fmaxf(dot(e1, e1), 1e-20f)),
                            fabsf(dot(a2, e2))),
                        0.5f);
    const V3 t = {mul(add(add(v0.x, v1.x), v2.x), kThird),
                  mul(add(add(v0.y, v1.y), v2.y), kThird),
                  mul(add(add(v0.z, v1.z), v2.z), kThird)};
    // the binding: mean = (R mu) k + T, R's columns a0, a1, a2
    const V3 m = {
        add(mul(add(add(mul(a0.x, mu.x), mul(a1.x, mu.y)), mul(a2.x, mu.z)), k), t.x),
        add(mul(add(add(mul(a0.y, mu.x), mul(a1.y, mu.y)), mul(a2.y, mu.z)), k), t.y),
        add(mul(add(add(mul(a0.z, mu.x), mul(a1.z, mu.y)), mul(a2.z, mu.z)), k), t.z)};
    means[o * 3 + 0] = m.x;
    means[o * 3 + 1] = m.y;
    means[o * 3 + 2] = m.z;
    float* ro = rec + o * 9;
    const float* cam = cams + static_cast<size_t>(b) * 14;
    // the view: p_view = W m + t
    const V3 pv = {add(add(add(mul(cam[0], m.x), mul(cam[1], m.y)), mul(cam[2], m.z)), cam[3]),
                   add(add(add(mul(cam[4], m.x), mul(cam[5], m.y)), mul(cam[6], m.z)), cam[7]),
                   add(add(add(mul(cam[8], m.x), mul(cam[9], m.y)), mul(cam[10], m.z)), cam[11])};
    int r = 0, n = 0;
    float x = 0.0f, y = 0.0f, ca = 0.0f, cb = 0.0f, cc = 0.0f, zv = 0.0f;
    float col[3] = {0.0f, 0.0f, 0.0f};
    if (pv.z > 0.2f) {
      // the world rotation R Rq and the covariance Sigma = M^T M, M = S Rw^T
      float mm[3][3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float ri[3] = {i == 0 ? a0.x : i == 1 ? a0.y : a0.z,
                             i == 0 ? a1.x : i == 1 ? a1.y : a1.z,
                             i == 0 ? a2.x : i == 1 ? a2.y : a2.z};
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const float rw = add(add(mul(ri[0], rq[0][j]), mul(ri[1], rq[1][j])),
                               mul(ri[2], rq[2][j]));
          mm[i][j] = mul(mul(es[j], k), rw);  // s'_j Rw[i][j]
        }
      }
      float sg[3][3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          sg[i][j] = add(add(mul(mm[i][0], mm[j][0]), mul(mm[i][1], mm[j][1])),
                         mul(mm[i][2], mm[j][2]));
        }
      }
      const float fx = cam[12], fy = cam[13];
      const float tanx = div(static_cast<float>(width), mul(2.0f, fx));
      const float tany = div(static_cast<float>(height), mul(2.0f, fy));
      const float focx = div(static_cast<float>(width), mul(2.0f, tanx));
      const float focy = div(static_cast<float>(height), mul(2.0f, tany));
      const float limx = mul(1.3f, tanx), limy = mul(1.3f, tany);
      const float tx = mul(fminf(limx, fmaxf(-limx, div(pv.x, pv.z))), pv.z);
      const float ty = mul(fminf(limy, fmaxf(-limy, div(pv.y, pv.z))), pv.z);
      const float zz = mul(pv.z, pv.z);
      const float j00 = div(focx, pv.z), j02 = -div(mul(focx, tx), zz);
      const float j11 = div(focy, pv.z), j12 = -div(mul(focy, ty), zz);
      // T = J W (2 x 3), then cov = T Sigma T^T
      float tm[2][3];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        tm[0][j] = add(mul(j00, cam[j]), mul(j02, cam[8 + j]));
        tm[1][j] = add(mul(j11, cam[4 + j]), mul(j12, cam[8 + j]));
      }
      float u[2][3];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          u[i][j] = add(add(mul(tm[i][0], sg[0][j]), mul(tm[i][1], sg[1][j])),
                        mul(tm[i][2], sg[2][j]));
        }
      }
      const float c00 = add(add(add(mul(u[0][0], tm[0][0]), mul(u[0][1], tm[0][1])),
                                mul(u[0][2], tm[0][2])), 0.3f);
      const float c01 = add(add(mul(u[0][0], tm[1][0]), mul(u[0][1], tm[1][1])),
                            mul(u[0][2], tm[1][2]));
      const float c11 = add(add(add(mul(u[1][0], tm[1][0]), mul(u[1][1], tm[1][1])),
                                mul(u[1][2], tm[1][2])), 0.3f);
      const float det = sub(mul(c00, c11), mul(c01, c01));
      if (det != 0.0f) {
        const float inv = div(1.0f, det);
        const float mid = mul(0.5f, add(c00, c11));
        const float lam = add(mid, __fsqrt_rn(fmaxf(0.1f, sub(mul(mid, mid), det))));
        r = static_cast<int>(ceilf(mul(3.0f, __fsqrt_rn(lam))));
        // the mean's pixel (ndc2Pix of x / (tan z), pixel centres on integers)
        const float zw = add(pv.z, 1e-7f);
        const float nx = div(div(pv.x, tanx), zw), ny = div(div(pv.y, tany), zw);
        x = mul(sub(mul(add(nx, 1.0f), static_cast<float>(width)), 1.0f), 0.5f);
        y = mul(sub(mul(add(ny, 1.0f), static_cast<float>(height)), 1.0f), 0.5f);
        int x0, y0, x1, y1;
        tile_rect(x, y, r, tiles_x, tiles_y, &x0, &y0, &x1, &y1);
        n = (x1 - x0) * (y1 - y0);
        if (n == 0) r = 0;
        ca = mul(c11, inv);
        cb = mul(-c01, inv);
        cc = mul(c00, inv);
        zv = pv.z;
        // SH-3 in the direction from the camera centre C = -W^T t
        const V3 cp = {
            -add(add(mul(cam[0], cam[3]), mul(cam[4], cam[7])), mul(cam[8], cam[11])),
            -add(add(mul(cam[1], cam[3]), mul(cam[5], cam[7])), mul(cam[9], cam[11])),
            -add(add(mul(cam[2], cam[3]), mul(cam[6], cam[7])), mul(cam[10], cam[11]))};
        V3 d = vsub(m, cp);
        const float dl = __fsqrt_rn(dot(d, d));
        d = {div(d.x, dl), div(d.y, dl), div(d.z, dl)};
        const float xx = mul(d.x, d.x), yy = mul(d.y, d.y), zz2 = mul(d.z, d.z);
        const float xy = mul(d.x, d.y), yz = mul(d.y, d.z), xz = mul(d.x, d.z);
        const float w[kSh] = {
            kC0,
            -mul(kC1, d.y),
            mul(kC1, d.z),
            -mul(kC1, d.x),
            mul(kC2[0], xy),
            mul(kC2[1], yz),
            mul(kC2[2], sub(sub(mul(2.0f, zz2), xx), yy)),
            mul(kC2[3], xz),
            mul(kC2[4], sub(xx, yy)),
            mul(mul(kC3[0], d.y), sub(mul(3.0f, xx), yy)),
            mul(mul(kC3[1], xy), d.z),
            mul(mul(kC3[2], d.y), sub(sub(mul(4.0f, zz2), xx), yy)),
            mul(mul(kC3[3], d.z), sub(sub(mul(2.0f, zz2), mul(3.0f, xx)), mul(3.0f, yy))),
            mul(mul(kC3[4], d.x), sub(sub(mul(4.0f, zz2), xx), yy)),
            mul(mul(kC3[5], d.z), sub(xx, yy)),
            mul(mul(kC3[6], d.x), sub(xx, mul(3.0f, yy)))};
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          float acc = mul(w[0], sh[ch]);
#pragma unroll
          for (int i = 1; i < kSh; ++i) acc = add(acc, mul(w[i], sh[i * 3 + ch]));
          col[ch] = fmaxf(add(acc, 0.5f), 0.0f);
        }
      }
    }
    const bool live = n > 0;
    ro[0] = live ? x : 0.0f;
    ro[1] = live ? y : 0.0f;
    ro[2] = live ? ca : 0.0f;
    ro[3] = live ? cb : 0.0f;
    ro[4] = live ? cc : 0.0f;
    ro[5] = live ? opac : 0.0f;
    ro[6] = live ? col[0] : 0.0f;
    ro[7] = live ? col[1] : 0.0f;
    ro[8] = live ? col[2] : 0.0f;
    depth[o] = live ? zv : 0.0f;
    radius[o] = r;
    count[o] = n;
  }
}

__global__ void gauss_emit_kernel(const float* __restrict__ rec,
                                  const float* __restrict__ depth,
                                  const int* __restrict__ radius,
                                  const int* __restrict__ count,
                                  const int64_t* __restrict__ offsets,
                                  int64_t* __restrict__ keys,
                                  int* __restrict__ gid, int batch, int n_gauss,
                                  int height, int width) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<int64_t>(batch) * n_gauss) return;
  const int n = count[i];
  if (n == 0) return;
  const int b = static_cast<int>(i / n_gauss);
  const int g = static_cast<int>(i % n_gauss);
  const int tiles_x = (width + kTile - 1) / kTile;
  const int tiles_y = (height + kTile - 1) / kTile;
  int x0, y0, x1, y1;
  tile_rect(rec[i * 9 + 0], rec[i * 9 + 1], radius[i], tiles_x, tiles_y, &x0,
            &y0, &x1, &y1);
  const int64_t bits = static_cast<int64_t>(__float_as_uint(depth[i]));
  const int64_t base = static_cast<int64_t>(b) * tiles_x * tiles_y;
  int64_t at = offsets[i] - n;
  for (int ty = y0; ty < y1; ++ty) {
    for (int tx = x0; tx < x1; ++tx) {
      keys[at] = ((base + ty * tiles_x + tx) << 32) | bits;
      gid[at] = g;
      ++at;
    }
  }
}

__global__ void gauss_ranges_kernel(const int64_t* __restrict__ skeys,
                                    const int64_t* __restrict__ order,
                                    const int* __restrict__ gid,
                                    int* __restrict__ ranges,
                                    int* __restrict__ sgid, int n_pairs) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n_pairs) return;
  sgid[k] = gid[order[k]];
  const int64_t tile = skeys[k] >> 32;
  if (k == 0) {
    ranges[tile * 2] = 0;
  } else {
    const int64_t prev = skeys[k - 1] >> 32;
    if (prev != tile) {
      ranges[prev * 2 + 1] = k;
      ranges[tile * 2] = k;
    }
  }
  if (k == n_pairs - 1) ranges[tile * 2 + 1] = n_pairs;
}

__global__ void __launch_bounds__(kBlendThreads)
gauss_blend_kernel(const int* __restrict__ ranges, const int* __restrict__ sgid,
                   const float* __restrict__ rec, float* __restrict__ image,
                   float* __restrict__ alpha, int n_gauss, int height, int width,
                   float bg_r, float bg_g, float bg_b) {
  __shared__ float s_xy[kBlendThreads][2];
  __shared__ float s_con[kBlendThreads][4];
  __shared__ float s_col[kBlendThreads][3];
  const int b = blockIdx.z;
  const int tiles_x = gridDim.x;
  const int tile = (b * gridDim.y + blockIdx.y) * tiles_x + blockIdx.x;
  const int px = blockIdx.x * kTile + threadIdx.x % kTile;
  const int py = blockIdx.y * kTile + threadIdx.x / kTile;
  const float fx = static_cast<float>(px), fy = static_cast<float>(py);
  const bool inside = px < width && py < height;
  bool done = !inside;
  const int start = ranges[tile * 2], end = ranges[tile * 2 + 1];
  const int rounds = (end - start + kBlendThreads - 1) / kBlendThreads;
  int todo = end - start;
  float t = 1.0f;
  float c[3] = {0.0f, 0.0f, 0.0f};
  const float* rb = rec + static_cast<size_t>(b) * n_gauss * 9;
  for (int i = 0; i < rounds; ++i, todo -= kBlendThreads) {
    if (__syncthreads_count(done) == kBlendThreads) break;
    const int k = start + i * kBlendThreads + threadIdx.x;
    if (k < end) {
      const float* q = rb + static_cast<size_t>(sgid[k]) * 9;
      s_xy[threadIdx.x][0] = q[0];
      s_xy[threadIdx.x][1] = q[1];
      s_con[threadIdx.x][0] = q[2];
      s_con[threadIdx.x][1] = q[3];
      s_con[threadIdx.x][2] = q[4];
      s_con[threadIdx.x][3] = q[5];
      s_col[threadIdx.x][0] = q[6];
      s_col[threadIdx.x][1] = q[7];
      s_col[threadIdx.x][2] = q[8];
    }
    __syncthreads();
    const int m = min(kBlendThreads, todo);
    for (int j = 0; !done && j < m; ++j) {
      const float dx = sub(s_xy[j][0], fx), dy = sub(s_xy[j][1], fy);
      const float power =
          sub(mul(-0.5f, add(mul(mul(s_con[j][0], dx), dx),
                             mul(mul(s_con[j][2], dy), dy))),
              mul(mul(s_con[j][1], dx), dy));
      if (power > 0.0f) continue;
      const float a = fminf(0.99f, mul(s_con[j][3], expf(power)));
      if (a < 1.0f / 255.0f) continue;
      const float test_t = mul(t, sub(1.0f, a));
      if (test_t < 0.0001f) {
        done = true;
        continue;
      }
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) c[ch] = add(c[ch], mul(mul(s_col[j][ch], a), t));
      t = test_t;
    }
  }
  if (inside) {
    const size_t pix = (static_cast<size_t>(b) * height + py) * width + px;
    image[pix * 3 + 0] = add(c[0], mul(t, bg_r));
    image[pix * 3 + 1] = add(c[1], mul(t, bg_g));
    image[pix * 3 + 2] = add(c[2], mul(t, bg_b));
    alpha[pix] = sub(1.0f, t);
  }
}

}  // namespace

// Each entry launches on `stream` and returns cudaGetLastError() of the
// launch.
extern "C" int gauss_prep(const void* verts, const void* faces,
                          const void* binding, const void* params,
                          const void* shs, const void* cams, void* means,
                          void* rec, void* depth, void* radius, void* count,
                          int batch, int n_vertices, int n_gauss, int height,
                          int width, void* stream) {
  const int blocks = (n_gauss + kPrepThreads - 1) / kPrepThreads;
  gauss_prep_kernel<<<blocks, kPrepThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(verts), static_cast<const int*>(faces),
      static_cast<const int*>(binding), static_cast<const float*>(params),
      static_cast<const float*>(shs), static_cast<const float*>(cams),
      static_cast<float*>(means), static_cast<float*>(rec),
      static_cast<float*>(depth), static_cast<int*>(radius),
      static_cast<int*>(count), batch, n_vertices, n_gauss, height, width);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gauss_emit(const void* rec, const void* depth, const void* radius,
                          const void* count, const void* offsets, void* keys,
                          void* gid, int batch, int n_gauss, int height,
                          int width, void* stream) {
  const int64_t n = static_cast<int64_t>(batch) * n_gauss;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
  gauss_emit_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rec), static_cast<const float*>(depth),
      static_cast<const int*>(radius), static_cast<const int*>(count),
      static_cast<const int64_t*>(offsets), static_cast<int64_t*>(keys),
      static_cast<int*>(gid), batch, n_gauss, height, width);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gauss_ranges(const void* skeys, const void* order,
                            const void* gid, void* ranges, void* sgid,
                            int n_pairs, void* stream) {
  const int threads = 256;
  const int blocks = (n_pairs + threads - 1) / threads;
  gauss_ranges_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(skeys), static_cast<const int64_t*>(order),
      static_cast<const int*>(gid), static_cast<int*>(ranges),
      static_cast<int*>(sgid), n_pairs);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gauss_blend(const void* ranges, const void* sgid, const void* rec,
                           void* image, void* alpha, int batch, int n_gauss,
                           int height, int width, float bg_r, float bg_g,
                           float bg_b, void* stream) {
  const dim3 grid((width + kTile - 1) / kTile, (height + kTile - 1) / kTile,
                  batch);
  gauss_blend_kernel<<<grid, kBlendThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ranges), static_cast<const int*>(sgid),
      static_cast<const float*>(rec), static_cast<float*>(image),
      static_cast<float*>(alpha), n_gauss, height, width, bg_r, bg_g, bg_b);
  return static_cast<int>(cudaGetLastError());
}
