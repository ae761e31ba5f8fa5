// The triangle setup's float32 arithmetic that two kernels compute: the
// NDC -> screen transform and the barycentric affine forms anchored at
// vertex 0 (ops/binning.ndc_to_screen and affine_forms). bin_setup
// (binning.cu) writes them into the rasterizer's setup, the records kernel
// (records.cu) into the render records, from whose winner K1, the
// textured kernel and the training shade rebuild the barycentrics; one
// source keeps the two bit for bit equal.
//
// Each value is the plain version's float32 operation in its order: the
// library is built with -fmad=false, so no product is fused into an add,
// and 1 / area is the correctly rounded reciprocal, as torch's. A dead
// row (|area| <= 1e-12, or culled) takes inv_area = 0, so its forms are
// the products' signed zeros, as the plain version's are.

#pragma once

#include <cuda_runtime.h>

namespace setup {

struct Forms {
  float wa0, wb0, wc0;   // w0(q) = wa0 qx + wb0 qy + wc0, q = pixel - p0
  float wa1, wb1, wc1;   // w1(q) the same
  bool dead;             // no area (or culled): inv_area 0
};

// binning.ndc_to_screen of one vertex; half_w = width * 0.5 (exact)
__device__ __forceinline__ void to_screen(const float* p, float half_w,
                                          float half_h, float& x, float& y) {
  x = (p[0] + 1.0f) * half_w;
  y = (1.0f - p[1]) * half_h;
}

// binning.affine_forms of the screen corners (x[k], y[k]); cull also
// kills every triangle of positive area (the binning's back-face rule)
__device__ __forceinline__ Forms affine_forms(const float x[3],
                                              const float y[3], bool cull) {
  const float u1 = x[1] - x[0];
  const float v1 = y[1] - y[0];
  const float u2 = x[2] - x[0];
  const float v2 = y[2] - y[0];
  const float area = u1 * v2 - v1 * u2;
  Forms f;
  f.dead = fabsf(area) <= 1e-12f;
  if (cull) f.dead = f.dead || area > 0.0f;
  const float inv = f.dead ? 0.0f : __frcp_rn(area);
  f.wa0 = (v1 - v2) * inv;
  f.wb0 = (u2 - u1) * inv;
  f.wc0 = (u1 * v2 - u2 * v1) * inv;
  f.wa1 = v2 * inv;
  f.wb1 = -u2 * inv;
  f.wc1 = 0.0f;
  return f;
}

}  // namespace setup
