// Native CPU z-buffer rasterizer — the C++ twin of
// facerecon_tpu_torch/oracle.py rasterize() (SURVEY.md §9.5 contract), a
// copy of the JAX package's native/raster_oracle.cc. Exact same float32
// operation order as the numpy oracle so outputs are bitwise-identical,
// but ~100x faster at full resolution (used for full-scale golden checks).
//
// Built by facerecon_tpu_torch/utils/native_oracle.py into
// facerecon_tpu_torch/_build/ with
//   g++ -O2 -ffp-contract=off -shared -fPIC raster_oracle.cc -o lib....so
// (-ffp-contract=off: no FMA contraction, so rounding matches numpy exactly)
//
// Contract: pixel covered iff all three edge functions carry the sign of the
// triangle's area (inclusive); nearest depth z' wins; ties -> smaller
// triangle id; tri_id = -1 and zbuf = +inf on background.

#include <cmath>
#include <cstdint>
#include <limits>

extern "C" {

void rasterize_cpu(const float* verts,   // (n_verts, 3) x_ndc, y_ndc, depth
                   int n_verts,
                   const int32_t* faces, // (n_faces, 3)
                   int n_faces,
                   int height, int width,
                   int32_t* tri_id,      // (h, w) out, init by callee
                   float* bary,          // (h, w, 3) out
                   float* zbuf) {        // (h, w) out
  const float inf = std::numeric_limits<float>::infinity();
  const int n_pix = height * width;
  for (int p = 0; p < n_pix; ++p) {
    tri_id[p] = -1;
    zbuf[p] = inf;
    bary[3 * p] = bary[3 * p + 1] = bary[3 * p + 2] = 0.0f;
  }

  const float half_w = 0.5f * static_cast<float>(width);
  const float half_h = 0.5f * static_cast<float>(height);

  for (int f = 0; f < n_faces; ++f) {
    const int32_t i0 = faces[3 * f], i1 = faces[3 * f + 1],
                  i2 = faces[3 * f + 2];
    if (i0 < 0 || i0 >= n_verts || i1 < 0 || i1 >= n_verts || i2 < 0 ||
        i2 >= n_verts)
      continue;
    // NDC -> screen, same formula as oracle.ndc_to_screen
    const float x0 = (verts[3 * i0] + 1.0f) * half_w;
    const float y0 = (1.0f - verts[3 * i0 + 1]) * half_h;
    const float x1 = (verts[3 * i1] + 1.0f) * half_w;
    const float y1 = (1.0f - verts[3 * i1 + 1]) * half_h;
    const float x2 = (verts[3 * i2] + 1.0f) * half_w;
    const float y2 = (1.0f - verts[3 * i2 + 1]) * half_h;
    const float z0 = verts[3 * i0 + 2];
    const float z1 = verts[3 * i1 + 2];
    const float z2 = verts[3 * i2 + 2];

    // signed area*2, same operation order as the oracle
    const float area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0);
    const float aabs = std::fabs(area);
    if (!(aabs > 1e-12f)) continue;
    const float s = area > 0.0f ? 1.0f : -1.0f;
    const float inv_area = 1.0f / area;

    // conservative integer pixel bbox over pixel centers (j+0.5, i+0.5)
    float xmin = x0 < x1 ? x0 : x1; xmin = xmin < x2 ? xmin : x2;
    float xmax = x0 > x1 ? x0 : x1; xmax = xmax > x2 ? xmax : x2;
    float ymin = y0 < y1 ? y0 : y1; ymin = ymin < y2 ? ymin : y2;
    float ymax = y0 > y1 ? y0 : y1; ymax = ymax > y2 ? ymax : y2;
    int jx0 = static_cast<int>(std::floor(xmin - 0.5f));
    int jx1 = static_cast<int>(std::ceil(xmax));
    int iy0 = static_cast<int>(std::floor(ymin - 0.5f));
    int iy1 = static_cast<int>(std::ceil(ymax));
    if (jx0 < 0) jx0 = 0;
    if (iy0 < 0) iy0 = 0;
    if (jx1 > width - 1) jx1 = width - 1;
    if (iy1 > height - 1) iy1 = height - 1;

    for (int iy = iy0; iy <= iy1; ++iy) {
      const float py = static_cast<float>(iy) + 0.5f;
      for (int jx = jx0; jx <= jx1; ++jx) {
        const float px = static_cast<float>(jx) + 0.5f;
        // edge functions, same form as oracle: edge(a,b) =
        // (bx-ax)*(py-ay) - (by-ay)*(px-ax); e0 uses edge(p1,p2) etc.
        const float e0 = (x2 - x1) * (py - y1) - (y2 - y1) * (px - x1);
        const float e1 = (x0 - x2) * (py - y2) - (y0 - y2) * (px - x2);
        const float e2 = (x1 - x0) * (py - y0) - (y1 - y0) * (px - x0);
        if (e0 * s < 0.0f || e1 * s < 0.0f || e2 * s < 0.0f) continue;
        const float w0 = e0 * inv_area;
        const float w1 = e1 * inv_area;
        const float w2 = e2 * inv_area;
        const float z = w0 * z0 + w1 * z1 + w2 * z2;
        const int p = iy * width + jx;
        if (z < zbuf[p]) {  // strict: earlier (smaller) id wins ties
          zbuf[p] = z;
          tri_id[p] = f;
          bary[3 * p] = w0;
          bary[3 * p + 1] = w1;
          bary[3 * p + 2] = w2;
        }
      }
    }
  }
}

}  // extern "C"
