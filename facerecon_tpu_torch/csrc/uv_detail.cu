// DECA's detail model in UV space for Hopper (sm_90a): world2uv,
// displacement2normal and the SH-shaded texture, one thread a texel.
//
// Replaces no TPU kernel: the JAX package has no DECA/FLAME path. It was
// added for DECA's detail model (arXiv:2012.04012, decalib/deca.py
// displacement2normal, utils/renderer.py world2uv and add_SHlight,
// utils/util.py vertex_normals on generate_triangles' dense grid). Done
// eagerly that is a dozen full passes over (B, 3, S, S) planes and a
// scatter over the grid's 2 (S - 5)(S - 11) faces; the grid is regular,
// so a texel's normal is a fixed stencil over the six faces around it,
// and one pass computes it.
//
// Per texel t of image b (a block of 16 x 16 texels stages the displaced
// positions of its texels and a one-texel halo in shared memory):
//   world2uv:  V(t), N(t) = ((w0 a0 + w1 a1) + w2 a2) of the posed
//              vertices and coarse normals at the corners of the UV face
//              the static table gives t (0 where no face covers t);
//   position:  P(t) = (V + (uv_z M) N) + fixed N;
//   normal:    n = sum of the corner cross products of the dense faces
//              that touch t, in DECA's index_add_ order (as vertex 1 of
//              the two faces of cell (y-1, x), vertex 2 of cell
//              (y-1, x-1)'s second and cell (y, x-1)'s first, vertex 0 of
//              cell (y, x-1)'s second and cell (y, x)'s first; a cell
//              (cy, cx) has faces where mx <= cx < S-1-mx and my <= cy <
//              S-1-my), each cross product of the corner's two edges as
//              DECA writes it, then n / max(|n|, 1e-6);
//   blend:     N_d = n M + N (1 - M);
//   shade:     texture_c = albedo_c x sum_k (Y_k(N_d) sh_factor_k)
//              light[k][c] in k order, Y = [1, x, y, z, xy, xz, yz,
//              x^2 - y^2, 3z^2 - 1] (the textured kernel's shade);
//   outputs:   texture and N_d (B, S, S, 3), displacement uv_z + fixed
//              (B, S, S) (uv_z unmasked, as DECA returns it).
// The plain version is ops/detail.uv_detail_reference, op for op
// (-fmad=false).
//
// Bound on this card: bytes. Per image the posed vertices and coarse
// normals (24 B a vertex), uv_z and the albedo read and the three outputs
// written (44 B a texel); once the table (16 B a texel), fixed and M.
//
// Layout (row-major, contiguous): verts, normals (B, N, 3) f32; uv_z
// (B, S, S) f32; faces (F, 3) i32; tface (S * S) i32; tbary (S * S, 3)
// f32; fixed, mask (S, S) f32; albedo (B, S, S, 3) f32; light (B, 9, 3)
// f32; shf (9,) f32.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kHalo = kTile + 2;
constexpr int kThreads = kTile * kTile;

struct Vec3 {
  float x, y, z;
};

__device__ __forceinline__ Vec3 sub(Vec3 a, Vec3 b) {
  return {__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y), __fsub_rn(a.z, b.z)};
}

__device__ __forceinline__ Vec3 cross(Vec3 a, Vec3 b) {
  return {__fsub_rn(__fmul_rn(a.y, b.z), __fmul_rn(a.z, b.y)),
          __fsub_rn(__fmul_rn(a.z, b.x), __fmul_rn(a.x, b.z)),
          __fsub_rn(__fmul_rn(a.x, b.y), __fmul_rn(a.y, b.x))};
}

__device__ __forceinline__ float lerp3(float w0, float a, float w1, float b,
                                       float w2, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(w0, a), __fmul_rn(w1, b)),
                   __fmul_rn(w2, c));
}

__global__ void __launch_bounds__(kThreads)
uv_detail_kernel(const float* __restrict__ verts,
                 const float* __restrict__ normals,
                 const float* __restrict__ uv_z,
                 const int* __restrict__ faces,
                 const int* __restrict__ tface,
                 const float* __restrict__ tbary,
                 const float* __restrict__ fixed,
                 const float* __restrict__ mask,
                 const float* __restrict__ albedo,
                 const float* __restrict__ light,
                 const float* __restrict__ shf,
                 float* __restrict__ texture, float* __restrict__ out_normals,
                 float* __restrict__ disp, int n_vertices, int size,
                 int margin_x, int margin_y) {
  __shared__ Vec3 pos[kHalo * kHalo];
  __shared__ Vec3 nrm[kHalo * kHalo];
  const int b = blockIdx.z;
  const int x0 = blockIdx.x * kTile - 1;
  const int y0 = blockIdx.y * kTile - 1;
  const size_t plane = static_cast<size_t>(size) * size;
  const float* vb = verts + static_cast<size_t>(b) * n_vertices * 3;
  const float* nb = normals + static_cast<size_t>(b) * n_vertices * 3;
  const float* zb = uv_z + static_cast<size_t>(b) * plane;
  for (int k = threadIdx.x; k < kHalo * kHalo; k += kThreads) {
    const int x = x0 + k % kHalo;
    const int y = y0 + k / kHalo;
    Vec3 p = {0.0f, 0.0f, 0.0f};
    Vec3 n = {0.0f, 0.0f, 0.0f};
    if (x >= 0 && x < size && y >= 0 && y < size) {
      const int t = y * size + x;
      const int f = tface[t];
      Vec3 v = {0.0f, 0.0f, 0.0f};
      if (f >= 0) {
        const float w0 = tbary[t * 3 + 0];
        const float w1 = tbary[t * 3 + 1];
        const float w2 = tbary[t * 3 + 2];
        const float* a = vb + faces[f * 3 + 0] * 3;
        const float* c1 = vb + faces[f * 3 + 1] * 3;
        const float* c2 = vb + faces[f * 3 + 2] * 3;
        v = {lerp3(w0, a[0], w1, c1[0], w2, c2[0]),
             lerp3(w0, a[1], w1, c1[1], w2, c2[1]),
             lerp3(w0, a[2], w1, c1[2], w2, c2[2])};
        const float* na = nb + faces[f * 3 + 0] * 3;
        const float* n1 = nb + faces[f * 3 + 1] * 3;
        const float* n2 = nb + faces[f * 3 + 2] * 3;
        n = {lerp3(w0, na[0], w1, n1[0], w2, n2[0]),
             lerp3(w0, na[1], w1, n1[1], w2, n2[1]),
             lerp3(w0, na[2], w1, n1[2], w2, n2[2])};
      }
      const float z = __fmul_rn(zb[t], mask[t]);
      const float fd = fixed[t];
      p = {__fadd_rn(__fadd_rn(v.x, __fmul_rn(z, n.x)), __fmul_rn(fd, n.x)),
           __fadd_rn(__fadd_rn(v.y, __fmul_rn(z, n.y)), __fmul_rn(fd, n.y)),
           __fadd_rn(__fadd_rn(v.z, __fmul_rn(z, n.z)), __fmul_rn(fd, n.z))};
    }
    pos[k] = p;
    nrm[k] = n;
  }
  __syncthreads();

  const int lx = threadIdx.x % kTile;
  const int ly = threadIdx.x / kTile;
  const int x = x0 + 1 + lx;
  const int y = y0 + 1 + ly;
  if (x >= size || y >= size) return;
  auto at = [&](int dy, int dx) { return pos[(ly + 1 + dy) * kHalo + lx + 1 + dx]; };
  auto cell = [&](int cy, int cx) {
    return cx >= margin_x && cx < size - 1 - margin_x && cy >= margin_y &&
           cy < size - 1 - margin_y;
  };
  const Vec3 a = at(0, 0);
  Vec3 acc = {0.0f, 0.0f, 0.0f};
  auto add = [&](bool valid, Vec3 c) {
    acc = {__fadd_rn(acc.x, valid ? c.x : 0.0f),
           __fadd_rn(acc.y, valid ? c.y : 0.0f),
           __fadd_rn(acc.z, valid ? c.z : 0.0f)};
  };
  const bool up = cell(y - 1, x);
  add(up, cross(sub(at(-1, 1), a), sub(at(-1, 0), a)));
  add(up, cross(sub(at(0, 1), a), sub(at(-1, 1), a)));
  add(cell(y - 1, x - 1), cross(sub(at(-1, 0), a), sub(at(0, -1), a)));
  const bool left = cell(y, x - 1);
  add(left, cross(sub(at(0, -1), a), sub(at(1, -1), a)));
  add(left, cross(sub(at(1, -1), a), sub(at(1, 0), a)));
  add(cell(y, x), cross(sub(at(1, 0), a), sub(at(0, 1), a)));
  const float len = fmaxf(
      __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(acc.x, acc.x),
                                     __fmul_rn(acc.y, acc.y)),
                           __fmul_rn(acc.z, acc.z))),
      1e-6f);
  const int t = y * size + x;
  const float m = mask[t];
  const float keep = __fsub_rn(1.0f, m);
  const Vec3 nc = nrm[(ly + 1) * kHalo + lx + 1];
  const float nd[3] = {
      __fadd_rn(__fmul_rn(__fdiv_rn(acc.x, len), m), __fmul_rn(nc.x, keep)),
      __fadd_rn(__fmul_rn(__fdiv_rn(acc.y, len), m), __fmul_rn(nc.y, keep)),
      __fadd_rn(__fmul_rn(__fdiv_rn(acc.z, len), m), __fmul_rn(nc.z, keep))};
  const float sh[9] = {
      1.0f, nd[0], nd[1], nd[2], __fmul_rn(nd[0], nd[1]),
      __fmul_rn(nd[0], nd[2]), __fmul_rn(nd[1], nd[2]),
      __fsub_rn(__fmul_rn(nd[0], nd[0]), __fmul_rn(nd[1], nd[1])),
      __fsub_rn(__fmul_rn(3.0f, __fmul_rn(nd[2], nd[2])), 1.0f)};
  const float* lb = light + static_cast<size_t>(b) * 27;
  const size_t o = (static_cast<size_t>(b) * plane + t) * 3;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    float acc_s = __fmul_rn(__fmul_rn(sh[0], shf[0]), lb[ch]);
#pragma unroll
    for (int k = 1; k < 9; ++k) {
      acc_s = __fadd_rn(acc_s, __fmul_rn(__fmul_rn(sh[k], shf[k]),
                                         lb[k * 3 + ch]));
    }
    texture[o + ch] = __fmul_rn(albedo[o + ch], acc_s);
    out_normals[o + ch] = nd[ch];
  }
  disp[static_cast<size_t>(b) * plane + t] = __fadd_rn(zb[t], fixed[t]);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() of the launch.
extern "C" int uv_detail(const void* verts, const void* normals,
                         const void* uv_z, const void* faces,
                         const void* tface, const void* tbary,
                         const void* fixed, const void* mask,
                         const void* albedo, const void* light,
                         const void* shf, void* texture, void* out_normals,
                         void* disp, int batch, int n_vertices, int size,
                         int margin_x, int margin_y, void* stream) {
  const int tiles = (size + kTile - 1) / kTile;
  const dim3 grid(tiles, tiles, batch);
  uv_detail_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(verts), static_cast<const float*>(normals),
      static_cast<const float*>(uv_z), static_cast<const int*>(faces),
      static_cast<const int*>(tface), static_cast<const float*>(tbary),
      static_cast<const float*>(fixed), static_cast<const float*>(mask),
      static_cast<const float*>(albedo), static_cast<const float*>(light),
      static_cast<const float*>(shf), static_cast<float*>(texture),
      static_cast<float*>(out_normals), static_cast<float*>(disp),
      n_vertices, size, margin_x, margin_y);
  return static_cast<int>(cudaGetLastError());
}
