// Geometry + SH-9 for the forward-only calls, for Hopper (sm_90a): from the
// three basis products (ops/geometry.basis_products, plain matrix products
// in the library) to the posed, projected, lit mesh (ops/geometry.Geometry
// with its radiance). One C entry, two passes:
//
//   1. shape_kernel: the canonical shape S = (mean_shape + id_part) +
//      exp_part, one thread an element of the (B, 3N) plane;
//   2. geometry_kernel: one thread a (face in the batch, vertex), and 68
//      more a face for the landmarks. Each block builds its face's R =
//      Rz Ry Rx and the nine scaled SH weights a channel in shared memory;
//      each thread then
//        - recomputes the area-weighted normal of every face adjacent to
//          its vertex (vertex_face_adj, slots 0..deg_max-1, pad = F) from
//          the three corners of S, and sums them in slot order, a pad slot
//          adding +0.0;
//        - normalises (norm clamped at 1e-8) and rotates the normal;
//        - poses the vertex (S R^T + t) and projects it to NDC and depth;
//        - computes the albedo (mean_tex + tex_part) / 255 and the SH-9
//          radiance in sh.illuminate's order;
//      and writes world, ndc, normals, texture and radiance (B, N, 3).
//      A landmark thread poses its landmark vertex the same way and writes
//      its pixel coordinates (B, 68, 2).
//
// Replaces no TPU kernel: the JAX package computes this layer with
// XLA-fused jnp (facerecon_tpu/ops/geometry.py coeffs_to_geometry,
// facerecon_tpu/ops/sh.py illuminate). The port ran it as about 180 eager
// launches a call (corner gathers, six cross-product passes, a deg_max-long
// gather-and-add loop on each of three planes, the rotation built from ~20
// small ops, the pose, the projections, 24 SH multiply-adds): 5.0 ms of
// 22.3 a microbatch of 128 on an H100 for a 0.13 ms bound. The
// differentiable path (training, fitting) keeps those eager ops: this
// kernel has no backward.
//
// Bound on this card: bytes. At the asset's 35,721 vertices and batch 128
// the layer must read the bases (3N x 224 x 4 B = 96 MB) and write six
// (B, N, 3) f32 planes (shape, world, ndc, normals, texture, radiance:
// 329 MB), 0.127 ms at 3.35e12 B/s; the basis products are 6.1 GFLOP,
// 0.092 ms at the float32 peak of 67e12. The design adds the products'
// round trip (3 planes written by the library and read here) and the
// shape's (written by pass 1, read by pass 2): 808 MB in all, 0.241 ms.
// Recomputing each face normal at its three vertices, rather than writing
// a (B, F, 3) face-normal plane (108 MB at batch 128), keeps the corner
// reads in L1 and L2: an image's shape is 429 KB.
//
// The plain version (ops/geometry.vertex_pass_reference, the eager path's
// forward) run with PyTorch's CUDA ops, op for op, but for the rotation:
// the library is built with -fmad=false, so no product is fused into an
// add, and every sum keeps the plain version's order. Where PyTorch's CUDA
// division by a Python scalar multiplies by the float reciprocal (the
// texture's / 255 and to_ndc's / (size / 2)), so does this kernel; a
// division by a tensor is a true division. The rotation's products (Rz Ry
// Rx, S R^T, n R^T) are three-term sums in k order here, and matmuls in the
// plain version, which sum the same terms in their own order, fused: an ulp
// or so apart. So shape and texture are bit for bit the plain version's,
// the posed fields within an ulp or so.
//
// Layout (row-major, contiguous unless a row stride is given):
//   id_part, exp_part, tex_part (B, 3N) f32 the basis products
//   mean_shape, mean_tex (3N,) f32
//   angles (B, 3), gamma (B, 27), trans (B, 3) f32 with row strides
//     (views of one coefficient row: the last axis contiguous)
//   faces (F, 3) i64; adj (N, deg_max) i64, pad F; lmk (68,) i64
// Outputs: shape, world, ndc, normals, texture, radiance (B, N, 3) f32;
// landmarks (B, 68, 2) f32.

#include <cuda_runtime.h>

namespace {

constexpr int kShapeThreads = 256;  // elements a block in pass 1
constexpr int kThreads = 128;       // vertices a block in pass 2

// the camera and the nine SH scale constants (ops/sh.SH_SCALES)
struct Consts {
  float focal, cam, center, inv_half;
  float scale[9];
};

// out = a b for 3x3 row-major matrices, each entry a three-term sum in k
// order
__device__ __forceinline__ void mm3(const float* a, const float* b,
                                    float* out) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      out[3 * i + j] = (a[3 * i] * b[j] + a[3 * i + 1] * b[3 + j])
                       + a[3 * i + 2] * b[6 + j];
    }
  }
}

// row j of R applied to p: (p R^T)_j
__device__ __forceinline__ float rot_row(const float* r, int j, float x,
                                         float y, float z) {
  return (x * r[3 * j] + y * r[3 * j + 1]) + z * r[3 * j + 2];
}

__global__ void __launch_bounds__(kShapeThreads)
shape_kernel(const float* __restrict__ id_part,
             const float* __restrict__ exp_part,
             const float* __restrict__ mean_shape, float* __restrict__ shape,
             int plane) {
  const int e = blockIdx.x * kShapeThreads + threadIdx.x;
  if (e >= plane) return;
  const size_t o = static_cast<size_t>(blockIdx.y) * plane + e;
  shape[o] = (mean_shape[e] + id_part[o]) + exp_part[o];
}

__global__ void __launch_bounds__(kThreads)
geometry_kernel(const float* __restrict__ shape,
                const float* __restrict__ tex_part,
                const float* __restrict__ mean_tex,
                const float* __restrict__ angles,
                const float* __restrict__ gamma,
                const float* __restrict__ trans,
                const long long* __restrict__ faces,
                const long long* __restrict__ adj,
                const long long* __restrict__ lmk,
                float* __restrict__ world, float* __restrict__ ndc,
                float* __restrict__ normals, float* __restrict__ texture,
                float* __restrict__ radiance, float* __restrict__ landmarks,
                int n_verts, int n_faces, int deg_max, int n_lmk,
                int angle_stride, int gamma_stride, int trans_stride,
                Consts k) {
  __shared__ float s_rot[9];
  __shared__ float s_g[27];
  __shared__ float s_t[3];
  const int b = blockIdx.y;
  const int t = threadIdx.x;
  if (t < 27) {
    // (gamma + e1) * SH_SCALES, channel-major [c * 9 + k]
    const int kk = t % 9;
    s_g[t] = (gamma[static_cast<size_t>(b) * gamma_stride + t]
              + (kk == 0 ? 1.0f : 0.0f)) * k.scale[kk];
  } else if (t < 30) {
    s_t[t - 27] = trans[static_cast<size_t>(b) * trans_stride + t - 27];
  } else if (t == 32) {
    // compute_rotation: Rz(psi) Ry(phi) Rx(theta)
    const float* a = angles + static_cast<size_t>(b) * angle_stride;
    const float ct = cosf(a[0]), st = sinf(a[0]);
    const float cp = cosf(a[1]), sp = sinf(a[1]);
    const float cs = cosf(a[2]), ss = sinf(a[2]);
    const float rx[9] = {1.0f, 0.0f, 0.0f, 0.0f, ct, -st, 0.0f, st, ct};
    const float ry[9] = {cp, 0.0f, sp, 0.0f, 1.0f, 0.0f, -sp, 0.0f, cp};
    const float rz[9] = {cs, -ss, 0.0f, ss, cs, 0.0f, 0.0f, 0.0f, 1.0f};
    float zy[9], r[9];
    mm3(rz, ry, zy);
    mm3(zy, rx, r);
#pragma unroll
    for (int i = 0; i < 9; ++i) s_rot[i] = r[i];
  }
  __syncthreads();
  const int i = blockIdx.x * kThreads + t;
  if (i >= n_verts + n_lmk) return;
  const size_t plane = static_cast<size_t>(n_verts) * 3;
  const float* sb = shape + static_cast<size_t>(b) * plane;

  if (i >= n_verts) {
    // perspective_projection of the posed landmark vertex
    const int j = i - n_verts;
    const float* p = sb + lmk[j] * 3;
    const float x = rot_row(s_rot, 0, p[0], p[1], p[2]) + s_t[0];
    const float y = rot_row(s_rot, 1, p[0], p[1], p[2]) + s_t[1];
    const float z = rot_row(s_rot, 2, p[0], p[1], p[2]) + s_t[2];
    const float zp = k.cam - z;
    float* out = landmarks + (static_cast<size_t>(b) * n_lmk + j) * 2;
    out[0] = k.focal * x / zp + k.center;
    out[1] = k.center - k.focal * y / zp;
    return;
  }

  // compute_norm: the adjacent faces' normals summed in slot order
  float nx = 0.0f, ny = 0.0f, nz = 0.0f;
  const long long* av = adj + static_cast<size_t>(i) * deg_max;
  for (int s = 0; s < deg_max; ++s) {
    const long long f = av[s];
    float fx = 0.0f, fy = 0.0f, fz = 0.0f;   // a pad slot adds +0.0
    if (f < n_faces) {
      const float* p0 = sb + faces[f * 3] * 3;
      const float* p1 = sb + faces[f * 3 + 1] * 3;
      const float* p2 = sb + faces[f * 3 + 2] * 3;
      const float x0 = p0[0], y0 = p0[1], z0 = p0[2];
      const float ax = p1[0] - x0, ay = p1[1] - y0, az = p1[2] - z0;
      const float bx = p2[0] - x0, by = p2[1] - y0, bz = p2[2] - z0;
      fx = ay * bz - az * by;
      fy = az * bx - ax * bz;
      fz = ax * by - ay * bx;
    }
    if (s == 0) {
      nx = fx;
      ny = fy;
      nz = fz;
    } else {
      nx = nx + fx;
      ny = ny + fy;
      nz = nz + fz;
    }
  }
  const float eps = static_cast<float>(1e-8);
  float len = sqrtf((nx * nx + ny * ny) + nz * nz);
  len = len < eps ? eps : len;                     // clamp(min=1e-8)
  nx = nx / len;
  ny = ny / len;
  nz = nz / len;
  const float rnx = rot_row(s_rot, 0, nx, ny, nz);
  const float rny = rot_row(s_rot, 1, nx, ny, nz);
  const float rnz = rot_row(s_rot, 2, nx, ny, nz);

  // rigid_transform and to_ndc
  const size_t o = static_cast<size_t>(b) * plane + static_cast<size_t>(i) * 3;
  const float* p = sb + static_cast<size_t>(i) * 3;
  const float x = rot_row(s_rot, 0, p[0], p[1], p[2]) + s_t[0];
  const float y = rot_row(s_rot, 1, p[0], p[1], p[2]) + s_t[1];
  const float z = rot_row(s_rot, 2, p[0], p[1], p[2]) + s_t[2];
  const float zp = k.cam - z;
  world[o] = x;
  world[o + 1] = y;
  world[o + 2] = z;
  ndc[o] = k.focal * x / zp * k.inv_half;
  ndc[o + 1] = k.focal * y / zp * k.inv_half;
  ndc[o + 2] = zp;
  normals[o] = rnx;
  normals[o + 1] = rny;
  normals[o + 2] = rnz;

  // texture_formation and illuminate
  const float feats[9] = {1.0f, rny, rnz, rnx, rnx * rny, rny * rnz,
                          3.0f * rnz * rnz - 1.0f, rnx * rnz,
                          rnx * rnx - rny * rny};
  const float inv255 = 1.0f / 255.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float tex = (mean_tex[static_cast<size_t>(i) * 3 + c]
                       + tex_part[o + c]) * inv255;
    const float* g = s_g + 9 * c;
    float light = g[0];
#pragma unroll
    for (int kk = 1; kk < 9; ++kk) light = light + feats[kk] * g[kk];
    texture[o + c] = tex;
    radiance[o + c] = tex * light;
  }
}

}  // namespace

// Both passes on `stream`: shape, then everything else. Returns the first
// failing launch's cudaGetLastError(), else 0.
extern "C" int geometry(const void* id_part, const void* exp_part,
                        const void* tex_part, const void* mean_shape,
                        const void* mean_tex, const void* angles,
                        const void* gamma, const void* trans,
                        const void* faces, const void* adj, const void* lmk,
                        void* shape, void* world, void* ndc, void* normals,
                        void* texture, void* radiance, void* landmarks,
                        int batch, int n_verts, int n_faces, int deg_max,
                        int n_lmk, int angle_stride, int gamma_stride,
                        int trans_stride, float focal, float cam,
                        float center, float half, float s0, float s1,
                        float s2, float s3, float s4, float s5, float s6,
                        float s7, float s8, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int plane = n_verts * 3;
  shape_kernel<<<dim3((plane + kShapeThreads - 1) / kShapeThreads, batch),
                 kShapeThreads, 0, st>>>(
      static_cast<const float*>(id_part), static_cast<const float*>(exp_part),
      static_cast<const float*>(mean_shape), static_cast<float*>(shape),
      plane);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // PyTorch divides by a CPU scalar as a multiply by its float reciprocal
  const Consts k = {focal, cam, center, 1.0f / half,
                    {s0, s1, s2, s3, s4, s5, s6, s7, s8}};
  geometry_kernel<<<dim3((n_verts + n_lmk + kThreads - 1) / kThreads, batch),
                    kThreads, 0, st>>>(
      static_cast<const float*>(shape), static_cast<const float*>(tex_part),
      static_cast<const float*>(mean_tex), static_cast<const float*>(angles),
      static_cast<const float*>(gamma), static_cast<const float*>(trans),
      static_cast<const long long*>(faces), static_cast<const long long*>(adj),
      static_cast<const long long*>(lmk), static_cast<float*>(world),
      static_cast<float*>(ndc), static_cast<float*>(normals),
      static_cast<float*>(texture), static_cast<float*>(radiance),
      static_cast<float*>(landmarks), n_verts, n_faces, deg_max, n_lmk,
      angle_stride, gamma_stride, trans_stride, k);
  return static_cast<int>(cudaGetLastError());
}
