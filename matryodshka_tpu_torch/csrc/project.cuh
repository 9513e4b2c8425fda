// The two lookup projections the sweep and render kernels compute in
// registers: the ODS eye projection of a point on a sweep sphere (K1's row
// parameters) and the intersection of a target pixel's ray with an MSI
// shell (K3's per-shell uv).
//
// The first follows the plain PyTorch version (cameras.project_ods and
// ops/sweep.py:row_params) operation by operation and rounds every
// operation once. The second (intersect.sphere_intersections and
// intersect_sphere_uv), which runs per (pixel, shell) on the render's hot
// path, hoists the terms that do not depend on the shell and fuses with
// explicit FMAs. Both map angles to pixels with one FMA a coordinate.
// Products, sums and quotients are written with the _rn intrinsics, so
// nvcc contracts nothing on its own and every kernel that calls these
// functions (the sweep, the render, and the two instrument kernels that
// write their results into tables) gets the same bits. sqrtf and atan2f
// are the precise forms (atan2f is within 2 ulp, csrc/probes.cu).
// The latitude and longitude of a pixel come from grids.lat_long_grid's
// vectors, which the wrappers build once per shape.
#pragma once

#include "common.cuh"

namespace matry {

__device__ __forceinline__ float fmul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float fadd(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float fsub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float fdiv(float a, float b) {
  return __fdiv_rn(a, b);
}
// torch.clamp(x, min=0): NaN stays NaN.
__device__ __forceinline__ float clamp0(float x) { return x < 0.f ? 0.f : x; }

// torch.remainder(x, n) of a float: fmod, moved into [0, n).
__device__ __forceinline__ float fremainder(float x, float n) {
  float m = fmodf(x, n);
  if (m < 0.f) m = fadd(m, n);
  return m;
}

// grids.theta_phi_to_pixels_uv folded into one FMA per coordinate,
// u = theta * ku + ou, v = phi * kv + ov, the constants evaluated in
// double (the rounding differs from the plain version's four operations
// by about an ulp of u, far inside the projection's noise bound).
struct PixelAffine {
  float ku, ou, kv, ov;
};

__device__ __forceinline__ PixelAffine pixel_affine(int W, int H) {
  const double PI = 3.141592653589793;
  const double ku = (W - 1) / (2 * PI - 2 * PI / W);
  const double kv = (H - 1) / (PI - PI / H);
  return {(float)ku, (float)((PI - PI / W) * ku), (float)kv,
          (float)((0.5 * PI - 0.5 * PI / H) * kv)};
}

__device__ __forceinline__ void to_pixels(float theta, float phi,
                                          const PixelAffine& m, float& u,
                                          float& v) {
  u = __fmaf_rn(theta, m.ku, m.ou);
  v = __fmaf_rn(phi, m.kv, m.ov);
}

// cameras.project_ods of one point for eye `order` on the viewing circle
// of radius r: the tangent ray's pixel (u, v), or (1, 1) where the point
// has no tangent ray (the reference's park).
__device__ __forceinline__ void project_ods(float x, float y, float z,
                                            float r, int order,
                                            const PixelAffine& m, float& u,
                                            float& v) {
  const float f = fsub(fmul(r, r), fadd(fmul(x, x), fmul(z, z)));
  const bool zlx = fabsf(z) > fabsf(x);
  const float px = zlx ? x : z;
  const float pz = zlx ? z : x;
  const float pz_sq = fmul(pz, pz);
  const float a = fadd(1.f, fdiv(fmul(px, px), pz_sq));
  const float b = fdiv(fmul(fmul(-2.f, f), px), pz_sq);
  const float c = fadd(f, fdiv(fmul(f, f), pz_sq));
  const float disc = fsub(fmul(b, b), fmul(fmul(4.f, a), c));
  if (!(disc >= 0.f)) {
    u = 1.f;
    v = 1.f;
    return;
  }
  const int sign_pz = (pz > 0.f) - (pz < 0.f);
  float s = fmul((float)(-order * sign_pz), sqrtf(clamp0(disc)));
  if (!zlx) s = -s;
  const float dx = fdiv(fadd(-b, s), fmul(2.f, a));
  const float dz = fdiv(fsub(f, fmul(px, dx)), pz);
  const float ex = zlx ? -dx : -dz;
  const float ez = zlx ? -dz : -dx;
  const float theta = -atan2f(ez, ex);
  float phi = atan2f(y, sqrtf(fadd(fmul(ex, ex), fmul(ez, ez))));
  if (isnan(phi)) phi = 1.f;
  const float half_pi = 1.57079637f;      // pi / 2 rounded to float
  phi = fminf(fmaxf(phi, -half_pi), half_pi);
  to_pixels(theta, phi, m, u, v);
}

// ops/sweep.py:_probe_columns, probe k of 16: the four quarter columns,
// then the odd eighths and the odd sixteenths. (Python drops repeated
// columns; a repeat projects to the same pixel, so the first column that
// is not parked is the same either way.)
__device__ __forceinline__ int probe_column(int k, int W) {
  int c;
  if (k < 4)
    c = k * W / 4;
  else if (k < 8)
    c = (2 * (k - 4) + 1) * W / 8;
  else
    c = (2 * (k - 8) + 1) * W / 16;
  return c % W;
}

// One sweep row's parameters (ops/sweep.py:row_params).
struct RowParam {
  int y0, y1, x0, valid;
  float fy, fx;
};

// row_params for (plane depth d, latitude row i) of one eye, evaluated by
// a half-warp: lane k of the half projects probe k, a ballot picks the
// first probe that is not parked (probe 0 if all are), and its (u, v)
// gives v and u0 = u + c (mod W). All 32 lanes of the warp must call it.
// lat, s: the lat_long_grid vectors ([H], [W]).
__device__ __forceinline__ RowParam sweep_row_param(
    float d, int i, float r, int order, const float* __restrict__ lat,
    const float* __restrict__ lon, int H, int W) {
  const int lane = threadIdx.x & 31;
  const int k = lane & 15;
  const int half = lane & 16;
  const PixelAffine m = pixel_affine(W, H);
  const float t = lat[i];
  const float cos_t = cosf(t);
  const int col = probe_column(k, W);
  const float sc = lon[col];
  const float x = fmul(d, fmul(cosf(sc), cos_t));
  const float y = fmul(d, sinf(t));
  const float z = fmul(d, fmul(sinf(sc), cos_t));
  float uc, vc;
  project_ods(x, y, z, r, order, m, uc, vc);
  const bool parked = uc == 1.f && vc == 1.f;
  const unsigned ball = __ballot_sync(0xffffffffu, !parked);
  const unsigned mine = (ball >> half) & 0xffffu;
  const int pick = half + (mine ? __ffs(mine) - 1 : 0);
  const float u0c = fremainder(fadd(uc, (float)col), (float)W);
  const float u0 = __shfl_sync(0xffffffffu, u0c, pick);
  const float v = __shfl_sync(0xffffffffu, vc, pick);
  RowParam rp;
  rp.valid = fmul(d, cos_t) >= r;
  const float y0f = floorf(v);
  const float x0f = floorf(u0);
  rp.y0 = wrap((int)y0f, H);
  rp.y1 = wrap(rp.y0 + 1, H);
  rp.fy = fsub(v, y0f);
  rp.x0 = wrap((int)x0f, W);
  rp.fx = fsub(u0, x0f);
  return rp;
}

// What a target pixel's ray needs for every shell
// (intersect_sphere_uv): the ray direction rotated by the target pose,
// the target centre in the MSI frame, and the shell-independent terms of
// the intersection quadratic a t^2 + b t + c = 0 (b^2, 4a, 1/(2a)).
struct Ray {
  float rx, ry, rz, cx, cy, cz, b, bb, a4, inv_2a, cc;
};

// The target views of a render launch: pose [B, 4, 4] (row major, batch
// stride pose_stride floats, 0 for one pose shared), pos [B, 3] (stride
// pos_stride), the shell radii [P] and lat [H], lon [W] (lat_long_grid's
// vectors).
struct Geo {
  const float* pose;
  const float* pos;
  const float* radii;
  const float* lat;
  const float* lon;
  long long pose_stride, pos_stride;
  int B, P, H, W;
};

inline Geo make_geo(const void* pose, long long pose_stride, const void* pos,
                    long long pos_stride, const void* radii, const void* lat,
                    const void* lon, int B, int P, int H, int W) {
  return Geo{(const float*)pose, (const float*)pos, (const float*)radii,
             (const float*)lat,  (const float*)lon, pose_stride,
             pos_stride,         B,                 P,
             H,                  W};
}

// pose: the 4x4 target pose (row major); pos: the target position (rig
// frame, swizzled (z, y, x) into the MSI frame); lat, lon: the pixel's
// grid angles.
__device__ __forceinline__ Ray target_ray(const float* __restrict__ pose,
                                          const float* __restrict__ pos,
                                          float lat, float lon) {
  const float cos_t = cosf(lat);
  const float d0 = fmul(cosf(lon), cos_t);
  const float d1 = sinf(lat);
  const float d2 = fmul(sinf(lon), cos_t);
  Ray q;
  q.rx = fadd(fadd(fmul(pose[0], d0), fmul(pose[1], d1)), fmul(pose[2], d2));
  q.ry = fadd(fadd(fmul(pose[4], d0), fmul(pose[5], d1)), fmul(pose[6], d2));
  q.rz = fadd(fadd(fmul(pose[8], d0), fmul(pose[9], d1)),
              fmul(pose[10], d2));
  const float c0 = pos[2], c1 = pos[1], c2 = pos[0];
  q.cx = fadd(fadd(fadd(fmul(pose[0], c0), fmul(pose[1], c1)),
                   fmul(pose[2], c2)), pose[3]);
  q.cy = fadd(fadd(fadd(fmul(pose[4], c0), fmul(pose[5], c1)),
                   fmul(pose[6], c2)), pose[7]);
  q.cz = fadd(fadd(fadd(fmul(pose[8], c0), fmul(pose[9], c1)),
                   fmul(pose[10], c2)), pose[11]);
  const float a =
      fadd(fadd(fmul(q.rx, q.rx), fmul(q.ry, q.ry)), fmul(q.rz, q.rz));
  q.b = fmul(2.f, fadd(fadd(fmul(q.rx, q.cx), fmul(q.ry, q.cy)),
                       fmul(q.rz, q.cz)));
  q.bb = fmul(q.b, q.b);
  q.a4 = fmul(4.f, a);
  q.inv_2a = fdiv(1.f, fmul(2.f, a));
  q.cc = fadd(fadd(fmul(q.cx, q.cx), fmul(q.cy, q.cy)), fmul(q.cz, q.cz));
  return q;
}

// The ray's forward intersection with the shell of radius `radius`, as
// an MSI pixel (u, v) (sphere_intersections, then the ERP angles). Per
// (pixel, shell) the hot path of the render: the shell-independent terms
// come from target_ray, FMAs are explicit (__fmaf_rn), and the one
// division is the ray's 1/(2a).
__device__ __forceinline__ void shell_uv(const Ray& q, float radius,
                                         const PixelAffine& m, float& u,
                                         float& v) {
  const float c = fsub(q.cc, fmul(radius, radius));
  const float disc = __fmaf_rn(-q.a4, c, q.bb);
  const float t = fmul(fadd(-q.b, sqrtf(clamp0(disc))), q.inv_2a);
  const float x = __fmaf_rn(t, q.rx, q.cx);
  const float y = __fmaf_rn(t, q.ry, q.cy);
  const float z = __fmaf_rn(t, q.rz, q.cz);
  const float theta = -atan2f(z, x);
  const float phi = atan2f(y, sqrtf(__fmaf_rn(x, x, fmul(z, z))));
  to_pixels(theta, phi, m, u, v);
}

}  // namespace matry
