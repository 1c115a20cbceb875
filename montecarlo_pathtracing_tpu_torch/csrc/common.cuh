// Device code shared by K1 (megakernel.cu), K2 (bounce_kernel.cu) and the
// trace kernels K3a, K3b, K4a, K4b, K5 and K6 (trace_kernels.cu).
//
// The JAX package shares the same pieces between its kernels:
// montecarlo_pathtracing_tpu/models/bounce_kernel.py imports _trace_fold
// and _bounce_step from megakernel.py, and every kernel uses the shape
// tests of ops/pallas_trace.py. Here they are: the vec3 helpers, the
// xxhash32 RNG and random_ray, the five analytic shape tests, their masked
// forms (K3a, K3b, K5's tile walk, K1) and the shading-normal point,
// Moller-Trumbore (mt_hit), the slab test, the closest-hit fold over a
// [38, P] prim table (prim_work, fold_group, trace_fold: K2's; K1 folds
// its own staged records) and one bounce of tp/montecarlo.frag:109-176
// (bounce_step), a template over the trace function so that each kernel
// brings its own closest-hit search.
//
// Floating point is IEEE (sqrtf, logf, sinf, cosf, powf, true division;
// no --use_fast_math): the shape tests divide by zero on purpose and mask
// the inf/nan afterwards, as the reference does. FMA contraction is on in
// K1 and K2, off in the trace kernels (kernels.EXTRA_FLAGS).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace pt {

constexpr int SUPER = 16;  // prims per super box of the prim table
constexpr float FMAX = 3.402823e38f;
constexpr float EPS = 1e-10f;
constexpr float BIAS = 1e-2f;
constexpr float PI_F = 3.14159265358979323846f;
constexpr float TINY = 1e-30f;

enum Shape { SPHERE = 1, CUBE = 2, CYLINDER = 3, CONE = 4, QUAD = 5 };

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 neg(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
// v / |v|, the length clamped below by eps when eps > 0
__device__ __forceinline__ V3 vnorm(V3 v, float eps = 0.0f) {
  float n = sqrtf(v.x * v.x + v.y * v.y + v.z * v.z);
  if (eps > 0.0f) n = fmaxf(n, eps);
  return {v.x / n, v.y / n, v.z / n};
}
__device__ __forceinline__ V3 reflect(V3 i, V3 n) {
  float d2 = 2.0f * dot(n, i);
  return {i.x - d2 * n.x, i.y - d2 * n.y, i.z - d2 * n.z};
}
// GLSL built-in refract: vec3(0) on total internal reflection
__device__ __forceinline__ V3 refract_glsl(V3 i, V3 n, float eta) {
  float ndi = dot(n, i);
  float k = 1.0f - eta * eta * (1.0f - ndi * ndi);
  if (k < 0.0f) return {0.0f, 0.0f, 0.0f};
  float c = eta * ndi + sqrtf(k);
  return {eta * i.x - c * n.x, eta * i.y - c * n.y, eta * i.z - c * n.z};
}

// 1/x with exact zeros clamped to a huge finite value (no inf*0 in slabs)
__device__ __forceinline__ float safe_rcp(float x) {
  return (x < 0.0f ? -1.0f : 1.0f) / fmaxf(fabsf(x), TINY);
}

__device__ __forceinline__ float ld(const float* base, int row, int stride, int col) {
  return __ldg(base + row * stride + col);
}

// m (12 floats, a 3x4 matrix row by row) applied to a point / a direction
__device__ __forceinline__ V3 affine(const float* m, V3 p) {
  return {m[0] * p.x + m[1] * p.y + m[2] * p.z + m[3], m[4] * p.x + m[5] * p.y + m[6] * p.z + m[7],
          m[8] * p.x + m[9] * p.y + m[10] * p.z + m[11]};
}
__device__ __forceinline__ V3 linear(const float* m, V3 p) {
  return {m[0] * p.x + m[1] * p.y + m[2] * p.z, m[4] * p.x + m[5] * p.y + m[6] * p.z,
          m[8] * p.x + m[9] * p.y + m[10] * p.z};
}

// ---------------------------------------------------------------------------
// xxhash32 RNG, bit-identical to ops/rng.py (raytracer_func.frag:90-124)
// ---------------------------------------------------------------------------

struct Rng {
  uint32_t s0, s1, s2;
};

__device__ __forceinline__ uint32_t rotl17(uint32_t h) { return (h << 17) | (h >> 15); }

__device__ __forceinline__ uint32_t xxhash32(uint32_t s0, uint32_t s1, uint32_t s2) {
  uint32_t h = s2 + 374761393u + s0 * 3266489917u;
  h = 668265263u * rotl17(h);
  h = h + s1 * 3266489917u;
  h = 668265263u * rotl17(h);
  h = 2246822519u * (h ^ (h >> 15));
  h = 3266489917u * (h ^ (h >> 13));
  return h ^ (h >> 16);
}

// one draw; the counter advances only where the lane takes the draw
__device__ __forceinline__ float draw(Rng& st, bool mask) {
  uint32_t m = xxhash32(st.s0, st.s1, st.s2);
  m = (m & 0x007FFFFFu) | 0x3F800000u;
  if (mask) {
    st.s0 += 11u;
    st.s1 += 43u;
    st.s2 += 67u;
  }
  return __uint_as_float(m) - 1.0f;
}

// v / |v| with the approximate rsqrtf (K1's FAST shading)
__device__ __forceinline__ V3 vnorm_fast(V3 v) {
  const float r = rsqrtf(v.x * v.x + v.y * v.y + v.z * v.z);
  return {v.x * r, v.y * r, v.z * r};
}

// random_ray (tp/montecarlo.frag:49-89): ONB about d + Beckmann-ish lobe;
// exactly 2 draws. FAST (K1 only) takes the approximate intrinsics:
// rsqrtf for the normalisations, __logf, __sincosf.
template <bool FAST = false>
__device__ V3 random_ray(Rng& st, V3 d, float roughness, bool mask) {
  if constexpr (FAST) {
    const V3 w = vnorm_fast({d.x, d.y + 5.0f, d.z + 3.0f});
    const V3 u = vnorm_fast(cross(d, w));
    const V3 v = vnorm_fast(cross(d, u));
    const float alpha = roughness * roughness;
    const float u1 = draw(st, mask);
    const float beta = (2.0f * PI_F) * u1;
    const float u2 = draw(st, mask);
    const float tan_theta2 = -(alpha * alpha) * __logf(1.0f - u2);
    const float cos_theta = rsqrtf(1.0f + tan_theta2);
    const float sin_theta = sqrtf(fmaxf(0.0f, 1.0f - cos_theta * cos_theta));
    float sb, cb;
    __sincosf(beta, &sb, &cb);
    const V3 l = vnorm_fast({cb * sin_theta, sb * sin_theta, cos_theta});
    return vnorm_fast({u.x * l.x + v.x * l.y + d.x * l.z, u.y * l.x + v.y * l.y + d.y * l.z,
                       u.z * l.x + v.z * l.y + d.z * l.z});
  }
  V3 w = vnorm({d.x, d.y + 5.0f, d.z + 3.0f});
  V3 u = vnorm(cross(d, w));
  V3 v = vnorm(cross(d, u));
  float alpha = roughness * roughness;
  float u1 = draw(st, mask);
  float beta = (2.0f * PI_F) * u1;
  float u2 = draw(st, mask);
  float tan_theta2 = -(alpha * alpha) * logf(1.0f - u2);
  float cos_theta = 1.0f / sqrtf(1.0f + tan_theta2);
  float sin_theta = sqrtf(fmaxf(0.0f, 1.0f - cos_theta * cos_theta));
  float lx = cosf(beta) * sin_theta;
  float ly = sinf(beta) * sin_theta;
  float lz = cos_theta;
  float ln = sqrtf(lx * lx + ly * ly + lz * lz);
  lx = lx / ln;
  ly = ly / ln;
  lz = lz / ln;
  return vnorm({u.x * lx + v.x * ly + d.x * lz, u.y * lx + v.y * ly + d.y * lz,
                u.z * lx + v.z * ly + d.z * lz});
}

// ---------------------------------------------------------------------------
// shape tests in the prim's local frame (ops/shapes.py): set a (local ray
// parameter of the nearest valid hit) and code (face / part); return valid
// ---------------------------------------------------------------------------

__device__ __forceinline__ bool sphere_test(V3 o, V3 d, float& a, int& code) {
  float OO = o.x * o.x + o.y * o.y + o.z * o.z;
  float OD = o.x * d.x + o.y * d.y + o.z * d.z;
  float D2 = d.x * d.x + d.y * d.y + d.z * d.z;
  float delta4 = OD * OD - D2 * (OO - 1.0f);
  float sq = sqrtf(fmaxf(delta4, 0.0f));
  float a1 = -(OD + sq) / D2;
  float a2 = -(OD - sq) / D2;
  bool ok = delta4 > 0.0f;
  bool v1 = ok && (a1 > EPS);
  bool v2 = ok && (a2 > EPS);
  a = v1 ? a1 : (v2 ? a2 : FMAX);
  code = 0;
  return v1 || v2;
}

__device__ __forceinline__ bool quad_test(V3 o, V3 d, float& a, int& code) {
  bool facing = d.z <= -EPS;
  float t = -o.z / d.z;
  float px = o.x + t * d.x;
  float py = o.y + t * d.y;
  bool valid = facing && (fabsf(px) <= 1.0f) && (fabsf(py) <= 1.0f);
  a = valid ? t : FMAX;
  code = 0;
  return valid;
}

__device__ __forceinline__ bool cube_test(V3 o3, V3 d3, float& a, int& code) {
  const float o[3] = {o3.x, o3.y, o3.z};
  const float d[3] = {d3.x, d3.y, d3.z};
  float al = FMAX;
  int face = 0;
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    const int c0 = c / 2, c1 = (c0 + 1) % 3, c2 = (c0 + 2) % 3;
    const float cd = -1.0f + 2.0f * (c % 2);
    float t = (cd - o[c0]) / d[c0];
    bool v = (fabsf(d[c0]) > EPS) && (t > EPS) && (fabsf(o[c1] + t * d[c1]) <= 1.0f) &&
             (fabsf(o[c2] + t * d[c2]) <= 1.0f) && (t < al);
    if (v) {
      al = t;
      face = c;
    }
  }
  a = al;
  code = face;
  return al < FMAX;
}

__device__ __forceinline__ bool cylinder_test(V3 o, V3 d, float& a, int& code) {
  float al = FMAX;
  int cl = -1;
  bool dz_ok = fabsf(d.z) > EPS;
#pragma unroll
  for (int cap = 0; cap < 2; ++cap) {
    float zplane = cap ? 1.0f : -1.0f;
    float t = (zplane - o.z) / d.z;
    float rx = o.x + t * d.x;
    float ry = o.y + t * d.y;
    if (dz_ok && (t > EPS) && (rx * rx + ry * ry < 1.0f) && (t < al)) {
      al = t;
      cl = cap;
    }
  }
  float O2 = o.x * o.x + o.y * o.y;
  float OD = o.x * d.x + o.y * d.y;
  float D2 = d.x * d.x + d.y * d.y;
  float delta4 = OD * OD - D2 * (O2 - 1.0f);
  float t = -(OD + sqrtf(fmaxf(delta4, 0.0f))) / D2;
  float z = o.z + t * d.z;
  if ((delta4 > 0.0f) && (t > EPS) && (t < al) && (fabsf(z) < 1.0f)) {
    al = t;
    cl = 2;
  }
  a = al;
  code = cl;
  return al < FMAX;
}

__device__ __forceinline__ bool cone_test(V3 o, V3 d, float& a, int& code) {
  float tl = FMAX;
  int cl = -1;
  float t0 = (-1.0f - o.z) / d.z;
  float rx = o.x + t0 * d.x;
  float ry = o.y + t0 * d.y;
  if ((fabsf(d.z) > EPS) && (t0 > EPS) && (rx * rx + ry * ry < 1.0f) && (t0 < tl)) {
    tl = t0;
    cl = 0;
  }
  const float k = 0.8f;  // cos^2 of the cone's half-angle
  float coz = o.z - 1.0f;
  float dco = d.x * o.x + d.y * o.y + d.z * coz;
  float coco = o.x * o.x + o.y * o.y + coz * coz;
  float a_ = d.z * d.z - k;
  float b_ = 2.0f * (d.z * coz - dco * k);
  float c_ = coz * coz - coco * k;
  float det = b_ * b_ - 4.0f * a_ * c_;
  float sq = sqrtf(fmaxf(det, 0.0f));
  float t1 = (-b_ - sq) / (2.0f * a_);
  float t2 = (-b_ + sq) / (2.0f * a_);
  if (fabsf(o.z + t1 * d.z) > 1.0f) t1 = FMAX;
  if (fabsf(o.z + t2 * d.z) > 1.0f) t2 = FMAX;
  // the reference's minimum propagates nan, which then fails `t < tl`
  bool nan = isnan(t1) || isnan(t2);
  float t = fminf(t1, t2);
  if (!nan && (det > 0.0f) && (t < tl)) {
    tl = t;
    cl = 2;
  }
  a = tl;
  code = cl;
  return tl < FMAX;
}

// Moller-Trumbore of triangle (A, B, C) against the ray oi + a di (the
// reference's _tri_kernel and _mt_rows): set a and return true where the
// triangle is hit at a > EPS
__device__ __forceinline__ bool mt_hit(V3 A, V3 B, V3 C, V3 oi, V3 di, float& a) {
  const V3 e1 = sub(B, A);
  const V3 e2 = sub(C, A);
  const float hx = di.y * e2.z - di.z * e2.y;
  const float hy = di.z * e2.x - di.x * e2.z;
  const float hz = di.x * e2.y - di.y * e2.x;
  const float det = e1.x * hx + e1.y * hy + e1.z * hz;
  if (!(fabsf(det) >= EPS)) return false;
  const float invd = 1.0f / det;
  const V3 s = sub(oi, A);
  const float u = (s.x * hx + s.y * hy + s.z * hz) * invd;
  const float qx = s.y * e1.z - s.z * e1.y;
  const float qy = s.z * e1.x - s.x * e1.z;
  const float qz = s.x * e1.y - s.y * e1.x;
  const float v = (di.x * qx + di.y * qy + di.z * qz) * invd;
  a = (e2.x * qx + e2.y * qy + e2.z * qz) * invd;
  return (u >= 0.0f) && (u <= 1.0f) && (v >= 0.0f) && (u + v <= 1.0f) && (a > EPS);
}

template <int SHAPE>
__device__ __forceinline__ bool shape_test(V3 o, V3 d, float& a, int& code) {
  if (SHAPE == SPHERE) return sphere_test(o, d, a, code);
  if (SHAPE == CUBE) return cube_test(o, d, a, code);
  if (SHAPE == CYLINDER) return cylinder_test(o, d, a, code);
  if (SHAPE == CONE) return cone_test(o, d, a, code);
  return quad_test(o, d, a, code);
}

// x / y: IEEE, or with FAST the approximate __fdividef (2 ulp; K1 only)
template <bool FAST>
__device__ __forceinline__ float fdiv(float x, float y) {
  if constexpr (FAST) {
    return __fdividef(x, y);
  } else {
    return x / y;
  }
}

// ---------------------------------------------------------------------------
// the masked shape tests (K3a, K3b, K5's tile walk and K1): the tests above,
// term for term, in select form, with each square root and division whose
// result the test would mask given an argument of 1 instead. The masked
// lanes then skip the IEEE square root's and division's slow paths (a zero
// or an infinite argument), and every value the test keeps is the same
// float as the tests above give.
// ---------------------------------------------------------------------------

template <bool FAST = false>
__device__ __forceinline__ bool g_sphere(V3 o, V3 d, float& a, int& code) {
  const float OO = o.x * o.x + o.y * o.y + o.z * o.z;
  const float OD = o.x * d.x + o.y * d.y + o.z * d.z;
  const float D2 = d.x * d.x + d.y * d.y + d.z * d.z;
  const float delta4 = OD * OD - D2 * (OO - 1.0f);
  const bool ok = delta4 > 0.0f;
  const float sq = sqrtf(ok ? delta4 : 1.0f);
  const float den = ok ? D2 : 1.0f;
  const float a1 = fdiv<FAST>(-(OD + sq), den);
  const float a2 = fdiv<FAST>(-(OD - sq), den);
  const bool v1 = ok && (a1 > EPS);
  const bool v2 = ok && (a2 > EPS);
  a = v1 ? a1 : (v2 ? a2 : FMAX);
  code = 0;
  return v1 || v2;
}

template <bool FAST = false>
__device__ __forceinline__ bool g_quad(V3 o, V3 d, float& a, int& code) {
  const bool facing = d.z <= -EPS;
  const float t = fdiv<FAST>(-o.z, facing ? d.z : -1.0f);
  const float px = o.x + t * d.x;
  const float py = o.y + t * d.y;
  const bool valid = facing && (fabsf(px) <= 1.0f) && (fabsf(py) <= 1.0f);
  a = valid ? t : FMAX;
  code = 0;
  return valid;
}

template <bool FAST = false>
__device__ __forceinline__ bool g_cube(V3 o3, V3 d3, float& a, int& code) {
  const float o[3] = {o3.x, o3.y, o3.z};
  const float d[3] = {d3.x, d3.y, d3.z};
  float al = FMAX;
  int face = 0;
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    const int c0 = c / 2, c1 = (c0 + 1) % 3, c2 = (c0 + 2) % 3;
    const float cd = -1.0f + 2.0f * (c % 2);
    const bool dok = fabsf(d[c0]) > EPS;
    const float t = fdiv<FAST>(cd - o[c0], dok ? d[c0] : 1.0f);
    const bool v = dok && (t > EPS) && (fabsf(o[c1] + t * d[c1]) <= 1.0f) &&
                   (fabsf(o[c2] + t * d[c2]) <= 1.0f) && (t < al);
    al = v ? t : al;
    face = v ? c : face;
  }
  a = al;
  code = face;
  return al < FMAX;
}

template <bool FAST = false>
__device__ __forceinline__ bool g_cylinder(V3 o, V3 d, float& a, int& code) {
  float al = FMAX;
  int cl = -1;
  const bool dz_ok = fabsf(d.z) > EPS;
  const float dz = dz_ok ? d.z : 1.0f;
#pragma unroll
  for (int cap = 0; cap < 2; ++cap) {
    const float zplane = cap ? 1.0f : -1.0f;
    const float t = fdiv<FAST>(zplane - o.z, dz);
    const float rx = o.x + t * d.x;
    const float ry = o.y + t * d.y;
    const bool v = dz_ok && (t > EPS) && (rx * rx + ry * ry < 1.0f) && (t < al);
    al = v ? t : al;
    cl = v ? cap : cl;
  }
  const float O2 = o.x * o.x + o.y * o.y;
  const float OD = o.x * d.x + o.y * d.y;
  const float D2 = d.x * d.x + d.y * d.y;
  const float delta4 = OD * OD - D2 * (O2 - 1.0f);
  const bool ok = delta4 > 0.0f;
  const float t = fdiv<FAST>(-(OD + sqrtf(ok ? delta4 : 1.0f)), ok ? D2 : 1.0f);
  const float z = o.z + t * d.z;
  const bool v = ok && (t > EPS) && (t < al) && (fabsf(z) < 1.0f);
  a = v ? t : al;
  code = v ? 2 : cl;
  return a < FMAX;
}

template <bool FAST = false>
__device__ __forceinline__ bool g_cone(V3 o, V3 d, float& a, int& code) {
  const bool dz_ok = fabsf(d.z) > EPS;
  const float t0 = fdiv<FAST>(-1.0f - o.z, dz_ok ? d.z : 1.0f);
  const float rx = o.x + t0 * d.x;
  const float ry = o.y + t0 * d.y;
  const bool v0 = dz_ok && (t0 > EPS) && (rx * rx + ry * ry < 1.0f) && (t0 < FMAX);
  float tl = v0 ? t0 : FMAX;
  int cl = v0 ? 0 : -1;
  const float k = 0.8f;  // cos^2 of the cone's half-angle
  const float coz = o.z - 1.0f;
  const float dco = d.x * o.x + d.y * o.y + d.z * coz;
  const float coco = o.x * o.x + o.y * o.y + coz * coz;
  const float a_ = d.z * d.z - k;
  const float b_ = 2.0f * (d.z * coz - dco * k);
  const float c_ = coz * coz - coco * k;
  const float det = b_ * b_ - 4.0f * a_ * c_;
  const bool ok = det > 0.0f;
  const float sq = sqrtf(ok ? det : 1.0f);
  float t1 = fdiv<FAST>(-b_ - sq, 2.0f * a_);
  float t2 = fdiv<FAST>(-b_ + sq, 2.0f * a_);
  t1 = fabsf(o.z + t1 * d.z) > 1.0f ? FMAX : t1;
  t2 = fabsf(o.z + t2 * d.z) > 1.0f ? FMAX : t2;
  // the reference's minimum propagates nan, which then fails `t < tl`
  const bool nan = isnan(t1) || isnan(t2);
  const float t = fminf(t1, t2);
  const bool v = !nan && ok && (t < tl);
  a = v ? t : tl;
  code = v ? 2 : cl;
  return a < FMAX;
}

template <int SHAPE, bool FAST = false>
__device__ __forceinline__ bool group_shape(V3 o, V3 d, float& a, int& code) {
  if (SHAPE == SPHERE) return g_sphere<FAST>(o, d, a, code);
  if (SHAPE == CUBE) return g_cube<FAST>(o, d, a, code);
  if (SHAPE == CYLINDER) return g_cylinder<FAST>(o, d, a, code);
  if (SHAPE == CONE) return g_cone<FAST>(o, d, a, code);
  return g_quad<FAST>(o, d, a, code);
}

// vnorm(v, TINY) with the square root given 1 where |v|^2 is 0 (its slow
// path): the same floats; with FAST, v times the approximate rsqrtf of
// |v|^2 (2 ulp; K1 only)
template <bool FAST = false>
__device__ __forceinline__ V3 vnorm_masked(V3 v) {
  const float l2 = v.x * v.x + v.y * v.y + v.z * v.z;
  const bool ok = l2 > 0.0f;
  if constexpr (FAST) {
    const float r = ok ? rsqrtf(l2) : 1.0f / TINY;
    return {v.x * r, v.y * r, v.z * r};
  } else {
    const float n = ok ? fmaxf(sqrtf(ok ? l2 : 1.0f), TINY) : TINY;
    return {v.x / n, v.y / n, v.z / n};
  }
}

// unnormalized shading-normal point in the local frame (intersection_info,
// raytracer_func.frag:783-897)
template <int SHAPE>
__device__ __forceinline__ V3 normal_point(V3 pl, int code) {
  if (SHAPE == SPHERE) return {2.0f * pl.x, 2.0f * pl.y, 2.0f * pl.z};
  if (SHAPE == CUBE) {
    int ax = code / 2;
    float sg = (code % 2 != 0) ? 1.0f : -1.0f;
    return {pl.x + (ax == 0 ? sg : 0.0f), pl.y + (ax == 1 ? sg : 0.0f),
            pl.z + (ax == 2 ? sg : 0.0f)};
  }
  if (SHAPE == CYLINDER) {
    bool cap = code < 2;
    float zsg = (code % 2 != 0) ? 1.0f : -1.0f;
    return {pl.x + (cap ? 0.0f : pl.x), pl.y + (cap ? 0.0f : pl.y), pl.z + (cap ? zsg : 0.0f)};
  }
  if (SHAPE == CONE) {
    float rxy = sqrtf(pl.x * pl.x + pl.y * pl.y);
    bool bot = code == 0;
    return {pl.x + (bot ? 0.0f : pl.x), pl.y + (bot ? 0.0f : pl.y),
            pl.z + (bot ? -1.0f : rxy / 2.0f)};
  }
  return {pl.x, pl.y, pl.z + 1.0f};
}

// ---------------------------------------------------------------------------
// the closest-hit fold over a [38, P] prim table
// ---------------------------------------------------------------------------

// running winner: world distance and the attributes shading needs
struct Win {
  float bd;
  V3 n, p;
  float shin, rough, emis;
  float r, g, b, a;
};

// a [38, P] prim table with its group descriptor and, for the cull, its
// 16-prim super boxes
struct Table {
  const float* tab;   // [38,P]: 12 inverse rows, 12 forward rows, shin, rough,
                      // emis, rgba, ok flag, world AABB min xyz, max xyz
  const float* sbb;   // [6,S] super boxes (cull only)
  const int* groups;  // [G,4] (shape code, start, count, super start)
  int P, S, G;
};

// the slab interval of box column `col` (rows min x,y,z, max x,y,z at
// `stride`) for the ray o + t d, rd = 1/d: the line is inside the box for
// t in [tmin, tmax], empty when tmax < tmin
__device__ __forceinline__ void slab_interval(const float* box, int stride, int col, V3 o, V3 rd,
                                              float& tmin, float& tmax) {
  float t0x = (ld(box, 0, stride, col) - o.x) * rd.x;
  float t1x = (ld(box, 3, stride, col) - o.x) * rd.x;
  float t0y = (ld(box, 1, stride, col) - o.y) * rd.y;
  float t1y = (ld(box, 4, stride, col) - o.y) * rd.y;
  float t0z = (ld(box, 2, stride, col) - o.z) * rd.z;
  float t1z = (ld(box, 5, stride, col) - o.z) * rd.z;
  tmin = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  tmax = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
}

// slab test of box column `col` against a per-ray cap, with the entry
// clamped at 0 (the reference's _slab_rows, and the chunk gates of its
// culled trace kernels, pallas_trace.py:280-292)
__device__ __forceinline__ bool slab_cap(const float* box, int stride, int col, V3 o, V3 rd,
                                         float cap) {
  float tmin, tmax;
  slab_interval(box, stride, col, o, rd, tmin, tmax);
  tmin = fmaxf(tmin, 0.0f);
  return (tmax >= tmin) && (tmin <= cap);
}

// slab test of box column `col` against the ray's running best world
// distance: the nearest distance from the origin to the box along the ray
// (along the whole line when BEHIND: quads and cones accept hits behind
// the origin), the slab parameter scaled by |d| (dl) because some rays are
// not unit
template <bool BEHIND>
__device__ __forceinline__ bool slab(const float* box, int stride, int col, V3 o, V3 rd,
                                     float dl, float best) {
  float tmin, tmax;
  slab_interval(box, stride, col, o, rd, tmin, tmax);
  if (BEHIND) return (tmax >= tmin) && (fmaxf(fmaxf(tmin, -tmax), 0.0f) * dl <= best);
  tmin = fmaxf(tmin, 0.0f);
  return (tmax >= tmin) && (tmin * dl <= best);
}

// test prim column c and fold it into w under the strictly-closer rule
template <int SHAPE>
__device__ __forceinline__ void prim_work(const float* __restrict__ tab, int P, int c, V3 o, V3 d,
                                          Win& w) {
  float iv[12];
#pragma unroll
  for (int r = 0; r < 12; ++r) iv[r] = ld(tab, r, P, c);
  V3 oi = affine(iv, o);
  V3 di = vnorm(linear(iv, d), TINY);
  float a;
  int code;
  if (!shape_test<SHAPE>(oi, di, a, code)) return;  // dist would be FMAX
  float tf[12];
#pragma unroll
  for (int r = 0; r < 12; ++r) tf[r] = ld(tab, 12 + r, P, c);
  V3 pl = {oi.x + a * di.x, oi.y + a * di.y, oi.z + a * di.z};
  V3 pg = affine(tf, pl);
  V3 e = sub(o, pg);
  float dist = sqrtf(e.x * e.x + e.y * e.y + e.z * e.z);
  if (!(dist < w.bd)) return;
  V3 q = normal_point<SHAPE>(pl, code);
  V3 tp = sub(affine(tf, q), pg);
  V3 nv = vnorm(tp, TINY);
  // cone top-"cap" quirk: N = 0 (raytracer_func.frag:850-853)
  if (SHAPE == CONE && code == 1) nv = {0.0f, 0.0f, 0.0f};
  w.bd = dist;
  w.n = nv;
  w.p = pg;
  w.shin = ld(tab, 24, P, c);
  w.rough = ld(tab, 25, P, c);
  w.emis = ld(tab, 26, P, c);
  w.r = ld(tab, 27, P, c);
  w.g = ld(tab, 28, P, c);
  w.b = ld(tab, 29, P, c);
  w.a = ld(tab, 30, P, c);
}

template <int SHAPE, bool CULL>
__device__ void fold_group(const Table& t, const int* ordr_row, int start, int count, int sstart,
                           V3 o, V3 d, V3 rd, float dl, Win& w) {
  const float* tab = t.tab;
  const int P = t.P;
  if (!CULL) {
    for (int c = start; c < start + count; ++c) {
      if (!(ld(tab, 31, P, c) > 0.0f)) continue;  // group padding never hits
      prim_work<SHAPE>(tab, P, c, o, d, w);
    }
    return;
  }
  // two-level frontier: a super box gates its prims' box tests; supers in
  // the tile's nearest-first order so the running best tightens early
  constexpr bool BEHIND = SHAPE == QUAD || SHAPE == CONE;
  const int nsup = (count + SUPER - 1) / SUPER;
  for (int spi = 0; spi < nsup; ++spi) {
    int sp = __ldg(ordr_row + sstart + spi);
    if (!slab<BEHIND>(t.sbb, t.S, sstart + sp, o, rd, dl, w.bd)) continue;
    for (int j = 0; j < SUPER; ++j) {
      // the clamp re-tests the group's last prim; an equal candidate never
      // replaces the winner
      int c = start + min(sp * SUPER + j, count - 1);
      if (!(ld(tab, 31, P, c) > 0.0f)) continue;
      if (!slab<BEHIND>(tab + 32 * P, P, c, o, rd, dl, w.bd)) continue;
      prim_work<SHAPE>(tab, P, c, o, d, w);
    }
  }
}

// closest hit over every group of the table; on a miss N, P keep (n_prev,
// p_prev) — the GLSL stale-output semantics the refraction re-trace relies
// on. With CULL, ordr_row is the ray's row of the super visit order.
template <bool CULL>
__device__ void trace_fold(const Table& t, const int* ordr_row, V3 o, V3 d, V3 n_prev,
                           V3 p_prev, Win& w) {
  w.bd = FMAX;
  w.n = n_prev;
  w.p = p_prev;
  w.shin = w.rough = w.emis = 0.0f;
  w.r = w.g = w.b = 0.0f;
  w.a = 1.0f;
  V3 rd = {0.0f, 0.0f, 0.0f};
  float dl = 0.0f;
  if (CULL) {
    rd = {safe_rcp(d.x), safe_rcp(d.y), safe_rcp(d.z)};
    dl = sqrtf(dot(d, d));
  }
  for (int g = 0; g < t.G; ++g) {
    const int code = __ldg(t.groups + 4 * g);
    const int start = __ldg(t.groups + 4 * g + 1);
    const int count = __ldg(t.groups + 4 * g + 2);
    const int sstart = __ldg(t.groups + 4 * g + 3);
    switch (code) {  // uniform: every thread reads the same descriptor
      case SPHERE:
        fold_group<SPHERE, CULL>(t, ordr_row, start, count, sstart, o, d, rd, dl, w);
        break;
      case CUBE:
        fold_group<CUBE, CULL>(t, ordr_row, start, count, sstart, o, d, rd, dl, w);
        break;
      case CYLINDER:
        fold_group<CYLINDER, CULL>(t, ordr_row, start, count, sstart, o, d, rd, dl, w);
        break;
      case CONE:
        fold_group<CONE, CULL>(t, ordr_row, start, count, sstart, o, d, rd, dl, w);
        break;
      default:
        fold_group<QUAD, CULL>(t, ordr_row, start, count, sstart, o, d, rd, dl, w);
        break;
    }
  }
}

// ---------------------------------------------------------------------------
// one bounce: tp/montecarlo.frag:109-176, per ray
// ---------------------------------------------------------------------------

// a path in flight: position, direction, throughput, radiance so far, the
// result once finished, and the RNG counters
struct Path {
  V3 o, d, att, total, result;
  bool done;
  Rng st;
};

// One bounce of a live path. trace(o, d, n_prev, p_prev, w) fills the
// winner w of the closest-hit search; it is called a second time for the
// refraction march-through on transparent scenes. A path that misses or
// hits an emitter finishes here (done = true). FAST (K1 only): random_ray's
// approximate intrinsics, rsqrtf for E and __powf for the Phong lobe.
template <bool TRANSPARENT, bool FAST = false, class Trace>
__device__ __forceinline__ void bounce_step(Trace& trace, float ior, Path& s) {
  const V3 unit_z = {0.0f, 0.0f, 1.0f};
  Win w;
  trace(s.o, s.d, unit_z, add(s.o, s.d), w);
  if (!(w.bd < FMAX)) {  // sky fallback (:117-119)
    float k = fmaxf(0.0f, s.d.z);
    V3 sky = {(1.0f - k) * 0.5f + k * 1.0f, (1.0f - k) * 0.5f + k * 1.0f,
              (1.0f - k) * 0.9f + k * 0.8f};
    s.result = {s.total.x + s.att.x * sky.x, s.total.y + s.att.y * sky.y,
                s.total.z + s.att.z * sky.z};
    s.done = true;
    return;
  }
  const V3 N = w.n, P = w.p;
  const float shin = w.shin, rough = w.rough, emis = w.emis, alpha = w.a;
  const V3 col = {w.r, w.g, w.b};
  const V3 d = s.d;
  V3 att = s.att;

  // draws 1-2: the diffuse sample, every hit lane (:127)
  V3 ray_d = random_ray<FAST>(s.st, N, 1.0f - rough, true);

  // Schlick from the IOR slider (:129)
  float r0 = (ior - 1.0f) / (ior + 1.0f);
  r0 = r0 * r0;
  float xs = 1.0f - dot(N, d);
  float x5 = xs * xs * xs * xs * xs;
  float rs = fminf(fmaxf(r0 + (1.0f - r0) * x5, 0.0f), 1.0f);

  V3 R = reflect(neg(ray_d), N);  // (:131)
  V3 E = FAST ? vnorm_masked<true>(sub(s.o, P)) : vnorm(sub(s.o, P), TINY);
  float se = (1.0f - rough) * 100.0f + rough * 2.0f;  // (:133)
  float spec = FAST ? __powf(fmaxf(0.0f, dot(E, R)), se) : powf(fmaxf(0.0f, dot(E, R)), se);

  // ambient leak + emissive gather (:136)
  float emit = emis * (1.0f - shin) * alpha;
  s.total = {s.total.x + col.x * 0.1f + att.x * emit, s.total.y + col.y * 0.1f + att.y * emit,
             s.total.z + col.z * 0.1f + att.z * emit};

  // emissive termination (:139,174-175)
  if (emis > 0.5f) {
    s.result = s.total;
    s.done = true;
    return;
  }

  const bool refl_case = (shin > 0.0f) && (alpha == 1.0f);
  const bool refr_case = (alpha < 1.0f) && (shin == 0.0f);
  const bool mixed_case = (alpha < 1.0f) && (shin > 0.0f);

  // draw 3: the mixed-case coin (:155); no draw, no counter advance
  // elsewhere
  const bool heads = mixed_case && (draw(s.st, true) > 0.5f);
  const bool choose_refl = refl_case || heads;
  const bool refr_lane = refr_case || (mixed_case && !heads);

  // draws 4-5: the reflect-branch sample (:143,158)
  V3 rray = unit_z;
  if (choose_refl) rray = random_ray<FAST>(s.st, reflect(d, N), 1.0f - shin * rough, true);

  // attenuation updates (:142,147,161,170); the re-trace below does not
  // change them, so they are done first and fewer values stay live across it
  V3 base = {col.x * att.x, col.y * att.y, col.z * att.z};
  V3 sm = {(1.0f - shin) * att.x + shin * col.x, (1.0f - shin) * att.y + shin * col.y,
           (1.0f - shin) * att.z + shin * col.z};
  float ks;
  if (refr_lane)
    ks = (1.0f - alpha) * (1.0f - rs) * spec;
  else if (choose_refl)
    ks = alpha * rs * spec;
  else
    ks = spec;
  s.att = {base.x + (att.x * ks) * sm.x, base.y + (att.y * ks) * sm.y,
           base.z + (att.z * ks) * sm.z};
  if (!refr_lane) {
    s.o = {P.x + BIAS * N.x, P.y + BIAS * N.y, P.z + BIAS * N.z};
    s.d = choose_refl ? rray : ray_d;
    return;
  }
  V3 N2 = N, P2 = P, d_exit = unit_z;
  if (TRANSPARENT) {
    // refraction march-through (:146-153); mixed keeps un-refracted D
    V3 d_in = refr_case ? refract_glsl(d, N, ior) : d;
    V3 o_in = {P.x - BIAS * N.x, P.y - BIAS * N.y, P.z - BIAS * N.z};
    Win w2;
    trace(o_in, d_in, N, P, w2);
    N2 = w2.n;
    P2 = w2.p;
    d_exit = refract_glsl(d_in, neg(N2), 1.0f / ior);
  }
  s.o = {P2.x + BIAS * N2.x, P2.y + BIAS * N2.y, P2.z + BIAS * N2.z};
  s.d = d_exit;
}

}  // namespace pt
