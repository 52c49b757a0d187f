// Device code shared by the frame kernels: megakernel.cu (K2, every
// hemisphere sampler, light-source sampling and NEE+MIS) and restir_di.cu
// (K3 and K4, the two ReSTIR DI stages).
//
//   * the counter-based PCG of core/rng.py, bit for bit;
//   * camera rays (core/camera.py::generate_rays), each step rounded once, and
//     the test entry fyp_camera_rays that writes them;
//   * the samplers and the Cook-Torrance BRDF of core/mathutils.py, in its
//     operation order;
//   * the light tree's importance descent and its bottom-up emitter pmf
//     (ops/lighttree.py);
//   * the surface record of a hit (ops/hit.py::hit_payload), and for the
//     textured kernels its albedo fetched from the atlas
//     (ops/texture.py::sample_bilinear, fetch_bilinear below).
//
// Vector products are uncontracted (traverse.cuh); scalar expressions may be
// FMA-contracted by nvcc, so a kernel and its plain PyTorch version differ
// by the rounding of those and of cos/sin/pow.
#pragma once

#include "traverse.cuh"

namespace fyp {

constexpr double kPiD = 3.1415926535;  // MathUtils.cuh:17
constexpr float kPi = static_cast<float>(kPiD);
constexpr float kInvPi = static_cast<float>(1.0 / kPiD);
constexpr float kTwoPi = static_cast<float>(2.0 * kPiD);
constexpr float kOriginEps = 1e-12f;  // integrators.py:49, a no-op at |p| ~ 1, kept
constexpr float kPClampLo = 1e-6f;
constexpr float kPClampHi = static_cast<float>(1.0 - 1e-6);
constexpr float kRandClamp = static_cast<float>(0.9999999);

struct Geo {
  const float* positions;  // (V, 3)
  const float* normals;    // (V, 3)
  const int* tri_v;        // (T, 3)
  const int* tri_mat;      // (T,)
  const float* uvs;        // (V, 2); read by the textured kernels only
};

struct Mats {
  const float* albedo;     // (M, 3)
  const float* roughness;  // (M,)
  const float* metallic;   // (M,)
  const float* emission;   // (M, 3) emission_color * emission_power
  const int* albedo_map;   // (M,) atlas page, -1 none; read by the textured kernels only
};

// The megakernels' texture levels (Scene.tex, ops/texture.py::make_kernel_tex): one float4 a
// texel (RGB and a zero, one 16-byte load), texel (y, x) of page k at
// (k * h + y) * w + x.  prim is the atlas's mip 0 box-filtered down to at most
// 256 a side, bounce its prefiltered bounce level (the TextureAtlas policy:
// primary hits read prim, hits after a scatter read bounce).
struct Tex {
  const float4* prim;    // (K, hp, wp)
  const float4* bounce;  // (K, hb, wb)
  int k, hp, wp, hb, wb;
};

struct LightTree {
  const float* energy;
  const float* axis;
  const float* cos_o;
  const float* sin_o;
  const float* cos_e;
  const float* sin_e;
  const float* box_lo;
  const float* box_hi;
  const int* left;
  const int* right;
  const int* tri;
  const int* parent;
  const int* leaf_of_tri;
  int max_depth;
};

// ---- counter-based PCG (core/rng.py) ----------------------------------------

__device__ __forceinline__ uint32_t pcg(uint32_t x) {
  uint32_t state = x * 747796405u + 2891336453u;
  uint32_t word = ((state >> ((state >> 28u) + 4u)) ^ state) * 277803737u;
  return (word >> 22u) ^ word;
}

__device__ __forceinline__ uint32_t fold(uint32_t key, uint32_t data) {
  return pcg(key ^ (data * 0x9E3779B9u + 2891336453u));
}

__device__ __forceinline__ float next_uniform(uint32_t& key) {
  key = pcg(key);
  return static_cast<float>(key >> 8) * (1.0f / 16777216.0f);
}

// ---- camera rays (core/camera.py::generate_rays; row 0 is NDC y = +1) -------

// cam is (2, 4, 4) row-major: inv_projection, inv_view
__device__ __forceinline__ void camera_ray(const float* cam, int width, int height, int pix, float3& orig,
                                           float3& dir) {
  const float* ip = cam;
  const float* iv = cam + 16;
  const float cx = __fsub_rn(__fmul_rn(static_cast<float>(pix % width) / static_cast<float>(width), 2.0f), 1.0f);
  const float cy = __fsub_rn(1.0f, __fmul_rn(static_cast<float>(pix / width) / static_cast<float>(height), 2.0f));
  auto ip_row = [&](int r) {
    return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(__ldg(ip + 4 * r), cx), __fmul_rn(__ldg(ip + 4 * r + 1), cy)),
                               __ldg(ip + 4 * r + 2)),
                     __ldg(ip + 4 * r + 3));
  };
  const float tw = ip_row(3);
  const float3 dn = normalize(make_float3(ip_row(0) / tw, ip_row(1) / tw, ip_row(2) / tw));
  dir = make_float3(dot(ldg3(iv, 0), dn), dot(ldg3(iv + 4, 0), dn), dot(ldg3(iv + 8, 0), dn));
  orig = make_float3(__ldg(iv + 3), __ldg(iv + 7), __ldg(iv + 11));
}

// ---- sampling and BRDF math (core/mathutils.py) ---------------------------------

__device__ __forceinline__ float clampf(float x, float lo, float hi) { return fminf(fmaxf(x, lo), hi); }

__device__ __forceinline__ float3 to_world(float3 n, float lx, float ly, float lz) {
  float3 t = (n.x * n.x > n.z * n.z) ? normalize(make_float3(-n.y, n.x, 0.0f))
                                     : normalize(make_float3(0.0f, -n.z, n.y));
  float3 b = normalize(cross(n, t));
  return normalize(t * lx + b * ly + n * lz);
}

__device__ __forceinline__ float3 uniform_dir(float3 n, float u1, float u2) {
  float phi = kTwoPi * u1;
  float st = sqrtf(fmaxf(1.0f - u2 * u2, 0.0f));
  return to_world(n, st * cosf(phi), st * sinf(phi), u2);
}

__device__ __forceinline__ float3 cosine_dir(float3 n, float u1, float u2) {
  float r = sqrtf(u1);
  float th = kTwoPi * u2;
  return to_world(n, r * cosf(th), r * sinf(th), sqrtf(fmaxf(1.0f - u1, 0.0f)));
}

__device__ __forceinline__ float ggx_sample(float3 n, float3 view, float rough, float u1, float u2, float3& l) {
  float alpha = rough * rough;
  float a2 = alpha * alpha;
  float phi = kTwoPi * u2;
  float ct = sqrtf(clampf((1.0f - u1) / fmaxf(1.0f + (a2 - 1.0f) * u1, 1e-12f), 0.0f, 1.0f));
  ct = clampf(ct, 0.0f, 1.0f);
  float st = sqrtf(fmaxf(1.0f - ct * ct, 0.0f));
  float3 h = to_world(n, st * cosf(phi), st * sinf(phi), ct);
  float3 i = -view;
  l = i - 2.0f * dot(i, h) * h;
  float ndl = dot(n, l), ndh = dot(n, h), vdh = dot(view, h);
  float den = (ndh * ndh) * (a2 - 1.0f) + 1.0f;
  float d = a2 / fmaxf(kPi * den * den, 1e-20f);
  float den4 = 4.0f * vdh;
  bool valid = ndl > 0.0f && den4 > 1e-6f && ndh > 0.0f;
  if (!valid) l = make_float3(0.0f, 0.0f, 0.0f);
  return valid ? (d * ndh) / den4 : 0.0f;
}

__device__ __forceinline__ float ggx_pdf(float3 n, float3 view, float3 l, float rough) {
  float3 h = normalize(view + l);
  float ndh = fmaxf(dot(n, h), 0.0f);
  float vdh = fmaxf(dot(view, h), 0.0f);
  float alpha = rough * rough;
  float a2 = alpha * alpha;
  float den = (ndh * ndh) * (a2 - 1.0f) + 1.0f;
  float d = a2 / fmaxf(kPi * den * den, 1e-20f);
  float den4 = 4.0f * vdh;
  bool valid = ndh > 0.0f && den4 > 1e-6f;
  return valid ? d * ndh / den4 : 0.0f;
}

__device__ __forceinline__ float spec_weight(float3 n, float3 view, float3 alb, float m) {
  float s = powf(1.0f - fmaxf(dot(n, view), 0.0f), 5.0f);
  float f0x = 0.04f * (1.0f - m) + alb.x * m;
  float f0y = 0.04f * (1.0f - m) + alb.y * m;
  float f0z = 0.04f * (1.0f - m) + alb.z * m;
  float w = ((f0x + (1.0f - f0x) * s) + (f0y + (1.0f - f0y) * s) + (f0z + (1.0f - f0z) * s)) * (1.0f / 3.0f);
  return m >= 1.0f ? 1.0f : (m <= 0.0f ? 0.0f : w);
}

// brdf_sample_hemisphere: lobe picked by u_sel <= w_spec, mixture pdf returned
__device__ __forceinline__ float mixture_sample(float3 n, float3 view, float3 alb, float metal, float rough,
                                                float u_sel, float u1, float u2, float3& l) {
  float w = spec_weight(n, view, alb, metal);
  float pdf_spec;
  if (u_sel <= w) {
    pdf_spec = ggx_sample(n, view, rough, u1, u2, l);
  } else {
    l = cosine_dir(n, u1, u2);
    pdf_spec = ggx_pdf(n, view, l, rough);
  }
  float pdf_diff = fmaxf(dot(n, l), 0.0f) * kInvPi;
  return w * pdf_spec + (1.0f - w) * pdf_diff;
}

__device__ __forceinline__ float mixture_pdf(float3 n, float3 view, float3 l, float3 alb, float metal, float rough) {
  float w = spec_weight(n, view, alb, metal);
  return w * ggx_pdf(n, view, l, rough) + (1.0f - w) * (fmaxf(dot(n, l), 0.0f) * kInvPi);
}

__device__ __forceinline__ float3 cook_torrance(float3 n, float3 view, float3 l, float3 alb, float metal,
                                                float rough) {
  float a = rough * rough;
  float a2 = a * a;
  float3 h = normalize(view + l);
  float ndl = fmaxf(dot(n, l), 0.0f);
  float ndv = fmaxf(dot(n, view), 0.0f);
  float ndh = fmaxf(dot(n, h), 0.0f);
  float vdh = fmaxf(dot(view, h), 0.0f);
  if (!(ndl > 0.0f && ndv > 0.0f)) return make_float3(0.0f, 0.0f, 0.0f);
  float s5 = powf(1.0f - vdh, 5.0f);
  float k = rough / 2.0f;
  float g = (ndv / fmaxf(ndv * (1.0f - k) + k, 1e-12f)) * (ndl / fmaxf(ndl * (1.0f - k) + k, 1e-12f));
  float den = (ndh * ndh) * (a2 - 1.0f) + 1.0f;
  float d = a2 * kInvPi / fmaxf(den * den, 1e-12f);
  float spec_den = fmaxf(4.0f * ndv * ndl, 1e-12f);
  float c[3] = {alb.x, alb.y, alb.z};
  float out[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float f0 = 0.04f * (1.0f - metal) + c[i] * metal;
    float f = f0 + (1.0f - f0) * s5;
    out[i] = (1.0f - f) * c[i] * kInvPi + (d * g * f) / spec_den;
  }
  return make_float3(out[0], out[1], out[2]);
}

// ---- light tree (ops/lighttree.py) ---------------------------------------------

__device__ inline float importance(const LightTree& lt, int node, float3 p) {
  float3 lo = ldg3(lt.box_lo, node), hi = ldg3(lt.box_hi, node);
  float3 c = 0.5f * (lo + hi);
  float3 axis = normalize(c - p);
  float cos_u = 1.0f;
  // not unrolled: K2, the one kernel that walks the light tree, inlines this
  // at four sites (two children, in pick_light and emitter_pmf), and eight
  // corners a site of normalize's three IEEE divisions made its NEE kernel
  // larger, with more registers live; one corner an iteration cut K2 NEE's
  // time by a fifth or more on an H100 (kernel_variants.py, PERF.md)
#pragma unroll 1
  for (int i = 0; i < 8; ++i) {
    float3 corner = make_float3((i & 4) ? hi.x : lo.x, (i & 2) ? hi.y : lo.y, (i & 1) ? hi.z : lo.z);
    float cc = clampf(dot(axis, normalize(corner - p)), -1.0f, 1.0f);
    cos_u = (i == 0) ? cc : fminf(cos_u, cc);
  }
  float sin_u = sqrtf(fmaxf(1.0f - cos_u * cos_u, 0.0f));
  float3 dv = p - c;
  float dist2 = fmaxf(dot(dv, dv), 1e-12f);
  dv = normalize(dv);
  float cos_t = clampf(dot(ldg3(lt.axis, node), dv), -1.0f, 1.0f);
  float sin_t = sqrtf(fmaxf(1.0f - cos_t * cos_t, 0.0f));
  float cos_o = __ldg(lt.cos_o + node), sin_o = __ldg(lt.sin_o + node);
  float cos_e = __ldg(lt.cos_e + node), sin_e = __ldg(lt.sin_e + node);
  float cos_a = cos_o * cos_u - sin_o * sin_u;
  float sin_a = sin_o * cos_u + cos_o * sin_u;
  float cos_diff = cos_t * cos_a + sin_t * fabsf(sin_a);
  bool a_gt_pi = sin_a < 0.0f;
  bool clamp_low = a_gt_pi || cos_t >= cos_a;
  bool b_ge_pi = a_gt_pi || cos_e <= -cos_a;
  float cos_b = cos_a * cos_e - sin_a * sin_e;
  bool clamp_high = !b_ge_pi && cos_t <= cos_b;
  float val = clamp_low ? 1.0f : (clamp_high ? cos_e : cos_diff);
  return __ldg(lt.energy + node) * val / dist2;
}

__device__ __forceinline__ float child_p_left(const LightTree& lt, int parent, float3 p) {
  float il = importance(lt, max(__ldg(lt.left + parent), 0), p);
  float ir = importance(lt, max(__ldg(lt.right + parent), 0), p);
  float s = il + ir;
  float pl = s > 0.0f ? il / s : 0.5f;
  return clampf(pl, kPClampLo, kPClampHi);
}

__device__ inline int pick_light(const LightTree& lt, float3 p, float rand, float& pmf) {
  int idx = 0;
  pmf = 1.0f;
  rand = clampf(rand, 0.0f, kRandClamp);
  for (int it = 0; it < lt.max_depth; ++it) {
    int l = __ldg(lt.left + idx);
    if (l < 0) break;
    float pl = child_p_left(lt, idx, p);
    bool go_left = rand < pl;
    pmf = pmf * (go_left ? pl : 1.0f - pl);
    float nr = go_left ? rand / pl : (rand - pl) / (1.0f - pl);
    idx = go_left ? l : __ldg(lt.right + idx);
    rand = clampf(nr, 0.0f, kRandClamp);
  }
  return __ldg(lt.tri + idx);
}

__device__ inline float emitter_pmf(const LightTree& lt, int tri, float3 p) {
  if (tri < 0) return 0.0f;
  int idx = __ldg(lt.leaf_of_tri + tri);
  if (idx < 0) return 0.0f;
  float pmf = 1.0f;
  for (int it = 0; it < lt.max_depth; ++it) {
    int par = __ldg(lt.parent + idx);
    if (par < 0) break;
    float pl = child_p_left(lt, par, p);
    pmf = pmf * (__ldg(lt.left + par) == idx ? pl : 1.0f - pl);
    idx = par;
  }
  return pmf;
}

// ---- surfaces ----------------------------------------------------------------------

struct Surf {
  float3 pos, n, alb;
  float rough, metal;
  int mat;
};

// ops/hit.py::hit_payload for a hit of the ray (o, d)
__device__ __forceinline__ Surf surface(const Geo& g, const Mats& m, const Hit& h, float3 o, float3 d) {
  int a = __ldg(g.tri_v + 3 * h.tri), b = __ldg(g.tri_v + 3 * h.tri + 1), c = __ldg(g.tri_v + 3 * h.tri + 2);
  float w = 1.0f - h.u - h.v;
  Surf s;
  s.n = normalize(ldg3(g.normals, a) * w + ldg3(g.normals, b) * h.u + ldg3(g.normals, c) * h.v);
  s.pos = o + d * h.t;
  s.mat = __ldg(g.tri_mat + h.tri);
  s.alb = ldg3(m.albedo, s.mat);
  s.rough = __ldg(m.roughness + s.mat);
  s.metal = __ldg(m.metallic + s.mat);
  return s;
}

__device__ __forceinline__ float3 emission_of(const Mats& m, int mat) { return ldg3(m.emission, mat); }

// ---- textures (ops/texture.py) -------------------------------------------------------

// sample_bilinear on one level, page `page`: the UV wrapped by floor-mod
// (u - floorf(u), as torch.remainder; fmodf keeps the sign and would take the
// wrong texel for a negative u), fx = wrap(u) * (w - 1), x1 = min(x0 + 1, w - 1),
// four 16-byte texel loads, then the x-lerps and the y-lerp, each product and
// sum rounded alone, so that it rounds as the plain version's elementwise ops.
// Hardware texture filtering is not used: its weights keep 8 fractional bits.
// x0 and y0 are clamped into the page, which changes nothing for a finite UV
// and keeps a NaN UV's reads inside the level.
__device__ __forceinline__ float3 fetch_bilinear(const float4* level, int h, int w, int page, float u, float v) {
  const float fx = __fmul_rn(u - floorf(u), static_cast<float>(w - 1));
  const float fy = __fmul_rn(v - floorf(v), static_cast<float>(h - 1));
  const float x0f = floorf(fx), y0f = floorf(fy);
  const int x0 = min(max(static_cast<int>(x0f), 0), w - 1);
  const int y0 = min(max(static_cast<int>(y0f), 0), h - 1);
  const int x1 = min(x0 + 1, w - 1), y1 = min(y0 + 1, h - 1);
  const float ax = fx - x0f, ay = fy - y0f;
  const float bx = 1.0f - ax, by = 1.0f - ay;
  const float4* r0 = level + (page * h + y0) * w;
  const float4* r1 = level + (page * h + y1) * w;
  const float4 c00 = __ldg(r0 + x0), c10 = __ldg(r0 + x1), c01 = __ldg(r1 + x0), c11 = __ldg(r1 + x1);
  auto lerp = [](float a, float wa, float b, float wb) { return __fadd_rn(__fmul_rn(a, wa), __fmul_rn(b, wb)); };
  const float3 top = make_float3(lerp(c00.x, bx, c10.x, ax), lerp(c00.y, bx, c10.y, ax), lerp(c00.z, bx, c10.z, ax));
  const float3 bot = make_float3(lerp(c01.x, bx, c11.x, ax), lerp(c01.y, bx, c11.y, ax), lerp(c01.z, bx, c11.z, ax));
  return make_float3(lerp(top.x, by, bot.x, ay), lerp(top.y, by, bot.y, ay), lerp(top.z, by, bot.z, ay));
}

// The surface record of a kernel built with or without textures.  Textured,
// a material with an albedo map (page >= 0, clipped to K - 1) takes its albedo
// from the bounce level at a hit after a scatter (`bounce`), else from the
// primary level, at the hit's UV w * uv0 + u * uv1 + v * uv2 (ops/hit.py's
// interpolation, with the hit's own barycentrics; render/integrators.py::
// fetch_albedo).  Untextured it is surface() itself.
template <bool kTextured>
__device__ __forceinline__ Surf tex_surface(const Geo& g, const Mats& m, const Tex& tex, const Hit& h, float3 o,
                                            float3 d, bool bounce) {
  Surf s = surface(g, m, h, o, d);
  if constexpr (kTextured) {
    const int page = __ldg(m.albedo_map + s.mat);
    if (page >= 0) {
      const int a = __ldg(g.tri_v + 3 * h.tri), b = __ldg(g.tri_v + 3 * h.tri + 1), c = __ldg(g.tri_v + 3 * h.tri + 2);
      const float w = 1.0f - h.u - h.v;
      auto interp = [&](int k) {
        return __fadd_rn(__fadd_rn(__fmul_rn(__ldg(g.uvs + 2 * a + k), w), __fmul_rn(__ldg(g.uvs + 2 * b + k), h.u)),
                         __fmul_rn(__ldg(g.uvs + 2 * c + k), h.v));
      };
      const float u = interp(0), v = interp(1);
      const int p = min(page, tex.k - 1);
      s.alb = bounce ? fetch_bilinear(tex.bounce, tex.hb, tex.wb, p, u, v)
                     : fetch_bilinear(tex.prim, tex.hp, tex.wp, p, u, v);
    }
  }
  return s;
}

// camera_ray of pixels pix0 .. pix0 + n - 1, for the test entry below
__global__ void camera_rays_kernel(const float* cam, int width, int height, int pix0, int n, float* orig,
                                   float* dir) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float3 o, d;
  camera_ray(cam, width, height, pix0 + i, o, d);
  orig[3 * i] = o.x;
  orig[3 * i + 1] = o.y;
  orig[3 * i + 2] = o.z;
  dir[3 * i] = d.x;
  dir[3 * i + 1] = d.y;
  dir[3 * i + 2] = d.z;
}

// the device library's functions that the shading code calls, on x[i]:
// out rows powf(x, 5), cosf(x), sinf(x), sqrtf(x), for the test entry below
__global__ void math_ops_kernel(const float* x, int n, float* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float v = x[i];
  out[i] = powf(v, 5.0f);
  out[n + i] = cosf(v);
  out[2 * n + i] = sinf(v);
  out[3 * n + i] = sqrtf(v);
}

}  // namespace fyp

// Test entry: the (4, n) rows of math_ops_kernel, built with the library's
// flags, for holding the device library's functions against PyTorch's
// (chip_smoke.py::k5_parting)
extern "C" int fyp_math_ops(const void* x, int n, void* out, void* stream) {
  if (n <= 0) return 0;
  fyp::math_ops_kernel<<<(n + 127) / 128, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), n, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Test entry of every library that includes this file: the rays camera_ray
// gives pixels pix0 .. pix0 + n - 1, (n, 3) origins and directions, built
// with the library's own flags (ops/kernels.py::camera_rays)
extern "C" int fyp_camera_rays(const void* cam, int width, int height, int pix0, int n, void* orig, void* dir,
                               void* stream) {
  if (n <= 0) return 0;
  fyp::camera_rays_kernel<<<(n + 127) / 128, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cam), width, height, pix0, n, static_cast<float*>(orig), static_cast<float*>(dir));
  return static_cast<int>(cudaGetLastError());
}
