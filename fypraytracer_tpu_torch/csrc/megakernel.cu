// megakernel: N frames of one sampling technique in one kernel launch (K2).
//
// Replaces the TPU kernel fypraytracer_tpu/render/megakernel.py::make_megakernel
// -> kernel (:1788, launched at :2404) for every entry of MegakernelRenderer.
// SAMPLER_OF (:2566): the hemisphere family (uniform, cosine, ggx, brdf), light-
// source sampling and NEE+MIS.  The kernel is a template over the sampler, so
// each technique compiles to its own code with no per-bounce dispatch; one C
// entry takes the sampler as an int.  Brute force is UNIFORM at 1 sample, chosen
// by the host (megakernel.py:2603).  `lanes` threads (1, 2 or 4, chosen by
// the host: render/megakernel.py::k2_lanes) own one pixel: each traces the
// pixel's primary ray and then runs every lanes-th frame (lane k frames k,
// k + lanes, ...) with the sample loop inside, tracing each ray alone through
// the 4-wide BVH (wide.cuh, trace_closest_wide1; NEE calls it, the other
// samplers inline it); the lanes add their sums by shuffles and lane 0 writes
// the pixel (frames_kernel).  It works from the scene's SoA arrays and the
// wide BVH's records, not from the TPU's packed P/AT/L tables, which existed
// for one-hot MXU fetches.  The frame loop is a template over the walk: for
// NEE it is also built with one thread a pixel and the threaded walk of
// traverse.cuh (frames_threaded_kernel), so that chip_smoke.py can time both
// in turns (fyp_megakernel's lanes argument 0).
// Each sampler is built untextured and textured (frames_kernel's T): the
// textured build fetches a mapped material's albedo from the atlas
// (shading.cuh::tex_surface, the JAX kernel's build_tex_lookup, :1526, built
// at :1837-1841), the primary hit from the primary level, every hit after a
// scatter from the bounce level; the untextured build compiles to the code it
// had before textures.  The threaded walk is built untextured only.
//
// Semantics kept from the JAX kernel (and from render/integrators.py, whose
// frame the PyTorch plain version sums):
//   * the primary hit is traced once per launch and reused by every frame
//     (megakernel.py:1962-1971); a pixel whose primary ray misses outputs
//     n_frames * sky, an emissive primary hit n_frames * emission (:2290-2292);
//   * keys are fold(fold(fold(pcg(pix), frame), s), 0) (core/rng.py::path_key);
//   * per scatter the draws are 2 uniforms for uniform, cosine and ggx and 3 for
//     the BRDF mixture, u_sel first (:1843-1870); a scatter with pdf <= 0 ends
//     the path; a miss adds throughput * sky, an emitter hit throughput *
//     emission, and ends it;
//   * LIGHT (radiance_light_source, :2213-2281) is one bounce of direct light:
//     light-tree pick, a uniform point on the triangle, pdf = pmf * dist^2 /
//     area with cos_y clamped at 0, visibility by identity, and the sky added
//     when the shadow ray escapes.  NEE's bounces == 1 branch differs from it
//     (cos_y clamped at 1e-12, no sky term), so it is a branch of its own;
//   * NEE (radiance_nee_mis): per bounce the draws are u_pick, lu1, lu2 for the
//     light sample, then u_sel, u1, u2 for the mixture continuation; the shadow
//     ray is a closest-hit trace checked by identity (sh_tri == lt_tri), cos_y
//     is clamped at 1e-12, pdf_brdf at 1e-12; the continuation's MIS takes
//     cos_y2, area2 and pmf2 at the actual hit; bounces == 1 is plain light
//     sampling with no MIS weight.
//
// What bounds it on an H100: the traversal's dependent loads (wide.cuh),
// multiplied by the traces per frame (1 + 2 * bounces for NEE, bounces for the
// hemisphere family, 1 for LIGHT), plus for NEE and LIGHT the light-tree
// descent, whose importance evaluation (8 box corners per child) is the main
// arithmetic.  Output is one float3 store per pixel per launch, so
// device-memory traffic is the scene's, which stays in L2 for Cornell.  Four
// threads a pixel launch 262,144 threads at 256², against 65,536 when one
// thread ran a pixel's frames, without shading anything twice (a quad that
// walked each ray together shaded each path four times and lost, PERF.md
// Findings); the wide BVH cuts a Cornell ray's dependent visits from 18.4
// nodes and 4.1 triangles to 3.6 nodes and 1.2 leaves.  More than one lane
// adds a pixel's frames in another order than one thread would, so its sums
// differ from one lane's in the last bits.  Path regeneration and ray sorting
// are later work.
//
// The pixel slab (the JAX kernel's chunk entry, render(..., pix0=) at
// :2372-2420, read at :1792 and :1952-1953): a launch renders the n_pix
// pixels that start at global pixel pix0 and writes them from out[0]; every
// ray and key is the global pixel's, so slabs of any size and boundary (not
// a multiple of the block or of the lanes) join into the one-launch image
// bit for bit.  parallel/shard.py::sharded_megakernel_render gives each rank
// its slab.
//
// C interface (loaded with ctypes by render/megakernel.py::megakernel):
//   fyp_megakernel           writes the (n_pix, 3) float32 HDR of pixels
//                            pix0 .. pix0 + n_pix - 1 summed over n_frames,
//                            returns cudaGetLastError() after the
//                            asynchronous launch (cudaErrorInvalidValue for an
//                            unknown sampler or lane count, the threaded
//                            walk, lanes 0, with another sampler than NEE,
//                            or a slab outside the image);
//   fyp_megakernel_occupancy the blocks of the same kernel a multiprocessor
//                            holds at once, by the CUDA runtime.
#include "shading.cuh"
#include "wide.cuh"

namespace {

using namespace fyp;

enum Sampler { UNIFORM = 0, COSINE = 1, GGX = 2, BRDF = 3, LIGHT = 4, NEE = 5 };

constexpr int kBlock = 128;  // threads; ptxas gives 72-96 registers a thread, no tighter bound pays

struct Params {
  const float* cam;  // (2, 4, 4): inv_projection, inv_view, row-major
  int width, height;
  int pix0, n_pix;  // the slab: global pixels pix0 .. pix0 + n_pix - 1, written to out[0 .. n_pix - 1]
  uint32_t frame0;
  int n_frames, bounces, samples;
  int lanes;  // threads a pixel: 1, 2 or 4
  float3 sky;
  Geo geo;
  Mats mats;
  Tex tex;  // the textured instantiations' levels
  Bvh bvh;
  WideBvh wide;
  LightTree lt;
};

// The closest hit of a ray, t < kBig: by one thread through the wide BVH ...
struct LaneWalk {
  WideBvh w;
  LaneStack st;
  __device__ __forceinline__ Hit operator()(float3 o, float3 d) const {
    return trace_closest_wide1(w, st, o, d, kBig);
  }
};

// ... the same, as a call: the walk then has the registers to itself, and
// the path's live state is saved around the call instead (NEE, whose path
// holds the most state: measured faster so at Cornell 256², slower at
// stress 128², PERF.md Findings)
__device__ __noinline__ Hit trace_closest_wide1_call(const WideBvh& w, const LaneStack& st, float3 o, float3 d) {
  return trace_closest_wide1(w, st, o, d, kBig);
}

struct LaneCallWalk {
  WideBvh w;
  LaneStack st;
  __device__ __forceinline__ Hit operator()(float3 o, float3 d) const { return trace_closest_wide1_call(w, st, o, d); }
};

// ... or by one thread through the threaded BVH
struct ThreadedWalk {
  Bvh bvh;
  Tris tris;
  __device__ __forceinline__ Hit operator()(float3 o, float3 d) const { return trace_closest(bvh, tris, o, d, kBig); }
};

// integrators.py::_scatter: a direction at surface s seen along view, and its pdf
template <int S>
__device__ __forceinline__ float scatter(uint32_t& key, const Surf& s, float3 view, float3& l) {
  if (S == BRDF || S == NEE) {
    float u_sel = next_uniform(key);
    float u1 = next_uniform(key);
    float u2 = next_uniform(key);
    return mixture_sample(s.n, view, s.alb, s.metal, s.rough, u_sel, u1, u2, l);
  }
  float u1 = next_uniform(key);
  float u2 = next_uniform(key);
  if (S == UNIFORM) {
    l = uniform_dir(s.n, u1, u2);
    return 1.0f / kTwoPi;
  }
  if (S == COSINE) {
    l = cosine_dir(s.n, u1, u2);
    return fmaxf(dot(s.n, l), 0.0f) * kInvPi;
  }
  return ggx_sample(s.n, view, s.rough, u1, u2, l);
}

// A uniform point on light triangle tid (Triangle.cuh:20-51): point, averaged
// normal, area; integrators.py::_sample_point_on_triangle.
__device__ __forceinline__ void light_point(const Params& P, int tid, float u1, float u2, float3& point,
                                            float3& ln, float& area) {
  int ia = __ldg(P.geo.tri_v + 3 * tid), ib = __ldg(P.geo.tri_v + 3 * tid + 1), ic = __ldg(P.geo.tri_v + 3 * tid + 2);
  float3 p0 = ldg3(P.geo.positions, ia), p1 = ldg3(P.geo.positions, ib), p2 = ldg3(P.geo.positions, ic);
  float su = sqrtf(u1);
  point = p0 * (1.0f - su) + p1 * (su * (1.0f - u2)) + p2 * (su * u2);
  ln = normalize(ldg3(P.geo.normals, ia) + ldg3(P.geo.normals, ib) + ldg3(P.geo.normals, ic));
  float3 cr = cross(p1 - p0, p2 - p0);
  area = 0.5f * sqrtf(dot(cr, cr));
}

// integrators.py::radiance_hemisphere, one sample of one frame
template <int S, bool T, class Walk>
__device__ __forceinline__ float3 hemisphere_path(const Params& P, const Walk& walk, uint32_t key, const Surf& prim,
                                                  float3 dir) {
  float3 rad = make_float3(0.0f, 0.0f, 0.0f);
  float3 view = -dir;
  float3 l;
  float pdf = scatter<S>(key, prim, view, l);
  float3 f = cook_torrance(prim.n, view, l, prim.alb, prim.metal, prim.rough);
  float3 thr = f * fmaxf(dot(l, prim.n), 0.0f) / pdf;
  if (!(pdf > 0.0f)) return rad;
  float3 ray_o = prim.pos + prim.n * kOriginEps;
  float3 ray_d = l;
  for (int b = 0; b < P.bounces; ++b) {
    Hit hh = walk(ray_o, ray_d);
    if (hh.tri < 0) return rad + thr * P.sky;
    Surf s = tex_surface<T>(P.geo, P.mats, P.tex, hh, ray_o, ray_d, true);
    float3 em = emission_of(P.mats, s.mat);
    if (dot(em, em) > 0.0f) return rad + thr * em;
    view = -ray_d;
    pdf = scatter<S>(key, s, view, l);
    f = cook_torrance(s.n, view, l, s.alb, s.metal, s.rough);
    thr = thr * f * fmaxf(dot(l, s.n), 0.0f) / pdf;
    if (!(pdf > 0.0f)) return rad;
    ray_o = s.pos + s.n * kOriginEps;
    ray_d = l;
  }
  return rad;
}

// integrators.py::radiance_light_source, one sample of one frame
template <class Walk>
__device__ __forceinline__ float3 light_sample(const Params& P, const Walk& walk, uint32_t key, const Surf& prim,
                                               float3 dir) {
  float u_pick = next_uniform(key);
  float u1 = next_uniform(key);
  float u2 = next_uniform(key);
  float pmf;
  int lt_tri = pick_light(P.lt, prim.pos, u_pick, pmf);
  float3 point, ln;
  float area;
  light_point(P, max(lt_tri, 0), u1, u2, point, ln, area);
  float3 tl = point - prim.pos;
  float dist = sqrtf(fmaxf(dot(tl, tl), 1e-20f));
  float3 l_dir = tl / dist;
  float3 fd = cook_torrance(prim.n, -dir, l_dir, prim.alb, prim.metal, prim.rough);
  float cos_x = fmaxf(dot(l_dir, prim.n), 0.0f);
  float cos_y = fmaxf(dot(-l_dir, ln), 0.0f);
  float pdf = pmf * (1.0f / fmaxf(area, 1e-20f)) * dist * dist;
  float3 contrib = fd * (cos_x * cos_y / fmaxf(pdf, 1e-20f));
  Hit sh = walk(prim.pos + prim.n * kOriginEps, l_dir);
  float3 rad = make_float3(0.0f, 0.0f, 0.0f);
  if (lt_tri >= 0 && sh.tri == lt_tri && pmf > 0.0f)
    rad = contrib * emission_of(P.mats, __ldg(P.geo.tri_mat + lt_tri));
  if (sh.tri < 0) rad = rad + contrib * P.sky;
  return rad;
}

// integrators.py::radiance_nee_mis, one sample of one frame
template <bool T, class Walk>
__device__ __forceinline__ float3 nee_path(const Params& P, const Walk& walk, uint32_t key, const Surf& prim,
                                           float3 dir) {
  const bool single = P.bounces == 1;
  float3 rad = make_float3(0.0f, 0.0f, 0.0f);
  float3 thr = make_float3(1.0f, 1.0f, 1.0f);
  Surf surf = prim;
  float3 ray_d = dir;

  for (int b = 0; b < P.bounces; ++b) {
    const float3 view = -ray_d;

    // ---- direct light sample + shadow ray (integrators.py:279-305)
    float u_pick = next_uniform(key);
    float lu1 = next_uniform(key);
    float lu2 = next_uniform(key);
    float pmf;
    int lt_tri = pick_light(P.lt, surf.pos, u_pick, pmf);
    {
      float3 point, ln;
      float area;
      light_point(P, max(lt_tri, 0), lu1, lu2, point, ln, area);
      float3 tl = point - surf.pos;
      float dist = sqrtf(fmaxf(dot(tl, tl), 1e-20f));
      float3 l_dir = tl / dist;
      Hit sh = walk(surf.pos + surf.n * kOriginEps, l_dir);
      if (lt_tri >= 0 && sh.tri == lt_tri && pmf > 0.0f) {
        float3 fd = cook_torrance(surf.n, view, l_dir, surf.alb, surf.metal, surf.rough);
        float cos_x = fmaxf(dot(l_dir, surf.n), 0.0f);
        float cos_y = fmaxf(dot(-l_dir, ln), 1e-12f);
        float pdf_direct = pmf * (1.0f / fmaxf(area, 1e-20f)) * dist * dist / cos_y;
        float w_direct = 1.0f;
        if (!single) {
          float pdf_brdf_l = mixture_pdf(surf.n, view, l_dir, surf.alb, surf.metal, surf.rough);
          w_direct = pdf_direct / fmaxf(pdf_brdf_l + pdf_direct, 1e-12f);
        }
        float dscale = w_direct / fmaxf(pdf_direct, 1e-20f) * cos_x;
        float3 l_em = emission_of(P.mats, __ldg(P.geo.tri_mat + lt_tri));
        rad = rad + thr * ((dscale * fd) * l_em);
      }
    }
    if (single) break;

    // ---- BRDF continuation (integrators.py:310-345)
    float3 l;
    float pdf_brdf = scatter<NEE>(key, surf, view, l);
    float3 fc = cook_torrance(surf.n, view, l, surf.alb, surf.metal, surf.rough);
    float cos_t = fmaxf(dot(l, surf.n), 0.0f);
    thr = thr * fc * cos_t / fmaxf(pdf_brdf, 1e-12f);
    if (!(pdf_brdf > 0.0f)) break;

    float3 ray_o = surf.pos + surf.n * kOriginEps;
    ray_d = l;
    Hit hh = walk(ray_o, ray_d);
    if (hh.tri < 0) {
      rad = rad + thr * P.sky;
      break;
    }
    Surf next = tex_surface<T>(P.geo, P.mats, P.tex, hh, ray_o, ray_d, true);
    float3 em = emission_of(P.mats, next.mat);
    if (dot(em, em) > 0.0f) {
      // MIS with the light pdf at the actual hit point
      float cos_y2 = fmaxf(dot(-ray_d, next.n), 1e-12f);
      float3 q0, q1, q2;
      triangle(Tris{P.geo.positions, P.geo.tri_v}, hh.tri, q0, q1, q2);
      float3 cr2 = cross(q1 - q0, q2 - q0);
      float area2 = 0.5f * sqrtf(fmaxf(dot(cr2, cr2), 1e-20f));
      float dist2 = fmaxf(hh.t, 0.0f);
      float pmf2 = emitter_pmf(P.lt, hh.tri, surf.pos);
      float pdf_direct2 = pmf2 * (1.0f / area2) * dist2 * dist2 / cos_y2;
      float w_brdf = pdf_brdf / fmaxf(pdf_brdf + pdf_direct2, 1e-12f);
      rad = rad + thr * em * w_brdf;
      break;
    }
    surf = next;
  }
  return rad;
}

// The HDR of pixel pix summed over frames f_first, f_first + f_step, ...
// (below n_frames), traced by walk; textured when T.  A primary miss or
// emitter gives n_frames times its radiance, whatever the frames, and sets
// *whole.
template <int S, bool T, class Walk>
__device__ __forceinline__ float3 frames(const Params& P, const Walk& walk, int pix, int f_first, int f_step,
                                         bool& whole) {
  float3 orig, dir;
  camera_ray(P.cam, P.width, P.height, pix, orig, dir);

  // ---- primary hit, traced once and reused by every frame
  const float nf = static_cast<float>(P.n_frames);
  const Hit h0 = walk(orig, dir);
  const Surf prim = h0.tri < 0 ? Surf{} : tex_surface<T>(P.geo, P.mats, P.tex, h0, orig, dir, false);
  const float3 em0 = h0.tri < 0 ? P.sky : emission_of(P.mats, prim.mat);
  whole = h0.tri < 0 || dot(em0, em0) > 0.0f;
  if (whole) return make_float3(nf * em0.x, nf * em0.y, nf * em0.z);
  const uint32_t pix_key = pcg(static_cast<uint32_t>(pix));
  float3 acc = make_float3(0.0f, 0.0f, 0.0f);
  for (int f = f_first; f < P.n_frames; f += f_step) {
    const uint32_t key_f = fold(pix_key, P.frame0 + static_cast<uint32_t>(f));
    float3 rad = make_float3(0.0f, 0.0f, 0.0f);
    for (int s = 0; s < P.samples; ++s) {
      const uint32_t key = fold(fold(key_f, static_cast<uint32_t>(s)), 0u);
      if (S == NEE) {
        rad = rad + nee_path<T>(P, walk, key, prim, dir);
      } else if (S == LIGHT) {
        rad = rad + light_sample(P, walk, key, prim, dir);
      } else {
        rad = rad + hemisphere_path<S, T>(P, walk, key, prim, dir);
      }
    }
    acc = acc + rad / static_cast<float>(P.samples);
  }
  return acc;
}

__device__ __forceinline__ void store(float* __restrict__ out, int pix, float3 v) {
  out[3 * pix + 0] = v.x;
  out[3 * pix + 1] = v.y;
  out[3 * pix + 2] = v.z;
}

// `lanes` threads a pixel, lane k with frames k, k + lanes, ... and the wide
// walk by the thread; the lanes add their sums by xor shuffles, for four
// (l0 + l1) + (l2 + l3)
template <int S, bool T, class Walk>
__device__ __forceinline__ void lane_frames(const Params& P, const Walk& walk, int local,
                                            float* __restrict__ out) {
  const int lanes = P.lanes;
  const int lane = threadIdx.x & (lanes - 1);
  const unsigned mask = ((1u << lanes) - 1u) << ((threadIdx.x & 31) & ~(lanes - 1));
  bool whole;  // the same in the pixel's lanes: one primary ray
  float3 acc = frames<S, T>(P, walk, P.pix0 + local, lane, lanes, whole);
  if (whole && lane != 0) acc = make_float3(0.0f, 0.0f, 0.0f);  // n_frames times its radiance, once
  for (int off = 1; off < lanes; off <<= 1) {
    acc.x += __shfl_xor_sync(mask, acc.x, off, lanes);
    acc.y += __shfl_xor_sync(mask, acc.y, off, lanes);
    acc.z += __shfl_xor_sync(mask, acc.z, off, lanes);
  }
  if (lane == 0) store(out, local, acc);
}

// T: textured (the albedo fetch of shading.cuh::tex_surface); the untextured
// instantiations compile to the code they had before textures
// Pixel `local` of the slab is global pixel P.pix0 + local: its ray and every
// key are the global pixel's, so slabs join into the whole image bit for bit
template <int S, bool T>
__global__ void __launch_bounds__(kBlock) frames_kernel(Params P, float* __restrict__ out) {
  const int local = (blockIdx.x * kBlock + threadIdx.x) / P.lanes;
  if (local >= P.n_pix) return;  // the ragged edge leaves a pixel's lanes whole
  const LaneStack st = lane_stack(P.wide.stack_depth);
  if constexpr (S == NEE) {
    lane_frames<S, T>(P, LaneCallWalk{P.wide, st}, local, out);
  } else {
    lane_frames<S, T>(P, LaneWalk{P.wide, st}, local, out);
  }
}

// one thread a pixel, the threaded walk (untextured only)
template <int S>
__global__ void __launch_bounds__(kBlock) frames_threaded_kernel(Params P, float* __restrict__ out) {
  const int local = blockIdx.x * kBlock + threadIdx.x;
  if (local >= P.n_pix) return;
  bool whole;
  store(out, local,
        frames<S, false>(P, ThreadedWalk{P.bvh, Tris{P.geo.positions, P.geo.tri_v}}, P.pix0 + local, 0, 1, whole));
}

using Kernel = void (*)(Params, float*);

template <bool T>
Kernel sampler_kernel(int sampler) {
  switch (sampler) {
    case UNIFORM: return frames_kernel<UNIFORM, T>;
    case COSINE: return frames_kernel<COSINE, T>;
    case GGX: return frames_kernel<GGX, T>;
    case BRDF: return frames_kernel<BRDF, T>;
    case LIGHT: return frames_kernel<LIGHT, T>;
    case NEE: return frames_kernel<NEE, T>;
    default: return nullptr;
  }
}

// The kernel of a sampler, lane count (0: the threaded walk, NEE and
// untextured only) and texturing, or null
Kernel kernel_of(int sampler, int lanes, bool textured) {
  if (lanes == 0) return sampler == NEE && !textured ? frames_threaded_kernel<NEE> : nullptr;
  if (lanes != 1 && lanes != 2 && lanes != 4) return nullptr;
  return textured ? sampler_kernel<true>(sampler) : sampler_kernel<false>(sampler);
}

// Dynamic shared memory of a block: a stack for each thread of the wide walk
size_t smem_of(int lanes, int stack_depth) { return lanes == 0 ? 0 : wide_stack_bytes(kBlock, stack_depth); }

}  // namespace

extern "C" int fyp_megakernel(
    int sampler, int lanes, const void* cam, int width, int height, int pix0, int n_pix, unsigned int frame0,
    int n_frames, int bounces,
    int samples, float sky_r, float sky_g, float sky_b,
    const void* positions, const void* normals, const void* tri_v, const void* tri_mat, const void* uvs,
    const void* albedo, const void* roughness, const void* metallic, const void* emission, const void* albedo_map,
    int textured, const void* tex_prim, const void* tex_bounce, int tex_k, int tex_hp, int tex_wp, int tex_hb,
    int tex_wb,
    const void* bvh_lo, const void* bvh_hi, const void* bvh_miss, const void* bvh_first,
    const void* bvh_prim_idx, int n_nodes, int leaf_size,
    const void* wide_nodes, const void* wide_tris, void* wide_overflow, int wide_stack_depth,
    const void* lt_energy, const void* lt_axis, const void* lt_cos_o, const void* lt_sin_o,
    const void* lt_cos_e, const void* lt_sin_e, const void* lt_box_lo, const void* lt_box_hi,
    const void* lt_left, const void* lt_right, const void* lt_tri, const void* lt_parent,
    const void* lt_leaf_of_tri, int lt_max_depth,
    void* out, void* stream) {
  if (n_pix <= 0) return 0;
  if (pix0 < 0 || pix0 + static_cast<long long>(n_pix) > static_cast<long long>(width) * height) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Kernel k = kernel_of(sampler, lanes, textured != 0);
  if (k == nullptr || wide_stack_depth < 1 || (textured && tex_k < 1)) return static_cast<int>(cudaErrorInvalidValue);
  auto F = [](const void* p) { return static_cast<const float*>(p); };
  auto I = [](const void* p) { return static_cast<const int*>(p); };
  Params P;
  P.cam = F(cam);
  P.width = width;
  P.height = height;
  P.pix0 = pix0;
  P.n_pix = n_pix;
  P.frame0 = frame0;
  P.n_frames = n_frames;
  P.bounces = bounces;
  P.samples = samples;
  P.lanes = max(lanes, 1);
  P.sky = make_float3(sky_r, sky_g, sky_b);
  P.geo = Geo{F(positions), F(normals), I(tri_v), I(tri_mat), F(uvs)};
  P.mats = Mats{F(albedo), F(roughness), F(metallic), F(emission), I(albedo_map)};
  P.tex = Tex{static_cast<const float4*>(tex_prim), static_cast<const float4*>(tex_bounce), tex_k, tex_hp, tex_wp,
              tex_hb, tex_wb};
  P.bvh = Bvh{F(bvh_lo), F(bvh_hi), I(bvh_miss), I(bvh_first), I(bvh_prim_idx), n_nodes, leaf_size};
  P.wide = WideBvh{static_cast<const float4*>(wide_nodes), static_cast<const float4*>(wide_tris),
                   static_cast<int*>(wide_overflow), wide_stack_depth};
  P.lt = LightTree{F(lt_energy), F(lt_axis), F(lt_cos_o), F(lt_sin_o), F(lt_cos_e), F(lt_sin_e),
                   F(lt_box_lo), F(lt_box_hi), I(lt_left), I(lt_right), I(lt_tri), I(lt_parent),
                   I(lt_leaf_of_tri), lt_max_depth};
  const size_t smem = smem_of(lanes, wide_stack_depth);
  const cudaError_t e = allow_stack_smem(k, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid = static_cast<int>((static_cast<long long>(P.lanes) * n_pix + kBlock - 1) / kBlock);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  k<<<grid, kBlock, smem, st>>>(P, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fyp_megakernel_occupancy(int sampler, int lanes, int textured, int wide_stack_depth,
                                        int* blocks_per_sm) {
  const Kernel k = kernel_of(sampler, lanes, textured != 0);
  if (k == nullptr || wide_stack_depth < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_of(lanes, wide_stack_depth);
  cudaError_t e = allow_stack_smem(k, smem);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, k, kBlock, smem);
  return static_cast<int>(e);
}
