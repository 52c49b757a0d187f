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
// the 4-wide BVH (wide.cuh, trace_closest_wide1); the lanes add their sums by
// shuffles and lane 0 writes the pixel (frames_kernel).  It works from the
// scene's SoA arrays and the wide BVH's records, not from the TPU's packed
// P/AT/L tables, which existed for one-hot MXU fetches.
// Each sampler is built untextured and textured (frames_kernel's T): the
// textured build fetches a mapped material's albedo from the atlas
// (shading.cuh::tex_surface, the JAX kernel's build_tex_lookup, :1526, built
// at :1837-1841), the primary hit from the primary level, every hit after a
// scatter from the bounce level; the untextured build compiles to the code it
// had before textures.
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
// A path's contributions are added to its frame's sum as they come, as the
// plain version adds them; for one sample a pixel that is the path's own sum.
//
// What bounds it on an H100: the traversal's dependent loads (wide.cuh),
// multiplied by the traces per frame (1 + 2 * bounces for NEE, bounces for the
// hemisphere family, 1 for LIGHT), and the shading arithmetic around them
// (for NEE and LIGHT the light-tree descent, whose importance evaluation, 8
// box corners per child, is the main part), whose IEEE divisions and roots
// make the code long; and so the threads a multiprocessor holds, which keep
// those loads in flight.  Output is one float3 store per pixel per launch,
// so device-memory traffic is the scene's, which stays in L2 for Cornell.
// What the design does about it (each choice measured, PERF.md Findings):
//   * one walk site: every trace of a lane, the primary hit, NEE's shadow
//     and continuation rays and the hemisphere family's bounces, goes
//     through the one inlined trace_closest_wide1 at the top of the frame
//     loop, which is not unrolled; the walk's code is emitted once, and
//     nothing is saved around a call;
//   * the same walk slots in every thread: a path runs a fixed sequence of
//     slots (frames below), so a warp's threads trace, shade and begin paths
//     together; a thread that began its next path as soon as its last one
//     ended would split its warp between the shading sites, each run in
//     turn;
//   * little state across the walk: a light sample's contribution is
//     computed before its shadow ray is traced (and NEE's continuation
//     scatter with it, the draws in the same order), so a shadow walk
//     carries that contribution and the light's id, not the surface; the
//     primary hit's surface and view stay in shared memory (KeptSurf);
//   * launch bounds at the most blocks a multiprocessor for which ptxas
//     spills nothing (min_blocks, chip_smoke.py phase 2); the stacks, 8 bytes
//     x stack depth x 128 threads of shared memory a block, and the kept
//     surfaces cap a deep tree's blocks too (stress: 5);
//   * NEE's shadow ray only asks whether the light's triangle is its closest
//     hit, so its walk is bounded by t_max = dist + tol, tol = max(1e-4,
//     1e-3 dist) (segment_visible_wide1's tolerance), and prunes every box
//     past the light: every hit nearer than t_max, ties at one t to the
//     lowest id, is found as the unbounded walk finds it, and where the
//     unbounded walk's closest hit lies past t_max it is not the light
//     (whose hit lies below t_max: tests/test_torch_k2_shadow.py) and the
//     bounded walk returns -1, so both fail the identity check.  LIGHT keeps
//     the unbounded walk: it adds the sky when the shadow ray escapes.
// Four threads a pixel launch 262,144 threads at 256², against 65,536 when one
// thread ran a pixel's frames; the wide BVH cuts a Cornell ray's dependent
// visits from 18.4 nodes and 4.1 triangles to 3.6 nodes and 1.2 leaves.  More
// than one lane adds a pixel's frames in another order than one thread would,
// so its sums differ from one lane's in the last bits.
//
// Built with -DFYP_K2_CLOCKS, each thread counts the cycles of its sections
// (Clocks below) for chip_smoke.py::k2_attribution; built with
// -DFYP_WALK_CHECKS, the walks check their state (wide.cuh).
//
// The pixel slab (the JAX kernel's chunk entry, render(..., pix0=) at
// :2372-2420, read at :1792 and :1952-1953): a launch renders the n_pix
// pixels that start at global pixel pix0 and writes them from out[0]; every
// ray and key is the global pixel's, so slabs of any size and boundary (not
// a multiple of the block or of the lanes) join into the one-launch image
// bit for bit.  parallel/shard.py::sharded_megakernel_render gives each rank
// its slab.
//
// C interface (loaded with ctypes by render/megakernel.py::PreparedK2):
//   fyp_megakernel_prepare   packs a launch's argument block once: the kernel
//                            of the sampler, lane count and texturing, its
//                            grid and shared memory (opted in above 48 KB),
//                            and Params with every pointer and int but the
//                            frames (cudaErrorInvalidValue for an unknown
//                            sampler or lane count, or a slab outside the
//                            image); the block is the caller's, of
//                            fyp_megakernel_prepared_bytes bytes;
//   fyp_megakernel_launch    launches a packed block with its first frame,
//                            frame count and output: writes the (n_pix, 3)
//                            float32 HDR of pixels pix0 .. pix0 + n_pix - 1
//                            summed over n_frames, returns cudaGetLastError()
//                            after the asynchronous launch.  The kernel and
//                            what it is given are those of one call that
//                            took every argument; only the host's work
//                            between two launches is less;
//   fyp_megakernel_occupancy the blocks of the same kernel a multiprocessor
//                            holds at once, by the CUDA runtime;
//   fyp_megakernel_clocks    (built with -DFYP_K2_CLOCKS) the sections'
//                            cycles summed since its last call.
#include "shading.cuh"
#include "wide.cuh"

namespace {

using namespace fyp;

enum Sampler { UNIFORM = 0, COSINE = 1, GGX = 2, BRDF = 3, LIGHT = 4, NEE = 5 };

constexpr int kBlock = 128;  // threads
// The blocks of 128 a multiprocessor must hold at once (__launch_bounds__),
// which caps a thread at 65,536 / (min_blocks * 128) registers: the most
// blocks at which ptxas spills nothing (NEE 96 registers at 5, the others
// 79-80 at 6, on an H100; kernel_variants.py, PERF.md)
template <int S>
constexpr int min_blocks() { return S == NEE ? 5 : 6; }

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
  WideBvh wide;
  LightTree lt;
};

// The ray kinds of the one walk site
enum Kind { kPrimary = 0, kShadow = 1, kBounce = 2 };

// Cycles a thread spends in each section of K2, built with -DFYP_K2_CLOCKS
// (chip_smoke.py::k2_attribution): the whole frame loop, the walks by ray
// kind (primary, shadow, continuation) and the light sample (pick_light,
// the point on the light, emitter_pmf); the rest is surface fetch, shading
// and scatter.  Each warp adds its threads' sums into k2_clocks, which the C
// entry fyp_megakernel_clocks hands over and clears.  Without the macro
// every call below compiles to nothing.
enum Section { kTotal = 0, kWalkPrimary = 1, kWalkShadow = 2, kWalkBounce = 3, kLight = 4, kSections = 5 };
#ifdef FYP_K2_CLOCKS
__device__ unsigned long long k2_clocks[kSections];
struct Clocks {
  long long c[kSections] = {};
  __device__ __forceinline__ long long now() const { return clock64(); }
  __device__ __forceinline__ void add(Section s, long long t0) { c[s] += clock64() - t0; }
  __device__ __forceinline__ void walk(int kind, long long t0) {
    const long long dt = clock64() - t0;
    c[kWalkPrimary] += kind == kPrimary ? dt : 0;
    c[kWalkShadow] += kind == kShadow ? dt : 0;
    c[kWalkBounce] += kind == kBounce ? dt : 0;
  }
  // every thread of the warp calls it
  __device__ void flush() {
#pragma unroll
    for (int s = 0; s < kSections; ++s) {
      long long v = c[s];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if ((threadIdx.x & 31) == 0) atomicAdd(k2_clocks + s, static_cast<unsigned long long>(v));
    }
  }
};
#else
struct Clocks {
  __device__ __forceinline__ long long now() const { return 0; }
  __device__ __forceinline__ void add(Section, long long) {}
  __device__ __forceinline__ void walk(int, long long) {}
  __device__ __forceinline__ void flush() {}
};
#endif

// The state of a path between two traces of the walk site.  A sampler sets
// only its own fields; the others are never used and take no registers.
struct Path {
  uint32_t key;
  int b;       // NEE: the vertex; the hemisphere family: the bounce ray
  float3 thr;  // throughput
  // a shadow ray in flight (NEE, LIGHT): the radiance it adds when its
  // closest hit is triangle `want` (-2 when it adds none)
  float3 lit;
  int want;
  // NEE's continuation, scattered before the shadow ray: traced when its
  // pdf > 0, from the shadow ray's origin along `dir`; its pdf and the
  // vertex's position weigh an emitter it hits (MIS)
  float3 dir;
  float pdf;
  float3 pos;
};

// The primary hit's surface and the direction it is seen along, kept in
// shared memory after the walks' stacks: a column of kBlock-strided floats
// a thread (no bank conflicts), read at each path's start and holding no
// register across the walk
struct KeptSurf {
  float* c;
  static constexpr int kFloats = 14;  // pos, n, alb, rough, metal, view
  __device__ __forceinline__ float& at(int k) const { return c[k * kBlock]; }
  __device__ __forceinline__ void store(const Surf& s, float3 view) const {
    at(0) = s.pos.x, at(1) = s.pos.y, at(2) = s.pos.z;
    at(3) = s.n.x, at(4) = s.n.y, at(5) = s.n.z;
    at(6) = s.alb.x, at(7) = s.alb.y, at(8) = s.alb.z;
    at(9) = s.rough, at(10) = s.metal;
    at(11) = view.x, at(12) = view.y, at(13) = view.z;
  }
  __device__ __forceinline__ Surf load(float3& view) const {
    Surf s;
    s.pos = make_float3(at(0), at(1), at(2));
    s.n = make_float3(at(3), at(4), at(5));
    s.alb = make_float3(at(6), at(7), at(8));
    s.rough = at(9);
    s.metal = at(10);
    s.mat = -1;
    view = make_float3(at(11), at(12), at(13));
    return s;
  }
};

// The thread's KeptSurf column: after the stacks of the block's kBlock walks
__device__ __forceinline__ KeptSurf kept_column(int stack_depth) {
  return KeptSurf{wide_stack + 2 * kBlock * stack_depth + threadIdx.x};
}

// The next ray of the walk site, and its kind
struct Ray {
  float3 o, d;
  float t_max;
  int kind;
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

// The hemisphere family's scatter at s seen along view
// (integrators.py::radiance_hemisphere): the throughput through it and its
// bounce ray; false when pdf <= 0 ends the path
template <int S>
__device__ __forceinline__ bool hemisphere_scatter(Path& p, const Surf& s, float3 view, Ray& r) {
  float3 l;
  const float pdf = scatter<S>(p.key, s, view, l);
  const float3 f = cook_torrance(s.n, view, l, s.alb, s.metal, s.rough);
  p.thr = p.thr * f * fmaxf(dot(l, s.n), 0.0f) / pdf;
  if (!(pdf > 0.0f)) return false;
  r = Ray{s.pos + s.n * kOriginEps, l, kBig, kBounce};
  return true;
}

// A vertex of NEE at s seen along view (integrators.py::radiance_nee_mis,
// :279-345): the light sample and what its shadow ray adds if the light is
// its closest hit, then (with more than one bounce) the mixture continuation
// and the throughput through it; the shadow ray, bounded by the light, next
__device__ __forceinline__ void nee_vertex(const Params& P, Clocks& clk, Path& p, const Surf& s, float3 view,
                                           Ray& r) {
  const bool single = P.bounces == 1;
  const float u_pick = next_uniform(p.key);
  const float lu1 = next_uniform(p.key);
  const float lu2 = next_uniform(p.key);
  float pmf;
  const long long t0 = clk.now();
  const int lt_tri = pick_light(P.lt, s.pos, u_pick, pmf);
  float3 point, ln;
  float area;
  light_point(P, max(lt_tri, 0), lu1, lu2, point, ln, area);
  clk.add(kLight, t0);
  const float3 tl = point - s.pos;
  const float dist = sqrtf(fmaxf(dot(tl, tl), 1e-20f));
  const float3 l_dir = tl / dist;
  p.want = -2;
  if (lt_tri >= 0 && pmf > 0.0f) {
    const float3 fd = cook_torrance(s.n, view, l_dir, s.alb, s.metal, s.rough);
    const float cos_x = fmaxf(dot(l_dir, s.n), 0.0f);
    const float cos_y = fmaxf(dot(-l_dir, ln), 1e-12f);
    const float pdf_direct = pmf * (1.0f / fmaxf(area, 1e-20f)) * dist * dist / cos_y;
    float w_direct = 1.0f;
    if (!single) {
      const float pdf_brdf_l = mixture_pdf(s.n, view, l_dir, s.alb, s.metal, s.rough);
      w_direct = pdf_direct / fmaxf(pdf_brdf_l + pdf_direct, 1e-12f);
    }
    const float dscale = w_direct / fmaxf(pdf_direct, 1e-20f) * cos_x;
    const float3 l_em = emission_of(P.mats, __ldg(P.geo.tri_mat + lt_tri));
    p.lit = p.thr * ((dscale * fd) * l_em);
    p.want = lt_tri;
  }
  p.pdf = 0.0f;
  if (!single) {
    float3 l;
    const float pdf_brdf = scatter<NEE>(p.key, s, view, l);
    const float3 fc = cook_torrance(s.n, view, l, s.alb, s.metal, s.rough);
    const float cos_t = fmaxf(dot(l, s.n), 0.0f);
    p.thr = p.thr * fc * cos_t / fmaxf(pdf_brdf, 1e-12f);
    p.dir = l;
    p.pdf = pdf_brdf;
    p.pos = s.pos;
  }
  const float tol = fmaxf(1e-4f, __fmul_rn(dist, 1e-3f));
  r = Ray{s.pos + s.n * kOriginEps, l_dir, __fadd_rn(dist, tol), kShadow};
}

// LIGHT's light sample at the primary hit s seen along view
// (integrators.py::radiance_light_source): what its shadow ray adds if the
// light is its closest hit (the sky is added if it escapes), and the ray
__device__ __forceinline__ void light_vertex(const Params& P, Clocks& clk, Path& p, const Surf& s, float3 view,
                                             Ray& r) {
  const float u_pick = next_uniform(p.key);
  const float u1 = next_uniform(p.key);
  const float u2 = next_uniform(p.key);
  float pmf;
  const long long t0 = clk.now();
  const int lt_tri = pick_light(P.lt, s.pos, u_pick, pmf);
  float3 point, ln;
  float area;
  light_point(P, max(lt_tri, 0), u1, u2, point, ln, area);
  clk.add(kLight, t0);
  const float3 tl = point - s.pos;
  const float dist = sqrtf(fmaxf(dot(tl, tl), 1e-20f));
  const float3 l_dir = tl / dist;
  const float3 fd = cook_torrance(s.n, view, l_dir, s.alb, s.metal, s.rough);
  const float cos_x = fmaxf(dot(l_dir, s.n), 0.0f);
  const float cos_y = fmaxf(dot(-l_dir, ln), 0.0f);
  const float pdf = pmf * (1.0f / fmaxf(area, 1e-20f)) * dist * dist;
  p.lit = fd * (cos_x * cos_y / fmaxf(pdf, 1e-20f));
  p.want = lt_tri >= 0 && pmf > 0.0f ? lt_tri : -2;
  r = Ray{s.pos + s.n * kOriginEps, l_dir, kBig, kShadow};
}

// The HDR of pixel pix summed over frames f_first, f_first + f_step, ...
// (below n_frames); textured when T.  A primary miss or emitter gives
// n_frames times its radiance, whatever the frames, and sets *whole.
//
// One iteration of the loop is one walk slot: the primary ray once, then
// for each path the same slots in every thread (NEE: a shadow and a
// continuation ray a bounce, one shadow ray at one bounce; the hemisphere
// family: a bounce ray a bounce; LIGHT: the shadow ray), so the threads of
// a warp trace, shade and begin paths together: a thread whose path ends
// early sits out its remaining slots, as it would wait at the end of a
// structured path loop.  The loop holds one walk site, one site that
// fetches a bounce hit's surface and one that shades a vertex (a light
// sample or a scatter, at the primary hit or at a bounce hit); the primary
// hit's surface and view are read back from shared memory (prim) at each
// path's start.
template <int S, bool T>
__device__ __forceinline__ float3 frames(const Params& P, const LaneStack& st, const KeptSurf& prim, Clocks& clk,
                                         int pix, int f_first, int f_step, bool& whole) {
  const long long t_all = clk.now();
  Ray r;
  camera_ray(P.cam, P.width, P.height, pix, r.o, r.d);
  r.t_max = kBig;
  r.kind = kPrimary;
  const int n_slots = S == LIGHT ? 1 : S == NEE ? (P.bounces == 1 ? 1 : 2 * P.bounces) : P.bounces;
  Path p;
  int slot = -1;       // the path's walk slot; -1: the primary ray
  bool live = true;    // a ray to trace in this slot
  const uint32_t pix_key = pcg(static_cast<uint32_t>(pix));
  int f = f_first, s = 0;
  float3 acc = make_float3(0.0f, 0.0f, 0.0f);
  float3 rad = acc;    // the frame's sum over its samples so far
#pragma unroll 1
  for (;;) {
    Hit h;
    h.tri = -1;
    if (live) {
      const long long t0 = clk.now();
      h = trace_closest_wide1(P.wide, st, r.o, r.d, r.t_max);
      clk.walk(r.kind, t0);
    }
    Surf sf;           // the surface of the vertex to shade, if any,
    float3 view;       // seen along view
    bool vertex = false;
    if (slot < 0) {
      const float3 em0 = h.tri < 0 ? P.sky : emission_of(P.mats, __ldg(P.geo.tri_mat + h.tri));
      whole = h.tri < 0 || dot(em0, em0) > 0.0f;
      if (whole) {
        const float nf = static_cast<float>(P.n_frames);
        clk.add(kTotal, t_all);
        return make_float3(nf * em0.x, nf * em0.y, nf * em0.z);
      }
      prim.store(tex_surface<T>(P.geo, P.mats, P.tex, h, r.o, r.d, false), -r.d);
    } else if (live && r.kind == kShadow) {
      if constexpr (S == LIGHT) {
        float3 add = make_float3(0.0f, 0.0f, 0.0f);
        if (h.tri == p.want) add = p.lit * emission_of(P.mats, __ldg(P.geo.tri_mat + p.want));
        if (h.tri < 0) add = add + p.lit * P.sky;
        rad = rad + add;
        live = false;
      } else {
        if (h.tri == p.want) rad = rad + p.lit;
        live = p.pdf > 0.0f;  // NEE's continuation, from the shadow ray's origin
        r.d = p.dir;
        r.t_max = kBig;
        r.kind = kBounce;
      }
    } else if (live) {
      // a bounce ray's hit
      if (h.tri < 0) {
        rad = rad + p.thr * P.sky;
        live = false;
      } else {
        sf = tex_surface<T>(P.geo, P.mats, P.tex, h, r.o, r.d, true);
        const float3 em = emission_of(P.mats, sf.mat);
        if (dot(em, em) > 0.0f) {
          if constexpr (S == NEE) {
            // MIS with the light pdf at the actual hit point
            const float cos_y2 = fmaxf(dot(-r.d, sf.n), 1e-12f);
            float3 q0, q1, q2;
            triangle(Tris{P.geo.positions, P.geo.tri_v}, h.tri, q0, q1, q2);
            const float3 cr2 = cross(q1 - q0, q2 - q0);
            const float area2 = 0.5f * sqrtf(fmaxf(dot(cr2, cr2), 1e-20f));
            const float dist2 = fmaxf(h.t, 0.0f);
            const long long t0 = clk.now();
            const float pmf2 = emitter_pmf(P.lt, h.tri, p.pos);
            clk.add(kLight, t0);
            const float pdf_direct2 = pmf2 * (1.0f / area2) * dist2 * dist2 / cos_y2;
            const float w_brdf = p.pdf / fmaxf(p.pdf + pdf_direct2, 1e-12f);
            rad = rad + p.thr * em * w_brdf;
          } else {
            rad = rad + p.thr * em;
          }
          live = false;
        } else {
          live = vertex = ++p.b < P.bounces;
          view = -r.d;
        }
      }
    }
    // after the primary ray, and after a path's last slot, the next path
    if (++slot == 0 || slot >= n_slots) {
      if (slot > 0 && ++s == P.samples) {
        acc = acc + rad / static_cast<float>(P.samples);
        rad = make_float3(0.0f, 0.0f, 0.0f);
        s = 0;
        f += f_step;
      }
      if (f >= P.n_frames) {
        clk.add(kTotal, t_all);
        return acc;
      }
      p.key = fold(fold(fold(pix_key, P.frame0 + static_cast<uint32_t>(f)), static_cast<uint32_t>(s)), 0u);
      p.thr = make_float3(1.0f, 1.0f, 1.0f);
      p.b = 0;
      slot = 0;
      live = vertex = S == LIGHT || P.bounces >= 1;
      sf = prim.load(view);
    }
    if (vertex) {
      if constexpr (S == NEE) {
        nee_vertex(P, clk, p, sf, view, r);
      } else if constexpr (S == LIGHT) {
        light_vertex(P, clk, p, sf, view, r);
      } else {
        live = hemisphere_scatter<S>(p, sf, view, r);
      }
    }
  }
}

__device__ __forceinline__ void store(float* __restrict__ out, int pix, float3 v) {
  out[3 * pix + 0] = v.x;
  out[3 * pix + 1] = v.y;
  out[3 * pix + 2] = v.z;
}

// T: textured (the albedo fetch of shading.cuh::tex_surface); the untextured
// instantiations compile to the code they had before textures.
// `lanes` threads a pixel, lane k with frames k, k + lanes, ...; the lanes
// add their sums by xor shuffles, for four (l0 + l1) + (l2 + l3).
// Pixel `local` of the slab is global pixel P.pix0 + local: its ray and every
// key are the global pixel's, so slabs join into the whole image bit for bit
template <int S, bool T>
__global__ void __launch_bounds__(kBlock, min_blocks<S>()) frames_kernel(Params P, float* __restrict__ out) {
  const int lanes = P.lanes;
  const int local = (blockIdx.x * kBlock + threadIdx.x) / lanes;
  Clocks clk;
  if (local < P.n_pix) {  // the ragged edge leaves a pixel's lanes whole
    const int lane = threadIdx.x & (lanes - 1);
    const unsigned mask = ((1u << lanes) - 1u) << ((threadIdx.x & 31) & ~(lanes - 1));
    bool whole;  // the same in the pixel's lanes: one primary ray
    float3 acc = frames<S, T>(P, lane_stack(P.wide.stack_depth), kept_column(P.wide.stack_depth), clk,
                              P.pix0 + local, lane, lanes, whole);
    if (whole && lane != 0) acc = make_float3(0.0f, 0.0f, 0.0f);  // n_frames times its radiance, once
    for (int off = 1; off < lanes; off <<= 1) {
      acc.x += __shfl_xor_sync(mask, acc.x, off, lanes);
      acc.y += __shfl_xor_sync(mask, acc.y, off, lanes);
      acc.z += __shfl_xor_sync(mask, acc.z, off, lanes);
    }
    if (lane == 0) store(out, local, acc);
  }
  clk.flush();
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

// A block's dynamic shared memory: the stacks of its walks, then each
// thread's KeptSurf column
size_t smem_of(int stack_depth) {
  return wide_stack_bytes(kBlock, stack_depth) + sizeof(float) * kBlock * KeptSurf::kFloats;
}

// The kernel of a sampler, lane count and texturing, or null
Kernel kernel_of(int sampler, int lanes, bool textured) {
  if (lanes != 1 && lanes != 2 && lanes != 4) return nullptr;
  return textured ? sampler_kernel<true>(sampler) : sampler_kernel<false>(sampler);
}

// A launch packed by fyp_megakernel_prepare: Params' frame0 and n_frames are
// set by each fyp_megakernel_launch
struct Prepared {
  Kernel kernel;
  int grid;
  size_t smem;
  Params P;
};

}  // namespace

extern "C" int fyp_megakernel_prepared_bytes() { return static_cast<int>(sizeof(Prepared)); }

extern "C" int fyp_megakernel_prepare(
    int sampler, int lanes, const void* cam, int width, int height, int pix0, int n_pix, int bounces,
    int samples, float sky_r, float sky_g, float sky_b,
    const void* positions, const void* normals, const void* tri_v, const void* tri_mat, const void* uvs,
    const void* albedo, const void* roughness, const void* metallic, const void* emission, const void* albedo_map,
    int textured, const void* tex_prim, const void* tex_bounce, int tex_k, int tex_hp, int tex_wp, int tex_hb,
    int tex_wb,
    const void* wide_nodes, const void* wide_tris, void* wide_overflow, int wide_stack_depth,
    const void* lt_energy, const void* lt_axis, const void* lt_cos_o, const void* lt_sin_o,
    const void* lt_cos_e, const void* lt_sin_e, const void* lt_box_lo, const void* lt_box_hi,
    const void* lt_left, const void* lt_right, const void* lt_tri, const void* lt_parent,
    const void* lt_leaf_of_tri, int lt_max_depth,
    void* prepared) {
  if (n_pix > 0 && (pix0 < 0 || pix0 + static_cast<long long>(n_pix) > static_cast<long long>(width) * height)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Kernel k = kernel_of(sampler, lanes, textured != 0);
  if (k == nullptr || wide_stack_depth < 1 || (textured && tex_k < 1)) return static_cast<int>(cudaErrorInvalidValue);
  auto F = [](const void* p) { return static_cast<const float*>(p); };
  auto I = [](const void* p) { return static_cast<const int*>(p); };
  Prepared& prep = *static_cast<Prepared*>(prepared);
  Params& P = prep.P;
  P.cam = F(cam);
  P.width = width;
  P.height = height;
  P.pix0 = pix0;
  P.n_pix = n_pix;
  P.frame0 = 0;
  P.n_frames = 0;
  P.bounces = bounces;
  P.samples = samples;
  P.lanes = lanes;
  P.sky = make_float3(sky_r, sky_g, sky_b);
  P.geo = Geo{F(positions), F(normals), I(tri_v), I(tri_mat), F(uvs)};
  P.mats = Mats{F(albedo), F(roughness), F(metallic), F(emission), I(albedo_map)};
  P.tex = Tex{static_cast<const float4*>(tex_prim), static_cast<const float4*>(tex_bounce), tex_k, tex_hp, tex_wp,
              tex_hb, tex_wb};
  P.wide = WideBvh{static_cast<const float4*>(wide_nodes), static_cast<const float4*>(wide_tris),
                   static_cast<int*>(wide_overflow), wide_stack_depth};
  P.lt = LightTree{F(lt_energy), F(lt_axis), F(lt_cos_o), F(lt_sin_o), F(lt_cos_e), F(lt_sin_e),
                   F(lt_box_lo), F(lt_box_hi), I(lt_left), I(lt_right), I(lt_tri), I(lt_parent),
                   I(lt_leaf_of_tri), lt_max_depth};
  prep.kernel = k;
  prep.smem = smem_of(wide_stack_depth);
  prep.grid = static_cast<int>((static_cast<long long>(lanes) * (n_pix > 0 ? n_pix : 0) + kBlock - 1) / kBlock);
  return static_cast<int>(allow_stack_smem(k, prep.smem));
}

extern "C" int fyp_megakernel_launch(const void* prepared, unsigned int frame0, int n_frames, void* out,
                                     void* stream) {
  const Prepared& prep = *static_cast<const Prepared*>(prepared);
  if (prep.P.n_pix <= 0) return 0;
  Params P = prep.P;
  P.frame0 = frame0;
  P.n_frames = n_frames;
  prep.kernel<<<prep.grid, kBlock, prep.smem, static_cast<cudaStream_t>(stream)>>>(P, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fyp_megakernel_occupancy(int sampler, int lanes, int textured, int wide_stack_depth,
                                        int* blocks_per_sm) {
  const Kernel k = kernel_of(sampler, lanes, textured != 0);
  if (k == nullptr || wide_stack_depth < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_of(wide_stack_depth);
  cudaError_t e = allow_stack_smem(k, smem);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, k, kBlock, smem);
  return static_cast<int>(e);
}

#ifdef FYP_K2_CLOCKS
// The cycles of each section (Section) summed over every thread of every
// launch since the last call, as kSections unsigned 64-bit ints copied to
// out (on the card), and the sums cleared, on the stream.
extern "C" int fyp_megakernel_clocks(void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemcpyFromSymbolAsync(out, k2_clocks, sizeof(k2_clocks), 0, cudaMemcpyDeviceToDevice, st);
  void* sums = nullptr;
  if (e == cudaSuccess) e = cudaGetSymbolAddress(&sums, k2_clocks);
  if (e == cudaSuccess) e = cudaMemsetAsync(sums, 0, sizeof(k2_clocks), st);
  return static_cast<int>(e);
}
#endif
