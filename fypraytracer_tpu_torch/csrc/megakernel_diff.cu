// megakernel_diff: the loss of one cosine-sampled frame against a target and
// its gradient with respect to per-triangle albedo, in one launch (K8).
//
// Replaces the TPU kernel fypraytracer_tpu/render/megakernel_diff.py::
// make_diff_megakernel -> kernel (:117, launched at :241).  One thread owns
// one pixel, each warp a tile of 8 x 4 pixels, a block of 128 threads four
// such tiles:
//   * forward: K2's cosine path for one frame and one sample (camera_ray,
//     the closest hit, surface, cosine_dir), keys fold(fold(fold(pcg(pix),
//     frame), 0), 0) (megakernel_diff.py:144-147); NL = bounces scatter
//     levels, level j scattering at the primary hit (j = 0) or at the hit of
//     level j-1's trace.  Each level keeps in registers (at most 4 levels)
//     the ratio dg_c / g_c of its throughput factor's albedo derivative dg_c
//     = df_c/dalb_c * cos / pdf to the factor g_c = f_c * cos / pdf (0 where
//     g_c <= 0), its surface's triangle id and its radiance contribution.  A primary
//     miss outputs the sky, an emissive primary hit its emission; both, and
//     a level whose pdf <= 0, carry no gradient.  The BRDF and its albedo
//     derivative are the JAX kernel's own _f_and_dfdalb (:67-96), term for
//     term, not shading.cuh's cook_torrance (another operation order);
//   * loss: sum over pixels and channels of (r_c - tgt_c)^2 / (3B), summed by
//     warp shuffles, then over the block's 4 warps in shared memory, then one
//     atomicAdd a block into one float;
//   * reverse scan (:215-225): over the levels in reverse, suffix_c +=
//     contrib_c(level) before use, gsel_c = a_c * suffix_c * (dg_c / g_c)
//     (a_c = 2 err_c / (3B)), added into d_tri[tri * 3 + c].  The TPU
//     kernel forms a one-hot (T, C) product on the MXU instead.
//
// What bounds it on an H100: the 1 + bounces BVH walks a pixel, as K2's
// cosine frame.  They go through the 4-wide BVH (wide.cuh::WideTracer,
// trace_closest_wide1, inlined; its stack in dynamic shared memory, one a
// thread), and one walk site serves every trace: the level loop is not
// unrolled, its step -1 traces the camera ray and step j scatters level j
// and traces on, and the per-level registers are written through an
// unrolled select on j, so they stay registers.  With the loop unrolled
// NL = 4 inlined five walks and ran 3% slower than the threaded walks at 4
// bounces on an H100, where one walk site runs 1.28x faster (PERF.md
// Findings).  After the walks come the atomics, on a few triangles:
// the Cornell walls are 2 triangles each, and most of the 65,536 pixels x 2
// levels land on them; once the walks were wide they took 10% of the
// kernel at 2 bounces and 23% at 4.  So at each level the lanes of a warp
// that hold one triangle id (__match_any_sync) sum its gradient by a masked
// warp sum, one such group at a time, and the group's lowest lane adds it
// (3 atomics a group instead of 3 a lane); a lane alone adds its own.  That
// took the kernel from 0.1090 to 0.0991 ms at Cornell 256² and 2 bounces
// (0.2130 to 0.1860 at 4), and cost 0.8% at 1024², where the atomics are
// 1% of it.  Float atomics sum in an order that changes between runs.
//
// Where its time goes (section clocks, below; PERF.md Findings): at Cornell
// 256² and 2 bounces the walks take 59% of the threads' cycles, the loss
// sum's barrier wait 16%, surface and scatter 10%, the atomics 0.04%; the
// launch is one wave, and 36% of it runs after its median block has
// ended.  So a warp walks a tile of 8 x 4 pixels rather than 32 of a row:
// its rays leave neighbouring points, so its lanes share more of their
// walks and its blocks end closer together (0.98x at 256², 0.95x on
// stress 128², 0.99x at 1920x1088, 0.97x at 4 bounces).  Keys, rays and
// targets stay on the pixel index, so only the float atomics' order
// changes.  A level keeps dg / g in place of g and dg, three registers
// fewer: with 2 bounces ptxas took 72 registers and spilled 24 bytes,
// now 71 and none (63-95 registers over NL = 1-4, no spills), without
// giving up a block a multiprocessor (a launch bound of 5 blocks also
// removes the spills, and lost 1.09x at 1920x1088).  Both together:
// 0.96x, 0.94x, 0.96x and 0.95x of the parent's kernel, on an H100.
//
// Built with -DFYP_DIFF_NO_ATOMICS, the gradient's atomics are compiled out
// (the sums stay live): chip_smoke.py times the kernel so built against the
// kept one to read the atomics' share.  Built with -DFYP_DIFF_CLOCKS, each
// thread counts the cycles of its sections and each block its span on the
// card's clock (Clocks below, clocks.cuh) for chip_smoke.py::k8_attribution.
// Built with -DFYP_WALK_CHECKS, the walks check their state (wide.cuh).
//
// Built with -fmad=false (ops/kernels.py::EXTRA_FLAGS), so that no product
// is fused into a sum and every expression but the reverse scan's product
// (a_c * suffix_c times the kept ratio, where diff_plain divides last)
// rounds as in the plain PyTorch version
// (render/megakernel_diff.py::diff_plain).
//
// C interface (loaded with ctypes by render/megakernel_diff.py::
// diff_megakernel): fyp_diff_megakernel zeroes the loss and d_tri (T, 3) on
// the stream, launches, and returns cudaGetLastError() (cudaErrorInvalidValue
// for bounces outside 1-4, or for 128 stacks of the depth that do not fit a
// block's shared memory); fyp_diff_clocks (built with -DFYP_DIFF_CLOCKS)
// hands over the section cycles and block spans since its last call.
#include "clocks.cuh"
#include "shading.cuh"
#include "wide.cuh"

namespace {

using namespace fyp;

constexpr int kBlock = 128;
constexpr int kWarps = kBlock / 32;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const float* cam;  // (2, 4, 4): inv_projection, inv_view, row-major
  int width, height;
  uint32_t frame;
  float3 sky;
  Geo geo;
  Mats mats;
  WideBvh wide;
  const float* target;  // (B, 3)
  float* loss;          // (1,)
  float* d_tri;         // (T, 3)
};

// v * rsqrt(|v|^2 + 1e-20): the JAX kernel's _norm3
__device__ __forceinline__ float3 norm3(float3 v) {
  return v * rsqrtf(v.x * v.x + v.y * v.y + v.z * v.z + 1e-20f);
}

// Cook-Torrance f_c and df_c/dalb_c (megakernel_diff.py:67-96)
__device__ __forceinline__ void f_and_dfdalb(float3 n, float3 v, float3 l, float3 alb, float rough, float metal,
                                             float f[3], float df[3]) {
  const float3 h = norm3(v + l);
  const float ndl = fmaxf(dot(n, l), 0.0f);
  const float ndv = fmaxf(dot(n, v), 0.0f);
  const float ndh = fmaxf(dot(n, h), 0.0f);
  const float vdh = fmaxf(dot(v, h), 0.0f);
  const float a = rough * rough;
  const float a2 = a * a;
  const float k = rough * 0.5f;
  const float g = (ndv / fmaxf(ndv * (1.0f - k) + k, 1e-12f)) * (ndl / fmaxf(ndl * (1.0f - k) + k, 1e-12f));
  const float den = ndh * ndh * (a2 - 1.0f) + 1.0f;
  const float d = a2 * kInvPi / fmaxf(den * den, 1e-12f);
  const float spec = d * g / fmaxf(4.0f * ndv * ndl, 1e-12f);
  const float s5 = powf(1.0f - vdh, 5.0f);
  const bool live = ndl > 0.0f && ndv > 0.0f;
  const float c[3] = {alb.x, alb.y, alb.z};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float f0 = 0.04f * (1.0f - metal) + c[i] * metal;
    const float fr = f0 + (1.0f - f0) * s5;
    const float dfr = metal * (1.0f - s5);
    f[i] = live ? (1.0f - fr) * c[i] * kInvPi + spec * fr : 0.0f;
    df[i] = live ? (1.0f - fr) * kInvPi + dfr * (spec - c[i] * kInvPi) : 0.0f;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Cycles a thread spends in each section of K8, built with -DFYP_DIFF_CLOCKS
// (chip_smoke.py::k8_attribution): the whole kernel, the camera ray, the walk
// of each level (kWalk: the camera ray's, then each scatter level's), the
// surface and emission of a hit, a level's scatter with f_and_dfdalb, the
// loss sum with its barrier wait, the reverse scan's warp sums and the
// gradient's atomics; the rest is the set-up, the keys and the
// contributions.  Each warp adds its threads' sums into diff_clocks and its
// span into diff_spans, which the C entry fyp_diff_clocks hands over and
// clears.  Without the macro every call below compiles to nothing.
enum Section {
  kTotal = 0, kCamera = 1, kWalk = 2, kSurface = 7, kScatter = 8, kLoss = 9, kScan = 10, kAtomics = 11,
  kSections = 12
};
#ifdef FYP_DIFF_CLOCKS
__device__ unsigned long long diff_clocks[kSections];
__device__ BlockSpans diff_spans;
struct Clocks : SectionClocks<kSections> {
  __device__ __forceinline__ void begin() const { SectionClocks::begin(diff_spans); }
  __device__ void flush() const { SectionClocks::flush(diff_clocks, diff_spans); }
};
#else
using Clocks = NoClocks;
#endif

// One channel of a triangle's gradient into d_tri
__device__ __forceinline__ void add_grad(float* p, float v) {
#ifdef FYP_DIFF_NO_ATOMICS
  if (v == -1.2345e-37f) *p = v;  // never true: keeps the sum live without the atomic
#else
  atomicAdd(p, v);
#endif
}

template <int NL>
__global__ void __launch_bounds__(kBlock) diff_kernel(Params P) {
  Clocks clk;
  clk.begin();
  const long long t_all = clk.now();
  const int n_pix = P.width * P.height;
  // each warp a tile of 8 x 4 pixels; a lane outside the image takes pix = n_pix
  const int tiles_x = (P.width + 7) / 8;
  const int wt = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int px = (wt % tiles_x) * 8 + (threadIdx.x & 7);
  const int py = (wt / tiles_x) * 4 + ((threadIdx.x >> 3) & 3);
  const int pix = px < P.width && py < P.height ? py * P.width + px : n_pix;
  const float inv_n = 1.0f / static_cast<float>(3 * n_pix);

  // per level: dg / g, contribution, triangle (-1: no gradient)
  float rg[NL][3], ct[NL][3];
  int tri[NL];
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    tri[j] = -1;
#pragma unroll
    for (int i = 0; i < 3; ++i) rg[j][i] = ct[j][i] = 0.0f;
  }

  // ---- forward; every thread of the block stays to the end (warp sums)
  float3 out = make_float3(0.0f, 0.0f, 0.0f), tgt = out;
  if (pix < n_pix) {
    const WideTracer tr{P.wide, lane_stack(P.wide.stack_depth)};
    float3 o, d;
    long long t0 = clk.now();
    camera_ray(P.cam, P.width, P.height, pix, o, d);
    clk.add(kCamera, t0);
    tgt = ldg3(P.target, pix);
    uint32_t key = 0u;
    float3 thr = make_float3(1.0f, 1.0f, 1.0f);
    float3 view = -d;
    Surf s{};          // the surface the next level scatters at
    int lvl_tri = -1;  // and its triangle
#pragma unroll 1
    for (int j = -1; j < NL; ++j) {
      if (j >= 0) {
        // level j scatters at s
        t0 = clk.now();
        const float u1 = next_uniform(key);
        const float u2 = next_uniform(key);
        const float3 l = cosine_dir(s.n, u1, u2);
        const float cos_t = fmaxf(dot(l, s.n), 0.0f);
        const float pdf = cos_t * kInvPi;
        if (!(pdf > 0.0f)) {
          clk.add(kScatter, t0);
          break;
        }
        float f[3], df[3];
        f_and_dfdalb(s.n, view, l, s.alb, s.rough, s.metal, f, df);
        const float scale = cos_t / pdf;
        float gj[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) gj[i] = f[i] * scale;
#pragma unroll
        for (int k = 0; k < NL; ++k) {
          if (k == j) {
#pragma unroll
            for (int i = 0; i < 3; ++i) rg[k][i] = gj[i] > 0.0f ? df[i] * scale / gj[i] : 0.0f;
            tri[k] = lvl_tri;
          }
        }
        thr = thr * make_float3(gj[0], gj[1], gj[2]);
        o = s.pos + s.n * kOriginEps;
        d = l;
        clk.add(kScatter, t0);
      }
      t0 = clk.now();
      const Hit h = tr.closest(o, d);
      clk.add(kWalk + 1 + j, t0);
      Surf nxt{};
      float3 em = make_float3(0.0f, 0.0f, 0.0f);
      t0 = clk.now();
      if (h.tri >= 0) {
        nxt = surface(P.geo, P.mats, h, o, d);
        em = emission_of(P.mats, nxt.mat);
      }
      clk.add(kSurface, t0);
      const bool lit = dot(em, em) > 0.0f;
      if (j < 0) {
        if (h.tri < 0) {
          out = P.sky;
          break;
        }
        if (lit) {
          out = em;
          break;
        }
        key = fold(fold(fold(pcg(static_cast<uint32_t>(pix)), P.frame), 0u), 0u);
      } else {
        float3 c = make_float3(0.0f, 0.0f, 0.0f);
        if (h.tri < 0) c = thr * P.sky;
        else if (lit) c = thr * em;
#pragma unroll
        for (int k = 0; k < NL; ++k) {
          if (k == j) {
            ct[k][0] = c.x;
            ct[k][1] = c.y;
            ct[k][2] = c.z;
          }
        }
        out = out + c;
        if (h.tri < 0 || lit) break;
      }
      view = -d;
      lvl_tri = h.tri;
      s = nxt;
    }
  }

  // ---- loss: warp shuffles, the block's warps in shared memory, one atomic
  long long t_sum = clk.now();
  const float e[3] = {out.x - tgt.x, out.y - tgt.y, out.z - tgt.z};
  __shared__ float part[kWarps];
  const float sq = warp_sum(e[0] * e[0] + e[1] * e[1] + e[2] * e[2]);
  const int lane = threadIdx.x & 31;
  if (lane == 0) part[threadIdx.x >> 5] = sq;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += part[w];
    atomicAdd(P.loss, s * inv_n);
  }
  clk.add(kLoss, t_sum);

  // ---- reverse scan over the levels, gradient into d_tri
  t_sum = clk.now();
  float adj[3], suffix[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 3; ++i) adj[i] = 2.0f * e[i] / static_cast<float>(3 * n_pix);
#pragma unroll
  for (int j = NL - 1; j >= 0; --j) {
    float gs[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      suffix[i] = suffix[i] + ct[j][i];
      gs[i] = adj[i] * suffix[i] * rg[j][i];
    }
    const int t = tri[j];
    // the lanes that hold one triangle: each group of two or more sums its
    // gradient (a masked warp sum, one group at a time) and its lowest lane
    // adds it; a lane alone adds its own
    const unsigned peers = __match_any_sync(kFull, t);
    const bool alone = (peers & (peers - 1u)) == 0u;
    unsigned groups = __ballot_sync(kFull, t >= 0 && !alone && lane == __ffs(peers) - 1);
    while (groups != 0u) {
      const int src = __ffs(groups) - 1;
      groups &= groups - 1u;
      const bool in = (peers >> src) & 1u;
      float s[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) s[i] = warp_sum(in ? gs[i] : 0.0f);
      if (lane == src) {
        const long long ta = clk.now();
#pragma unroll
        for (int i = 0; i < 3; ++i)
          if (s[i] != 0.0f) add_grad(P.d_tri + 3 * t + i, s[i]);
        clk.sub(kScan, clk.add(kAtomics, ta));
      }
    }
    if (alone && t >= 0) {
      const long long ta = clk.now();
#pragma unroll
      for (int i = 0; i < 3; ++i)
        if (gs[i] != 0.0f) add_grad(P.d_tri + 3 * t + i, gs[i]);
      clk.sub(kScan, clk.add(kAtomics, ta));
    }
  }
  clk.add(kScan, t_sum);
  clk.add(kTotal, t_all);
  clk.flush();
}

using DiffKernel = void (*)(Params);

}  // namespace

extern "C" int fyp_diff_megakernel(
    const void* cam, int width, int height, unsigned int frame, int bounces, float sky_r, float sky_g,
    float sky_b, const void* positions, const void* normals, const void* tri_v, const void* tri_mat, int n_tris,
    const void* albedo, const void* roughness, const void* metallic, const void* emission,
    const void* wide_nodes, const void* wide_tris, void* wide_overflow, int wide_stack_depth,
    const void* target, void* loss_out, void* dtri_out, void* stream) {
  const size_t smem = wide_stack_bytes(kBlock, wide_stack_depth > 0 ? wide_stack_depth : 0);
  if (bounces < 1 || bounces > 4 || wide_stack_depth < 1 || smem + sizeof(float) * kWarps > 232448u)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // a reused buffer would add to the last launch's sums
  cudaError_t err = cudaMemsetAsync(loss_out, 0, sizeof(float), st);
  if (err == cudaSuccess) err = cudaMemsetAsync(dtri_out, 0, sizeof(float) * 3 * static_cast<size_t>(n_tris), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_pix = width * height;
  if (n_pix <= 0) return 0;
  auto F = [](const void* p) { return static_cast<const float*>(p); };
  auto I = [](const void* p) { return static_cast<const int*>(p); };
  Params P;
  P.cam = F(cam);
  P.width = width;
  P.height = height;
  P.frame = frame;
  P.sky = make_float3(sky_r, sky_g, sky_b);
  P.geo = Geo{F(positions), F(normals), I(tri_v), I(tri_mat)};
  P.mats = Mats{F(albedo), F(roughness), F(metallic), F(emission)};
  P.wide = WideBvh{static_cast<const float4*>(wide_nodes), static_cast<const float4*>(wide_tris),
                   static_cast<int*>(wide_overflow), wide_stack_depth};
  P.target = F(target);
  P.loss = static_cast<float*>(loss_out);
  P.d_tri = static_cast<float*>(dtri_out);
  const DiffKernel k = bounces == 1 ? diff_kernel<1> : bounces == 2 ? diff_kernel<2>
                       : bounces == 3 ? diff_kernel<3> : diff_kernel<4>;
  err = allow_stack_smem(k, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  k<<<((width + 7) / 8 * ((height + 3) / 4) + kWarps - 1) / kWarps, kBlock, smem, st>>>(P);
  return static_cast<int>(cudaGetLastError());
}

#ifdef FYP_DIFF_CLOCKS
// The cycles of each section (Section) summed over every thread of every
// launch since the last call, as kSections unsigned 64-bit ints copied to
// sums_out, and the first n_blocks blocks' starts and ends in nanoseconds,
// as (2, n_blocks) unsigned 64-bit ints copied to spans_out (both on the
// card); then both cleared, on the stream.
extern "C" int fyp_diff_clocks(void* sums_out, void* spans_out, int n_blocks, void* stream) {
  void* sums = nullptr;
  void* spans = nullptr;
  cudaError_t e = cudaGetSymbolAddress(&sums, diff_clocks);
  if (e == cudaSuccess) e = cudaGetSymbolAddress(&spans, diff_spans);
  if (e == cudaSuccess)
    e = read_clocks(static_cast<unsigned long long*>(sums), kSections, static_cast<BlockSpans*>(spans), sums_out,
                    spans_out, n_blocks, static_cast<cudaStream_t>(stream));
  return static_cast<int>(e);
}
#endif
