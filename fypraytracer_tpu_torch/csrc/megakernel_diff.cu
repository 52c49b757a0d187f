// megakernel_diff: the loss of one cosine-sampled frame against a target and
// its gradient with respect to per-triangle albedo, in one launch (K8).
//
// Replaces the TPU kernel fypraytracer_tpu/render/megakernel_diff.py::
// make_diff_megakernel -> kernel (:117, launched at :241).  One thread owns
// one pixel (128-thread blocks, as K2):
//   * forward: K2's cosine path for one frame and one sample (camera_ray,
//     trace_closest, surface, cosine_dir), keys fold(fold(fold(pcg(pix),
//     frame), 0), 0) (megakernel_diff.py:144-147); NL = bounces scatter
//     levels, level j scattering at the primary hit (j = 0) or at the hit of
//     level j-1's trace.  Each level keeps its throughput factor g_c = f_c *
//     cos / pdf, dg_c = df_c/dalb_c * cos / pdf, its surface's triangle id and
//     its radiance contribution in registers (at most 4 levels).  A primary
//     miss outputs the sky, an emissive primary hit its emission; both, and
//     a level whose pdf <= 0, carry no gradient.  The BRDF and its albedo
//     derivative are the JAX kernel's own _f_and_dfdalb (:67-96), term for
//     term, not shading.cuh's cook_torrance (another operation order);
//   * loss: sum over pixels and channels of (r_c - tgt_c)^2 / (3B), summed by
//     warp shuffles, then over the block's 4 warps in shared memory, then one
//     atomicAdd a block into one float;
//   * reverse scan (:215-225): over the levels in reverse, suffix_c +=
//     contrib_c(level) before use, gsel_c = a_c * suffix_c * dg_c / g_c where
//     g_c > 0 (a_c = 2 err_c / (3B)), added into d_tri[tri * 3 + c].  The TPU
//     kernel forms a one-hot (T, C) product on the MXU instead.
//
// What bounds it on an H100: the BVH walks (1 + bounces traces a pixel, as
// K2's cosine frame) and, after them, atomics on a few triangles: the
// Cornell walls are 2 triangles each, and most of the 65,536 pixels x 2
// levels land on them.  The design against that contention: where the 32
// lanes of a warp hold one triangle id at a level, the warp sums its
// gradient by shuffles and one lane adds it (3 atomics instead of 96);
// otherwise each lane adds its own.  Float atomics sum in an order that
// changes between runs.
//
// Built with -fmad=false (ops/kernels.py::EXTRA_FLAGS), so that no product
// is fused into a sum and every expression rounds as in the plain PyTorch
// version (render/megakernel_diff.py::diff_plain).
//
// C interface (loaded with ctypes by render/megakernel_diff.py::
// diff_megakernel): zeroes the loss and d_tri (T, 3) on the stream, launches,
// and returns cudaGetLastError() (cudaErrorInvalidValue for bounces outside
// 1-4).
#include "shading.cuh"

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
  Bvh bvh;
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

template <int NL>
__global__ void __launch_bounds__(kBlock) diff_kernel(Params P) {
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  const int n_pix = P.width * P.height;
  const float inv_n = 1.0f / static_cast<float>(3 * n_pix);

  // per level: g, dg, contribution, triangle (-1: no gradient)
  float g[NL][3], dg[NL][3], ct[NL][3];
  int tri[NL];
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    tri[j] = -1;
#pragma unroll
    for (int i = 0; i < 3; ++i) g[j][i] = dg[j][i] = ct[j][i] = 0.0f;
  }

  // ---- forward; every thread of the block stays to the end (warp sums)
  float3 out = make_float3(0.0f, 0.0f, 0.0f), tgt = out;
  if (pix < n_pix) {
    Tris tris{P.geo.positions, P.geo.tri_v};
    float3 orig, dir;
    camera_ray(P.cam, P.width, P.height, pix, orig, dir);
    tgt = ldg3(P.target, pix);
    const Hit h0 = trace_closest(P.bvh, tris, orig, dir, kBig);
    Surf s;
    float3 em0 = out;
    if (h0.tri >= 0) {
      s = surface(P.geo, P.mats, h0, orig, dir);
      em0 = emission_of(P.mats, s.mat);
    }
    if (h0.tri < 0) {
      out = P.sky;
    } else if (dot(em0, em0) > 0.0f) {
      out = em0;
    } else {
      uint32_t key = fold(fold(fold(pcg(static_cast<uint32_t>(pix)), P.frame), 0u), 0u);
      float3 thr = make_float3(1.0f, 1.0f, 1.0f);
      float3 view = -dir;
      int lvl_tri = h0.tri;
#pragma unroll
      for (int j = 0; j < NL; ++j) {
        const float u1 = next_uniform(key);
        const float u2 = next_uniform(key);
        const float3 l = cosine_dir(s.n, u1, u2);
        const float cos_t = fmaxf(dot(l, s.n), 0.0f);
        const float pdf = cos_t * kInvPi;
        if (!(pdf > 0.0f)) break;
        float f[3], df[3];
        f_and_dfdalb(s.n, view, l, s.alb, s.rough, s.metal, f, df);
        const float scale = cos_t / pdf;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          g[j][i] = f[i] * scale;
          dg[j][i] = df[i] * scale;
        }
        tri[j] = lvl_tri;
        thr = thr * make_float3(g[j][0], g[j][1], g[j][2]);

        const float3 ray_o = s.pos + s.n * kOriginEps;
        const Hit hh = trace_closest(P.bvh, tris, ray_o, l, kBig);
        float3 c = make_float3(0.0f, 0.0f, 0.0f);
        bool ends = true;
        Surf nxt;
        if (hh.tri < 0) {
          c = thr * P.sky;
        } else {
          nxt = surface(P.geo, P.mats, hh, ray_o, l);
          const float3 em = emission_of(P.mats, nxt.mat);
          if (dot(em, em) > 0.0f) c = thr * em;
          else ends = false;
        }
        ct[j][0] = c.x;
        ct[j][1] = c.y;
        ct[j][2] = c.z;
        out = out + c;
        if (ends) break;
        view = -l;
        lvl_tri = hh.tri;
        s = nxt;
      }
    }
  }

  // ---- loss: warp shuffles, the block's warps in shared memory, one atomic
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

  // ---- reverse scan over the levels, gradient into d_tri
  float adj[3], suffix[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 3; ++i) adj[i] = 2.0f * e[i] / static_cast<float>(3 * n_pix);
#pragma unroll
  for (int j = NL - 1; j >= 0; --j) {
    float gs[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      suffix[i] = suffix[i] + ct[j][i];
      gs[i] = g[j][i] > 0.0f ? adj[i] * suffix[i] * dg[j][i] / g[j][i] : 0.0f;
    }
    const int t = tri[j];
    const int t_lane0 = __shfl_sync(kFull, t, 0);
    if (__all_sync(kFull, t == t_lane0)) {
      // the whole warp on one triangle: one sum and one atomic a channel
#pragma unroll
      for (int i = 0; i < 3; ++i) gs[i] = warp_sum(gs[i]);
      if (lane == 0 && t >= 0) {
#pragma unroll
        for (int i = 0; i < 3; ++i)
          if (gs[i] != 0.0f) atomicAdd(P.d_tri + 3 * t + i, gs[i]);
      }
    } else if (t >= 0) {
#pragma unroll
      for (int i = 0; i < 3; ++i)
        if (gs[i] != 0.0f) atomicAdd(P.d_tri + 3 * t + i, gs[i]);
    }
  }
}

}  // namespace

extern "C" int fyp_diff_megakernel(
    const void* cam, int width, int height, unsigned int frame, int bounces, float sky_r, float sky_g,
    float sky_b, const void* positions, const void* normals, const void* tri_v, const void* tri_mat, int n_tris,
    const void* albedo, const void* roughness, const void* metallic, const void* emission,
    const void* bvh_lo, const void* bvh_hi, const void* bvh_miss, const void* bvh_first,
    const void* bvh_prim_idx, int n_nodes, int leaf_size,
    const void* target, void* loss_out, void* dtri_out, void* stream) {
  if (bounces < 1 || bounces > 4) return static_cast<int>(cudaErrorInvalidValue);
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
  P.bvh = Bvh{F(bvh_lo), F(bvh_hi), I(bvh_miss), I(bvh_first), I(bvh_prim_idx), n_nodes, leaf_size};
  P.target = F(target);
  P.loss = static_cast<float*>(loss_out);
  P.d_tri = static_cast<float*>(dtri_out);
  const int grid = (n_pix + kBlock - 1) / kBlock;
  switch (bounces) {
    case 1: diff_kernel<1><<<grid, kBlock, 0, st>>>(P); break;
    case 2: diff_kernel<2><<<grid, kBlock, 0, st>>>(P); break;
    case 3: diff_kernel<3><<<grid, kBlock, 0, st>>>(P); break;
    default: diff_kernel<4><<<grid, kBlock, 0, st>>>(P); break;
  }
  return static_cast<int>(cudaGetLastError());
}
