// Closest-hit traversal of the threaded BVH, one thread per ray, and the
// vector helpers and triangle test every walk shares.
//
// trace_closest is the walk of trace.cu's trace_threaded_kernel and of K2
// NEE's threaded instantiation (megakernel.cu), kept for an A/B beside the
// wide BVH of wide.cuh, which K1-K8 walk.  It replaces the TPU's dense ray x
// triangle tile sweep (fypraytracer_tpu/ops/pallas_dense.py::_intersect_kernel) with the
// reference's own per-ray walk (Renderer.cu:460-561), in the stackless
// form of fypraytracer_tpu/ops/traverse.py:75-113:
//   * nodes are in preorder; an inner node whose box is hit falls through
//     to i+1, any other node jumps to miss[i]; miss == n_nodes ends it;
//   * a leaf holds leaf_size slots of prim_idx, padded with -1, each tested
//     with Moller-Trumbore (t > T_EPSILON, t < t_best);
//   * of hits at exactly the same t the lowest triangle id wins, as in the
//     TPU kernel (pallas_dense.py:65-70), so the answer does not depend on
//     walk order; boxes entered exactly at t_best are still visited;
//   * the inverse direction is clamped away from zero with its sign kept,
//     so 0 * inf never poisons the slab test.
//
// What bounds it on an H100: chains of dependent global loads (node ->
// child -> triangle -> vertices) and warp divergence, since the 32 rays of
// a warp walk different paths.  What this first version does about it:
// SoA arrays read through __ldg (the read-only path), and a scene small
// enough to stay resident in L1/L2 (the Cornell box is ~70 KB of nodes,
// indices and vertices).  Packing nodes into 32-byte records, a wide BVH,
// and sorting rays by direction are left to later work.
//
// Floating point: no fast-math (sqrt and division stay IEEE).  The hit and
// slab tests use the non-contracting intrinsics __fmul_rn/__fadd_rn, in
// the plain PyTorch version's operation order (core/mathutils.py::dot3,
// cross3), so a triangle hit and an exact tie on a shared edge are decided
// bit for bit as the plain version decides them.  Scalar shading code in
// shading.cuh may still be FMA-contracted.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fyp {

constexpr float kTEpsilon = 1.0e-4f;    // Renderer.cu:531
constexpr float kDetEpsilon = 1.0e-12f;
constexpr float kBig = 3.0e38f;

// Vector helpers.  Products use __fmul_rn, which the compiler never fuses
// into an FMA, and dot/cross sum in the plain version's order, so vector
// arithmetic rounds exactly as PyTorch's elementwise ops do.
__device__ __forceinline__ float3 operator+(float3 a, float3 b) { return make_float3(a.x + b.x, a.y + b.y, a.z + b.z); }
__device__ __forceinline__ float3 operator-(float3 a, float3 b) { return make_float3(a.x - b.x, a.y - b.y, a.z - b.z); }
__device__ __forceinline__ float3 operator-(float3 a) { return make_float3(-a.x, -a.y, -a.z); }
__device__ __forceinline__ float3 operator*(float3 a, float3 b) {
  return make_float3(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y), __fmul_rn(a.z, b.z));
}
__device__ __forceinline__ float3 operator*(float3 a, float s) {
  return make_float3(__fmul_rn(a.x, s), __fmul_rn(a.y, s), __fmul_rn(a.z, s));
}
__device__ __forceinline__ float3 operator*(float s, float3 a) { return a * s; }
__device__ __forceinline__ float3 operator/(float3 a, float s) { return make_float3(a.x / s, a.y / s, a.z / s); }

// ((x + y) + z), as core/mathutils.py::dot3
__device__ __forceinline__ float dot(float3 a, float3 b) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y)), __fmul_rn(a.z, b.z));
}

__device__ __forceinline__ float3 cross(float3 a, float3 b) {
  return make_float3(__fsub_rn(__fmul_rn(a.y, b.z), __fmul_rn(a.z, b.y)),
                     __fsub_rn(__fmul_rn(a.z, b.x), __fmul_rn(a.x, b.z)),
                     __fsub_rn(__fmul_rn(a.x, b.y), __fmul_rn(a.y, b.x)));
}

// v / sqrt(max(|v|^2, 1e-20)), as core/mathutils.py::normalize
__device__ __forceinline__ float3 normalize(float3 v) { return v / sqrtf(fmaxf(dot(v, v), 1e-20f)); }

__device__ __forceinline__ float3 ldg3(const float* p, int i) {
  return make_float3(__ldg(p + 3 * i), __ldg(p + 3 * i + 1), __ldg(p + 3 * i + 2));
}

struct Bvh {
  const float* lo;        // (N, 3)
  const float* hi;        // (N, 3)
  const int* miss;        // (N,)
  const int* first;       // (N,)  -1 = inner node
  const int* prim_idx;    // (P,)  -1 = padding slot
  int n_nodes;
  int leaf_size;
};

struct Tris {
  const float* positions;  // (V, 3)
  const int* tri_v;        // (T, 3)
};

struct Hit {
  int tri;   // -1 on a miss
  float t;   // -1 on a miss
  float u, v;
};

// ops/intersect.py::moller_trumbore, uncontracted
__device__ __forceinline__ bool moller_trumbore(float3 o, float3 d, float3 p0, float3 p1, float3 p2,
                                                float& t, float& u, float& v) {
  float3 e1 = p1 - p0;
  float3 e2 = p2 - p0;
  float3 pvec = cross(d, e2);
  float det = dot(e1, pvec);
  bool valid = fabsf(det) > kDetEpsilon;
  float inv_det = 1.0f / (valid ? det : 1.0f);
  float3 tvec = o - p0;
  u = __fmul_rn(dot(tvec, pvec), inv_det);
  float3 qvec = cross(tvec, e1);
  v = __fmul_rn(dot(d, qvec), inv_det);
  t = __fmul_rn(dot(e2, qvec), inv_det);
  return valid && u >= 0.0f && v >= 0.0f && __fadd_rn(u, v) <= 1.0f && t > kTEpsilon;
}

__device__ __forceinline__ float safe_inv(float d) {
  float ds = fabsf(d) < 1e-20f ? (d < 0.0f ? -1e-20f : 1e-20f) : d;
  return 1.0f / ds;
}

__device__ __forceinline__ void triangle(const Tris& tris, int id, float3& p0, float3& p1, float3& p2) {
  int a = __ldg(tris.tri_v + 3 * id), b = __ldg(tris.tri_v + 3 * id + 1), c = __ldg(tris.tri_v + 3 * id + 2);
  p0 = ldg3(tris.positions, a);
  p1 = ldg3(tris.positions, b);
  p2 = ldg3(tris.positions, c);
}

// Closest hit with t in (T_EPSILON, t_max), ties to the lowest id;
// ops/traverse.py::trace_rays.
__device__ inline Hit trace_closest(const Bvh& bvh, const Tris& tris, float3 o, float3 d, float t_max) {
  float3 inv = make_float3(safe_inv(d.x), safe_inv(d.y), safe_inv(d.z));
  Hit h;
  h.tri = -1;
  h.t = t_max;
  h.u = 0.0f;
  h.v = 0.0f;
  int node = 0;
  while (node < bvh.n_nodes) {
    float3 lo = ldg3(bvh.lo, node);
    float3 hi = ldg3(bvh.hi, node);
    float t0x = __fmul_rn(lo.x - o.x, inv.x), t1x = __fmul_rn(hi.x - o.x, inv.x);
    float t0y = __fmul_rn(lo.y - o.y, inv.y), t1y = __fmul_rn(hi.y - o.y, inv.y);
    float t0z = __fmul_rn(lo.z - o.z, inv.z), t1z = __fmul_rn(hi.z - o.z, inv.z);
    float tmin = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
    float tmax = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
    bool hit_box = tmax >= fmaxf(tmin, 0.0f) && tmin <= h.t;
    int first = __ldg(bvh.first + node);
    if (hit_box && first < 0) {
      node += 1;
      continue;
    }
    if (hit_box) {
      for (int k = 0; k < bvh.leaf_size; ++k) {
        int id = __ldg(bvh.prim_idx + first + k);
        if (id < 0) continue;
        float3 p0, p1, p2;
        triangle(tris, id, p0, p1, p2);
        float t, u, v;
        if (moller_trumbore(o, d, p0, p1, p2, t, u, v) && (t < h.t || (t == h.t && id < h.tri))) {
          h.tri = id;
          h.t = t;
          h.u = u;
          h.v = v;
        }
      }
    }
    node = __ldg(bvh.miss + node);
  }
  if (h.tri < 0) h.t = -1.0f;
  return h;
}

}  // namespace fyp
