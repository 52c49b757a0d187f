// The vector helpers and the triangle fetch that every walk and frame kernel
// shares, and the hit record.
//
// The port's walks are those of the 4-wide BVH (wide.cuh), which K1-K8 walk;
// the threaded BVH's stackless walk, the reference's own per-ray walk
// (Renderer.cu:460-561) and the first design of K1 and K2, is now the plain
// PyTorch walk alone (ops/traverse.py::trace_rays), which the kernels are
// held against.  Of hits at exactly the same t the lowest triangle id wins,
// as in the TPU kernel (pallas_dense.py:65-70), so the answer does not
// depend on walk order; the inverse direction is clamped away from zero with
// its sign kept, so 0 * inf never poisons the slab test.
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

struct Tris {
  const float* positions;  // (V, 3)
  const int* tri_v;        // (T, 3)
};

struct Hit {
  int tri;   // -1 on a miss
  float t;   // -1 on a miss
  float u, v;
};

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

}  // namespace fyp
