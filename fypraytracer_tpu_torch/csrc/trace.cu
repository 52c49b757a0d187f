// trace_closest: closest hit of a ray batch against the scene's BVH (K1).
//
// Replaces the TPU kernel fypraytracer_tpu/ops/pallas_dense.py::_intersect_kernel
// (launched by _pallas_trace at :100), which computes the same closest hit by
// a dense sweep of 256-ray x 512-triangle tiles through the MXU.  The sweep was
// the TPU's answer to its gather cost (ops/dense.py:1-18); on Hopper each ray
// walks the 4-wide BVH (wide.cuh): a quad of four threads a ray while the
// batch's quads fit on the card at once (65,536 rays: 262,144 threads), one
// thread a ray for a larger batch (the caller's lanes argument,
// ops/traverse.py::k1_lanes).  The walks, what bounds them and what this
// design does about it are described in wide.cuh.
//
// C interface (loaded with ctypes by ops/traverse.py::trace_closest): each
// entry returns cudaGetLastError() after the launch; the launch is
// asynchronous on the given stream and allocates nothing.
//   fyp_trace_closest          the wide walks (K1), lanes 4 or 1;
//   fyp_segment_visible        wide.cuh::segment_visible_wide1 (the segment
//                              test of K5's walks), one thread a segment, so
//                              that it can be held against its plain version
//                              (ops/traverse.py::trace_segments).
#include "wide.cuh"

namespace {

constexpr int kBlock = 128;  // threads: 32 quads, or 128 rays

__global__ void __launch_bounds__(kBlock) trace_closest_kernel(fyp::WideBvh w, const float* __restrict__ origins,
                                                               const float* __restrict__ directions,
                                                               const float* __restrict__ t_max, int n_rays,
                                                               int* __restrict__ out_tri, float* __restrict__ out_t,
                                                               float* __restrict__ out_u, float* __restrict__ out_v) {
  const int i = (blockIdx.x * kBlock + threadIdx.x) >> 2;
  if (i >= n_rays) return;  // the quads of the ragged edge leave whole
  const fyp::Quad q = fyp::make_quad(w.stack_depth);
  const float3 o = fyp::ldg3(origins, i);
  const float3 d = fyp::ldg3(directions, i);
  const float tm = t_max ? __ldg(t_max + i) : fyp::kBig;
  const fyp::Hit h = fyp::trace_closest_wide(w, q, o, d, tm);
  if (q.lane == 0) {
    out_tri[i] = h.tri;
    out_t[i] = h.t;
    out_u[i] = h.u;
    out_v[i] = h.v;
  }
}

__global__ void __launch_bounds__(kBlock) trace_lane_kernel(fyp::WideBvh w, const float* __restrict__ origins,
                                                            const float* __restrict__ directions,
                                                            const float* __restrict__ t_max, int n_rays,
                                                            int* __restrict__ out_tri, float* __restrict__ out_t,
                                                            float* __restrict__ out_u, float* __restrict__ out_v) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n_rays) return;
  const float3 o = fyp::ldg3(origins, i);
  const float3 d = fyp::ldg3(directions, i);
  const float tm = t_max ? __ldg(t_max + i) : fyp::kBig;
  const fyp::Hit h = fyp::trace_closest_wide1(w, fyp::lane_stack(w.stack_depth), o, d, tm);
  out_tri[i] = h.tri;
  out_t[i] = h.t;
  out_u[i] = h.u;
  out_v[i] = h.v;
}

__global__ void __launch_bounds__(kBlock) segment_kernel(fyp::WideBvh w, const float* __restrict__ origins,
                                                         const float* __restrict__ directions,
                                                         const float* __restrict__ dist, int n,
                                                         int* __restrict__ out) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  out[i] = fyp::segment_visible_wide1(w, fyp::lane_stack(w.stack_depth), fyp::ldg3(origins, i),
                                      fyp::ldg3(directions, i), __ldg(dist + i));
}

}  // namespace

extern "C" int fyp_trace_closest(const void* nodes, const void* tris, void* overflow, const void* origins,
                                 const void* directions, const void* t_max, int n_rays, void* out_tri,
                                 void* out_t, void* out_u, void* out_v, int lanes, int stack_depth,
                                 void* stream) {
  if (n_rays <= 0) return 0;
  if (stack_depth < 1 || (lanes != 4 && lanes != 1)) return static_cast<int>(cudaErrorInvalidValue);
  const fyp::WideBvh w{static_cast<const float4*>(nodes), static_cast<const float4*>(tris),
                       static_cast<int*>(overflow), stack_depth};
  // a quad a ray: 32 rays and 32 stacks a block; one thread a ray: 128 of each
  auto kernel = lanes == 4 ? trace_closest_kernel : trace_lane_kernel;
  const size_t smem = fyp::wide_stack_bytes(kBlock / lanes, stack_depth);
  const cudaError_t e = fyp::allow_stack_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid = static_cast<int>((static_cast<long long>(lanes) * n_rays + kBlock - 1) / kBlock);
  kernel<<<grid, kBlock, smem, static_cast<cudaStream_t>(stream)>>>(
      w, static_cast<const float*>(origins), static_cast<const float*>(directions),
      static_cast<const float*>(t_max), n_rays, static_cast<int*>(out_tri), static_cast<float*>(out_t),
      static_cast<float*>(out_u), static_cast<float*>(out_v));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fyp_segment_visible(const void* nodes, const void* tris, void* overflow, const void* origins,
                                   const void* directions, const void* dist, int n, void* out, int stack_depth,
                                   void* stream) {
  if (n <= 0) return 0;
  if (stack_depth < 1) return static_cast<int>(cudaErrorInvalidValue);
  const fyp::WideBvh w{static_cast<const float4*>(nodes), static_cast<const float4*>(tris),
                       static_cast<int*>(overflow), stack_depth};
  const size_t smem = fyp::wide_stack_bytes(kBlock, stack_depth);
  const cudaError_t e = fyp::allow_stack_smem(segment_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  segment_kernel<<<(n + kBlock - 1) / kBlock, kBlock, smem, static_cast<cudaStream_t>(stream)>>>(
      w, static_cast<const float*>(origins), static_cast<const float*>(directions), static_cast<const float*>(dist),
      n, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
