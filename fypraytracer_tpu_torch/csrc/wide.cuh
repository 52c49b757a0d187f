// Closest-hit traversal of the 4-wide BVH: by a quad of lanes, or by one thread.
//
// Device code of K1 (trace.cu) and K2 (megakernel.cu).  It replaces, for
// them, the threaded walk of traverse.cuh::trace_closest, which K3-K8 keep.
// The records are built on the host by accel/wide.py (scene/types.py::
// WideBVH): a node is 8 float4, child k's (lo.xyz, hi.x) at k and its
// (hi.yz, ref, 0) at 4 + k, so lane k of a quad fetches its child with two
// 16-byte loads and the four lanes read 64 adjacent bytes each time; a
// triangle is 3 float4 in leaf-slot order, (p0, id), (e1, 0), (e2, 0).
//
// trace_closest_wide: the walk of one ray by a quad (lanes 4q .. 4q + 3):
//   * inner node: lane k tests child k's box with traverse.cuh's slab test
//     (__fmul_rn, entered at t <= t_best counts); the quad ranks the hit
//     children by entry t (ties to the lower child) with four shuffles,
//     takes the nearest next and pushes the others, farthest first, onto
//     the quad's stack in shared memory;
//   * leaf: lane k tests slot k with traverse.cuh's uncontracted
//     Moller-Trumbore on the stored edges, and the quad keeps the least
//     (t, id) by two xor shuffles, so an exact tie goes to the lowest id;
//   * pop: an entry whose entry t is no longer <= t_best is skipped.
// Every value that steers the walk is the same in the quad's four lanes, so
// the quad stays converged; its shuffles use the quad's own mask, since the
// other quads of the warp walk other rays.
// trace_closest_wide1: the same visits in the same order by one thread,
// which tests the four children itself.  Both give the closest hit with ties
// to the lowest id, as the threaded walk finds it (ops/traverse.py::
// trace_rays_wide is this walk in PyTorch).
//
// The stack lives in dynamic shared memory, stack_depth entries a quad (or a
// thread, for the one-thread walk), 8 bytes an entry; the wrappers pass the
// tree's own need (accel/wide.py, WideBVH.stack_need) and refuse a tree whose
// stacks would not fit in a block's shared memory (accel/wide.py::MAX_STACK);
// a launch above the default 48 KB opts in (allow_stack_smem).  Should a push
// still not fit, the entry is dropped and *overflow is set to 1, which
// ops/traverse.py::check_overflow reads: the walk never truncates silently.
//
// What bounds it on an H100: the latency of dependent loads.  Against the
// threaded walk a Cornell camera ray makes 3.6 node visits and 1.2 leaf
// visits instead of 18.4 and 4.1, each visit loads its whole node (two
// 16-byte loads a lane, or eight for one thread), and a leaf reaches its
// triangles in one hop.  The quad puts four threads on a ray, which pays
// while a batch's quads fit on the card at once; past that its shuffles and
// ballots cost more than they hide, and one thread a ray is faster (K1
// chooses by batch size, ops/traverse.py::k1_lanes; K2 runs one thread a
// ray, PERF.md Findings).
#pragma once

#include "traverse.cuh"

namespace fyp {

constexpr int kEmpty = -1;  // accel/wide.py::EMPTY

struct WideBvh {
  const float4* nodes;  // (Nw, 8)
  const float4* tris;   // (S, 3)
  int* overflow;        // set to 1 when a stack would overflow
  int stack_depth;      // entries of a stack: the tree's stack_need, at least 1
};

// The walks' stacks: all entry t first, then all refs (8 bytes an entry).
extern __shared__ float wide_stack[];

// Bytes of dynamic shared memory for the stacks of n_stacks walks.
inline size_t wide_stack_bytes(int n_stacks, int depth) { return 8u * static_cast<size_t>(n_stacks) * depth; }

// Let kernel launch with smem bytes of dynamic shared memory: above the 48 KB
// a block gets by default it must opt in, up to what the card allows (227 KB
// on an H100); past that the runtime refuses.
template <class Kernel>
inline cudaError_t allow_stack_smem(Kernel kernel, size_t smem) {
  if (smem <= 48u * 1024u) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
}

// The quad of lanes that walks one ray, and its stack.
struct Quad {
  int lane;       // 0..3 within the quad
  int base;       // the warp lane of the quad's lane 0
  unsigned mask;  // the quad's four bits of the warp
  float* st_t;    // the stack: entry t of each entry
  int* st_ref;    // and its node or leaf ref
};

// The quad of this thread; a block's threads are whole quads, and quad q of
// the block owns entries [q * depth, (q + 1) * depth) of the stacks.
__device__ __forceinline__ Quad make_quad(int depth) {
  Quad q;
  const int wl = threadIdx.x & 31;
  q.lane = wl & 3;
  q.base = wl & ~3;
  q.mask = 0xFu << q.base;
  const int n_quads = blockDim.x >> 2;
  q.st_t = wide_stack + (threadIdx.x >> 2) * depth;
  q.st_ref = reinterpret_cast<int*>(wide_stack + n_quads * depth) + (threadIdx.x >> 2) * depth;
  return q;
}

// The stack of one thread's walk: entry i at i * stride, threads side by side
// so that a warp's pushes and pops fall in distinct banks.
struct LaneStack {
  float* t;
  int* ref;
  int stride;
};

__device__ __forceinline__ LaneStack lane_stack(int depth) {
  const int n = blockDim.x;
  return LaneStack{wide_stack + threadIdx.x, reinterpret_cast<int*>(wide_stack + n * depth) + threadIdx.x, n};
}

__device__ __forceinline__ unsigned quad_ballot(const Quad& q, bool pred) {
  return (__ballot_sync(q.mask, pred) >> q.base) & 0xFu;
}

// traverse.cuh::moller_trumbore given the edges e1 = p1 - p0, e2 = p2 - p0
__device__ __forceinline__ bool moller_trumbore_edges(float3 o, float3 d, float3 p0, float3 e1, float3 e2,
                                                      float& t, float& u, float& v) {
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

// Closest hit with t in (T_EPSILON, t_max), ties to the lowest id, walked by
// the quad q; every lane of the quad calls it with the same ray and gets the
// same hit.  ops/traverse.py::trace_rays_wide.
__device__ __forceinline__ Hit trace_closest_wide(const WideBvh& w, const Quad& q, float3 o, float3 d,
                                                  float t_max) {
  const float3 inv = make_float3(safe_inv(d.x), safe_inv(d.y), safe_inv(d.z));
  Hit h;
  h.tri = -1;
  h.t = t_max;
  h.u = 0.0f;
  h.v = 0.0f;
  int cur = 0;  // the root, an inner node
  int sp = 0;
  while (true) {
    if (cur >= 0) {
      const float4 a = __ldg(w.nodes + 8 * cur + q.lane);
      const float4 b = __ldg(w.nodes + 8 * cur + 4 + q.lane);
      const int ref = __float_as_int(b.z);
      const float t0x = __fmul_rn(a.x - o.x, inv.x), t1x = __fmul_rn(a.w - o.x, inv.x);
      const float t0y = __fmul_rn(a.y - o.y, inv.y), t1y = __fmul_rn(b.x - o.y, inv.y);
      const float t0z = __fmul_rn(a.z - o.z, inv.z), t1z = __fmul_rn(b.y - o.z, inv.z);
      const float tmin = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
      const float tmax = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
      const bool hit = ref != kEmpty && tmax >= fmaxf(tmin, 0.0f) && tmin <= h.t;
      const unsigned hits = quad_ballot(q, hit);
      if (hits != 0u) {
        // rank among the hit children: nearer entry first, ties to the lower child
        int rank = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float tj = __shfl_sync(q.mask, tmin, j, 4);
          rank += ((hits >> j) & 1u) && (tj < tmin || (tj == tmin && j < q.lane));
        }
        const int n_hit = __popc(hits);
        if (hit && rank > 0) {
          const int slot = sp + n_hit - 1 - rank;  // the farthest lies deepest
          if (slot < w.stack_depth) {
            q.st_ref[slot] = ref;
            q.st_t[slot] = tmin;
          } else {
            *w.overflow = 1;
          }
        }
        sp = min(sp + n_hit - 1, w.stack_depth);
        const int nearest = __ffs(quad_ballot(q, hit && rank == 0)) - 1;
        cur = __shfl_sync(q.mask, ref, nearest, 4);
        __syncwarp(q.mask);  // the pushes are seen by every lane's pops
        continue;
      }
    } else {
      // a leaf: lane k tests slot k
      const int s = 4 * (-cur - 2) + q.lane;
      const float4 p0 = __ldg(w.tris + 3 * s);
      const float4 e1 = __ldg(w.tris + 3 * s + 1);
      const float4 e2 = __ldg(w.tris + 3 * s + 2);
      const int id = __float_as_int(p0.w);
      float t = 0.0f, u = 0.0f, v = 0.0f;
      const bool ok = id >= 0 && moller_trumbore_edges(o, d, make_float3(p0.x, p0.y, p0.z),
                                                       make_float3(e1.x, e1.y, e1.z),
                                                       make_float3(e2.x, e2.y, e2.z), t, u, v);
      int kid = ok ? id : 0x7fffffff;
      float kt = ok ? t : kBig;
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float ot = __shfl_xor_sync(q.mask, kt, off, 4);
        const int oid = __shfl_xor_sync(q.mask, kid, off, 4);
        const float ou = __shfl_xor_sync(q.mask, u, off, 4);
        const float ov = __shfl_xor_sync(q.mask, v, off, 4);
        if (ot < kt || (ot == kt && oid < kid)) {
          kt = ot;
          kid = oid;
          u = ou;
          v = ov;
        }
      }
      if (kid != 0x7fffffff && (kt < h.t || (kt == h.t && kid < h.tri))) {
        h.tri = kid;
        h.t = kt;
        h.u = u;
        h.v = v;
      }
    }
    // pop the nearest entry still in reach
    cur = kEmpty;
    while (sp > 0) {
      --sp;
      const float te = q.st_t[sp];
      if (te <= h.t) {
        cur = q.st_ref[sp];
        break;
      }
    }
    if (cur == kEmpty) break;
  }
  if (h.tri < 0) h.t = -1.0f;
  return h;
}

// The same walk by one thread: it tests the four children itself and orders
// the hit ones by an odd-even transposition of four (stable: ties keep the
// child order).  Same visits, same result; no shuffles and one thread a ray.
__device__ __forceinline__ Hit trace_closest_wide1(const WideBvh& w, const LaneStack& st, float3 o, float3 d,
                                                   float t_max) {
  const float3 inv = make_float3(safe_inv(d.x), safe_inv(d.y), safe_inv(d.z));
  Hit h;
  h.tri = -1;
  h.t = t_max;
  h.u = 0.0f;
  h.v = 0.0f;
  int cur = 0;
  int sp = 0;
  while (true) {
    if (cur >= 0) {
      float key[4];
      int ref[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float4 a = __ldg(w.nodes + 8 * cur + k);
        const float4 b = __ldg(w.nodes + 8 * cur + 4 + k);
        ref[k] = __float_as_int(b.z);
        const float t0x = __fmul_rn(a.x - o.x, inv.x), t1x = __fmul_rn(a.w - o.x, inv.x);
        const float t0y = __fmul_rn(a.y - o.y, inv.y), t1y = __fmul_rn(b.x - o.y, inv.y);
        const float t0z = __fmul_rn(a.z - o.z, inv.z), t1z = __fmul_rn(b.y - o.z, inv.z);
        const float tmin = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
        const float tmax = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
        const bool hit = ref[k] != kEmpty && tmax >= fmaxf(tmin, 0.0f) && tmin <= h.t;
        key[k] = hit ? tmin : kBig;
        if (!hit) ref[k] = kEmpty;
      }
      // a stable sort of four: nearer first, ties keep the child order
      auto cswap = [&](int i, int j) {
        if (key[j] < key[i]) {
          const float tk = key[i];
          key[i] = key[j];
          key[j] = tk;
          const int tr = ref[i];
          ref[i] = ref[j];
          ref[j] = tr;
        }
      };
      cswap(0, 1);
      cswap(2, 3);
      cswap(1, 2);
      cswap(0, 1);
      cswap(2, 3);
      cswap(1, 2);
      const int n_hit = (ref[0] != kEmpty) + (ref[1] != kEmpty) + (ref[2] != kEmpty) + (ref[3] != kEmpty);
      if (n_hit > 0) {
#pragma unroll
        for (int r = 3; r >= 1; --r) {
          if (r < n_hit) {
            if (sp < w.stack_depth) {
              st.t[sp * st.stride] = key[r];
              st.ref[sp * st.stride] = ref[r];
              ++sp;
            } else {
              *w.overflow = 1;
            }
          }
        }
        cur = ref[0];
        continue;
      }
    } else {
      const int s0 = 4 * (-cur - 2);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float4 p0 = __ldg(w.tris + 3 * (s0 + k));
        const int id = __float_as_int(p0.w);
        if (id < 0) continue;
        const float4 e1 = __ldg(w.tris + 3 * (s0 + k) + 1);
        const float4 e2 = __ldg(w.tris + 3 * (s0 + k) + 2);
        float t, u, v;
        if (moller_trumbore_edges(o, d, make_float3(p0.x, p0.y, p0.z), make_float3(e1.x, e1.y, e1.z),
                                  make_float3(e2.x, e2.y, e2.z), t, u, v) &&
            (t < h.t || (t == h.t && id < h.tri))) {
          h.tri = id;
          h.t = t;
          h.u = u;
          h.v = v;
        }
      }
    }
    cur = kEmpty;
    while (sp > 0) {
      --sp;
      if (st.t[sp * st.stride] <= h.t) {
        cur = st.ref[sp * st.stride];
        break;
      }
    }
    if (cur == kEmpty) break;
  }
  if (h.tri < 0) h.t = -1.0f;
  return h;
}

}  // namespace fyp
