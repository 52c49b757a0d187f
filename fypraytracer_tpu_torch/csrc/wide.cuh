// Traversal of the 4-wide BVH: the closest hit by a quad of lanes or by one
// thread, and the segment test by one thread.
//
// Device code of K1 (trace.cu), K2 (megakernel.cu), K3 and K4 (restir_di.cu),
// K5-K7 (restir_gi.cu) and K8 (megakernel_diff.cu).  It replaces, for them,
// the stackless walk of the threaded binary BVH, which is now the plain
// PyTorch walk alone (ops/traverse.py::trace_rays).
// The records are built on the host by accel/wide.py (scene/types.py::
// WideBVH): a node is 8 float4, child k's (lo.xyz, hi.x) at k and its
// (hi.yz, ref, 0) at 4 + k, so lane k of a quad fetches its child with two
// 16-byte loads and the four lanes read 64 adjacent bytes each time; a
// triangle is 3 float4 in leaf-slot order, (p0, id), (e1, 0), (e2, 0).
//
// trace_closest_wide: the walk of one ray by a quad (lanes 4q .. 4q + 3):
//   * inner node: lane k tests child k's box with the slab test of
//     ops/intersect.py::ray_aabb (__fmul_rn, entered at t <= t_best counts); the quad ranks the hit
//     children by entry t (ties to the lower child) with four shuffles,
//     takes the nearest next and pushes the others, farthest first, onto
//     the quad's stack in shared memory;
//   * leaf: lane k tests slot k with an uncontracted Moller-Trumbore on the
//     stored edges (moller_trumbore_edges), and the quad keeps the least
//     (t, id) by two xor shuffles, so an exact tie goes to the lowest id;
//   * pop: an entry whose entry t is no longer <= t_best is skipped.
// Every value that steers the walk is the same in the quad's four lanes, so
// the quad stays converged; its shuffles use the quad's own mask, since the
// other quads of the warp walk other rays.
// trace_closest_wide1: the same visits in the same order by one thread,
// which tests the four children itself.  Both give the closest hit with ties
// to the lowest id, as the plain walk of the threaded BVH finds it
// (ops/traverse.py::trace_rays; trace_rays_wide is this walk in PyTorch).  segment_visible_wide1: the
// one-thread walk bounded by a segment's end, with an early exit
// (ops/traverse.py::segment_visible_wide).
//
// The stack lives in dynamic shared memory, stack_depth entries a quad (or a
// thread, for the one-thread walk), 8 bytes an entry; the wrappers pass the
// tree's own need (accel/wide.py, WideBVH.stack_need) and refuse a tree whose
// stacks would not fit in a block's shared memory (accel/wide.py::MAX_STACK);
// a launch above the default 48 KB opts in (allow_stack_smem).  Should a push
// still not fit, the entry is dropped and *overflow is set to 1, which
// ops/traverse.py::check_overflow reads: the walk never truncates silently.
//
// Built with -DFYP_WALK_CHECKS, the one-thread walks check their state as they
// go: the node index, every child's ref, the leaf's slots and their triangle
// ids within the tree the host set (fyp_walk_checks), the stack pointer within
// the stack, the ray and a segment's length finite, and at most 2^20 steps.  A
// failed check counts its code in the host's buffer (the first failure's code,
// values and thread beside it) and the walk goes on safely; without the macro
// the checks are not compiled.  tests/test_torch_cuda.py::
// test_wide_walks_stay_in_range runs K3-K8 so built.
//
// What bounds it on an H100: the latency of dependent loads.  Against the
// threaded walk a Cornell camera ray makes 3.6 node visits and 1.2 leaf
// visits instead of 18.4 and 4.1, each visit loads its whole node (two
// 16-byte loads a lane, or eight for one thread), and a leaf reaches its
// triangles in one hop.  The quad puts four threads on a ray, which pays
// while a batch's quads fit on the card at once; past that its shuffles and
// ballots cost more than they hide, and one thread a ray is faster (K1
// chooses by batch size, ops/traverse.py::k1_lanes; K2-K6 run one thread a
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

#ifdef FYP_WALK_CHECKS
// The tree the walks must stay in, and where a failed check is counted:
// out[0] = 1 once a check failed, out[1..4] its code, two values and the
// thread, out[8 + code] the failures of each code.  Codes: 1 a node index,
// 2 the stack pointer, 3 a child's ref, 4 a leaf's slots, 5 a triangle id,
// 6 a ray not finite, 7 a segment's length, 8 a walk past 2^20 steps.
struct WalkLimits {
  int n_nodes, n_slots, n_tris;
  int* out;
};
__device__ WalkLimits walk_limits;

__device__ __noinline__ void walk_check_failed(int code, int a, int b) {
  int* o = walk_limits.out;
  if (atomicCAS(o, 0, 1) == 0) {
    o[1] = code;
    o[2] = a;
    o[3] = b;
    o[4] = blockIdx.x * blockDim.x + threadIdx.x;
  }
  atomicAdd(o + 8 + code, 1);
}

__device__ __forceinline__ bool walk_check(bool ok, int code, int a, int b) {
  if (!ok) walk_check_failed(code, a, b);
  return ok;
}

// a child's ref: empty, an inner node, or a leaf whose four slots lie in the tree
__device__ __forceinline__ bool ref_in_tree(int r) {
  return r == kEmpty || (r >= 0 && r < walk_limits.n_nodes) || (r <= -2 && 4 * (-r - 2) + 4 <= walk_limits.n_slots);
}

__device__ __forceinline__ bool finite3(float3 v) { return isfinite(v.x) && isfinite(v.y) && isfinite(v.z); }

#define WALK_CHECK(cond, code, a, b) walk_check((cond), (code), (a), (b))
#define WALK_NOTE(cond, code, a, b) static_cast<void>(walk_check((cond), (code), (a), (b)))
#else
#define WALK_CHECK(cond, code, a, b) true
#define WALK_NOTE(cond, code, a, b) static_cast<void>(0)
#endif

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

// ops/intersect.py::moller_trumbore given the edges e1 = p1 - p0, e2 = p2 - p0,
// uncontracted
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

// An inner node of the one-thread walk: it tests the four children's boxes
// against bound (a box entered at t <= bound counts), orders the hit ones by
// an odd-even transposition of four (stable: ties keep the child order),
// pushes all but the nearest, farthest first, and returns the nearest, or
// kEmpty where no child is hit.
__device__ __forceinline__ int open_node1(const WideBvh& w, const LaneStack& st, int& sp, int cur, float3 o,
                                          float3 inv, float bound) {
  float key[4];
  int ref[4];
  if (!WALK_CHECK(cur >= 0 && cur < walk_limits.n_nodes, 1, cur, sp) ||
      !WALK_CHECK(sp >= 0 && sp <= w.stack_depth, 2, sp, cur))
    return kEmpty;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float4 a = __ldg(w.nodes + 8 * cur + k);
    const float4 b = __ldg(w.nodes + 8 * cur + 4 + k);
    ref[k] = __float_as_int(b.z);
    if (!WALK_CHECK(ref_in_tree(ref[k]), 3, ref[k], cur)) ref[k] = kEmpty;
    const float t0x = __fmul_rn(a.x - o.x, inv.x), t1x = __fmul_rn(a.w - o.x, inv.x);
    const float t0y = __fmul_rn(a.y - o.y, inv.y), t1y = __fmul_rn(b.x - o.y, inv.y);
    const float t0z = __fmul_rn(a.z - o.z, inv.z), t1z = __fmul_rn(b.y - o.z, inv.z);
    const float tmin = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
    const float tmax = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
    const bool hit = ref[k] != kEmpty && tmax >= fmaxf(tmin, 0.0f) && tmin <= bound;
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
  }
  return ref[0];
}

// The nearest stack entry whose entry t is still <= bound, or kEmpty.
__device__ __forceinline__ int pop1(const LaneStack& st, int& sp, float bound) {
  while (sp > 0) {
    --sp;
    if (st.t[sp * st.stride] <= bound) return st.ref[sp * st.stride];
  }
  return kEmpty;
}

// The same walk as trace_closest_wide by one thread, which tests the four
// children itself.  Same visits, same result; no shuffles and one thread a
// ray.
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
  WALK_NOTE(finite3(o) && finite3(d), 6, 0, 0);
#ifdef FYP_WALK_CHECKS
  int steps = 0;
#endif
  while (WALK_CHECK(++steps < (1 << 20), 8, cur, sp)) {
    if (cur >= 0) {
      cur = open_node1(w, st, sp, cur, o, inv, h.t);
      if (cur != kEmpty) continue;
    } else {
      // a leaf outside the tree is counted and read as slots 0-3
      const int s0 = WALK_CHECK(-cur - 2 >= 0 && 4 * (-cur - 2) + 4 <= walk_limits.n_slots, 4, cur, sp)
                         ? 4 * (-cur - 2) : 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float4 p0 = __ldg(w.tris + 3 * (s0 + k));
        WALK_NOTE(__float_as_int(p0.w) < walk_limits.n_tris, 5, __float_as_int(p0.w), s0 + k);
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
    cur = pop1(st, sp, h.t);
    if (cur == kEmpty) break;
  }
  if (h.tri < 0) h.t = -1.0f;
  return h;
}

// The segment test by one thread through the wide BVH: whether the segment
// of length dist from o along the unit direction d reaches its end (no hit
// with t < dist - tol, some hit with t <= dist + tol, tol = max(1e-4, 1e-3 *
// dist)), as the JAX megakernels' shadow test decides it
// (fypraytracer_tpu/render/megakernel.py:847-866, build_shadow_trace).  The
// walk of trace_closest_wide1 with its bound best starting just above dist +
// tol; it returns false at the first hit below dist - tol.  It gives the
// threaded walk's answer for every segment: best never falls below dist -
// tol, so a box entered beyond best holds no hit that blocks the segment or
// ends it, and every box is one of the binary tree's boxes bit for bit.
// ops/traverse.py::segment_visible_wide, bit for bit the threaded
// ops/traverse.py::segment_visible.
__device__ __forceinline__ bool segment_visible_wide1(const WideBvh& w, const LaneStack& st, float3 o, float3 d,
                                                      float dist) {
  const float tol = fmaxf(1e-4f, __fmul_rn(dist, 1e-3f));
  const float lo = __fsub_rn(dist, tol);
  const float t_end = nextafterf(__fadd_rn(dist, tol), kBig);  // hits at t <= dist + tol count
  const float3 inv = make_float3(safe_inv(d.x), safe_inv(d.y), safe_inv(d.z));
  float best = t_end;
  int cur = 0;
  int sp = 0;
  WALK_NOTE(finite3(o) && finite3(d), 6, 1, 0);
  WALK_NOTE(isfinite(dist) && dist > 0.0f, 7, __float_as_int(dist), 0);
#ifdef FYP_WALK_CHECKS
  int steps = 0;
#endif
  while (WALK_CHECK(++steps < (1 << 20), 8, cur, sp)) {
    if (cur >= 0) {
      cur = open_node1(w, st, sp, cur, o, inv, best);
      if (cur != kEmpty) continue;
    } else {
      // a leaf outside the tree is counted and read as slots 0-3
      const int s0 = WALK_CHECK(-cur - 2 >= 0 && 4 * (-cur - 2) + 4 <= walk_limits.n_slots, 4, cur, sp)
                         ? 4 * (-cur - 2) : 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float4 p0 = __ldg(w.tris + 3 * (s0 + k));
        WALK_NOTE(__float_as_int(p0.w) < walk_limits.n_tris, 5, __float_as_int(p0.w), s0 + k);
        if (__float_as_int(p0.w) < 0) continue;
        const float4 e1 = __ldg(w.tris + 3 * (s0 + k) + 1);
        const float4 e2 = __ldg(w.tris + 3 * (s0 + k) + 2);
        float t, u, v;
        if (moller_trumbore_edges(o, d, make_float3(p0.x, p0.y, p0.z), make_float3(e1.x, e1.y, e1.z),
                                  make_float3(e2.x, e2.y, e2.z), t, u, v) &&
            t < best) {
          if (t < lo) return false;
          best = t;
        }
      }
    }
    cur = pop1(st, sp, best);
    if (cur == kEmpty) break;
  }
  return best < t_end;
}

// A kernel's walks through the wide BVH, one thread a ray (K3-K8): the
// closest hit and the segment test.  The walks are inlined at each
// call site: K5 so built takes 126-128 registers and spills nothing under
// __launch_bounds__(128), and K5 with the walks as __noinline__ calls
// faulted with an illegal address after tens to hundreds of frames, at the
// same frame each time; built with the
// range checks (FYP_WALK_CHECKS), both kinds run those frames clean with
// every check passing, so the fault lies in the code built for the calls,
// not in the walk's state (ROADMAP queue 3).
struct WideTracer {
  WideBvh w;
  LaneStack st;
  __device__ __forceinline__ Hit closest(float3 o, float3 d) const { return trace_closest_wide1(w, st, o, d, kBig); }
  __device__ __forceinline__ bool visible(float3 o, float3 d, float dist) const {
    return segment_visible_wide1(w, st, o, d, dist);
  }
};

}  // namespace fyp

#ifdef FYP_WALK_CHECKS
// Set the tree the walks' checks hold them to and the int buffer (at least
// 16 entries, on the card) they count failures in.
extern "C" int fyp_walk_checks(int n_nodes, int n_slots, int n_tris, void* out) {
  const fyp::WalkLimits l{n_nodes, n_slots, n_tris, static_cast<int*>(out)};
  return static_cast<int>(cudaMemcpyToSymbol(fyp::walk_limits, &l, sizeof(l)));
}
#endif
