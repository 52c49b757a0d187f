#!/usr/bin/env python3
"""A kernel family against variants of its own source, in turns, on one card.

Families (``FAMILIES``): ``k2`` is K2 (csrc/megakernel.cu), ``gi`` is K5, K6
and K7 (csrc/restir_gi.cu), ``k8`` is K8 (csrc/megakernel_diff.cu) and ``di``
is K3 and K4 (csrc/restir_di.cu).  Each variant is the committed source with
some text replaced (the family's ``variants``; ``+`` joins them, as
``mb5+onewalk``):

- ``mbN``, every family: the launch bound's blocks a multiprocessor.  K2:
  every sampler's ``min_blocks`` set to N (``mb0`` no minimum).  K5 and K6:
  ``__launch_bounds__(128, N)`` on their tiles split over clusters, so at
  most 65,536 / (128 N) registers a thread.  The committed bound,
  ``__launch_bounds__(kThreads)``, sets no minimum: it lets the split
  instantiation take up to 255 registers, and only a tile run as one block
  of 512 threads is capped at 128 (by its size).  K8 and K4:
  ``__launch_bounds__(128, N)`` on ``diff_kernel`` (every bounce count) and
  on ``k4_shade``, whose committed bounds set no minimum.
- ``k7mbN``, ``gi``: ``__launch_bounds__(128, N)`` on K7 (``gi_stage2``),
  whose committed bound sets no minimum.
- ``splitmbN``, ``di``: ``__launch_bounds__(kThreads, N)`` on K3's tiles
  split over clusters (blocks of 128), as ``gi``'s ``mbN``.
- ``loop``, ``di``: K3 evaluates p-hat a candidate at a time, as its
  parent did; the committed K3 evaluates it once per emitter where the
  emissive list holds at most four (``kPhatTable``) and reads the
  candidates' values from that table (``phat_of``).  ``phat``: ``p_prev``
  read from the table too (it spills 4 bytes at 64 registers).  The draws
  are the same, so the stage is the committed kernel's bit for bit.
- ``chained`` and ``eager``, ``gi``: K7 reads a neighbour's rows as its
  parent and K5 do, each test's after the test before (``chained``:
  ``K7Laps::kEager`` 0), or every test's rows before the first test
  (``eager``: 1), in place of the committed 2 (the Jacobian's rows and
  arithmetic too, for every neighbour); bit for bit.
- ``vislist``, ``gi``: K7's spatial reuse walks each thread's own list of
  visibility segments (``spatial_list``): a pass over the neighbours marks
  those that need a walk, one walk site in a loop over the marked ones
  (``__ffs``) marks the blocked, and a third pass merges in neighbour order
  with the same draws; bit for bit the committed kernel's.
- ``unrolled``, K2: the light tree's corner loop unrolled.
- ``unbounded``, K2: NEE's shadow walk unbounded.
- ``onewalk``, K5 and K6: ``stage1``'s primary ray, the path sample's first
  hit and each continuation walked at one inlined site, at the top of a
  loop that is not unrolled, with the same slots in every thread (slot 0
  the primary hit, 1 the first hit, 2 .. bounces the continuation); the
  random numbers are drawn in the same order, so the outputs are the
  committed kernels' bit for bit.
- ``block64``, K8: blocks of 64 threads (two tiles of 8 x 4 pixels) in
  place of 128.
- ``fastmath``, K8: ``f_and_dfdalb``'s ``powf(1 - v.h, 5)`` as products
  and its three divisions by ``__fdividef``; K8's outputs then differ from
  ``diff_plain``'s in the last bits, within its gates.
- ``unbounded``, K4: the shadow walk unbounded, one pass (the parent's).

K3-K7's outputs (K3's stage, K4's state and accum, K5's stage, state and
accum, K6's stage, K7's state and accum) must equal kept's bit for bit on
every side and turn (their digests are compared); K8's loss and d_tri must lie within
``chip_smoke.py``'s gates of kept's first turn (the float atomics sum in an
order that changes between runs).
A variant's copy of ``csrc/`` goes under
``fypraytracer_tpu_torch/_build/variants/``; each side runs in a process of
its own (the build's flags and sources are process state), all sides built
first, in parallel, then timed in turns (kept, the variants, the variants
again in reverse, kept).  K2's time at a case is CUDA events around 3 reps of
a run of launches after a warm-up, the median rep over the run's launches,
at the shapes ``chip_smoke.py --ab`` times K2 (``K2_AB``) and with 1 and 2
lanes at 1920x1088.  K8's, K3's and K4's is their own device time a launch, as
K5's below: K8 at frame 3 against a seeded target at Cornell 256², stress
128² and Cornell 1920x1088 with 2 bounces and at Cornell 256² with 4
(``chip_smoke.k8_by_shape``), K3 and K4 at frame 3 after two frames of
the DI loop at the same three shapes (``DI_CASES``).  K5's (both
visibility modes), K6's and K7's is the kernel's own device time a launch
by torch.profiler over 20 launches (5 at 1920x1088;
``chip_smoke.kernel_ms``), frame 3 after two frames of their own loop, at
the shapes ``chip_smoke.py`` times them (Cornell 256², stress 128²,
Cornell 1920x1088).  K3, K5 and K6 run in the launch the wrapper picks
(``picked``) and with every tile split over a cluster (``split``,
``restir_common.tile_clustered`` stood in for) where the wrapper picks one
block a tile.

Prints one JSON line a side's build (registers and spill bytes of every
instantiation of the family; for K5 and K6 also their resident blocks a
multiprocessor at Cornell's and the stress scene's stacks), one a turn, and
one a case with each side's median ms, its ratio to kept and kept's own
spread between its first and its last turn (max / min), which bounds what a
ratio can tell.  Needs a CUDA card:

    python3 kernel_variants.py k2 mb8 unrolled
    python3 kernel_variants.py gi onewalk mb5+onewalk
    python3 kernel_variants.py k8 mb6 block64 fastmath
    python3 kernel_variants.py di --only k3 loop splitmb5
    python3 kernel_variants.py gi --only k7 chained vislist

``--builds-only`` after the family builds the sides and prints their BUILD
lines without timing them (a launch bound's spills, in a minute);
``--only k7`` (a comma-separated list of ``k3``, ``k4``, ``k5``, ``k6``,
``k7``) after the family times only those kernels of ``di`` or ``gi``.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
from contextlib import nullcontext

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

# K2: (technique, scene, width, height, frames, lanes or None for k2_lanes, launches a rep)
K2_CASES = ([("NEE_MIS", "cornell", 256, 256, 8, None, 20), ("NEE_MIS", "cornell", 256, 256, 64, None, 5),
             ("NEE_MIS", "stress", 128, 128, 8, None, 20), ("NEE_MIS", "cornell", 1920, 1088, 8, None, 3),
             ("NEE_MIS", "cornell", 1920, 1088, 8, 1, 3), ("NEE_MIS", "cornell", 1920, 1088, 8, 2, 3)]
            + [(t, "cornell", 256, 256, 8, None, 20) for t in ("UNIFORM", "COSINE", "GGX", "BRDF", "LIGHT_SOURCE")])
# K5 and K6: (scene, width, height, launches timed)
GI_CASES = (("cornell", 256, 256, 20), ("stress", 128, 128, 20), ("cornell", 1920, 1088, 5))
# K4: at GI_CASES' shapes
DI_CASES = GI_CASES

# stage1's closest-hit walks at one site: the committed text from its camera
# ray to the end of the path sample (first, last) and what replaces it
ONE_WALK_SPAN = ("  float3 orig, dir;\n  camera_ray(P.cam, P.width, P.height, pix, orig, dir);\n"
                 "  const float3 view = -dir;\n  long long t0 = clk.now();\n",
                 "    res.w = w_of(res);\n  }\n")
ONE_WALK = r"""  float3 ro, rd;  // the slot's ray
  camera_ray(P.cam, P.width, P.height, pix, ro, rd);
  res = PathRes{zero3(), zero3(), zero3(), 0.0f, 0.0f, 0.0f, 0.0f};
  o.shade = false;
  bool live = true;       // a ray to trace in this slot
  bool active = false;    // the path goes on past its first hit
  bool reconnect = false;
  float pdf0 = 0.0f;
  float3 fw = zero3();    // the first bounce's BRDF weight f0 * cos0 / pdf0
  float3 s1_pos = zero3(), s1_n = zero3();
  float3 thr = make_float3(1.0f, 1.0f, 1.0f);
  float3 rad = zero3();
  const int n_slots = 1 + max(P.bounces, 1);
#pragma unroll 1
  for (int slot = 0; slot < n_slots; ++slot) {
    Hit h;
    h.tri = -1;
    h.t = -1.0f;
    if (live) {
      const long long tw = clk.now();
      h = tr.closest(ro, rd);
      clk.add(slot == 0 ? kPrimary : kPathWalks, tw);
    }
    const bool hit = live && h.tri >= 0;
    Surf sf{};
    float3 em = zero3();
    if (hit) {
      sf = tex_surface<T>(P.geo, P.mats, P.tex, h, ro, rd, slot > 0);
      em = emission_of(P.mats, sf.mat);
    }
    const bool em_hit = dot(em, em) > 0.0f;
    if (slot == 0) {
      o.hit = hit;
      o.em = em;
      o.shade = hit && !em_hit;
      o.pos = sf.pos;
      o.n = sf.n;
      o.alb = sf.alb;
      o.rough = sf.rough;
      o.metal = sf.metal;
      o.t = hit ? h.t : -1.0f;
      o.sky_direct = zero3();
      key = fold(fold(fold(pcg(static_cast<uint32_t>(pix)), P.frame), 0u), 8001u);
      if (!o.shade) break;
      // ---- the BRDF path sample (megakernel_restir_gi.py:993-1092)
      const float u_sel = next_uniform(key);
      const float u1 = next_uniform(key);
      const float u2 = next_uniform(key);
      const float3 view = -rd;
      float3 d0;
      pdf0 = mixture_sample(o.n, view, o.alb, o.metal, o.rough, u_sel, u1, u2, d0);
      const float3 f0 = cook_torrance(o.n, view, d0, o.alb, o.metal, o.rough);
      const float cos0 = fmaxf(dot(d0, o.n), 0.0f);
      fw = f0 * (cos0 / fmaxf(pdf0, 1e-12f));
      ro = o.pos + o.n * kOriginEps;
      rd = d0;
      continue;  // the first hit is traced whatever pdf0
    }
    if (slot == 1) {
      s1_pos = sf.pos;
      s1_n = sf.n;
      reconnect = hit && pdf0 > 0.0f;
      if (!hit && pdf0 > 0.0f) o.sky_direct = fw * P.sky;
      // the path continues from the sample point with unit throughput
      if (reconnect && em_hit) rad = em;
      active = reconnect && !em_hit;
    } else if (live) {
      if (!hit) {
        rad = rad + thr * P.sky;
        active = false;
      } else if (em_hit) {
        rad = rad + thr * em;
        active = false;
      }
    }
    live = false;
    if (slot < P.bounces) {
      // the next continuation from sf, seen along rd
      const float r1 = next_uniform(key);
      const float r2 = next_uniform(key);
      const float r3 = next_uniform(key);
      if (active) {
        const float3 bv = -rd;
        float3 l;
        const float pdf = mixture_sample(sf.n, bv, sf.alb, sf.metal, sf.rough, r1, r2, r3, l);
        const float3 f = cook_torrance(sf.n, bv, l, sf.alb, sf.metal, sf.rough);
        const float scale = fmaxf(dot(l, sf.n), 0.0f) / fmaxf(pdf, 1e-12f);
        thr = thr * f * scale;
        live = pdf > 0.0f;
        active = live;
        ro = sf.pos + sf.n * kOriginEps;
        rd = l;
      }
    }
  }
  if (o.shade) {
    if (!reconnect) rad = zero3();
    const float src_pdf = reconnect ? pdf0 : 0.0f;
    const float p_hat = rad_norm(rad);
    const float u0 = next_uniform(key);
    const float w_ris = src_pdf > 0.0f ? p_hat / fmaxf(src_pdf, 1e-12f) : 0.0f;
    res_update(res, s1_pos, s1_n, rad, w_ris, 1.0f, p_hat, u0);
    res.w = w_of(res);
  }
"""


def k2_mb(n: int) -> list:
    return [("megakernel.cu", "constexpr int min_blocks() { return S == NEE ? 5 : 6; }",
             f"constexpr int min_blocks() {{ return {max(n, 1)}; }}")]


def gi_mb(n: int) -> list:
    return [("restir_gi.cu", f"__launch_bounds__(kThreads) {k}(",
             f"__launch_bounds__(kThreads, kThreads == kTileBlock ? {n} : 1) {k}(") for k in ("gi_mono", "gi_stage1")]


def k8_mb(n: int) -> list:
    return [("megakernel_diff.cu", "__launch_bounds__(kBlock) diff_kernel(", f"__launch_bounds__(kBlock, {n}) diff_kernel(")]


def di_mb(n: int) -> list:
    return [("restir_di.cu", "__launch_bounds__(kTileBlock) k4_shade(", f"__launch_bounds__(kTileBlock, {n}) k4_shade(")]


# f_and_dfdalb's power and divisions, fast
K8_FAST = [
    ("megakernel_diff.cu", """  const float g = (ndv / fmaxf(ndv * (1.0f - k) + k, 1e-12f)) * (ndl / fmaxf(ndl * (1.0f - k) + k, 1e-12f));
  const float den = ndh * ndh * (a2 - 1.0f) + 1.0f;
  const float d = a2 * kInvPi / fmaxf(den * den, 1e-12f);
  const float spec = d * g / fmaxf(4.0f * ndv * ndl, 1e-12f);
  const float s5 = powf(1.0f - vdh, 5.0f);""",
     """  const float g = __fdividef(ndv, fmaxf(ndv * (1.0f - k) + k, 1e-12f)) *
                  __fdividef(ndl, fmaxf(ndl * (1.0f - k) + k, 1e-12f));
  const float den = ndh * ndh * (a2 - 1.0f) + 1.0f;
  const float d = __fdividef(a2 * kInvPi, fmaxf(den * den, 1e-12f));
  const float spec = __fdividef(d * g, fmaxf(4.0f * ndv * ndl, 1e-12f));
  const float om = 1.0f - vdh, om2 = om * om;
  const float s5 = om2 * om2 * om;""")]
# K4's shadow walk as the parent walked it: unbounded, one pass
DI_UNBOUNDED = [("restir_di.cu", ("    // the shadow walk bounded by the emitter, then unbounded where it found\n",
                                  "      t_max = kBig;\n    }\n"),
                 "    t0 = clk.now();\n    const Hit sh = trace_closest_wide1(P.wide, lane_stack(P.wide.stack_depth), "
                 "pos + n * kOriginEps, l, kBig);\n")]


# K3 as the parent evaluated p-hat: a candidate at a time, whatever the
# list (the committed table's span, from its comment to the candidate's
# value, and what replaces it)
DI_LOOP = [("restir_di.cu", ("  // where the list is short, p-hat of every emitter once",
                             "    float ph = table ? phat_of(ph_e, cand) : p_hat(P.em, cand, s.pos, s.n, view, s.alb, "
                             "s.rough, s.metal);"),
            """  Res res{0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int i = 0; i < P.candidates; ++i) {
    float u_sel = next_uniform(key);
    float u_acc = next_uniform(key);
    int cand = min(static_cast<int>(u_sel * static_cast<float>(ne)), ne - 1);
    float ph = p_hat(P.em, cand, s.pos, s.n, view, s.alb, s.rough, s.metal);""")]
K3_PREV = "    const float p_prev = p_hat(P.em, slot(P.em, prev_idx), s.pos, s.n, view, s.alb, s.rough, s.metal);"
K3_PREV_TABLE = ("    const float p_prev = table ? phat_of(ph_e, slot(P.em, prev_idx))\n"
                 "                               : p_hat(P.em, slot(P.em, prev_idx), s.pos, s.n, view, s.alb, s.rough, "
                 "s.metal);")
# K3's p_prev read from the table too (it then spills 4 bytes at 64 registers)
DI_PHAT = [("restir_di.cu", K3_PREV, K3_PREV_TABLE)]


def k3_bound(blocks: str) -> list:
    return [("restir_di.cu", "__launch_bounds__(kThreads) k3_candidates(",
             f"__launch_bounds__(kThreads, {blocks}) k3_candidates(")]


# K7: each thread's own list of visibility walks; its passes read a
# neighbour through this helper, spatial's reads and Jacobian as a function
K7_NEIGHBOUR = r"""// A neighbour of pixel pix at the frame's offset draws (ux, uy), read from
// the stage nb, as spatial reads it: whether it counts (ok) and, where it
// does (with L::kEager 2, wherever), its sample and p-hat through the
// reconnection Jacobian (p_n, before visibility) with the segment from
// its sample point towards this pixel's visible point (dr / dist_r over
// dist_r).  Laps of L on clk from t.
struct Neighbour {
  int q;
  bool ok;
  float3 spn, snn, radn, dr;
  float dist_r, p_n;
};

template <class L, class Clk>
__device__ __forceinline__ Neighbour neighbour(const Params& P, Clk& clk, long long& t, const float* nb, int pix,
                                               const Own& o, float ux, float uy) {
  const int C = P.C;
  const int tile = pix / C;
  const int lane = pix - tile * C;
  const int B = P.width * P.height;
  const int px = pix % P.width, py = pix / P.width;
  Neighbour r;
  const int dx = static_cast<int>(__fmul_rn(__fsub_rn(__fmul_rn(ux, 2.0f), 1.0f), P.radius));
  const int dy = static_cast<int>(__fmul_rn(__fsub_rn(__fmul_rn(uy, 2.0f), 1.0f), P.radius));
  const int s = tile * C + dy * P.width + dx;
  const int sc = min(max(s, 0), B - C);
  const int q = sc + lane;
  r.q = q;
  const bool in_img = px + dx >= 0 && px + dx < P.width && py + dy >= 0 && py + dy < P.height;
  const float n_t = row1(nb, GS_T, B, q);
  if constexpr (L::kEager > 0) {
    // every row the tests read, loaded before any test and tested without
    // a branch (q lies in [0, B) whatever the offset)
    r.ok = in_img & (s == sc) & (n_t <= 1.1f * o.t) & (n_t >= 0.9f * o.t) &
           (dot(row3(nb, GS_NRM, B, q), o.n) >= kNormalSpatial) & (row1(nb, GS_SHADE, B, q) > 0.5f) &
           (row1(nb, GS_M, B, q) > 0.0f);
  } else {
    r.ok = in_img && s == sc && n_t <= 1.1f * o.t && n_t >= 0.9f * o.t &&
           dot(row3(nb, GS_NRM, B, q), o.n) >= kNormalSpatial && row1(nb, GS_SHADE, B, q) > 0.5f &&
           row1(nb, GS_M, B, q) > 0.0f;
  }
  if constexpr (L::kEager < 2) {
    if (!r.ok) return r;
    t += clk.add(L::kTests, t);
  }

  // Jacobian of path reconnection (eq. 11, Renderer.cu:2343-2353)
  r.spn = row3(nb, GS_SP, B, q);
  r.snn = row3(nb, GS_SN, B, q);
  r.radn = row3(nb, GS_RAD, B, q);
  const float3 dq = row3(nb, GS_POS, B, q) - r.spn;
  r.dr = o.pos - r.spn;
  const float dist_q = sqrtf(fmaxf(dot(dq, dq), 1e-20f));
  r.dist_r = sqrtf(fmaxf(dot(r.dr, r.dr), 1e-20f));
  const float cos_q = dot(r.snn, dq) / dist_q;
  const float cos_r = dot(r.snn, r.dr) / r.dist_r;
  const float jac = (cos_q > 0.0f ? cos_r / fmaxf(cos_q, 1e-12f) : 0.0f) * (dist_q * dist_q) /
                    fmaxf(r.dist_r * r.dist_r, 1e-20f);
  r.p_n = jac > 0.0f ? rad_norm(r.radn) / fmaxf(jac, 1e-12f) : 0.0f;
  t += clk.add(L::kJacobian, t);
  return r;
}

"""
K7_LIST = r"""// K7's spatial reuse with each thread's own list of visibility walks:
// spatial's with vis, bit for bit, in three passes over each chunk of 32
// neighbours: (A) the tests and the Jacobian mark the neighbours whose
// segment is walked (they count and p_n > 0); (B) one walk site, in a loop
// over the marked ones, marks those whose segment is blocked; (C) the merge
// in k order with the same draws, p_n = 0 where B found the segment
// blocked.  A neighbour's rows are read and its Jacobian computed again in
// each pass, so that none of its values stays live across them.  Returns
// the walks of the first 32 neighbours, as spatial does.
template <class L, class Tracer, class Clk>
__device__ uint32_t spatial_list(const Params& P, const Tracer& tr, Clk& clk, const float* nb, int pix,
                                 const Own& o, PathRes& res, uint32_t& key) {
  long long t = clk.now();
  const int B = P.width * P.height;
  float z = o.shade ? res.m : 0.0f;
  uint32_t first = 0;
  uint32_t okey = fold(fold(fold(pcg(0xD1CEu), P.frame), 0u), 8002u);
  for (int k0 = 0; k0 < P.neighbors; k0 += 32) {
    const int n = min(P.neighbors - k0, 32);
    uint32_t walk = 0;
    if (o.shade) {
      uint32_t ka = okey;
      for (int j = 0; j < n; ++j) {
        const float ux = next_uniform(ka);
        const float uy = next_uniform(ka);
        const Neighbour c = neighbour<L>(P, clk, t, nb, pix, o, ux, uy);
        if (c.ok && c.p_n > 0.0f) walk |= 1u << j;
      }
    }
    if (k0 == 0) first = walk;
    uint32_t blocked = 0;
    uint32_t kb = okey;
    int jb = 0;
#pragma unroll 1
    while (walk != 0u) {
      const int j = __ffs(static_cast<int>(walk)) - 1;
      walk &= walk - 1u;
      for (; jb < j; ++jb) {
        next_uniform(kb);
        next_uniform(kb);
      }
      const float ux = next_uniform(kb);
      const float uy = next_uniform(kb);
      ++jb;
      const Neighbour c = neighbour<L>(P, clk, t, nb, pix, o, ux, uy);
      if (!tr.visible(c.spn + c.snn * kOriginEps, c.dr / c.dist_r, c.dist_r)) blocked |= 1u << j;
      t += clk.add(L::kWalks, t);
    }
    for (int j = 0; j < n; ++j) {
      const float ux = next_uniform(okey);
      const float uy = next_uniform(okey);
      const float u_acc = next_uniform(key);
      if (!o.shade) continue;
      const Neighbour c = neighbour<L>(P, clk, t, nb, pix, o, ux, uy);
      if (!c.ok) continue;
      const float p_n = ((blocked >> j) & 1u) != 0u ? 0.0f : c.p_n;
      const float nb_m = row1(nb, GS_M, B, c.q);
      z = z + nb_m;
      res_update(res, c.spn, c.snn, c.radn, p_n * row1(nb, GS_W, B, c.q) * nb_m, nb_m, p_n, u_acc);
    }
  }
  res.w = res.phat > 0.0f ? res.wsum / (fmaxf(z, 1.0f) * res.phat) : 0.0f;
  clk.add(L::kTests, t);
  return first;
}

// The shade (restir_gi._shade)"""
# vislist with a first pass that only tests the neighbours (their six rows),
# leaving the Jacobian and p_n > 0 to the walk pass
K7_LIST_TESTS = K7_LIST.replace("""        const Neighbour c = neighbour<L>(P, clk, t, nb, pix, o, ux, uy);
        if (c.ok && c.p_n > 0.0f) walk |= 1u << j;""", """        if (counts(P, nb, pix, o, ux, uy)) walk |= 1u << j;""").replace(
    """      const Neighbour c = neighbour<L>(P, clk, t, nb, pix, o, ux, uy);
      if (!tr.visible(c.spn + c.snn * kOriginEps, c.dr / c.dist_r, c.dist_r)) blocked |= 1u << j;""",
    """      const Neighbour c = neighbour<L>(P, clk, t, nb, pix, o, ux, uy);
      if (c.p_n > 0.0f && !tr.visible(c.spn + c.snn * kOriginEps, c.dr / c.dist_r, c.dist_r)) blocked |= 1u << j;""")
K7_COUNTS = """// Whether neighbour (ux, uy) of pixel pix counts: neighbour's tests alone,
// every row read before the first
__device__ __forceinline__ bool counts(const Params& P, const float* nb, int pix, const Own& o, float ux, float uy) {
  const int C = P.C;
  const int tile = pix / C;
  const int lane = pix - tile * C;
  const int B = P.width * P.height;
  const int px = pix % P.width, py = pix / P.width;
  const int dx = static_cast<int>(__fmul_rn(__fsub_rn(__fmul_rn(ux, 2.0f), 1.0f), P.radius));
  const int dy = static_cast<int>(__fmul_rn(__fsub_rn(__fmul_rn(uy, 2.0f), 1.0f), P.radius));
  const int s = tile * C + dy * P.width + dx;
  const int sc = min(max(s, 0), B - C);
  const int q = sc + lane;
  const bool in_img = px + dx >= 0 && px + dx < P.width && py + dy >= 0 && py + dy < P.height;
  const float n_t = row1(nb, GS_T, B, q);
  return in_img & (s == sc) & (n_t <= 1.1f * o.t) & (n_t >= 0.9f * o.t) &
         (dot(row3(nb, GS_NRM, B, q), o.n) >= kNormalSpatial) & (row1(nb, GS_SHADE, B, q) > 0.5f) &
         (row1(nb, GS_M, B, q) > 0.0f);
}

"""
GI_VISLIST = [("restir_gi.cu", "// The shade (restir_gi._shade)", K7_NEIGHBOUR + K7_LIST),
              ("restir_gi.cu", "walked = spatial<K7Laps>(P, tr, clk, sg, pix, o, res, key, true);",
               "walked = spatial_list<K7Laps>(P, tr, clk, sg, pix, o, res, key);")]


# K7's neighbour reads: the committed K7Laps::kEager 2 (every row and the
# Jacobian before the caller tests ok), 1 (every test's rows before the
# first test) or 0 (the parent's chain of tests, as K5 reads)
def k7_eager(level: int) -> list:
    return [("restir_gi.cu", "  static constexpr int kEager = 2;", f"  static constexpr int kEager = {level};")]


def k7_mb(n: int) -> list:
    return [("restir_gi.cu", "__launch_bounds__(kTileBlock) gi_stage2(", f"__launch_bounds__(kTileBlock, {n}) gi_stage2(")]


# family -> (library, its kernels' names in ptxas_report, {prefix: substitutions of a
# launch bound of N blocks, named prefix + N}, the other variants); a
# substitution is (file in csrc/, old text or (its first, its last line), new text)
FAMILIES = {
    "k2": ("megakernel", ("frames_kernel",), {"mb": k2_mb}, {
        "unrolled": [("shading.cuh", "#pragma unroll 1\n  for (int i = 0; i < 8; ++i) {",
                      "#pragma unroll\n  for (int i = 0; i < 8; ++i) {")],
        "unbounded": [("megakernel.cu", "r = Ray{s.pos + s.n * kOriginEps, l_dir, __fadd_rn(dist, tol), kShadow};",
                       "r = Ray{s.pos + s.n * kOriginEps, l_dir, kBig + 0.0f * tol, kShadow};")]}),
    "gi": ("restir_gi", ("gi_mono", "gi_stage1", "gi_stage2"), {"mb": gi_mb, "k7mb": k7_mb}, {
        "onewalk": [("restir_gi.cu", ONE_WALK_SPAN, ONE_WALK)], "vislist": GI_VISLIST,
        "eager": k7_eager(1), "chained": k7_eager(0),
        "vislist2": [("restir_gi.cu", "// The shade (restir_gi._shade)", K7_NEIGHBOUR + K7_COUNTS + K7_LIST_TESTS),
                     GI_VISLIST[1]]}),
    "k8": ("megakernel_diff", ("diff_kernel",), {"mb": k8_mb}, {
        "block64": [("megakernel_diff.cu", "constexpr int kBlock = 128;", "constexpr int kBlock = 64;")],
        "fastmath": K8_FAST}),
    "di": ("restir_di", ("k3_candidates", "k4_shade"),
           {"mb": di_mb, "splitmb": lambda n: k3_bound(f"kThreads == kTileBlock ? {n} : 1")},
           {"unbounded": DI_UNBOUNDED, "loop": DI_LOOP, "phat": DI_PHAT}),
}


def substitute(text: str, fn: str, old, new: str) -> str:
    """text with old (or the span from old[0] through old[1]) replaced once."""
    first, last = (old, None) if isinstance(old, str) else old
    i = text.find(first)
    j = i + len(first) if last is None else text.find(last, i) + len(last)
    if i < 0 or j < i + len(first) or text.count(first) != 1:
        raise RuntimeError(f"{fn} has not exactly one {first!r}{'' if last is None else ' ... ' + repr(last)}")
    return text[:i] + new + text[j:]


def use_variant(family: str, name: str):
    """Point ops/kernels.py at the variant's copy of csrc/ (made once)."""
    from fypraytracer_tpu_torch.ops import kernels

    if name == "kept":
        return kernels
    _, _, bounds, variants = FAMILIES[family]
    dst = os.path.join(kernels.BUILD_DIR, "variants", f"{family}_{name}", "csrc")
    if not os.path.isdir(dst):
        tmp = f"{dst}.{os.getpid()}"
        shutil.copytree(os.path.join(REPO, "fypraytracer_tpu_torch", "csrc"), tmp)
        for part in name.split("+"):
            prefix = part.rstrip("0123456789")
            if prefix in bounds and part != prefix:
                subs = bounds[prefix](int(part[len(prefix):]))
            elif part in variants:
                subs = variants[part]
            else:
                raise ValueError(f"unknown variant {part} of {family}")
            for fn, old, new in subs:
                path = os.path.join(tmp, fn)
                with open(path) as f:
                    text = f.read()
                with open(path, "w") as f:
                    f.write(substitute(text, fn, old, new))
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        os.replace(tmp, dst)
    kernels.CSRC = dst
    return kernels


def build(family: str, name: str) -> None:
    import chip_smoke

    lib, prefixes = FAMILIES[family][:2]
    kernels = use_variant(family, name)
    kernels.build(lib)
    line = dict(side=name, ptxas={k: v for k, v in chip_smoke.ptxas_report(kernels.build_info[lib]["log"]).items()
                                  if k.startswith(prefixes)})
    if family == "gi":
        line["blocks_per_sm"] = chip_smoke.gi_blocks_per_sm()
    print("BUILD " + json.dumps(line), flush=True)


def time_k2() -> dict:
    import torch

    from fypraytracer_tpu_torch.config import RenderSettings, SamplingTechnique
    from fypraytracer_tpu_torch.ops.traverse import check_overflow
    from fypraytracer_tpu_torch.render import megakernel as mk
    from fypraytracer_tpu_torch.render.megakernel import morton_permuted_scene
    from fypraytracer_tpu_torch.scene import procedural

    sc = {}
    for name, w, h in {(c[1], c[2], c[3]) for c in K2_CASES}:
        if name == "stress":
            builder, cam = procedural.stress(w, h)
            sc[(name, w, h)] = (morton_permuted_scene(builder.compile(native=True))[0].to("cuda"), cam)
        else:
            builder, cam = procedural.cornell_box(w, h)
            sc[(name, w, h)] = (builder.compile().to("cuda"), cam)
    ms = {}
    for tech, scene_name, w, h, frames, lanes, calls in K2_CASES:
        scene, cam = sc[(scene_name, w, h)]
        st = RenderSettings(technique=SamplingTechnique[tech], bounces=2, samples=1, sky_color=(0.05, 0.06, 0.08))
        lanes = lanes or mk.k2_lanes(frames)

        def run():
            mk.megakernel(scene, cam, 1, frames, st, lanes=lanes)

        run()
        torch.cuda.synchronize()
        reps = []
        for _ in range(3):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                run()
            end.record()
            torch.cuda.synchronize()
            reps.append(start.elapsed_time(end) / calls)
        ms[f"{tech} {scene_name} {w}x{h} {frames} frames lanes{lanes}"] = statistics.median(reps)
    for scene, _ in sc.values():
        check_overflow(scene)
    return ms


def digest(*ts) -> str:
    """sha256 (16 hex digits) of the tensors' bytes."""
    import hashlib

    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def time_gi(kernels=None) -> tuple:
    """K5's (both modes), K6's and K7's device ms a launch at each of
    ``GI_CASES`` (K5 and K6 in the launch the wrapper picks and, where it
    picks one block a tile, split too), and the digests of their outputs:
    K5's stage, state and accum, K6's stage, K7's state and accum; only
    ``kernels`` ("k5", "k6", "k7") where given."""
    from unittest import mock

    import torch

    import chip_smoke
    from fypraytracer_tpu_torch.ops.traverse import check_overflow
    from fypraytracer_tpu_torch.render import megakernel_restir_gi as mg
    from fypraytracer_tpu_torch.render import restir_common as rc

    st = chip_smoke.settings_for("RESTIR_GI")
    ms, outputs = {}, {}
    for scene_name, w, h, calls in GI_CASES:
        scene, cam = chip_smoke.tile_scene(scene_name, w, h)
        case = f"{scene_name} {w}x{h}"
        B = w * h
        ppv = torch.as_tensor(cam.proj_view, device="cuda")
        cam_t = rc.camera_matrices(cam, "cuda")
        launches = ["picked"] + ([] if rc.pick_tile_launch(scene, B, cam_t.device)["clustered"] else ["split"])
        for kernel in ("k5", "k5 final_vis", "k6", "k7"):
            if kernels and kernel.split()[0] not in kernels:
                continue
            z = (torch.zeros((mg.GT_ROWS, B), device="cuda"), torch.zeros((mg.GS_ROWS, B), device="cuda"))
            _, state, stage = mg.restir_gi_megakernel(scene, cam, *z, 1, 2, st, ppv, ppv, mono=kernel.startswith("k5"))
            outs = (torch.zeros((B, 3), device="cuda"), torch.empty_like(state), torch.empty_like(stage))
            if kernel == "k7":
                wrapper = mg.restir_gi_k2
                stage = mg.restir_gi_k1(scene, cam, 3, st, state, ppv, cam=cam_t)

                def run():
                    mg.restir_gi_k2(scene, cam, 3, st, stage, outs[1], outs[0], cam=cam_t)
            elif kernel == "k6":
                wrapper = mg.restir_gi_k1

                def run():
                    mg.restir_gi_k1(scene, cam, 3, st, state, ppv, outs[2], cam=cam_t)
            else:
                wrapper = mg.restir_gi_mono

                def run(fv=kernel.endswith("final_vis")):
                    mg.restir_gi_mono(scene, cam, 3, st, state, stage, ppv, *outs, final_vis=fv, cam=cam_t)
            run()
            outputs[f"{kernel} {case}"] = digest(*{"k6": outs[2:], "k7": outs[:2]}.get(kernel, outs))
            for launch in launches if kernel != "k7" else ["picked"]:
                with mock.patch.object(rc, "tile_clustered", lambda *_: True) if launch == "split" else nullcontext():
                    run()
                    torch.cuda.synchronize()
                    ms[f"{kernel} {case} {launch}"] = chip_smoke.kernel_ms(
                        run, calls, launches=lambda: wrapper.launches)
        check_overflow(scene)
    return ms, outputs


def time_k8() -> tuple:
    """K8's device ms a launch at ``chip_smoke.py``'s shapes
    (``k8_by_shape``), and its loss and d_tri at Cornell 256²."""
    import chip_smoke

    out = chip_smoke.k8_by_shape(outputs=True)
    return out["ms_by_shape"], out["outputs"]


def time_di(kernels=None) -> tuple:
    """K3's and K4's device ms a launch at each of ``DI_CASES`` (frame 3,
    after two frames of the DI loop; K3 in the launch the wrapper picks
    and, where it picks one block a tile, split too), and the digests of
    K3's stage and of K4's state and accum; only ``kernels`` ("k3", "k4")
    where given."""
    from unittest import mock

    import torch

    import chip_smoke
    from fypraytracer_tpu_torch.ops.traverse import check_overflow
    from fypraytracer_tpu_torch.render import megakernel_restir as mr
    from fypraytracer_tpu_torch.render import restir_common as rc

    st = chip_smoke.settings_for("RESTIR_DI")
    ms, outputs = {}, {}
    for name, w, h, calls in DI_CASES:
        scene, cam = chip_smoke.tile_scene(name, w, h)
        case = f"{name} {w}x{h}"
        B = w * h
        ppv = torch.as_tensor(cam.proj_view, device="cuda")
        cam_t = rc.camera_matrices(cam, "cuda")
        em = mr.prepare_emissive_table(scene)
        state = torch.zeros((mr.ST_ROWS, B), device="cuda")
        mr.restir_di_megakernel(scene, em, cam, state, 1, 2, st, ppv, ppv)

        def k3():
            return mr.restir_di_k3(scene, em, cam, 3, st, state, ppv, cam=cam_t)

        stage = k3()
        outputs[f"k3 {case}"] = digest(stage)
        for launch in ["picked"] + ([] if rc.pick_tile_launch(scene, B, cam_t.device)["clustered"] else ["split"]):
            if kernels and "k3" not in kernels:
                break
            with mock.patch.object(rc, "tile_clustered", lambda *_: True) if launch == "split" else nullcontext():
                k3()
                torch.cuda.synchronize()
                ms[f"k3 {case} {launch}"] = chip_smoke.kernel_ms(k3, calls, launches=lambda: mr.restir_di_k3.launches)
        acc, st_out = torch.zeros((B, 3), device="cuda"), torch.empty_like(state)

        def k4():
            mr.restir_di_k4(scene, em, cam, 3, st, stage, st_out, acc, cam=cam_t)

        k4()
        outputs[f"k4 {case}"] = digest(st_out, acc)
        if not kernels or "k4" in kernels:
            ms[f"k4 {case}"] = chip_smoke.kernel_ms(k4, calls, launches=lambda: mr.restir_di_k4.launches)
        check_overflow(scene)
    return ms, outputs


def time_side(family: str, name: str, only: str = "") -> None:
    use_variant(family, name)
    kernels = tuple(only.split(",")) if only else None
    ms, outputs = {"k2": lambda: (time_k2(), None), "gi": lambda: time_gi(kernels), "k8": time_k8,
                   "di": lambda: time_di(kernels)}[family]()
    print("TURN " + json.dumps(dict(side=name, ms=ms, outputs=outputs)), flush=True)


def outputs_agree(family: str, got, want) -> bool:
    """K3-K7's digests equal kept's first; K8's loss within 1e-5 and d_tri
    within 1e-4 of its largest entry of kept's first (chip_smoke.py's
    gates, at Cornell 256²); K2's are not compared here."""
    if family in ("di", "gi"):
        return got == want
    if family == "k8":
        for case, w in want.items():
            g = got[case]
            scale = max(abs(x) for x in w["d_tri"])
            if abs(g["loss"] - w["loss"]) > 1e-5 * abs(w["loss"]) or \
                    max(abs(a - b) for a, b in zip(g["d_tri"], w["d_tri"])) > 1e-4 * scale:
                return False
    return True


def main(family: str, variants: list) -> int:
    if family not in FAMILIES:
        raise SystemExit(f"usage: kernel_variants.py {{{','.join(FAMILIES)}}} [--builds-only] [--only KERNELS] "
                         "VARIANT [VARIANT ...]")
    builds_only = variants[:1] == ["--builds-only"]
    variants = variants[1:] if builds_only else variants
    only = variants[1] if variants[:1] == ["--only"] else ""
    variants = variants[2:] if only else variants
    sides = ["kept"] + variants
    me = os.path.abspath(__file__)
    procs = [subprocess.Popen([sys.executable, me, "--build", family, s], cwd=REPO, stdout=subprocess.PIPE,
                              text=True) for s in sides]
    for p in procs:
        out, _ = p.communicate(timeout=900)
        print(out, end="", flush=True)
        if p.returncode != 0:
            return p.returncode
    if builds_only:
        return 0
    turns = {s: [] for s in sides}
    outputs = {s: [] for s in sides}
    for side in sides + sides[::-1]:
        r = subprocess.run([sys.executable, me, "--time", family, side, only], cwd=REPO, capture_output=True, text=True,
                           timeout=900)
        line = [ln for ln in r.stdout.splitlines() if ln.startswith("TURN ")]
        if r.returncode != 0 or not line:
            print(r.stdout + r.stderr[-3000:], flush=True)
            return r.returncode or 1
        print(line[0], flush=True)
        turn = json.loads(line[0][5:])
        turns[side].append(turn["ms"])
        outputs[side].append(turn["outputs"])
    agree = {s: [outputs_agree(family, o, outputs["kept"][0]) for o in outputs[s]] for s in sides}
    print(json.dumps(dict(outputs_agree_with_kept=agree)), flush=True)
    for case in turns["kept"][0]:
        med = {s: statistics.median(t[case] for t in turns[s]) for s in sides}
        kept = [t[case] for t in turns["kept"]]
        print(json.dumps(dict(case=case, median_ms=med, over_kept={s: med[s] / med["kept"] for s in variants},
                              kept_spread=max(kept) / min(kept))), flush=True)
    return 0 if all(v for vs in agree.values() for v in vs) else 1


if __name__ == "__main__":
    if sys.argv[1:2] == ["--build"]:
        build(*sys.argv[2:4])
    elif sys.argv[1:2] == ["--time"]:
        time_side(*sys.argv[2:5])
    else:
        sys.exit(main(sys.argv[1], sys.argv[2:]))
