// ReSTIR GI: K5 (the whole frame in one kernel, spatial reuse lagged by one
// frame), K6 (primary hit, BRDF path sample, temporal reuse) and K7 (same-frame
// spatial reuse, shade).
//
// Replaces the TPU kernels of fypraytracer_tpu/render/megakernel_restir_gi.py:
//   * K5 restir_gi_mono: make_restir_gi_mono -> kernel (:917, launched at
//     :1490), a template over final_vis (one visibility ray for the spatial
//     winner instead of one per neighbour);
//   * K6 restir_gi_k1: make_restir_gi_megakernel::k1 (:169, launched at :748);
//   * K7 restir_gi_k2: k2a (:447 -> :758) and k2b (:544 -> :794).  k2a only
//     gathers each tile's neighbour rows into a buffer for k2b; a thread here
//     reads its neighbours' rows itself, so both are one kernel.
// K6 + K7 is the reference's two-stage split (mono=False): the launch boundary
// orders them, so one stage and one state buffer suffice (K6 reads the state,
// writes the stage; K7 reads the stage, writes the state at its own pixel).
// K5 reads the previous frame's state at the reprojected tile and its stage at
// the neighbour tiles while other blocks write this frame's: it takes separate
// input and output buffers, which the host swaps every frame.
//
// Buffers are SoA, (rows, B) float32, B = width * height, rows named by the
// GS_* (stage) and GT_* (state) constants below, the JAX rows without padding
// (megakernel_restir_gi.py:67-96).  The semantics are the JAX megakernels' (see
// render/megakernel_restir_gi.py): a tile is C consecutive pixels (tile.cuh;
// Params::C); the tile reads the previous state at one offset, rint(mean(
// prev_pix - pix)) over its shading pixels (summed as integers), and a pixel
// keeps history only where that read is its own reprojected pixel; the N
// spatial offsets are shared by the frame, drawn in every thread from
// path_key(0xD1CE, frame, 0, 8002); a neighbour counts where it is in the
// image, the tile's read is unclamped, its depth is within +-10%, its raw
// normal's dot is >= 0.906, it shades and M > 0; visibility is the segment
// test from the neighbour's sample point (+ n * 1e-12) to this pixel's
// visible point.
//
// Textures (megakernel_restir_gi.py:193-199, 966-972): K5 and K6 are built with
// and without the albedo fetch (shading.cuh::tex_surface); the primary hit
// reads the primary level, the path's hits after a scatter the bounce level,
// and K7 shades with the albedo K6 staged (GS_ALB).  The fetch is compiled
// with -fmad=false too.
//
// RNG: fold(fold(fold(pcg(pix), frame), 0), 8001), drawn u_sel, u1, u2, three a
// bounce after the first, u0, and ut under temporal reuse; K5 then folds 8002
// into that key, K7 starts from fold(..., 8002); one u_acc per neighbour.  A
// pixel that does not shade draws nothing (none of its outputs depends on its
// draws), and a visibility ray is traced only where it can change the merge
// (the neighbour counts and its p-hat > 0): both exact.
//
// What bounds it on an H100 (chip_smoke.py::gi_attribution, the section
// clocks below; PERF.md Findings): K5 and K6 run each tile as one block of C
// threads or, where the tiles are too few to fill the card, split over a
// cluster of blocks of 128 (tile.cuh).  A tile's 512 threads take 122-128
// registers, the whole register file of a multiprocessor: 16 warps.  The
// split blocks' bound sets no minimum, and ptxas gives them the same
// registers, 4 blocks of 128 a multiprocessor; at 5 every one spills.  Of
// the threads' cycles at Cornell 256² (1920x1088), K5 spends 34% (24%) in the path
// sample's closest-hit walks, 17% (20%) at the tile's reprojection sum,
// mostly waiting at its barrier for the tile's slowest path, 19% (31%) in
// spatial reuse's neighbour reads and Jacobian, 7% (3%) on the primary walk,
// 3% (5%) on the visibility walks and 19% (15%) in surface fetch, scatter
// and shading; K6 44% (38%) in the path's walks and 23% (32%) at the sum;
// on the stress scene the sum takes a third.  Each walk is a chain of
// dependent loads through the 4-wide BVH (wide.cuh::WideTracer:
// trace_closest_wide1 and segment_visible_wide1, inlined, each walk's stack
// in dynamic shared memory); one thread a pixel, reservoirs in registers,
// buffers read through __ldg.  Redesigns measured against this one in turns
// and dropped: one closest-hit walk site for the primary ray and the path
// (kernel_variants.py gi onewalk: 99-119 registers for a tile as one
// block; 0.88-0.96x at 256² and 1920x1088, 1.06-1.14x on the stress
// scene, where its split blocks ran 5 a multiprocessor); the primary hit
// and the tile's sum in a pass of their own before K5 and K6, which then
// run blocks of 128 without a cluster (20 warps at 96 registers, but the
// pass is one latency-bound wave of primary walks, 0.047 ms at 256², and
// K5 in blocks of 128 ran 1.27x slower at 1920x1088); the tile's sum moved
// to just after the primary hit (its barrier share fell to 4-14%, and K5
// and K6 ran 0.92-1.15x, slower at 256² and 1920x1088).  K7 sums nothing
// over its tile (the tile enters only through pix / C in spatial), so it
// needs no cluster: it runs blocks of 128, C / 128 of them a tile, which hold five
// blocks (20 warps) a multiprocessor at its 96 registers where one block of
// 512 is one (16); on an H100 they ran it 1.02x, 1.06x and 1.43x faster than
// one block of C a tile at Cornell 256², stress 128² and Cornell 1920x1088.
//
// K7 (chip_smoke.py::k7_attribution; PERF.md Findings): at Cornell 256²
// (stress 128², 1920x1088) its threads count 59% (75%, 64%) of their
// cycles in the neighbour tests, 6% (1%, 9%) in the Jacobian and 23% (11%,
// 21%) in the visibility walks; a warp's walk round finds 8.8 (3.5, 7.8)
// of its 32 lanes walking, and a lane that does not walk counts its wait
// for those that do in its next tests.  Reading every row of a
// neighbour before its tests, the Jacobian computed for every neighbour
// (L::kEager 2), cut its time to 0.97x at all three.  Each thread walking
// its own list of segments (kernel_variants.py gi vislist) needs 1/1.4 to
// 1/1.6 of the rounds and ran 0.76-0.78x on the stress scene and 0.92-0.96x
// at 1920x1088, but 1.04-1.06x at Cornell 256², where reading and testing
// the neighbours again costs more than the rounds it saves.
//
// Floating point: built with -fmad=false (ops/kernels.py), so no product is
// fused into a sum and every expression rounds as the plain PyTorch version's
// elementwise ops do; a reservoir decision compares floats and flips on one
// ulp.  cosf/sinf/powf remain the device library's.
//
// C interface (loaded with ctypes by render/megakernel_restir_gi.py):
// fyp_restir_gi launches one kernel, chosen by `kernel`, on the given stream
// (`clustered`: K5 and K6 split each tile over a cluster) and returns the
// launch's error, or cudaGetLastError(); fyp_restir_gi_occupancy reports K5's
// and K6's resident blocks and clusters; fyp_restir_gi_clocks (built with
// -DFYP_GI_CLOCKS) their section cycles, fyp_restir_gi_k7_clocks K7's with
// its block spans and visibility-walk counters.
#include "clocks.cuh"
#include "shading.cuh"
#include "tile.cuh"
#include "wide.cuh"

namespace {

using namespace fyp;

// stage rows
constexpr int GS_POS = 0;    // 0:3 visible point
constexpr int GS_NRM = 3;    // 3:6 visible normal
constexpr int GS_ALB = 6;    // 6:9
constexpr int GS_ROUGH = 9;
constexpr int GS_METAL = 10;
constexpr int GS_T = 11;     // -1 on a miss
constexpr int GS_SHADE = 12;
constexpr int GS_EMIT = 13;  // 13:16 primary emission
constexpr int GS_HIT = 16;
constexpr int GS_SKY = 17;   // 17:20 first-bounce sky term, shaded
constexpr int GS_SP = 20;    // 20:23 sample point
constexpr int GS_SN = 23;    // 23:26 sample normal
constexpr int GS_RAD = 26;   // 26:29 radiance from the sample point
constexpr int GS_PHAT = 29;
constexpr int GS_W = 30;
constexpr int GS_M = 31;
constexpr int GS_WSUM = 32;
// state rows
constexpr int GT_SP = 0;
constexpr int GT_SN = 3;
constexpr int GT_RAD = 6;
constexpr int GT_PHAT = 9;
constexpr int GT_W = 10;
constexpr int GT_M = 11;
constexpr int GT_WSUM = 12;
constexpr int GT_NRM = 13;  // 13:16

constexpr float kNormalTemporal = 0.99f;
constexpr float kNormalSpatial = 0.906f;

enum Kernel { kMono = 0, kMonoFinalVis = 1, kStage1 = 2, kStage2 = 3 };

struct Params {
  const float* cam;  // (2, 4, 4)
  const float* ppv;  // (4, 4) previous proj @ view, row-major
  int width, height;
  int C;             // pixels a tile
  uint32_t frame;
  int bounces;
  int neighbors;     // 0 without spatial reuse
  float radius;
  float history_limit;
  int temporal;
  float3 sky;
  Geo geo;
  Mats mats;
  Tex tex;                // the textured instantiations' levels
  WideBvh wide;
  const float* state_in;  // K5: previous state; K6: state
  const float* stage_in;  // K5: previous stage; K7: this frame's stage
  float* state_out;       // K5, K7
  float* stage_out;       // K5, K6
  float* accum;           // K5, K7: (B, 3), the frame's HDR added
};

// Cycles a thread spends in each section of K5 and K6, built with
// -DFYP_GI_CLOCKS (chip_smoke.py::gi_attribution): the whole kernel, the
// primary hit, the path sample's walks (first hit and continuation), the
// tile's reprojection sum with its barrier wait, the rest of temporal reuse,
// spatial reuse's row reads and Jacobian, the visibility walks (per neighbour
// or final_vis), and the stage, shade and state stores; the rest is the
// camera ray, surface fetch, scatter and shading.  Each warp adds its
// threads' sums into gi_clocks, which the C entry fyp_restir_gi_clocks hands
// over and clears.  Without the macro every call below compiles to nothing.
enum Section {
  kTotal = 0, kPrimary = 1, kPathWalks = 2, kTileSum = 3, kTemporal = 4, kSpatialReads = 5, kVisWalks = 6,
  kStores = 7, kSections = 8
};
#ifdef FYP_GI_CLOCKS
__device__ unsigned long long gi_clocks[kSections];
struct Clocks {
  long long c[kSections] = {};
  __device__ __forceinline__ long long now() const { return clock64(); }
  // adds the cycles since t0 to section s and returns them
  __device__ __forceinline__ long long add(int s, long long t0) {
    const long long dt = clock64() - t0;
    c[s] += dt;
    return dt;
  }
  __device__ __forceinline__ void sub(int s, long long dt) { c[s] -= dt; }
  // every thread of the warp calls it
  __device__ void flush() {
#pragma unroll
    for (int s = 0; s < kSections; ++s) {
      long long v = c[s];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if ((threadIdx.x & 31) == 0) atomicAdd(gi_clocks + s, static_cast<unsigned long long>(v));
    }
  }
};
#else
struct Clocks {
  __device__ __forceinline__ long long now() const { return 0; }
  __device__ __forceinline__ long long add(int, long long) { return 0; }
  __device__ __forceinline__ void sub(int, long long) {}
  __device__ __forceinline__ void flush() {}
};
#endif

// Cycles a thread of K7 spends in each section, also built with
// -DFYP_GI_CLOCKS (chip_smoke.py::k7_attribution): the whole kernel, its own
// stage reads, the neighbours' reads and tests (with the merge), the
// reconnection Jacobian, the visibility walks, the shade, and the accum and
// state writes; the rest is the keys and the camera ray.  Each warp adds its
// threads' sums into k7_clocks and its block's span into k7_spans
// (clocks.cuh), and after the sections its visibility walks: the lanes
// that walk summed over the warp's rounds (a round: a neighbour that any
// lane of the warp walks), the rounds, and the most walks of any one lane,
// over the first 32 neighbours.  The C entry fyp_restir_gi_k7_clocks hands
// them over and clears them.  Without the macro every call compiles to
// nothing.
enum K7Section {
  k7Total = 0, k7OwnReads = 1, k7NeighbourTests = 2, k7Jacobian = 3, k7VisWalks = 4, k7Shade = 5, k7Writes = 6,
  k7Sections = 7, k7WalkLanes = 7, k7WalkRounds = 8, k7LongestLists = 9, k7Sums = 10
};
#ifdef FYP_GI_CLOCKS
__device__ unsigned long long k7_clocks[k7Sums];
__device__ BlockSpans k7_spans;
struct K7Clocks : SectionClocks<k7Sections> {
  __device__ __forceinline__ void begin() const { SectionClocks::begin(k7_spans); }
  // every thread of the warp calls it, with bit k set where it walked
  // neighbour k's segment
  __device__ void walks(uint32_t walked, int n) const {
    unsigned long long lanes = 0, rounds = 0;
    for (int k = 0; k < min(n, 32); ++k) {
      const unsigned b = __ballot_sync(0xffffffffu, (walked >> k) & 1u);
      lanes += __popc(b);
      rounds += b != 0u ? 1u : 0u;
    }
    const unsigned longest = __reduce_max_sync(0xffffffffu, static_cast<unsigned>(__popc(walked)));
    if ((threadIdx.x & 31) == 0) {
      atomicAdd(k7_clocks + k7WalkLanes, lanes);
      atomicAdd(k7_clocks + k7WalkRounds, rounds);
      atomicAdd(k7_clocks + k7LongestLists, static_cast<unsigned long long>(longest));
    }
  }
  __device__ void flush() const { SectionClocks::flush(k7_clocks, k7_spans); }
};
#else
struct K7Clocks : NoClocks {
  __device__ __forceinline__ void walks(uint32_t, int) const {}
};
#endif

// The sections that spatial's and shade_out's clocks add to, for K5 and
// for K7: each is a lap, the cycles since the last mark, added at its end;
// and how spatial reads a neighbour's rows (kEager): 0, the tests in a
// chain of branches, each test's rows loaded after the test before; 1,
// every test's rows loaded first and the tests without a branch; 2, the
// reconnection Jacobian's rows and arithmetic too, for every neighbour,
// before its tests decide.  The same values and decisions in each.
struct K5Laps {
  static constexpr int kTests = kSpatialReads, kJacobian = kSpatialReads, kWalks = kVisWalks, kShade = kStores,
                       kWrites = kStores;
  static constexpr int kEager = 0;
};
struct K7Laps {
  static constexpr int kTests = k7NeighbourTests, kJacobian = k7Jacobian, kWalks = k7VisWalks, kShade = k7Shade,
                       kWrites = k7Writes;
  static constexpr int kEager = 2;
};

// A reservoir of path samples (megakernel_restir_gi.py::_gi_res_update).
struct PathRes {
  float3 sp, sn, rad;
  float phat, w, m, wsum;
};

// This pixel's primary hit as the stage holds it.
struct Own {
  float3 pos, n, alb, em, sky_direct;
  float rough, metal, t;
  bool hit, shade;
};

__device__ __forceinline__ float3 zero3() { return make_float3(0.0f, 0.0f, 0.0f); }

__device__ __forceinline__ float3 row3(const float* buf, int row, int B, int q) {
  return make_float3(__ldg(buf + row * B + q), __ldg(buf + (row + 1) * B + q), __ldg(buf + (row + 2) * B + q));
}

__device__ __forceinline__ float row1(const float* buf, int row, int B, int q) { return __ldg(buf + row * B + q); }

__device__ __forceinline__ void put3(float* buf, int row, int B, int q, float3 v) {
  buf[row * B + q] = v.x;
  buf[(row + 1) * B + q] = v.y;
  buf[(row + 2) * B + q] = v.z;
}

__device__ __forceinline__ void res_update(PathRes& r, float3 sp, float3 sn, float3 rad, float weight, float count,
                                           float pdf, float u) {
  const float wsum2 = r.wsum + weight;
  const float m2 = r.m + count;
  if (wsum2 > 0.0f && u < weight / wsum2) {
    r.sp = sp;
    r.sn = sn;
    r.rad = rad;
    r.phat = pdf;
  }
  r.wsum = wsum2;
  r.m = m2;
}

// W = wsum / (max(M, 1) p-hat)
__device__ __forceinline__ float w_of(const PathRes& r) {
  return r.phat > 0.0f ? r.wsum / (fmaxf(r.m, 1.0f) * r.phat) : 0.0f;
}

__device__ __forceinline__ float rad_norm(float3 r) { return sqrtf(fmaxf(dot(r, r), 0.0f)); }

// ---- the first half of a frame (K6; K5 before its spatial reuse) ------------------

// Primary hit, the BRDF path sample and temporal reuse of pixel pix, written to
// the stage; textured when T (the primary hit reads the primary level, the
// path's later hits the bounce level, megakernel_restir_gi.py:202-282); rays
// walked by tr.  Every thread of the tile must call it (the tile's
// reprojection offset is a reduction over the Tile, tile.cuh).
template <bool T, class Tracer, class Tile>
__device__ void stage1(const Params& P, const Tracer& tr, Clocks& clk, int pix, Own& o, PathRes& res,
                       uint32_t& key) {
  const int C = P.C;
  const int tile = pix / C;
  const int lane = pix - tile * C;
  const int B = P.width * P.height;

  float3 orig, dir;
  camera_ray(P.cam, P.width, P.height, pix, orig, dir);
  const float3 view = -dir;
  long long t0 = clk.now();
  const Hit h0 = tr.closest(orig, dir);
  clk.add(kPrimary, t0);
  o.hit = h0.tri >= 0;
  Surf s0{};
  o.em = zero3();
  if (o.hit) {
    s0 = tex_surface<T>(P.geo, P.mats, P.tex, h0, orig, dir, false);
    o.em = emission_of(P.mats, s0.mat);
  }
  o.shade = o.hit && !(dot(o.em, o.em) > 0.0f);
  o.pos = s0.pos;
  o.n = s0.n;
  o.alb = s0.alb;
  o.rough = s0.rough;
  o.metal = s0.metal;
  o.t = o.hit ? h0.t : -1.0f;
  o.sky_direct = zero3();
  res = PathRes{zero3(), zero3(), zero3(), 0.0f, 0.0f, 0.0f, 0.0f};
  key = fold(fold(fold(pcg(static_cast<uint32_t>(pix)), P.frame), 0u), 8001u);

  if (o.shade) {
    // ---- the BRDF path sample (megakernel_restir_gi.py:993-1092)
    const float u_sel = next_uniform(key);
    const float u1 = next_uniform(key);
    const float u2 = next_uniform(key);
    float3 d0;
    const float pdf0 = mixture_sample(o.n, view, o.alb, o.metal, o.rough, u_sel, u1, u2, d0);
    const float3 f0 = cook_torrance(o.n, view, d0, o.alb, o.metal, o.rough);
    const float cos0 = fmaxf(dot(d0, o.n), 0.0f);
    const float3 o1 = o.pos + o.n * kOriginEps;
    t0 = clk.now();
    const Hit h1 = tr.closest(o1, d0);
    clk.add(kPathWalks, t0);
    const bool hit1 = h1.tri >= 0;
    Surf s1{};
    float3 em1 = zero3();
    if (hit1) {
      s1 = tex_surface<T>(P.geo, P.mats, P.tex, h1, o1, d0, true);
      em1 = emission_of(P.mats, s1.mat);
    }
    const bool reconnect = hit1 && pdf0 > 0.0f;
    const float fterm = cos0 / fmaxf(pdf0, 1e-12f);
    if (!hit1 && pdf0 > 0.0f) o.sky_direct = f0 * fterm * P.sky;

    // the path continues from the sample point with unit throughput
    float3 rad = zero3();
    const bool em1_hit = dot(em1, em1) > 0.0f;
    if (reconnect && em1_hit) rad = em1;
    bool active = reconnect && !em1_hit;
    float3 thr = make_float3(1.0f, 1.0f, 1.0f);
    Surf cur = s1;
    float3 cd = d0;
    for (int b = 0; b < P.bounces - 1; ++b) {
      const float r1 = next_uniform(key);
      const float r2 = next_uniform(key);
      const float r3 = next_uniform(key);
      if (!active) continue;
      const float3 bv = -cd;
      float3 l;
      const float pdf = mixture_sample(cur.n, bv, cur.alb, cur.metal, cur.rough, r1, r2, r3, l);
      const float3 f = cook_torrance(cur.n, bv, l, cur.alb, cur.metal, cur.rough);
      const float scale = fmaxf(dot(l, cur.n), 0.0f) / fmaxf(pdf, 1e-12f);
      thr = thr * f * scale;
      if (!(pdf > 0.0f)) {
        active = false;
        continue;
      }
      const float3 no = cur.pos + cur.n * kOriginEps;
      const long long tw = clk.now();
      const Hit h = tr.closest(no, l);
      clk.add(kPathWalks, tw);
      if (h.tri < 0) {
        rad = rad + thr * P.sky;
        active = false;
        continue;
      }
      const Surf nxt = tex_surface<T>(P.geo, P.mats, P.tex, h, no, l, true);
      const float3 em = emission_of(P.mats, nxt.mat);
      if (dot(em, em) > 0.0f) {
        rad = rad + thr * em;
        active = false;
        continue;
      }
      cur = nxt;
      cd = l;
    }
    if (!reconnect) rad = zero3();
    const float src_pdf = reconnect ? pdf0 : 0.0f;
    const float p_hat = rad_norm(rad);
    const float u0 = next_uniform(key);
    const float w_ris = src_pdf > 0.0f ? p_hat / fmaxf(src_pdf, 1e-12f) : 0.0f;
    res_update(res, s1.pos, s1.n, rad, w_ris, 1.0f, p_hat, u0);
    res.w = w_of(res);
  }

  if (P.temporal) {
    // ---- temporal reuse through the tile-shared reprojection (:1095-1164)
    const long long tt = clk.now();
    int prev_pix = 0;
    if (o.shade) {
      const float* pv = P.ppv;
      auto prow = [&](int r) {
        return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(__ldg(pv + 4 * r), o.pos.x), __fmul_rn(__ldg(pv + 4 * r + 1), o.pos.y)),
                                   __fmul_rn(__ldg(pv + 4 * r + 2), o.pos.z)),
                         __ldg(pv + 4 * r + 3));
      };
      const float cxp = prow(0), cyp = prow(1), cwp = prow(3);
      const bool wok = fabsf(cwp) >= 1e-20f;
      const float inv_w = 1.0f / (wok ? cwp : 1.0f);
      const float u = __fadd_rn(__fmul_rn(wok ? __fmul_rn(cxp, inv_w) : 0.0f, 0.5f), 0.5f);
      const float v = __fadd_rn(__fmul_rn(wok ? __fmul_rn(cyp, inv_w) : 0.0f, 0.5f), 0.5f);
      const int ppx = min(max(static_cast<int>(__fmul_rn(u, static_cast<float>(P.width))), 0), P.width - 1);
      const int ppy = min(max(static_cast<int>(__fmul_rn(__fsub_rn(1.0f, v), static_cast<float>(P.height))), 0),
                          P.height - 1);
      prev_pix = ppx + ppy * P.width;
    }
    const long long ts = clk.now();
    const int2 sum = Tile::sum(o.shade, prev_pix - pix);
    clk.sub(kTemporal, clk.add(kTileSum, ts));
    const int off = static_cast<int>(rintf(static_cast<float>(sum.x) / fmaxf(static_cast<float>(sum.y), 1.0f)));
    const int q = min(max(tile * C + off, 0), B - C) + lane;
    if (o.shade) {
      const float* st = P.state_in;
      const float p_m = row1(st, GT_M, B, q);
      const bool valid = dot(row3(st, GT_NRM, B, q), o.n) >= kNormalTemporal && p_m > 0.0f && q == prev_pix;
      const float prev_m = fminf(p_m, P.history_limit * fmaxf(res.m, 1.0f));
      const float ut = next_uniform(key);
      if (valid) {
        const float p_prev = row1(st, GT_PHAT, B, q);
        res_update(res, row3(st, GT_SP, B, q), row3(st, GT_SN, B, q), row3(st, GT_RAD, B, q),
                   p_prev * row1(st, GT_W, B, q) * prev_m, prev_m, p_prev, ut);
        res.w = w_of(res);
      }
    }
    clk.add(kTemporal, tt);
  }
}

__device__ void write_stage(float* sg, int B, int pix, const Own& o, const PathRes& res) {
  put3(sg, GS_POS, B, pix, o.pos);
  put3(sg, GS_NRM, B, pix, o.n);
  put3(sg, GS_ALB, B, pix, o.alb);
  sg[GS_ROUGH * B + pix] = o.rough;
  sg[GS_METAL * B + pix] = o.metal;
  sg[GS_T * B + pix] = o.t;
  sg[GS_SHADE * B + pix] = o.shade ? 1.0f : 0.0f;
  put3(sg, GS_EMIT, B, pix, o.em);
  sg[GS_HIT * B + pix] = o.hit ? 1.0f : 0.0f;
  put3(sg, GS_SKY, B, pix, o.sky_direct);
  put3(sg, GS_SP, B, pix, res.sp);
  put3(sg, GS_SN, B, pix, res.sn);
  put3(sg, GS_RAD, B, pix, res.rad);
  sg[GS_PHAT * B + pix] = res.phat;
  sg[GS_W * B + pix] = res.w;
  sg[GS_M * B + pix] = res.m;
  sg[GS_WSUM * B + pix] = res.wsum;
}

// ---- the second half (K7; K5 after its stage) ---------------------------------

// Spatial reuse of res over the frame's neighbours read from nb (a stage
// buffer), with per-neighbour visibility walked by tr when vis
// (megakernel_restir_gi.py: 1185-1373 and 447-661), the neighbours in
// rounds: round k tests neighbour k (in the image, the tile's read
// unclamped, depth, normal, shading, M > 0), computes its p-hat through
// the reconnection Jacobian and walks its segment.  Returns bit k set where
// it walked neighbour k's segment (k < 32).  Laps of L on clk.
template <class L, class Tracer, class Clk>
__device__ uint32_t spatial(const Params& P, const Tracer& tr, Clk& clk, const float* nb, int pix, const Own& o,
                            PathRes& res, uint32_t& key, bool vis) {
  long long t = clk.now();
  const int C = P.C;
  const int tile = pix / C;
  const int lane = pix - tile * C;
  const int B = P.width * P.height;
  const int px = pix % P.width, py = pix / P.width;
  float z = o.shade ? res.m : 0.0f;
  uint32_t walked = 0;
  uint32_t okey = fold(fold(fold(pcg(0xD1CEu), P.frame), 0u), 8002u);
  for (int k = 0; k < P.neighbors; ++k) {
    const float ux = next_uniform(okey);
    const float uy = next_uniform(okey);
    const float u_acc = next_uniform(key);
    if (!o.shade) continue;
    const int dx = static_cast<int>(__fmul_rn(__fsub_rn(__fmul_rn(ux, 2.0f), 1.0f), P.radius));
    const int dy = static_cast<int>(__fmul_rn(__fsub_rn(__fmul_rn(uy, 2.0f), 1.0f), P.radius));
    const int s = tile * C + dy * P.width + dx;
    const int sc = min(max(s, 0), B - C);
    const int q = sc + lane;
    const bool in_img = px + dx >= 0 && px + dx < P.width && py + dy >= 0 && py + dy < P.height;
    const float n_t = row1(nb, GS_T, B, q);
    bool ok;
    if constexpr (L::kEager > 0) {
      // every row the tests read, loaded before any test and tested without
      // a branch (q lies in [0, B) whatever the offset)
      ok = in_img & (s == sc) & (n_t <= 1.1f * o.t) & (n_t >= 0.9f * o.t) &
           (dot(row3(nb, GS_NRM, B, q), o.n) >= kNormalSpatial) & (row1(nb, GS_SHADE, B, q) > 0.5f) &
           (row1(nb, GS_M, B, q) > 0.0f);
    } else {
      ok = in_img && s == sc && n_t <= 1.1f * o.t && n_t >= 0.9f * o.t &&
           dot(row3(nb, GS_NRM, B, q), o.n) >= kNormalSpatial && row1(nb, GS_SHADE, B, q) > 0.5f &&
           row1(nb, GS_M, B, q) > 0.0f;
    }
    if constexpr (L::kEager < 2) {
      if (!ok) continue;
      t += clk.add(L::kTests, t);
    }

    // Jacobian of path reconnection (eq. 11, Renderer.cu:2343-2353)
    const float3 spn = row3(nb, GS_SP, B, q);
    const float3 snn = row3(nb, GS_SN, B, q);
    const float3 radn = row3(nb, GS_RAD, B, q);
    const float3 dq = row3(nb, GS_POS, B, q) - spn;
    const float3 dr = o.pos - spn;
    const float dist_q = sqrtf(fmaxf(dot(dq, dq), 1e-20f));
    const float dist_r = sqrtf(fmaxf(dot(dr, dr), 1e-20f));
    const float cos_q = dot(snn, dq) / dist_q;
    const float cos_r = dot(snn, dr) / dist_r;
    const float jac = (cos_q > 0.0f ? cos_r / fmaxf(cos_q, 1e-12f) : 0.0f) * (dist_q * dist_q) /
                      fmaxf(dist_r * dist_r, 1e-20f);
    float p_n = jac > 0.0f ? rad_norm(radn) / fmaxf(jac, 1e-12f) : 0.0f;
    if constexpr (L::kEager == 2) {
      if (!ok) continue;
    }
    t += clk.add(L::kJacobian, t);
    if (vis && p_n > 0.0f) {
      walked |= k < 32 ? 1u << k : 0u;
      if (!tr.visible(spn + snn * kOriginEps, dr / dist_r, dist_r)) p_n = 0.0f;
      t += clk.add(L::kWalks, t);
    }
    const float nb_m = row1(nb, GS_M, B, q);
    z = z + nb_m;
    res_update(res, spn, snn, radn, p_n * row1(nb, GS_W, B, q) * nb_m, nb_m, p_n, u_acc);
  }
  res.w = res.phat > 0.0f ? res.wsum / (fmaxf(z, 1.0f) * res.phat) : 0.0f;
  clk.add(L::kTests, t);
  return walked;
}

// The shade (restir_gi._shade), the frame's HDR added to accum and the state
// written; final_vis traces one visibility ray for the winner, walked by tr.
template <class L, class Tracer, class Clk>
__device__ void shade_out(const Params& P, const Tracer& tr, Clk& clk, int pix, const Own& o, const PathRes& res,
                          float3 view, bool final_vis) {
  long long t = clk.now();
  const int B = P.width * P.height;
  float3 hdr;
  if (!o.hit) {
    hdr = P.sky;
  } else if (!o.shade) {
    hdr = o.em;
  } else {
    const float3 ts = res.sp - o.pos;
    const float dist = sqrtf(fmaxf(dot(ts, ts), 1e-20f));
    const float3 sd = ts / dist;
    bool lane_ok = res.w > 0.0f;
    if (lane_ok && final_vis) {
      t += clk.add(L::kShade, t);
      lane_ok = tr.visible(res.sp + res.sn * kOriginEps, -sd, dist);
      t += clk.add(L::kWalks, t);
    }
    float3 gi = zero3();
    if (lane_ok) {
      const float3 f = cook_torrance(o.n, view, sd, o.alb, o.metal, o.rough);
      const float cos_t = fmaxf(dot(sd, o.n), 0.0f);
      gi = f * cos_t * res.w * res.rad;
    }
    hdr = gi + o.sky_direct;
  }
  t += clk.add(L::kShade, t);
  P.accum[3 * pix + 0] += hdr.x;
  P.accum[3 * pix + 1] += hdr.y;
  P.accum[3 * pix + 2] += hdr.z;

  float* st = P.state_out;
  put3(st, GT_SP, B, pix, res.sp);
  put3(st, GT_SN, B, pix, res.sn);
  put3(st, GT_RAD, B, pix, res.rad);
  st[GT_PHAT * B + pix] = res.phat;
  st[GT_W * B + pix] = res.w;
  st[GT_M * B + pix] = res.m;
  st[GT_WSUM * B + pix] = res.wsum;
  put3(st, GT_NRM, B, pix, o.n);
  clk.add(L::kWrites, t);
}

// ---- the kernels ---------------------------------------------------------------------

// K5: the whole frame, each tile a cluster of blocks of kThreads threads
// (kTileBlock: split, kTileMax: one block), the walks through the wide BVH;
// spatial reuse reads the previous frame's stage.
template <bool kFinalVis, bool T, int kThreads>
__global__ void __launch_bounds__(kThreads) gi_mono(Params P) {
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  const int B = P.width * P.height;
  const WideTracer tr{P.wide, lane_stack(P.wide.stack_depth)};
  Clocks clk;
  const long long t_all = clk.now();
  Own o;
  PathRes res;
  uint32_t key;
  stage1<T, WideTracer, ClusterTile>(P, tr, clk, pix, o, res, key);
  const long long ts = clk.now();
  write_stage(P.stage_out, B, pix, o, res);
  clk.add(kStores, ts);
  key = fold(key, 8002u);
  if (P.neighbors > 0) spatial<K5Laps>(P, tr, clk, P.stage_in, pix, o, res, key, !kFinalVis);
  float3 orig, dir;
  camera_ray(P.cam, P.width, P.height, pix, orig, dir);
  shade_out<K5Laps>(P, tr, clk, pix, o, res, -dir, kFinalVis && P.neighbors > 0);
  clk.add(kTotal, t_all);
  clk.flush();
}

// K6: the stage of this frame, each tile a cluster of blocks of kThreads
// threads as K5's, the walks through the wide BVH.
template <bool T, int kThreads>
__global__ void __launch_bounds__(kThreads) gi_stage1(Params P) {
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  const WideTracer tr{P.wide, lane_stack(P.wide.stack_depth)};
  Clocks clk;
  const long long t_all = clk.now();
  Own o;
  PathRes res;
  uint32_t key;
  stage1<T, WideTracer, ClusterTile>(P, tr, clk, pix, o, res, key);
  const long long ts = clk.now();
  write_stage(P.stage_out, P.width * P.height, pix, o, res);
  clk.add(kStores, ts);
  clk.add(kTotal, t_all);
  clk.flush();
}

// K7: same-frame spatial reuse from K6's stage, the shade, the state;
// blocks of kTileBlock threads, C / kTileBlock of them a tile, without a
// cluster; the walks through the wide BVH.
__global__ void __launch_bounds__(kTileBlock) gi_stage2(Params P) {
  K7Clocks clk;
  clk.begin();
  const long long t_all = clk.now();
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  const int B = P.width * P.height;
  const WideTracer tr{P.wide, lane_stack(P.wide.stack_depth)};
  const float* sg = P.stage_in;
  const long long t0 = clk.now();
  Own o;
  o.pos = row3(sg, GS_POS, B, pix);
  o.n = row3(sg, GS_NRM, B, pix);
  o.alb = row3(sg, GS_ALB, B, pix);
  o.em = row3(sg, GS_EMIT, B, pix);
  o.sky_direct = row3(sg, GS_SKY, B, pix);
  o.rough = row1(sg, GS_ROUGH, B, pix);
  o.metal = row1(sg, GS_METAL, B, pix);
  o.t = row1(sg, GS_T, B, pix);
  o.hit = row1(sg, GS_HIT, B, pix) > 0.5f;
  o.shade = row1(sg, GS_SHADE, B, pix) > 0.5f;
  PathRes res{row3(sg, GS_SP, B, pix), row3(sg, GS_SN, B, pix), row3(sg, GS_RAD, B, pix), row1(sg, GS_PHAT, B, pix),
              row1(sg, GS_W, B, pix), row1(sg, GS_M, B, pix), row1(sg, GS_WSUM, B, pix)};
  clk.add(k7OwnReads, t0);
  uint32_t key = fold(fold(fold(pcg(static_cast<uint32_t>(pix)), P.frame), 0u), 8002u);
  uint32_t walked = 0;
  if (P.neighbors > 0) walked = spatial<K7Laps>(P, tr, clk, sg, pix, o, res, key, true);
  clk.walks(walked, P.neighbors);
  float3 orig, dir;
  camera_ray(P.cam, P.width, P.height, pix, orig, dir);
  shade_out<K7Laps>(P, tr, clk, pix, o, res, -dir, false);
  clk.add(k7Total, t_all);
  clk.flush();
}

using TileKernel = void (*)(Params);

template <int kThreads>
TileKernel tile_kernel_of(Kernel kernel, bool textured) {
  switch (kernel) {
    case kMono:
      return textured ? gi_mono<false, true, kThreads> : gi_mono<false, false, kThreads>;
    case kMonoFinalVis:
      return textured ? gi_mono<true, true, kThreads> : gi_mono<true, false, kThreads>;
    case kStage1:
      return textured ? gi_stage1<true, kThreads> : gi_stage1<false, kThreads>;
    default:
      return nullptr;
  }
}

// K5's (final_vis or not) or K6's instantiation for texturing and a tile split
// over a cluster; null for K7, which launches without one
TileKernel tile_kernel(int kernel, bool textured, bool clustered) {
  const Kernel k = static_cast<Kernel>(kernel);
  return clustered ? tile_kernel_of<kTileBlock>(k, textured) : tile_kernel_of<kTileMax>(k, textured);
}

}  // namespace

extern "C" int fyp_restir_gi(
    int kernel, const void* cam, const void* ppv, int width, int height, unsigned int frame, int lanes, int clustered,
    int bounces,
    int neighbors, float radius, float history_limit, int temporal, float sky_r, float sky_g, float sky_b,
    const void* positions, const void* normals, const void* tri_v, const void* tri_mat, const void* uvs,
    const void* albedo, const void* roughness, const void* metallic, const void* emission, const void* albedo_map,
    int textured, const void* tex_prim, const void* tex_bounce, int tex_k, int tex_hp, int tex_wp, int tex_hb,
    int tex_wb, const void* wide_nodes, const void* wide_tris, void* wide_overflow, int wide_stack_depth,
    const void* state_in, const void* stage_in, void* state_out, void* stage_out, void* accum, void* stream) {
  const int n_pix = width * height;
  if (n_pix <= 0) return 0;
  if (lanes <= 0 || lanes > 512 || n_pix % lanes != 0 || (textured && tex_k < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (kernel < kMono || kernel > kStage2) return static_cast<int>(cudaErrorInvalidValue);
  const TileKernel tiled = tile_kernel(kernel, textured != 0, clustered != 0);
  size_t smem = 0;
  if (!tile_fits(lanes, tiled == nullptr || clustered != 0, wide_stack_depth, &smem))
    return static_cast<int>(cudaErrorInvalidValue);
  auto F = [](const void* p) { return static_cast<const float*>(p); };
  auto I = [](const void* p) { return static_cast<const int*>(p); };
  Params P;
  P.cam = F(cam);
  P.ppv = F(ppv);
  P.width = width;
  P.height = height;
  P.C = lanes;
  P.frame = frame;
  P.bounces = bounces;
  P.neighbors = neighbors;
  P.radius = radius;
  P.history_limit = history_limit;
  P.temporal = temporal;
  P.sky = make_float3(sky_r, sky_g, sky_b);
  P.geo = Geo{F(positions), F(normals), I(tri_v), I(tri_mat), F(uvs)};
  P.mats = Mats{F(albedo), F(roughness), F(metallic), F(emission), I(albedo_map)};
  P.tex = Tex{static_cast<const float4*>(tex_prim), static_cast<const float4*>(tex_bounce), tex_k, tex_hp, tex_wp,
              tex_hb, tex_wb};
  P.wide = WideBvh{static_cast<const float4*>(wide_nodes), static_cast<const float4*>(wide_tris),
                   static_cast<int*>(wide_overflow), wide_stack_depth};
  P.state_in = F(state_in);
  P.stage_in = F(stage_in);
  P.state_out = static_cast<float*>(state_out);
  P.stage_out = static_cast<float*>(stage_out);
  P.accum = static_cast<float*>(accum);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tiled == nullptr) {
    // K7: blocks of kTileBlock threads, no cluster
    cudaError_t e = allow_stack_smem(gi_stage2, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    gi_stage2<<<n_pix / kTileBlock, kTileBlock, smem, s>>>(P);
    return static_cast<int>(cudaGetLastError());
  }
  cudaError_t e = allow_stack_smem(tiled, smem);
  if (e == cudaSuccess) e = launch_tiles(tiled, n_pix, lanes, tile_threads(lanes, clustered != 0), smem, s, P);
  return static_cast<int>(e);
}

// The blocks of K5 (kernel kMono or kMonoFinalVis) or K6 (kStage1), textured
// or not, split or not, one multiprocessor holds at once, and the clusters
// the card holds at once, for tiles of lanes pixels and stacks of
// wide_stack_depth entries, by the CUDA runtime.
extern "C" int fyp_restir_gi_occupancy(int kernel, int textured, int lanes, int clustered, int wide_stack_depth,
                                       int* blocks_per_sm, int* clusters) {
  size_t smem = 0;
  const TileKernel k = kernel >= kMono && kernel <= kStage1 ? tile_kernel(kernel, textured != 0, clustered != 0)
                                                            : nullptr;
  if (k == nullptr || !tile_fits(lanes, clustered != 0, wide_stack_depth, &smem))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = allow_stack_smem(k, smem);
  const int threads = tile_threads(lanes, clustered != 0);
  if (e == cudaSuccess) e = tile_occupancy(k, lanes, threads, smem, blocks_per_sm, clusters);
  return static_cast<int>(e);
}

#ifdef FYP_GI_CLOCKS
// K7's cycles of each section (K7Section) summed over every thread of every
// launch since the last call, then its walk counters, as k7Sums unsigned
// 64-bit ints copied to sums_out, and the first n_blocks blocks' spans as
// (2, n_blocks) unsigned 64-bit ints copied to spans_out (both on the
// card); then all cleared, on the stream.
extern "C" int fyp_restir_gi_k7_clocks(void* sums_out, void* spans_out, int n_blocks, void* stream) {
  void* sums = nullptr;
  void* spans = nullptr;
  cudaError_t e = cudaGetSymbolAddress(&sums, k7_clocks);
  if (e == cudaSuccess) e = cudaGetSymbolAddress(&spans, k7_spans);
  if (e == cudaSuccess)
    e = read_clocks(static_cast<unsigned long long*>(sums), k7Sums, static_cast<BlockSpans*>(spans), sums_out,
                    spans_out, n_blocks, static_cast<cudaStream_t>(stream));
  return static_cast<int>(e);
}

// The cycles of each section (Section) of K5 and K6 summed over every thread
// of every launch since the last call, as kSections unsigned 64-bit ints
// copied to out (on the card), and the sums cleared, on the stream.
extern "C" int fyp_restir_gi_clocks(void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemcpyFromSymbolAsync(out, gi_clocks, sizeof(gi_clocks), 0, cudaMemcpyDeviceToDevice, st);
  void* sums = nullptr;
  if (e == cudaSuccess) e = cudaGetSymbolAddress(&sums, gi_clocks);
  if (e == cudaSuccess) e = cudaMemsetAsync(sums, 0, sizeof(gi_clocks), st);
  return static_cast<int>(e);
}
#endif
