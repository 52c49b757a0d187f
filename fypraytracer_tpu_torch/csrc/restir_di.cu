// ReSTIR DI as two kernels per frame: K3 (primary hit, RIS candidates,
// temporal reuse) and K4 (spatial reuse, shadow ray, shade).
//
// Replaces the TPU kernels fypraytracer_tpu/render/megakernel_restir.py::k1
// (:243, launched at :678) and ::k2 (:417, launched at :718), the reference's
// own split (Renderer.cu:166-224).  The host launches K3 then K4 for each frame
// on one stream; the launch boundary orders them, so one stage buffer and one
// state buffer suffice:
//   K3 reads the state (previous frame) and writes the stage;
//   K4 reads the stage (this frame, any pixel) and writes the state (own pixel).
// Both buffers are SoA, (rows, B) float32 with B = width * height, rows named by
// the S_* and ST_* constants below (megakernel_restir.py:101-126 without the
// padding rows); reservoir indices and counts are stored as floats, as there.
//
// The semantics are the megakernel's, not the wavefront's (render/restir_di.py):
//   * pixels are linear; a tile is C consecutive pixels (tile.cuh,
//     C = render/restir_common.py::pick_ray_lanes(B)): K3 runs it as one
//     block of C threads or split over a cluster of blocks of 128, K4 as
//     C / 128 blocks of 128 (no cluster: K4 has no tile sum, and its reads
//     need only the tile's index pix / C);
//   * candidates are uniform over the emissive list with p-hat at the emitter's
//     centroid (:219-240, :313-325), dist^-1 by rsqrtf.  p-hat depends on
//     the pixel's surface and the emitter only, so where the list holds at
//     most kPhatTable emitters K3 evaluates each once, after the surface,
//     and reads every candidate's value from that table, the same bits
//     (tests/test_torch_k3_phat.py holds the premise); a pixel that does
//     not shade evaluates none, since its reservoir takes no candidate;
//   * temporal reuse: each shading pixel reprojects its hit point through ppv;
//     the tile reads the previous state at ONE offset, rint(mean(prev_pix -
//     pix)) over its shading pixels (summed as integers), clamped to [0, B - C];
//     a pixel keeps history only where the pixel read is its exact prev_pix,
//     the normals agree (dot >= 0.99), M > 0; history is capped at limit * M
//     (:327-399);
//   * spatial reuse: N offsets per frame, shared by every pixel, drawn from
//     path_key(0xD1CE, frame, 0, 7002) (:753-762; each thread draws them
//     itself); a neighbour counts only when it is in the image, the tile's read
//     at that offset is unclamped, its depth is within +-10%, its normal dot is
//     >= 0.906 and it shades (:489-544);
//   * the shadow ray leaves pos + n * 1e-12 towards a uniform point on the
//     chosen emitter; visible means its closest hit is that emitter; an escaping
//     shadow ray adds the sky (:546-590).  K4 walks it first bounded by the
//     emitter, t_max = dist + tol, tol = max(1e-4, 1e-3 dist) (K2's NEE rule,
//     megakernel.cu), and walks it again unbounded only where that walk
//     finds no hit: a bounded walk finds every hit nearer than t_max as the
//     unbounded walk does (ties to the lowest id), so where it finds one it
//     is the unbounded walk's closest hit, and where it finds none the second
//     walk tells an escaping ray (the sky) from one blocked past the emitter.
//     Both passes run at one inlined walk site; the result is the unbounded
//     walk's, bit for bit (tests/test_torch_k4_shadow.py holds the premise
//     and counts the second passes);
//   * textures (megakernel_restir.py:278-288): K3 is built with and without
//     the albedo fetch (shading.cuh::tex_surface); its primary hit reads the
//     primary level, and K4 shades with the albedo K3 staged (S_ALB);
//   * keys: fold(fold(fold(pcg(pix), frame), 0), 7001) in K3, 7002 in K4; draws
//     in K3: u_sel, u_acc per candidate, then the two temporal draws; in K4: one
//     for self, one per neighbour, then two for the point on the emitter.
//
// What bounds it on an H100: two BVH walks per pixel per frame (primary in K3,
// shadow in K4), chains of dependent loads, and the candidate p-hat
// evaluations (M + 1 in K3, ne + 1 where the table serves; N + 1 in K4,
// each a Cook-Torrance evaluation); the
// stage and state rows are read and written once per frame, coalesced (22 + 9
// rows of 4 B per pixel), plus N neighbour reads of 8 rows that stay in L2.
// The emissive table is a few floats per emitter.  One thread per pixel, state
// in global memory, reads through __ldg.  Both walk the 4-wide BVH
// (wide.cuh::WideTracer, inlined, each thread's stack in dynamic shared
// memory).  K3 runs each tile as one block or, where the tiles are too few
// to fill the card, split over a cluster of blocks of 128 (tile.cuh).  K4
// runs every frame in blocks of 128, which need no cluster: at 77 registers
// a thread an SM holds six of them against one block of 512, and they beat
// one block a tile at every shape timed, by 1.46x at 1920x1088 (on an H100,
// PERF.md Findings).  Of K3's threads' cycles at Cornell 256² (stress 128²,
// 1920x1088) the candidate loop took 34% (19%, 37%) before the table, the
// primary walk 25% (38%, 18%) and the tile's sum, mostly its barrier's
// wait for the tile's slowest walk, 22% (33%, 25%); the table cut K3's
// time to 0.93x (0.93x, 0.73x), at 64 registers without a spill (p_prev
// from the table too spills 4 bytes: it is evaluated).
//
// Built with -DFYP_DI_CLOCKS, K3 and K4 count the cycles of their sections
// and each block its span on the card's clock (K3Clocks and Clocks below,
// clocks.cuh) for chip_smoke.py::di_attribution.
//
// C interface (loaded with ctypes by render/megakernel_restir.py): each entry
// launches one kernel on the given stream and returns the launch's error (K3)
// or cudaGetLastError() (K4); fyp_restir_di_k3_occupancy reports K3's resident
// blocks and clusters; fyp_restir_di_k3_clocks and fyp_restir_di_clocks
// (built with -DFYP_DI_CLOCKS) hand over K3's and K4's section cycles and
// block spans since their last call.
#include "clocks.cuh"
#include "shading.cuh"
#include "tile.cuh"
#include "wide.cuh"

namespace {

using namespace fyp;

// stage rows (K3 -> K4)
constexpr int S_POS = 0;     // 0:3
constexpr int S_NRM = 3;     // 3:6
constexpr int S_ALB = 6;     // 6:9
constexpr int S_ROUGH = 9;
constexpr int S_METAL = 10;
constexpr int S_T = 11;      // -1 on a miss
constexpr int S_SHADE = 12;  // 1 where the pixel shades (hit, not emissive)
constexpr int S_EMIT = 13;   // 13:16 primary emission
constexpr int S_HIT = 16;
constexpr int S_RIDX = 17;   // reservoir: index, W, p-hat, wsum, M
constexpr int S_RW = 18;
constexpr int S_RPDF = 19;
constexpr int S_RWSUM = 20;
constexpr int S_RM = 21;

// state rows (K4 -> next frame's K3)
constexpr int ST_RIDX = 0;
constexpr int ST_RW = 1;
constexpr int ST_RPDF = 2;
constexpr int ST_RWSUM = 3;
constexpr int ST_RM = 4;
constexpr int ST_NRM = 5;  // 5:8
constexpr int ST_T = 8;

constexpr float kNormalTemporal = 0.99f;  // Renderer.cu:1772
constexpr float kNormalSpatial = 0.906f;  // Renderer.cu:1935

struct Emitters {          // render/megakernel_restir.py::prepare_emissive_table
  const float* p0;         // (E, 3)
  const float* e1;         // (E, 3) p1 - p0
  const float* e2;         // (E, 3) p2 - p0
  const float* area;       // (E,)
  const float* normal;     // (E, 3) averaged vertex normal
  const float* emission;   // (E, 3)
  const float* centroid;   // (E, 3)
  const int* tri;          // (E,) triangle id
  int n;
};

struct Res {
  float idx, w, p, wsum, m;
};

// megakernel_restir.py::_res_update
__device__ __forceinline__ void res_update(Res& r, float cand, float weight, float count, float pdf, float u,
                                           bool active) {
  float wsum2 = r.wsum + (active ? weight : 0.0f);
  float m2 = r.m + (active ? count : 0.0f);
  bool accept = active && wsum2 > 0.0f && u < weight / (wsum2 > 0.0f ? wsum2 : 1.0f);
  if (accept) {
    r.idx = cand;
    r.p = pdf;
  }
  r.wsum = wsum2;
  r.m = m2;
}

__device__ __forceinline__ int slot(const Emitters& E, float idx) {
  return min(max(static_cast<int>(idx), 0), E.n - 1);
}

// p-hat at the emitter's centroid (megakernel_restir.py:219-240)
__device__ float p_hat(const Emitters& E, int e, float3 pos, float3 n, float3 view, float3 alb, float rough,
                       float metal) {
  float3 tl = ldg3(E.centroid, e) - pos;
  float dist2 = fmaxf(dot(tl, tl), 1e-20f);
  float3 l = tl * rsqrtf(dist2);
  float3 f = cook_torrance(n, view, l, alb, metal, rough);
  float cos_x = fmaxf(dot(l, n), 0.0f);
  float cos_y = fmaxf(-dot(l, ldg3(E.normal, e)), 0.0f);
  float area = fmaxf(__ldg(E.area + e), 1e-20f);
  float scale = cos_x * cos_y * area / dist2;
  float3 r = f * scale * ldg3(E.emission, e);
  return sqrtf(fmaxf(dot(r, r), 0.0f));
}

// K3 evaluates p-hat once per emitter where the emissive list holds at most
// kPhatTable emitters (the Cornell box and the stress scene hold 2), and
// reads each candidate's value from that table
constexpr int kPhatTable = 4;

// the table's entry for emitter e (0 <= e < kPhatTable), selected by
// compares: a runtime index into a local array would put it in local memory
__device__ __forceinline__ float phat_of(const float (&t)[kPhatTable], int e) {
  float v = t[0];
#pragma unroll
  for (int j = 1; j < kPhatTable; ++j) v = e == j ? t[j] : v;
  return v;
}

__device__ __forceinline__ float3 row3(const float* buf, int row, int B, int q) {
  return make_float3(__ldg(buf + row * B + q), __ldg(buf + (row + 1) * B + q), __ldg(buf + (row + 2) * B + q));
}

__device__ __forceinline__ void put3(float* buf, int row, int B, int q, float3 v) {
  buf[row * B + q] = v.x;
  buf[(row + 1) * B + q] = v.y;
  buf[(row + 2) * B + q] = v.z;
}

// Cycles a thread spends in each section, built with -DFYP_DI_CLOCKS
// (chip_smoke.py::di_attribution).  K3: the whole kernel, the primary walk,
// the surface with its texture fetch, the candidate loop (its p-hat
// evaluations, draws and reservoir updates), the reprojection, the tile's
// sum with its barrier wait, the temporal reads with p_prev and the merge,
// and the stage writes; the rest is the camera ray and the keys.  K4: the
// whole kernel, its stage reads, the spatial loop's neighbour reads (with
// their tests) and its p-hat evaluations, the point on the emitter with the
// BRDF and the geometry term, the shadow walk (both passes), and the accum
// and state writes; the rest is the camera ray, the keys, the reservoir
// updates and the final sum.  Each warp adds its threads' sums into
// k3_clocks or di_clocks and its block's span into k3_spans or di_spans,
// which the C entries fyp_restir_di_k3_clocks and fyp_restir_di_clocks hand
// over and clear.  Without the macro every call below compiles to nothing.
enum K3Section {
  k3Total = 0, k3PrimaryWalk = 1, k3Surface = 2, k3Candidates = 3, k3Reproject = 4, k3TileSum = 5,
  k3Temporal = 6, k3Writes = 7, k3Sections = 8
};
enum Section {
  kTotal = 0, kStageReads = 1, kNeighbourReads = 2, kPHat = 3, kEmitter = 4, kShadowWalk = 5, kWrites = 6,
  kSections = 7
};
#ifdef FYP_DI_CLOCKS
__device__ unsigned long long k3_clocks[k3Sections];
__device__ BlockSpans k3_spans;
__device__ unsigned long long di_clocks[kSections];
__device__ BlockSpans di_spans;
struct K3Clocks : SectionClocks<k3Sections> {
  __device__ __forceinline__ void begin() const { SectionClocks::begin(k3_spans); }
  __device__ void flush() const { SectionClocks::flush(k3_clocks, k3_spans); }
};
struct Clocks : SectionClocks<kSections> {
  __device__ __forceinline__ void begin() const { SectionClocks::begin(di_spans); }
  __device__ void flush() const { SectionClocks::flush(di_clocks, di_spans); }
};
#else
using K3Clocks = NoClocks;
using Clocks = NoClocks;
#endif

struct K3Params {
  const float* cam;  // (2, 4, 4)
  const float* ppv;  // (4, 4) previous proj @ view, row-major
  int width, height;
  int C;             // pixels a tile
  uint32_t frame;
  int candidates;
  float history_limit;
  int temporal;
  Geo geo;
  Mats mats;
  Tex tex;             // the textured instantiation's levels
  WideBvh wide;
  Emitters em;
  const float* state;  // (ST rows, B), read
  float* stage;        // (S rows, B), written
};

// K3: each tile of C pixels a cluster of blocks of kThreads threads
// (kTileBlock: split, kTileMax: one block), the primary ray through the wide
// BVH; textured when T
template <bool T, int kThreads>
__global__ void __launch_bounds__(kThreads) k3_candidates(K3Params P) {
  K3Clocks clk;
  clk.begin();
  const long long t_all = clk.now();
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  const int C = P.C;
  const int tile = pix / C;
  const int lane = pix - tile * C;
  const int B = P.width * P.height;
  const WideTracer tr{P.wide, lane_stack(P.wide.stack_depth)};

  float3 orig, dir;
  camera_ray(P.cam, P.width, P.height, pix, orig, dir);
  long long t0 = clk.now();
  const Hit h0 = tr.closest(orig, dir);
  clk.add(k3PrimaryWalk, t0);
  t0 = clk.now();
  const bool hit = h0.tri >= 0;
  Surf s{};
  float3 em0 = make_float3(0.0f, 0.0f, 0.0f);
  if (hit) {
    s = tex_surface<T>(P.geo, P.mats, P.tex, h0, orig, dir, false);
    em0 = emission_of(P.mats, s.mat);
  }
  const bool shade = hit && !(dot(em0, em0) > 0.0f);
  const float3 view = -dir;
  clk.add(k3Surface, t0);

  uint32_t key = fold(fold(fold(pcg(static_cast<uint32_t>(pix)), P.frame), 0u), 7001u);
  const int ne = P.em.n;
  t0 = clk.now();
  // where the list is short, p-hat of every emitter once (a pixel that does
  // not shade reads none: its reservoir takes no candidate), then each
  // candidate's from the table; else a p-hat a candidate
  const bool table = ne <= kPhatTable;
  float ph_e[kPhatTable];
#pragma unroll
  for (int j = 0; j < kPhatTable; ++j) ph_e[j] = 0.0f;
  if (table && shade) {
#pragma unroll 1
    for (int e = 0; e < ne; ++e) {
      const float v = p_hat(P.em, e, s.pos, s.n, view, s.alb, s.rough, s.metal);
#pragma unroll
      for (int j = 0; j < kPhatTable; ++j) ph_e[j] = j == e ? v : ph_e[j];
    }
  }
  Res res{0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int i = 0; i < P.candidates; ++i) {
    float u_sel = next_uniform(key);
    float u_acc = next_uniform(key);
    int cand = min(static_cast<int>(u_sel * static_cast<float>(ne)), ne - 1);
    float ph = table ? phat_of(ph_e, cand) : p_hat(P.em, cand, s.pos, s.n, view, s.alb, s.rough, s.metal);
    res_update(res, static_cast<float>(cand), ph * static_cast<float>(ne), 1.0f, ph, u_acc, shade);
  }
  res.w = res.p > 0.0f ? (res.wsum / fmaxf(res.m, 1.0f)) / res.p : 0.0f;
  clk.add(k3Candidates, t0);

  if (P.temporal) {
    // reprojection through the previous proj @ view (Renderer.cu:1750-1765)
    t0 = clk.now();
    const float* pv = P.ppv;
    auto prow = [&](int r) {
      return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(__ldg(pv + 4 * r), s.pos.x), __fmul_rn(__ldg(pv + 4 * r + 1), s.pos.y)),
                                 __fmul_rn(__ldg(pv + 4 * r + 2), s.pos.z)),
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
    const int prev_pix = ppx + ppy * P.width;
    clk.add(k3Reproject, t0);

    // the tile's one offset: rint of the mean reprojection offset of its
    // shading pixels, summed exactly as integers
    t0 = clk.now();
    const int2 sum = ClusterTile::sum(shade, prev_pix - pix);
    clk.add(k3TileSum, t0);
    t0 = clk.now();
    const int off = static_cast<int>(rintf(static_cast<float>(sum.x) / fmaxf(static_cast<float>(sum.y), 1.0f)));
    const int sc = min(max(tile * C + off, 0), B - C);
    const int q = sc + lane;

    const float3 pn = row3(P.state, ST_NRM, B, q);
    const float p_m = __ldg(P.state + ST_RM * B + q);
    const bool valid = dot(pn, s.n) >= kNormalTemporal && p_m > 0.0f && shade && q == prev_pix;
    const float prev_m = fminf(p_m, P.history_limit * res.m);
    const float prev_idx = __ldg(P.state + ST_RIDX * B + q);
    const float prev_w = __ldg(P.state + ST_RW * B + q);

    float u1 = next_uniform(key);
    float u2 = next_uniform(key);
    Res tmp{0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    float z = 0.0f;
    res_update(tmp, res.idx, res.p * res.w * res.m, res.m, res.p, u1, valid);
    z = z + ((valid && res.p > 0.0f) ? res.m : 0.0f);
    const float p_prev = p_hat(P.em, slot(P.em, prev_idx), s.pos, s.n, view, s.alb, s.rough, s.metal);
    res_update(tmp, prev_idx, p_prev * prev_w * prev_m, prev_m, p_prev, u2, valid);
    z = z + ((valid && p_prev > 0.0f) ? prev_m : 0.0f);
    const float m_inv = 1.0f / fmaxf(z, 1.0f);
    if (valid) {
      res = tmp;
      res.w = tmp.p > 0.0f ? (m_inv * tmp.wsum) / tmp.p : 0.0f;
    }
    clk.add(k3Temporal, t0);
  }

  t0 = clk.now();
  float* st = P.stage;
  put3(st, S_POS, B, pix, s.pos);
  put3(st, S_NRM, B, pix, s.n);
  put3(st, S_ALB, B, pix, s.alb);
  st[S_ROUGH * B + pix] = s.rough;
  st[S_METAL * B + pix] = s.metal;
  st[S_T * B + pix] = hit ? h0.t : -1.0f;
  st[S_SHADE * B + pix] = shade ? 1.0f : 0.0f;
  put3(st, S_EMIT, B, pix, em0);
  st[S_HIT * B + pix] = hit ? 1.0f : 0.0f;
  st[S_RIDX * B + pix] = res.idx;
  st[S_RW * B + pix] = res.w;
  st[S_RPDF * B + pix] = res.p;
  st[S_RWSUM * B + pix] = res.wsum;
  st[S_RM * B + pix] = res.m;
  clk.add(k3Writes, t0);
  clk.add(k3Total, t_all);
  clk.flush();
}

struct K4Params {
  const float* cam;  // (2, 4, 4)
  int width, height;
  int C;             // pixels a tile
  uint32_t frame;
  int neighbors;
  float radius;
  int spatial;
  float3 sky;
  WideBvh wide;
  Emitters em;
  const float* stage;  // (S rows, B), read
  float* state;        // (ST rows, B), written
  float* accum;        // (B, 3), this frame's HDR added
};

// K4: blocks of kTileBlock threads, C / kTileBlock of them a tile, the shadow
// ray through the wide BVH
__global__ void __launch_bounds__(kTileBlock) k4_shade(K4Params P) {
  Clocks clk;
  clk.begin();
  const long long t_all = clk.now();
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  const int C = P.C;
  const int tile = pix / C;
  const int lane = pix - tile * C;
  const int B = P.width * P.height;
  const float* sg = P.stage;

  long long t0 = clk.now();
  const float3 pos = row3(sg, S_POS, B, pix);
  const float3 n = row3(sg, S_NRM, B, pix);
  const float3 alb = row3(sg, S_ALB, B, pix);
  const float rough = __ldg(sg + S_ROUGH * B + pix);
  const float metal = __ldg(sg + S_METAL * B + pix);
  const float t_own = __ldg(sg + S_T * B + pix);
  const bool shade = __ldg(sg + S_SHADE * B + pix) > 0.5f;
  const bool hit = __ldg(sg + S_HIT * B + pix) > 0.5f;
  Res res{__ldg(sg + S_RIDX * B + pix), __ldg(sg + S_RW * B + pix), __ldg(sg + S_RPDF * B + pix),
          __ldg(sg + S_RWSUM * B + pix), __ldg(sg + S_RM * B + pix)};
  clk.add(kStageReads, t0);

  float3 orig, dir;
  camera_ray(P.cam, P.width, P.height, pix, orig, dir);
  const float3 view = -dir;
  uint32_t key = fold(fold(fold(pcg(static_cast<uint32_t>(pix)), P.frame), 0u), 7002u);

  if (P.spatial && P.neighbors > 0) {
    Res sp{0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    float z = 0.0f;
    res_update(sp, res.idx, res.p * res.w * res.m, res.m, res.p, next_uniform(key), shade);
    z = z + ((shade && res.p > 0.0f) ? res.m : 0.0f);
    const int px = pix % P.width, py = pix / P.width;
    uint32_t okey = fold(fold(fold(pcg(0xD1CEu), P.frame), 0u), 7002u);
    for (int k = 0; k < P.neighbors; ++k) {
      t0 = clk.now();
      const float ux = next_uniform(okey);
      const float uy = next_uniform(okey);
      const int dx = static_cast<int>(__fmul_rn(__fsub_rn(__fmul_rn(ux, 2.0f), 1.0f), P.radius));
      const int dy = static_cast<int>(__fmul_rn(__fsub_rn(__fmul_rn(uy, 2.0f), 1.0f), P.radius));
      const int s = tile * C + dy * P.width + dx;
      const int sc = min(max(s, 0), B - C);
      const int q = sc + lane;
      const bool in_img = px + dx >= 0 && px + dx < P.width && py + dy >= 0 && py + dy < P.height;
      const float n_t = __ldg(sg + S_T * B + q);
      const bool depth_ok = n_t <= 1.1f * t_own && n_t >= 0.9f * t_own;
      const bool normal_ok = dot(row3(sg, S_NRM, B, q), n) >= kNormalSpatial;
      const bool ok = shade && in_img && s == sc && depth_ok && normal_ok && __ldg(sg + S_SHADE * B + q) > 0.5f;
      const float nb_idx = __ldg(sg + S_RIDX * B + q);
      const float nb_w = __ldg(sg + S_RW * B + q);
      const float nb_m = __ldg(sg + S_RM * B + q);
      clk.add(kNeighbourReads, t0);
      const float u_acc = next_uniform(key);
      t0 = clk.now();
      const float p_n = p_hat(P.em, slot(P.em, nb_idx), pos, n, view, alb, rough, metal);
      clk.add(kPHat, t0);
      res_update(sp, nb_idx, p_n * nb_w * nb_m, nb_m, p_n, u_acc, ok);
      z = z + ((ok && p_n > 0.0f) ? nb_m : 0.0f);
    }
    const float m_inv = 1.0f / fmaxf(z, 1.0f);
    if (shade) {
      res = sp;
      res.w = sp.p > 0.0f ? (m_inv * sp.wsum) / sp.p : 0.0f;
    }
  }

  // ---- final shade (Renderer.cu:1957-2031)
  const float up1 = next_uniform(key);
  const float up2 = next_uniform(key);
  float3 hdr;
  if (!hit) {
    hdr = P.sky;
  } else if (!shade) {
    hdr = row3(sg, S_EMIT, B, pix);
  } else {
    t0 = clk.now();
    const int e = slot(P.em, res.idx);
    const float su = sqrtf(up1);
    const float b1 = su * (1.0f - up2);
    const float b2 = su * up2;
    const float3 pt = ldg3(P.em.p0, e) + ldg3(P.em.e1, e) * b1 + ldg3(P.em.e2, e) * b2;
    const float3 tl = pt - pos;
    const float dist2 = fmaxf(dot(tl, tl), 1e-20f);
    const float3 l = tl * rsqrtf(dist2);
    const float3 f = cook_torrance(n, view, l, alb, metal, rough);
    const float cos_x = fmaxf(dot(l, n), 0.0f);
    const float cos_y = fmaxf(-dot(l, ldg3(P.em.normal, e)), 0.0f);
    const float area = fmaxf(__ldg(P.em.area + e), 1e-20f);
    const float thr_s = cos_x * cos_y * area / dist2;
    clk.add(kEmitter, t0);
    // the shadow walk bounded by the emitter, then unbounded where it found
    // no hit: one walk site, at most two passes
    t0 = clk.now();
    const LaneStack stack = lane_stack(P.wide.stack_depth);
    const float3 so = pos + n * kOriginEps;
    const float dist = sqrtf(dist2);
    float t_max = __fadd_rn(dist, fmaxf(1e-4f, __fmul_rn(dist, 1e-3f)));
    Hit sh;
#pragma unroll 1
    for (int pass = 0; pass < 2; ++pass) {
      sh = trace_closest_wide1(P.wide, stack, so, l, t_max);
      if (sh.tri >= 0) break;
      t_max = kBig;
    }
    clk.add(kShadowWalk, t0);
    const int sel_tri = __ldg(P.em.tri + e);
    hdr = make_float3(0.0f, 0.0f, 0.0f);
    if (sh.tri == sel_tri && sel_tri >= 0) hdr = f * thr_s * ldg3(P.em.emission, e) * res.w;
    if (sh.tri < 0) hdr = hdr + f * thr_s * P.sky;
  }
  t0 = clk.now();
  P.accum[3 * pix + 0] += hdr.x;
  P.accum[3 * pix + 1] += hdr.y;
  P.accum[3 * pix + 2] += hdr.z;

  float* st = P.state;
  st[ST_RIDX * B + pix] = res.idx;
  st[ST_RW * B + pix] = res.w;
  st[ST_RPDF * B + pix] = res.p;
  st[ST_RWSUM * B + pix] = res.wsum;
  st[ST_RM * B + pix] = res.m;
  put3(st, ST_NRM, B, pix, n);
  st[ST_T * B + pix] = t_own;
  clk.add(kWrites, t0);
  clk.add(kTotal, t_all);
  clk.flush();
}

Emitters emitters(const void* p0, const void* e1, const void* e2, const void* area, const void* normal,
                  const void* emission, const void* centroid, const void* tri, int n) {
  auto F = [](const void* p) { return static_cast<const float*>(p); };
  return Emitters{F(p0), F(e1), F(e2), F(area), F(normal), F(emission), F(centroid), static_cast<const int*>(tri), n};
}

using K3Kernel = void (*)(K3Params);

// K3's instantiation for texturing and a tile split over a cluster
K3Kernel k3_kernel(bool textured, bool clustered) {
  if (clustered) return textured ? k3_candidates<true, kTileBlock> : k3_candidates<false, kTileBlock>;
  return textured ? k3_candidates<true, kTileMax> : k3_candidates<false, kTileMax>;
}

}  // namespace

extern "C" int fyp_restir_di_k3(
    const void* cam, const void* ppv, int width, int height, unsigned int frame, int lanes, int clustered,
    int candidates,
    float history_limit, int temporal,
    const void* positions, const void* normals, const void* tri_v, const void* tri_mat, const void* uvs,
    const void* albedo, const void* roughness, const void* metallic, const void* emission, const void* albedo_map,
    int textured, const void* tex_prim, const void* tex_bounce, int tex_k, int tex_hp, int tex_wp, int tex_hb,
    int tex_wb,
    const void* wide_nodes, const void* wide_tris, void* wide_overflow, int wide_stack_depth,
    const void* em_p0, const void* em_e1, const void* em_e2, const void* em_area, const void* em_normal,
    const void* em_emission, const void* em_centroid, const void* em_tri, int n_emissive,
    const void* state, void* stage, void* stream) {
  const int n_pix = width * height;
  if (n_pix <= 0) return 0;
  size_t smem = 0;
  if (!tile_fits(lanes, clustered != 0, wide_stack_depth, &smem) || n_pix % lanes != 0 || n_emissive <= 0 ||
      (textured && tex_k < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  auto F = [](const void* p) { return static_cast<const float*>(p); };
  auto I = [](const void* p) { return static_cast<const int*>(p); };
  K3Params P;
  P.cam = F(cam);
  P.ppv = F(ppv);
  P.width = width;
  P.height = height;
  P.C = lanes;
  P.frame = frame;
  P.candidates = candidates;
  P.history_limit = history_limit;
  P.temporal = temporal;
  P.geo = Geo{F(positions), F(normals), I(tri_v), I(tri_mat), F(uvs)};
  P.mats = Mats{F(albedo), F(roughness), F(metallic), F(emission), I(albedo_map)};
  P.tex = Tex{static_cast<const float4*>(tex_prim), static_cast<const float4*>(tex_bounce), tex_k, tex_hp, tex_wp,
              tex_hb, tex_wb};
  P.wide = WideBvh{static_cast<const float4*>(wide_nodes), static_cast<const float4*>(wide_tris),
                   static_cast<int*>(wide_overflow), wide_stack_depth};
  P.em = emitters(em_p0, em_e1, em_e2, em_area, em_normal, em_emission, em_centroid, em_tri, n_emissive);
  P.state = F(state);
  P.stage = static_cast<float*>(stage);
  const K3Kernel k = k3_kernel(textured != 0, clustered != 0);
  cudaError_t e = allow_stack_smem(k, smem);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (e == cudaSuccess) e = launch_tiles(k, n_pix, lanes, tile_threads(lanes, clustered != 0), smem, st, P);
  return static_cast<int>(e);
}

// The blocks of K3 (textured, split or not) one multiprocessor holds at once,
// and the clusters the card holds at once, for tiles of lanes pixels and
// stacks of wide_stack_depth entries, by the CUDA runtime.
extern "C" int fyp_restir_di_k3_occupancy(int textured, int lanes, int clustered, int wide_stack_depth,
                                          int* blocks_per_sm, int* clusters) {
  size_t smem = 0;
  if (!tile_fits(lanes, clustered != 0, wide_stack_depth, &smem)) return static_cast<int>(cudaErrorInvalidValue);
  const K3Kernel k = k3_kernel(textured != 0, clustered != 0);
  cudaError_t e = allow_stack_smem(k, smem);
  const int threads = tile_threads(lanes, clustered != 0);
  if (e == cudaSuccess) e = tile_occupancy(k, lanes, threads, smem, blocks_per_sm, clusters);
  return static_cast<int>(e);
}

extern "C" int fyp_restir_di_k4(
    const void* cam, int width, int height, unsigned int frame, int lanes, int neighbors, float radius,
    int spatial, float sky_r, float sky_g, float sky_b,
    const void* wide_nodes, const void* wide_tris, void* wide_overflow, int wide_stack_depth,
    const void* em_p0, const void* em_e1, const void* em_e2, const void* em_area, const void* em_normal,
    const void* em_emission, const void* em_centroid, const void* em_tri, int n_emissive,
    const void* stage, void* state, void* accum, void* stream) {
  const int n_pix = width * height;
  if (n_pix <= 0) return 0;
  size_t smem = 0;
  if (!tile_fits(lanes, true, wide_stack_depth, &smem) || n_pix % lanes != 0 || n_emissive <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto F = [](const void* p) { return static_cast<const float*>(p); };
  K4Params P;
  P.cam = F(cam);
  P.width = width;
  P.height = height;
  P.C = lanes;
  P.frame = frame;
  P.neighbors = neighbors;
  P.radius = radius;
  P.spatial = spatial;
  P.sky = make_float3(sky_r, sky_g, sky_b);
  P.wide = WideBvh{static_cast<const float4*>(wide_nodes), static_cast<const float4*>(wide_tris),
                   static_cast<int*>(wide_overflow), wide_stack_depth};
  P.em = emitters(em_p0, em_e1, em_e2, em_area, em_normal, em_emission, em_centroid, em_tri, n_emissive);
  P.stage = F(stage);
  P.state = static_cast<float*>(state);
  P.accum = static_cast<float*>(accum);
  const cudaError_t e = allow_stack_smem(k4_shade, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  k4_shade<<<n_pix / kTileBlock, kTileBlock, smem, static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}

#ifdef FYP_DI_CLOCKS
// K3's cycles of each section (K3Section) summed over every thread of every
// launch since the last call, and the first n_blocks blocks' spans, as
// fyp_restir_di_clocks hands over K4's; then both cleared, on the stream.
extern "C" int fyp_restir_di_k3_clocks(void* sums_out, void* spans_out, int n_blocks, void* stream) {
  void* sums = nullptr;
  void* spans = nullptr;
  cudaError_t e = cudaGetSymbolAddress(&sums, k3_clocks);
  if (e == cudaSuccess) e = cudaGetSymbolAddress(&spans, k3_spans);
  if (e == cudaSuccess)
    e = read_clocks(static_cast<unsigned long long*>(sums), k3Sections, static_cast<BlockSpans*>(spans), sums_out,
                    spans_out, n_blocks, static_cast<cudaStream_t>(stream));
  return static_cast<int>(e);
}

// K4's cycles of each section (Section) summed over every thread of every
// launch since the last call, as kSections unsigned 64-bit ints copied to
// sums_out, and the first n_blocks blocks' starts and ends in nanoseconds,
// as (2, n_blocks) unsigned 64-bit ints copied to spans_out (both on the
// card); then both cleared, on the stream.
extern "C" int fyp_restir_di_clocks(void* sums_out, void* spans_out, int n_blocks, void* stream) {
  void* sums = nullptr;
  void* spans = nullptr;
  cudaError_t e = cudaGetSymbolAddress(&sums, di_clocks);
  if (e == cudaSuccess) e = cudaGetSymbolAddress(&spans, di_spans);
  if (e == cudaSuccess)
    e = read_clocks(static_cast<unsigned long long*>(sums), kSections, static_cast<BlockSpans*>(spans), sums_out,
                    spans_out, n_blocks, static_cast<cudaStream_t>(stream));
  return static_cast<int>(e);
}
#endif

