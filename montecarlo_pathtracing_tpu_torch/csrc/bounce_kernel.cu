// K2: the fused per-bounce kernel for mesh and large analytic scenes, by
// hand for Hopper (sm_90a).
//
// Replaces montecarlo_pathtracing_tpu/models/bounce_kernel.py:776
// (_fused_kernel, the Pallas TPU kernel launched by _fused_call). One
// launch runs one bounce of every ray of the wavefront (whole_path = 0),
// or the whole path (whole_path = the bounce count): the closest hit over
//   - the small analytic prim table (trace_fold of common.cuh, K1's fold;
//     with CULL its supers in this bounce's nearest-first order, read at
//     offset sched_base of the schedule row),
//   - every mesh instance: a front-to-back walk of its 16-chunk supers in
//     the mesh-local frame (mesh_instance), Moller-Trumbore over the
//     128-triangle chunks, the winner merged by world distance with the
//     interpolated (or, with FLAT, the face) normal,
//   - every large analytic group: the same walk over 128-prim chunks in
//     world distance (ana_group),
// then the bounce step of common.cuh: sky, emission, the 4-case material
// logic with its 2+1+2 masked draws and the refraction re-trace. The plain
// PyTorch version is models/bounce_kernel.py::fused_call_reference;
// chip_smoke.py holds the two against each other.
//
// Design. All per-ray state in registers; in wavefront mode a ray's column
// `ray` of the [15, M] f32 and [4, M] int32 state is read and written back
// in place. The TPU's 1024-ray tile survives only as the row of the super
// schedule a ray reads (ord/ent[ray / 1024]), which a second kernel of this
// file, schedule_kernel, builds on the card before each launch (one block a
// tile; the plain version is bounce_kernel.py::_schedules). The TPU's 16-slot DMA
// ring, its per-sublane predication and its MXU one-hot winner gather are
// not carried over: the walk keeps the index of its winning triangle or
// prim and reads that one's attributes once, at the merge.
//
// Lanes per ray. A group of L lanes of a warp owns one ray. Its lanes split
// each chunk's 128 triangles or prims, 128 / L each, neighbouring lanes on
// neighbouring columns (coalesced), and reduce to the least `a` (meshes) or
// world distance (large groups), the lowest column on equal values
// (group_min): the winner of the ascending strict-`<` scan, bit for bit.
// The group's best then gates the next chunk. Everything else (the path
// state, the RNG, the small table, the walk's decisions, the merge and the
// bounce step) every lane of the group computes alike, and lane 0 writes the
// ray back. A group folds only the chunks its own ray enters, where a warp
// of 32 rays folds every chunk that one of them enters. The grid holds the
// blocks the card keeps resident; each group takes every so-many-th ray of
// [0, n_scan), n_scan being the last live ray's index + 1, which the wrapper
// computes as a device scalar. From bounce 1 the host's re-sort sends
// finished rays to the tail (ops/sort_rays.py), so a few thousand live rays
// still spread over every SM, L lanes each.
//
// Two shapes, one kernel body: 8 lanes per ray (LANES_MANY) in whole-path
// mode and for a wavefront launch with MANY_RAYS or more rays to scan, 16
// (LANES_FEW) below. The lanes per ray are a runtime value, so the kernel
// reads n_scan and picks, and no count comes back to the host; a caller may
// force either shape (models/bounce_kernel.py mirrors the rule and checks
// its copy against fused_shape_rule). On an H100 (chip_smoke.py phase 5,
// PERF.md) 8 lanes fold coherent primaries and whole paths faster (a group
// spends less of its time on the work every lane repeats: the slab gates,
// the small table, shading), 16 the sparse late bounces. One lane per ray
// (the first design) and 32 lanes measured slower than both in trials.
//
// The walks. The outer trace (the first trace of a launch) visits an
// instance's supers in the tile's nearest-first schedule and stops, per
// ray, at the first super whose conservative entry bound `ent` is not below
// min(best, root-box exit): ent lower-bounds the entry of every ray of the
// tile, and the list is sorted ascending, so nothing later can be closer.
// The refraction re-trace and the later bounces of whole-path mode have no
// schedule (their rays exist only in the kernel) and visit the supers in
// Morton order behind a per-ray super slab test. In both walks each chunk
// is slab-gated per ray against min(best, root-box exit) before its 128
// triangles or prims are tested.
//
// What bounds it on this card: the FP32 instruction rate of the
// Moller-Trumbore and shape tests (about 51 FP32 operations per
// ray-triangle test, 25 per ray-box test, 47-86 per ray-prim test),
// divergence between the rays of a warp, and latency at low occupancy on
// sparse bounces (128-255 registers a thread). Lanes per ray answers the
// last two: a group folds only its own ray's chunks, and the live rays'
// tests spread over L times as many lanes. Memory is not the bound:
// mesh_demo's triangle pool is 737 KB and lives in L2 (50 MB).
//
// Registers. ptxas gives the variants 128-255 registers and spills part of
// the path state to local memory, which stays in L1. A launch bound of 2
// or 3 blocks per SM (168-255 registers) spills less or nothing but
// measured slower on an H100, in both modes: here the resident warps, not
// the spills, decide how much of the walks' latency is hidden.
// chip_smoke.py prints each variant's registers and spills (PERF.md).
//
// Deliberate difference: the large-group merge recomputes the winner's hit
// and takes it only where that recomputation is valid. The reference
// discards the valid flag there (bounce_kernel.py:734), so an ulp-level flip
// at a shape test's threshold could accept a garbage hit.
//
// Floating point is IEEE, without --use_fast_math (see common.cuh).

#include "common.cuh"

namespace {

using namespace pt;

constexpr int BLOCK = 128;
constexpr int TILE = 1024;     // rays per row of the super schedule
constexpr int TRI_SUPER = 16;  // chunks per super
constexpr int CHUNK = 128;     // triangles or prims per chunk
constexpr int TRI_ROWS = 18;   // triangle chunk rows: corners a b c, normals
constexpr int ANA_ROWS = 32;   // prim chunk rows: inverse, forward, material,
                               // rgba, ok flag
constexpr float INF = 3e38f;
constexpr int MAX_DEVICES = 64;  // devices whose resident block count is cached
constexpr int NONE = 0x7fffffff;  // no candidate in a lane's share of a chunk
// lanes per ray when a launch has MANY_RAYS or more rays to scan, and when
// it has fewer: the threshold is set from each shape's time per launch
// against its rays to scan on an H100 (chip_smoke.py phase 5)
constexpr int LANES_MANY = 8;
constexpr int LANES_FEW = 16;
constexpr int MANY_RAYS = 32768;

struct Params {
  float* stf;          // [15,M] o d attenu total result, in place
  int* sti;            // [4,M] done, rng s0 s1 s2 (uint32 bits), in place
  Table small;         // the small analytic groups' prim table
  const float* msc;    // [37,n_mesh] inverse, forward, material, rgba, root box
  const int* msi;      // [4,n_mesh] chunk start, supers, super start, 0
  const float* cbb;    // [6,Cm] mesh chunk boxes (mesh-local)
  const float* sbb;    // [6,Sm] mesh super boxes
  const float* tpool;  // [C,18,128] triangle chunks
  const float* acbb;   // [6,Ca] analytic chunk boxes (world)
  const float* asbb;   // [6,Sa] analytic super boxes
  const float* apool;  // [Ca,32,128] analytic prim chunks
  const float* agr;    // [6,A] large groups' root boxes
  const int* ana;      // [A,4] (shape code, chunk start, chunks, super start)
  const int* ord;      // [M/TILE,1,Stot] nearest-first super order per tile
  const float* ent;    // [M/TILE,1,Stot] its conservative entry bounds
  const int* n_scan;   // [1] rays to scan: every live ray has a lower index
  unsigned long long* counts;  // [5] work counters (Counts; K2_COUNTS builds)
  float ior;
  int M, n_mesh, Cm, Sm, Ca, Sa, A, Stot, mesh_stot, sched_base, whole_path;
  int lanes;  // lanes per ray: LANES_MANY or LANES_FEW, or 0 to choose
};

// The launch's work, in a build with -DK2_COUNTS (kernels.py makes one for
// k2_launch's `work`; without it the counting code is not compiled, since
// it slowed both shapes even when nothing was counted), added to
// Params::counts: [TRI] ray-triangle tests, [BOX] ray-box tests of chunks
// and supers, [PRIM] ray-prim tests of the large groups, [TRACE] traces,
// and [SLOTS] the lane slots the warps spent on chunk folds. A group's L
// lanes count 128 / L tests each of a chunk they fold, its box tests and
// traces count once (on lane 0); a warp's fold of a chunk takes 128 / L
// steps of its 32 lanes, 32 * 128 / L slots, counted once per warp and fold
// by its lowest active lane, so that (tri + prim) / slots is the share of
// the warps' lanes that did useful work in the folds (divergence between
// rays costs the rest).
enum { TRI, BOX, PRIM, TRACE, SLOTS, N_COUNTS };
struct Counts {
#ifdef K2_COUNTS
  uint32_t v[N_COUNTS] = {};
  __device__ void add(int k, uint32_t x) { v[k] += x; }
#else
  __device__ void add(int, uint32_t) {}
#endif
};

// the lanes of a warp that own one ray: LANES_MANY or LANES_FEW of them,
// aligned
struct Group {
  int lanes;      // lanes per ray
  int lane;       // this thread's lane in its group
  unsigned mask;  // the group's lanes in the warp
  __device__ explicit Group(int n) : lanes(n) {
    const int wl = threadIdx.x % 32;
    lane = wl & (n - 1);
    mask = ((1u << n) - 1u) << (wl - lane);
  }
  __device__ bool lead() const { return lane == 0; }
};

// one chunk fold of the group: its lanes' tests, and the warp's lane slots
__device__ __forceinline__ void count_fold(Counts& n, int what, const Group& g) {
  n.add(what, CHUNK / g.lanes);
#ifdef K2_COUNTS
  if ((threadIdx.x % 32) == __ffs(__activemask()) - 1) n.add(SLOTS, 32 * CHUNK / g.lanes);
#endif
}

// the group's least (value, index), the lowest index on equal values: the
// candidate an ascending scan with a strict `<` keeps. Every lane ends with
// it (a butterfly over the group's lanes; an xor below `lanes` stays inside
// the aligned group).
__device__ __forceinline__ void group_min(const Group& g, float& v, int& i) {
  for (int off = g.lanes / 2; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(g.mask, v, off);
    const int oi = __shfl_xor_sync(g.mask, i, off);
    if (ov < v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
}

// the per-ray cap of a walk: the exit from the root box (column `col` of
// `box`, a union of the real chunk boxes) with a margin, 0 when the ray
// misses the root box; nothing can be hit beyond it
__device__ __forceinline__ float root_bound(const float* box, int stride, int col, V3 o, V3 rd) {
  float tmin, tmax;
  slab_interval(box, stride, col, o, rd, tmin, tmax);
  tmin = fmaxf(tmin, 0.0f);
  bool hit = (tmax >= tmin) && (tmin <= INF);
  return hit ? tmax * 1.0001f + 1e-4f : 0.0f;
}

__device__ __forceinline__ V3 row3(const float* blk, int row, int t) {
  return {__ldg(blk + row * CHUNK + t), __ldg(blk + (row + 1) * CHUNK + t),
          __ldg(blk + (row + 2) * CHUNK + t)};
}

// ---------------------------------------------------------------------------
// mesh instances (_mesh_instance, bounce_kernel.py:243-520)
// ---------------------------------------------------------------------------

// Moller-Trumbore of the 128 triangles of chunk c against the local unit
// ray, the group's lanes taking columns lane, lane + L, ... (coalesced); a
// valid hit strictly closer than abest becomes the winner, the lowest
// column on equal parameters, as the ascending scan
__device__ __forceinline__ void fold_tris(const float* __restrict__ tpool, int c, V3 oi, V3 di,
                                          float& abest, int& best, const Group& g,
                                          Counts& n) {
  const float* blk = tpool + static_cast<size_t>(c) * TRI_ROWS * CHUNK;
  count_fold(n, TRI, g);
  float al = abest;
  int il = NONE;
  for (int k = 0; k < CHUNK / g.lanes; ++k) {
    const int t = g.lane + k * g.lanes;
    float a;
    if (mt_hit(row3(blk, 0, t), row3(blk, 3, t), row3(blk, 6, t), oi, di, a) && a < al) {
      al = a;
      il = c * CHUNK + t;
    }
  }
  group_min(g, al, il);
  if (il != NONE) {
    abest = al;
    best = il;
  }
}

__device__ __forceinline__ void visit_tri_super(const Params& p, int c0, V3 oi, V3 di, V3 rdi,
                                                float bound, float& abest, int& best,
                                                const Group& g, Counts& n) {
  if (g.lead()) n.add(BOX, TRI_SUPER);
  for (int j = 0; j < TRI_SUPER; ++j) {
    const int c = c0 + j;
    if (slab_cap(p.cbb, p.Cm, c, oi, rdi, fminf(abest, bound)))
      fold_tris(p.tpool, c, oi, di, abest, best, g, n);
  }
}

// walk mesh instance mi and merge its winner into w by world distance
template <bool FLAT>
__device__ void mesh_instance(const Params& p, int mi, bool scheduled, const int* ord_row,
                              const float* ent_row, V3 o, V3 d, Win& w, const Group& g,
                              Counts& n) {
  const int nm = p.n_mesh;
  float iv[12];
#pragma unroll
  for (int r = 0; r < 12; ++r) iv[r] = ld(p.msc, r, nm, mi);
  // mesh-local frame; nrm converts the local parameter to world distance
  const V3 oi = affine(iv, o);
  const V3 dn = linear(iv, d);
  const float nrm = fmaxf(sqrtf(dot(dn, dn)), TINY);
  const V3 di = {dn.x / nrm, dn.y / nrm, dn.z / nrm};
  const V3 rdi = {safe_rcp(di.x), safe_rcp(di.y), safe_rcp(di.z)};
  const float bound = root_bound(p.msc + 31 * nm, nm, mi, oi, rdi);
  // seed from the current world winner: analytic prims and earlier
  // instances occlude this mesh's chunks
  float abest = w.bd * nrm;
  int best = -1;  // winning triangle: chunk * 128 + column
  const int cstart = __ldg(p.msi + mi);
  const int nsup = __ldg(p.msi + nm + mi);
  const int sstart = __ldg(p.msi + 2 * nm + mi);
  if (scheduled) {
    for (int k = 0; k < nsup; ++k) {
      if (!(__ldg(ent_row + sstart + k) < fminf(abest, bound))) break;
      const int s = __ldg(ord_row + sstart + k);
      visit_tri_super(p, cstart + s * TRI_SUPER, oi, di, rdi, bound, abest, best, g, n);
    }
  } else {
    if (g.lead()) n.add(BOX, nsup);
    for (int s = 0; s < nsup; ++s) {
      if (slab_cap(p.sbb, p.Sm, sstart + s, oi, rdi, fminf(abest, bound)))
        visit_tri_super(p, cstart + s * TRI_SUPER, oi, di, rdi, bound, abest, best, g, n);
    }
  }
  if (best < 0) return;

  // merge: the hit point back to world space, taken if closer there
  const float* blk = p.tpool + static_cast<size_t>(best / CHUNK) * TRI_ROWS * CHUNK;
  const int t = best % CHUNK;
  float tf[12];
#pragma unroll
  for (int r = 0; r < 12; ++r) tf[r] = ld(p.msc, 12 + r, nm, mi);
  const V3 plh = {oi.x + abest * di.x, oi.y + abest * di.y, oi.z + abest * di.z};
  const V3 pg = affine(tf, plh);
  const V3 e = sub(o, pg);
  const float wd = sqrtf(e.x * e.x + e.y * e.y + e.z * e.z);
  if (!(wd < w.bd)) return;
  const V3 wa = row3(blk, 0, t), wb = row3(blk, 3, t), wc = row3(blk, 6, t);
  V3 no;
  if (FLAT) {
    no = cross(sub(wb, wa), sub(wc, wa));
  } else {
    // vertex normals weighted by the opposite sub-triangle areas
    const V3 na = row3(blk, 9, t), nb = row3(blk, 12, t), nc = row3(blk, 15, t);
    const V3 PA = sub(wa, plh), PB = sub(wb, plh), PC = sub(wc, plh);
    const V3 cA = cross(PB, PC), cB = cross(PA, PC), cC = cross(PA, PB);
    const float tA = sqrtf(cA.x * cA.x + cA.y * cA.y + cA.z * cA.z);
    const float tB = sqrtf(cB.x * cB.x + cB.y * cB.y + cB.z * cB.z);
    const float tC = sqrtf(cC.x * cC.x + cC.y * cC.y + cC.z * cC.z);
    no = {na.x * tA + nb.x * tB + nc.x * tC, na.y * tA + nb.y * tB + nc.y * tC,
          na.z * tA + nb.z * tB + nc.z * tC};
  }
  const V3 nmv = sub(affine(tf, add(plh, no)), pg);
  const float nl = fmaxf(sqrtf(nmv.x * nmv.x + nmv.y * nmv.y + nmv.z * nmv.z), TINY);
  w.bd = wd;
  w.n = {nmv.x / nl, nmv.y / nl, nmv.z / nl};
  w.p = pg;
  w.shin = ld(p.msc, 24, nm, mi);
  w.rough = ld(p.msc, 25, nm, mi);
  w.emis = ld(p.msc, 26, nm, mi);
  w.r = ld(p.msc, 27, nm, mi);
  w.g = ld(p.msc, 28, nm, mi);
  w.b = ld(p.msc, 29, nm, mi);
  w.a = ld(p.msc, 30, nm, mi);
}

// ---------------------------------------------------------------------------
// large analytic groups (_ana_group, bounce_kernel.py:579-769)
// ---------------------------------------------------------------------------

// world-space candidate of prim column t of an analytic chunk block (the
// reference's _ana_candidates): false where the shape test fails
template <int SHAPE>
__device__ __forceinline__ bool ana_candidate(const float* blk, int t, V3 o, V3 d, float& dist,
                                              int& code, V3& pl, V3& pg) {
  float iv[12];
#pragma unroll
  for (int r = 0; r < 12; ++r) iv[r] = __ldg(blk + r * CHUNK + t);
  const V3 oi = affine(iv, o);
  const V3 dn = linear(iv, d);
  const float rn = 1.0f / fmaxf(sqrtf(dn.x * dn.x + dn.y * dn.y + dn.z * dn.z), TINY);
  const V3 di = {dn.x * rn, dn.y * rn, dn.z * rn};
  float a;
  if (!shape_test<SHAPE>(oi, di, a, code)) return false;
  float tf[12];
#pragma unroll
  for (int r = 0; r < 12; ++r) tf[r] = __ldg(blk + (12 + r) * CHUNK + t);
  pl = {oi.x + a * di.x, oi.y + a * di.y, oi.z + a * di.z};
  pg = affine(tf, pl);
  const V3 e = sub(o, pg);
  dist = sqrtf(e.x * e.x + e.y * e.y + e.z * e.z);
  return true;
}

// the 128 prims of chunk c in world distance, split over the group's lanes
// as fold_tris does
template <int SHAPE>
__device__ __forceinline__ void fold_prims(const float* __restrict__ apool, int c, V3 o, V3 d,
                                           float& abest, int& best, const Group& g,
                                           Counts& n) {
  const float* blk = apool + static_cast<size_t>(c) * ANA_ROWS * CHUNK;
  count_fold(n, PRIM, g);
  float al = abest;
  int il = NONE;
  for (int k = 0; k < CHUNK / g.lanes; ++k) {
    const int t = g.lane + k * g.lanes;
    if (!(__ldg(blk + 31 * CHUNK + t) > 0.0f)) continue;  // chunk padding
    float dist;
    int code;
    V3 pl, pg;
    if (ana_candidate<SHAPE>(blk, t, o, d, dist, code, pl, pg) && dist < al) {
      al = dist;
      il = c * CHUNK + t;
    }
  }
  group_min(g, al, il);
  if (il != NONE) {
    abest = al;
    best = il;
  }
}

template <int SHAPE>
__device__ __forceinline__ void visit_ana_super(const Params& p, int c0, V3 o, V3 d, V3 rd,
                                                float bound, float& abest, int& best,
                                                const Group& g, Counts& n) {
  if (g.lead()) n.add(BOX, TRI_SUPER);
  for (int j = 0; j < TRI_SUPER; ++j) {
    const int c = c0 + j;
    if (slab_cap(p.acbb, p.Ca, c, o, rd, fminf(abest, bound)))
      fold_prims<SHAPE>(p.apool, c, o, d, abest, best, g, n);
  }
}

// walk large group gi (chunks cstart.., supers sstart.., schedule segment
// at ssched) in world distance and merge its winner into w
template <int SHAPE>
__device__ void ana_group(const Params& p, int gi, int cstart, int nchunks, int sstart,
                          int ssched, bool scheduled, const int* ord_row, const float* ent_row,
                          V3 o, V3 d, V3 rd, Win& w, const Group& g, Counts& n) {
  const float bound = root_bound(p.agr, p.A, gi, o, rd);
  float abest = w.bd;
  int best = -1;  // winning prim: chunk * 128 + column
  const int nsup = nchunks / TRI_SUPER;
  if (scheduled) {
    for (int k = 0; k < nsup; ++k) {
      if (!(__ldg(ent_row + ssched + k) < fminf(abest, bound))) break;
      const int s = __ldg(ord_row + ssched + k);
      visit_ana_super<SHAPE>(p, cstart + s * TRI_SUPER, o, d, rd, bound, abest, best, g, n);
    }
  } else {
    if (g.lead()) n.add(BOX, nsup);
    for (int s = 0; s < nsup; ++s) {
      if (slab_cap(p.asbb, p.Sa, sstart + s, o, rd, fminf(abest, bound)))
        visit_ana_super<SHAPE>(p, cstart + s * TRI_SUPER, o, d, rd, bound, abest, best, g,
                                  n);
    }
  }
  if (best < 0) return;

  // merge: recompute the winner's hit; take it only where that is valid
  const float* blk = p.apool + static_cast<size_t>(best / CHUNK) * ANA_ROWS * CHUNK;
  const int t = best % CHUNK;
  float dist;
  int code;
  V3 pl, pg;
  if (!ana_candidate<SHAPE>(blk, t, o, d, dist, code, pl, pg)) return;
  if (!(abest < w.bd)) return;
  float tf[12];
#pragma unroll
  for (int r = 0; r < 12; ++r) tf[r] = __ldg(blk + (12 + r) * CHUNK + t);
  const V3 q = normal_point<SHAPE>(pl, code);
  V3 nv = vnorm(sub(affine(tf, q), pg), TINY);
  // cone top-"cap" quirk: N = 0 (raytracer_func.frag:850-853)
  if (SHAPE == CONE && code == 1) nv = {0.0f, 0.0f, 0.0f};
  w.bd = abest;
  w.n = nv;
  w.p = pg;
  w.shin = __ldg(blk + 24 * CHUNK + t);
  w.rough = __ldg(blk + 25 * CHUNK + t);
  w.emis = __ldg(blk + 26 * CHUNK + t);
  w.r = __ldg(blk + 27 * CHUNK + t);
  w.g = __ldg(blk + 28 * CHUNK + t);
  w.b = __ldg(blk + 29 * CHUNK + t);
  w.a = __ldg(blk + 30 * CHUNK + t);
}

// ---------------------------------------------------------------------------
// the closest-hit search of one trace, and the kernel
// ---------------------------------------------------------------------------

// The first call of a launch for a ray is the scheduled outer trace; every
// later one (the refraction re-trace, later bounces of whole-path mode)
// walks without the schedule. Every lane of the ray's group calls it with
// the same ray and gets the same winner.
template <bool FLAT, bool CULL>
struct FusedTrace {
  const Params& p;
  const int* ord_row;
  const float* ent_row;
  bool scheduled;
  const Group& g;
  Counts& n;

  __device__ void operator()(V3 o, V3 d, V3 n_prev, V3 p_prev, Win& w) {
    if (g.lead()) n.add(TRACE, 1);
    trace_fold<CULL>(p.small, ord_row + p.sched_base, o, d, n_prev, p_prev, w);
    for (int mi = 0; mi < p.n_mesh; ++mi)
      mesh_instance<FLAT>(p, mi, scheduled, ord_row, ent_row, o, d, w, g, n);
    if (p.A > 0) {
      const V3 rd = {safe_rcp(d.x), safe_rcp(d.y), safe_rcp(d.z)};
      int ssched = p.mesh_stot;
      for (int gi = 0; gi < p.A; ++gi) {
        const int code = __ldg(p.ana + 4 * gi);
        const int cstart = __ldg(p.ana + 4 * gi + 1);
        const int nchunks = __ldg(p.ana + 4 * gi + 2);
        const int sstart = __ldg(p.ana + 4 * gi + 3);
        switch (code) {  // uniform: every thread reads the same descriptor
          case SPHERE:
            ana_group<SPHERE>(p, gi, cstart, nchunks, sstart, ssched, scheduled, ord_row,
                                 ent_row, o, d, rd, w, g, n);
            break;
          case CUBE:
            ana_group<CUBE>(p, gi, cstart, nchunks, sstart, ssched, scheduled, ord_row,
                               ent_row, o, d, rd, w, g, n);
            break;
          case CYLINDER:
            ana_group<CYLINDER>(p, gi, cstart, nchunks, sstart, ssched, scheduled, ord_row,
                                   ent_row, o, d, rd, w, g, n);
            break;
          case CONE:
            ana_group<CONE>(p, gi, cstart, nchunks, sstart, ssched, scheduled, ord_row,
                               ent_row, o, d, rd, w, g, n);
            break;
          default:
            ana_group<QUAD>(p, gi, cstart, nchunks, sstart, ssched, scheduled, ord_row,
                               ent_row, o, d, rd, w, g, n);
            break;
        }
        ssched += nchunks / TRI_SUPER;
      }
    }
    scheduled = false;
  }
};

// One launch over rays [0, n_scan) of the wavefront, one per group of
// lanes: ray r goes to group r mod (the grid's groups), which takes every
// so-many-th ray; finished rays are skipped. The lanes per ray are p.lanes
// or, with 0, chosen here from the rays to scan (the wrapper computes
// n_scan with no host sync): LANES_MANY in whole-path mode and for a
// wavefront with MANY_RAYS rays or more to scan, LANES_FEW below
// (models/bounce_kernel.py::k2_shape is the same rule).
template <bool TRANSPARENT, bool FLAT, bool CULL>
__global__ void __launch_bounds__(BLOCK) fused_kernel(Params p) {
  const int M = p.M;
  const int n_scan = min(__ldg(p.n_scan), M);
  int lanes = p.lanes;
  if (lanes == 0) lanes = (p.whole_path > 0 || n_scan >= MANY_RAYS) ? LANES_MANY : LANES_FEW;
  const Group g(lanes);
  const int stride = gridDim.x * (BLOCK / lanes);
  Counts n;
  for (int ray = (blockIdx.x * BLOCK + threadIdx.x) / lanes; ray < n_scan; ray += stride) {
    float* f = p.stf + ray;
    int* u = p.sti + ray;
    if (u[0] != 0) continue;  // a finished ray changes nothing
    Path s;
    s.o = {f[0], f[M], f[2 * M]};
    s.d = {f[3 * M], f[4 * M], f[5 * M]};
    s.att = {f[6 * M], f[7 * M], f[8 * M]};
    s.total = {f[9 * M], f[10 * M], f[11 * M]};
    s.result = {f[12 * M], f[13 * M], f[14 * M]};
    s.done = false;
    s.st = {static_cast<uint32_t>(u[M]), static_cast<uint32_t>(u[2 * M]),
            static_cast<uint32_t>(u[3 * M])};
    const int row = (ray / TILE) * p.Stot;
    FusedTrace<FLAT, CULL> trace{p, p.ord + row, p.ent + row, true, g, n};
    const int nb = p.whole_path > 0 ? p.whole_path : 1;
    for (int bounce = 0; bounce < nb && !s.done; ++bounce)
      bounce_step<TRANSPARENT>(trace, p.ior, s);
    __syncwarp(g.mask);  // every lane of the group has read the state
    if (g.lead()) {
      const float out[15] = {s.o.x,     s.o.y,     s.o.z,     s.d.x,      s.d.y,
                             s.d.z,     s.att.x,   s.att.y,   s.att.z,    s.total.x,
                             s.total.y, s.total.z, s.result.x, s.result.y, s.result.z};
#pragma unroll
      for (int k = 0; k < 15; ++k) f[k * M] = out[k];
      u[0] = s.done ? 1 : 0;
      u[M] = static_cast<int>(s.st.s0);
      u[2 * M] = static_cast<int>(s.st.s1);
      u[3 * M] = static_cast<int>(s.st.s2);
    }
  }
#ifdef K2_COUNTS
  // one atomic per warp and counter
  const unsigned mask = __activemask();
  const bool leader = (threadIdx.x % 32) == (__ffs(mask) - 1);
#pragma unroll
  for (int k = 0; k < N_COUNTS; ++k) {
    const uint32_t sum = __reduce_add_sync(mask, n.v[k]);
    if (leader) atomicAdd(p.counts + k, static_cast<unsigned long long>(sum));
  }
#endif
}

// a grid of the blocks the card keeps resident (no more than the rays need
// with LANES_FEW lanes each): the groups stride over the rays
template <bool TRANSPARENT, bool FLAT, bool CULL>
void launch(const Params& p, cudaStream_t stream) {
  auto kernel = fused_kernel<TRANSPARENT, FLAT, CULL>;
  // the same for every launch of this variant on a device: cached per
  // device (the cards of a host may differ)
  static int resident_of[MAX_DEVICES] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  int resident = dev < MAX_DEVICES ? resident_of[dev] : 0;
  if (resident == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, BLOCK, 0);
    resident = sms * (per_sm > 0 ? per_sm : 1);
    if (dev < MAX_DEVICES) resident_of[dev] = resident;
  }
  const int need = (p.M * LANES_FEW + BLOCK - 1) / BLOCK;
  kernel<<<need < resident ? need : resident, BLOCK, 0, stream>>>(p);
}

template <bool TRANSPARENT, bool FLAT>
void launch_cull(const Params& p, int cull, cudaStream_t stream) {
  if (cull)
    launch<TRANSPARENT, FLAT, true>(p, stream);
  else
    launch<TRANSPARENT, FLAT, false>(p, stream);
}

// ---------------------------------------------------------------------------
// the per-tile nearest-first super schedule (bounce_kernel.py::_schedules)
// ---------------------------------------------------------------------------
//
// One block per 1024-ray tile of the wavefront. It reduces the tile's rays to
// their bundle (the least and greatest o and d per axis; min and max do not
// depend on the order, so this is exact), computes the conservative entry
// bound of every super in _schedules' order (each mesh instance's supers in
// its local frame, then each large group's, then, with the small table's
// cull, each small group's), and sorts each segment ascending and stably by
// rank: an entry's rank counts the entries of its segment that are smaller,
// or equal with a lower index, nan last, which is torch.sort(stable=True)'s
// order. Every product, sum, quotient and square root rounds on its own (the
// _rn intrinsics, since this file builds with contraction on), as each torch
// op does; the 3x3 products sum in index order. min and max carry nan
// through, as torch.minimum, torch.maximum and amin do.

constexpr int SCHED_BLOCK = 256;
constexpr float SHRINK = 0x1.fff2e4p-1f;  // float32(1 - 1e-4), as _schedules
constexpr float MARGIN = 1e-4f;

struct SchedParams {
  const float* stf;    // [15,M] wavefront state: rows 0-2 o, 3-5 d
  const float* msc;    // [37,n_mesh]: rows 0-11 the inverse affine
  const int* msi;      // [4,n_mesh] chunk start, supers, super start, 0
  const float* sbb;    // [6,Sm] mesh super boxes (mesh-local)
  const int* ana;      // [A,4] (shape code, chunk start, chunks, super start)
  const float* asbb;   // [6,Sa] large groups' super boxes (world)
  const int* groups;   // [G,4] (shape code, start, count, super start)
  const float* gsbb;   // [6,Sg] small groups' super boxes (world)
  int* ord;            // [M/TILE,1,W] out: each segment's local order
  float* ent;          // [M/TILE,1,W] out: its entry bounds, ascending
  float* scratch;      // [M/TILE,W] the unsorted entry bounds
  int M, n_mesh, Sm, A, Sa, G, Sg, cull, mesh_stot, sched_base;
  int Stot;            // the schedule's length: every segment's supers
  int W;               // row width: Stot, or 1 when there is no segment
};

__device__ __forceinline__ float nan_min(float a, float b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ float nan_max(float a, float b) { return (a > b || a != a) ? a : b; }

// a ray bundle: the least and greatest origin and direction per axis
struct Bundle {
  float olo[3], ohi[3], dlo[3], dhi[3];
};

// the feasible t >= 0 interval [lo, hi] of a * t <= b (_cond_interval)
__device__ __forceinline__ void cond_interval(float a, float b, float& lo, float& hi) {
  const bool pos = a > 0.0f, neg = a < 0.0f, zer = !(pos || neg);
  const float ratio = __fdiv_rn(b, zer ? 1.0f : a);
  lo = neg ? (ratio != ratio ? ratio : fmaxf(ratio, 0.0f)) : 0.0f;
  hi = pos ? ratio : INF;
  if (zer && b < 0.0f) hi = -1.0f;
}

// the bundle's conservative entry distance into box `col` of a [6, S]
// table, INF where it cannot reach it or the box is padding
// (bundle_box_entry)
__device__ float bundle_entry(const Bundle& b, const float* box, int S, int col) {
  float t_lo = 0.0f, t_hi = INF;
  bool real = true;
  for (int c = 0; c < 3; ++c) {
    const float blo = __ldg(box + c * S + col), bhi = __ldg(box + (3 + c) * S + col);
    float lo1, hi1, lo2, hi2;
    cond_interval(b.dlo[c], __fsub_rn(bhi, b.olo[c]), lo1, hi1);
    cond_interval(-b.dhi[c], __fsub_rn(b.ohi[c], blo), lo2, hi2);
    t_lo = nan_max(t_lo, nan_max(lo1, lo2));
    t_hi = nan_min(t_hi, nan_min(hi1, hi2));
    real = real && (blo <= bhi);
  }
  return (t_hi >= t_lo && real) ? t_lo : INF;
}

// l . x in index order
__device__ __forceinline__ float dot_rn(float l0, float l1, float l2, const float* x) {
  return __fadd_rn(__fadd_rn(__fmul_rn(l0, x[0]), __fmul_rn(l1, x[1])), __fmul_rn(l2, x[2]));
}

// mesh instance mi's local-frame bundle of the world bundle w by centre +-
// radius through the inverse affine map, and dmin, the least |d_local| over
// its direction interval
__device__ void local_bundle(const SchedParams& p, int mi, const Bundle& w, Bundle& b,
                             float& dmin) {
  float iv[12];
#pragma unroll
  for (int r = 0; r < 12; ++r) iv[r] = __ldg(p.msc + r * p.n_mesh + mi);
  float oc[3], orad[3], dc[3], drad[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    oc[c] = __fmul_rn(__fadd_rn(w.olo[c], w.ohi[c]), 0.5f);
    orad[c] = __fmul_rn(__fsub_rn(w.ohi[c], w.olo[c]), 0.5f);
    dc[c] = __fmul_rn(__fadd_rn(w.dlo[c], w.dhi[c]), 0.5f);
    drad[c] = __fmul_rn(__fsub_rn(w.dhi[c], w.dlo[c]), 0.5f);
  }
  float sq[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float l0 = iv[4 * r], l1 = iv[4 * r + 1], l2 = iv[4 * r + 2];
    const float a0 = fabsf(l0), a1 = fabsf(l1), a2 = fabsf(l2);
    const float oc_l = __fadd_rn(dot_rn(l0, l1, l2, oc), iv[4 * r + 3]);
    const float orad_l = dot_rn(a0, a1, a2, orad);
    const float dc_l = dot_rn(l0, l1, l2, dc);
    const float drad_l = dot_rn(a0, a1, a2, drad);
    b.olo[r] = __fsub_rn(oc_l, orad_l);
    b.ohi[r] = __fadd_rn(oc_l, orad_l);
    b.dlo[r] = __fsub_rn(dc_l, drad_l);
    b.dhi[r] = __fadd_rn(dc_l, drad_l);
    const float cmin = (b.dlo[r] <= 0.0f && b.dhi[r] >= 0.0f)
                           ? 0.0f
                           : nan_min(fabsf(b.dlo[r]), fabsf(b.dhi[r]));
    sq[r] = __fmul_rn(cmin, cmin);
  }
  dmin = __fsqrt_rn(__fadd_rn(__fadd_rn(sq[0], sq[1]), sq[2]));
}

// f(kind, index, schedule offset, supers) for each segment of the
// schedule, in its order: kind 0 mesh instances, 1 large groups, 2 the
// small groups (with cull)
template <class F>
__device__ void for_segments(const SchedParams& p, F f) {
  for (int mi = 0; mi < p.n_mesh; ++mi)
    f(0, mi, __ldg(p.msi + 2 * p.n_mesh + mi), __ldg(p.msi + p.n_mesh + mi));
  int off = p.mesh_stot;
  for (int gi = 0; gi < p.A; ++gi) {
    const int n = __ldg(p.ana + 4 * gi + 2) / TRI_SUPER;
    f(1, gi, off, n);
    off += n;
  }
  if (p.cull) {
    for (int gi = 0; gi < p.G; ++gi)
      f(2, gi, p.sched_base + __ldg(p.groups + 4 * gi + 3),
        (__ldg(p.groups + 4 * gi + 2) + SUPER - 1) / SUPER);
  }
}

// torch.sort(stable=True)'s order: a before b (indices ia, ib)
__device__ __forceinline__ bool sorts_before(float a, int ia, float b, int ib) {
  if (a != a) return b != b && ia < ib;
  if (b != b) return true;
  return a < b || (a == b && ia < ib);
}

__global__ void __launch_bounds__(SCHED_BLOCK) schedule_kernel(SchedParams p) {
  __shared__ float part[12][SCHED_BLOCK / 32];
  __shared__ float red[12];
  const int tid = threadIdx.x;
  const size_t row = static_cast<size_t>(blockIdx.x) * p.W;

  // the tile's bundle: [0,3) least o, [3,6) greatest o, [6,9) least d,
  // [9,12) greatest d
  float v[12];
  const int ray0 = blockIdx.x * TILE + tid;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    v[c] = v[3 + c] = p.stf[c * p.M + ray0];
    v[6 + c] = v[9 + c] = p.stf[(3 + c) * p.M + ray0];
  }
  for (int ray = ray0 + SCHED_BLOCK; ray < (blockIdx.x + 1) * TILE; ray += SCHED_BLOCK) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float o = p.stf[c * p.M + ray], d = p.stf[(3 + c) * p.M + ray];
      v[c] = nan_min(v[c], o);
      v[3 + c] = nan_max(v[3 + c], o);
      v[6 + c] = nan_min(v[6 + c], d);
      v[9 + c] = nan_max(v[9 + c], d);
    }
  }
#pragma unroll
  for (int k = 0; k < 12; ++k) {
    const bool lo = (k / 3) % 2 == 0;
    for (int off = 16; off > 0; off >>= 1) {
      const float x = __shfl_xor_sync(0xffffffffu, v[k], off);
      v[k] = lo ? nan_min(v[k], x) : nan_max(v[k], x);
    }
    if (tid % 32 == 0) part[k][tid / 32] = v[k];
  }
  __syncthreads();
  if (tid < 12) {
    const bool lo = (tid / 3) % 2 == 0;
    float x = part[tid][0];
    for (int w = 1; w < SCHED_BLOCK / 32; ++w)
      x = lo ? nan_min(x, part[tid][w]) : nan_max(x, part[tid][w]);
    red[tid] = x;
  }
  __syncthreads();
  Bundle world;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    world.olo[c] = red[c];
    world.ohi[c] = red[3 + c];
    world.dlo[c] = red[6 + c];
    world.dhi[c] = red[9 + c];
  }

  // every segment's entry bounds, unsorted; the local frame's are scaled
  // by dmin before the INF test (INF * 0 would be nan)
  float* e = p.scratch + row;
  for_segments(p, [&](int kind, int idx, int off, int n) {
    if (kind == 0) {
      Bundle lb;
      float dmin;
      local_bundle(p, idx, world, lb, dmin);
      for (int k = tid; k < n; k += SCHED_BLOCK) {  // off: its super start
        const float raw = bundle_entry(lb, p.sbb, p.Sm, off + k);
        e[off + k] = raw >= INF ? INF : __fsub_rn(__fmul_rn(__fmul_rn(raw, dmin), SHRINK), MARGIN);
      }
    } else {
      const float* box = kind == 1 ? p.asbb : p.gsbb;
      const int S = kind == 1 ? p.Sa : p.Sg;
      const int ss = __ldg((kind == 1 ? p.ana : p.groups) + 4 * idx + 3);
      for (int k = tid; k < n; k += SCHED_BLOCK) {
        const float raw = bundle_entry(world, box, S, ss + k);
        e[off + k] = raw >= INF ? INF : __fsub_rn(__fmul_rn(raw, SHRINK), MARGIN);
      }
    }
  });
  if (tid == 0 && p.Stot == 0) {
    p.ord[row] = 0;  // no segment: the plain version's [nt, 1, 1] of 0, INF
    p.ent[row] = INF;
  }
  __syncthreads();

  // each segment sorted by rank
  for_segments(p, [&](int, int, int off, int n) {
    for (int i = tid; i < n; i += SCHED_BLOCK) {
      const float x = e[off + i];
      int rank = 0;
      for (int j = 0; j < n; ++j) rank += sorts_before(e[off + j], j, x, i);
      p.ord[row + off + rank] = i;
      p.ent[row + off + rank] = x;
    }
  });
}

}  // namespace

extern "C" int fused_call(void* stf, void* sti, int M, float ior, const void* tab, int P,
                          const void* gsbb, int Sg, const void* groups, int G, const void* msc,
                          const void* msi, int n_mesh, const void* cbb, int Cm, const void* sbb,
                          int Sm, const void* tpool, const void* acbb, int Ca, const void* asbb,
                          int Sa, const void* apool, const void* agr, const void* ana, int A,
                          const void* ord, const void* ent, int Stot, int mesh_stot,
                          int sched_base, int whole_path, int has_transparent, int flat_face,
                          int cull_small, const void* n_scan, int lanes, void* counts,
                          void* stream) {
  if (M <= 0 || M % TILE != 0 || (lanes != 0 && lanes != LANES_MANY && lanes != LANES_FEW))
    return static_cast<int>(cudaErrorInvalidValue);
#ifdef K2_COUNTS
  if (!counts) return static_cast<int>(cudaErrorInvalidValue);
#else
  if (counts) return static_cast<int>(cudaErrorInvalidValue);  // a K2_COUNTS build counts
#endif
  Params p;
  p.stf = static_cast<float*>(stf);
  p.sti = static_cast<int*>(sti);
  p.small.tab = static_cast<const float*>(tab);
  p.small.sbb = static_cast<const float*>(gsbb);
  p.small.groups = static_cast<const int*>(groups);
  p.small.P = P;
  p.small.S = Sg;
  p.small.G = G;
  p.msc = static_cast<const float*>(msc);
  p.msi = static_cast<const int*>(msi);
  p.cbb = static_cast<const float*>(cbb);
  p.sbb = static_cast<const float*>(sbb);
  p.tpool = static_cast<const float*>(tpool);
  p.acbb = static_cast<const float*>(acbb);
  p.asbb = static_cast<const float*>(asbb);
  p.apool = static_cast<const float*>(apool);
  p.agr = static_cast<const float*>(agr);
  p.ana = static_cast<const int*>(ana);
  p.ord = static_cast<const int*>(ord);
  p.ent = static_cast<const float*>(ent);
  p.n_scan = static_cast<const int*>(n_scan);
  p.counts = static_cast<unsigned long long*>(counts);
  p.ior = ior;
  p.M = M;
  p.n_mesh = n_mesh;
  p.Cm = Cm;
  p.Sm = Sm;
  p.Ca = Ca;
  p.Sa = Sa;
  p.A = A;
  p.Stot = Stot;
  p.mesh_stot = mesh_stot;
  p.sched_base = sched_base;
  p.whole_path = whole_path;
  p.lanes = lanes;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (has_transparent) {
    if (flat_face)
      launch_cull<true, true>(p, cull_small, s);
    else
      launch_cull<true, false>(p, cull_small, s);
  } else {
    if (flat_face)
      launch_cull<false, true>(p, cull_small, s);
    else
      launch_cull<false, false>(p, cull_small, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// the nearest-first super schedule of the wavefront stf [15, M] into ord and
// ent [M/TILE, 1, max(Stot, 1)], scratch [M/TILE, max(Stot, 1)]: one block a
// tile, on `stream`, no sync
extern "C" int fused_schedule(const void* stf, int M, const void* msc, const void* msi,
                              int n_mesh, const void* sbb, int Sm, const void* ana, int A,
                              const void* asbb, int Sa, const void* groups, int G,
                              const void* gsbb, int Sg, int cull_small, int mesh_stot,
                              int sched_base, int Stot, void* ord, void* ent, void* scratch,
                              void* stream) {
  if (M <= 0 || M % TILE != 0 || n_mesh < 0 || A < 0 || G < 0 || mesh_stot < 0 ||
      sched_base < mesh_stot || Stot < sched_base)
    return static_cast<int>(cudaErrorInvalidValue);
  SchedParams p;
  p.stf = static_cast<const float*>(stf);
  p.msc = static_cast<const float*>(msc);
  p.msi = static_cast<const int*>(msi);
  p.sbb = static_cast<const float*>(sbb);
  p.ana = static_cast<const int*>(ana);
  p.asbb = static_cast<const float*>(asbb);
  p.groups = static_cast<const int*>(groups);
  p.gsbb = static_cast<const float*>(gsbb);
  p.ord = static_cast<int*>(ord);
  p.ent = static_cast<float*>(ent);
  p.scratch = static_cast<float*>(scratch);
  p.M = M;
  p.n_mesh = n_mesh;
  p.Sm = Sm;
  p.A = A;
  p.Sa = Sa;
  p.G = G;
  p.Sg = Sg;
  p.cull = cull_small;
  p.mesh_stot = mesh_stot;
  p.sched_base = sched_base;
  p.Stot = Stot;
  p.W = Stot > 0 ? Stot : 1;
  schedule_kernel<<<M / TILE, SCHED_BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// the shape rule of this build: LANES_MANY, LANES_FEW, MANY_RAYS
extern "C" void fused_shape_rule(int* out) {
  out[0] = LANES_MANY;
  out[1] = LANES_FEW;
  out[2] = MANY_RAYS;
}

extern "C" const char* fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
