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
// Design. One thread per ray, 128 threads per block, all per-ray state in
// registers. In wavefront mode each thread reads column `ray` of the
// [15, M] f32 and [4, M] int32 state and writes it back in place, so the
// accesses are coalesced. The TPU's 1024-ray tile survives only as the row
// of the host's super schedule a ray reads (ord/ent[ray / 1024]). The
// TPU's 16-slot DMA ring, its per-sublane predication and its MXU one-hot
// winner gather are not carried over: a thread walks the chunks itself and
// keeps the index of its winning triangle or prim, whose attributes it
// reads once at the merge.
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
// Moller-Trumbore and shape tests (about 60 FP32 operations per
// ray-triangle test, 25 per ray-box test, 60-150 per ray-prim test),
// divergence (rays of one warp pass different chunk gates and stop their
// walks at different supers) and, on late bounces, occupancy: a few
// thousand live rays fill about one block per SM, each thread walking its
// chunks alone, with 168-255 registers and some spills. On an NVIDIA H100
// 80GB HBM3 at 700 W (chip_smoke.py), 43% of the lanes in mesh_demo's
// chunk folds did useful work, and bounces with 3% of the rays in flight
// took longer than the first. Memory is not the bound: mesh_demo's
// triangle pool is 737 KB and lives in L2 (50 MB), and a warp's threads
// that test the same chunk read the same addresses. The simple design
// answers with the per-ray early exit of the scheduled walk, the per-ray
// chunk gates, and finished rays leaving the bounce loop.
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
  unsigned long long* counts;  // [5] work counters (Counts), or null
  float ior;
  int M, n_mesh, Cm, Sm, Ca, Sa, A, Stot, mesh_stot, sched_base, whole_path;
};

// the work one thread did, summed over the launch into Params::counts when
// that is set: ray-triangle tests, ray-box tests of chunks and supers,
// ray-prim tests of the large groups, traces, and the lane slots the warps
// spent on chunk folds (tri + prim over slots is the share of lanes that
// did useful work there: divergence costs the rest)
struct Counts {
  uint32_t tri = 0, box = 0, prim = 0, trace = 0, slots = 0;
};

// a warp runs a chunk's fold once for all of its threads that take it:
// the lowest of them counts the warp's 32 x CHUNK lane slots
__device__ __forceinline__ void count_slots(Counts& n) {
  if ((threadIdx.x % 32) == __ffs(__activemask()) - 1) n.slots += 32 * CHUNK;
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
// ray; a valid hit strictly closer than abest becomes the winner
__device__ __forceinline__ void fold_tris(const float* __restrict__ tpool, int c, V3 oi, V3 di,
                                          float& abest, int& best, Counts& n) {
  const float* blk = tpool + static_cast<size_t>(c) * TRI_ROWS * CHUNK;
  n.tri += CHUNK;
  count_slots(n);
  for (int t = 0; t < CHUNK; ++t) {
    float a;
    if (mt_hit(row3(blk, 0, t), row3(blk, 3, t), row3(blk, 6, t), oi, di, a) && a < abest) {
      abest = a;
      best = c * CHUNK + t;
    }
  }
}

__device__ __forceinline__ void visit_tri_super(const Params& p, int c0, V3 oi, V3 di, V3 rdi,
                                                float bound, float& abest, int& best, Counts& n) {
  n.box += TRI_SUPER;
  for (int j = 0; j < TRI_SUPER; ++j) {
    const int c = c0 + j;
    if (slab_cap(p.cbb, p.Cm, c, oi, rdi, fminf(abest, bound)))
      fold_tris(p.tpool, c, oi, di, abest, best, n);
  }
}

// walk mesh instance mi and merge its winner into w by world distance
template <bool FLAT>
__device__ void mesh_instance(const Params& p, int mi, bool scheduled, const int* ord_row,
                              const float* ent_row, V3 o, V3 d, Win& w, Counts& n) {
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
      visit_tri_super(p, cstart + s * TRI_SUPER, oi, di, rdi, bound, abest, best, n);
    }
  } else {
    n.box += nsup;
    for (int s = 0; s < nsup; ++s) {
      if (slab_cap(p.sbb, p.Sm, sstart + s, oi, rdi, fminf(abest, bound)))
        visit_tri_super(p, cstart + s * TRI_SUPER, oi, di, rdi, bound, abest, best, n);
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

template <int SHAPE>
__device__ __forceinline__ void fold_prims(const float* __restrict__ apool, int c, V3 o, V3 d,
                                           float& abest, int& best, Counts& n) {
  const float* blk = apool + static_cast<size_t>(c) * ANA_ROWS * CHUNK;
  n.prim += CHUNK;
  count_slots(n);
  for (int t = 0; t < CHUNK; ++t) {
    if (!(__ldg(blk + 31 * CHUNK + t) > 0.0f)) continue;  // chunk padding
    float dist;
    int code;
    V3 pl, pg;
    if (ana_candidate<SHAPE>(blk, t, o, d, dist, code, pl, pg) && dist < abest) {
      abest = dist;
      best = c * CHUNK + t;
    }
  }
}

template <int SHAPE>
__device__ __forceinline__ void visit_ana_super(const Params& p, int c0, V3 o, V3 d, V3 rd,
                                                float bound, float& abest, int& best, Counts& n) {
  n.box += TRI_SUPER;
  for (int j = 0; j < TRI_SUPER; ++j) {
    const int c = c0 + j;
    if (slab_cap(p.acbb, p.Ca, c, o, rd, fminf(abest, bound)))
      fold_prims<SHAPE>(p.apool, c, o, d, abest, best, n);
  }
}

// walk large group g (chunks cstart.., supers sstart.., schedule segment at
// ssched) in world distance and merge its winner into w
template <int SHAPE>
__device__ void ana_group(const Params& p, int g, int cstart, int nchunks, int sstart, int ssched,
                          bool scheduled, const int* ord_row, const float* ent_row, V3 o, V3 d,
                          V3 rd, Win& w, Counts& n) {
  const float bound = root_bound(p.agr, p.A, g, o, rd);
  float abest = w.bd;
  int best = -1;  // winning prim: chunk * 128 + column
  const int nsup = nchunks / TRI_SUPER;
  if (scheduled) {
    for (int k = 0; k < nsup; ++k) {
      if (!(__ldg(ent_row + ssched + k) < fminf(abest, bound))) break;
      const int s = __ldg(ord_row + ssched + k);
      visit_ana_super<SHAPE>(p, cstart + s * TRI_SUPER, o, d, rd, bound, abest, best, n);
    }
  } else {
    n.box += nsup;
    for (int s = 0; s < nsup; ++s) {
      if (slab_cap(p.asbb, p.Sa, sstart + s, o, rd, fminf(abest, bound)))
        visit_ana_super<SHAPE>(p, cstart + s * TRI_SUPER, o, d, rd, bound, abest, best, n);
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

// The first call of a launch is the scheduled outer trace; every later one
// (the refraction re-trace, later bounces of whole-path mode) walks
// without the schedule.
template <bool FLAT, bool CULL>
struct FusedTrace {
  const Params& p;
  const int* ord_row;
  const float* ent_row;
  bool scheduled;
  Counts n;

  __device__ void operator()(V3 o, V3 d, V3 n_prev, V3 p_prev, Win& w) {
    ++n.trace;
    trace_fold<CULL>(p.small, ord_row + p.sched_base, o, d, n_prev, p_prev, w);
    for (int mi = 0; mi < p.n_mesh; ++mi)
      mesh_instance<FLAT>(p, mi, scheduled, ord_row, ent_row, o, d, w, n);
    if (p.A > 0) {
      const V3 rd = {safe_rcp(d.x), safe_rcp(d.y), safe_rcp(d.z)};
      int ssched = p.mesh_stot;
      for (int g = 0; g < p.A; ++g) {
        const int code = __ldg(p.ana + 4 * g);
        const int cstart = __ldg(p.ana + 4 * g + 1);
        const int nchunks = __ldg(p.ana + 4 * g + 2);
        const int sstart = __ldg(p.ana + 4 * g + 3);
        switch (code) {  // uniform: every thread reads the same descriptor
          case SPHERE:
            ana_group<SPHERE>(p, g, cstart, nchunks, sstart, ssched, scheduled, ord_row, ent_row,
                              o, d, rd, w, n);
            break;
          case CUBE:
            ana_group<CUBE>(p, g, cstart, nchunks, sstart, ssched, scheduled, ord_row, ent_row, o,
                            d, rd, w, n);
            break;
          case CYLINDER:
            ana_group<CYLINDER>(p, g, cstart, nchunks, sstart, ssched, scheduled, ord_row,
                                ent_row, o, d, rd, w, n);
            break;
          case CONE:
            ana_group<CONE>(p, g, cstart, nchunks, sstart, ssched, scheduled, ord_row, ent_row, o,
                            d, rd, w, n);
            break;
          default:
            ana_group<QUAD>(p, g, cstart, nchunks, sstart, ssched, scheduled, ord_row, ent_row, o,
                            d, rd, w, n);
            break;
        }
        ssched += nchunks / TRI_SUPER;
      }
    }
    scheduled = false;
  }
};

template <bool TRANSPARENT, bool FLAT, bool CULL>
__global__ void __launch_bounds__(BLOCK) fused_kernel(Params p) {
  const int ray = blockIdx.x * BLOCK + threadIdx.x;
  if (ray >= p.M) return;
  const int M = p.M;
  float* f = p.stf + ray;
  int* u = p.sti + ray;
  Path s;
  s.o = {f[0], f[M], f[2 * M]};
  s.d = {f[3 * M], f[4 * M], f[5 * M]};
  s.att = {f[6 * M], f[7 * M], f[8 * M]};
  s.total = {f[9 * M], f[10 * M], f[11 * M]};
  s.result = {f[12 * M], f[13 * M], f[14 * M]};
  s.done = u[0] != 0;
  s.st = {static_cast<uint32_t>(u[M]), static_cast<uint32_t>(u[2 * M]),
          static_cast<uint32_t>(u[3 * M])};
  if (s.done) return;  // a finished ray changes nothing
  const int row = (ray / TILE) * p.Stot;
  FusedTrace<FLAT, CULL> trace{p, p.ord + row, p.ent + row, true, {}};
  const int nb = p.whole_path > 0 ? p.whole_path : 1;
  for (int bounce = 0; bounce < nb && !s.done; ++bounce)
    bounce_step<TRANSPARENT>(trace, p.ior, s);
  const float out[15] = {s.o.x,     s.o.y,     s.o.z,     s.d.x,     s.d.y,
                         s.d.z,     s.att.x,   s.att.y,   s.att.z,   s.total.x,
                         s.total.y, s.total.z, s.result.x, s.result.y, s.result.z};
#pragma unroll
  for (int k = 0; k < 15; ++k) f[k * M] = out[k];
  u[0] = s.done ? 1 : 0;
  u[M] = static_cast<int>(s.st.s0);
  u[2 * M] = static_cast<int>(s.st.s1);
  u[3 * M] = static_cast<int>(s.st.s2);
  if (p.counts) {  // one atomic per warp and counter
    const unsigned mask = __activemask();
    const uint32_t c[5] = {trace.n.tri, trace.n.box, trace.n.prim, trace.n.trace,
                           trace.n.slots};
    const bool leader = (threadIdx.x % 32) == (__ffs(mask) - 1);
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      const uint32_t sum = __reduce_add_sync(mask, c[k]);
      if (leader) atomicAdd(p.counts + k, static_cast<unsigned long long>(sum));
    }
  }
}

template <bool TRANSPARENT, bool FLAT, bool CULL>
void launch(const Params& p, cudaStream_t stream) {
  const int grid = (p.M + BLOCK - 1) / BLOCK;
  fused_kernel<TRANSPARENT, FLAT, CULL><<<grid, BLOCK, 0, stream>>>(p);
}

template <bool TRANSPARENT, bool FLAT>
void launch_cull(const Params& p, int cull, cudaStream_t stream) {
  if (cull)
    launch<TRANSPARENT, FLAT, true>(p, stream);
  else
    launch<TRANSPARENT, FLAT, false>(p, stream);
}

}  // namespace

extern "C" int fused_call(void* stf, void* sti, int M, float ior, const void* tab, int P,
                          const void* gsbb, int Sg, const void* groups, int G, const void* msc,
                          const void* msi, int n_mesh, const void* cbb, int Cm, const void* sbb,
                          int Sm, const void* tpool, const void* acbb, int Ca, const void* asbb,
                          int Sa, const void* apool, const void* agr, const void* ana, int A,
                          const void* ord, const void* ent, int Stot, int mesh_stot,
                          int sched_base, int whole_path, int has_transparent, int flat_face,
                          int cull_small, void* counts, void* stream) {
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

extern "C" const char* fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
