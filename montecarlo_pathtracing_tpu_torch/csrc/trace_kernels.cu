// The trace kernels of the pallas-trace route, by hand for Hopper (sm_90a):
// the closest hit of a ray set against one analytic group or one mesh
// instance. The host (ops/pallas_trace.py, ops/sparse_trace.py) pads the
// tables, computes the tile bundles, entry bounds, root-box exit bounds
// and the ranked schedules, and merges the winners into the scene's hit
// record (ops/trace.py::trace_soa).
//
// K3a group_kernel replaces montecarlo_pathtracing_tpu/ops/pallas_trace.py:162
//     (_group_kernel_plain, launched by group_best_rows): world rays against
//     every prim of a homogeneous group; (dist, group row, local a, dircode).
// K3b group_culled_kernel replaces ops/pallas_trace.py:251
//     (_group_kernel_culled, launched by group_best_rows with chunk boxes):
//     K3a behind a slab test of each 128-prim chunk's world box.
// K4a tri_kernel replaces ops/pallas_trace.py:497 (_tri_kernel, launched by
//     mesh_best_rows): Moller-Trumbore of mesh-local unit rays against every
//     128-triangle chunk, folded on the local parameter a; (a, row).
// K4b tri_culled_kernel replaces ops/pallas_trace.py:543 (_tri_kernel_culled,
//     launched by mesh_best_rows with leaf and super boxes): K4a behind two
//     levels of slab tests, supers of 16 leaf chunks and then each leaf.
// K5 an_walk replaces ops/sparse_trace.py:139 (_an_kernel, launched by
//     _an_fold_call inside group_best_rows_sparse): the nearest-first walk of
//     a 1024-ray tile over the group's 8-prim blocks, with the occlusion prune.
// K6 mesh_walk replaces ops/sparse_trace.py:374 (_mesh_kernel, launched by
//     _mesh_fold_call inside mesh_best_rows_sparse): the same walk of a
//     128-ray tile over the instance's 128-triangle chunks.
// Their plain PyTorch versions are the *_plain functions beside the
// wrappers; chip_smoke.py holds each kernel against its plain version.
//
// Design. One thread per ray, its best hit in registers. Folds run in
// ascending prim or triangle order with a strict `<`: the TPU kernels'
// first minimum inside a chunk followed by a strictly-closer merge across
// chunks (pallas_trace.py:204-224) is exactly that scan, so the winners,
// ties included, are the TPU kernels', and every output equals the plain
// versions' bit for bit. Padding prims (scene id < 0 in K3a and K3b, ok
// flag 0 in K5) never win; padding triangles are degenerate. K3b reads the
// group's table columns with __ldg, the same column by every thread of a
// warp: one broadcast each. K4b and K6 stage each chunk's [9, 128] corner
// rows (4.6 KB) in shared memory, one column per thread, and every thread
// then tests the chunk's triangles from there. K5 reads an 8-prim block's
// [25, 8] table (inverse rows, forward rows, ok flag) as warp-wide
// broadcasts (see "The walks").
//
// The brute folds (K3a, K4a) are bound by the instructions they issue:
// every FP32 operation is one (no FMA, below), and each IEEE division and
// square root adds a range check and a slow-path branch. K4a's fold loop
// issues about 50 instructions a test up to its reject on u (10 of them
// the reciprocal), K3a's 130-290 a test by shape up to its hit path
// (chip_smoke.py phase 1 counts them in the SASS). So their design cuts
// instructions, one ray a thread:
// - K4a stages each chunk as the corner A and the edges e1 = B - A and
//   e2 = C - A (mt_hit's own subtractions, once a chunk and not once a
//   test), a float4 each: three 16-byte shared broadcasts a test. The
//   next chunk is loaded into registers while this one is folded and
//   staged into the other buffer after it: one barrier a chunk. 1 / det
//   is given 1 where |det| < EPS, so a degenerate triangle takes no slow
//   path. q, v and a run only where some ray of the warp has |det| >= EPS
//   and u in [0, 1]: every other test is rejected whatever they are.
// - K3a stages each 128-prim chunk's inverse and forward rows in shared
//   memory as [prim][row] float4s (12 KB): three broadcasts for the local
//   frame, three more for the forward rows, read only where some ray of
//   the warp passes the shape test. A prim with scene id < 0 is staged
//   with a NaN inverse frame, which fails every shape test, and the chunk
//   stops one past its last prim with scene id >= 0 (the group's padding
//   costs nothing). Its shape tests give each square root and division
//   whose result they would mask an argument of 1, so that the lanes of a
//   miss skip the IEEE slow path (sqrtf(0) takes it); the values they keep
//   are common.cuh's, float for float.
// - Measured on an H100 and dropped (PERF.md): 2 and 4 rays a thread,
//   slower on both: a 128-thread block then holds 2 or 4 times the rays,
//   so fewer warps share an SM, and the shared reads they save are few;
//   and 2 or 4 prims or triangles a step, no faster. K4a's reject on u is
//   its largest step and double buffering its smallest. The select form
//   itself compiles to about the same branches as common.cuh's tests: the
//   masked arguments are K3a's gain there.
//
// The culled folds (K3b, K4b). Before a chunk each ray tests the chunk's
// box against its running best (the reference's slab test, with
// ops/vec.safe_rcp's reciprocals: a zero component gives a huge finite
// value, never inf * 0). The TPU skipped a chunk when no ray of its
// 1024-ray tile passed; the cull is conservative (a hit inside a box lies
// no nearer than the box's entry), so any subset of a tile's rays, down to
// one, may skip a chunk that none of its rays passes, and the winners stay
// the brute fold's. K3b gates per warp (__any_sync): its prims are read as
// warp-wide broadcasts, so a warp is the finest unit that runs a chunk
// together, and it needs no barrier. Gating each ray alone would save no
// time (a lane that skips idles while its warp runs the chunk for the
// others); gating the 128-ray block would add a barrier per chunk (1,172 on
// a 150k-prim group) and run chunks for four warps that one of them needs.
// K4b gates per block (__syncthreads_or), since its block stages a chunk's
// triangles in shared memory together; the barrier is the one staging
// needs anyway. Its padding leaves (past the last real chunk, empty boxes)
// are skipped and never read; the reference clamped their data index to
// the last real chunk instead (pallas_trace.py:580-590). Box columns are
// read with __ldg, the same column by every thread: uniform broadcasts
// from L1 (1,172 K3b boxes are 28 KB).
//
// The walks (K5, K6). A K6 block walks its tile's ranked list (order[t],
// tlo[t], ascending entry bound) front to back in one launch; before each
// chunk it asks with __syncthreads_or whether any of its rays still has
// tlo < min(best, bound), the prune of sparse_trace.py:401-403, and ends the
// walk at the first that none has. In K5 each warp walks its tile's list on
// its own, with no block barrier: it takes the prune over its own 32 rays
// (__any_sync), then tests the block's box (sup_bb) per ray within min(best,
// bound), K3b's slab test, and skips the block when none of its rays enters
// it (a lane that does not enter idles while the others test). The TPU took
// the prune over the whole 1024-ray tile, and both the prune and the gate
// are sound over any subset of a tile's rays, down to one: tlo lower-bounds
// every ray of the tile's entry into the box (the bundle holds them all), a
// hit inside a box lies no nearer than the ray's entry into it, and bound
// caps every hit inside the root box, so a block skipped for ray r holds no
// hit strictly closer than r's best. The list is sorted and best only
// shrinks, so nothing later passes the prune either. Winners equal the brute
// fold's; on an exact distance tie between two blocks the ranked order
// decides, as it does on the TPU. K5's plain version keeps the tile-wide
// prune alone. K5 reads each prim's 25 rows with __ldg, the same address for
// the warp's 32 lanes: one broadcast from L1 each, issued together for the
// block's 8 prims, so no step waits on a staging barrier. Staging each
// block's table per warp in shared memory, with the next ranked block's
// loads in flight, measured slower on an H100 (PERF.md), so the table is
// read as broadcasts. "Blocks visited" (counter [1]) counts, per
// warp, the blocks it entered. The TPU's repeated calls over a budgeted
// worklist, carrying the best in and out (ain/rin), are not needed: the
// whole list is walked in one launch.
//
// What bounds them on this card: FP32 operations. A ray-prim test is 47-86
// FP32 operations (the local frame 42, the shape test 5-44), and 33 more for
// the world hit point and distance where the shape test passes; a
// ray-triangle test is 51 (20 where the determinant rejects it); a slab
// test about 24. The bytes are few: rays in, winners out, chunk boxes,
// tables read from L1 and L2 (a group's [25, P] table is 52 KB at 512 prims;
// mesh_demo's largest instance is 83 KB of corners). What keeps them from
// that bound: the IEEE divisions' and square roots' extra instructions, the
// brute kernels' tests of prims a ray can never hit, and in the walks the
// chunks a block visits for its few rays that still need them.
//
// Work counters, when `counts` is set: [0] ray-prim or ray-triangle tests
// done (K3a and K4a: every ray against each chunk's items up to its end,
// so a prim with scene id < 0 before a chunk's last real prim counts
// too), [1] 128-prim chunks (K3a) or chunks (K4a, K6) that blocks visited,
// 8-prim blocks that warps entered (K5), or chunks that warps (K3b) or
// blocks (K4b) entered,
// [2] tests that hit (the shape test passed, or the triangle was hit); K3b
// and K4b add [3] ray-box tests and K4b [4] supers that blocks entered.
//
// Floating point is IEEE, without --use_fast_math (see common.cuh), and this
// file is built without FMA contraction (-fmad=false, kernels.EXTRA_FLAGS):
// every multiply and add rounds on its own, as in the plain versions, and
// the kernels return their distances bit for bit. The world distance is
// rebuilt from a hit point in the prim's frame, which cancels badly for rays
// far from a prim; with contracted multiply-adds the distances moved by up
// to 1.5e-3 relative on an H100, past the reference's own 5e-4 between its
// folds (tests/test_pallas_trace.py:72). chip_smoke.py times both builds.

#include "common.cuh"

namespace {

using namespace pt;

constexpr int CHUNK = 128;      // prims or triangles per chunk
constexpr int SUPB = 8;         // prims per K5 block
constexpr int TAB_ROWS = 25;    // K5 block rows: inverse, forward, ok flag
constexpr int AN_TILE = 1024;   // rays per K5 tile
constexpr int AN_BLOCK = 256;   // rays per K5 thread block (a quarter tile)
constexpr int MESH_TILE = 128;  // rays per K6 tile and thread block
constexpr float INF = 3e38f;    // entry bound of an unreachable block
constexpr int TRI_SUPER = 16;   // leaf chunks per K4b super
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ V3 ray_at(const float* r, int M, int i) {
  return {r[i], r[M + i], r[2 * M + i]};
}

// v summed over the warp's threads, added to *slot by one of them
__device__ __forceinline__ void add_warp_sum(unsigned long long* slot, uint32_t v) {
  const unsigned mask = __activemask();
  const uint32_t sum = __reduce_add_sync(mask, v);
  if ((threadIdx.x % 32) == __ffs(mask) - 1) atomicAdd(slot, static_cast<unsigned long long>(sum));
}

// the thread's tests and hits summed per warp, and the block's visits once
__device__ __forceinline__ void add_counts(unsigned long long* counts, uint32_t tests,
                                           uint32_t visits, uint32_t hits) {
  if (!counts) return;
  add_warp_sum(counts, tests);
  add_warp_sum(counts + 2, hits);
  if (threadIdx.x == 0) atomicAdd(counts + 1, static_cast<unsigned long long>(visits));
}

// one ray against one prim of a group: world distance and local hit (a,
// code), false where the shape test fails
template <int SHAPE>
__device__ __forceinline__ bool prim_hit(const float* iv, const float* tf, V3 o, V3 d, float& dist,
                                         float& a, int& code) {
  const V3 oi = affine(iv, o);
  const V3 di = vnorm(linear(iv, d), TINY);
  if (!shape_test<SHAPE>(oi, di, a, code)) return false;
  const V3 pl = {oi.x + a * di.x, oi.y + a * di.y, oi.z + a * di.z};
  const V3 e = sub(o, affine(tf, pl));
  dist = sqrtf(e.x * e.x + e.y * e.y + e.z * e.z);
  return true;
}

// prims [begin, end) of a group's [12, ppad] tables, ascending, folded into
// the best (bd, brow, ba, bdir) under the strictly-closer rule
template <int SHAPE>
__device__ __forceinline__ void fold_prims(const float* __restrict__ inv,
                                           const float* __restrict__ trf,
                                           const int* __restrict__ pid, int ppad, int begin,
                                           int end, V3 ro, V3 rd, float& bd, int& brow, float& ba,
                                           int& bdir, uint32_t& tests, uint32_t& hits) {
  for (int c = begin; c < end; ++c) {
    if (__ldg(pid + c) < 0) continue;  // group padding never hits
    ++tests;
    float iv[12], tf[12];
#pragma unroll
    for (int r = 0; r < 12; ++r) iv[r] = ld(inv, r, ppad, c);
#pragma unroll
    for (int r = 0; r < 12; ++r) tf[r] = ld(trf, r, ppad, c);
    float dist, a;
    int code;
    if (!prim_hit<SHAPE>(iv, tf, ro, rd, dist, a, code)) continue;
    ++hits;
    if (dist < bd) {
      bd = dist;
      brow = c;
      ba = a;
      bdir = code;
    }
  }
}

// ---------------------------------------------------------------------------
// K3a: every prim of one group, ascending
// ---------------------------------------------------------------------------

// K3a's shape tests: common.cuh's, term for term, in select form, with each
// square root and division whose result the test would mask given an
// argument of 1 instead. The masked lanes then skip the IEEE square root's
// and division's slow paths (a zero or an infinite argument), and every
// value the test keeps is the same float as common.cuh's.
__device__ __forceinline__ bool g_sphere(V3 o, V3 d, float& a, int& code) {
  const float OO = o.x * o.x + o.y * o.y + o.z * o.z;
  const float OD = o.x * d.x + o.y * d.y + o.z * d.z;
  const float D2 = d.x * d.x + d.y * d.y + d.z * d.z;
  const float delta4 = OD * OD - D2 * (OO - 1.0f);
  const bool ok = delta4 > 0.0f;
  const float sq = sqrtf(ok ? delta4 : 1.0f);
  const float den = ok ? D2 : 1.0f;
  const float a1 = -(OD + sq) / den;
  const float a2 = -(OD - sq) / den;
  const bool v1 = ok && (a1 > EPS);
  const bool v2 = ok && (a2 > EPS);
  a = v1 ? a1 : (v2 ? a2 : FMAX);
  code = 0;
  return v1 || v2;
}

__device__ __forceinline__ bool g_quad(V3 o, V3 d, float& a, int& code) {
  const bool facing = d.z <= -EPS;
  const float t = -o.z / (facing ? d.z : -1.0f);
  const float px = o.x + t * d.x;
  const float py = o.y + t * d.y;
  const bool valid = facing && (fabsf(px) <= 1.0f) && (fabsf(py) <= 1.0f);
  a = valid ? t : FMAX;
  code = 0;
  return valid;
}

__device__ __forceinline__ bool g_cube(V3 o3, V3 d3, float& a, int& code) {
  const float o[3] = {o3.x, o3.y, o3.z};
  const float d[3] = {d3.x, d3.y, d3.z};
  float al = FMAX;
  int face = 0;
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    const int c0 = c / 2, c1 = (c0 + 1) % 3, c2 = (c0 + 2) % 3;
    const float cd = -1.0f + 2.0f * (c % 2);
    const bool dok = fabsf(d[c0]) > EPS;
    const float t = (cd - o[c0]) / (dok ? d[c0] : 1.0f);
    const bool v = dok && (t > EPS) && (fabsf(o[c1] + t * d[c1]) <= 1.0f) &&
                   (fabsf(o[c2] + t * d[c2]) <= 1.0f) && (t < al);
    al = v ? t : al;
    face = v ? c : face;
  }
  a = al;
  code = face;
  return al < FMAX;
}

__device__ __forceinline__ bool g_cylinder(V3 o, V3 d, float& a, int& code) {
  float al = FMAX;
  int cl = -1;
  const bool dz_ok = fabsf(d.z) > EPS;
  const float dz = dz_ok ? d.z : 1.0f;
#pragma unroll
  for (int cap = 0; cap < 2; ++cap) {
    const float zplane = cap ? 1.0f : -1.0f;
    const float t = (zplane - o.z) / dz;
    const float rx = o.x + t * d.x;
    const float ry = o.y + t * d.y;
    const bool v = dz_ok && (t > EPS) && (rx * rx + ry * ry < 1.0f) && (t < al);
    al = v ? t : al;
    cl = v ? cap : cl;
  }
  const float O2 = o.x * o.x + o.y * o.y;
  const float OD = o.x * d.x + o.y * d.y;
  const float D2 = d.x * d.x + d.y * d.y;
  const float delta4 = OD * OD - D2 * (O2 - 1.0f);
  const bool ok = delta4 > 0.0f;
  const float t = -(OD + sqrtf(ok ? delta4 : 1.0f)) / (ok ? D2 : 1.0f);
  const float z = o.z + t * d.z;
  const bool v = ok && (t > EPS) && (t < al) && (fabsf(z) < 1.0f);
  a = v ? t : al;
  code = v ? 2 : cl;
  return a < FMAX;
}

__device__ __forceinline__ bool g_cone(V3 o, V3 d, float& a, int& code) {
  const bool dz_ok = fabsf(d.z) > EPS;
  const float t0 = (-1.0f - o.z) / (dz_ok ? d.z : 1.0f);
  const float rx = o.x + t0 * d.x;
  const float ry = o.y + t0 * d.y;
  const bool v0 = dz_ok && (t0 > EPS) && (rx * rx + ry * ry < 1.0f) && (t0 < FMAX);
  float tl = v0 ? t0 : FMAX;
  int cl = v0 ? 0 : -1;
  const float k = 0.8f;  // cos^2 of the cone's half-angle
  const float coz = o.z - 1.0f;
  const float dco = d.x * o.x + d.y * o.y + d.z * coz;
  const float coco = o.x * o.x + o.y * o.y + coz * coz;
  const float a_ = d.z * d.z - k;
  const float b_ = 2.0f * (d.z * coz - dco * k);
  const float c_ = coz * coz - coco * k;
  const float det = b_ * b_ - 4.0f * a_ * c_;
  const bool ok = det > 0.0f;
  const float sq = sqrtf(ok ? det : 1.0f);
  float t1 = (-b_ - sq) / (2.0f * a_);
  float t2 = (-b_ + sq) / (2.0f * a_);
  t1 = fabsf(o.z + t1 * d.z) > 1.0f ? FMAX : t1;
  t2 = fabsf(o.z + t2 * d.z) > 1.0f ? FMAX : t2;
  // the reference's minimum propagates nan, which then fails `t < tl`
  const bool nan = isnan(t1) || isnan(t2);
  const float t = fminf(t1, t2);
  const bool v = !nan && ok && (t < tl);
  a = v ? t : tl;
  code = v ? 2 : cl;
  return a < FMAX;
}

template <int SHAPE>
__device__ __forceinline__ bool group_shape(V3 o, V3 d, float& a, int& code) {
  if (SHAPE == SPHERE) return g_sphere(o, d, a, code);
  if (SHAPE == CUBE) return g_cube(o, d, a, code);
  if (SHAPE == CYLINDER) return g_cylinder(o, d, a, code);
  if (SHAPE == CONE) return g_cone(o, d, a, code);
  return g_quad(o, d, a, code);
}

// a staged prim: its inverse and forward affine rows, four floats a
// float4, so that a thread reads a 3x4 matrix as three 16-byte broadcasts
struct StagedPrim {
  float4 inv[3], trf[3];
};

__device__ __forceinline__ void unpack(const float4 (&m)[3], float (&f)[12]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    f[4 * k] = m[k].x;
    f[4 * k + 1] = m[k].y;
    f[4 * k + 2] = m[k].z;
    f[4 * k + 3] = m[k].w;
  }
}

// 1 + the largest chunk index whose flag is set, over the block's threads
// (one per chunk column): each warp's maximum goes to ends[warp] and the
// block's is read after the next barrier (chunk_end)
__device__ __forceinline__ void put_end(int* ends, bool real) {
  const int end = __reduce_max_sync(FULL, real ? static_cast<int>(threadIdx.x) + 1 : 0);
  if (threadIdx.x % 32 == 0) ends[threadIdx.x / 32] = end;
}

__device__ __forceinline__ int chunk_end(const int* ends) {
  int end = 0;
#pragma unroll
  for (int w = 0; w < CHUNK / 32; ++w) end = max(end, ends[w]);
  return end;
}

// stage column p of the group's tables in slot s. A prim with scene id < 0
// gets a NaN inverse frame: its local ray is NaN, which fails every shape
// test, so it never hits, as the padding masked by the plain version.
__device__ __forceinline__ void stage_prim(StagedPrim& s, int* ends, const float* inv,
                                           const float* trf, const int* pid, int ppad, int p) {
  const bool real = __ldg(pid + p) >= 0;
  float iv[12], tf[12];
#pragma unroll
  for (int r = 0; r < 12; ++r) {
    iv[r] = real ? ld(inv, r, ppad, p) : __int_as_float(0x7fc00000);
    tf[r] = ld(trf, r, ppad, p);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    s.inv[k] = make_float4(iv[4 * k], iv[4 * k + 1], iv[4 * k + 2], iv[4 * k + 3]);
    s.trf[k] = make_float4(tf[4 * k], tf[4 * k + 1], tf[4 * k + 2], tf[4 * k + 3]);
  }
  put_end(ends, real);
}

// the staged prims [0, end) of chunk c folded, ascending, into the ray's
// best under the strictly-closer rule. The local frame and the shape test
// run for every prim; the forward rows, the hit point and the distance
// only when some ray of the warp passes the shape test.
template <int SHAPE>
__device__ __forceinline__ void group_fold(const StagedPrim* s, int end, int c, V3 ro, V3 rd,
                                           float& bd, int& brow, float& ba, int& bdir,
                                           uint32_t& hits) {
  for (int j = 0; j < end; ++j) {
    float iv[12];
    unpack(s[j].inv, iv);
    const V3 oi = affine(iv, ro);
    const V3 di = vnorm(linear(iv, rd), TINY);
    float a;
    int code;
    const bool ok = group_shape<SHAPE>(oi, di, a, code);
    if (!__any_sync(FULL, ok)) continue;
    float tf[12];
    unpack(s[j].trf, tf);
    if (!ok) continue;
    ++hits;
    const V3 pl = {oi.x + a * di.x, oi.y + a * di.y, oi.z + a * di.z};
    const V3 e = sub(ro, affine(tf, pl));
    const float dist = sqrtf(e.x * e.x + e.y * e.y + e.z * e.z);
    if (dist < bd) {
      bd = dist;
      brow = c * CHUNK + j;
      ba = a;
      bdir = code;
    }
  }
}

template <int SHAPE>
__global__ void __launch_bounds__(CHUNK)
    group_kernel(const float* __restrict__ o, const float* __restrict__ d, int M,
                 const float* __restrict__ inv, const float* __restrict__ trf,
                 const int* __restrict__ pid, int ppad, float* dist_out, int* row_out,
                 float* a_out, int* dir_out, unsigned long long* counts) {
  __shared__ StagedPrim s[CHUNK];
  __shared__ int ends[CHUNK / 32];
  const int ray = blockIdx.x * CHUNK + threadIdx.x;
  const V3 ro = ray_at(o, M, ray);
  const V3 rd = ray_at(d, M, ray);
  float bd = FMAX, ba = 0.0f;
  int brow = -1, bdir = -1;
  const int nchunks = ppad / CHUNK;
  uint32_t tests = 0, hits = 0;
  for (int c = 0; c < nchunks; ++c) {
    __syncthreads();  // every thread is done with the previous chunk
    stage_prim(s[threadIdx.x], ends, inv, trf, pid, ppad, c * CHUNK + threadIdx.x);
    __syncthreads();
    const int end = chunk_end(ends);
    tests += end;
    group_fold<SHAPE>(s, end, c, ro, rd, bd, brow, ba, bdir, hits);
  }
  dist_out[ray] = bd;
  row_out[ray] = bd < FMAX ? brow : -1;
  a_out[ray] = ba;
  dir_out[ray] = bdir;
  add_counts(counts, tests, nchunks, hits);
}

// ---------------------------------------------------------------------------
// K3b: K3a, a warp entering a 128-prim chunk only if one of its rays
// enters the chunk's box no farther than its best
// ---------------------------------------------------------------------------

template <int SHAPE>
__global__ void __launch_bounds__(CHUNK)
    group_culled_kernel(const float* __restrict__ o, const float* __restrict__ d, int M,
                        const float* __restrict__ inv, const float* __restrict__ trf,
                        const int* __restrict__ pid, int ppad, const float* __restrict__ cbb,
                        float* dist_out, int* row_out, float* a_out, int* dir_out,
                        unsigned long long* counts) {
  const int ray = blockIdx.x * CHUNK + threadIdx.x;
  const V3 ro = ray_at(o, M, ray);
  const V3 rd = ray_at(d, M, ray);
  const V3 rcp = {safe_rcp(rd.x), safe_rcp(rd.y), safe_rcp(rd.z)};
  const int nchunks = ppad / CHUNK;
  float bd = FMAX, ba = 0.0f;
  int brow = -1, bdir = -1;
  uint32_t tests = 0, entered = 0, hits = 0;
  for (int c = 0; c < nchunks; ++c) {
    // M is a multiple of 1024 and a block 128 rays: every warp is full
    if (!__any_sync(FULL, slab_cap(cbb, nchunks, c, ro, rcp, bd))) continue;
    ++entered;
    fold_prims<SHAPE>(inv, trf, pid, ppad, c * CHUNK, (c + 1) * CHUNK, ro, rd, bd, brow, ba, bdir,
                      tests, hits);
  }
  dist_out[ray] = bd;
  row_out[ray] = bd < FMAX ? brow : -1;
  a_out[ray] = ba;
  dir_out[ray] = bdir;
  if (!counts) return;
  add_warp_sum(counts, tests);
  add_warp_sum(counts + 2, hits);
  add_warp_sum(counts + 3, static_cast<uint32_t>(nchunks));
  if (threadIdx.x % 32 == 0) atomicAdd(counts + 1, static_cast<unsigned long long>(entered));
}

// ---------------------------------------------------------------------------
// K4a: every 128-triangle chunk of one instance, ascending
// ---------------------------------------------------------------------------

// corners of triangle t of the staged chunk
__device__ __forceinline__ void corners(const float (&s)[9][CHUNK], int t, V3& A, V3& B, V3& C) {
  A = {s[0][t], s[1][t], s[2][t]};
  B = {s[3][t], s[4][t], s[5][t]};
  C = {s[6][t], s[7][t], s[8][t]};
}

// stage chunk c of the [9, ppad] corner rows, one column per thread
__device__ __forceinline__ void stage_chunk(float (&s)[9][CHUNK], const float* tri, int ppad,
                                            int c) {
#pragma unroll
  for (int r = 0; r < 9; ++r) s[r][threadIdx.x] = __ldg(tri + r * ppad + c * CHUNK + threadIdx.x);
}

// fold the staged chunk c into (abest, best) under the strictly-closer rule,
// counting the triangles hit
__device__ __forceinline__ void fold_chunk(const float (&s)[9][CHUNK], int c, V3 oi, V3 di,
                                           float& abest, int& best, uint32_t& hits) {
  for (int t = 0; t < CHUNK; ++t) {
    V3 A, B, C;
    corners(s, t, A, B, C);
    float a;
    if (!mt_hit(A, B, C, oi, di, a)) continue;
    ++hits;
    if (a < abest) {
      abest = a;
      best = c * CHUNK + t;
    }
  }
}

// a triangle staged for K4a: its corner A and its edges e1 = B - A and
// e2 = C - A (mt_hit's own subtractions, done once a chunk instead of once a
// test), a float4 each, so that a thread reads it as three 16-byte
// broadcasts
struct StagedTri {
  float4 a, e1, e2;
};

// triangle column t of the [9, ppad] corner rows, into registers
__device__ __forceinline__ void load_tri(const float* tri, int ppad, int t, float (&v)[9]) {
#pragma unroll
  for (int r = 0; r < 9; ++r) v[r] = __ldg(tri + r * ppad + t);
}

// the loaded triangle into slot s; the chunk's end counts the triangles up
// to the last one with a nonzero corner (the zero padding of pad_tris
// behind it is degenerate and never hits)
__device__ __forceinline__ void stage_tri(StagedTri& s, int* ends, const float (&v)[9]) {
  s.a = make_float4(v[0], v[1], v[2], 0.0f);
  s.e1 = make_float4(v[3] - v[0], v[4] - v[1], v[5] - v[2], 0.0f);
  s.e2 = make_float4(v[6] - v[0], v[7] - v[1], v[8] - v[2], 0.0f);
  bool real = false;
#pragma unroll
  for (int r = 0; r < 9; ++r) real = real || (v[r] != 0.0f);
  put_end(ends, real);
}

// the staged triangles [0, end) of chunk c folded, ascending, into the ray's
// best: mt_hit's expressions, in its order. The determinant, 1 / det and u
// run for every triangle (1 / det given 1 where |det| < EPS, which rejects
// the test: no slow path on a degenerate triangle); q, v and a only when
// some ray of the warp has |det| >= EPS and u in [0, 1], since every other
// test is rejected whatever they are.
__device__ __forceinline__ void tri_fold(const StagedTri* s, int end, int c, V3 oi, V3 di,
                                         float& abest, int& best, uint32_t& hits) {
  for (int t = 0; t < end; ++t) {
    const float4 A = s[t].a, e1 = s[t].e1, e2 = s[t].e2;
    const float hx = di.y * e2.z - di.z * e2.y;
    const float hy = di.z * e2.x - di.x * e2.z;
    const float hz = di.x * e2.y - di.y * e2.x;
    const float det = e1.x * hx + e1.y * hy + e1.z * hz;
    const bool ok = fabsf(det) >= EPS;
    const float invd = 1.0f / (ok ? det : 1.0f);
    const V3 sv = {oi.x - A.x, oi.y - A.y, oi.z - A.z};
    const float u = (sv.x * hx + sv.y * hy + sv.z * hz) * invd;
    const bool pass = ok && (u >= 0.0f) && (u <= 1.0f);
    if (!__any_sync(FULL, pass)) continue;
    const float qx = sv.y * e1.z - sv.z * e1.y;
    const float qy = sv.z * e1.x - sv.x * e1.z;
    const float qz = sv.x * e1.y - sv.y * e1.x;
    const float v = (di.x * qx + di.y * qy + di.z * qz) * invd;
    const float a = (e2.x * qx + e2.y * qy + e2.z * qz) * invd;
    if (pass && (v >= 0.0f) && (u + v <= 1.0f) && (a > EPS)) {
      ++hits;
      if (a < abest) {
        abest = a;
        best = c * CHUNK + t;
      }
    }
  }
}

__global__ void __launch_bounds__(CHUNK)
    tri_kernel(const float* __restrict__ o, const float* __restrict__ d, int M,
               const float* __restrict__ tri, int ppad, float* a_out, int* row_out,
               unsigned long long* counts) {
  __shared__ StagedTri s[2][CHUNK];
  __shared__ int ends[2][CHUNK / 32];
  const int ray = blockIdx.x * CHUNK + threadIdx.x;
  const V3 oi = ray_at(o, M, ray);
  const V3 di = ray_at(d, M, ray);
  float abest = FMAX;
  int best = -1;
  const int nchunks = ppad / CHUNK;
  uint32_t tests = 0, hits = 0;
  // chunk c + 1 is loaded into registers while chunk c is folded, and
  // staged into the other buffer after it: one barrier a chunk
  float v[9];
  load_tri(tri, ppad, threadIdx.x, v);
  stage_tri(s[0][threadIdx.x], ends[0], v);
  for (int c = 0; c < nchunks; ++c) {
    __syncthreads();  // chunk c staged; every thread done with chunk c - 1
    const int b = c & 1;
    const int end = chunk_end(ends[b]);
    const bool next = c + 1 < nchunks;
    if (next) load_tri(tri, ppad, (c + 1) * CHUNK + threadIdx.x, v);
    tests += end;
    tri_fold(s[b], end, c, oi, di, abest, best, hits);
    if (next) stage_tri(s[b ^ 1][threadIdx.x], ends[b ^ 1], v);
  }
  a_out[ray] = abest;
  row_out[ray] = abest < FMAX ? best : -1;
  add_counts(counts, tests, nchunks, hits);
}

// ---------------------------------------------------------------------------
// K4b: K4a behind two levels of box tests, a block entering a super or a
// leaf only if one of its rays enters the box no farther than its best a
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(CHUNK)
    tri_culled_kernel(const float* __restrict__ o, const float* __restrict__ d, int M,
                      const float* __restrict__ tri, int ppad, const float* __restrict__ cbb,
                      const float* __restrict__ sbb, int nsuper, float* a_out, int* row_out,
                      unsigned long long* counts) {
  __shared__ float s[9][CHUNK];
  const int ray = blockIdx.x * CHUNK + threadIdx.x;
  const V3 oi = ray_at(o, M, ray);
  const V3 di = ray_at(d, M, ray);
  const V3 rcp = {safe_rcp(di.x), safe_rcp(di.y), safe_rcp(di.z)};
  const int nreal = ppad / CHUNK, nleaf = nsuper * TRI_SUPER;
  float abest = FMAX;
  int best = -1;
  uint32_t boxes = 0, supers = 0, visits = 0, hits = 0;
  for (int sc = 0; sc < nsuper; ++sc) {
    ++boxes;
    if (!__syncthreads_or(slab_cap(sbb, nsuper, sc, oi, rcp, abest))) continue;
    ++supers;
    for (int j = 0; j < TRI_SUPER; ++j) {
      const int c = sc * TRI_SUPER + j;
      if (c >= nreal) break;  // padding leaves: empty boxes, no triangles
      ++boxes;
      // the barrier also ends every thread's use of the previous chunk
      if (!__syncthreads_or(slab_cap(cbb, nleaf, c, oi, rcp, abest))) continue;
      stage_chunk(s, tri, ppad, c);
      __syncthreads();
      ++visits;
      fold_chunk(s, c, oi, di, abest, best, hits);
    }
  }
  a_out[ray] = abest;
  row_out[ray] = abest < FMAX ? best : -1;
  if (!counts) return;
  add_counts(counts, visits * CHUNK, visits, hits);
  add_warp_sum(counts + 3, boxes);
  if (threadIdx.x == 0) atomicAdd(counts + 4, static_cast<unsigned long long>(supers));
}

// ---------------------------------------------------------------------------
// K5: each warp walks its 1024-ray tile's ranked 8-prim blocks on its own
// ---------------------------------------------------------------------------

// the ray's test of prim j of a block whose [25, 8] table is at t (device
// memory read as warp-wide broadcasts), folded into (bd, brow, ba, bdir)
// under the strictly-closer rule
template <int SHAPE>
__device__ __forceinline__ void an_prim(const float* t, int b, int j, V3 ro, V3 rd, float& bd,
                                        int& brow, float& ba, int& bdir, uint32_t& tests,
                                        uint32_t& hits) {
  if (!(__ldg(t + 24 * SUPB + j) > 0.0f)) return;  // the ok flag gates the take
  ++tests;
  float iv[12], tf[12];
#pragma unroll
  for (int r = 0; r < 12; ++r) iv[r] = __ldg(t + r * SUPB + j);
#pragma unroll
  for (int r = 0; r < 12; ++r) tf[r] = __ldg(t + (12 + r) * SUPB + j);
  float dist, a;
  int code;
  if (!prim_hit<SHAPE>(iv, tf, ro, rd, dist, a, code)) return;
  ++hits;
  if (dist < bd) {
    bd = dist;
    brow = b * SUPB + j;
    ba = a;
    bdir = code;
  }
}

template <int SHAPE>
__global__ void __launch_bounds__(AN_BLOCK)
    an_walk(const float* __restrict__ o, const float* __restrict__ d, int M,
            const float* __restrict__ tab, const float* __restrict__ sbb, int nblk,
            const int* __restrict__ order, const float* __restrict__ tlo, int S,
            const float* __restrict__ bound, float* dist_out, int* row_out, float* a_out,
            int* dir_out, unsigned long long* counts) {
  constexpr int TAB = TAB_ROWS * SUPB;  // 200 floats per block
  const int tile = blockIdx.x / (AN_TILE / AN_BLOCK);
  const int ray = blockIdx.x * AN_BLOCK + threadIdx.x;
  const int lane = threadIdx.x % 32;
  const V3 ro = ray_at(o, M, ray);
  const V3 rd = ray_at(d, M, ray);
  const V3 rcp = {safe_rcp(rd.x), safe_rcp(rd.y), safe_rcp(rd.z)};
  const float bnd = bound[ray];
  const int* ord = order + static_cast<size_t>(tile) * S;
  const float* ent = tlo + static_cast<size_t>(tile) * S;
  float bd = FMAX, ba = 0.0f;
  int brow = -1, bdir = -1;
  uint32_t tests = 0, visits = 0, hits = 0;
  for (int k = 0; k < S; ++k) {
    const float e = __ldg(ent + k);  // the same for every thread
    if (!(e < INF)) break;           // unreachable blocks sort last
    const float cap = fminf(bd, bnd);
    // the occlusion prune over the warp's 32 rays
    if (!__any_sync(FULL, e < cap)) break;
    const int b = __ldg(ord + k);
    // the block's box, per ray, within min(best, bound); the warp skips
    // the block when none of its rays enters it
    const bool enter = slab_cap(sbb, nblk, b, ro, rcp, cap);
    if (!__any_sync(FULL, enter)) continue;
    ++visits;
    if (!enter) continue;
    const float* t = tab + static_cast<size_t>(b) * TAB;
#pragma unroll
    for (int j = 0; j < SUPB; ++j)
      an_prim<SHAPE>(t, b, j, ro, rd, bd, brow, ba, bdir, tests, hits);
  }
  dist_out[ray] = bd;
  row_out[ray] = brow;
  a_out[ray] = ba;
  dir_out[ray] = bdir;
  if (!counts) return;
  add_warp_sum(counts, tests);
  add_warp_sum(counts + 2, hits);
  if (lane == 0) atomicAdd(counts + 1, static_cast<unsigned long long>(visits));
}

// ---------------------------------------------------------------------------
// K6: a 128-ray tile walks its ranked 128-triangle chunks
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(MESH_TILE)
    mesh_walk(const float* __restrict__ o, const float* __restrict__ d, int M,
              const float* __restrict__ tri, int ppad, const int* __restrict__ order,
              const float* __restrict__ tlo, int S, const float* __restrict__ bound,
              float* a_out, int* row_out, unsigned long long* counts) {
  __shared__ float s[9][CHUNK];
  const int tile = blockIdx.x;
  const int ray = tile * MESH_TILE + threadIdx.x;
  const V3 oi = ray_at(o, M, ray);
  const V3 di = ray_at(d, M, ray);
  const float bnd = bound[ray];
  const int* ord = order + static_cast<size_t>(tile) * S;
  const float* ent = tlo + static_cast<size_t>(tile) * S;
  float abest = FMAX;
  int best = -1;
  uint32_t visits = 0, hits = 0;
  for (int k = 0; k < S; ++k) {
    const float e = __ldg(ent + k);  // the same for every thread
    if (!(e < INF)) break;           // unreachable chunks sort last
    // the occlusion prune; the barrier also ends every thread's use of the
    // previous chunk before it is overwritten
    if (!__syncthreads_or(e < fminf(abest, bnd))) break;
    const int c = __ldg(ord + k);
    stage_chunk(s, tri, ppad, c);
    __syncthreads();
    ++visits;
    fold_chunk(s, c, oi, di, abest, best, hits);
  }
  a_out[ray] = abest;
  row_out[ray] = best;
  add_counts(counts, visits * CHUNK, visits, hits);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <template <int> class Launch, class... Args>
int by_shape(int shape, Args... args) {
  switch (shape) {
    case SPHERE:
      Launch<SPHERE>::run(args...);
      break;
    case CUBE:
      Launch<CUBE>::run(args...);
      break;
    case CYLINDER:
      Launch<CYLINDER>::run(args...);
      break;
    case CONE:
      Launch<CONE>::run(args...);
      break;
    case QUAD:
      Launch<QUAD>::run(args...);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int SHAPE>
struct GroupLaunch {
  static void run(const float* o, const float* d, int M, const float* inv, const float* trf,
                  const int* pid, int ppad, float* dist, int* row, float* a, int* dir,
                  unsigned long long* counts, cudaStream_t stream) {
    group_kernel<SHAPE><<<M / CHUNK, CHUNK, 0, stream>>>(o, d, M, inv, trf, pid, ppad, dist, row,
                                                         a, dir, counts);
  }
};

template <int SHAPE>
struct GroupCulledLaunch {
  static void run(const float* o, const float* d, int M, const float* inv, const float* trf,
                  const int* pid, int ppad, const float* cbb, float* dist, int* row, float* a,
                  int* dir, unsigned long long* counts, cudaStream_t stream) {
    group_culled_kernel<SHAPE><<<M / CHUNK, CHUNK, 0, stream>>>(o, d, M, inv, trf, pid, ppad, cbb,
                                                                dist, row, a, dir, counts);
  }
};

template <int SHAPE>
struct AnLaunch {
  static void run(const float* o, const float* d, int M, const float* tab, const float* sbb,
                  int nblk, const int* order, const float* tlo, int S, const float* bound,
                  float* dist, int* row, float* a, int* dir, unsigned long long* counts,
                  cudaStream_t stream) {
    an_walk<SHAPE><<<M / AN_BLOCK, AN_BLOCK, 0, stream>>>(o, d, M, tab, sbb, nblk, order, tlo, S,
                                                          bound, dist, row, a, dir, counts);
  }
};

bool bad_rays(int M, int tile) { return M <= 0 || M % tile != 0; }

template <int SHAPE>
struct GroupKernel {
  static const void* get() { return reinterpret_cast<const void*>(group_kernel<SHAPE>); }
};

}  // namespace

// K3a. o, d: [3, M] f32 (M a multiple of 1024); inv, trf: [12, ppad] f32;
// pid: [ppad] i32 (ppad a multiple of 128); outputs [M].
extern "C" int group_best(const void* o, const void* d, int M, const void* inv, const void* trf,
                          const void* pid, int ppad, int shape, void* dist, void* row, void* a,
                          void* dir, void* counts, void* stream) {
  if (bad_rays(M, AN_TILE) || ppad <= 0 || ppad % CHUNK) return cudaErrorInvalidValue;
  return by_shape<GroupLaunch>(
      shape, static_cast<const float*>(o), static_cast<const float*>(d), M,
      static_cast<const float*>(inv), static_cast<const float*>(trf), static_cast<const int*>(pid),
      ppad, static_cast<float*>(dist), static_cast<int*>(row), static_cast<float*>(a),
      static_cast<int*>(dir), static_cast<unsigned long long*>(counts),
      static_cast<cudaStream_t>(stream));
}

// K3b. As K3a, plus cbb: [6, ppad / 128] f32 chunk boxes.
extern "C" int group_best_culled(const void* o, const void* d, int M, const void* inv,
                                 const void* trf, const void* pid, int ppad, const void* cbb,
                                 int shape, void* dist, void* row, void* a, void* dir,
                                 void* counts, void* stream) {
  if (bad_rays(M, AN_TILE) || ppad <= 0 || ppad % CHUNK) return cudaErrorInvalidValue;
  return by_shape<GroupCulledLaunch>(
      shape, static_cast<const float*>(o), static_cast<const float*>(d), M,
      static_cast<const float*>(inv), static_cast<const float*>(trf), static_cast<const int*>(pid),
      ppad, static_cast<const float*>(cbb), static_cast<float*>(dist), static_cast<int*>(row),
      static_cast<float*>(a), static_cast<int*>(dir), static_cast<unsigned long long*>(counts),
      static_cast<cudaStream_t>(stream));
}

// K4a. o, d: [3, M] f32 (M a multiple of 1024); tri: [9, ppad] f32 (ppad a
// multiple of 128); outputs [M].
extern "C" int mesh_best(const void* o, const void* d, int M, const void* tri, int ppad, void* a,
                         void* row, void* counts, void* stream) {
  if (bad_rays(M, AN_TILE) || ppad <= 0 || ppad % CHUNK) return cudaErrorInvalidValue;
  tri_kernel<<<M / CHUNK, CHUNK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<const float*>(d), M,
      static_cast<const float*>(tri), ppad, static_cast<float*>(a), static_cast<int*>(row),
      static_cast<unsigned long long*>(counts));
  return static_cast<int>(cudaGetLastError());
}

// K4b. As K4a, plus cbb: [6, 16 * nsuper] f32 leaf boxes (ppad / 128 of
// them real) and sbb: [6, nsuper] f32 super boxes.
extern "C" int mesh_best_culled(const void* o, const void* d, int M, const void* tri, int ppad,
                                const void* cbb, const void* sbb, int nsuper, void* a, void* row,
                                void* counts, void* stream) {
  if (bad_rays(M, AN_TILE) || ppad <= 0 || ppad % CHUNK || nsuper <= 0 ||
      ppad / CHUNK > nsuper * TRI_SUPER)
    return cudaErrorInvalidValue;
  tri_culled_kernel<<<M / CHUNK, CHUNK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<const float*>(d), M,
      static_cast<const float*>(tri), ppad, static_cast<const float*>(cbb),
      static_cast<const float*>(sbb), nsuper, static_cast<float*>(a), static_cast<int*>(row),
      static_cast<unsigned long long*>(counts));
  return static_cast<int>(cudaGetLastError());
}

// K5. o, d: [3, M] f32 (M a multiple of 1024); tab: [nblk, 25, 8] f32;
// sbb: [6, nblk] f32 block boxes; order: [M/1024, S] i32 block ids; tlo:
// [M/1024, S] f32 ascending per row; bound: [M] f32; outputs [M].
extern "C" int an_fold(const void* o, const void* d, int M, const void* tab, const void* sbb,
                       int nblk, const void* order, const void* tlo, int S, const void* bound,
                       int shape, void* dist, void* row, void* a, void* dir, void* counts,
                       void* stream) {
  if (bad_rays(M, AN_TILE) || nblk <= 0 || S <= 0) return cudaErrorInvalidValue;
  return by_shape<AnLaunch>(
      shape, static_cast<const float*>(o), static_cast<const float*>(d), M,
      static_cast<const float*>(tab), static_cast<const float*>(sbb), nblk,
      static_cast<const int*>(order),
      static_cast<const float*>(tlo), S, static_cast<const float*>(bound),
      static_cast<float*>(dist), static_cast<int*>(row), static_cast<float*>(a),
      static_cast<int*>(dir), static_cast<unsigned long long*>(counts),
      static_cast<cudaStream_t>(stream));
}

// K6. o, d: [3, M] f32 (M a multiple of 128); tri: [9, ppad] f32; order:
// [M/128, S] i32 chunk ids; tlo: [M/128, S] f32 ascending per row; bound: [M]
// f32; outputs [M].
extern "C" int mesh_fold(const void* o, const void* d, int M, const void* tri, int ppad,
                         const void* order, const void* tlo, int S, const void* bound, void* a,
                         void* row, void* counts, void* stream) {
  if (bad_rays(M, MESH_TILE) || ppad <= 0 || ppad % CHUNK || S <= 0) return cudaErrorInvalidValue;
  mesh_walk<<<M / MESH_TILE, MESH_TILE, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<const float*>(d), M,
      static_cast<const float*>(tri), ppad, static_cast<const int*>(order),
      static_cast<const float*>(tlo), S, static_cast<const float*>(bound), static_cast<float*>(a),
      static_cast<int*>(row), static_cast<unsigned long long*>(counts));
  return static_cast<int>(cudaGetLastError());
}

// The compiled K3a (kernel 0, of a shape code) or K4a (kernel 1): out =
// {registers a thread, local memory bytes a thread (spills), static shared
// memory bytes a block, resident blocks per SM, threads a block}.
extern "C" int brute_kernel_info(int kernel, int shape, int* out) {
  const void* fn = nullptr;
  if (kernel == 1) {
    fn = reinterpret_cast<const void*>(tri_kernel);
  } else if (kernel == 0) {
    switch (shape) {
      case SPHERE: fn = GroupKernel<SPHERE>::get(); break;
      case CUBE: fn = GroupKernel<CUBE>::get(); break;
      case CYLINDER: fn = GroupKernel<CYLINDER>::get(); break;
      case CONE: fn = GroupKernel<CONE>::get(); break;
      case QUAD: fn = GroupKernel<QUAD>::get(); break;
      default: return cudaErrorInvalidValue;
    }
  } else {
    return cudaErrorInvalidValue;
  }
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, CHUNK, 0);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(attr.sharedSizeBytes);
  out[3] = blocks;
  out[4] = CHUNK;
  return cudaSuccess;
}

extern "C" const char* trace_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
