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
//     K3a behind a slab test of each 128-prim chunk's world box (and of
//     supers of 16 chunks).
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
// Design. One thread per ray in K3a, K4a and K5, L lanes per ray in K3b,
// K4b and K6; a ray's best hit in registers. Folds run in ascending prim
// or triangle order with a strict `<`: the TPU kernels' first minimum
// inside a chunk followed by a strictly-closer merge across chunks
// (pallas_trace.py:204-224) is exactly that scan, so the winners, ties
// included, are the TPU kernels', and every output equals the plain
// versions' bit for bit. With L lanes a ray, lane j folds items j, j + L,
// ... of a chunk so, and the lanes reduce (distance or a, row) to its
// lexicographic minimum, the lowest row on an equal key (lane_min): the
// first minimum of the chunk's ascending scan, merged strictly closer.
// Padding prims (scene id < 0 in K3a and K3b, ok flag 0 in K5) never win;
// padding triangles are degenerate. K5 reads an 8-prim block's [25, 8]
// table (inverse rows, forward rows, ok flag) as warp-wide broadcasts (see
// "The walks").
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
// The culled folds (K3b, K4b). Before a chunk, rays test the chunk's box
// against their running best (the reference's slab test, with
// ops/vec.safe_rcp's reciprocals: a zero component gives a huge finite
// value, never inf * 0). The TPU skipped a chunk when no ray of its
// 1024-ray tile passed. Where every hit lies in front of the ray's origin
// (t > EPS: spheres, cubes, cylinders, triangles) the cull is
// conservative: a hit inside a box lies no nearer than the ray's entry
// into it, so any subset of a tile's rays, down to one, may skip a chunk
// that none of its rays enters, and the winners stay the brute fold's.
// Cones and quads take hits behind the origin (their tests have no t > EPS
// check), which a skipped chunk may hold, so their winners depend on which
// rays decide together: K3b decides for them per 1024-ray tile, as the
// plain version and the TPU kernel do (group_tile_kernel: K3a's staged
// fold behind a gate of the whole block, a tile a block, a ray a thread).
//
// K3b on the other shapes (group_culled_kernel) gated per warp of 32 rays,
// one thread a ray reading each prim's 24 table values as serial
// broadcasts, so a warp folded every chunk any of its rays entered: on
// scene_stress(200_000)'s 1,172 chunks a warp entered up to 95 while the
// mean was 3 (chip_smoke.py phase 11 replays the walks), and those warps
// set the launch's time. It now gives each ray 16 lanes and gates each ray
// on its own best. Lane j tests box g + j of 16 at once (a super box, then
// in each super the ray enters its 16 chunk boxes); the ray walks the
// boxes it entered ascending, each gate re-read against the best the walk
// has reached; in an entered chunk lane j folds prims j, j + 16, ... with
// K3a's masked shape tests, so that the 16 lanes read 16 neighbouring
// columns of each [12, ppad] row together. The ray groups of a warp walk
// their own chunks at once. A super is the exact union of 16 chunk boxes,
// built on the card at each launch (super_of_chunks); it cuts the box
// tests, 131,072 rays x 1,172 boxes a launch there, about elevenfold. A
// lane whose ray walks nothing at a step, and a prim with scene id < 0,
// test an identity frame and drop the result: no lane of the warp takes an
// IEEE slow path on a NaN or a zero.
//
// K4b, one thread a ray, gated its 128-ray blocks (__syncthreads_or) on
// every super and leaf, staged each entered chunk as [9][128] scalars and
// tested all 128 triangles of it with mt_hit, without K4a's staged edges
// or its reject on u. It is built from K3b's and K4a's parts now: L =
// TRI_LANES lanes a ray, each ray gated on its own best a (exact: a
// triangle's hits lie in front of the origin) through the supers, L tested
// at once, and the leaves of each super it enters, L at a time, walked
// ascending; in an entered leaf lane j folds triangles j, j + L, ... with
// K4a's test and warp-wide reject on u, and the lanes reduce (a, index)
// (lane_min). The triangles are staged once a launch, as K4a stages them
// (the corner and the edges, StagedTri), into a scratch buffer in device
// memory (stage_tri_records), from which the lanes of a ray read 48-byte
// neighbouring records. Its padding leaves (past the last real chunk,
// empty boxes) are skipped and never read; the reference clamped their
// data index to the last real chunk instead (pallas_trace.py:580-590).
//
// The walks (K5, K6). A tile's ranked list (order[t], tlo[t], ascending
// entry bound) is walked front to back in one launch; before each block or
// chunk the walking rays ask whether any of them still has tlo < min(best,
// bound), the prune of sparse_trace.py:401-403, and end the walk at the
// first that none has. The TPU took the prune over the whole tile, and the
// prune is sound over any subset of a tile's rays, down to one: tlo
// lower-bounds every ray of the tile's entry into the box (the bundle
// holds them all), a hit inside a box lies no nearer than the ray's entry
// into it, and bound caps every hit inside the root box, so a block
// skipped for ray r holds no hit strictly closer than r's best. The list
// is sorted and best only shrinks, so nothing later passes the prune
// either. Winners equal the brute fold's; on an exact distance tie between
// two blocks the ranked order decides, as it does on the TPU.
// - K5 (spheres, cubes, cylinders: an_walk): each warp walks its 1024-ray
//   tile's list on its own, with no block barrier: it takes the prune over
//   its own 32 rays (__any_sync), then tests the block's box (sup_bb) per
//   ray within min(best, bound), K3b's slab test, and skips the block when
//   none of its rays enters it (a lane that does not enter idles while the
//   others test). That per-ray gate rests on hits lying in front of the
//   origin. Cones and quads take hits behind it, and there the per-ray
//   gate differed from the plain version (chip_smoke.py phase 7 prints by
//   how many rows), so for them a block is a tile (an_tile_walk): the
//   prune over its 1024 rays (__syncthreads_or), and every ray of the tile
//   tests every block the prune admits, as the plain version, which keeps
//   the tile-wide prune alone, and the TPU kernel do. K5 reads each prim's 25
//   rows with __ldg, the same address for the warp's 32 lanes: one
//   broadcast from L1 each, issued together for the block's 8 prims, so no
//   step waits on a staging barrier. Staging each block's table per warp in
//   shared memory, with the next ranked block's loads in flight, measured
//   slower on an H100 (PERF.md). "Blocks visited" (counter [1]) counts,
//   per warp, the blocks it entered.
// - K6 walked a 128-ray tile a block, one thread a ray folding all 128
//   triangles of a chunk, so the launch waited on its few tiles that
//   walked up to the instance's whole list (mesh_demo: 18 chunks; the
//   launch times follow the longest walk, chip_smoke.py phase 9). It now
//   gives each ray 8 lanes: a block holds 16 rays of a tile, and the
//   tile's 8 blocks each walk its list with their own prune. A chunk is
//   staged as K4a stages it (the corner and the edges, with the next
//   ranked chunk loaded while this one is folded, before its prune: a load
//   the prune then drops costs bandwidth only; one barrier a chunk), and
//   lane j folds triangles j, j + 8, ... with K4a's test. The block also
//   stages the chunk's box, the union of its real triangles' corners: a
//   warp folds the chunk only when one of its 4 rays enters that box
//   within min(best, bound), less the entry bounds' margin, so that the
//   prune keeps the block walking for its other rays at the cost of
//   staging alone.
// - Lanes a ray, measured on an H100 from 4, 8 and 16 with the rest of the
//   design as above (PERF.md): K3b is fastest at 16, K6 at 8; at 16, K6's
//   blocks double, and with them the part of its floor they cost. K4b's
//   are timed by chip_smoke.py (K4B_LANES) each run.
// The TPU's repeated calls over a budgeted worklist, carrying the best in
// and out (ain/rin), are not needed: the whole list is walked in one
// launch.
//
// What bounds them on this card: FP32 operations. A ray-prim test is 47-86
// FP32 operations (the local frame 42, the shape test 5-44), and 33 more for
// the world hit point and distance where the shape test passes; a
// ray-triangle test is 51 (20 where the determinant rejects it); a slab
// test about 24. The bytes are few: rays in, winners out, chunk boxes,
// tables read from L1 and L2 (a group's [25, P] table is 52 KB at 512
// prims, a 150,016-prim group's [12, P] rows 14.4 MB; mesh_demo's largest
// instance is 83 KB of corners). What keeps them from that bound: the IEEE
// divisions' and square roots' extra instructions, no FMA (below), the
// brute kernels' tests of prims a ray can never hit, in K3b and K6 the
// lanes whose ray needs nothing at a step, and in K6 a floor of about 0.011
// ms a launch on an H100 where no block walks (the blocks' loads of their
// rays, one barrier, the stores).
//
// Work counters, when `counts` is set: [0] ray-prim or ray-triangle tests
// done, over a ray's lanes (K3a, K4a, K6 and K3b's cones and quads: every
// ray against each chunk's items up to its end, so a prim with scene id <
// 0 before a chunk's last real prim counts too; K6 only where the ray's
// warp folds the chunk; K3b's other shapes: the real prims of the chunks
// the ray walks; K4b: every triangle of the leaves the ray folds, padding
// included), [1] 128-prim chunks (K3a) or chunks (K4a, K6) that blocks
// visited, 8-prim blocks that warps entered (K5), (ray, chunk) pairs
// folded (K3b, K4b), [2] tests that hit (the shape test passed, or the
// triangle was hit); K3b and K4b add [3] ray-box tests (super and chunk or
// leaf boxes, over a ray's lanes) and K4b [4] (ray, super) pairs entered.
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
// the downward margin of the entry bounds (ops/sparse_trace.py _TLO_SCALE,
// _TLO_MARGIN), which K6 gives its per-ray chunk box test too
constexpr float TLO_SCALE = 1.0f - 1e-4f;
constexpr float TLO_MARGIN = 1e-4f;
constexpr int TRI_SUPER = 16;   // leaf chunks per K4b super
constexpr int WALK_LANES = 8;   // lanes per ray in K6
constexpr int CULL_LANES = 16;  // lanes per ray in K3b
constexpr int TRI_LANES = 16;   // lanes per ray in K4b
constexpr int GROUP_SUPER = 16; // chunks per K3b super box
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

// the bits of the thread's L-lane group (lanes L * k .. L * k + L - 1 of
// its warp) in a warp-wide ballot, lane by lane
template <int L>
__device__ __forceinline__ unsigned group_bits(unsigned ballot) {
  static_assert(L > 0 && L < 32 && 32 % L == 0, "a lane group divides a warp");
  return (ballot >> ((threadIdx.x % 32) & ~(L - 1))) & ((1u << L) - 1u);
}

// (key, row) reduced over the thread's L-lane group to its lexicographic
// minimum, the lowest row on an equal key: with each lane holding the first
// minimum of its ascending subset, that is the first minimum of the group's
// ascending scan. Every lane of the group gets it.
template <int L>
__device__ __forceinline__ void lane_min(float& key, int& row) {
#pragma unroll
  for (int off = L / 2; off > 0; off /= 2) {
    const float k2 = __shfl_xor_sync(FULL, key, off);
    const int r2 = __shfl_xor_sync(FULL, row, off);
    if (k2 < key || (k2 == key && r2 < row)) {
      key = k2;
      row = r2;
    }
  }
}

// the same, carrying the winner's local a and dircode
template <int L>
__device__ __forceinline__ void lane_min(float& key, int& row, float& a, int& code) {
#pragma unroll
  for (int off = L / 2; off > 0; off /= 2) {
    const float k2 = __shfl_xor_sync(FULL, key, off);
    const int r2 = __shfl_xor_sync(FULL, row, off);
    const float a2 = __shfl_xor_sync(FULL, a, off);
    const int c2 = __shfl_xor_sync(FULL, code, off);
    if (k2 < key || (k2 == key && r2 < row)) {
      key = k2;
      row = r2;
      a = a2;
      code = c2;
    }
  }
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

// ---------------------------------------------------------------------------
// K3a: every prim of one group, ascending
// ---------------------------------------------------------------------------

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
// K3b: K3a behind a test of each 128-prim chunk's box: per ray, L lanes a
// ray, where the shape takes only hits in front of the ray's origin; per
// 1024-ray tile, one ray a thread, where it takes hits behind it
// ---------------------------------------------------------------------------

// shapes whose tests take hits behind the ray's origin: the cone's side and
// the quad have no t > EPS check (common.cuh's slab<BEHIND>)
__host__ __device__ constexpr bool takes_behind(int shape) {
  return shape == CONE || shape == QUAD;
}

// prims c * 128 + lane, + L, + 2L, ... of the group's [12, ppad] tables
// (the L lanes of a ray read L neighbouring columns of each row), folded
// ascending into the lane's candidate (cd, crow, ca, cdir) under the
// strictly-closer rule: K3a's test and shape tests. Where the lane's ray
// walks no chunk now (on false), and for a prim with scene id < 0, the
// lane tests an identity frame and drops the result: its numbers stay
// ordinary, so that it sends no lane of the warp down an IEEE slow path.
template <int SHAPE, int L>
__device__ __forceinline__ void group_fold_lane(const float* __restrict__ inv,
                                                const float* __restrict__ trf,
                                                const int* __restrict__ pid, int ppad, int c,
                                                int lane, bool on, V3 ro, V3 rd, float& cd,
                                                int& crow, float& ca, int& cdir, uint32_t& tests,
                                                uint32_t& hits) {
  for (int i = 0; i < CHUNK / L; ++i) {
    const int p = c * CHUNK + lane + i * L;
    const bool real = on && __ldg(pid + p) >= 0;
    tests += real;
    float iv[12];
#pragma unroll
    for (int r = 0; r < 12; ++r) iv[r] = real ? ld(inv, r, ppad, p) : (r % 5 == 0 ? 1.0f : 0.0f);
    const V3 oi = affine(iv, ro);
    const V3 di = vnorm(linear(iv, rd), TINY);
    float a;
    int code;
    const bool ok = group_shape<SHAPE>(oi, di, a, code) && real;
    if (!__any_sync(FULL, ok)) continue;
    if (!ok) continue;
    float tf[12];
#pragma unroll
    for (int r = 0; r < 12; ++r) tf[r] = ld(trf, r, ppad, p);
    ++hits;
    const V3 pl = {oi.x + a * di.x, oi.y + a * di.y, oi.z + a * di.z};
    const V3 e = sub(ro, affine(tf, pl));
    const float dist = sqrtf(e.x * e.x + e.y * e.y + e.z * e.z);
    if (dist < cd) {
      cd = dist;
      crow = p;
      ca = a;
      cdir = code;
    }
  }
}

// the ray's entry into box b (min xyz, max xyz) clamped at 0, or +inf where
// it misses the box, so that te <= best is slab_cap's test against any best
// (slab_interval's arithmetic)
__device__ __forceinline__ float box_entry(const float (&b)[6], V3 o, V3 rcp) {
  const float t0x = (b[0] - o.x) * rcp.x, t1x = (b[3] - o.x) * rcp.x;
  const float t0y = (b[1] - o.y) * rcp.y, t1y = (b[4] - o.y) * rcp.y;
  const float t0z = (b[2] - o.z) * rcp.z, t1z = (b[5] - o.z) * rcp.z;
  float tmin = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  const float tmax = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
  tmin = fmaxf(tmin, 0.0f);
  return tmax >= tmin ? tmin : INFINITY;
}

// the same for box column col of [6, stride] boxes
__device__ __forceinline__ float column_entry(const float* box, int stride, int col, V3 o,
                                              V3 rcp) {
  float b[6];
#pragma unroll
  for (int r = 0; r < 6; ++r) b[r] = ld(box, r, stride, col);
  return box_entry(b, o, rcp);
}

// the ray walks the chunks c0 + j (j < L) whose entry te (lane j's) is
// within its best, ascending, each gate reading the best the walk has
// reached; every ray group of the warp walks its own chunk at each step
template <int SHAPE, int L>
__device__ __forceinline__ void walk_chunks(int c0, float te, int lane,
                                            const float* __restrict__ inv,
                                            const float* __restrict__ trf,
                                            const int* __restrict__ pid, int ppad, V3 ro, V3 rd,
                                            float& bd, int& brow, float& ba, int& bdir,
                                            uint32_t& tests, uint32_t& entered, uint32_t& hits) {
  unsigned left = (1u << L) - 1u;  // the chunks not passed yet
  for (;;) {
    const unsigned want = group_bits<L>(__ballot_sync(FULL, te <= bd)) & left;
    if (!__any_sync(FULL, want != 0)) break;
    const bool on = want != 0;
    const int j = on ? __ffs(want) - 1 : 0;
    left = on ? left & ~((2u << j) - 1u) : 0u;
    entered += on;
    float cd = FMAX, ca = 0.0f;
    int crow = -1, cdir = -1;
    group_fold_lane<SHAPE, L>(inv, trf, pid, ppad, c0 + j, lane, on, ro, rd, cd, crow, ca, cdir,
                              tests, hits);
    lane_min<L>(cd, crow, ca, cdir);
    if (cd < bd) {
      bd = cd;
      brow = crow;
      ba = ca;
      bdir = cdir;
    }
  }
}

template <int SHAPE>
__global__ void __launch_bounds__(CHUNK)
    group_culled_kernel(const float* __restrict__ o, const float* __restrict__ d, int M,
                        const float* __restrict__ inv, const float* __restrict__ trf,
                        const int* __restrict__ pid, int ppad, const float* __restrict__ cbb,
                        const float* __restrict__ sbb, int nsuper, float* dist_out, int* row_out,
                        float* a_out, int* dir_out, unsigned long long* counts) {
  static_assert(!takes_behind(SHAPE), "a hit behind the origin escapes a per-ray gate");
  constexpr int L = CULL_LANES;
  const int lane = threadIdx.x % L;
  const int ray = blockIdx.x * (CHUNK / L) + threadIdx.x / L;
  const V3 ro = ray_at(o, M, ray);
  const V3 rd = ray_at(d, M, ray);
  const V3 rcp = {safe_rcp(rd.x), safe_rcp(rd.y), safe_rcp(rd.z)};
  const int nchunks = ppad / CHUNK;
  float bd = FMAX, ba = 0.0f;
  int brow = -1, bdir = -1;
  uint32_t tests = 0, entered = 0, hits = 0, boxes = 0;
  // M is a multiple of 1024 and a block 128 threads: every warp is full
  for (int g = 0; g < nsuper; g += L) {
    float ts = INFINITY;
    if (g + lane < nsuper) {
      ++boxes;
      ts = column_entry(sbb, nsuper, g + lane, ro, rcp);
    }
    unsigned left = (1u << L) - 1u;
    for (;;) {
      const unsigned want = group_bits<L>(__ballot_sync(FULL, ts <= bd)) & left;
      if (!__any_sync(FULL, want != 0)) break;
      const bool on = want != 0;
      const int j = on ? __ffs(want) - 1 : 0;
      left = on ? left & ~((2u << j) - 1u) : 0u;
      for (int h = 0; h < GROUP_SUPER; h += L) {
        const int c0 = (g + j) * GROUP_SUPER + h;
        float te = INFINITY;
        if (on && c0 + lane < nchunks) {
          ++boxes;
          te = column_entry(cbb, nchunks, c0 + lane, ro, rcp);
        }
        walk_chunks<SHAPE, L>(c0, te, lane, inv, trf, pid, ppad, ro, rd, bd, brow, ba, bdir, tests,
                              entered, hits);
      }
    }
  }
  if (lane == 0) {
    dist_out[ray] = bd;
    row_out[ray] = bd < FMAX ? brow : -1;
    a_out[ray] = ba;
    dir_out[ray] = bdir;
  }
  if (!counts) return;
  add_warp_sum(counts, tests);
  add_warp_sum(counts + 1, lane == 0 ? entered : 0u);
  add_warp_sum(counts + 2, hits);
  add_warp_sum(counts + 3, boxes);
}

// the K3b super boxes: box s of sbb [6, nsuper] is the exact union (min of
// the minima, max of the maxima) of chunk boxes 16 s .. 16 s + 15 of cbb
// [6, nchunks]; one thread a super
__global__ void super_of_chunks(const float* __restrict__ cbb, int nchunks, float* sbb,
                                int nsuper) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= nsuper) return;
  for (int r = 0; r < 6; ++r) {
    float v = r < 3 ? INFINITY : -INFINITY;
    for (int c = s * GROUP_SUPER; c < min(nchunks, (s + 1) * GROUP_SUPER); ++c)
      v = r < 3 ? fminf(v, cbb[r * nchunks + c]) : fmaxf(v, cbb[r * nchunks + c]);
    sbb[r * nsuper + s] = v;
  }
}

// A chunk whose box a ray's segment [0, best] misses may hold a hit behind
// the ray's origin, so for cones and quads no gate finer than the plain
// version's decides as it does: one block is a 1024-ray tile, one ray a
// thread, and the block enters a chunk where some ray of the tile enters
// its box within its best, as the plain version and the TPU kernel do; an
// entered chunk is staged and folded by every ray of the tile as in K3a.
template <int SHAPE>
__global__ void __launch_bounds__(AN_TILE)
    group_tile_kernel(const float* __restrict__ o, const float* __restrict__ d, int M,
                      const float* __restrict__ inv, const float* __restrict__ trf,
                      const int* __restrict__ pid, int ppad, const float* __restrict__ cbb,
                      float* dist_out, int* row_out, float* a_out, int* dir_out,
                      unsigned long long* counts) {
  __shared__ StagedPrim s[CHUNK];
  __shared__ int ends[CHUNK / 32];
  const int ray = blockIdx.x * AN_TILE + threadIdx.x;
  const V3 ro = ray_at(o, M, ray);
  const V3 rd = ray_at(d, M, ray);
  const V3 rcp = {safe_rcp(rd.x), safe_rcp(rd.y), safe_rcp(rd.z)};
  const int nchunks = ppad / CHUNK;
  float bd = FMAX, ba = 0.0f;
  int brow = -1, bdir = -1;
  uint32_t tests = 0, entered = 0, hits = 0;
  for (int c = 0; c < nchunks; ++c) {
    // the barrier also ends every thread's use of the previous chunk
    if (!__syncthreads_or(slab_cap(cbb, nchunks, c, ro, rcp, bd))) continue;
    ++entered;
    if (threadIdx.x < CHUNK)
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
  if (!counts) return;
  add_warp_sum(counts, tests);
  add_warp_sum(counts + 1, entered);
  add_warp_sum(counts + 2, hits);
  add_warp_sum(counts + 3, static_cast<uint32_t>(nchunks));
}

// ---------------------------------------------------------------------------
// K4a: every 128-triangle chunk of one instance, ascending
// ---------------------------------------------------------------------------

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

// the staged triangles t = lane, lane + L, ... below end folded, ascending,
// into (abest, best = base + t): mt_hit's expressions, in its order. K4a
// runs it with one lane a ray (every triangle of the chunk), K6 with
// WALK_LANES. The determinant, 1 / det and u run for every triangle (1 /
// det given 1 where |det| < EPS, which rejects the test: no slow path on a
// degenerate triangle); q, v and a only when some lane of the warp has
// |det| >= EPS and u in [0, 1], since every other test is rejected
// whatever they are.
template <int L>
__device__ __forceinline__ void tri_fold(const StagedTri* s, int end, int lane, int base, V3 oi,
                                         V3 di, float& abest, int& best, uint32_t& hits) {
  const int n = (end + L - 1) / L;  // the same for every thread of the block
  for (int i = 0; i < n; ++i) {
    const int t = lane + i * L;
    const bool in = L == 1 || t < end;
    const float4 A = s[t].a, e1 = s[t].e1, e2 = s[t].e2;
    const float hx = di.y * e2.z - di.z * e2.y;
    const float hy = di.z * e2.x - di.x * e2.z;
    const float hz = di.x * e2.y - di.y * e2.x;
    const float det = e1.x * hx + e1.y * hy + e1.z * hz;
    const bool ok = fabsf(det) >= EPS;
    const float invd = 1.0f / (ok ? det : 1.0f);
    const V3 sv = {oi.x - A.x, oi.y - A.y, oi.z - A.z};
    const float u = (sv.x * hx + sv.y * hy + sv.z * hz) * invd;
    const bool pass = in && ok && (u >= 0.0f) && (u <= 1.0f);
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
        best = base + t;
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
    tri_fold<1>(s[b], end, 0, c * CHUNK, oi, di, abest, best, hits);
    if (next) stage_tri(s[b ^ 1][threadIdx.x], ends[b ^ 1], v);
  }
  a_out[ray] = abest;
  row_out[ray] = abest < FMAX ? best : -1;
  add_counts(counts, tests, nchunks, hits);
}

// ---------------------------------------------------------------------------
// K4b: K4a behind two levels of box tests, L lanes a ray, each ray gated on
// its own best a through the supers and then the leaves
// ---------------------------------------------------------------------------

// triangle t of the [9, ppad] corner rows as K4a stages it (the corner and
// the edges), into st[t]: one thread a triangle, once a launch
__global__ void stage_tri_records(const float* __restrict__ tri, int ppad, StagedTri* st) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= ppad) return;
  float v[9];
  load_tri(tri, ppad, t, v);
  st[t].a = make_float4(v[0], v[1], v[2], 0.0f);
  st[t].e1 = make_float4(v[3] - v[0], v[4] - v[1], v[5] - v[2], 0.0f);
  st[t].e2 = make_float4(v[6] - v[0], v[7] - v[1], v[8] - v[2], 0.0f);
}

// triangles lane, lane + L, ... of the staged chunk s folded, ascending,
// into the lane's candidate (ca, ct = index in the chunk): tri_fold's test
// with its warp-wide gate on u, for the rays that walk the chunk (on); a
// lane whose ray walks nothing now tests the chunk it is given and drops
// the result
template <int L>
__device__ __forceinline__ void tri_fold_lane(const StagedTri* __restrict__ s, int lane, bool on,
                                              V3 oi, V3 di, float& ca, int& ct, uint32_t& tests,
                                              uint32_t& hits) {
  for (int i = 0; i < CHUNK / L; ++i) {
    const int t = lane + i * L;
    tests += on;
    const float4 A = s[t].a, e1 = s[t].e1, e2 = s[t].e2;
    const float hx = di.y * e2.z - di.z * e2.y;
    const float hy = di.z * e2.x - di.x * e2.z;
    const float hz = di.x * e2.y - di.y * e2.x;
    const float det = e1.x * hx + e1.y * hy + e1.z * hz;
    const bool ok = fabsf(det) >= EPS;
    const float invd = 1.0f / (ok ? det : 1.0f);
    const V3 sv = {oi.x - A.x, oi.y - A.y, oi.z - A.z};
    const float u = (sv.x * hx + sv.y * hy + sv.z * hz) * invd;
    const bool pass = on && ok && (u >= 0.0f) && (u <= 1.0f);
    if (!__any_sync(FULL, pass)) continue;
    const float qx = sv.y * e1.z - sv.z * e1.y;
    const float qy = sv.z * e1.x - sv.x * e1.z;
    const float qz = sv.x * e1.y - sv.y * e1.x;
    const float v = (di.x * qx + di.y * qy + di.z * qz) * invd;
    const float a = (e2.x * qx + e2.y * qy + e2.z * qz) * invd;
    if (pass && (v >= 0.0f) && (u + v <= 1.0f) && (a > EPS)) {
      ++hits;
      if (a < ca) {
        ca = a;
        ct = t;
      }
    }
  }
}

// the ray walks the leaf chunks c0 + j (j < L) whose entry te (lane j's)
// is within its best a, ascending, each gate reading the best the walk has
// reached; every ray group of the warp walks its own chunk at each step
template <int L>
__device__ __forceinline__ void walk_tri_chunks(int c0, float te, int lane,
                                                const StagedTri* __restrict__ st, V3 oi, V3 di,
                                                float& abest, int& best, uint32_t& tests,
                                                uint32_t& entered, uint32_t& hits) {
  unsigned left = (1u << L) - 1u;  // the chunks not passed yet
  for (;;) {
    const unsigned want = group_bits<L>(__ballot_sync(FULL, te <= abest)) & left;
    if (!__any_sync(FULL, want != 0)) break;
    const bool on = want != 0;
    const int j = on ? __ffs(want) - 1 : 0;
    left = on ? left & ~((2u << j) - 1u) : 0u;
    entered += on;
    const int c = on ? c0 + j : 0;  // a ray off the walk reads chunk 0
    float ca = FMAX;
    int ct = CHUNK;
    tri_fold_lane<L>(st + c * CHUNK, lane, on, oi, di, ca, ct, tests, hits);
    lane_min<L>(ca, ct);
    if (ca < abest) {
      abest = ca;
      best = c * CHUNK + ct;
    }
  }
}

template <int L>
__global__ void __launch_bounds__(CHUNK)
    tri_culled_kernel(const float* __restrict__ o, const float* __restrict__ d, int M,
                      const StagedTri* __restrict__ st, int ppad, const float* __restrict__ cbb,
                      const float* __restrict__ sbb, int nsuper, float* a_out, int* row_out,
                      unsigned long long* counts) {
  static_assert(TRI_SUPER % L == 0, "a super's leaves are tested L at a time");
  const int lane = threadIdx.x % L;
  const int ray = blockIdx.x * (CHUNK / L) + threadIdx.x / L;
  const V3 oi = ray_at(o, M, ray);
  const V3 di = ray_at(d, M, ray);
  const V3 rcp = {safe_rcp(di.x), safe_rcp(di.y), safe_rcp(di.z)};
  const int nreal = ppad / CHUNK, nleaf = nsuper * TRI_SUPER;
  float abest = FMAX;
  int best = -1;
  uint32_t tests = 0, entered = 0, hits = 0, boxes = 0, supers = 0;
  // M is a multiple of 1024 and a block 128 threads: every warp is full
  for (int g = 0; g < nsuper; g += L) {
    float ts = INFINITY;
    if (g + lane < nsuper) {
      ++boxes;
      ts = column_entry(sbb, nsuper, g + lane, oi, rcp);
    }
    unsigned left = (1u << L) - 1u;
    for (;;) {
      const unsigned want = group_bits<L>(__ballot_sync(FULL, ts <= abest)) & left;
      if (!__any_sync(FULL, want != 0)) break;
      const bool on = want != 0;
      const int j = on ? __ffs(want) - 1 : 0;
      left = on ? left & ~((2u << j) - 1u) : 0u;
      supers += on;
      for (int h = 0; h < TRI_SUPER; h += L) {
        const int c0 = (g + j) * TRI_SUPER + h;
        // a padding leaf (past the last real chunk) is skipped and unread
        float te = INFINITY;
        if (on && c0 + lane < nreal) {
          ++boxes;
          te = column_entry(cbb, nleaf, c0 + lane, oi, rcp);
        }
        walk_tri_chunks<L>(c0, te, lane, st, oi, di, abest, best, tests, entered, hits);
      }
    }
  }
  if (lane == 0) {
    a_out[ray] = abest;
    row_out[ray] = abest < FMAX ? best : -1;
  }
  if (!counts) return;
  add_warp_sum(counts, tests);
  add_warp_sum(counts + 1, lane == 0 ? entered : 0u);
  add_warp_sum(counts + 2, hits);
  add_warp_sum(counts + 3, boxes);
  add_warp_sum(counts + 4, lane == 0 ? supers : 0u);
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

// K5 for cones and quads, whose tests take hits behind the ray's origin: a
// block skipped for one ray may hold a hit closer than its best, so no
// gate finer than the plain version's decides as it does. One block is a
// 1024-ray tile, one ray a thread; step k is taken where some ray of the
// tile has tlo[k] < min(best, bound) (__syncthreads_or: the reference's
// test against the tile's largest min(best, bound)), and then every ray
// of the tile tests the block's 8 prims, with no per-ray box test, as
// an_fold_plain does. The prims' rows are warp-wide broadcasts, as in
// an_walk; the shape tests are K3a's masked ones (the same floats).
template <int SHAPE>
__global__ void __launch_bounds__(AN_TILE)
    an_tile_walk(const float* __restrict__ o, const float* __restrict__ d, int M,
                 const float* __restrict__ tab, const int* __restrict__ order,
                 const float* __restrict__ tlo, int S, const float* __restrict__ bound,
                 float* dist_out, int* row_out, float* a_out, int* dir_out,
                 unsigned long long* counts) {
  static_assert(takes_behind(SHAPE), "the other shapes walk per warp (an_walk)");
  constexpr int TAB = TAB_ROWS * SUPB;
  const int ray = blockIdx.x * AN_TILE + threadIdx.x;
  const V3 ro = ray_at(o, M, ray);
  const V3 rd = ray_at(d, M, ray);
  const float bnd = bound[ray];
  const int* ord = order + static_cast<size_t>(blockIdx.x) * S;
  const float* ent = tlo + static_cast<size_t>(blockIdx.x) * S;
  float bd = FMAX, ba = 0.0f;
  int brow = -1, bdir = -1;
  uint32_t tests = 0, visits = 0, hits = 0;
  for (int k = 0; k < S; ++k) {
    const float e = __ldg(ent + k);  // the same for every thread
    if (!(e < INF)) break;           // unreachable blocks sort last
    if (!__syncthreads_or(e < fminf(bd, bnd))) break;
    ++visits;
    const int b = __ldg(ord + k);
    const float* t = tab + static_cast<size_t>(b) * TAB;
#pragma unroll
    for (int j = 0; j < SUPB; ++j) {
      if (!(__ldg(t + 24 * SUPB + j) > 0.0f)) continue;  // the ok flag gates the take
      ++tests;
      float iv[12];
#pragma unroll
      for (int r = 0; r < 12; ++r) iv[r] = __ldg(t + r * SUPB + j);
      const V3 oi = affine(iv, ro);
      const V3 di = vnorm(linear(iv, rd), TINY);
      float a;
      int code;
      const bool ok = group_shape<SHAPE>(oi, di, a, code);
      if (!__any_sync(FULL, ok)) continue;
      float tf[12];
#pragma unroll
      for (int r = 0; r < 12; ++r) tf[r] = __ldg(t + (12 + r) * SUPB + j);
      if (!ok) continue;
      ++hits;
      const V3 pl = {oi.x + a * di.x, oi.y + a * di.y, oi.z + a * di.z};
      const V3 e3 = sub(ro, affine(tf, pl));
      const float dist = sqrtf(e3.x * e3.x + e3.y * e3.y + e3.z * e3.z);
      if (dist < bd) {
        bd = dist;
        brow = b * SUPB + j;
        ba = a;
        bdir = code;
      }
    }
  }
  dist_out[ray] = bd;
  row_out[ray] = brow;
  a_out[ray] = ba;
  dir_out[ray] = bdir;
  if (!counts) return;
  add_warp_sum(counts, tests);
  add_warp_sum(counts + 2, hits);
  if (threadIdx.x % 32 == 0) atomicAdd(counts + 1, static_cast<unsigned long long>(visits));
}

// ---------------------------------------------------------------------------
// K6: a 128-ray tile's ranked 128-triangle chunks, walked by each of its
// WALK_LANES blocks on its own, L lanes a ray
// ---------------------------------------------------------------------------

// the staged triangle's box reduced over the warp into wb[warp] (lo xyz, hi
// xyz); a triangle of zeros (padding) adds nothing
__device__ __forceinline__ void put_box(float (*wb)[6], const float (&v)[9]) {
  bool real = false;
#pragma unroll
  for (int r = 0; r < 9; ++r) real = real || (v[r] != 0.0f);
  float b[6];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    b[k] = real ? fminf(fminf(v[k], v[3 + k]), v[6 + k]) : INFINITY;
    b[3 + k] = real ? fmaxf(fmaxf(v[k], v[3 + k]), v[6 + k]) : -INFINITY;
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      b[k] = fminf(b[k], __shfl_xor_sync(FULL, b[k], off));
      b[3 + k] = fmaxf(b[3 + k], __shfl_xor_sync(FULL, b[3 + k], off));
    }
  }
  if (threadIdx.x % 32 == 0) {
#pragma unroll
    for (int k = 0; k < 6; ++k) wb[threadIdx.x / 32][k] = b[k];
  }
}

// the ray's entry into the staged chunk's box (the union of its warps'),
// clamped at 0, +inf where it misses it
__device__ __forceinline__ float chunk_entry(const float (*wb)[6], V3 o, V3 rcp) {
  float b[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) b[k] = wb[0][k];
#pragma unroll
  for (int w = 1; w < CHUNK / 32; ++w) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      b[k] = fminf(b[k], wb[w][k]);
      b[3 + k] = fmaxf(b[3 + k], wb[w][3 + k]);
    }
  }
  return box_entry(b, o, rcp);
}

__global__ void __launch_bounds__(MESH_TILE)
    mesh_walk(const float* __restrict__ o, const float* __restrict__ d, int M,
              const float* __restrict__ tri, int ppad, const int* __restrict__ order,
              const float* __restrict__ tlo, int S, const float* __restrict__ bound,
              float* a_out, int* row_out, unsigned long long* counts) {
  constexpr int L = WALK_LANES;
  __shared__ StagedTri s[2][CHUNK];
  __shared__ int ends[2][CHUNK / 32];
  __shared__ float wbox[2][CHUNK / 32][6];  // the staged chunk's box by warp
  const int lane = threadIdx.x % L;
  const int ray = blockIdx.x * (MESH_TILE / L) + threadIdx.x / L;
  const int tile = ray / MESH_TILE;
  const V3 oi = ray_at(o, M, ray);
  const V3 di = ray_at(d, M, ray);
  const V3 rcp = {safe_rcp(di.x), safe_rcp(di.y), safe_rcp(di.z)};
  const float bnd = bound[ray];
  const int* ord = order + static_cast<size_t>(tile) * S;
  const float* ent = tlo + static_cast<size_t>(tile) * S;
  float abest = FMAX;
  int best = -1;
  uint32_t tests = 0, visits = 0, hits = 0;
  // chunk k + 1 is loaded into registers while chunk k is folded, and
  // staged into the other buffer after it: one barrier a chunk. The first
  // is loaded only where the prune lets some ray of the block in.
  float v[9];
  const float e0 = __ldg(ent);
  const int walk = __syncthreads_or(e0 < INF && e0 < fminf(abest, bnd)) ? S : 0;
  if (walk) {
    load_tri(tri, ppad, __ldg(ord) * CHUNK + threadIdx.x, v);
    stage_tri(s[0][threadIdx.x], ends[0], v);
    put_box(wbox[0], v);
  }
  for (int k = 0; k < walk; ++k) {
    const float e = __ldg(ent + k);  // the same for every thread
    if (!(e < INF)) break;           // unreachable chunks sort last
    // the occlusion prune over the block's rays (a ray's lanes hold its
    // best); the barrier also shows chunk k's staging and ends every
    // thread's use of chunk k - 1's buffer
    if (!__syncthreads_or(e < fminf(abest, bnd))) break;
    const int b = k & 1;
    const int c = __ldg(ord + k);
    // loaded before chunk k + 1's prune: a load the prune drops costs
    // bandwidth only
    const bool next = k + 1 < S && __ldg(ent + k + 1) < INF;
    if (next) load_tri(tri, ppad, __ldg(ord + k + 1) * CHUNK + threadIdx.x, v);
    const int end = chunk_end(ends[b]);
    ++visits;
    // the chunk's box per ray within min(best, bound), with the entry
    // bounds' margin; a warp folds the chunk when one of its rays enters
    const float te = chunk_entry(wbox[b], oi, rcp);
    if (__any_sync(FULL, te * TLO_SCALE - TLO_MARGIN < fminf(abest, bnd))) {
      tests += lane < end ? (end - lane + L - 1) / L : 0;
      float ca = FMAX;
      int ct = CHUNK;
      tri_fold<L>(s[b], end, lane, 0, oi, di, ca, ct, hits);
      lane_min<L>(ca, ct);
      if (ca < abest) {
        abest = ca;
        best = c * CHUNK + ct;
      }
    }
    if (next) {
      stage_tri(s[b ^ 1][threadIdx.x], ends[b ^ 1], v);
      put_box(wbox[b ^ 1], v);
    }
  }
  if (lane == 0) {
    a_out[ray] = abest;
    row_out[ray] = best;
  }
  add_counts(counts, tests, visits, hits);
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
                  const int* pid, int ppad, const float* cbb, float* sbb, int nsuper, float* dist,
                  int* row, float* a, int* dir, unsigned long long* counts, cudaStream_t stream) {
    if constexpr (takes_behind(SHAPE)) {
      group_tile_kernel<SHAPE><<<M / AN_TILE, AN_TILE, 0, stream>>>(
          o, d, M, inv, trf, pid, ppad, cbb, dist, row, a, dir, counts);
    } else {
      super_of_chunks<<<(nsuper + 127) / 128, 128, 0, stream>>>(cbb, ppad / CHUNK, sbb, nsuper);
      group_culled_kernel<SHAPE><<<M / CHUNK * CULL_LANES, CHUNK, 0, stream>>>(
          o, d, M, inv, trf, pid, ppad, cbb, sbb, nsuper, dist, row, a, dir, counts);
    }
  }
};

// K5 by shape: the per-warp walk with its per-ray box gate (an_walk) where
// every hit lies in front of the ray's origin, the tile walk
// (an_tile_walk) for cones and quads; per_ray forces an_walk on them too,
// the gate this kernel had for them before, which chip_smoke.py shows
// differing from the plain version
template <int SHAPE>
struct AnLaunch {
  static void run(const float* o, const float* d, int M, const float* tab, const float* sbb,
                  int nblk, const int* order, const float* tlo, int S, const float* bound,
                  float* dist, int* row, float* a, int* dir, unsigned long long* counts,
                  bool per_ray, cudaStream_t stream) {
    if constexpr (takes_behind(SHAPE)) {
      if (!per_ray) {
        an_tile_walk<SHAPE><<<M / AN_TILE, AN_TILE, 0, stream>>>(o, d, M, tab, order, tlo, S,
                                                                 bound, dist, row, a, dir, counts);
        return;
      }
    }
    an_walk<SHAPE><<<M / AN_BLOCK, AN_BLOCK, 0, stream>>>(o, d, M, tab, sbb, nblk, order, tlo, S,
                                                          bound, dist, row, a, dir, counts);
  }
};

bool bad_rays(int M, int tile) { return M <= 0 || M % tile != 0; }

// K3a's (culled false) or K3b's (true) kernel of a shape, and its threads
// a block and lanes a ray
template <int SHAPE>
struct GroupKernel {
  static const void* get(bool culled, int& threads, int& lanes) {
    threads = CHUNK;
    lanes = 1;
    if (!culled) return reinterpret_cast<const void*>(group_kernel<SHAPE>);
    if constexpr (takes_behind(SHAPE)) {
      threads = AN_TILE;
      return reinterpret_cast<const void*>(group_tile_kernel<SHAPE>);
    } else {
      lanes = CULL_LANES;
      return reinterpret_cast<const void*>(group_culled_kernel<SHAPE>);
    }
  }
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

// K3b. As K3a, plus cbb: [6, ppad / 128] f32 chunk boxes, and sbb: [6,
// nsuper] f32 scratch for the super boxes, nsuper = ceil(ppad / 128 / 16).
extern "C" int group_best_culled(const void* o, const void* d, int M, const void* inv,
                                 const void* trf, const void* pid, int ppad, const void* cbb,
                                 void* sbb, int nsuper, int shape, void* dist, void* row, void* a,
                                 void* dir, void* counts, void* stream) {
  if (bad_rays(M, AN_TILE) || ppad <= 0 || ppad % CHUNK ||
      nsuper * GROUP_SUPER < ppad / CHUNK || (nsuper - 1) * GROUP_SUPER >= ppad / CHUNK)
    return cudaErrorInvalidValue;
  return by_shape<GroupCulledLaunch>(
      shape, static_cast<const float*>(o), static_cast<const float*>(d), M,
      static_cast<const float*>(inv), static_cast<const float*>(trf), static_cast<const int*>(pid),
      ppad, static_cast<const float*>(cbb), static_cast<float*>(sbb), nsuper,
      static_cast<float*>(dist), static_cast<int*>(row),
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
// them real), sbb: [6, nsuper] f32 super boxes, st: [ppad, 12] f32 scratch
// for the staged triangles, and lanes a ray (4, 8 or 16; 0: TRI_LANES).
extern "C" int mesh_best_culled(const void* o, const void* d, int M, const void* tri, int ppad,
                                const void* cbb, const void* sbb, int nsuper, void* st, int lanes,
                                void* a, void* row, void* counts, void* stream) {
  if (bad_rays(M, AN_TILE) || ppad <= 0 || ppad % CHUNK || nsuper <= 0 ||
      ppad / CHUNK > nsuper * TRI_SUPER)
    return cudaErrorInvalidValue;
  if (lanes == 0) lanes = TRI_LANES;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  StagedTri* rec = static_cast<StagedTri*>(st);
  stage_tri_records<<<ppad / CHUNK, CHUNK, 0, s>>>(static_cast<const float*>(tri), ppad, rec);
  const float* fo = static_cast<const float*>(o);
  const float* fd = static_cast<const float*>(d);
  const float* fc = static_cast<const float*>(cbb);
  const float* fs = static_cast<const float*>(sbb);
  float* fa = static_cast<float*>(a);
  int* ir = static_cast<int*>(row);
  unsigned long long* cnt = static_cast<unsigned long long*>(counts);
  switch (lanes) {
    case 4:
      tri_culled_kernel<4><<<M / CHUNK * 4, CHUNK, 0, s>>>(fo, fd, M, rec, ppad, fc, fs, nsuper,
                                                           fa, ir, cnt);
      break;
    case 8:
      tri_culled_kernel<8><<<M / CHUNK * 8, CHUNK, 0, s>>>(fo, fd, M, rec, ppad, fc, fs, nsuper,
                                                           fa, ir, cnt);
      break;
    case 16:
      tri_culled_kernel<16><<<M / CHUNK * 16, CHUNK, 0, s>>>(fo, fd, M, rec, ppad, fc, fs,
                                                             nsuper, fa, ir, cnt);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

// K5. o, d: [3, M] f32 (M a multiple of 1024); tab: [nblk, 25, 8] f32;
// sbb: [6, nblk] f32 block boxes; order: [M/1024, S] i32 block ids; tlo:
// [M/1024, S] f32 ascending per row; bound: [M] f32; outputs [M]; per_ray
// nonzero: the per-ray gate for cones and quads too (AnLaunch).
extern "C" int an_fold(const void* o, const void* d, int M, const void* tab, const void* sbb,
                       int nblk, const void* order, const void* tlo, int S, const void* bound,
                       int shape, void* dist, void* row, void* a, void* dir, void* counts,
                       int per_ray, void* stream) {
  if (bad_rays(M, AN_TILE) || nblk <= 0 || S <= 0) return cudaErrorInvalidValue;
  return by_shape<AnLaunch>(
      shape, static_cast<const float*>(o), static_cast<const float*>(d), M,
      static_cast<const float*>(tab), static_cast<const float*>(sbb), nblk,
      static_cast<const int*>(order),
      static_cast<const float*>(tlo), S, static_cast<const float*>(bound),
      static_cast<float*>(dist), static_cast<int*>(row), static_cast<float*>(a),
      static_cast<int*>(dir), static_cast<unsigned long long*>(counts), per_ray != 0,
      static_cast<cudaStream_t>(stream));
}

// K6. o, d: [3, M] f32 (M a multiple of 128); tri: [9, ppad] f32; order:
// [M/128, S] i32 chunk ids; tlo: [M/128, S] f32 ascending per row; bound: [M]
// f32; outputs [M].
extern "C" int mesh_fold(const void* o, const void* d, int M, const void* tri, int ppad,
                         const void* order, const void* tlo, int S, const void* bound, void* a,
                         void* row, void* counts, void* stream) {
  if (bad_rays(M, MESH_TILE) || ppad <= 0 || ppad % CHUNK || S <= 0) return cudaErrorInvalidValue;
  mesh_walk<<<M / MESH_TILE * WALK_LANES, MESH_TILE, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<const float*>(d), M,
      static_cast<const float*>(tri), ppad, static_cast<const int*>(order),
      static_cast<const float*>(tlo), S, static_cast<const float*>(bound), static_cast<float*>(a),
      static_cast<int*>(row), static_cast<unsigned long long*>(counts));
  return static_cast<int>(cudaGetLastError());
}

// K5's kernel of a shape, and its threads a block
template <int SHAPE>
struct AnKernel {
  static const void* get(int& threads) {
    if constexpr (takes_behind(SHAPE)) {
      threads = AN_TILE;
      return reinterpret_cast<const void*>(an_tile_walk<SHAPE>);
    } else {
      threads = AN_BLOCK;
      return reinterpret_cast<const void*>(an_walk<SHAPE>);
    }
  }
};

// A compiled trace kernel: K3a (kernel 0), K3b (2) or K5 (5) of a shape
// code, K4a (1), K6 (3) or K4b (4, its default lanes). out = {registers a
// thread, local memory bytes a thread (spills), static shared memory bytes
// a block, resident blocks per SM, threads a block, lanes a ray}.
extern "C" int trace_kernel_info(int kernel, int shape, int* out) {
  const void* fn = nullptr;
  int threads = CHUNK, lanes = 1;
  if (kernel == 1) {
    fn = reinterpret_cast<const void*>(tri_kernel);
  } else if (kernel == 3) {
    fn = reinterpret_cast<const void*>(mesh_walk);
    lanes = WALK_LANES;
  } else if (kernel == 4) {
    fn = reinterpret_cast<const void*>(tri_culled_kernel<TRI_LANES>);
    lanes = TRI_LANES;
  } else if (kernel == 5) {
    switch (shape) {
      case SPHERE: fn = AnKernel<SPHERE>::get(threads); break;
      case CUBE: fn = AnKernel<CUBE>::get(threads); break;
      case CYLINDER: fn = AnKernel<CYLINDER>::get(threads); break;
      case CONE: fn = AnKernel<CONE>::get(threads); break;
      case QUAD: fn = AnKernel<QUAD>::get(threads); break;
      default: return cudaErrorInvalidValue;
    }
  } else if (kernel == 0 || kernel == 2) {
    const bool culled = kernel == 2;
    switch (shape) {
      case SPHERE: fn = GroupKernel<SPHERE>::get(culled, threads, lanes); break;
      case CUBE: fn = GroupKernel<CUBE>::get(culled, threads, lanes); break;
      case CYLINDER: fn = GroupKernel<CYLINDER>::get(culled, threads, lanes); break;
      case CONE: fn = GroupKernel<CONE>::get(culled, threads, lanes); break;
      case QUAD: fn = GroupKernel<QUAD>::get(culled, threads, lanes); break;
      default: return cudaErrorInvalidValue;
    }
  } else {
    return cudaErrorInvalidValue;
  }
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, 0);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(attr.sharedSizeBytes);
  out[3] = blocks;
  out[4] = threads;
  out[5] = lanes;
  return cudaSuccess;
}

extern "C" const char* trace_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
