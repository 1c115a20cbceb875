// K1: the whole-pass path-tracing megakernel, by hand for Hopper (sm_90a).
//
// Replaces montecarlo_pathtracing_tpu/models/megakernel.py::_mega_kernel
// (the Pallas TPU kernel launched by _mega_call). One launch runs one
// progressive pass for every ray: the xxhash32 seed from the uv bits and
// pass * GOLDEN + bits(date), then per bounce the closest-hit fold over
// the [38, P] prim table (optionally culled by 16-prim super boxes in the
// tile's nearest-first order, then per-prim boxes), sky, ambient leak,
// emission, the 4-case material logic with its 2+1+2 masked draws,
// Schlick, the Phong lobe, and on transparent scenes the refraction
// re-trace. The plain PyTorch version is models/megakernel.py::
// mega_pass_reference; chip_smoke.py holds the two against each other.
//
// What bounds it. The fold: per prim and ray about 60-150 FP32 operations
// (more for cubes and cones), repeated for every prim of the scene, or of
// the supers and prims a ray enters, on every bounce, with no reuse across
// rays; and the shading, one bounce step per ray in flight. Device memory
// sees only 20 bytes in and 12 bytes out per ray: the issue slots bound it,
// not bandwidth. The first design (one thread a ray, 128 threads a block,
// the table read from device memory) issued 250-470 instructions a prim
// test for those 60-150 operations (the IEEE divisions, square roots and
// their slow paths, 12-31 scalar loads a test), held 128-168 registers (3-4
// resident blocks, spills) and took 22-126x its bound (chip_smoke.py phases
// 1-3 on an H100; PERF.md). Its time per bounce did not follow the rays in
// flight: on box_diffuse 96% of a warp's lane-bounces carried a path.
//
// Design, each step measured on an H100 with K1 built with the step on
// and off, and kept where faster:
// - The table staged in shared memory once a block, as per-prim float4
//   records that the block packs from the [38, P] table: the prim boxes
//   ((min, ok flag), (max, 0)) and the super boxes (32 bytes each), then
//   the inverse frames (48 bytes) and the hit records (the forward frame's
//   rows, shin, rough, emis, rgba: 80 bytes). A test reads 2 to 5 16-byte
//   broadcasts. The kernel stages as much as costs no resident blocks:
//   everything on box_diffuse, box_balls and materials, the boxes alone on
//   colonnes (976 prims: 33 KB), whose culled fold is mostly box tests;
//   the rest is read from device memory (K1Tab). Staging alone, at 4
//   blocks, cut the registers from 128-168 to 84-96 with no spills.
// - K3a's masked shape tests (common.cuh), with the fold's divisions and
//   normalisations and the shading's normalisations, log, sine, cosine and
//   power taken by the approximate intrinsics (__fdividef, rsqrtf, __logf,
//   __sincosf, __powf; FAST in common.cuh), which issue a fraction of the
//   IEEE forms' instructions: faster on every window in the fold, and in
//   the shading on all but colonnes (a few percent slower there). K1 is
//   held to its plain version by the megakernel protocol, which holds
//   with them (the share of lanes within 1e-3 and the mean difference are
//   printed).
// - __launch_bounds__(128, 6): 80 registers, 6 resident blocks; the
//   fastest bound on box_diffuse and box_balls, as fast as 4 and 5 on
//   colonnes, a few percent behind them on materials. At that bound the
//   staged culled variants spill 32-52 bytes, those reading the table or
//   its frames from device memory 170-714 (the -Xptxas -v report).
// - Persistent blocks with path regeneration: the grid is as many blocks
//   as are resident on the card at once; a lane whose path has ended
//   writes its rgb and takes the next ray of the launch, at bounce 0, from
//   a counter (next_ray) in warp-wide batches (one atomic a warp and
//   round), until the launch's rays run out. The seed, the RNG counters
//   and the draw schedule belong to the ray, so every ray's output is the
//   one a thread of its own gives. mega_pass zeroes the counter on the
//   stream before the launch: K1 runs on one stream at a time. It paid
//   where many paths end early (colonnes) and cost a little where few do
//   (box_diffuse, box_balls, materials); it stays for the larger absolute
//   gain. Refilling a warp only once all its lanes are idle was no better.
// Floating point is IEEE elsewhere (common.cuh); this file is built with
// FMA contraction (kernels.py).
//
// The device code K1 shares with K2 (the bounce step, the RNG, the shape
// tests, the normal point) is in common.cuh; K1's fold over its staged or
// global table is here.

#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace {

using namespace pt;

constexpr int BLOCK = 128;      // threads a block
constexpr int MIN_BLOCKS = 6;   // resident blocks an SM must fit (80 registers)
constexpr int TILE = 4096;        // rays per row of the super visit order
constexpr int SMEM_MAX = 232448;  // bytes of shared memory a block may use
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_DEVICES = 64;   // devices whose SM count is cached

// the next ray of the launch that no lane has taken
__device__ unsigned int next_ray;

struct Params {
  const float* dirs;  // [Np,3] unit directions
  const float* tc;    // [Np,2] screen coords (their bits seed the RNG)
  const float* fpar;  // [4] origin xyz, IOR
  Table table;        // [38,P] prim table, super boxes (cull), groups
  const int* ordr;    // [Np/TILE,1,S] per-tile super visit order (cull)
  float* rgb;         // [n,3] out
  uint32_t seed;      // pass * GOLDEN + bits(date)
  int nb_bounces, n;
};

__device__ __forceinline__ void unpack3(const float4* m, float (&f)[12]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float4 v = m[k];
    f[4 * k] = v.x;
    f[4 * k + 1] = v.y;
    f[4 * k + 2] = v.z;
    f[4 * k + 3] = v.w;
  }
}

// K1's prim table, read from shared memory as far as STAGE says: 0 none
// (the [38, P] table in device memory), 1 the prim boxes [P][2] ((min,
// ok), (max, 0)) and the super boxes [S][2] ((min, 0), (max, 0)), 2 also
// the inverse frames [P][3] and the hit records [P][5] (the forward
// frame's rows, (shin, rough, emis, r), (g, b, a, 0))
template <int STAGE>
struct K1Tab {
  const float* tab;
  const float* sbb;
  int P, S;
  const float4* box;
  const float4* sup;
  const float4* inv;
  const float4* hit;
  __device__ __forceinline__ float at(int r, int c) const { return ld(tab, r, P, c); }
  __device__ __forceinline__ void inverse(int c, float (&iv)[12]) const {
    if constexpr (STAGE == 2) {
      unpack3(inv + 3 * c, iv);
    } else {
#pragma unroll
      for (int r = 0; r < 12; ++r) iv[r] = at(r, c);
    }
  }
  __device__ __forceinline__ float4 box_lo(int c) const {
    if constexpr (STAGE >= 1) return box[2 * c];
    return make_float4(at(32, c), at(33, c), at(34, c), at(31, c));
  }
  __device__ __forceinline__ float4 box_hi(int c) const {
    if constexpr (STAGE >= 1) return box[2 * c + 1];
    return make_float4(at(35, c), at(36, c), at(37, c), 0.0f);
  }
  __device__ __forceinline__ void forward(int c, float (&tf)[12]) const {
    if constexpr (STAGE == 2) {
      unpack3(hit + 5 * c, tf);
    } else {
#pragma unroll
      for (int r = 0; r < 12; ++r) tf[r] = at(12 + r, c);
    }
  }
  __device__ __forceinline__ float4 mat0(int c) const {
    if constexpr (STAGE == 2) return hit[5 * c + 3];
    return make_float4(at(24, c), at(25, c), at(26, c), at(27, c));
  }
  __device__ __forceinline__ float4 mat1(int c) const {
    if constexpr (STAGE == 2) return hit[5 * c + 4];
    return make_float4(at(28, c), at(29, c), at(30, c), 0.0f);
  }
  __device__ __forceinline__ float4 sup_lo(int s) const {
    if constexpr (STAGE >= 1) return sup[2 * s];
    return make_float4(ld(sbb, 0, S, s), ld(sbb, 1, S, s), ld(sbb, 2, S, s), 0.0f);
  }
  __device__ __forceinline__ float4 sup_hi(int s) const {
    if constexpr (STAGE >= 1) return sup[2 * s + 1];
    return make_float4(ld(sbb, 3, S, s), ld(sbb, 4, S, s), ld(sbb, 5, S, s), 0.0f);
  }
};

// shared memory bytes of the table staged at STAGE
__host__ __device__ constexpr int staged_bytes(int stage, int P, int S) {
  return stage == 0 ? 0 : 16 * (2 * P + 2 * S + (stage == 2 ? 8 * P : 0));
}

// the table packed into shared memory by the block's threads, a column a
// thread (the rows of a column: coalesced across the threads); returns the
// accessor
template <int STAGE>
__device__ K1Tab<STAGE> stage_table(const Table& t, float4* smem) {
  K1Tab<STAGE> k{t.tab, t.sbb, t.P, t.S, smem, smem + 2 * t.P, smem + 2 * t.P + 2 * t.S,
                 smem + 5 * t.P + 2 * t.S};
  if constexpr (STAGE >= 1) {
    float4* box = smem;
    float4* sup = smem + 2 * t.P;
    float4* inv = smem + 2 * t.P + 2 * t.S;
    float4* hit = inv + 3 * t.P;
    for (int c = threadIdx.x; c < t.P; c += blockDim.x) {
      box[2 * c] = make_float4(ld(t.tab, 32, t.P, c), ld(t.tab, 33, t.P, c), ld(t.tab, 34, t.P, c),
                               ld(t.tab, 31, t.P, c));
      box[2 * c + 1] =
          make_float4(ld(t.tab, 35, t.P, c), ld(t.tab, 36, t.P, c), ld(t.tab, 37, t.P, c), 0.0f);
      if constexpr (STAGE == 2) {
        float v[31];
#pragma unroll
        for (int r = 0; r < 31; ++r) v[r] = ld(t.tab, r, t.P, c);
#pragma unroll
        for (int k3 = 0; k3 < 3; ++k3) {
          inv[3 * c + k3] = make_float4(v[4 * k3], v[4 * k3 + 1], v[4 * k3 + 2], v[4 * k3 + 3]);
          hit[5 * c + k3] =
              make_float4(v[12 + 4 * k3], v[13 + 4 * k3], v[14 + 4 * k3], v[15 + 4 * k3]);
        }
        hit[5 * c + 3] = make_float4(v[24], v[25], v[26], v[27]);
        hit[5 * c + 4] = make_float4(v[28], v[29], v[30], 0.0f);
      }
    }
    for (int s = threadIdx.x; s < t.S; s += blockDim.x) {
      sup[2 * s] = make_float4(ld(t.sbb, 0, t.S, s), ld(t.sbb, 1, t.S, s), ld(t.sbb, 2, t.S, s),
                               0.0f);
      sup[2 * s + 1] = make_float4(ld(t.sbb, 3, t.S, s), ld(t.sbb, 4, t.S, s),
                                   ld(t.sbb, 5, t.S, s), 0.0f);
    }
    __syncthreads();
  }
  return k;
}

// common.cuh's slab<BEHIND> on a box given as (min, _), (max, _)
template <bool BEHIND>
__device__ __forceinline__ bool slab4(float4 lo, float4 hi, V3 o, V3 rd, float dl, float best) {
  const float t0x = (lo.x - o.x) * rd.x, t1x = (hi.x - o.x) * rd.x;
  const float t0y = (lo.y - o.y) * rd.y, t1y = (hi.y - o.y) * rd.y;
  const float t0z = (lo.z - o.z) * rd.z, t1z = (hi.z - o.z) * rd.z;
  float tmin = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  const float tmax = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
  if (BEHIND) return (tmax >= tmin) && (fmaxf(fmaxf(tmin, -tmax), 0.0f) * dl <= best);
  tmin = fmaxf(tmin, 0.0f);
  return (tmax >= tmin) && (tmin * dl <= best);
}

// test prim column c and fold it into w under the strictly-closer rule
// (common.cuh prim_work with the masked tests)
template <int SHAPE, class Tab>
__device__ __forceinline__ void prim_test(const Tab& tab, int c, V3 o, V3 d, Win& w) {
  float iv[12];
  tab.inverse(c, iv);
  const V3 oi = affine(iv, o);
  const V3 di = vnorm_masked<true>(linear(iv, d));
  float a;
  int code;
  if (!group_shape<SHAPE, true>(oi, di, a, code)) return;  // dist would be FMAX
  float tf[12];
  tab.forward(c, tf);
  const V3 pl = {oi.x + a * di.x, oi.y + a * di.y, oi.z + a * di.z};
  const V3 pg = affine(tf, pl);
  const V3 e = sub(o, pg);
  const float dist = sqrtf(e.x * e.x + e.y * e.y + e.z * e.z);
  if (!(dist < w.bd)) return;
  const V3 q = normal_point<SHAPE>(pl, code);
  V3 nv = vnorm(sub(affine(tf, q), pg), TINY);
  // cone top-"cap" quirk: N = 0 (raytracer_func.frag:850-853)
  if (SHAPE == CONE && code == 1) nv = {0.0f, 0.0f, 0.0f};
  const float4 m0 = tab.mat0(c), m1 = tab.mat1(c);
  w.bd = dist;
  w.n = nv;
  w.p = pg;
  w.shin = m0.x;
  w.rough = m0.y;
  w.emis = m0.z;
  w.r = m0.w;
  w.g = m1.x;
  w.b = m1.y;
  w.a = m1.z;
}

// common.cuh's fold_group over the staged or global records
template <int SHAPE, bool CULL, class Tab>
__device__ void fold_group_k1(const Tab& tab, const int* ordr_row, int start, int count,
                              int sstart, V3 o, V3 d, V3 rd, float dl, Win& w) {
  if (!CULL) {
    for (int c = start; c < start + count; ++c) {
      if (!(tab.box_lo(c).w > 0.0f)) continue;  // group padding never hits
      prim_test<SHAPE>(tab, c, o, d, w);
    }
    return;
  }
  // two-level frontier: a super box gates its prims' box tests; supers in
  // the tile's nearest-first order so the running best tightens early
  constexpr bool BEHIND = SHAPE == QUAD || SHAPE == CONE;
  const int nsup = (count + SUPER - 1) / SUPER;
  for (int spi = 0; spi < nsup; ++spi) {
    const int sp = __ldg(ordr_row + sstart + spi);
    if (!slab4<BEHIND>(tab.sup_lo(sstart + sp), tab.sup_hi(sstart + sp), o, rd, dl, w.bd))
      continue;
    for (int j = 0; j < SUPER; ++j) {
      // the clamp re-tests the group's last prim; an equal candidate never
      // replaces the winner
      const int c = start + min(sp * SUPER + j, count - 1);
      const float4 lo = tab.box_lo(c);
      if (!(lo.w > 0.0f)) continue;
      if (!slab4<BEHIND>(lo, tab.box_hi(c), o, rd, dl, w.bd)) continue;
      prim_test<SHAPE>(tab, c, o, d, w);
    }
  }
}

// K1's closest-hit search: every group of the table, the supers (with CULL)
// in the ray's tile's nearest-first order; on a miss N, P keep (n_prev,
// p_prev), the GLSL stale-output semantics the refraction re-trace relies
// on (common.cuh's trace_fold, over the staged or global records)
template <bool CULL, class Tab>
struct MegaTrace {
  Tab tab;
  const int* groups;
  int G;
  const int* ordr_row;
  __device__ __forceinline__ void operator()(V3 o, V3 d, V3 n_prev, V3 p_prev, Win& w) const {
    w.bd = FMAX;
    w.n = n_prev;
    w.p = p_prev;
    w.shin = w.rough = w.emis = 0.0f;
    w.r = w.g = w.b = 0.0f;
    w.a = 1.0f;
    V3 rd = {0.0f, 0.0f, 0.0f};
    float dl = 0.0f;
    if (CULL) {
      rd = {safe_rcp(d.x), safe_rcp(d.y), safe_rcp(d.z)};
      dl = sqrtf(dot(d, d));
    }
    for (int g = 0; g < G; ++g) {
      const int code = __ldg(groups + 4 * g);
      const int start = __ldg(groups + 4 * g + 1);
      const int count = __ldg(groups + 4 * g + 2);
      const int sstart = __ldg(groups + 4 * g + 3);
      switch (code) {  // uniform: every thread reads the same descriptor
        case SPHERE:
          fold_group_k1<SPHERE, CULL>(tab, ordr_row, start, count, sstart, o, d, rd, dl, w);
          break;
        case CUBE:
          fold_group_k1<CUBE, CULL>(tab, ordr_row, start, count, sstart, o, d, rd, dl, w);
          break;
        case CYLINDER:
          fold_group_k1<CYLINDER, CULL>(tab, ordr_row, start, count, sstart, o, d, rd, dl, w);
          break;
        case CONE:
          fold_group_k1<CONE, CULL>(tab, ordr_row, start, count, sstart, o, d, rd, dl, w);
          break;
        default:
          fold_group_k1<QUAD, CULL>(tab, ordr_row, start, count, sstart, o, d, rd, dl, w);
          break;
      }
    }
  }
};

template <bool TRANSPARENT, bool CULL, int STAGE>
__global__ void __launch_bounds__(BLOCK, MIN_BLOCKS) mega_kernel(Params p) {
  using Tab = K1Tab<STAGE>;
  extern __shared__ float4 smem[];
  const Tab tab = stage_table<STAGE>(p.table, smem);
  MegaTrace<CULL, Tab> trace{tab, p.table.groups, p.table.G, nullptr};
  const V3 origin = {__ldg(p.fpar), __ldg(p.fpar + 1), __ldg(p.fpar + 2)};
  const float ior = __ldg(p.fpar + 3);
  const int lane = threadIdx.x % 32;
  const unsigned below = (1u << lane) - 1u;
  int ray = -1;      // the lane's ray, -1 between rays
  int bounce = 0;    // the bounces its path has taken
  bool more = true;  // the launch may still hold a ray for this lane
  Path s;
  for (;;) {
    // lanes without a path take the next rays, a batch a warp
    const unsigned want = __ballot_sync(FULL, ray < 0 && more);
    if (want) {
      const int leader = __ffs(want) - 1;
      unsigned base = 0;
      if (lane == leader) base = atomicAdd(&next_ray, static_cast<unsigned>(__popc(want)));
      base = __shfl_sync(FULL, base, leader);
      if (ray < 0 && more) {
        const unsigned r = base + __popc(want & below);
        if (r < static_cast<unsigned>(p.n)) {
          ray = static_cast<int>(r);
          bounce = 0;
          s.d = {p.dirs[3 * ray], p.dirs[3 * ray + 1], p.dirs[3 * ray + 2]};
          s.o = origin;
          // srand: integer-exact seed (ops/rng.srand_soa)
          s.st = {__float_as_uint(p.tc[2 * ray]), p.seed, __float_as_uint(p.tc[2 * ray + 1])};
          s.att = {0.8f, 0.8f, 0.8f};  // vec3(0.8) (:106-107)
          s.total = {0.0f, 0.0f, 0.0f};
          s.result = {0.0f, 0.0f, 0.0f};
          s.done = false;
        } else {
          more = false;
        }
      }
    }
    if (!__any_sync(FULL, ray >= 0)) break;
    if (ray < 0) continue;
    if (bounce < p.nb_bounces) {
      trace.ordr_row = CULL ? p.ordr + (ray / TILE) * p.table.S : nullptr;
      bounce_step<TRANSPARENT, true>(trace, ior, s);
      ++bounce;
    }
    // a finished path changes nothing in later bounces, so it ends here;
    // bounce-cap exhaustion returns black (:178)
    if (s.done || bounce >= p.nb_bounces) {
      float* out = p.rgb + 3 * ray;
      out[0] = s.done ? s.result.x : 0.0f;
      out[1] = s.done ? s.result.y : 0.0f;
      out[2] = s.done ? s.result.z : 0.0f;
      ray = -1;
    }
  }
}

template <bool TRANSPARENT, bool CULL, int STAGE>
const void* kernel_of() {
  return reinterpret_cast<const void*>(mega_kernel<TRANSPARENT, CULL, STAGE>);
}

// K1's kernel of one variant for a table of P prims and S supers: the
// table staged as far as costs no resident blocks, its dynamic shared
// memory and resident blocks per SM
template <bool TRANSPARENT, bool CULL>
const void* choose(int P, int S, int& smem, int& per_sm, cudaError_t& err) {
  const void* fns[3] = {kernel_of<TRANSPARENT, CULL, 0>(), kernel_of<TRANSPARENT, CULL, 1>(),
                        kernel_of<TRANSPARENT, CULL, 2>()};
  for (int stage = 2; stage > 0; --stage) {
    if (stage == 1 && !CULL) continue;  // the uncull fold reads no boxes
    const void* fn = fns[stage];
    smem = staged_bytes(stage, P, S);
    if (smem > SMEM_MAX) continue;
    int free_sm = 0;
    per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&free_sm, fn, BLOCK, 0);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, BLOCK, smem);
    if (err != cudaSuccess) return nullptr;
    if (per_sm > 0 && per_sm == free_sm) return fn;
  }
  smem = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fns[0], BLOCK, 0);
  return fns[0];
}

const void* mega_variant(int has_transparent, int cull, int P, int S, int& smem, int& per_sm,
                         cudaError_t& err) {
  if (has_transparent)
    return cull ? choose<true, true>(P, S, smem, per_sm, err)
                : choose<true, false>(P, S, smem, per_sm, err);
  return cull ? choose<false, true>(P, S, smem, per_sm, err)
              : choose<false, false>(P, S, smem, per_sm, err);
}

}  // namespace

extern "C" int mega_pass(const void* dirs, const void* tc, const void* fpar, unsigned int seed,
                         const void* tab, int P, const void* sbb, int S, const void* ordr,
                         const void* groups, int G, int nb_bounces, int has_transparent, int cull,
                         int n, void* rgb, void* stream) {
  Params p;
  p.dirs = static_cast<const float*>(dirs);
  p.tc = static_cast<const float*>(tc);
  p.fpar = static_cast<const float*>(fpar);
  p.table.tab = static_cast<const float*>(tab);
  p.table.sbb = static_cast<const float*>(sbb);
  p.table.groups = static_cast<const int*>(groups);
  p.table.P = P;
  p.table.S = cull ? S : 0;
  p.table.G = G;
  p.ordr = static_cast<const int*>(ordr);
  p.rgb = static_cast<float*>(rgb);
  p.seed = seed;
  p.nb_bounces = nb_bounces;
  p.n = n;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int smem = 0, per_sm = 0;
  cudaError_t err = cudaSuccess;
  const void* fn = mega_variant(has_transparent, cull, P, p.table.S, smem, per_sm, err);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  // the current device's SM count, cached per device (the cards of a host
  // may differ)
  static int sms_of[MAX_DEVICES] = {};
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev < MAX_DEVICES) sms = sms_of[dev];
  if (err == cudaSuccess && sms == 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess && dev < MAX_DEVICES) sms_of[dev] = sms;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  // as many blocks as are resident at once, and no more than the rays need
  const int grid = std::min(per_sm * sms, (n + BLOCK - 1) / BLOCK);
  void* counter = nullptr;
  err = cudaGetSymbolAddress(&counter, next_ray);
  if (err == cudaSuccess) err = cudaMemsetAsync(counter, 0, sizeof(unsigned int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&p};
  err = cudaLaunchKernel(fn, dim3(grid), dim3(BLOCK), args, static_cast<size_t>(smem), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The K1 kernel that mega_pass launches for a variant (transparent or not,
// culled or not) and a table of P prims and S super boxes: out = {registers
// a thread, local memory bytes a thread (spills), static shared memory
// bytes a block, resident blocks per SM, threads a block, dynamic shared
// memory bytes a block (the staged table; 0 where it is read from device
// memory)}.
extern "C" int mega_kernel_info(int has_transparent, int cull, int P, int S, int* out) {
  int smem = 0, per_sm = 0;
  cudaError_t err = cudaSuccess;
  const void* fn = mega_variant(has_transparent, cull, P, cull ? S : 0, smem, per_sm, err);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(attr.sharedSizeBytes);
  out[3] = per_sm;
  out[4] = BLOCK;
  out[5] = smem;
  return cudaSuccess;
}

extern "C" const char* mega_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
