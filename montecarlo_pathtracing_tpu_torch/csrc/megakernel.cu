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
// Design. One thread per ray, 128 threads per block; the TPU's 32x128
// ray tile survives only as the row of the super visit order a ray reads
// (ordr[ray / 4096]). All per-ray state (position, direction, throughput,
// RNG counters and the 14 winner attributes of the fold) lives in
// registers. The prim table, the super boxes, the visit order and the
// group descriptor stay in global memory and are read with __ldg: every
// thread of a warp reads the same prim at the same time, so each load is
// one broadcast transaction that hits L1 after the first warp.
//
// What bounds it. The fold: per prim and ray about 25 uniform loads and
// 60-150 FP32 operations (more for cubes and cones), repeated for every
// prim of the scene on every bounce, with no reuse across rays. The loads
// are warp-uniform L1 hits, so the issue slots of the FP32 work and the
// divergence of the per-ray branches (hit or miss, the four material
// cases, the per-ray cull) bound it, not memory bandwidth: device memory
// sees only 20 bytes in and 12 bytes out per ray. The simple design does
// two things about it: a prim whose shape test fails skips the hit-point
// and normal work, and a ray that terminates leaves the bounce loop, so
// finished rays cost nothing. The TPU kept the table in 1 MB of SMEM;
// at 4096 prims it takes 608 KB, more than a block's 227 KB of shared
// memory, so staging it through shared memory in chunks is left for a
// later change.
//
// The device code K1 shares with K2 (shape tests, the fold over the prim
// table, the bounce step, the RNG) is in common.cuh. Floating point is
// IEEE, without --use_fast_math (see there).

#include "common.cuh"

namespace {

using namespace pt;

constexpr int BLOCK = 128;
constexpr int TILE = 4096;  // rays per row of the super visit order

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

// the prim-table fold of K1: every group of the table, the supers (with
// CULL) in the tile's nearest-first order. It refers to the kernel
// parameter's table, which the compiler reads from the constant bank
// instead of holding it in registers.
template <bool CULL>
struct MegaTrace {
  const Table& t;
  const int* ordr_row;
  __device__ __forceinline__ void operator()(V3 o, V3 d, V3 n_prev, V3 p_prev, Win& w) const {
    trace_fold<CULL>(t, ordr_row, o, d, n_prev, p_prev, w);
  }
};

template <bool TRANSPARENT, bool CULL>
__global__ void __launch_bounds__(BLOCK) mega_kernel(Params p) {
  const int ray = blockIdx.x * BLOCK + threadIdx.x;
  if (ray >= p.n) return;
  Path s;
  s.d = {p.dirs[3 * ray], p.dirs[3 * ray + 1], p.dirs[3 * ray + 2]};
  s.o = {__ldg(p.fpar), __ldg(p.fpar + 1), __ldg(p.fpar + 2)};
  const float ior = __ldg(p.fpar + 3);
  // srand: integer-exact seed (ops/rng.srand_soa)
  s.st = {__float_as_uint(p.tc[2 * ray]), p.seed, __float_as_uint(p.tc[2 * ray + 1])};
  MegaTrace<CULL> trace{p.table, CULL ? p.ordr + (ray / TILE) * p.table.S : nullptr};

  s.att = {0.8f, 0.8f, 0.8f};  // vec3(0.8) (:106-107)
  s.total = {0.0f, 0.0f, 0.0f};
  s.result = {0.0f, 0.0f, 0.0f};
  s.done = false;
  // a finished ray changes nothing in later bounces, so it leaves the loop
  for (int bounce = 0; bounce < p.nb_bounces && !s.done; ++bounce)
    bounce_step<TRANSPARENT>(trace, ior, s);
  // bounce-cap exhaustion returns black (:178)
  float* out = p.rgb + 3 * ray;
  out[0] = s.done ? s.result.x : 0.0f;
  out[1] = s.done ? s.result.y : 0.0f;
  out[2] = s.done ? s.result.z : 0.0f;
}

template <bool TRANSPARENT, bool CULL>
void launch(const Params& p, cudaStream_t stream) {
  const int grid = (p.n + BLOCK - 1) / BLOCK;
  mega_kernel<TRANSPARENT, CULL><<<grid, BLOCK, 0, stream>>>(p);
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
  p.table.S = S;
  p.table.G = G;
  p.ordr = static_cast<const int*>(ordr);
  p.rgb = static_cast<float*>(rgb);
  p.seed = seed;
  p.nb_bounces = nb_bounces;
  p.n = n;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (has_transparent) {
    if (cull)
      launch<true, true>(p, s);
    else
      launch<true, false>(p, s);
  } else {
    if (cull)
      launch<false, true>(p, s);
    else
      launch<false, false>(p, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mega_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
