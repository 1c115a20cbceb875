"""Counter-based stateless RNG: bit-exact xxhash32 construction.

Port of montecarlo_pathtracing_tpu/ops/rng.py (the reference's GLSL RNG,
shaders/raytracer_func.frag:90-135): xxhash32 of a uvec3 counter, a seed
from (pixel uv bits, pass * GOLDEN + bits(date)), a counter advance of
uvec3(11, 43, 67) per draw, and the mantissa trick mapping the hash to a
float in [0, 1). Streams are bit-identical to the JAX package.

The AoS forms (`xxhash32`, `srand`, `uniform`, ...) keep the state as an
[..., 3] tensor, one counter per lane, as the reference's [N, 3] API; the
SoA forms (`*_soa`) as a tuple of [N] tensors. Both give the same streams.

Integer layout: PyTorch on the CPU has no uint32 add or shift, so a
counter lane is an int64 tensor holding a value in [0, 2**32). Every add
and multiply is masked with `& 0xFFFFFFFF`; the int64 product of two
masked values may wrap, but its low 32 bits are still right. The CUDA
kernels use native uint32_t.
"""
from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF

# xxhash32 primes (raytracer_func.frag:92-93)
_P2 = 2246822519
_P3 = 3266489917
_P4 = 668265263
_P5 = 374761393

# per-draw counter advance (raytracer_func.frag:121)
ADVANCE = (11, 43, 67)

_MANTISSA = 0x007FFFFF
_ONE_F32 = 0x3F800000

# Weyl/golden-ratio step mixing the pass index into the seed
GOLDEN = 0x9E3779B9


def float_bits(x: torch.Tensor) -> torch.Tensor:
    """float32 tensor -> its IEEE bits as int64 in [0, 2**32)."""
    return x.to(torch.float32).contiguous().view(torch.int32).to(
        torch.int64) & M32


def seed_y(pass_index: int, date: float = 0.0) -> int:
    """The y word of the seed: pass * GOLDEN + bits(date), mod 2**32."""
    db = int(np.float32(date).view(np.uint32))
    return (int(pass_index) * GOLDEN + db) & M32


def _rotl17(h):
    return ((h << 17) | (h >> 15)) & M32


def xxhash32(p):
    """xxhash32 of an int64 [..., 3] counter of uint32 values
    (raytracer_func.frag:90-101)."""
    return xxhash32_soa(p[..., 0], p[..., 1], p[..., 2])


def srand(screen_tc, pass_index: int, date: float = 0.0):
    """Initial per-lane counter from (uv, pass, date), integer-exact:
    (bits(tc.x), pass * GOLDEN + bits(date), bits(tc.y)). screen_tc:
    float32 [..., 2]; returns int64 [..., 3]."""
    return torch.stack(srand_soa(screen_tc[..., 0], screen_tc[..., 1],
                                 pass_index, date), dim=-1)


def uniform(state):
    """One draw per lane of an int64 [..., 3] state: (value in [0, 1)
    float32, advanced state) (raytracer_func.frag:112-124)."""
    f, new = uniform_soa((state[..., 0], state[..., 1], state[..., 2]))
    return f, torch.stack(new, dim=-1)


def uniform_masked(state, mask):
    """Draw for every lane but advance the counter only where `mask`:
    the sequential GLSL draw schedule under masked SIMD. Values at
    masked-off lanes are garbage and must not be used."""
    f, new = uniform(state)
    return f, torch.where(mask[..., None], new, state)


def uniform2(state):
    f1, state = uniform(state)
    f2, state = uniform(state)
    return torch.stack([f1, f2], dim=-1), state


def uniform3(state):
    f1, state = uniform(state)
    f2, state = uniform(state)
    f3, state = uniform(state)
    return torch.stack([f1, f2, f3], dim=-1), state


# ---------------------------------------------------------------------------
# SoA forms: the state as a tuple (s0, s1, s2) of [N] int64 tensors, the
# same streams bit for bit
# ---------------------------------------------------------------------------

def xxhash32_soa(s0, s1, s2):
    """xxhash32 of (s0, s1, s2), each an int64 tensor of uint32 values."""
    h = (s2 + _P5 + ((s0 * _P3) & M32)) & M32
    h = (_P4 * _rotl17(h)) & M32
    h = (h + ((s1 * _P3) & M32)) & M32
    h = (_P4 * _rotl17(h)) & M32
    h = (_P2 * (h ^ (h >> 15))) & M32
    h = (_P3 * (h ^ (h >> 13))) & M32
    return h ^ (h >> 16)


def srand_soa(u, v, pass_index: int, date: float = 0.0):
    """u, v: [N] float32 screen coords. Returns the state tuple
    (bits(u), pass * GOLDEN + bits(date), bits(v)) of [N] int64."""
    bu = float_bits(u)
    bv = float_bits(v)
    y = torch.full_like(bu, seed_y(pass_index, date))
    return (bu, y, bv)


def uniform_soa(state):
    """One draw per lane: (value in [0, 1) float32, advanced state)."""
    s0, s1, s2 = state
    m = xxhash32_soa(s0, s1, s2)
    m = (m & _MANTISSA) | _ONE_F32
    f = m.to(torch.int32).view(torch.float32) - 1.0
    return f, ((s0 + ADVANCE[0]) & M32, (s1 + ADVANCE[1]) & M32,
               (s2 + ADVANCE[2]) & M32)


def uniform_masked_soa(state, mask):
    """Draw for every lane but advance the counter only where `mask`:
    the sequential GLSL draw schedule under masked SIMD. Values at
    masked-off lanes are garbage and must not be used."""
    f, new = uniform_soa(state)
    return f, tuple(torch.where(mask, n, s) for n, s in zip(new, state))


# ---------------------------------------------------------------------------
# Pure-python oracle (for tests)
# ---------------------------------------------------------------------------

def xxhash32_py(x: int, y: int, z: int) -> int:
    def rotl(v, r):
        return ((v << r) | (v >> (32 - r))) & M32

    h = (z + 374761393 + x * 3266489917) & M32
    h = (668265263 * rotl(h, 17)) & M32
    h = (h + y * 3266489917) & M32
    h = (668265263 * rotl(h, 17)) & M32
    h = (2246822519 * ((h ^ (h >> 15)))) & M32
    h = (3266489917 * ((h ^ (h >> 13)))) & M32
    return (h ^ (h >> 16)) & M32


def srand_py(u: float, v: float, pass_index: int, date: float = 0.0):
    bu = int(np.float32(u).view(np.uint32))
    bv = int(np.float32(v).view(np.uint32))
    return np.array([bu, seed_y(pass_index, date), bv], dtype=np.uint64)


def uniform_py(state):
    """state: length-3 array-like of python ints/uint64. Returns (f, state)."""
    st = [int(s) & M32 for s in state]
    m = xxhash32_py(*st)
    m = (m & _MANTISSA) | _ONE_F32
    f = float(np.array([m], dtype=np.uint32).view(np.float32)[0]) - 1.0
    new = [(s + a) & M32 for s, a in zip(st, ADVANCE)]
    return np.float32(f), new
