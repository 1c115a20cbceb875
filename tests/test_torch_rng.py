"""The port's xxhash32 RNG against the JAX package's: bit equality.

The port keeps uint32 counters in int64 tensors (torch on the CPU has no
uint32 add or shift); every value must still equal the JAX package's
uint32 bit for bit, and every float draw must have the same bits.
Inputs come from fixed numpy seeds.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from montecarlo_pathtracing_tpu.ops import rng as jrng
from montecarlo_pathtracing_tpu_torch.ops import rng

N = 4096


def _u32(t):
    return t.numpy().astype(np.uint64)


def _j(a):
    return np.asarray(a).astype(np.uint64)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_srand_counters_bit_equal(seed):
    g = np.random.default_rng(seed)
    u = g.random(N, dtype=np.float32)
    v = g.random(N, dtype=np.float32)
    pass_index = int(g.integers(0, 1 << 20))
    date = float(np.float32(g.normal() * 100))
    ref = jrng.srand_soa(jnp.asarray(u), jnp.asarray(v), jnp.int32(pass_index),
                         date)
    got = rng.srand_soa(torch.as_tensor(u), torch.as_tensor(v), pass_index,
                        date)
    for r, t in zip(ref, got):
        assert t.dtype == torch.int64
        np.testing.assert_array_equal(_u32(t), _j(r))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_uniform_masked_schedule_bit_equal(seed):
    """A 2+1+2 schedule of masked draws from random states, as one bounce
    of the integrator takes them: floats and counters bit-equal."""
    g = np.random.default_rng(100 + seed)
    st = [g.integers(0, 1 << 32, N, dtype=np.uint64).astype(np.uint32)
          for _ in range(3)]
    jst = tuple(jnp.asarray(s) for s in st)
    tst = tuple(torch.as_tensor(s.astype(np.int64)) for s in st)
    for _ in range(5):
        mask = g.random(N) < 0.6
        jf, jst = jrng.uniform_masked_soa(jst, jnp.asarray(mask))
        tf, tst = rng.uniform_masked_soa(tst, torch.as_tensor(mask))
        np.testing.assert_array_equal(tf.numpy().view(np.uint32),
                                      np.asarray(jf).view(np.uint32))
        for r, t in zip(jst, tst):
            np.testing.assert_array_equal(_u32(t), _j(r))


def test_hash_extremes_and_python_oracle():
    """Counters at 0 and 2**32-1 (the wrap of every masked add and
    multiply), against the JAX hash and the pure-python oracle."""
    vals = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF],
                    np.uint32)
    s0, s1, s2 = np.meshgrid(vals, vals, vals, indexing="ij")
    s0, s1, s2 = (a.ravel() for a in (s0, s1, s2))
    ref = jrng.xxhash32_soa(jnp.asarray(s0), jnp.asarray(s1), jnp.asarray(s2))
    got = rng.xxhash32_soa(*(torch.as_tensor(a.astype(np.int64))
                             for a in (s0, s1, s2)))
    np.testing.assert_array_equal(_u32(got), _j(ref))
    for k in range(0, s0.size, 37):
        assert rng.xxhash32_py(int(s0[k]), int(s1[k]), int(s2[k])) == \
            int(got[k])
    f, new = rng.uniform_py(rng.srand_py(0.25, 0.75, 3, 1.5))
    jf, jnew = jrng.uniform_py(jrng.srand_py(0.25, 0.75, 3, 1.5))
    assert f == jf and [int(x) for x in new] == [int(x) for x in jnew]
