"""The port's wavefront sort keys and permutation against the JAX package's.

Keys are integers, so they must be bit-equal (the port holds them as
int64 values in [0, 2**32), the reference as uint32), dead lanes
included; the stable argsort must give the same permutation, also across
the many equal keys of dead lanes.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from montecarlo_pathtracing_tpu.ops import sort_rays as jsr
from montecarlo_pathtracing_tpu_torch.ops import sort_rays as sr


def _wavefront(seed, n=2048):
    """Origins partly outside the bounds, directions with exact zeros and
    signs of every octant, a third of the lanes dead."""
    g = np.random.default_rng(seed)
    o = (g.normal(size=(3, n)) * 60).astype(np.float32)
    d = g.normal(size=(3, n)).astype(np.float32)
    d[0, :n // 8] = 0.0
    d[2, n // 8:n // 4] = -0.0
    done = g.random(n) < 0.33
    lo = np.array([-50.0, -40.0, -30.0], np.float32)
    hi = np.array([45.0, 60.0, 20.0], np.float32)
    return o, d, done, lo, hi


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ray_sort_key_bit_equal(seed):
    o, d, done, lo, hi = _wavefront(seed)
    ref = np.asarray(jsr.ray_sort_key(
        tuple(jnp.asarray(x) for x in o), tuple(jnp.asarray(x) for x in d),
        jnp.asarray(done), jnp.asarray(lo), jnp.asarray(hi)))
    got = sr.ray_sort_key(
        tuple(torch.as_tensor(x) for x in o),
        tuple(torch.as_tensor(x) for x in d), torch.as_tensor(done),
        torch.as_tensor(lo), torch.as_tensor(hi))
    assert got.dtype == torch.int64
    got = got.numpy()
    assert ((got >= 0) & (got <= 0xFFFFFFFF)).all()
    np.testing.assert_array_equal(got, ref.astype(np.int64))
    assert (got[done] == sr.DEAD_KEY).all() and (got[~done] < sr.DEAD_KEY).all()


def test_sort_wavefront_permutation_equal():
    o, d, done, lo, hi = _wavefront(5)
    jkey = jsr.ray_sort_key(
        tuple(jnp.asarray(x) for x in o), tuple(jnp.asarray(x) for x in d),
        jnp.asarray(done), jnp.asarray(lo), jnp.asarray(hi))
    key = sr.ray_sort_key(
        tuple(torch.as_tensor(x) for x in o),
        tuple(torch.as_tensor(x) for x in d), torch.as_tensor(done),
        torch.as_tensor(lo), torch.as_tensor(hi))
    lane = np.arange(o.shape[1], dtype=np.int32)
    jperm, jout = jsr.sort_wavefront(jkey, [jnp.asarray(o[0]),
                                            jnp.asarray(lane)])
    perm, out = sr.sort_wavefront(key, [torch.as_tensor(o[0]),
                                        torch.as_tensor(lane)])
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(jout[0]))
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(jout[1]))
    # dead lanes keep their order at the tail (stable sort)
    ndead = int(done.sum())
    np.testing.assert_array_equal(perm.numpy()[-ndead:], np.flatnonzero(done))


def test_park_constants_equal():
    assert sr.PARK_Z == float(jsr.PARK_Z)
    assert sr.DEAD_KEY == int(jsr.DEAD_KEY)
