"""The port never imports jax or the JAX package.

Checked in a fresh interpreter, because tests/conftest.py imports jax
into the pytest process.
"""
import os
import pkgutil
import subprocess
import sys

import montecarlo_pathtracing_tpu_torch as port

_CHECK = """
import importlib, sys
for name in sys.argv[1:]:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'montecarlo_pathtracing_tpu'))
assert not bad, bad
print(len(sys.argv) - 1)
"""


def _modules():
    names = [port.__name__]
    for info in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
        names.append(info.name)
    return names


def test_port_and_chip_smoke_import_no_jax():
    """Every module of the package, and chip_smoke.py, which drives the
    port alone, import without pulling in jax."""
    names = _modules()
    assert len(names) >= 20, names   # every module of the slice is listed
    root = os.path.dirname(os.path.dirname(os.path.abspath(port.__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _CHECK, *names, "chip_smoke"],
                         cwd=root, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str(len(names) + 1)
