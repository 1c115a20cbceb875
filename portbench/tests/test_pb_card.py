"""On a card: the benchmark refuses to give a result where the program is
missing (a directory that holds only BENCHMARK.json and portbench/)."""
import os
import shutil
import subprocess
import sys

import pytest

from portbench.harness import spec


@pytest.mark.card
def test_a_checkout_without_the_program_gives_no_result(card, tmp_path):
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "c3_mesh_batch",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
