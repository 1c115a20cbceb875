"""The check fails what it must: each fault a cell can have, planted under
the window of a run driven as the benchmark drives it (the look for a
card skipped: the CPU runs the program's plain kernels), and the control,
the reference in bfloat16 in the program's place. A sound run passes."""
import numpy as np
import pytest
import torch

from portbench.harness import cell as cells, check, spec

SEED = 2 ** 31 + 99


@pytest.mark.parametrize("workload", ["c5_colonnes_batch", "c3_mesh_batch",
                                      "c5_colonnes_interactive"])
def test_a_sound_run_is_correct(tiny_root, workload):
    res = cells.run_cell(workload, SEED, 0.2, False, device="cpu",
                         root=tiny_root)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("workload", ["c5_colonnes_batch", "c3_mesh_batch",
                                      "c5_colonnes_interactive"])
def test_a_fault_under_the_window_fails_the_check(tiny_root, workload,
                                                  fault):
    res = cells.run_cell(workload, SEED, 0.2, False, device="cpu",
                         fault=fault, root=tiny_root)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("workload", ["c5_colonnes_batch", "c3_mesh_batch"])
def test_the_control_fails_the_check(tiny_root, workload):
    cell = spec.cell(workload, tiny_root)
    record = cells.single(cell, SEED, 0.2, False, "cpu", 0.0,
                          root=tiny_root)
    from portbench.harness import loop
    proj, view = loop.camera_of(cell["config"])
    low = check.reference_frames(record["desc"], cell["config"], proj, view,
                                 record["ys"], record["xs"],
                                 record["frames"], record["date"], "cpu",
                                 torch.bfloat16)
    record["frames"] = [(v, *f[1:]) for v, f in zip(low, record["frames"])]
    found = cells.compare(record, cell["config"], "cpu")
    ok, rows = check.judge(found, cell["limits"])
    assert not ok, rows
    assert np.isfinite(low).all()
