"""The benchmark harness of montecarlo_pathtracing_tpu_torch.

`run.py` is the command; this package is its machinery, driven by the
files the workload's entry in BENCHMARK.json names: its configuration
(`configs/<config>.json`, with its scene `scenes/<scene>.json`), its
traffic mix (`traffic/<traffic>.json`), its limits (`limits/<workload>
.json`) and the per-layer metric readers (`metrics/<metric>.py`).
"""
