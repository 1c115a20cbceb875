"""Intersection constants shared by the shape tests and the megakernel.

Only the constants of montecarlo_pathtracing_tpu/ops/intersect.py
(:34-61) are ported so far; the dense intersectors and folds are
ROADMAP item A.7.
"""
from __future__ import annotations

import numpy as np

EPSILON = np.float32(1e-10)
FLT_MAX = np.float32(3.402823e38)

# primitive type codes (raytracer_func.frag:38-43)
CODE_MESH = 0
CODE_SPHERE = 1
CODE_CUBE = 2
CODE_CYLINDER = 3
CODE_CONE = 4
CODE_ORIENTED_QUAD = 5
