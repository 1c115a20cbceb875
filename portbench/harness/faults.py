"""Faults planted under the window, for the harness's own tests: each
must make the check come out not correct.

  - `unchanged`: a pass returns the accumulator as it was;
  - `half`: every pass leaves out the second half of each tile's rays,
    and the image is resolved over the rest as if whole;
  - `altered`: every ray's radiance is off by 10% in red where the pass
    produces it.
"""
from __future__ import annotations


def plant(name: str, r) -> None:
    real = r._pass

    def unchanged(scene, accs, *rest):
        return None

    def half(scene, accs, dirs, tcs, *rest):
        def first(ts):
            return [t[:t.shape[0] // 2] for t in ts]
        real(scene, first(accs), first(dirs), first(tcs), *rest)

    def altered(scene, accs, *rest):
        before = [a.clone() for a in accs]
        real(scene, accs, *rest)
        for a, b in zip(accs, before):
            a[..., 0] += 0.1 * (a[..., 0] - b[..., 0])

    r._pass = {"unchanged": unchanged, "half": half,
               "altered": altered}[name]
