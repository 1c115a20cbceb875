"""The seed decides the inputs, and only the inputs."""
import numpy as np

from portbench.harness import check, loop, spec


def _cell(name, root=spec.ROOT):
    c = spec.cell(name, root)
    return c["config"], c["traffic"]


def test_one_seed_gives_the_same_inputs_twice(tiny_root):
    for name in ("c5_colonnes_batch", "c5_colonnes_interactive",
                 "c3_mesh_batch"):
        cfg, traffic = _cell(name, tiny_root)
        seed = 2 ** 31 + 12345
        assert loop.inputs(seed, cfg, traffic) == loop.inputs(seed, cfg,
                                                               traffic)
        a = check.sample(seed, cfg["width"], cfg["height"], 2048)
        b = check.sample(seed, cfg["width"], cfg["height"], 2048)
        assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_two_seeds_give_different_inputs(tiny_root):
    cfg, traffic = _cell("c5_colonnes_batch")
    a, b = loop.inputs(1, cfg, traffic), loop.inputs(2, cfg, traffic)
    assert a["date"] != b["date"] and a["first_pass"] != b["first_pass"]
    sa = check.sample(1, cfg["width"], cfg["height"], 2048)
    sb = check.sample(2, cfg["width"], cfg["height"], 2048)
    assert not np.array_equal(sa[1], sb[1])
    cfg, traffic = _cell("c5_colonnes_interactive", tiny_root)
    phases = {loop.inputs(s, cfg, traffic)["reset_phase"] for s in range(8)}
    assert len(phases) > 1


def test_the_seed_moves_only_what_the_traffic_names(tiny_root):
    cfg, traffic = _cell("c5_colonnes_interactive", tiny_root)
    assert {loop.inputs(s, cfg, traffic)["first_pass"]
            for s in range(8)} == {0}
    cfg, traffic = _cell("c3_mesh_batch")
    ins = [loop.inputs(s, cfg, traffic) for s in range(8)]
    assert {i["reset_phase"] for i in ins} == {0}
    assert len({i["first_pass"] for i in ins}) > 1
    assert len({i["date"] for i in ins}) > 1


def test_the_sample_is_distinct_pixels_inside_the_image():
    ys, xs = check.sample(99, 1920, 1080, 2048)
    assert len(set(zip(ys.tolist(), xs.tolist()))) == 2048
    assert ys.max() < 1080 and xs.max() < 1920 and ys.min() >= 0
