"""The trace digest on a synthetic timeline."""
import pytest
from torch.autograd import DeviceType

from portbench.harness import trace

CPU, CUDA = DeviceType.CPU, DeviceType.CUDA


def test_busy_kernels_and_idle_gaps_by_host_activity():
    events = [
        ("pb.window", CPU, 0.0, 100.0, 1, True),
        ("pb.advance", CPU, 0.0, 100.0, 1, True),
        ("pb.advance", CUDA, 0.0, 100.0, 0, True),      # an annotation
        ("aten::where", CPU, 20.0, 30.0, 1, False),
        ("aten::copy_", CPU, 50.0, 90.0, 1, False),
        ("cudaLaunchKernel", CPU, 60.0, 61.0, 1, False),
        ("aten::zeros", CPU, 5.0, 6.0, 2, False),       # another thread
        ("mega_kernel<true>", CUDA, 10.0, 20.0, 0, False),
        ("mega_kernel<true>", CUDA, 15.0, 18.0, 0, False),  # overlaps
        ("Memcpy DtoH", CUDA, 30.0, 40.0, 0, False),
        ("fused_kernel", CUDA, 95.0, 120.0, 0, False),  # ends past it
    ]
    d = trace.digest(events, passes=4)
    assert d["window_s"] == pytest.approx(100e-6)
    # [10, 20] + [30, 40] + [95, 100]
    assert d["busy_s"] == pytest.approx(25e-6)
    assert d["kernel_s"]["mega_kernel<true>"] == pytest.approx(13e-6)
    assert d["passes"] == 4
    gaps = dict(d["idle_gaps"])
    # gaps [0, 10] and [40, 95] (midpoint 67.5 in aten::copy_), [20, 30]
    assert gaps["pb.advance"] == pytest.approx(10e-6)
    assert gaps["pb.advance > aten::where"] == pytest.approx(10e-6)
    assert gaps["pb.advance > aten::copy_"] == pytest.approx(55e-6)
    assert d["device_ops"][0][0] == "mega_kernel<true>"


def test_a_trace_without_its_window_is_an_error():
    with pytest.raises(RuntimeError):
        trace.digest([("aten::add", CPU, 0.0, 1.0, 1, False)], passes=1)


def test_the_device_stretch_is_its_device_work_over_its_host_length():
    events = [
        ("cudaLaunchKernel", CPU, 1.0, 2.0, 1, False),  # host: not work
        ("pb.advance", CUDA, 0.0, 50.0, 0, True),       # an annotation
        ("mega_kernel<true>", CUDA, 10.0, 20.0, 0, False),
        ("mega_kernel<true>", CUDA, 15.0, 25.0, 0, False),  # overlaps
        ("Memcpy DtoH", CUDA, 30.0, 40.0, 0, False),
    ]
    d = trace.device_digest(events, window_s=100e-6, passes=8)
    assert d["window_s"] == 100e-6 and d["passes"] == 8
    # [10, 25] + [30, 40]
    assert d["busy_s"] == pytest.approx(25e-6)
    assert d["kernel_s"] == pytest.approx({"mega_kernel<true>": 20e-6,
                                           "Memcpy DtoH": 10e-6})
    assert d["device_ops"][0] == ["mega_kernel<true>", pytest.approx(20e-6)]


@pytest.mark.parametrize("name", ["idle_pct.rays", "idle_pct.frame"])
def test_idle_is_busy_a_pass_against_an_untraced_pass(name):
    from portbench.harness import spec
    read = spec.metric_reader(name)
    t = {"busy_s": 0.5, "passes": 8, "window_s": 10.0,
         "untraced_s_per_pass": 0.625}
    # 0.0625 s busy of a 0.625 s pass; the stretch's own 10 s is not used
    assert read({"cards": [{"trace": t}]}) == pytest.approx(90.0)
    assert read({"cards": [{"trace": dict(t, untraced_s_per_pass=None)}]
                 }) is None
