"""k2_ms_per_pass: device milliseconds of K2 (csrc/bounce_kernel.cu, kernel
`fused_kernel`) per pass in the traced stretch, from torch.profiler's
kernel events by name; the mean over the cards."""

KERNEL = "fused_kernel"


def read(run):
    values = []
    for c in run["cards"]:
        t = c.get("trace")
        if not t or not t["passes"]:
            continue
        s = sum(v for k, v in t["kernel_s"].items() if KERNEL in k)
        if s > 0:
            values.append(s / t["passes"] * 1e3)
    return sum(values) / len(values) if values else None
