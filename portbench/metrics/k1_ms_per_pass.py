"""k1_ms_per_pass: device milliseconds of K1 (csrc/megakernel.cu, kernel
`mega_kernel`) per pass in the traced stretch, from torch.profiler's
kernel events by name; the mean over the cards."""

KERNEL = "mega_kernel"


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
