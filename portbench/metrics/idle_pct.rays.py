"""idle_pct: the share of a pass's time in which the card ran no
operation: 100 x (1 - device busy seconds a pass / untraced seconds a
pass). Busy is the union of the profiler's device intervals over the
device stretch's passes; the time a pass is the same run's untraced
steps' (a profiler slows the host, so the traced stretch's own length
would overstate the idle share)."""


def read(run):
    values = []
    for c in run["cards"]:
        t = c.get("trace")
        if t and t["busy_s"] > 0 and t["passes"] and t.get(
                "untraced_s_per_pass"):
            busy = t["busy_s"] / t["passes"]
            values.append(100.0 * (1.0 - busy / t["untraced_s_per_pass"]))
    return sum(values) / len(values) if values else None
