"""launches_per_pass: K1 and K2 launches per pass in the window, from the
program's launch counters (k1_launch.launches, k2_launch.launches),
summed over the cell's processes, over their passes. An exact count."""


def read(run):
    launches = sum(c["launches"] for c in run["cards"])
    passes = sum(c["passes"] for c in run["cards"])
    return launches / passes if launches and passes else None
