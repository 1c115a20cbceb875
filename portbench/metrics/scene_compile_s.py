"""scene_compile_s: host seconds of the program's compile_scene, from the
benchmark's span around it; the mean over the cell's processes."""


def read(run):
    spans = [c["spans"]["scene_compile"] for c in run["cards"]]
    values = [s for per in spans for s in per]
    return sum(values) / len(values) if values else None
