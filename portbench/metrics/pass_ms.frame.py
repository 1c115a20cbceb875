"""pass_ms.frame: the median over the window's frames of the benchmark's
host-clock span around each frame's Renderer.advance (the pass and its
synchronise), in milliseconds."""
import statistics


def read(run):
    spans = run["cards"][0]["spans"].get("pass")
    return statistics.median(spans) * 1e3 if spans else None
