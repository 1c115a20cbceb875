"""resolve_ms.frame: the median over the window's frames of the
benchmark's host-clock span around each frame's Renderer.image(), in
milliseconds."""
import statistics


def read(run):
    spans = run["cards"][0]["spans"].get("resolve")
    return statistics.median(spans) * 1e3 if spans else None
