"""The backend's decode step: the median of ``TorchBackend
.decode_wall_s`` (the wall time of a decode-only iteration, one graph
replay between two synchronisations) over the window (ms)."""
import statistics


def read(run):
    w = run.decode_walls
    return 1e3 * statistics.median(w) if w else None
