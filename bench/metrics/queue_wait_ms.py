"""The scheduler's queue: from a request's arrival to its first
scheduling, on the engine's clock, averaged over the requests that
arrived in the window; one never scheduled counts its wait to the
window's end (ms)."""


def read(run):
    loop = run.loop
    waits = [(r.first_scheduled_time if r.first_scheduled_time is not None
              else loop.clock1) - r.arrival_time
             for r in loop.window_requests()]
    return 1e3 * sum(waits) / len(waits) if waits else None
