"""The engine and its drive loop on the host: the wall time of each
iteration's drive call (scheduling, accounting, the policy's call)
outside ``TorchBackend.execute``, averaged over the window (ms)."""


def read(run):
    its = run.iterations
    return 1e3 * sum(i.host_s for i in its) / len(its) if its else None
