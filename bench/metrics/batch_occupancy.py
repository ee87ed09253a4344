"""The scheduler's batch: the rows of each decode iteration that carry a
request, over ``max_batch``, averaged over the window's decode
iterations (%)."""


def read(run):
    its = [i for i in run.iterations if i.rows]
    if not its:
        return None
    return 100.0 * sum(i.rows for i in its) / (len(its) * run.max_batch)
