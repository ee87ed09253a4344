"""The card's idle share of the traced window: the time in which no
kernel ran, over the window's length (%)."""


def read(run):
    tr = run.traced
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
