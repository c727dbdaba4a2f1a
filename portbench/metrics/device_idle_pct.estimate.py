"""Share of the traced sub-window in which no kernel, copy or memset ran on
the card: 100 (1 - busy / window), busy the union of the device intervals."""


def read(run):
    t = run.traced
    return None if t is None else 100.0 * (1.0 - t["busy_s"] / t["window_s"])
