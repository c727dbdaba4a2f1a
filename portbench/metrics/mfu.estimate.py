"""The whole estimate's share of the card's peak: the network's operations
for every estimate the window ran (``counts/flops.py``, from shapes) over
the window's length, against the peak of the cell's compute dtype
(``counts/peaks.py``)."""

from portbench.counts.peaks import FLOPS_PER_S


def read(run):
    return 100.0 * run.counts["flops"] / run.window_s / FLOPS_PER_S[run.counts["dtype"]]
