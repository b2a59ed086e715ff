"""Host ms of the window's server steps that admit, median."""

from portbench import readers


def read(run):
    return readers.host_median_ms(run, "admit")
