"""Host ms a tick in the processor and placement calls of FastVLAPolicy.forward, median over the window."""

from portbench import readers


def read(run):
    return readers.host_median_ms(run, "prep")
