"""Share of the untraced window's cycles with nothing running on the card: 1 - device-busy
seconds a profiled cycle / the window's seconds a cycle."""

from portbench import readers


def read(run):
    return readers.device_idle(run)
