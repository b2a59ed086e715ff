"""Share of the untraced window's ticks with nothing running on the card: 1 - device-busy
seconds a profiled tick / the window's seconds a tick."""

from portbench import readers


def read(run):
    return readers.device_idle(run)
