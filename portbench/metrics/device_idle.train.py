"""Share of the untraced window's steps with nothing running on the card: 1 - device-busy
seconds a profiled step / the window's seconds a step."""

from portbench import readers


def read(run):
    return readers.device_idle(run)
