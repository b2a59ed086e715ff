"""Device ms a step inside the range around the trainer's gradient call."""

from portbench import readers


def read(run):
    return readers.device_ms_per_unit(run, "backward")
