"""Device ms a tick inside the range around the Qwen2 decoder's forward."""

from portbench import readers


def read(run):
    return readers.device_ms_per_unit(run, "decoder")
