"""Device ms a tick inside the range around FastVLM.encode_images (FastViTHD and the projector)."""

from portbench import readers


def read(run):
    return readers.device_ms_per_unit(run, "tower")
