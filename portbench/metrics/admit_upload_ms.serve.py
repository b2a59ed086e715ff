"""Host ms an admission step in the port's ``serve.admit.upload`` spans (frames, ids and masks
copied to the card), median over the profiled admission steps."""

from portbench import spans


def read(run):
    return spans.median_ms_below("serve.admit", "serve.admit.upload", need="serve.admit.program")
