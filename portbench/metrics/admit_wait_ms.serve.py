"""Host ms an admission step in the port's ``serve.admit.prefill``, ``.scatter`` and ``.fetch``
spans (the tower and prefill enqueued, the pages written, the first tokens and masks copied to the
host): the host's wait on the card's admission work, in whichever of the three a synchronising copy
holds it, median over the profiled admission steps."""

from portbench import spans


def read(run):
    return spans.median_ms_below("serve.admit", ("serve.admit.prefill", "serve.admit.scatter", "serve.admit.fetch"),
                                 need="serve.admit.program")
