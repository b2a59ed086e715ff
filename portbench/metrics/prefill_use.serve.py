"""Per cent of the positions the profiled admission programs computed that were real: image
tokens and real prompt tokens, over program rows (padding rows included) x (image tokens +
bucket); the port's counters ``serve.admit.positions`` and ``serve.admit.positions_computed``."""

from portbench import spans


def read(run):
    counts = spans.recorded()[1]
    computed = counts.get("serve.admit.positions_computed")
    return 100.0 * counts.get("serve.admit.positions", 0) / computed if computed else None
