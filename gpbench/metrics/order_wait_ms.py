"""Mean host milliseconds from a request's placement into an inbox to the
release of its response to the client (decision, execution and, with a
journal, the fsync): the program's ``request_wait_seconds{stage="order"}``
over the traced slice."""

from gpbench.spans import mean_ms


def read(ctx):
    return mean_ms("request_wait_seconds", plane="gpbench", stage="order")
