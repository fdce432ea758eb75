"""Mean host milliseconds a request waits in the manager from admission to
its placement into a tick's inbox: the program's
``request_wait_seconds{stage="queue"}`` over the traced slice."""

from gpbench.spans import mean_ms


def read(ctx):
    return mean_ms("request_wait_seconds", plane="gpbench", stage="queue")
