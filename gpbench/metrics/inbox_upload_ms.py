"""Device milliseconds of the inbox's copies to the card (with the device
app's descriptor upload): the program's CUDA-event timer
``tick_device_seconds{part="upload"}``, mean over the traced slice."""

from gpbench.spans import mean_ms


def read(ctx):
    return mean_ms("tick_device_seconds", driver="modea", plane="gpbench",
                   part="upload")
