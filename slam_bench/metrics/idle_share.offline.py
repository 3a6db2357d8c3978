"""The device's idle share of the traced window: 1 - the union of every
device operation's interval (kernels, copies, sets) / the window's length."""

READS = ("device_trace",)


def read(rec):
    return rec.idle_share()
