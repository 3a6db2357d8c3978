"""K5's share of its roofline in the window, a keyframe a tick (%): see
``Record.k5_share``."""

READS = ("device_trace", "spans:segment")


def read(rec):
    return rec.k5_share()
