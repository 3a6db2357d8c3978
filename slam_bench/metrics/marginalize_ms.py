"""ms a marginalization: the span (``trace.Spans``) around
``fixed_lag.marginalize``, per call in the window."""

READS = ("spans:marginalize",)


def read(rec):
    calls = rec.spans.get("marginalize", [])
    return 1e3 * rec.span_s("marginalize") / len(calls) if calls else None
