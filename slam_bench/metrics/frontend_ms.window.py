"""Frontend ms a keyframe in window ingest: the spans (``trace.Spans``)
around ``engine._process_keyframes_window`` and, for a run of one,
``engine._process_keyframe`` (frontend, association and landmark
ingest), summed over the window, per keyframe through them."""

READS = ("spans:frontend.window", "spans:frontend.keyframe")


def read(rec):
    win, one = rec.spans.get("frontend.window", []), rec.spans.get("frontend.keyframe", [])
    rows = sum(c["rows"] for c in win) + len(one)
    if not rows:
        return None
    return 1e3 * (rec.span_s("frontend.window") + rec.span_s("frontend.keyframe")) / rows
