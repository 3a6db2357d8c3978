"""Frontend ms a detection keyframe, one keyframe a tick: the span
(``trace.Spans``) around ``engine._process_keyframe`` (frontend, association
and landmark ingest), per call."""

READS = ("spans:frontend.keyframe",)


def read(rec):
    calls = rec.spans.get("frontend.keyframe", [])
    return 1e3 * rec.span_s("frontend.keyframe") / len(calls) if calls else None
