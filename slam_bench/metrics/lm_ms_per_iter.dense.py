"""ms an LM iteration: the span (``trace.Spans``) around
``engine._optimize_tick`` (the solve, its marginals and the table sync),
summed over the window, over the LM iterations the engine's
``stats_history`` counts for the window's optimizing ticks."""

READS = ("spans:optimize", "program_counter:stats_history")


def read(rec):
    iters = sum(t["iters"] for t in rec.optimizing_ticks())
    return 1e3 * rec.span_s("optimize") / iters if iters else None
