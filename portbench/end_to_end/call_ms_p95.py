"""call_ms_p95 (ms): the 95th percentile of the wall time of every call in
the window, each from before the call to after the synchronisation that
ends it (host clock)."""

from portbench.accounting import percentile


def read(w):
    return percentile(w.call_seconds, 95.0) * 1e3
