"""``call_ms_p95`` of the traced window in the per-step cell, where the
card idles about half the window and the host paces each call: a reading
of the host, with no bound."""

from benchmark.harness import metric_reader

read = metric_reader("call_ms_p95")
