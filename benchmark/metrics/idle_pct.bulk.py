"""idle_pct.bulk: the share of the traced slice in which no kernel, copy or
set ran on the device (the union of the profiler's device intervals), in
percent."""

from benchmark.harness.readers import idle_pct


def read(run):
    return idle_pct(run)
