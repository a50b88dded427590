"""The 95th percentile of a step with its host read, over every step of
the window, by the host clock."""

from perfbench.lib.readers import percentile


def read(records):
    return percentile(records["step_ms"], 95.0)
