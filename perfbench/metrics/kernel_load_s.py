"""Seconds in the port's ``kernels.load`` span (``ops/_build.py``): the
kernel library's build, or its load from disk, and binding, once a process
at its first launch, which falls in set-up. The port records the span
whether or not its tracing is on."""

from perfbench.lib.program_spans import span_seconds


def read(records):
    return span_seconds("kernels.load")
