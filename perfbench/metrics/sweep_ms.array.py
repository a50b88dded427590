"""Host ms a step in the port's ``array.sweep`` span (the sequential
sweep over the devices of every array), over the steps of the window run
with the port's tracing on after the measured one, without the profiler."""


def read(records):
    s = records.get("array_spans")
    return 1e3 * s["sweep_s"] / s["steps"] if s else None
