"""Host ms a step in the port's ``array.step`` span outside its
``array.sweep`` (decode, reward, observation, auto-reset), over the steps
of the window run with the port's tracing on, without the profiler."""


def read(records):
    s = records.get("array_spans")
    return 1e3 * (s["step_s"] - s["sweep_s"]) / s["steps"] if s else None
