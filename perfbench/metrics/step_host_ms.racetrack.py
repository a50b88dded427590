"""Host ms a step in the port's ``racetrack.step`` span (on the card a
graph's replay: the inputs' copies, the keys, the replay, the outputs'
clones and views), over the steps of the window run with the port's tracing
on after the measured one, without the profiler."""


def read(records):
    s = records.get("racetrack_spans")
    return 1e3 * s["step_s"] / s["steps"] if s else None
