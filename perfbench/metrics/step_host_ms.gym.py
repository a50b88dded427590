"""Host ms of env.step until it returns, before the read, averaged over
every step of the window: the benchmark's own span, by the host clock."""


def read(records):
    ms = records.get("env_step_ms")
    return sum(ms) / len(ms) if ms else None
