"""Device ms a train step: the seconds in which the card ran the step's
kernels (the union of its device events, NCCL's left out and averaged
over the ranks), plus each collective's least NCCL kernel time over the
ranks (its transfer, without the wait for the slowest rank), over the
train steps traced after the window. Host gaps between launches are not
in it: the window's rate, which they set, is the per-layer
``train_env_steps_per_s.window``."""


def read(records):
    t = records.get("busy") or records.get("trace")
    if not t or not t["steps"]:
        return None
    ms = 1e3 * (t["work_s"] + t["collective_s"]) / t["steps"]
    return ms if ms > 0.0 else None
