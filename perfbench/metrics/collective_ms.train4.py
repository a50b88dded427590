"""Device ms a train step of the collectives (the gradient all-reduce of
each minibatch, the advantage statistics, the metrics), in the traced
window: for each collective the least time of its NCCL kernel over the
ranks. The rank that arrives last at a collective waits least, so this
is the transfer; the wait for the slowest rank is left out."""


def read(records):
    t = records.get("trace")
    if not t or not t["steps"] or t["collective_s"] <= 0.0:
        return None
    return 1e3 * t["collective_s"] / t["steps"]
