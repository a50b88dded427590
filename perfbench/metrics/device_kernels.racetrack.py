"""Device events (kernels, copies, fills) a step in the traced window: what
a fused racetrack step would cut."""


def read(records):
    t = records.get("trace")
    if not t or not t["steps"] or not t["device_events"]:
        return None
    return t["device_events"] / t["steps"]
