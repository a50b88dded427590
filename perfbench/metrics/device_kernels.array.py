"""Device events (kernels, copies, fills) a step in the traced window; the
run notes the port's ``array.device_updates`` a step beside it."""


def read(records):
    t = records.get("trace")
    if not t or not t["steps"] or not t["device_events"]:
        return None
    return t["device_events"] / t["steps"]
