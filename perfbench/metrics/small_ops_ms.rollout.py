"""Device ms a step of every device event other than pulse_kernel (the
step's glue: decode, energy, observation, reward, reset), in the traced
window."""


def read(records):
    t = records.get("trace")
    if not t or not t["steps"] or t["busy_s"] <= 0.0:
        return None
    return 1e3 * t["other_device_s"] / t["steps"]
