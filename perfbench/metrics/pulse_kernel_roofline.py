"""pulse_kernel's share of its roofline: the traced pulses' frozen
operations and bytes (perfbench/roofline/llgs.py) at the published peak,
over the device time of the traced pulse_kernel launches."""

from perfbench.lib.readers import pulse_roofline_pct as read  # noqa: F401
