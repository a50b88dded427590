"""Device models: parameter dataclasses and per-type physics functions.

PyTorch counterpart of ``spintorque_tpu/devices``; the factory and the
switching analytics are not ported yet.
"""

from .params import (
    DEVICE_TYPES,
    DeviceParams,
    default_device_dict,
    make_device_params,
    validate_device_dict,
)
from .resistance import pulse_energy, resistance

__all__ = [
    "DEVICE_TYPES",
    "DeviceParams",
    "default_device_dict",
    "make_device_params",
    "validate_device_dict",
    "pulse_energy",
    "resistance",
]
