"""The device's idle share of a racetrack step (lib/readers.idle_pct)."""

from perfbench.lib.readers import idle_pct as read  # noqa: F401
