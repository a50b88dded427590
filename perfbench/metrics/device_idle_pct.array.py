"""The device's idle share of an array step (lib/readers.idle_pct)."""

from perfbench.lib.readers import idle_pct as read  # noqa: F401
