"""Telemetry of the port: the per-query device profiler capture
(profiler.py).  The reference's span / metric export, the query history
store and the OTLP conversion are not ported yet."""
from .profiler import profile_capture

__all__ = ["profile_capture"]
