"""Utilities: phase timers and the profiler trace context."""
