"""Utilities: phase timers, the profiler trace context, and synthetic
fault trees (``synthetic.py``, vendored from the JAX package)."""
