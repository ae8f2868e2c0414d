"""Utilities: profiling on ``torch.profiler`` (``profiling.py``)."""
