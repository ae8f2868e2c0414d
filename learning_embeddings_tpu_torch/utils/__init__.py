"""Utilities: profiling on ``torch.profiler`` (``profiling.py``) and the
scalar-log reader and plot exporter (``tblog.py``)."""
