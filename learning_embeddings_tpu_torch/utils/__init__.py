"""Utilities: profiling on ``torch.profiler`` (``profiling.py``), the
pinned, stream-ordered host → card copies (``staging.py``) and the
scalar-log reader and plot exporter (``tblog.py``)."""
