"""Plots: the 2-D toy embedding (``toy.py``)."""
