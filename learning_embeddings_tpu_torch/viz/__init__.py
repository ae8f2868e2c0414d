"""Plots: the 2-D toy embedding (``toy.py``) and the bottleneck2d
head's label vectors (``contours.py``)."""
