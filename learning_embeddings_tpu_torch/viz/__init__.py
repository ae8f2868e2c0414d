"""Plots: the 2-D toy embedding (``toy.py``), the hierarchy embedding
with images (``hypernymy.py``) and the bottleneck2d head's analysis
(``contours.py``)."""
