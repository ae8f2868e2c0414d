"""Faults planted in the program beside those of ``faults.py``, which the
checks of the cells that came after it have to catch; each patches a
method of the program for as long as its context is open. Used by the
benchmark's tests on the CPU and, through

    python3 -m benchmark.lib.cell_faults <calibrate.py's arguments>

by ``calibrate.py`` on the card (``--faults no_shift_mask:7,8``), never
by a run. The names of ``faults.py`` are planted by it.

* ``no_shift_mask`` (the Swin cell): the shifted blocks attend across
  the regions that the roll brought together (M left out of B + M in
  ``models/swin.py::ShiftedWindowAttention.bias``).
* ``no_relative_bias`` (the Swin cell): the learned relative-position
  bias left out (B left out of B + M); the tables take no gradient.
"""

from __future__ import annotations

import contextlib
import sys

import torch

from . import faults

#: ``faults.py``'s own, kept before ``__main__`` puts ``planted`` in its
#: place for ``calibrate.py``
_planted = faults.planted

CELL_FAULTS = ("no_shift_mask", "no_relative_bias")
FAULTS = faults.FAULTS + CELL_FAULTS


def _no_shift_mask(orig):
    def bias(self, mask, n_windows):
        return orig(self, None, n_windows)
    return bias


def _no_relative_bias(orig):
    def bias(self, mask, n_windows):
        N = self.window ** 2
        table = self.relative_position_bias_table
        b = torch.zeros(n_windows, self.heads, N, N, device=table.device)
        if mask is not None:
            b = b + mask.unsqueeze(1)
        return b.reshape(1, n_windows * self.heads, N, N)
    return bias


@contextlib.contextmanager
def planted(name: str):
    if name not in CELL_FAULTS:
        with _planted(name):
            yield
        return
    from learning_embeddings_tpu_torch.models.swin import \
        ShiftedWindowAttention

    make = {"no_shift_mask": _no_shift_mask,
            "no_relative_bias": _no_relative_bias}[name]
    orig = ShiftedWindowAttention.bias
    ShiftedWindowAttention.bias = make(orig)
    try:
        yield
    finally:
        ShiftedWindowAttention.bias = orig


if __name__ == "__main__":
    from benchmark import calibrate

    faults.planted = planted
    sys.exit(calibrate.main())
