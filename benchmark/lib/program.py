"""Readings taken from the program's own state for the check, and the
device handling every driver shares."""

from __future__ import annotations

import sys
import time
from typing import Dict, Iterable, Tuple

import torch

class Stamps:
    """Logs on standard error the seconds each set-up phase took."""

    def __init__(self):
        self.last = time.perf_counter()

    def __call__(self, what: str) -> None:
        now = time.perf_counter()
        print(f"[setup] {what} {now - self.last:.3f} s", file=sys.stderr,
              flush=True)
        self.last = now


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


@torch.no_grad()
def first_grad_norms(named: Iterable[Tuple[str, torch.nn.Parameter]],
                     optimizer: torch.optim.Optimizer,
                     beta1: float = 0.9) -> Dict[str, float]:
    """The norm of each leaf's gradient as Adam got it at its first step,
    worked out from its state after that step (m₁ = (1 − β₁)·g₁); a leaf
    with no state reads 0."""
    out = {}
    for name, p in named:
        st = optimizer.state.get(p, {})
        m = st.get("exp_avg")
        out[name] = 0.0 if m is None else float(m.norm()) / (1 - beta1)
    return out


@torch.no_grad()
def change_norms(named: Iterable[Tuple[str, torch.nn.Parameter]],
                 start: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """‖leaf − its start‖ for each leaf."""
    return {name: float((p.detach().float() - start[name]).norm())
            for name, p in named}
