"""One process per rank: ``run_ranks`` starts `world` Python processes,
each of which joins a ``torch.distributed`` process group (a ``FileStore``
in a directory the caller owns, so no TCP port is taken) and calls the
same function; it returns their results in rank order.

A rank that raises, exits or outlives the time limit fails the run: the
other ranks are killed (they would wait on a collective for ever) and
``RuntimeError`` carries the end of every rank's output. Nothing is
retried.

Run as ``python -m learning_embeddings_tpu_torch.parallel.launch <spec>
<rank>`` by ``run_ranks`` only.
"""

from __future__ import annotations

import datetime
import importlib
import os
import pickle
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional

__all__ = ["run_ranks"]

#: bytes of each rank's output that an error message quotes
_TAIL = 3000


def _tail(path: str) -> str:
    try:
        with open(path, "rb") as f:
            f.seek(max(os.path.getsize(path) - _TAIL, 0))
            return f.read().decode(errors="replace")
    except OSError as e:
        return f"<no output: {e}>"


def run_ranks(target: str, world: int, kwargs: Optional[Dict] = None, *,
              workdir: str, device: str = "cpu",
              backend: Optional[str] = None, timeout_s: float = 300.0,
              threads: Optional[int] = None) -> List[Any]:
    """Calls `target` ('package.module:function') with `kwargs` in `world`
    processes, after each has started its default process group (rank r of
    `world`; `backend` by default gloo on the CPU and for several ranks on
    one card, else NCCL; collectives time out after `timeout_s`). Rank r's
    device is card r % device count for ``device="cuda"``. `workdir` must
    be empty or new; it receives the store, the ranks' output
    (``rank{r}.log``, kept) and the pickled arguments and results (removed
    once read: they may hold whole models). `threads` caps each rank's
    intra-op threads. Returns the functions' return values in rank
    order."""
    from .mesh import default_backend

    os.makedirs(workdir, exist_ok=True)
    spec_path = os.path.join(workdir, "spec.pkl")
    spec = {"target": target, "world": world, "kwargs": kwargs or {},
            "store": os.path.join(workdir, "store"), "device": device,
            "backend": backend or default_backend(device, world),
            "timeout_s": timeout_s, "threads": threads}
    with open(spec_path, "wb") as f:
        pickle.dump(spec, f)
    # the ranks import this package from where this process did
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    path = os.environ.get("PYTHONPATH")
    child_env = dict(os.environ,
                     PYTHONPATH=root + (os.pathsep + path if path else ""))
    procs, logs = [], []
    deadline = time.monotonic() + timeout_s
    try:
        for r in range(world):
            log = os.path.join(workdir, f"rank{r}.log")
            logs.append(log)
            with open(log, "wb") as out:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", __name__, spec_path, str(r)],
                    stdout=out, stderr=subprocess.STDOUT, env=child_env))
        failed = None
        while failed is None and any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs)
                   if p.poll() not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited with {procs[bad[0]].poll()}"
            elif time.monotonic() > deadline:
                failed = f"the ranks ran past {timeout_s:.0f} s"
            else:
                time.sleep(0.05)
        if failed is None:
            bad = [r for r, p in enumerate(procs) if p.returncode != 0]
            if bad:
                failed = f"rank {bad[0]} exited with {procs[bad[0]].returncode}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        os.remove(spec_path)
    if failed is not None:
        tails = "\n".join(f"--- rank {r} ({logs[r]}) ---\n{_tail(logs[r])}"
                          for r in range(len(logs)))
        raise RuntimeError(f"run_ranks({target}, {world}): {failed}\n{tails}")
    out = []
    for r in range(world):
        path = os.path.join(workdir, f"result{r}.pkl")
        with open(path, "rb") as f:
            out.append(pickle.load(f))
        os.remove(path)
    return out


def _child(spec_path: str, rank: int) -> None:
    import torch
    import torch.distributed as dist

    from .mesh import mesh_device

    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    world = spec["world"]
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    if spec["threads"]:
        torch.set_num_threads(spec["threads"])
    if torch.device(spec["device"]).type == "cuda":
        torch.cuda.set_device(mesh_device(spec["device"]))
    store = dist.FileStore(spec["store"], world)
    dist.init_process_group(
        spec["backend"], store=store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=spec["timeout_s"]))
    module, _, name = spec["target"].partition(":")
    fn = getattr(importlib.import_module(module), name)
    result = fn(**spec["kwargs"])
    tmp = os.path.join(os.path.dirname(spec_path), f".result{rank}.pkl")
    with open(tmp, "wb") as f:
        pickle.dump(result, f)
    os.replace(tmp, os.path.join(os.path.dirname(spec_path),
                                 f"result{rank}.pkl"))
    dist.destroy_process_group()


if __name__ == "__main__":
    _child(sys.argv[1], int(sys.argv[2]))
