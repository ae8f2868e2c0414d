"""Readings that a cell's check limits are set from, in one process:

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--controls 4,5,6] [--faults half_batch:7,8,9] [--out <file>]

For each of `--seeds`, the program's numbers (set-up with its check
steps, then the check against the plain reference, no window); for each
of `--controls`, the control's (the reference in fp8 in the program's
place); for each of `--bf16`, the reference's own in bf16 in the
program's place (a look at what the stated precision alone reads); for
each fault of ``lib/faults.py`` and its seeds, the numbers
of the program with that fault planted. One JSON line a reading, on
standard output and appended to `--out`.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, ".torch_kernels",
                                              "triton")


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def readings(workload: str, seeds=(), controls=(), faults=None,
             device: str = "cuda", root: str = ROOT, override=None,
             bf16=()):
    """Yields {"kind", "seed", "numbers", "details", "seconds"} for each
    reading; `override` replaces entries of the configuration (a look at
    a cause, such as the program in float32; "tf32": false turns TF32
    off for the program too)."""
    import torch

    from benchmark.lib import harness
    from benchmark.lib.faults import planted
    from benchmark.reference.resnet import bf16_round

    if override and override.get("tf32") is False:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    work, conf = harness.cell(workload, root)
    conf = {**conf, **(override or {})}
    Driver = harness.driver(work["driver"], root)

    def one(kind, seed, fn):
        t0 = time.perf_counter()
        d = Driver(seed=seed, device=device, config=conf,
                   params=work.get("params", {}))
        numbers = fn(d)
        details = getattr(d, "details", None)
        del d
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        return {"workload": workload, "kind": kind, "seed": seed,
                "numbers": numbers, "details": details,
                "override": override or None,
                "seconds": time.perf_counter() - t0}

    def program(d):
        d.setup()
        d.free()
        return d.check()

    def control(d):
        d.make_inputs()
        return d.control()

    for seed in seeds:
        yield one("program", seed, program)
    for seed in controls:
        yield one("control", seed, control)
    for seed in bf16:
        yield one("reference_bf16", seed,
                  lambda d: (d.make_inputs(), d.control(bf16_round))[1])
    for name, fault_seeds in (faults or {}).items():
        for seed in fault_seeds:
            with planted(name):
                yield one(name, seed, program)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--controls", default="")
    p.add_argument("--bf16", default="")
    p.add_argument("--faults", action="append", default=[],
                   help="name:seed,seed,...")
    p.add_argument("--override", default="{}",
                   help="JSON object of configuration entries to replace")
    p.add_argument("--out")
    a = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    faults = {f.split(":")[0]: _seeds(f.split(":")[1]) for f in a.faults}
    for r in readings(a.workload, _seeds(a.seeds), _seeds(a.controls),
                      faults, override=json.loads(a.override),
                      bf16=_seeds(a.bf16)):
        line = json.dumps(r)
        print(line, flush=True)
        if a.out:
            with open(a.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
