"""The benchmark of learning_embeddings_tpu_torch on NVIDIA cards.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

One run: set-up (imports, the card, the cell's inputs and weights from
the seed, the program, its first steps for the check, warm-up of every
shape the window uses), then a window of `--seconds` of the cell's work
ending in a synchronise, then the check against the plain reference
(``benchmark/reference/``). The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``; with ``--trace 1`` its per-layer
metrics: those of device time read from a part at the window's end
profiled on the card, those of the host clock from the rest), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number
compared with its limit, which also end standard error.

It exits non-zero, with no result, where no card is found (it never runs
on the CPU), where the cell needs more cards than there are, and where
the JAX package or JAX itself was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# every build and kernel cache of the program stays in the checkout, at a
# fixed path, so that only a checkout's first run compiles
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, ".torch_kernels",
                                              "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, ".torch_kernels",
                                                  "extensions")

#: top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "learning_embeddings_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, device: str = "cuda", root: str = ROOT) -> int:
    """One run; `device` other than 'cuda' skips the look for a card (the
    benchmark's own tests drive the rest of a run on the CPU, with the
    cells of `root`)."""
    args = parse(argv)
    import torch

    from benchmark.lib import check, harness, trace

    work, conf = harness.cell(args.workload, root)
    chips = int(work.get("chips", 1))
    if device == "cuda":
        if not torch.cuda.is_available():
            log("no CUDA card: the benchmark runs only on the card")
            return 3
        if torch.cuda.device_count() < chips:
            log(f"the cell needs {chips} cards, "
                f"{torch.cuda.device_count()} found")
            return 3
    e2e, per_layer = harness.cell_metrics(args.workload, root)
    log(f"[setup] process start to the driver "
        f"{time.perf_counter() - T0:.3f} s")
    drv = harness.driver(work["driver"], root)(
        seed=args.seed, device=device, config=conf,
        params=work.get("params", {}))
    drv.setup()
    if device == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T0
    log(f"[run] {args.workload} seed {args.seed}: set-up {setup_s:.3f} s")

    # the window; with --trace 1 its last `trace_seconds` (at most half of
    # it) run under the profiler, which records the card's activity alone.
    # The per-layer metrics of device time read that traced part; those of
    # the host clock read the untraced part before it, which the profiler
    # does not slow
    traced = (min(float(work["params"].get("trace_seconds", args.seconds)),
                  args.seconds / 2) if args.trace else 0.0)
    drv.window_start()
    t0 = time.perf_counter()
    units = 0
    while time.perf_counter() - t0 < args.seconds - traced:
        units += drv.step()
    prof = None
    if args.trace:
        from torch.profiler import ProfilerActivity, profile
        if device == "cuda":
            torch.cuda.synchronize()
        host = dict(drv.info(), window_s=time.perf_counter() - t0)
        log(f"[run] untraced part: {host['window_s']:.3f} s, "
            f"{host['steps']} steps")
        prof = profile(activities=[ProfilerActivity.CUDA if device == "cuda"
                                   else ProfilerActivity.CPU])
        prof.__enter__()
        drv.trace_start()
        t_traced = time.perf_counter()
        while time.perf_counter() - t_traced < traced:
            units += drv.step()
    drv.finish()
    if device == "cuda":
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    if prof is not None:
        traced_s = time.perf_counter() - t_traced
        prof.__exit__(None, None, None)
    peak = (torch.cuda.max_memory_allocated() if device == "cuda" else 0)
    failed = drv.failed()
    log(f"[run] window {window_s:.3f} s, {units} {drv.unit}, "
        f"{failed} failed, peak {peak} bytes")

    result = {"correct": False, "attempted": int(units),
              "failed": int(failed), "metrics": {}, "device": {
                  "platform": "gpu" if device == "cuda" else device,
                  "kind": (torch.cuda.get_device_name(0)
                           if device == "cuda" else device),
                  "count": chips, "memory_peak_bytes": int(peak)}}
    if args.trace:
        t_trace = time.perf_counter()
        win = trace.from_profiler(prof, traced_s)
        prof = None
        log(f"[run] trace: {traced_s:.3f} s traced, {len(win.ops)} device "
            f"ops, {len(win.host)} host ranges, read in "
            f"{time.perf_counter() - t_trace:.3f} s")
        info = dict(drv.info(), host=host)
        log(f"[run] traced part: {traced_s:.3f} s, {info['steps']} steps")
        for m in per_layer:
            value = harness.metric(m["name"], root).read(win, info)
            if value is not None:
                result["metrics"][m["name"]] = {"value": float(value),
                                                "unit": m["unit"]}
        result["device"]["busy_s"] = win.busy_s
        result["device"]["window_s"] = win.window_s
        result["breakdown"] = win.breakdown()
        del win
    else:
        rates = drv.rates(window_s, units)
        for m in e2e:
            if m["name"] == "setup_s":
                result["metrics"]["setup_s"] = {"value": setup_s,
                                                "unit": "s"}
            elif m["name"] in rates:
                result["metrics"][m["name"]] = {"value": rates[m["name"]],
                                                "unit": m["unit"]}
    if device == "cuda":
        log(f"[run] card: {card_limit()}")

    # the check: after the peak was read, with the program's state freed
    drv.free()
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = check.entries(drv.check(), work["check"])
    log(f"[run] check {time.perf_counter() - t_check:.3f} s")
    result["correct"] = check.passed(checks) and failed == 0
    result["checks"] = {c["name"]: {"value": c["value"],
                                    "limit": c["limit"]} for c in checks}

    bad = forbidden_modules()
    if bad:
        log(f"[run] forbidden modules were loaded: {bad}")
        return 4
    for c in checks:
        ok = math.isfinite(c["value"]) and c["value"] <= c["limit"]
        log(f"check {c['name']} {c['value']!r} limit {c['limit']!r} "
            f"{'ok' if ok else 'FAILED'}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
