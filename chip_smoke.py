#!/usr/bin/env python3
"""Smoke run of the PyTorch port (learning_embeddings_tpu_torch) on one
NVIDIA card.

Usage, from the root of a checkout:   python3 chip_smoke.py [--batch N]
(default batch 128, the JAX bench's)

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. device   the card's name and power limit (nvidia-smi), torch, CUDA and
            Triton versions.
2. kernels  builds the Triton kernels of the slice from the sources in the
            checkout and holds each against its plain PyTorch version on
            the card: at the 12 BatchNorm (R, C) shapes of ResNet-50@448
            (R × batch) and one ragged shape, on integer-valued bf16 inputs
            (the sums are exact in f32: no difference is allowed) and on
            normal bf16 inputs (|kernel − plain| ≤ 1e-5·Σ|terms| + 1e-6);
            then batch_norm_train's forward and backward on the card
            against the CPU path, and one small ResNet-50 train step on the
            card against the CPU.
3. slice    the main path: ClassifierTrainer(resnet50, multi_level_ce,
            adam, lr 1e-5, 448², bn_impl='pallas', bf16 trunk) on the
            taxonomy of entry.ethec_labelmap(), synthetic uint8 NHWC images
            from a seeded generator; 2 warm-up and 5 timed steps.
            Asserts finite losses, 53 launches of each kernel per step, and
            no channels_last copy.
4. measure  ms/step, images/s, peak memory; the profiler's device time of
            each kernel per step and the device's busy share; and, for
            one step's 53 launches of each kernel, the kernel's time, its
            plain version's, the library call's (torch.batch_norm_stats /
            torch.batch_norm_backward_reduce) and the bound.

The line before the last is the card's nvidia-smi name and power limit;
the last is {"ok": true, "device": {...}}. A `kernels` JSON line and the
details go before them, and the details also to
chiprun_out/chip_smoke.json.
"""

import argparse
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
DEV = "cuda"

#: H100 SXM data-sheet peaks (dense): HBM bytes/s and f32 (non-tensor) flop/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

#: per-image (R, C) of the 53 train-mode BatchNorm layers of ResNet-50 at
#: 448², with how many layers have each shape
RESNET50_448_BN = {
    (50176, 64): 1, (12544, 64): 6, (12544, 128): 1, (12544, 256): 4,
    (3136, 128): 7, (3136, 256): 1, (3136, 512): 5, (784, 256): 11,
    (784, 512): 1, (784, 1024): 7, (196, 512): 5, (196, 2048): 4,
}
RAGGED = (12345, 100)
KERNEL_SRC = "learning_embeddings_tpu_torch/ops/bn_triton.py"
TPU_KERNELS = {"bn_stats": "learning_embeddings_tpu/ops/bn_pallas.py:52",
               "bn_corr": "learning_embeddings_tpu/ops/bn_pallas.py:64"}


def log(*a):
    print(*a, flush=True)


# --------------------------------------------------------------------------
# phase 1: device
# --------------------------------------------------------------------------
def require_card_and_checkout():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA card is available")
    sys.path.insert(0, HERE)
    import learning_embeddings_tpu_torch as port

    if os.path.dirname(os.path.dirname(os.path.abspath(port.__file__))) \
            != HERE:
        raise SystemExit(f"chip_smoke: the port was imported from "
                         f"{port.__file__}, not from this checkout")


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def device_phase():
    import torch
    import triton

    smi = smi_line()
    log(f"[device] {smi}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"triton {triton.__version__} python {sys.version.split()[0]}")
    props = torch.cuda.get_device_properties(0)
    log(f"[device] {props.name}: {props.multi_processor_count} SMs, "
        f"{props.total_memory / 2**30:.1f} GiB")
    return smi


# --------------------------------------------------------------------------
# timing
# --------------------------------------------------------------------------
def cuda_ms(fn, inputs, iters=20):
    """Mean ms per call of fn(*inputs[i % n]) over `iters` eager calls,
    host launch cost included, cycling through input copies that together
    exceed the 50 MB L2 cache."""
    import torch

    for i in range(2):
        fn(*inputs[i % len(inputs)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*inputs[i % len(inputs)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, inputs, iters=20):
    """Device ms per call of fn, without the host's launch cost: `iters`
    calls (cycling through the input copies) captured in one CUDA graph,
    replayed between two events."""
    import torch

    for i in range(2):
        fn(*inputs[i % len(inputs)])
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*inputs[i % len(inputs)])
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def n_copies(nbytes):
    return max(2, min(16, -(-150_000_000 // nbytes)))


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------
def check_reduction(name, kernel_fn, plain_fn, library_fn, R, C, n_in, gen):
    """Integer-valued (exact) and normal bf16 inputs; returns the max abs
    error on the normal ones and the device times of the kernel, its plain
    version and the library call, and the kernel's eager time (host launch
    cost included)."""
    import torch

    dev = DEV
    # entries in {-1, 0, 1}: every partial sum is an integer below 2^24,
    # so both sides sum exactly in f32 whatever their order
    ints = [torch.randint(-1, 2, (R, C), device=dev, generator=gen)
            .to(torch.bfloat16) for _ in range(n_in)]
    got = kernel_fn(*ints)
    exact = plain_fn(*ints)
    for g, e in zip(got, exact):
        if not torch.equal(g, e):
            bad = (g - e).abs().max().item()
            raise AssertionError(f"{name} {(R, C)}: integer sums differ "
                                 f"from the exact ones by {bad}")

    xs = [torch.randn((R, C), device=dev, generator=gen)
          .to(torch.bfloat16) for _ in range(n_in)]
    got = kernel_fn(*xs)
    ref = plain_fn(*xs)
    mag = plain_fn(*[t.float().abs() for t in xs])   # Σ|terms|
    err = 0.0
    for g, r, m in zip(got, ref, mag):
        diff = (g - r).abs()
        if not bool((diff <= 1e-5 * m + 1e-6).all()):
            raise AssertionError(
                f"{name} {(R, C)}: kernel and plain version differ by "
                f"{diff.max().item()} (tolerance 1e-5·Σ|terms| + 1e-6)")
        err = max(err, diff.max().item())

    copies = [[torch.randn((R, C), device=dev, generator=gen)
               .to(torch.bfloat16) for _ in range(n_in)]
              for _ in range(n_copies(R * C * 2 * n_in))]
    times = {"ms": device_ms(kernel_fn, copies),
             "plain_ms": device_ms(plain_fn, copies),
             "library_ms": device_ms(library_fn, copies),
             "eager_ms": cuda_ms(kernel_fn, copies)}
    return err, times


def kernels_phase(batch):
    import torch

    from learning_embeddings_tpu_torch.ops import bn, bn_triton

    gen = torch.Generator(device=DEV).manual_seed(0)

    def hw(R):
        side = int(round(R ** 0.5))
        return (side, R // side) if side * (R // side) == R else (1, R)

    def as4d(x2, R):
        """(R·B, C) rows → the NCHW channels_last tensor they view."""
        h, w = hw(R)
        return x2.view(-1, h, w, x2.shape[1]).permute(0, 3, 1, 2)

    rows = []
    for (R, C), mult in list(RESNET50_448_BN.items()) + [(RAGGED, 0)]:
        Rb = R * batch if mult else R

        def lib_stats(x2, R=R):
            return torch.batch_norm_stats(as4d(x2, R), 1e-5)

        ones = torch.ones(C, device=DEV)
        zeros = torch.zeros(C, device=DEV)

        def lib_corr(dy2, x2, R=R):
            return torch.batch_norm_backward_reduce(
                as4d(dy2, R), as4d(x2, R), zeros, ones, ones,
                True, False, False)[:2]

        row = {"R": Rb, "C": C, "layers": mult}
        for name, kfn, pfn, lfn, n_in in (
                ("bn_stats", bn_triton.bn_stats, bn._stats_plain, lib_stats,
                 1),
                ("bn_corr", bn_triton.bn_corr, bn._corr_plain, lib_corr, 2)):
            err, times = check_reduction(name, kfn, pfn, lfn, Rb, C, n_in,
                                         gen)
            row[name] = {"max_abs_err": err, **times,
                         "bound_ms": bound_ms(Rb, C, n_in)}
        rows.append(row)
        log(f"[kernels] R={Rb:>8} C={C:>4} x{mult:<2} " + " | ".join(
            f"{n} {row[n]['ms'] * 1e3:7.1f}us (eager "
            f"{row[n]['eager_ms'] * 1e3:6.1f}, plain "
            f"{row[n]['plain_ms'] * 1e3:7.1f}, library "
            f"{row[n]['library_ms'] * 1e3:7.1f}, bound "
            f"{row[n]['bound_ms'] * 1e3:6.1f}) err {row[n]['max_abs_err']:.3g}"
            for n in ("bn_stats", "bn_corr")))
    return rows


def bound_ms(R, C, n_in):
    """Least time: each bf16 input read once and the two f32 (C,) outputs
    written once over the HBM rate, or 3 f32 operations per element over
    the f32 rate, whichever is larger (always the bytes here)."""
    by_bytes = (n_in * R * C * 2 + 2 * C * 4) / HBM_BYTES_PER_S
    by_ops = 3 * R * C / F32_FLOPS
    return 1e3 * max(by_bytes, by_ops)


def bn_train_phase():
    """batch_norm_train forward + backward on the card against the CPU."""
    import torch

    from learning_embeddings_tpu_torch.ops import batch_norm_train

    g = torch.Generator().manual_seed(1)
    shape = (8, 64, 56, 56)
    x = (0.5 + 2 * torch.randn(shape, generator=g)) \
        .contiguous(memory_format=torch.channels_last)
    scale = 1 + 0.2 * torch.randn(64, generator=g)
    bias = 0.1 * torch.randn(64, generator=g)
    dy = torch.randn(shape, generator=g) \
        .contiguous(memory_format=torch.channels_last)

    def run(dev, dtype):
        tx = x.to(dev, dtype, copy=True).requires_grad_(True)
        ts = scale.to(dev, copy=True).requires_grad_(True)
        tb = bias.to(dev, copy=True).requires_grad_(True)
        y, mean, var = batch_norm_train(tx, ts, tb, 1e-5)
        y.backward(dy.to(dev, dtype))
        return [t.detach().float().cpu() for t in
                (y, mean, var, tx.grad, ts.grad, tb.grad)]

    names = ("y", "mean", "var", "dx", "dscale", "dbias")
    # f32: the two differ only in the order of the sums; bf16: y and dx
    # round to bf16 (eps 2^-8) on both sides from f32 values that differ
    # in that order, so they may land one bf16 step apart
    for dtype, rtol, atol in ((torch.float32, 1e-4, 1e-4),
                              (torch.bfloat16, 1e-2, 1e-2)):
        for n, a, b in zip(names, run(DEV, dtype), run("cpu", dtype)):
            scale_ = max(1.0, b.abs().max().item())
            err = (a - b).abs().max().item()
            if not torch.allclose(a, b, rtol=rtol, atol=atol * scale_):
                raise AssertionError(f"batch_norm_train {dtype} {n}: card "
                                     f"and CPU differ by {err}")
        log(f"[kernels] batch_norm_train {str(dtype):15} fwd+bwd on the "
            f"card = CPU path (rtol {rtol}, atol {atol}·max|ref|)")


def small_step_phase(labelmap):
    """One f32 train step at 64², batch 8, on the card (kernels) and on the
    CPU (plain path) from the same weights. ResNet-18: the same loss,
    gradients and running statistics. ResNet-50: the same loss and running
    statistics; its gradients are not compared, because at this size they
    are ill-conditioned: on an H100 two summation orders on the card (the
    kernels, the plain reductions) differed by up to 31% of a tensor's
    largest entry, and the plain path on the card from the CPU by 19%,
    while ResNet-18 agreed within 1.5e-5. (Nor is the loss after an Adam
    update a check: the update moves every weight by about lr·sign(g), and
    the sign of a near-zero gradient is rounding noise.)"""
    import numpy as np
    import torch

    from learning_embeddings_tpu_torch.train.classifier import (
        ClassifierConfig, ClassifierTrainer)

    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 256, (8, 64, 64, 3)).astype(np.uint8)
    ll = labelmap.leaf_paths()[rng.randint(0, labelmap.levels[-1], 8)]
    mh = np.zeros((8, labelmap.n_classes), np.float32)
    prev_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False   # full f32 convs for this check
    try:
        for backbone in ("resnet18", "resnet50"):
            res, state = {}, None
            for dev in ("cpu", DEV):
                tr = ClassifierTrainer(labelmap, ClassifierConfig(
                    backbone=backbone, lr=1e-5, image_size=64, batch_size=8,
                    dtype=torch.float32, device=dev))
                if state is None:
                    state = {k: v.clone() for k, v in
                             tr.model.state_dict().items()}
                tr.model.load_state_dict(state)
                _, loss = tr.train_step(tr.state,
                                        *tr.put_batch(imgs, ll, mh))
                tensors = dict(tr.model.named_buffers())
                if backbone == "resnet18":
                    tensors.update({"grad " + k: p.grad for k, p in
                                    tr.model.named_parameters()})
                res[dev] = (float(loss),
                            {k: v.detach().float().cpu()
                             for k, v in tensors.items()})
            (l_card, t_card), (l_cpu, t_cpu) = res[DEV], res["cpu"]
            # per tensor, |card − CPU| within 1e-4 of its largest entry
            worst = max(((t_card[k] - v).abs().max().item()
                         / max(v.abs().max().item(), 1e-12), k)
                        for k, v in t_cpu.items())
            if not (abs(l_card - l_cpu) < 1e-4 and worst[0] <= 1e-4):
                raise AssertionError(
                    f"small {backbone} step: loss card {l_card} CPU "
                    f"{l_cpu}; worst tensor {worst}")
            log(f"[kernels] {backbone} 64² f32 step: loss card "
                f"{l_card:.6f} CPU {l_cpu:.6f} (limit 1e-4); {len(t_cpu)} "
                f"tensors agree, worst {worst[0]:.2e} of max|·| "
                f"({worst[1]}; limit 1e-4)")
    finally:
        torch.backends.cudnn.allow_tf32 = prev_tf32


# --------------------------------------------------------------------------
# phase 3: the slice
# --------------------------------------------------------------------------
def slice_phase(labelmap, batch, steps=5, warmup=2):
    import torch

    from learning_embeddings_tpu_torch.ops import bn, bn_triton
    from learning_embeddings_tpu_torch.ops.bn import FusedBatchNorm
    from learning_embeddings_tpu_torch.train.classifier import (
        ClassifierConfig, ClassifierTrainer)

    cfg = ClassifierConfig(backbone="resnet50", criterion="multi_level_ce",
                           optimizer="adam", lr=1e-5, image_size=448,
                           batch_size=batch, seed=0, bn_impl="pallas",
                           dtype=torch.bfloat16, device=DEV)
    trainer = ClassifierTrainer(labelmap, cfg)
    bns = [m for m in trainer.model.modules() if isinstance(m, FusedBatchNorm)]
    if len(bns) != 53:
        raise AssertionError(f"ResNet-50 has {len(bns)} BatchNorm layers")

    gen = torch.Generator(device=DEV).manual_seed(0)
    images = torch.randint(0, 256, (batch, 448, 448, 3), dtype=torch.uint8,
                           device=DEV, generator=gen)
    paths = torch.as_tensor(labelmap.leaf_paths(), device=DEV)
    leaves = torch.randint(0, labelmap.levels[-1], (batch,), device=DEV,
                           generator=gen)
    multihot = torch.zeros((batch, labelmap.n_classes), device=DEV)
    batch_t = trainer.put_batch(images, paths[leaves], multihot)

    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda m, inp: seen.append((inp[0].numel() // inp[0].shape[1],
                                    inp[0].shape[1]))) for m in bns]

    # the main path: counts set to 0 just before, read just after
    bn_triton.STATS_LAUNCHES = bn_triton.CORR_LAUNCHES = 0
    bn.CHANNELS_LAST_COPIES = 0
    state, losses = trainer.state, []
    for i in range(warmup):
        state, loss = trainer.train_step(state, *batch_t)
        losses.append(loss)
        if i == 0:
            for h in hooks:
                h.remove()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, loss = trainer.train_step(state, *batch_t)
        losses.append(loss)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"bn_stats": bn_triton.STATS_LAUNCHES,
                "bn_corr": bn_triton.CORR_LAUNCHES}
    copies = bn.CHANNELS_LAST_COPIES

    want = sorted((R * batch, C) for (R, C), n in RESNET50_448_BN.items()
                  for _ in range(n))
    if sorted(seen) != want:
        raise AssertionError(f"BatchNorm shapes of the step {sorted(seen)} "
                             f"are not ResNet-50@448's {want}")
    losses = [float(l) for l in losses]
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"non-finite losses {losses}")
    n_steps = warmup + steps
    for name, n in launches.items():
        if n != 53 * n_steps:
            raise AssertionError(f"{name}: {n} launches in {n_steps} steps, "
                                 f"expected {53 * n_steps}")
    if copies:
        raise AssertionError(f"{copies} channels_last copies in the step")
    result = {
        "batch": batch, "steps_timed": steps, "steps_total": n_steps,
        "n_classes": labelmap.n_classes, "levels": list(labelmap.levels),
        "losses": losses, "launches": launches,
        "launches_per_step": {k: v / n_steps for k, v in launches.items()},
        "channels_last_copies": copies,
        "ms_per_step": 1e3 * seconds / steps,
        "images_per_s": batch * steps / seconds,
        "max_memory_allocated_gib":
            torch.cuda.max_memory_allocated() / 2**30,
    }
    log(f"[slice] resnet50@448 batch {batch}, {labelmap.n_classes} classes "
        f"{tuple(labelmap.levels)}: losses {losses}")
    log(f"[slice] launches {launches} over {n_steps} steps "
        f"(53 + 53 per step), channels_last copies {copies}")
    log(f"[slice] {result['ms_per_step']:.2f} ms/step, "
        f"{result['images_per_s']:.1f} images/s, peak memory "
        f"{result['max_memory_allocated_gib']:.2f} GiB")
    return trainer, state, batch_t, result


# --------------------------------------------------------------------------
# phase 4: profile of one step
# --------------------------------------------------------------------------
def profile_phase(trainer, state, batch_t):
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, loss = trainer.train_step(state, *batch_t)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)

    per_name = {}
    for evt in prof.key_averages():
        if not str(evt.device_type).endswith("CUDA"):   # kernels only
            continue
        us = float(evt.self_device_time_total)
        if us > 0:
            per_name[evt.key] = (per_name.get(evt.key, (0.0, 0))[0] + us,
                                 evt.count)
    busy = sum(us for us, _ in per_name.values())
    kern = {}
    for name, pat in (("bn_stats", "bn_stats_kernel"),
                      ("bn_corr", "bn_corr_kernel")):
        hits = [(k, v) for k, v in per_name.items() if pat in k]
        kern[name] = {"ms": sum(v[0] for _, v in hits) / 1e3,
                      "count": sum(v[1] for _, v in hits)} if hits else None
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:12]
    out = {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
           "idle_share": (1 - busy / wall_us) if busy else None,
           "kernels": kern,
           "top": [{"name": k[:80], "ms": v[0] / 1e3, "count": v[1]}
                   for k, v in top]}
    if busy == 0:
        log("[measure] the profiler saw no device time: per-step kernel "
            "time from the profiler not measured")
    else:
        log(f"[measure] profiled step: wall {out['wall_ms']:.2f} ms, device "
            f"busy {out['device_busy_ms']:.2f} ms (idle share "
            f"{out['idle_share']:.3f}); bn_stats {kern['bn_stats']}, "
            f"bn_corr {kern['bn_corr']}")
        for t in out["top"]:
            log(f"[measure]   {t['ms']:9.3f} ms x{t['count']:<4} {t['name']}")
    return out


def per_step_kernel_line(rows, slice_result, prof):
    """The `kernels` record: one step's 53 launches of each kernel."""
    kernels = []
    for name in ("bn_stats", "bn_corr"):
        tot = {k: sum(r[name][k] * r["layers"] for r in rows)
               for k in ("ms", "eager_ms", "plain_ms", "library_ms",
                         "bound_ms")}
        kernels.append({
            "name": name, "route": "triton", "source": KERNEL_SRC,
            "replaces": TPU_KERNELS[name],
            "launches": slice_result["launches"][name],
            "max_abs_err": max(r[name]["max_abs_err"] for r in rows),
            "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"], "bound_by": "bytes",
            "library_ms": tot["library_ms"], "eager_ms": tot["eager_ms"],
            "in_step_profiler_ms": (prof["kernels"][name]["ms"]
                                    if prof["kernels"][name] else None),
        })
    return kernels


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    args = ap.parse_args(argv)

    require_card_and_checkout()
    import torch

    from learning_embeddings_tpu_torch.entry import ethec_labelmap
    from learning_embeddings_tpu_torch.hierarchy import toy_labelmap

    t_start = time.perf_counter()
    smi = device_phase()
    torch.backends.cudnn.benchmark = True

    t = time.perf_counter()
    rows = kernels_phase(args.batch)
    bn_train_phase()
    small_step_phase(toy_labelmap(3, 3))
    log(f"[kernels] phase took {time.perf_counter() - t:.1f} s "
        f"(kernel builds included)")

    labelmap = ethec_labelmap()
    trainer, state, batch_t, result = slice_phase(labelmap, args.batch)
    prof = profile_phase(trainer, state, batch_t)
    kernels = per_step_kernel_line(rows, result, prof)

    details = {"nvidia_smi": smi, "torch": torch.__version__,
               "cuda": torch.version.cuda, "slice": result,
               "profile": prof, "kernel_shapes": rows, "kernels": kernels,
               "seconds": time.perf_counter() - t_start}
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(details, f, indent=1)
    log(f"[done] {details['seconds']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
