#!/usr/bin/env python3
"""Smoke run of the PyTorch port (learning_embeddings_tpu_torch) on one
NVIDIA card.

Usage, from the root of a checkout:   python3 chip_smoke.py [--batch N]
(default batch 128, the JAX bench's, for the classifier path)

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. device   the card's name and power limit (nvidia-smi), torch, CUDA,
            nvcc and Triton versions; starts the nvcc build of the CUDA
            kernel library in the background.
2. kernels  builds the kernels of both slices from the sources in the
            checkout and holds each against its plain PyTorch version on
            the card:
            - bn_stats / bn_corr (Triton) at the 12 BatchNorm (R, C)
              shapes of ResNet-50@448 (R × batch) and one ragged shape, on
              integer-valued bf16 inputs (the sums are exact in f32: no
              difference is allowed) and on normal bf16 inputs
              (|kernel − plain| ≤ 1e-5·Σ|terms| + 1e-6); bn_dx (Triton)
              at the same shapes against _dx_plain (one bf16 ulp beyond
              the f32 rounding of its terms), timed beside its byte bound,
              _dx_plain and torch.batch_norm_backward_elemt (the library
              yardstick; the port never calls it); bn_act (Triton) at the
              same shapes against _act_plain with train coefficients, the
              ReLU and with and without the residual (one ulp of y), timed
              beside its byte bound (x and, after each bn3, the residual
              read once, the output written once: 8.482 ms a step at
              batch 128) and _act_plain (the unfused chain);
            - pairwise_order (CUDA C++, two kernels chosen by D: exact_d
              for 1 ≤ D ≤ 16, generic past it) at the three (M, N, D)
              shapes of the joint eval, the same at ETHEC's 723 labels,
              and ragged ones on both routes, on integer-valued inputs
              (exact) and normal f32 inputs (|kernel − plain| ≤
              1e-5·Σ_d terms + 1e-6); asserts the route each shape
              launched, and times the exact_d and generic kernels in
              turns at the six eval shapes;
            - window_attention (CUDA C++, the Swin's kernel pair) at
              Swin-L's four stage shapes at 384² (nW·H 384, 192, 96, 48;
              144 tokens of 32) at the Swin cell's batch 64, shifted and
              not, forward and backward on bf16 inputs against
              window_attention_plain (output within 2^-7 of its norm, the
              packed qkv and the bias gradients within 2^-6); timed a
              stage beside the plain route, the memory-efficient SDPA (the
              library yardstick) and the byte bound (24·T·C bytes a block
              and image: 6.29 ms a step); then one Swin-L train step at
              batch 64 with the counters reset just before it: 48
              "window_attention", 48 "attention" and "attention_bias";
            the additions for the model zoo: K1/K2 at VGG11BN@448's 8
            BatchNorm shapes (batch 64), K1 at the ghost route's row
            prefixes of ResNet-50@448's 12 shapes (8 rows) and K1's
            bf16-rounding variant (each x² rounded to bf16 before the
            sum) at ResNet-50@448's 12 shapes, each on integer-valued
            (exact) and normal inputs; and for phase 15, K1/K2 at the
            rows each rank gives them there: ResNet-50@448's 12 shapes at
            64, 16 and 8 rows, ResNet-18@64's 5 at 4 rows in f32 and at 4
            and 2 rows in bf16, ResNet-18@32's 5 at 4 rows, and the
            spatial shapes of phase 15 (f), each image's H halved:
            ResNet-50@448's 12 at 128 rows, ResNet-18@64's 5 at 8 rows in
            f32 and at 4 and 2 rows in bf16; each on integer-valued
            (exact) and normal inputs;
            then batch_norm_train's forward and backward on the card
            against the CPU path, one small classifier train step and one
            small joint step with its eval on the card against the CPU,
            and one small hyperbolic-cone joint step for each label
            optimizer (adam, rsgd, radam) on the card against the CPU.
3. slice 1  the classifier path: ClassifierTrainer(resnet50,
            multi_level_ce, adam, lr 1e-5, 448², bn_impl='pallas', bf16
            trunk) on the taxonomy of entry.ethec_labelmap(), synthetic
            uint8 NHWC images from a seeded generator; 2 warm-up and 3
            timed steps. Asserts finite losses, 53 launches of each BN
            kernel per step, and no channels_last copy. Then the
            profiler's view of one step.
4. slice 2  the joint path: JointCNNTrainer(resnet50, 448², order energy,
            dim 10, 16 label→image edges a step, ratio 5, alpha 0.05,
            pick_per_level, lr 1e-2/1e-3, bf16 tower) on the same
            taxonomy with 2048 synthetic train images and a seeded uint8
            pixel bank; batches prepared up front; 2 warm-up and 5 timed
            steps, then the runner's eval: embeddings of a 5286-image val
            split (the ETHEC val split's size) in chunks of 128,
            classification metrics, val edge metrics (which calibrate the
            threshold), reconstruction, and the test metrics of a
            5049-image split at that threshold. Asserts finite losses,
            53 + 53 BN launches per step and at least 2 pairwise_order
            launches, all on the exact_d route, and holds the eval's
            energies from the kernel against the plain version on the
            card. Then the profiler's view of one joint step.
5. slice 4  the hyperbolic joint path, BASELINE.json's workload
            (bench.py:127-130): the phase-4 run with energy hyp_cone and
            the hybrid Adam on the labels, on the same graph and pixel
            bank, then the same eval. Asserts finite losses, 53 + 53 BN
            launches per step, no pairwise_order launch (the cone energy
            takes its Gram form), and every label row in the annulus
            [r0, 1 − 1e−5]. Then the profiler's view of one step.
6. slice 4  the label-only trainer: EmbeddingTrainer on the same taxonomy
            with the CLI defaults (dim 10, batch 8, ratio 5, alpha 0.05,
            lr 1e-3, 90% of the non-basic edges in train), three runs of a
            few epochs (hyp_cone + adam, hyp_cone + rsgd, order + adam),
            each with its val, test and reconstruction F1. The order run's
            reconstruction must launch pairwise_order on the exact_d route,
            and that launch is held against the plain version. Then the
            profiler's view of one step of each run.
7. slice 5  the label-only CLIs through their main(argv) with the CLI
            defaults on Butterfly200: order_embeddings_h (adam hybrid) 5
            epochs then --resume to 7 (starts at 5, best_model kept),
            order_embeddings --loss order_emb_loss 5 epochs with
            --check_reconstr_every 1 (K3 once per reconstruction, exact_d),
            embed_toy (4 levels, branching 3, hyp_cones_loss) and
            validate_embedding on the order run (K3, the run's
            reconstruction F1). Experiments go to .smoke_experiments/,
            removed at the end.
8. slice 5  run_joint_cnn at the BASELINE width (hyp_cone, ResNet-50@448,
            bf16 tower, 16 edges a step, ratio 5) on 256 train images and
            256-image val and test splits of the pixel bank, warm-started
            from phase 7's hyperbolic best_model (table and threshold), 2
            epochs then resume=True to 3, then 1 epoch with the order
            energy (its eval launches K3 on exact_d); 53 + 53 BN launches
            a step; each split's eval, one checkpoint's save, load and size.
9. slice 5  cli/oe_h.py --use_CNN end to end on 120 Butterfly200 records
            with PNG images the script writes (decoded by cv2).
10. slice 6 the classifier experiment through cli/ethec_experiments.py at
            the flagship width (ResNet-50@448, batch 128, multi_level,
            Adam lr 1e-5, 8 decode threads) on the same taxonomy: 1024
            train, 256 val and 256 test records of every leaf in turn,
            pointing at 256 distinct 375×500 PNGs the script writes; 2
            epochs with --profile 2, --resume to 3, --set_mode test (the
            best model reloaded), --loss multi_label --evaluator ML for 1
            epoch (per-class thresholds tuned on val), then cli/image_emb.py
            on the first experiment. Asserts 53 + 53 BN launches per train
            step and none in the eval steps, the checkpoints, the resumed
            epochs, the score dump's shape, the test run's best epoch and
            micro-F1, finite thresholds and mAP in [0, 1], and 2048-wide
            f32 features for every split; reports the epoch time split
            into data wait, steps, eval and checkpoints, images/s, peak
            memory, the profile's top ops and one checkpoint's save, load
            and size.
11. slice 7 the fc7 joint trainer (JointEmbeddingTrainer: FeatNet on
            precomputed 2048-wide features, negatives drawn on the card):
            (a) 3 train_steps on given negatives of hyp_cone + adam,
            hyp_cone + rsgd and order + adam on the card against the CPU;
            (b) JointTrainerConfig's defaults (hyp_cone + adam, dim 10,
            batch 10, ratio 5) on the taxonomy with a train graph of
            37,643 synthetic images (ETHEC's train split) over every leaf,
            308 MB of f32 features on the card: 2 warm-up and 500 timed
            train_batch steps, a profile of 5 (idle share), peak memory
            and the epoch time the step implies; (c) one train_epoch of
            each of the three runs on a 2048-image graph, each followed by
            the runner's eval on 5286- and 5049-row feature splits (K3
            three times, on exact_d, in the order run's eval and held
            against the plain version; none in the hyperbolic ones, whose
            label rows stay in the annulus); (d) run_joint_embedding, 2
            epochs then resume=True to 3, warm-started from phase 7's
            hyperbolic best_model, with one checkpoint's size, save and
            load; (e) cli/oe_h.py and cli/oe.py without --use_CNN for one
            epoch on the {split}.npz features phase 10's image_emb wrote.
12. slice 8 inference and reports (cli/inference.py's card functions)
            on phase 10's experiment (ResNet-50@448, best_model): the
            rebuild from its manifest, run_tsne (no drawing) over its 256
            val and 256 test records, the eval forward's images/s and a
            profile of it, the occlusion maps of 2 test images (225
            occluded images each, batches of 32), LIME's per-level
            softmax and coefficients for the same 2 (100 perturbations;
            SLIC, forward and masks + ridge timed apart), one image's
            logits on the card against the CPU path (bf16 within
            5e-2·max|logit|, f32 with TF32 off within 1e-4·max|logit|),
            cross_level_confusion on its score dumps and
            read_jsonl_scalars on its metrics. Asserts no BN launch in
            the whole phase, every shape and finite values; reports the
            peak memory above what earlier phases hold.
13. slice 8 cli/fashion_mnist.py and cli/cifar.py --dataset cifar10,
            --debug on the synthetic stand-in (600 images), 1 epoch each
            at their defaults (ResNet-18@224, batch 8, multi_level).
            Asserts 20 + 20 BN launches per train step and none in the
            eval steps, no channels_last copy (FashionMNIST's 1-channel
            stem included) and finite losses and metrics; reports ms a
            step, images/s, the epoch time and its data wait; then the
            FashionMNIST step alone on a synthetic batch after warm-up
            (ms, images/s, a profile), and K1 and K2 against their plain
            versions at the 20 BN shapes of that step (as in phase 2).
14. slice 9 the model zoo: (a) one f32 train-mode forward and backward
            (TF32 off) of small models on the card against the CPU for
            each option (ResNet-18 with stem s2d, remat, ghost rows 2,
            bf16 statistics, bn_impl flax; VGG11BN; AlexNet): logits
            within 1e-5 of max|logit| (bf16 statistics 1e-2) and each
            option's K1/K2 launches; (b) the s2d ResNet-50@448 with
            conv7's weights converted equals conv7 (f32 within 1e-5, bf16
            within 5e-2 of max|logit|); (c) the ResNet-50@448 classifier
            step, batch 128, with stem s2d, remat, bn_stats_rows 8,
            bn_stats_dtype bfloat16 and bn_impl flax, 2 + 3 steps each:
            launches 53/53, 105/53, 53/53, 53/53 (every K1 the rounding
            variant) and 0/0 a step, no channels_last copy, remat's peak
            memory below the conv7 step's (phase 3), and a profile of the
            flax step by class (the library's BatchNorm kernels,
            convolutions, elementwise): the yardstick for the port's
            BatchNorm; (d) VGG11BN@448, batch 64: 8 + 8 a step; (e)
            cli/ethec_experiments.py --model vgg11_bn --bn_stats_rows 8
            --bn_stats_dtype bfloat16 for one epoch on phase 10's records,
            cli/image_emb.py --model alexnet (4096-wide features, no BN
            launch) and cli/oe_h.py on those features without --use_CNN;
            (f) the hyperbolic joint step at the BASELINE width with remat
            (105/53 a step) and with bf16 statistics (53/53).
15. slice 10 multi-GPU, each group of ranks as processes with a time
            limit (parallel/launch.py; any rank's failure fails the
            phase): (a) the ResNet-50@448 classifier step, global batch
            128, on a (2, 1) gloo mesh of two ranks sharing the card (64
            rows each), 3 steps against the one-process step from the
            same weights and batches: losses within 1e-2 relative, 53 + 53
            K1/K2 launches and 53 + 53 BN all-reduces a rank a step, the
            running statistics equal on both ranks bit for bit; ms/step,
            peak memory a rank and the collectives' share of a step; (b)
            the BASELINE hyperbolic joint step (ResNet-50@448, 16 edges,
            ratio 5) on the same mesh against one process (losses within
            1e-2), its eval on the mesh (on the start weights: hit@1
            within 0.01 of one process), its first step again at
            lr_images 1e-5 with a bf16 and an f32 tower (TF32 off): tower
            and labels equal on both ranks bit for bit, embeddings within
            5e-2 of max|·| and hit@1 within 0.01 of one process after the
            step, and in f32 the tower's moves of one process's sign on at
            least 95% of the entries it moved; and the order eval's K3
            tiles at M × 5286, D = 10, on (2, 1) and (1, 2) splits: gathered, equal
            to the one-process kernel bit for bit, one exact_d launch a
            rank; (c) a (2, 2) mesh of four ranks, f32 ResNet-18@64 (TF32
            off), all five criteria on Butterfly200 (the head
            column-parallel) and on an odd class count (row-parallel):
            logits within 1e-5 of max|logit| and losses within 1e-5
            relative of one process;
            (d) an NCCL group over every card (one on a one-card machine)
            runs (a)'s step at batch 8 a card and reduces known values;
            with two or more cards, (a) over them on NCCL, a rank a card;
            (e) entry.dryrun_multichip(4, device="cuda"), whose spatial
            stage on (2, 2) exchanges 36 + 34 halos a rank;
            (f) spatial partitioning (slice 11): the images' H over the
            'model' axis of a (1, 2) gloo mesh of two ranks sharing the
            card, every layer of ResNet-50@448 H-sharded with halo
            exchanges: the bf16 step at batch 128 (3 steps, 3 timed)
            against (a)'s one-process step: losses within 1e-2 relative,
            53 + 53 K1/K2 launches and 18 + 17 halo exchanges a rank a
            step (the stem, the pool and 16 3×3 convs; the image takes no
            gradient), no channels_last copy, running statistics equal on
            both ranks bit for bit, peak memory a rank at most 0.6 of one
            process's; ms/step and the collectives' share by tag; the f32
            ResNet-18@64 step (TF32 off) within 1e-5 of one process; and
            cli/ethec_experiments.py --spatial_partition --n_model 2 in the
            two ranks (ResNet-50@448, batch 32, on phase 10's images).

The line before the last is the card's nvidia-smi name and power limit;
the last is {"ok": true, "device": {...}}. A `kernels` JSON line and the
details go before them, and the details also to
chiprun_out/chip_smoke.json.
"""

import argparse
import dataclasses
import json
import math
import os
import shutil
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
#: per-image (R, C) of the 20 train-mode BatchNorm layers of ResNet-18 at
#: 224² (the CIFAR / FashionMNIST CLIs' default), layers of each shape
RESNET18_224_BN = {(12544, 64): 1, (3136, 64): 4, (784, 128): 5,
                   (196, 256): 5, (49, 512): 5}
#: the same at 64² and 32² (phase 15's (2, 2) step and the dryrun twin)
RESNET18_64_BN = {(1024, 64): 1, (256, 64): 4, (64, 128): 5, (16, 256): 5,
                  (4, 512): 5}
RESNET18_32_BN = {(256, 64): 1, (64, 64): 4, (16, 128): 5, (4, 256): 5,
                  (1, 512): 5}
#: of those, the layers whose output takes the residual add (each bn3)
RESNET50_448_RESIDUAL = {(12544, 256): 3, (3136, 512): 4, (784, 1024): 6,
                         (196, 2048): 3}
RAGGED = (12345, 100)
KERNEL_SRC = {"bn_stats": "learning_embeddings_tpu_torch/ops/bn_triton.py",
              "bn_corr": "learning_embeddings_tpu_torch/ops/bn_triton.py",
              "bn_dx": "learning_embeddings_tpu_torch/ops/bn_triton.py",
              "bn_act": "learning_embeddings_tpu_torch/ops/bn_triton.py",
              "pairwise_order":
                  "learning_embeddings_tpu_torch/csrc/pairwise_order.cu",
              "window_attention":
                  "learning_embeddings_tpu_torch/csrc/window_attention.cu"}
TPU_KERNELS = {"bn_stats": "learning_embeddings_tpu/ops/bn_pallas.py:52",
               "bn_corr": "learning_embeddings_tpu/ops/bn_pallas.py:64",
               "bn_dx": None,
               "bn_act": None,
               "pairwise_order":
                   "learning_embeddings_tpu/geometry/pairwise.py:46",
               "window_attention": None}
#: Swin-L at 384², window 12 (head width 32): (windows, heads, grid,
#: blocks) of each stage, and the Swin cell's batch
SWIN_L_STAGES = ((64, 6, 96, 2), (16, 12, 48, 2), (4, 24, 24, 18),
                 (1, 48, 12, 2))
SWIN_WINDOW, SWIN_HEAD_WIDTH, SWIN_BATCH = 12, 32, 64
#: sizes of the ETHEC val and test splits: the joint eval's image counts
VAL_IMAGES, TEST_IMAGES = 5286, 5049
EMB_DIM = 10
#: ETHEC's label count: the joint eval's M where the ETHEC split is present
ETHEC_LABELS = 723
#: ragged (M, N, D) shapes for the pairwise_order check, beside the eval's:
#: the exact_d route's D = 1, 3, 10 and 16, the generic route's 17 and 131
K3_RAGGED = [(1, 1, 1), (37, 129, 10), (130, 7, 3), (5, 300, 131),
             (65, 4097, 10), (33, 131, 16), (19, 130, 17)]


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
    from torch.utils.cpp_extension import CUDA_HOME

    smi = smi_line()
    log(f"[device] {smi}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"triton {triton.__version__} python {sys.version.split()[0]}")
    nvcc = subprocess.run([os.path.join(CUDA_HOME or "", "bin", "nvcc"),
                           "--version"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()
    log(f"[device] nvcc: {nvcc.splitlines()[-1]}")
    props = torch.cuda.get_device_properties(0)
    log(f"[device] {props.name}: {props.multi_processor_count} SMs, "
        f"{props.total_memory / 2**30:.1f} GiB")
    return smi


def start_cuda_build():
    """Starts the nvcc build of the CUDA kernel library (one nvcc per
    source; there is one) on a worker thread, beside the Triton builds of
    the BN checks; returns (future, start time)."""
    from concurrent.futures import ThreadPoolExecutor

    from learning_embeddings_tpu_torch.ops import pairwise_order

    def build():
        return pairwise_order.build_library(), time.perf_counter()

    ex = ThreadPoolExecutor(max_workers=1)
    fut = ex.submit(build)
    ex.shutdown(wait=False)   # the thread ends with the build
    return fut, time.perf_counter()


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
def check_reduction(name, kernel_fn, plain_fn, library_fn, R, C, n_in, gen,
                    dtype=None):
    """Integer-valued (exact) and normal inputs of `dtype` (by default
    bf16); returns the max abs
    error on the normal ones and the device times of the kernel, its plain
    version and the library call (None where there is none), and the
    kernel's eager time (host launch cost included)."""
    import torch

    dev = DEV
    dtype = dtype or torch.bfloat16
    # entries in {-1, 0, 1}: every partial sum is an integer below 2^24,
    # so both sides sum exactly in f32 whatever their order
    ints = [torch.randint(-1, 2, (R, C), device=dev, generator=gen)
            .to(dtype) for _ in range(n_in)]
    got = kernel_fn(*ints)
    exact = plain_fn(*ints)
    for g, e in zip(got, exact):
        if not torch.equal(g, e):
            bad = (g - e).abs().max().item()
            raise AssertionError(f"{name} {(R, C)}: integer sums differ "
                                 f"from the exact ones by {bad}")

    xs = [torch.randn((R, C), device=dev, generator=gen).to(dtype)
          for _ in range(n_in)]
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

    copies = [[torch.randn((R, C), device=dev, generator=gen).to(dtype)
               for _ in range(n_in)]
              for _ in range(n_copies(R * C * dtype.itemsize * n_in))]
    times = {"ms": device_ms(kernel_fn, copies),
             "plain_ms": device_ms(plain_fn, copies),
             "library_ms": (None if library_fn is None
                            else device_ms(library_fn, copies)),
             "eager_ms": cuda_ms(kernel_fn, copies)}
    return err, times


def _ulp(v, dtype):
    """One unit in the last place of |v| in `dtype` (bf16 or f32)."""
    import torch

    bits = {torch.bfloat16: 7, torch.float32: 23}[dtype]
    return torch.ldexp(torch.ones_like(v), torch.frexp(v.abs())[1] - 1 - bits)


def check_dx(R, C, gen, dtype=None):
    """bn_dx against _dx_plain on normal inputs of `dtype` (by default
    bf16), the plain route with the statistics and sums of the data: at
    most one ulp of dx's dtype beyond 2^-21 of the magnitude of the terms
    it sums (Triton's FMAs and its order of the per-channel arithmetic).
    Returns the max abs error and the device times of the kernel,
    _dx_plain and torch.batch_norm_backward_elemt over a channels_last
    view (R taken as one image of H·W rows), and the kernel's eager
    time."""
    import torch

    from learning_embeddings_tpu_torch.ops import bn, bn_triton

    dtype = dtype or torch.bfloat16

    def inputs():
        x = (0.5 + 1.5 * torch.randn((R, C), device=DEV, generator=gen)) \
            .to(dtype)
        dy = torch.randn((R, C), device=DEV, generator=gen).to(dtype)
        s, q = bn._stats_plain(x)
        mean = s / R
        inv = torch.rsqrt(torch.clamp_min(q / R - mean * mean, 0) + 1e-5)
        scale = 1 + 0.2 * torch.randn(C, device=DEV, generator=gen)
        sdy, sdyx = bn._corr_plain(dy, x)
        return dy, x, scale, mean, inv, sdy, sdyx, sdy, sdyx

    args = inputs()
    dy, x, scale, mean, inv, sdy, sdyx = args[:7]
    got, _ = bn_triton.bn_dx(*args, R, R)
    want, _ = bn._dx_plain(*args, R, R)
    g = (scale * inv).abs()
    terms = (dy.float().abs() * g + (g * sdy / R).abs()
             + (x.float() - mean).abs() * g * inv * inv
             * (sdyx.abs() + (mean * sdy).abs()) / R)
    diff = (got.float() - want.float()).abs()
    tol = _ulp(torch.maximum(got.float().abs(), want.float().abs()), dtype) \
        + 2.0 ** -21 * terms
    if not bool((diff <= tol).all()):
        raise AssertionError(f"bn_dx {(R, C)}: kernel and plain version "
                             f"differ by {diff.max().item()} beyond one ulp")
    err = diff.max().item()
    del got, want, terms, diff, tol
    count = torch.tensor([R], device=DEV, dtype=torch.int32)

    def kernel(dy, x, out, v, _):
        return bn_triton.bn_dx(dy, x, *v, R, R, out=out)

    def plain(dy, x, out, v, _):
        return bn._dx_plain(dy, x, *v, R, R, out=out)

    def library(dy, x, out, v, sum_dy_xmu):
        scale, mean, inv, sdy = v[:4]
        return torch.batch_norm_backward_elemt(
            _as4d(dy, R), _as4d(x, R), mean, inv, scale, sdy, sum_dy_xmu,
            count)

    # sum_dy_xmu = Σdy·(x − mean) = Σdy·x − mean·Σdy, made off the clock
    copies = [(a[0], a[1], torch.empty_like(a[1]), a[2:],
               a[6] - a[3] * a[5])
              for a in [args] + [inputs() for _ in range(
                  n_copies(3 * R * C * dtype.itemsize) - 1)]]
    times = {"ms": device_ms(kernel, copies),
             "plain_ms": device_ms(plain, copies),
             "library_ms": device_ms(library, copies),
             "eager_ms": cuda_ms(kernel, copies)}
    return err, times


def dx_bound_ms(R, C, dtype=None):
    """Least time of bn_dx: dy and x (by default bf16) read once, dx
    written once, and its eight (C,) f32 vectors, over the HBM rate (its
    ~8 f32 operations an element take a tenth of that)."""
    itemsize = 2 if dtype is None else dtype.itemsize
    return 1e3 * (3 * R * C * itemsize + 8 * C * 4) / HBM_BYTES_PER_S


def check_act(R, C, gen, dtype=None):
    """bn_act against _act_plain on normal inputs of `dtype` (by default
    bf16), with the train coefficients of the data's sums and the ReLU,
    without and with the residual: within one ulp of y (and one of the
    output after the add). Returns the max abs error and, for each of the
    two, the device times of the kernel and of _act_plain (the unfused
    chain: the fold's launches, addcmul, add, ReLU), and the kernel's
    eager time."""
    import torch

    from learning_embeddings_tpu_torch.ops import bn, bn_triton

    dtype = dtype or torch.bfloat16

    def inputs():
        x = (0.5 + 1.5 * torch.randn((R, C), device=DEV, generator=gen)) \
            .to(dtype)
        r = torch.randn((R, C), device=DEV, generator=gen).to(dtype)
        scale = 1 + 0.2 * torch.randn(C, device=DEV, generator=gen)
        bias = 0.1 * torch.randn(C, device=DEV, generator=gen)
        return x, r, torch.empty_like(x), scale, bias, *bn._stats_plain(x)

    args = inputs()
    x, r, _, scale, bias, s, q = args
    y, _ = bn._act_plain(x, scale, bias, 1e-5, s, q, R, relu=False)
    err = 0.0
    for res in (None, r):
        got, _ = bn_triton.bn_act(x, scale, bias, 1e-5, s, q, R,
                                  residual=res)
        want, _ = bn._act_plain(x, scale, bias, 1e-5, s, q, R,
                                residual=res)
        diff = (got.float() - want.float()).abs()
        tol = _ulp(y.float(), dtype) + (0 if res is None else _ulp(
            torch.maximum(got.float().abs(), want.float().abs()), dtype))
        if not bool((diff <= tol).all()):
            raise AssertionError(f"bn_act {(R, C)}: kernel and plain "
                                 f"version differ by {diff.max().item()} "
                                 f"beyond one ulp")
        err = max(err, diff.max().item())
    del y, got, want, diff, tol
    copies = [args] + [inputs() for _ in range(
        n_copies(3 * R * C * dtype.itemsize) - 1)]
    times = {}
    for tag, res in (("", False), ("residual_", True)):
        def kernel(x, r, out, scale, bias, s, q, res=res):
            return bn_triton.bn_act(x, scale, bias, 1e-5, s, q, R,
                                    residual=r if res else None, out=out)

        def plain(x, r, out, scale, bias, s, q, res=res):
            return bn._act_plain(x, scale, bias, 1e-5, s, q, R,
                                 residual=r if res else None)
        times[tag + "ms"] = device_ms(kernel, copies)
        times[tag + "plain_ms"] = device_ms(plain, copies)
        times[tag + "eager_ms"] = cuda_ms(kernel, copies)
    return err, times


def act_bound_ms(R, C, residual=False, dtype=None):
    """Least time of bn_act: x (by default bf16), with `residual` the
    residual too, read once and the output written once, and its (C,)
    f32 vectors (Σx, Σx², scale and bias read, mean, var, inv and d
    written), over the HBM rate (its few f32 operations an element take
    a tenth of that)."""
    itemsize = 2 if dtype is None else dtype.itemsize
    return 1e3 * ((3 if residual else 2) * R * C * itemsize + 8 * C * 4) \
        / HBM_BYTES_PER_S


def _as4d(x2, R):
    """(R·B, C) rows of images with R = H·W rows each → the NCHW
    channels_last tensor they view (H·W as square as R allows)."""
    side = int(round(R ** 0.5))
    h, w = (side, R // side) if side * (R // side) == R else (1, R)
    return x2.view(-1, h, w, x2.shape[1]).permute(0, 3, 1, 2)


def kernels_phase(batch, shapes=None, ragged=RAGGED, tag="kernels",
                  dtype=None):
    """K1, K2, bn_dx and bn_act against their plain versions (and timed)
    at the BN shapes of one train step, `shapes` per image (default
    ResNet-50@448's, whose bn3 layers take the residual) times `batch`,
    and at the ragged shape; inputs of `dtype` (by default bf16)."""
    import torch

    from learning_embeddings_tpu_torch.ops import bn, bn_triton

    gen = torch.Generator(device=DEV).manual_seed(0)
    rows = []
    residual = RESNET50_448_RESIDUAL if shapes is None else {}
    shapes = RESNET50_448_BN if shapes is None else shapes
    for (R, C), mult in list(shapes.items()) + ([(ragged, 0)] if ragged
                                                else []):
        Rb = R * batch if mult else R

        def lib_stats(x2, R=R):
            return torch.batch_norm_stats(_as4d(x2, R), 1e-5)

        ones = torch.ones(C, device=DEV)
        zeros = torch.zeros(C, device=DEV)

        def lib_corr(dy2, x2, R=R):
            return torch.batch_norm_backward_reduce(
                _as4d(dy2, R), _as4d(x2, R), zeros, ones, ones,
                True, False, False)[:2]

        row = {"R": Rb, "C": C, "layers": mult}
        for name, kfn, pfn, lfn, n_in in (
                ("bn_stats", bn_triton.bn_stats, bn._stats_plain, lib_stats,
                 1),
                ("bn_corr", bn_triton.bn_corr, bn._corr_plain, lib_corr, 2)):
            err, times = check_reduction(name, kfn, pfn, lfn, Rb, C, n_in,
                                         gen, dtype)
            row[name] = {"max_abs_err": err, **times,
                         "bound_ms": bound_ms(Rb, C, n_in, dtype)}
        err, times = check_dx(Rb, C, gen, dtype)
        row["bn_dx"] = {"max_abs_err": err, **times,
                        "bound_ms": dx_bound_ms(Rb, C, dtype)}
        # per layer: those with the residual at its time, the rest (and
        # the ragged shape) without
        n_res = residual.get((R, C), 0) if mult else 0
        w = n_res / mult if mult else 0.0
        err, t = check_act(Rb, C, gen, dtype)
        row["bn_act"] = {
            "max_abs_err": err, "residual_layers": n_res, **t,
            **{k: (1 - w) * t[k] + w * t["residual_" + k]
               for k in ("ms", "plain_ms", "eager_ms")},
            "library_ms": None,
            "bound_ms": (1 - w) * act_bound_ms(Rb, C, False, dtype)
            + w * act_bound_ms(Rb, C, True, dtype)}
        rows.append(row)
        log(f"[{tag}] R={Rb:>8} C={C:>4} x{mult:<2} " + " | ".join(
            f"{n} {row[n]['ms'] * 1e3:7.1f}us (eager "
            f"{row[n]['eager_ms'] * 1e3:6.1f}, plain "
            f"{row[n]['plain_ms'] * 1e3:7.1f}, library "
            f"{row[n]['library_ms'] * 1e3:7.1f}, bound "
            f"{row[n]['bound_ms'] * 1e3:6.1f}) err {row[n]['max_abs_err']:.3g}"
            for n in ("bn_stats", "bn_corr", "bn_dx")))
        a = row["bn_act"]
        log(f"[{tag}] R={Rb:>8} C={C:>4} x{mult:<2} bn_act "
            f"{a['ms'] * 1e3:7.1f}us a layer (residual "
            f"{a['residual_ms'] * 1e3:7.1f}, eager {a['eager_ms'] * 1e3:6.1f},"
            f" plain {a['plain_ms'] * 1e3:7.1f}, bound "
            f"{a['bound_ms'] * 1e3:6.1f}) err {a['max_abs_err']:.3g}")
    return rows


def bound_ms(R, C, n_in, dtype=None):
    """Least time: each input (by default bf16) read once and the two f32
    (C,) outputs written once over the HBM rate, or 3 f32 operations per
    element over the f32 rate, whichever is larger (always the bytes
    here)."""
    itemsize = 2 if dtype is None else dtype.itemsize
    by_bytes = (n_in * R * C * itemsize + 2 * C * 4) / HBM_BYTES_PER_S
    by_ops = 3 * R * C / F32_FLOPS
    return 1e3 * max(by_bytes, by_ops)


def k3_bound(M, N, D):
    """(bound ms, bound_by) of pairwise_order: u and v read once and the
    (M, N) f32 output written once over the HBM rate, against a sub, a max
    and an FMA (two flops) per (i, j, d) over the f32 rate."""
    by_bytes = 4 * (M * D + N * D + M * N) / HBM_BYTES_PER_S
    by_ops = 4 * M * N * D / F32_FLOPS
    return 1e3 * max(by_bytes, by_ops), \
        ("bytes" if by_bytes >= by_ops else "operations")


def k3_build_report(build):
    """Waits for the nvcc build; logs its time and ptxas' resource use of
    each kernel instance (exact_d at each D, generic)."""
    import re

    fut, t0 = build
    so, t1 = fut.result()
    seconds = t1 - t0
    with open(so[:-3] + ".log") as f:
        lines = [ln.strip() for ln in f]
    report, name = {}, None
    for ln in lines:
        m = re.search(r"entry function '(\S+)'", ln)
        if m:
            d = re.search(r"exact_kernelILi(\d+)E", m.group(1))
            name = f"exact_d D={d.group(1)}" if d else (
                "generic" if "generic_kernel" in m.group(1) else m.group(1))
        elif name and ("Used" in ln or "spill" in ln):
            report[name] = (report.get(name, "") + " " + ln.replace(
                "ptxas info    : ", "")).strip()
    log(f"[kernels] pairwise_order library {os.path.basename(so)} built "
        f"in {seconds:.1f} s (nvcc, beside the Triton builds)")
    for k, v in report.items():
        log(f"[kernels]   ptxas {k}: {v}")
    return {"library": os.path.basename(so), "build_s": seconds,
            "ptxas": report}


def check_k3(M, N, D, gen, timed):
    """pairwise_order against its plain version at (M, N, D): integer
    inputs exactly, normal inputs within 1e-5·Σ_d terms + 1e-6; with
    `timed`, the device ms of both (CUDA graph, inputs rotated past the
    L2) and the kernel's eager ms."""
    import torch

    from learning_embeddings_tpu_torch.ops import pairwise_order as k3
    from learning_embeddings_tpu_torch.utils import profiling

    def ints(n):
        return torch.randint(-3, 4, (n, D), device=DEV, generator=gen) \
            .float()

    route = k3.route_for(D)
    ui, vi = ints(M), ints(N)
    before = profiling.counts()
    got, exact = k3.pairwise_order(ui, vi), k3.pairwise_order_plain(ui, vi)
    launched = profiling.counts() - before
    ran = "exact_d" if launched["pairwise_order_exact_d"] else (
        "generic" if launched["pairwise_order_generic"] else None)
    if ran != route:
        raise AssertionError(f"pairwise_order {(M, N, D)} launched {ran}, "
                             f"expected {route}")
    if not torch.equal(got, exact):
        raise AssertionError(f"pairwise_order {(M, N, D)}: integer inputs "
                             f"differ by {(got - exact).abs().max().item()}")
    u = torch.randn((M, D), device=DEV, generator=gen)
    v = torch.randn((N, D), device=DEV, generator=gen)
    ref = k3.pairwise_order_plain(u, v)
    err = k3_compare(f"pairwise_order {(M, N, D)}", k3.pairwise_order(u, v),
                     ref)
    row = {"M": M, "N": N, "D": D, "route": route, "max_abs_err": err}
    if timed:
        # the generic kernel on the same inputs: checked, then timed in
        # turns with the exact_d one (exact, generic, generic, exact)
        err_g = k3_compare(f"pairwise_order_generic {(M, N, D)}",
                           k3.pairwise_order_generic(u, v), ref)
        copies = [(torch.randn((M, D), device=DEV, generator=gen),
                   torch.randn((N, D), device=DEV, generator=gen))
                  for _ in range(n_copies(4 * (M * D + N * D + M * N)))]
        bound, by = k3_bound(M, N, D)
        turns = [device_ms(fn, copies) for fn in (
            k3.pairwise_order, k3.pairwise_order_generic,
            k3.pairwise_order_generic, k3.pairwise_order)]
        plan = k3.device_plan(M, N, D, DEV)
        row.update(plan={"tile": plan.tile, "tiles": plan.tiles_m
                         * plan.tiles_n, "grid": plan.grid,
                         "blocks_per_sm": k3.exact_blocks_per_sm(D, DEV)},
                   ms=(turns[0] + turns[3]) / 2,
                   generic_ms=(turns[1] + turns[2]) / 2, turns_ms=turns,
                   generic_max_abs_err=err_g,
                   plain_ms=device_ms(k3.pairwise_order_plain, copies),
                   eager_ms=cuda_ms(k3.pairwise_order, copies),
                   bound_ms=bound, bound_by=by)
    return row


def k3_compare(what, got, ref):
    """|kernel − plain| ≤ 1e-5·Σ_d terms + 1e-6; `ref` is that sum (the
    terms are non-negative). Returns the largest difference."""
    diff = (got - ref).abs()
    if got.shape != ref.shape or not bool((diff <= 1e-5 * ref + 1e-6)
                                          .all()):
        raise AssertionError(f"{what}: kernel and plain version differ by "
                             f"{diff.max().item() if diff.numel() else '?'} "
                             f"(tolerance 1e-5·Σ terms + 1e-6)")
    return diff.max().item() if diff.numel() else 0.0


def eval_shapes(n_labels):
    """The joint eval's three pairwise_order shapes at n_labels labels."""
    return [(n_labels, VAL_IMAGES, EMB_DIM), (n_labels, n_labels, EMB_DIM),
            (n_labels, TEST_IMAGES, EMB_DIM)]


def k3_phase(build, n_labels):
    """pairwise_order at the joint eval's shapes and ETHEC's (timed, both
    routes) and ragged ones."""
    import torch

    from learning_embeddings_tpu_torch.ops import pairwise_order as k3

    report = k3_build_report(build)
    gen = torch.Generator(device=DEV).manual_seed(3)
    rows = []
    path = eval_shapes(n_labels)
    timed = path + [s for s in eval_shapes(ETHEC_LABELS) if s not in path]
    for shape in timed + K3_RAGGED:
        row = check_k3(*shape, gen, timed=shape in timed)
        row["on_path"] = shape in path
        rows.append(row)
        log(f"[kernels] pairwise_order {shape} {row['route']}: err "
            f"{row['max_abs_err']:.3g}" + (
                f", {row['ms'] * 1e3:.2f}us (turns "
                f"{[round(t * 1e3, 2) for t in row['turns_ms']]}; generic "
                f"{row['generic_ms'] * 1e3:.2f}, eager "
                f"{row['eager_ms'] * 1e3:.1f}, plain "
                f"{row['plain_ms'] * 1e3:.1f}, bound "
                f"{row['bound_ms'] * 1e3:.2f} by {row['bound_by']}, "
                f"{row['bound_ms'] / row['ms']:.0%} of it; plan "
                f"{row['plan']})" if "ms" in row else ""))
    empty = k3.pairwise_order(torch.zeros((0, EMB_DIM), device=DEV),
                              torch.zeros((7, EMB_DIM), device=DEV))
    if empty.shape != (0, 7):
        raise AssertionError(f"pairwise_order M = 0 gave {empty.shape}")
    return {"build": report, "shapes": rows}


def _rel_gap(got, want):
    """‖got − want‖ / ‖want‖ in f32."""
    got, want = got.detach().float(), want.detach().float()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def window_attention_bound_ms(batch, windows, heads):
    """The window attention's byte bound of one block's forward and
    backward: 24·T·C bytes an image (bf16 q, k, v read and o written in the
    forward; q, k, v, o and dO read and dq, dk, dv written in the
    backward), T = nW·N tokens, C = heads·d; the bias is not counted."""
    T, C = windows * SWIN_WINDOW ** 2, heads * SWIN_HEAD_WIDTH
    return 24 * T * C * batch / HBM_BYTES_PER_S * 1e3


def check_window_attention(windows, heads, grid, shifted, batch, gen,
                           timed):
    """The kernel pair at one Swin-L stage shape, `batch` images, against
    the plain route on the same bf16 inputs: the output within 2^-7 of its
    norm, the packed qkv gradient and the bias's gradient (summed over the
    images) within 2^-6, the card tests' limits; one forward and one
    backward counted as "window_attention". Where `timed`: the kernel's
    forward (recorded for autograd, as in a train step) and backward, the
    plain route's, and the memory-efficient SDPA's on the same q, k, v
    unpacked and the same bias (the port's route until the kernel), each
    fwd + bwd in ms."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from learning_embeddings_tpu_torch.models import swin
    from learning_embeddings_tpu_torch.ops import window_attention as wa
    from learning_embeddings_tpu_torch.utils import profiling

    N, d = SWIN_WINDOW ** 2, SWIN_HEAD_WIDTH
    C = heads * d
    qkv = torch.randn(batch, windows, N, 3 * C, device=DEV,
                      generator=gen).to(torch.bfloat16).requires_grad_(True)
    att = swin.ShiftedWindowAttention(C, heads, SWIN_WINDOW).to(DEV)
    with torch.no_grad():
        att.relative_position_bias_table.copy_(torch.randn(
            att.relative_position_bias_table.shape, device=DEV,
            generator=gen) * 0.5)
    mask = (swin.shift_mask(grid, SWIN_WINDOW, SWIN_WINDOW // 2).to(DEV)
            if shifted else None)
    bias = att.bias(mask, windows).detach().to(torch.bfloat16) \
        .requires_grad_(True)
    dout = torch.randn(batch, windows, N, C, device=DEV, generator=gen).to(
        torch.bfloat16)

    def grads(fn):
        out = fn(qkv, bias, heads)
        dqkv, dbias = torch.autograd.grad(out, (qkv, bias), dout)
        torch.cuda.synchronize()
        return out.detach(), dqkv, dbias

    before = profiling.counts()
    got = grads(wa.window_attention)
    launched = (profiling.counts() - before)["window_attention"]
    want = grads(wa.window_attention_plain)
    what = (f"window_attention (B {batch}, nW {windows}, H {heads}, "
            f"{'shifted' if shifted else 'not shifted'})")
    if launched != 2:
        raise AssertionError(f"{what}: {launched} kernel launches counted "
                             f"for one forward and backward, expected 2")
    if got[2].dtype != torch.bfloat16 or got[1].shape != qkv.shape:
        raise AssertionError(f"{what}: qkv gradient {tuple(got[1].shape)}, "
                             f"bias gradient {got[2].dtype}")
    rel = {k: _rel_gap(g, w) for k, g, w in zip(("out", "dqkv", "dbias"),
                                                   got, want)}
    limits = {"out": 2 ** -7, "dqkv": 2 ** -6, "dbias": 2 ** -6}
    if any(rel[k] > limits[k] for k in rel):
        raise AssertionError(f"{what}: relative gaps to the plain route "
                             f"{rel}, limits {limits}")
    row = {"windows": windows, "heads": heads, "grid": grid,
           "shifted": shifted, "rel_err": rel,
           "max_abs_err": max(float((g.float() - w.float()).abs().max())
                              for g, w in zip(got, want))}
    del got, want
    if timed:
        B, H = batch, heads
        q, k, v = (t.contiguous().requires_grad_(True) for t in qkv.detach()
                   .view(B, windows, N, 3, H, d).permute(3, 0, 1, 4, 2, 5)
                   .reshape(3, B, windows * H, N, d).unbind(0))
        dsplit = dout.view(B, windows, N, H, d).transpose(2, 3).reshape(
            B, windows * H, N, d)

        def library():
            with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
                return torch.autograd.grad(sdpa(q, k, v, attn_mask=bias),
                                           (q, k, v, bias), dsplit)

        def route(fn):
            return lambda: torch.autograd.grad(fn(qkv, bias, heads),
                                               (qkv, bias), dout)

        fwd_ms = cuda_ms(lambda: wa.window_attention(qkv, bias, heads),
                         [()], iters=10)
        row.update(
            fwd_ms=fwd_ms,
            ms=cuda_ms(route(wa.window_attention), [()], iters=10),
            plain_ms=cuda_ms(route(wa.window_attention_plain), [()],
                             iters=5),
            library_ms=cuda_ms(library, [()], iters=10),
            bound_ms=window_attention_bound_ms(batch, windows, heads))
        row["bwd_ms"] = row["ms"] - fwd_ms
    return row


def swin_step_launches(labelmap, batch):
    """One Swin-L train step at 384² (bf16, multi_level_ce, Adam) after a
    warm-up step, the counters reset just before it: every window
    attention through the kernel pair (48 "window_attention", with 48
    "attention" and "attention_bias" and 96 "swin_windows"), no BatchNorm
    kernel, a finite loss."""
    import torch

    from learning_embeddings_tpu_torch.train.classifier import (
        ClassifierConfig, ClassifierTrainer)
    from learning_embeddings_tpu_torch.utils import profiling

    trainer = ClassifierTrainer(labelmap, ClassifierConfig(
        backbone="swin_l", criterion="multi_level_ce", optimizer="adam",
        lr=1e-5, image_size=384, batch_size=batch, seed=0,
        dtype=torch.bfloat16, device=DEV))
    gen = torch.Generator(device=DEV).manual_seed(4)
    images = torch.randint(0, 256, (batch, 384, 384, 3), dtype=torch.uint8,
                           device=DEV, generator=gen)
    paths = torch.as_tensor(labelmap.leaf_paths(), device=DEV)
    leaves = torch.randint(0, labelmap.levels[-1], (batch,), device=DEV,
                           generator=gen)
    batch_t = trainer.put_batch(images, paths[leaves],
                                torch.zeros((batch, labelmap.n_classes),
                                            device=DEV))
    state, loss = trainer.train_step(trainer.state, *batch_t)
    torch.cuda.synchronize()
    profiling.reset_counts()
    state, loss = trainer.train_step(state, *batch_t)
    torch.cuda.synchronize()
    c = profiling.counts()
    names = ("window_attention", "attention", "attention_bias",
             "swin_windows", "bn_stats", "bn_corr", "bn_dx", "bn_act")
    got = {k: c.get(k, 0) for k in names}
    want = dict(zip(names, (48, 48, 48, 96, 0, 0, 0, 0)))
    if got != want or not math.isfinite(float(loss)):
        raise AssertionError(f"Swin-L step (B {batch}): counts {got}, "
                             f"expected {want}; loss {float(loss)}")
    del trainer, state, batch_t, images
    return got


def window_attention_phase(labelmap, batch=SWIN_BATCH):
    """The window attention's kernel pair at Swin-L's four stage shapes at
    the Swin cell's batch, shifted and not (stage 4 has no shift), held
    against the plain route and timed once a stage beside the
    memory-efficient SDPA and the byte bound; then the counts of one
    Swin-L train step at that batch. The step's ms sum each stage's
    forward and backward over its blocks."""
    import torch

    gen = torch.Generator(device=DEV).manual_seed(5)
    t0 = time.perf_counter()
    rows = []
    for windows, heads, grid, depth in SWIN_L_STAGES:
        for shifted in ((True, False) if grid > SWIN_WINDOW else (False,)):
            row = check_window_attention(windows, heads, grid, shifted,
                                         batch, gen, timed=shifted
                                         or grid == SWIN_WINDOW)
            row["blocks"] = depth
            rows.append(row)
            log(f"[kernels] window_attention nW {windows} H {heads} "
                f"{'shifted' if shifted else 'plain'}: rel err "
                f"{ {k: round(v, 5) for k, v in row['rel_err'].items()} }"
                + (f", {row['ms']:.3f} ms (fwd {row['fwd_ms']:.3f}; plain "
                   f"{row['plain_ms']:.2f}, library {row['library_ms']:.3f},"
                   f" bound {row['bound_ms']:.3f}) a block"
                   if "ms" in row else ""))
            torch.cuda.empty_cache()
    timed = [r for r in rows if "ms" in r]
    step = {k: sum(r[k] * r["blocks"] for r in timed)
            for k in ("ms", "fwd_ms", "bwd_ms", "plain_ms", "library_ms",
                      "bound_ms")}
    launches = swin_step_launches(labelmap, batch)
    torch.cuda.empty_cache()
    log(f"[kernels] window_attention over Swin-L's 24 blocks at B {batch}: "
        f"{step['ms']:.2f} ms a step (plain {step['plain_ms']:.2f}, library "
        f"{step['library_ms']:.2f}, bound {step['bound_ms']:.2f}); a step's "
        f"counts {launches}; {time.perf_counter() - t0:.1f} s")
    return {"batch": batch, "step": step, "step_launches": launches,
            "shapes": rows}


def window_attention_record(wa_result, by_path):
    """The kernels line's record of the window attention's kernel pair."""
    rows = wa_result["shapes"]
    return {
        "name": "window_attention", "route": "cuda",
        "source": KERNEL_SRC["window_attention"],
        "replaces": TPU_KERNELS["window_attention"],
        "replaces_note": "no TPU kernel: the JAX package has no "
                         "transformer; replaces the memory-efficient SDPA "
                         "call and the q/k/v split, output transpose and "
                         "dq/dk/dv stack around it",
        "launches": wa_result["step_launches"]["window_attention"],
        "launches_by_path": dict(
            by_path("window_attention"),
            **{f"swin_l_384_b{wa_result['batch']}_step":
               wa_result["step_launches"]["window_attention"]}),
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "max_rel_err": {k: max(r["rel_err"][k] for r in rows)
                        for k in ("out", "dqkv", "dbias")},
        **wa_result["step"], "bound_by": "bytes",
        "library_note": "memory-efficient SDPA with the bias as its float "
                        "mask, on q, k, v already split (a yardstick the "
                        "port no longer calls)",
        "batch": wa_result["batch"],
        "shapes": [{k: r[k] for k in ("windows", "heads", "blocks", "ms",
                                      "fwd_ms", "bwd_ms", "plain_ms",
                                      "library_ms", "bound_ms")}
                   for r in rows if "ms" in r],
    }


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


def small_joint_phase(image_size=64):
    """One f32 JointCNNTrainer step (ResNet-18, order energy) and its eval
    on the card (kernels) and on the CPU (plain versions), from the same
    seed: the same weights and host negatives. 24 train images with
    distinct pixels and 8 label→image edges a step, so the tower sees 16
    distinct images (with a few repeated ones, a train-mode BN layer at
    1×1 spatial size normalises a variance near 0, and two summation
    orders then disagree by far more than rounding). The tower trains at
    lr 1e-5: Adam's first step moves each weight by about ±lr, and the
    sign of a gradient within rounding of 0 differs between the two
    devices; at 1e-3 those entries moved the eval's embeddings by 3.5e-4
    (NVIDIA H100 80GB HBM3, 700.00 W)."""
    import numpy as np
    import torch

    from learning_embeddings_tpu_torch.hierarchy import toy_labelmap
    from learning_embeddings_tpu_torch.losses.joint_sampling import (
        build_joint_graph)
    from learning_embeddings_tpu_torch.train.joint_cnn import (
        JointCNNConfig, JointCNNTrainer)

    lm = toy_labelmap(2, 3)
    rng = np.random.RandomState(0)
    graph, edges = build_joint_graph(
        lm, lm.leaf_paths()[rng.randint(0, lm.levels[-1], 24)])
    bank = rng.randint(0, 256, (24, image_size, image_size, 3)) \
        .astype(np.uint8)
    batch = edges[edges[:, 1] >= graph.n_labels][::3][:8]
    val_paths = (lm.leaf_paths()[rng.randint(0, lm.levels[-1], 12)]
                 + np.asarray(lm.level_start)[None, :])
    prev_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False   # full f32 convs for this check
    try:
        res = {}
        for dev in ("cpu", DEV):
            tr = JointCNNTrainer(lm, graph, edges, lambda r: bank[r % 24],
                                 JointCNNConfig(
                                     energy="order", backbone="resnet18",
                                     embedding_dim=4,
                                     image_size=image_size, batch_size=8,
                                     neg_to_pos_ratio=4, alpha=0.5,
                                     lr_images=1e-5, tower_dtype="float32",
                                     device=dev))
            loss, e_pos, e_neg = tr.train_batch(batch[:, 0], batch[:, 1])
            emb = tr.image_embeddings_for_rows(np.arange(12), batch_size=5)
            res[dev] = {
                "loss": loss, "e_pos": e_pos.cpu(), "e_neg": e_neg.cpu(),
                "emb": emb,
                "hit@1": tr.classification_metrics(val_paths, emb)["hit@1"],
                "rec_f1": float(tr.reconstruction().f1)}
    finally:
        torch.backends.cudnn.allow_tf32 = prev_tf32
    card, cpu = res[DEV], res["cpu"]
    checks = {
        "loss": abs(card["loss"] - cpu["loss"]) <= 1e-4 * abs(cpu["loss"]),
        "e_pos": torch.allclose(card["e_pos"], cpu["e_pos"], rtol=1e-3,
                                atol=1e-4),
        "e_neg": torch.allclose(card["e_neg"], cpu["e_neg"], rtol=1e-3,
                                atol=1e-4),
        "emb": np.allclose(card["emb"], cpu["emb"], rtol=1e-3, atol=1e-4),
        "hit@1": card["hit@1"] == cpu["hit@1"],
        "rec_f1": abs(card["rec_f1"] - cpu["rec_f1"]) <= 1e-4,
    }
    if not all(checks.values()):
        raise AssertionError(f"small joint step: card and CPU disagree on "
                             f"{[k for k, ok in checks.items() if not ok]}:"
                             f" card {card} CPU {cpu}")
    log(f"[kernels] resnet18 {image_size}² f32 joint step + eval: loss card "
        f"{card['loss']:.6f} CPU {cpu['loss']:.6f} (limit 1e-4 rel); "
        f"energies, embeddings (rtol 1e-3, atol 1e-4), hit@1 "
        f"{card['hit@1']:.4f} and reconstruction F1 {card['rec_f1']:.4f} "
        f"agree")


def _annulus_error(rows, r0):
    """How far the row norms of `rows` lie outside [r0, 1 − 1e−5] (0 when
    all lie inside)."""
    import torch

    n = torch.as_tensor(rows).float().norm(dim=-1)
    return max(0.0, (r0 - n).max().item(), (n - (1 - 1e-5)).max().item())


#: row norms are computed in f32 after the projection: allowed rounding
ANNULUS_TOL = 1e-6


def small_hyp_joint_phase(image_size=64):
    """One f32 JointCNNTrainer step with the hyperbolic-cone energy
    (ResNet-18, the hyp_cone_exp0 maps) for each label optimizer, on the
    card and on the CPU from the same seed, then the labels × images
    energies of 12 images. Same sizes and lr_images 1e-5 as
    small_joint_phase (see there). Compared: the loss (rel 1e-4), the
    label table (abs 1e-5), the step's energies (|Δ| ≤ 1e-4 + 1e-3·|E|,
    as small_joint_phase's; abs 1e-5 failed at 1.4e-5 on an H100) and the
    eval energies (|Δ| ≤ 1e-3 + 1e-3·|E|: near the inner radius the
    cone's aperture asin(K(1 − ‖x‖²)/‖x‖) sits at its clamp, where its
    gradient is ~229, so an embedding difference of 1e-6 moves an energy
    by ~2e-4); every
    label embedding, and the table where it is projected, within
    [r0, 1 − 1e−5] up to 1e-6 of rounding."""
    import numpy as np
    import torch

    from learning_embeddings_tpu_torch.geometry import (inner_radius,
                                                        pairwise_energy)
    from learning_embeddings_tpu_torch.hierarchy import toy_labelmap
    from learning_embeddings_tpu_torch.losses.joint_sampling import (
        build_joint_graph)
    from learning_embeddings_tpu_torch.train.joint_cnn import (
        JointCNNConfig, JointCNNTrainer)

    lm = toy_labelmap(2, 3)
    rng = np.random.RandomState(0)
    graph, edges = build_joint_graph(
        lm, lm.leaf_paths()[rng.randint(0, lm.levels[-1], 24)])
    bank = rng.randint(0, 256, (24, image_size, image_size, 3)) \
        .astype(np.uint8)
    batch = edges[edges[:, 1] >= graph.n_labels][::3][:8]
    r0 = inner_radius(0.1)
    out = {}
    prev_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False   # full f32 convs for this check
    try:
        for opt in ("adam", "rsgd", "radam"):
            res = {}
            for dev in ("cpu", DEV):
                tr = JointCNNTrainer(lm, graph, edges, lambda r: bank[r % 24],
                                     JointCNNConfig(
                                         energy="hyp_cone",
                                         optimizer_labels=opt,
                                         backbone="resnet18",
                                         embedding_dim=4,
                                         image_size=image_size,
                                         batch_size=8, neg_to_pos_ratio=4,
                                         alpha=0.5, lr_images=1e-5,
                                         tower_dtype="float32", device=dev))
                loss, e_pos, e_neg = tr.train_batch(batch[:, 0], batch[:, 1])
                emb = tr.image_embeddings_for_rows(np.arange(12),
                                                   batch_size=5)
                lab = tr.label_embeddings()
                res[dev] = {
                    "loss": loss, "e_pos": e_pos.cpu(), "e_neg": e_neg.cpu(),
                    "table": tr.embedder.embedding.detach().cpu(),
                    "labels": lab.cpu(),
                    "energies": pairwise_energy(
                        "hyp_cone", lab, torch.as_tensor(emb, device=lab
                                                         .device),
                        K=0.1).cpu()}
            card, cpu = res[DEV], res["cpu"]
            errs = {
                "loss": abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"]),
                "e_pos": ((card["e_pos"] - cpu["e_pos"]).abs()
                          - 1e-3 * cpu["e_pos"].abs()).max().item(),
                "e_neg": ((card["e_neg"] - cpu["e_neg"]).abs()
                          - 1e-3 * cpu["e_neg"].abs()).max().item(),
                "table": (card["table"] - cpu["table"]).abs().max().item(),
                "energies": ((card["energies"] - cpu["energies"]).abs()
                             - 1e-3 * cpu["energies"].abs()).max().item(),
                "annulus": max(_annulus_error(card["labels"], r0),
                               _annulus_error(card["table"], r0)
                               if opt != "rsgd" else 0.0)}
            limits = {"loss": 1e-4, "e_pos": 1e-4, "e_neg": 1e-4,
                      "table": 1e-5, "energies": 1e-3,
                      "annulus": ANNULUS_TOL}
            bad = {k: v for k, v in errs.items() if not v <= limits[k]}
            if bad:
                raise AssertionError(
                    f"small hyperbolic joint step ({opt}): card and CPU "
                    f"disagree on {bad} (limits {limits})")
            out[opt] = errs
            log(f"[kernels] resnet18 {image_size}² f32 hyp_cone joint step "
                f"({opt}): loss card {card['loss']:.6f} CPU "
                f"{cpu['loss']:.6f}; differences {errs} within {limits}")
    finally:
        torch.backends.cudnn.allow_tf32 = prev_tf32
    return out


# --------------------------------------------------------------------------
# phase 3: slice 1, the classifier path
# --------------------------------------------------------------------------
def slice_phase(labelmap, batch, steps=3, warmup=2):
    import torch

    from learning_embeddings_tpu_torch.ops.bn import FusedBatchNorm
    from learning_embeddings_tpu_torch.train.classifier import (
        ClassifierConfig, ClassifierTrainer)
    from learning_embeddings_tpu_torch.utils import profiling

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

    # every layer's input shape, read where the trunk calls it: its `act`
    # (a forward hook would miss the layers the blocks reach through act)
    seen = []

    def watch(m):
        act = m.act

        def counted(x, *a, **k):
            seen.append((x.numel() // x.shape[1], x.shape[1]))
            return act(x, *a, **k)
        m.act = counted

    for m in bns:
        watch(m)

    # the main path: counts set to 0 just before, read just after
    profiling.reset_counts()
    state, losses = trainer.state, []
    for i in range(warmup):
        state, loss = trainer.train_step(state, *batch_t)
        losses.append(loss)
        if i == 0:
            for m in bns:
                del m.act
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, loss = trainer.train_step(state, *batch_t)
        losses.append(loss)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counted = profiling.counts()
    launches = {k: counted[k] for k in ("bn_stats", "bn_corr", "bn_dx",
                                        "bn_act")}
    copies = counted["channels_last_copies"]

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
        f"(53 + 53 + 53 + 53 per step), channels_last copies {copies}")
    log(f"[slice] {result['ms_per_step']:.2f} ms/step, "
        f"{result['images_per_s']:.1f} images/s, peak memory "
        f"{result['max_memory_allocated_gib']:.2f} GiB")
    return trainer, state, batch_t, result


# --------------------------------------------------------------------------
# profile of one step
# --------------------------------------------------------------------------
PROFILED = {"bn_stats": "bn_stats_kernel", "bn_corr": "bn_corr_kernel",
            "pairwise_order": "pairwise_order_"}


def profile_phase(step, tag):
    """The profiler's view of one call of `step()`: wall time, device busy
    time and idle share, the time of each kernel of the port and the
    largest device entries."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)

    per_name, annotated_us = {}, 0.0
    for evt in prof.key_averages():
        if not str(evt.device_type).endswith("CUDA"):   # kernels only
            continue
        us = float(evt.self_device_time_total)
        if getattr(evt, "is_user_annotation", False):
            # a range such as Optimizer.step#Adam.step that spans kernels
            # counted on their own: not device time of its own
            annotated_us += us
            continue
        if us > 0:
            per_name[evt.key] = (per_name.get(evt.key, (0.0, 0))[0] + us,
                                 evt.count)
    busy = sum(us for us, _ in per_name.values())
    kern = {}
    for name, pat in PROFILED.items():
        hits = [(k, v) for k, v in per_name.items() if pat in k]
        kern[name] = {"ms": sum(v[0] for _, v in hits) / 1e3,
                      "count": sum(v[1] for _, v in hits)} if hits else None
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:12]
    out = {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
           "idle_share": (1 - busy / wall_us) if busy else None,
           "device_entries": sum(n for _, n in per_name.values()),
           "annotated_ms": annotated_us / 1e3,
           "kernels": kern,
           "top": [{"name": k[:80], "ms": v[0] / 1e3, "count": v[1]}
                   for k, v in top],
           "per_name_ms": {k: v[0] / 1e3 for k, v in per_name.items()}}
    if busy == 0:
        log(f"[{tag}] the profiler saw no device time: per-step kernel "
            "time from the profiler not measured")
    else:
        log(f"[{tag}] profiled step: wall {out['wall_ms']:.2f} ms, device "
            f"busy {out['device_busy_ms']:.2f} ms (idle share "
            f"{out['idle_share']:.3f}) in {out['device_entries']} kernels "
            f"and copies (annotated ranges left out: "
            f"{out['annotated_ms']:.3f} ms); " + ", ".join(
                f"{k} {v}" for k, v in kern.items() if v))
        for t in out["top"]:
            log(f"[{tag}]   {t['ms']:9.3f} ms x{t['count']:<4} {t['name']}")
    return out


# --------------------------------------------------------------------------
# phase 4: slice 2, the joint --use_CNN path and its eval
# --------------------------------------------------------------------------
def _unique_tower_images(prepared, n_labels):
    """Distinct images the tower embeds in one prepared step (the JAX
    bench's count, bench.py:32-39): image nodes among both endpoints of
    the positive and negative edges."""
    import numpy as np

    ids = np.concatenate([prepared[j].cpu().numpy() for j in (1, 2, 3, 4)])
    return int(len(np.unique(ids[ids >= n_labels])))


def _split_paths(labelmap, n, rng):
    """(n, L) global ancestor paths of n synthetic images of random
    leaves."""
    import numpy as np

    leaves = rng.randint(0, labelmap.levels[-1], n)
    return (labelmap.leaf_paths()[leaves]
            + np.asarray(labelmap.level_start)[None, :]).astype(np.int32)


def joint_phase(labelmap, image_size=448, batch=16, n_train=2048,
                n_val=VAL_IMAGES, n_test=TEST_IMAGES, eval_chunk=128,
                steps=5, warmup=2, energy="order", tag="joint"):
    """The joint step at full width (bench.py:113-143 with `energy`; Adam
    on the labels, under hyp_cone the hybrid) and the runner's eval. The
    order energy's eval must launch pairwise_order (exact_d), the cone
    energies' none."""
    import numpy as np
    import torch

    from learning_embeddings_tpu_torch.geometry import inner_radius

    from learning_embeddings_tpu_torch.losses.joint_sampling import (
        build_joint_graph)
    from learning_embeddings_tpu_torch.ops import pairwise_order as k3
    from learning_embeddings_tpu_torch.train.joint_cnn import (
        JointCNNConfig, JointCNNTrainer)
    from learning_embeddings_tpu_torch.utils import profiling

    nl = labelmap.n_classes
    rng = np.random.RandomState(0)
    graph, train_edges = build_joint_graph(
        labelmap, labelmap.leaf_paths()[rng.randint(0, labelmap.levels[-1],
                                                    n_train)])
    # label→image edges only: every step drives the tower with pixels
    img_edges = train_edges[train_edges[:, 1] >= nl]
    bank = rng.randint(0, 256, (64, image_size, image_size, 3),
                       dtype=np.uint8)

    def pixel_loader(rows):
        return bank[np.asarray(rows) % len(bank)]

    cfg = JointCNNConfig(energy=energy, backbone="resnet50",
                         embedding_dim=EMB_DIM, image_size=image_size,
                         batch_size=batch, neg_to_pos_ratio=5, alpha=0.05,
                         pick_per_level=True, lr_labels=1e-2,
                         lr_images=1e-3, tower_dtype="bfloat16", seed=0,
                         device=DEV)
    trainer = JointCNNTrainer(labelmap, graph, img_edges[:10000],
                              pixel_loader, cfg)
    edges = img_edges[rng.permutation(len(img_edges))]

    # host prep (negatives, pixel gather, copies to the card) up front
    t0 = time.perf_counter()
    prepared = [trainer.prepare_batch(*edges[i * batch:(i + 1) * batch].T)
                for i in range(warmup + steps)]
    torch.cuda.synchronize()
    prep_ms = 1e3 * (time.perf_counter() - t0) / len(prepared)
    timed = prepared[warmup:]
    n_imgs = sum(_unique_tower_images(p, nl) for p in timed)
    tower_rows = [int(p[0].shape[0]) for p in prepared]

    # the main path, training and eval: counts set to 0 just before,
    # read just after
    profiling.reset_counts()
    losses = []
    warmed = set()
    for p in prepared[:warmup]:
        warmed.add(p[0].shape[0])
        losses.append(trainer.train_prepared(p)[0])
    for p in timed:   # each tower batch size once before the clock
        if p[0].shape[0] not in warmed:
            warmed.add(p[0].shape[0])
            losses.append(trainer.train_prepared(p)[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for p in timed:
        losses.append(trainer.train_prepared(p)[0])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    n_steps = len(losses)

    ev = {}
    t0 = time.perf_counter()
    val_paths = _split_paths(labelmap, n_val, rng)
    val_emb = trainer.image_embeddings_for_rows(np.arange(n_val),
                                                batch_size=eval_chunk)
    ev["embed_val_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    m_val = trainer.classification_metrics(val_paths, val_emb)
    ev["ranking_val_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    em_val = trainer.edge_metrics(val_paths, val_emb)
    trainer.optimal_threshold = float(em_val.threshold)
    ev["edge_val_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rec = trainer.reconstruction()
    ev["reconstruction_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    test_paths = _split_paths(labelmap, n_test, rng)
    test_emb = trainer.image_embeddings_for_rows(
        np.arange(n_val, n_val + n_test), batch_size=eval_chunk)
    m_test = trainer.classification_metrics(test_paths, test_emb)
    em_test = trainer.edge_metrics(test_paths, test_emb,
                                   threshold=trainer.optimal_threshold)
    ev["test_s"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = profiling.counts()

    losses = [float(l) for l in losses]
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"joint step: non-finite losses {losses}")
    for name in ("bn_stats", "bn_corr"):
        if launches[name] != 53 * n_steps:
            raise AssertionError(f"{name}: {launches[name]} launches in "
                                 f"{n_steps} joint steps and the eval, "
                                 f"expected {53 * n_steps}")
    if energy == "order" and (launches["pairwise_order"] < 2 or launches[
            "pairwise_order_exact_d"] != launches["pairwise_order"]):
        raise AssertionError(f"pairwise_order launched {launches} in the "
                             f"eval, expected at least 2, all exact_d "
                             f"(D = {EMB_DIM})")
    if energy != "order" and launches["pairwise_order"]:
        raise AssertionError(f"pairwise_order launched {launches} with the "
                             f"{energy} energy, expected none")
    annulus = None
    if energy == "hyp_cone":
        r0 = inner_radius(trainer.K)
        annulus = max(_annulus_error(trainer.label_embeddings(), r0),
                      _annulus_error(trainer.embedder.embedding.detach(), r0))
        if annulus > ANNULUS_TOL:
            raise AssertionError(f"label rows lie {annulus} outside the "
                                 f"annulus [{r0}, 1 - 1e-5]")
    for name, emb, n in (("val", val_emb, n_val), ("test", test_emb, n_test)):
        if emb.shape != (n, EMB_DIM) or not np.isfinite(emb).all():
            raise AssertionError(f"{name} embeddings: shape {emb.shape}, "
                                 f"finite {np.isfinite(emb).all()}")
    scalars = {"val " + k: v for k, v in m_val.items()
               if isinstance(v, float)}
    scalars.update({"test " + k: v for k, v in m_test.items()
                    if isinstance(v, float)})
    for what, em in (("val edge", em_val), ("reconstruction", rec),
                     ("test edge", em_test)):
        scalars.update({f"{what} {k}": float(v)
                        for k, v in em._asdict().items()})
    bad = {k: v for k, v in scalars.items() if not math.isfinite(v)}
    if bad:
        raise AssertionError(f"non-finite eval metrics {bad}")

    err = None
    if energy == "order":
        # the eval's labels × val-images energies: kernel against plain
        lab = trainer.label_embeddings()
        img = torch.as_tensor(val_emb, device=DEV)
        err = k3_compare("eval energies", k3.pairwise_order(lab, img),
                         k3.pairwise_order_plain(lab, img))

    result = {
        "energy": energy, "optimizer_labels": cfg.optimizer_labels,
        "label_annulus_error": annulus,
        "batch_edges": batch, "image_size": image_size,
        "steps_timed": len(timed), "steps_total": n_steps,
        "tower_rows_per_step": tower_rows,
        "unique_tower_images_timed": n_imgs, "losses": losses,
        "launches": launches,
        "launches_per_step": {k: launches[k] / n_steps
                              for k in ("bn_stats", "bn_corr")},
        "ms_per_step": 1e3 * seconds / len(timed),
        "unique_tower_images_per_s": n_imgs / seconds,
        "host_prep_ms_per_batch": prep_ms,
        "max_memory_allocated_gib": peak_gib,
        "eval_seconds": ev, "eval_images": [n_val, n_test],
        "eval_metrics": scalars, "eval_energy_max_abs_err": err,
    }
    log(f"[{tag}] resnet50@{image_size} {energy} dim {EMB_DIM}, {batch} "
        f"label→image edges a step, tower rows {tower_rows}: losses "
        f"{[round(l, 4) for l in losses]}")
    log(f"[{tag}] launches {launches} over {n_steps} steps and the eval "
        f"(53 + 53 BN per step; pairwise_order in the eval with the order "
        f"energy only)" + ("" if annulus is None else
                           f"; label rows outside the annulus by {annulus}"))
    log(f"[{tag}] {result['ms_per_step']:.2f} ms/step, "
        f"{result['unique_tower_images_per_s']:.1f} unique tower images/s, "
        f"host prep {prep_ms:.1f} ms/batch, peak memory {peak_gib:.2f} GiB")
    log(f"[{tag}] eval: " + ", ".join(f"{k} {v:.2f}" for k, v in ev.items())
        + f"; val hit@1 {m_val['hit@1']:.4f}, val edge F1 "
        f"{float(em_val.f1):.4f} at {float(em_val.threshold):.4g}, "
        f"reconstruction F1 {float(rec.f1):.4f}, test edge F1 "
        f"{float(em_test.f1):.4f}" + ("" if err is None else
                                      f"; eval energies kernel vs plain "
                                      f"max err {err:.3g}"))
    return trainer, timed[-1], (val_paths, val_emb), result


# --------------------------------------------------------------------------
# phase 6: slice 4, the label-only trainer
# --------------------------------------------------------------------------
#: (energy, optimizer) of the label-only runs
LABEL_ONLY_RUNS = (("hyp_cone", "adam"), ("hyp_cone", "rsgd"),
                   ("order", "adam"))


def label_only_phase(labelmap, epochs=5):
    """EmbeddingTrainer on `labelmap`'s taxonomy (every leaf path, as the
    CLI's butterfly200 taxonomy does) with the CLI defaults
    (cli/order_embeddings_h.py, cli/common.py): dim 10, batch 8, ratio 5,
    alpha 0.05, lr 1e-3, 90% of the non-basic edges in train, seed 0. Each
    run is a path of its own: the counts are set to 0 before its epochs and
    read after its eval (val, test at the val threshold, reconstruction).
    Then the profiler's view of one step of the run."""
    import numpy as np
    import torch

    from learning_embeddings_tpu_torch.geometry import inner_radius
    from learning_embeddings_tpu_torch.hierarchy import (
        label_graph_from_paths, split_edges)
    from learning_embeddings_tpu_torch.ops import pairwise_order as k3
    from learning_embeddings_tpu_torch.train.embedding import (
        EmbeddingTrainer, EmbeddingTrainerConfig)
    from learning_embeddings_tpu_torch.utils import profiling

    splits = split_edges(label_graph_from_paths(labelmap.leaf_paths(),
                                                labelmap),
                         proportion_of_nb_edges_in_train=0.9, seed=0)
    nl = labelmap.n_classes
    results = {}
    for energy, opt in LABEL_ONLY_RUNS:
        name = f"{energy}_{opt}"
        cfg = EmbeddingTrainerConfig(energy=energy, optimizer=opt,
                                     embedding_dim=EMB_DIM, batch_size=8,
                                     neg_to_pos_ratio=5, alpha=0.05, lr=1e-3,
                                     seed=0, device=DEV)
        profiling.reset_counts()
        trainer = EmbeddingTrainer(labelmap, splits, cfg)
        epoch_s, stats = [], []
        for _ in range(epochs):
            t0 = time.perf_counter()
            stats.append(trainer.train_epoch())   # waits on its losses
            epoch_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        val = trainer.evaluate("val")
        test = trainer.evaluate("test")
        rec = trainer.reconstruction()
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        launches = profiling.counts()

        steps = len(splits.train) // cfg.batch_size
        f1 = {"val": float(val.f1), "test": float(test.f1),
              "reconstruction": float(rec.f1)}
        losses = [st["loss"] for st in stats]
        if not all(map(math.isfinite, losses + list(f1.values()))):
            raise AssertionError(f"label-only {name}: losses {losses}, "
                                 f"F1 {f1}")
        if launches["bn_stats"] or launches["bn_corr"]:
            raise AssertionError(f"label-only {name} launched BN kernels: "
                                 f"{launches}")
        err = annulus = None
        if energy == "order":
            if launches["pairwise_order"] < 1 or launches[
                    "pairwise_order_exact_d"] != launches["pairwise_order"]:
                raise AssertionError(
                    f"label-only {name}: pairwise_order launched "
                    f"{launches}, expected the reconstruction's on exact_d")
            emb = trainer.all_embeddings()[:nl]
            err = k3_compare(f"label-only reconstruction energies {name}",
                             k3.pairwise_order(emb, emb),
                             k3.pairwise_order_plain(emb, emb))
        else:
            if launches["pairwise_order"]:
                raise AssertionError(f"label-only {name}: pairwise_order "
                                     f"launched {launches}, expected none")
            annulus = _annulus_error(trainer.all_embeddings(),
                                     inner_radius(trainer.K))
            if annulus > ANNULUS_TOL:
                raise AssertionError(f"label-only {name}: embeddings lie "
                                     f"{annulus} outside the annulus")
        steady = epoch_s[1:] or epoch_s
        results[name] = {
            "energy": energy, "optimizer": opt, "epochs": epochs,
            "n_nodes": trainer.n_nodes, "train_edges": len(splits.train),
            "val_edges": len(splits.val), "test_edges": len(splits.test),
            "steps_per_epoch": steps, "epoch_s": epoch_s,
            "ms_per_epoch": 1e3 * sum(steady) / len(steady),
            "steps_per_s": steps * len(steady) / sum(steady),
            "eval_s": eval_s, "losses": losses, "f1": f1,
            "val_threshold": float(val.threshold),
            "launches": launches, "reconstruction_max_abs_err": err,
            "annulus_error": annulus}
        log(f"[label] {name}: {trainer.n_nodes} nodes, "
            f"{len(splits.train)} train edges ({steps} steps/epoch); epochs "
            f"{[round(t, 3) for t in epoch_s]} s; "
            f"{results[name]['ms_per_epoch']:.1f} ms/epoch, "
            f"{results[name]['steps_per_s']:.0f} steps/s after the first; "
            f"eval {eval_s:.3f} s; val F1 {f1['val']:.4f} at "
            f"{float(val.threshold):.4g}, test F1 {f1['test']:.4f}, "
            f"reconstruction F1 {f1['reconstruction']:.4f}; launches "
            f"{launches}" + ("" if err is None else
                             f"; reconstruction energies kernel vs plain "
                             f"max err {err:.3g}"))
        edges = torch.as_tensor(splits.train[:8], device=DEV).long()
        results[name]["profile"] = profile_phase(
            lambda: trainer.train_batch(edges[:, 0], edges[:, 1]),
            f"label {name}")
    return results


# --------------------------------------------------------------------------
# phases 7-9: slice 5, the runner and the CLIs
# --------------------------------------------------------------------------
#: experiment directories of the slice-5 phases, removed at the end
EXPERIMENTS = os.path.join(HERE, ".smoke_experiments")


def _jsonl(exp_root):
    with open(os.path.join(exp_root, "logs", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _steps(exp_root, tag):
    return [r["step"] for r in _jsonl(exp_root) if r["tag"] == tag]


def _run_path(name, fn, paths):
    """fn() as a path of its own: the counts set to 0 just before, read
    just after (into paths[name]); returns (fn(), seconds)."""
    import torch

    from learning_embeddings_tpu_torch.utils import profiling

    profiling.reset_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    paths[name] = profiling.counts()
    return out, seconds


def _k3_on_exact_d(name, launches, at_least):
    if launches["pairwise_order"] < at_least or launches[
            "pairwise_order_exact_d"] != launches["pairwise_order"]:
        raise AssertionError(f"{name}: pairwise_order launched {launches}, "
                             f"expected at least {at_least}, all exact_d")


def label_cli_phase(epochs=5, resume_to=7, toy_epochs=5):
    """The label-only CLIs through their main(argv), with the CLI defaults
    (dim 10, batch 8, ratio 5, lr 1e-3, --taxonomy butterfly200, --set_mode
    train) on the card, each a path of its own:
    - order_embeddings_h (the adam hybrid) for `epochs`, then --resume to
      `resume_to`: the second run starts at `epochs`, and its best_model
      holds the best val F1 of all epochs;
    - order_embeddings --loss order_emb_loss for `epochs` with
      --check_reconstr_every 1: K3 once per reconstruction (one an epoch
      and the final one), all on exact_d;
    - embed_toy --tree_levels 4 --tree_branching 3 --loss hyp_cones_loss;
    - validate_embedding on the order run: K3 on exact_d, and the run's
      final reconstruction F1 (within 1e-6)."""
    from learning_embeddings_tpu_torch.cli import (embed_toy,
                                                   order_embeddings,
                                                   order_embeddings_h,
                                                   validate_embedding)

    base = ["--taxonomy", "butterfly200", "--set_mode", "train",
            "--experiment_dir", EXPERIMENTS, "--device", DEV]
    paths, out = {}, {}

    hyp = os.path.join(EXPERIMENTS, "cli_hyp")
    first, s1 = _run_path("cli_order_embeddings_h", lambda: order_embeddings_h
                          .main(base + ["--experiment_name", "cli_hyp",
                                        "--n_epochs", str(epochs)]), paths)
    second, s2 = _run_path("cli_order_embeddings_h_resume",
                           lambda: order_embeddings_h.main(
                               base + ["--experiment_name", "cli_hyp",
                                       "--n_epochs", str(resume_to),
                                       "--resume"]), paths)
    steps = _steps(hyp, "train/loss")
    if steps != list(range(resume_to)):
        raise AssertionError(f"order_embeddings_h --resume: train epochs "
                             f"{steps}, expected 0..{resume_to - 1} once each")
    val = {r["step"]: r["value"] for r in _jsonl(hyp) if r["tag"] == "val/f1"}
    best_epoch = max(sorted(val), key=lambda e: val[e])
    if second["best_epoch"] != best_epoch or abs(
            second["best_val_f1"] - val[best_epoch]) > 1e-7:
        raise AssertionError(f"best_model after --resume: epoch "
                             f"{second['best_epoch']} F1 "
                             f"{second['best_val_f1']}, val F1 by epoch {val}")
    out["order_embeddings_h"] = {
        "epochs": [epochs, resume_to], "seconds": [s1, s2],
        "best_epoch": second["best_epoch"],
        "best_val_f1": second["best_val_f1"],
        "best_epoch_before_resume": first["best_epoch"],
        "test_f1": second.get("test_f1"),
        "reconstruction_f1": second["reconstruction_f1"],
        "epoch_s": [r["value"] for r in _jsonl(hyp)
                    if r["tag"] == "epoch_time"]}
    for p in ("cli_order_embeddings_h", "cli_order_embeddings_h_resume"):
        if paths[p]["pairwise_order"] or paths[p]["bn_stats"]:
            raise AssertionError(f"{p} launched {paths[p]}, expected none")

    order = os.path.join(EXPERIMENTS, "cli_order")
    res, s = _run_path("cli_order_embeddings", lambda: order_embeddings.main(
        base + ["--experiment_name", "cli_order", "--loss",
                "order_emb_loss", "--n_epochs", str(epochs),
                "--check_reconstr_every", "1"]), paths)
    _k3_on_exact_d("order_embeddings", paths["cli_order_embeddings"],
                   epochs + 1)
    out["order_embeddings"] = {
        "epochs": epochs, "seconds": s, "best_epoch": res["best_epoch"],
        "best_val_f1": res["best_val_f1"], "test_f1": res.get("test_f1"),
        "reconstruction_f1": res["reconstruction_f1"],
        "reconstruction_f1_by_epoch": [
            r["value"] for r in _jsonl(order)
            if r["tag"] == "reconstruction/f1"]}

    res, s = _run_path("cli_embed_toy", lambda: embed_toy.main(
        ["--tree_levels", "4", "--tree_branching", "3", "--loss",
         "hyp_cones_loss", "--n_epochs", str(toy_epochs), "--experiment_dir",
         EXPERIMENTS, "--experiment_name", "cli_toy", "--device", DEV]),
        paths)
    out["embed_toy"] = {"epochs": toy_epochs, "seconds": s,
                        "n_nodes": res["trainer"].n_nodes,
                        "reconstruction_f1": res["reconstruction_f1"]}

    val_res, s = _run_path("cli_validate_embedding",
                           lambda: validate_embedding.main(
                               ["--experiment_path", order, "--device", DEV]),
                           paths)
    _k3_on_exact_d("validate_embedding", paths["cli_validate_embedding"], 1)
    diff = abs(val_res["reconstruction_f1"]
               - out["order_embeddings"]["reconstruction_f1"])
    if diff > 1e-6:
        raise AssertionError(f"validate_embedding: reconstruction F1 "
                             f"{val_res['reconstruction_f1']}, the run's "
                             f"{out['order_embeddings']['reconstruction_f1']}")
    out["validate_embedding"] = dict(val_res, seconds=s)
    for name, r in out.items():
        log(f"[cli] {name}: " + ", ".join(
            f"{k} {v}" for k, v in r.items() if not isinstance(v, list))
            + f"; launches {paths.get('cli_' + name)}")
    return out, paths, os.path.join(hyp, "weights", "best_model")


def joint_runner_phase(warm_path, image_size=448, backbone="resnet50",
                       n_train=256, n_val=256, n_test=256, epochs=2,
                       resume_to=3, order_epochs=1):
    """run_joint_cnn at the BASELINE width (bench.py:113-143: hyp_cone,
    ResNet-50@448, bf16 tower, 16 label→image edges a step, ratio 5) on
    Butterfly200 (the label-only runs' taxonomy) with `n_train` synthetic
    train images of the seeded pixel bank and held-out val and test splits
    of `n_val`/`n_test`: warm-started from the hyperbolic label-only run's
    best_model (--load_emb_from's loader: its table and threshold),
    `epochs` epochs, then resume=True to `resume_to`; then `order_epochs`
    with the order energy, whose eval launches K3 (exact_d). Each run is a
    path of its own; every train step launches 53 + 53 BN kernels."""
    import argparse as _ap

    import numpy as np
    import torch

    from learning_embeddings_tpu_torch.cli._joint_main import load_warm_start
    from learning_embeddings_tpu_torch.hierarchy import butterfly200_labelmap
    from learning_embeddings_tpu_torch.losses.joint_sampling import (
        build_joint_graph)
    from learning_embeddings_tpu_torch.train.experiment import (
        Checkpointer, ExperimentDir)
    from learning_embeddings_tpu_torch.train.joint_cnn import JointCNNConfig
    from learning_embeddings_tpu_torch.train.runner import run_joint_cnn

    labelmap = butterfly200_labelmap()
    nl = labelmap.n_classes
    rng = np.random.RandomState(0)
    graph, train_edges = build_joint_graph(
        labelmap, labelmap.leaf_paths()[rng.randint(0, labelmap.levels[-1],
                                                    n_train)])
    img_edges = train_edges[train_edges[:, 1] >= nl]
    bank = rng.randint(0, 256, (64, image_size, image_size, 3),
                       dtype=np.uint8)
    calls = {"train": 0}

    def train_loader(rows):
        calls["train"] += 1
        return bank[np.asarray(rows) % len(bank)]

    def eval_loader(offset):
        return lambda rows: bank[(np.asarray(rows) + offset) % len(bank)]

    eval_sets = {"val": (_split_paths(labelmap, n_val, rng), eval_loader(7)),
                 "test": (_split_paths(labelmap, n_test, rng),
                          eval_loader(29))}
    table, thr = load_warm_start(_ap.Namespace(load_emb_from=warm_path,
                                               load_cosine_emb=None), nl)
    if table is None or table.shape != (nl, EMB_DIM) or thr is None \
            or not math.isfinite(thr):
        raise AssertionError(f"warm start from {warm_path}: table "
                             f"{None if table is None else table.shape}, "
                             f"threshold {thr}")

    def cfg(energy):
        return JointCNNConfig(energy=energy, backbone=backbone,
                              embedding_dim=EMB_DIM, image_size=image_size,
                              batch_size=16, neg_to_pos_ratio=5, alpha=0.05,
                              pick_per_level=True, lr_labels=1e-2,
                              lr_images=1e-3, tower_dtype="bfloat16", seed=0,
                              device=DEV)

    steps_per_epoch = len(img_edges) // 16
    paths, runs = {}, {}
    for name, energy, kw in (
            ("joint_runner_hyp_cone", "hyp_cone",
             dict(n_epochs=epochs, init_embeddings=table,
                  init_threshold=thr)),
            ("joint_runner_hyp_cone_resume", "hyp_cone",
             dict(n_epochs=resume_to, resume=True)),
            ("joint_runner_order", "order", dict(n_epochs=order_epochs))):
        exp_name = "order" if energy == "order" else "hyp"
        calls["train"] = 0
        torch.cuda.reset_peak_memory_stats()
        res, seconds = _run_path(name, lambda: run_joint_cnn(
            labelmap, graph, img_edges, train_loader, cfg(energy),
            experiment_dir=os.path.join(EXPERIMENTS, "joint"),
            experiment_name=exp_name, eval_sets=eval_sets,
            manifest_args={"phase": name}, **kw), paths)
        launches = paths[name]
        n_steps = calls["train"]
        if n_steps != (kw["n_epochs"] - (epochs if kw.get("resume") else 0)) \
                * steps_per_epoch:
            raise AssertionError(f"{name}: {n_steps} train steps, expected "
                                 f"{steps_per_epoch} an epoch")
        for k in ("bn_stats", "bn_corr"):
            if launches[k] != 53 * n_steps:
                raise AssertionError(f"{name}: {k} launched {launches[k]} "
                                     f"times in {n_steps} steps, expected "
                                     f"53 a step")
        if energy == "order":
            _k3_on_exact_d(name, launches, 2)
        elif launches["pairwise_order"]:
            raise AssertionError(f"{name}: pairwise_order launched "
                                 f"{launches}, expected none")
        root = os.path.join(EXPERIMENTS, "joint", exp_name)
        metrics = _jsonl(root)
        bad = [r for r in metrics if not math.isfinite(r["value"])]
        finals = [res["reconstruction_f1"]] + list(
            res["test_metrics"].values())
        if bad or not all(map(math.isfinite, finals)):
            raise AssertionError(f"{name}: non-finite metrics {bad} "
                                 f"{res['test_metrics']}")
        tr = res["trainer"]
        runs[name] = {
            "energy": energy, "seconds": seconds, "train_steps": n_steps,
            "launches_per_step": {k: launches[k] / max(n_steps, 1)
                                  for k in ("bn_stats", "bn_corr")},
            "epoch_s": [r["value"] for r in metrics
                        if r["tag"] == "epoch_time"],
            "train_epochs": _steps(root, "train/loss"),
            "best_epoch": res["best_epoch"],
            "best_val_micro_f1": res["best_val_micro_f1"],
            "test_metrics": res["test_metrics"],
            "reconstruction_f1": res["reconstruction_f1"],
            "threshold": tr.optimal_threshold,
            "max_memory_allocated_gib":
                torch.cuda.max_memory_allocated() / 2**30}

    hyp = runs["joint_runner_hyp_cone_resume"]
    if hyp["train_epochs"] != list(range(resume_to)):
        raise AssertionError(f"resume: train epochs {hyp['train_epochs']}, "
                             f"expected 0..{resume_to - 1} once each")
    if hyp["best_val_micro_f1"] < runs["joint_runner_hyp_cone"][
            "best_val_micro_f1"]:
        raise AssertionError("resume lost the best val micro-F1")

    # the eval of each split, timed on the order run's best model as the
    # runner runs it (after the paths' counts were read), and one
    # checkpoint's save, load and size
    timing = {}
    for split, (paths_g, loader) in eval_sets.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        embs = tr.image_embeddings_for_rows(np.arange(len(paths_g)),
                                            loader=loader, batch_size=16)
        tr.classification_metrics(paths_g, embs)
        tr.edge_metrics(paths_g, embs, threshold=(
            tr.optimal_threshold if split == "test" else None))
        torch.cuda.synchronize()
        timing[f"eval_{split}_s"] = time.perf_counter() - t0
    ckpt = Checkpointer(ExperimentDir(os.path.join(EXPERIMENTS, "joint"),
                                      "order"))
    payload = tr.checkpoint_payload()
    t0 = time.perf_counter()
    ckpt.save("timed", payload)
    timing["checkpoint_save_ms"] = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    tr.restore_payload(ckpt.load("timed", payload))
    torch.cuda.synchronize()
    timing["checkpoint_load_ms"] = 1e3 * (time.perf_counter() - t0)
    timing["checkpoint_bytes"] = os.path.getsize(
        os.path.join(ckpt.dir, "timed"))
    result = {"runs": runs, "timing": timing, "n_train": n_train,
              "n_val": n_val, "n_test": n_test, "image_size": image_size,
              "backbone": backbone, "steps_per_epoch": steps_per_epoch,
              "warm_start_threshold": thr}
    for name, r in runs.items():
        log(f"[runner] {name}: {r['train_steps']} steps in {r['seconds']:.1f}"
            f" s (epochs {[round(t, 2) for t in r['epoch_s']]} s), best "
            f"epoch {r['best_epoch']} val micro-F1 "
            f"{r['best_val_micro_f1']:.4f}, test " + ", ".join(
                f"{k} {r['test_metrics'][k]:.4f}"
                for k in ("micro_f1", "hit@1", "edge_f1")) +
            f", reconstruction F1 {r['reconstruction_f1']:.4f}, peak "
            f"{r['max_memory_allocated_gib']:.2f} GiB; launches "
            f"{paths[name]}")
    log(f"[runner] {timing}")
    return result, paths


def oe_h_cli_phase(n_leaves=40, per_leaf=3, image_hw=(375, 500)):
    """cli/oe_h.py --use_CNN end to end on a small synthetic split:
    Butterfly200 records (`per_leaf` specimens of each of `n_leaves`
    leaves, split by stratified_split) and PNG images the script writes,
    decoded by cv2 on the card's machine; the CLI defaults otherwise
    (resnet18 at 448², batch 8), one epoch."""
    import numpy as np

    from learning_embeddings_tpu_torch import data
    from learning_embeddings_tpu_torch.cli import oe_h
    from learning_embeddings_tpu_torch.data.pipeline import _cv2
    from learning_embeddings_tpu_torch.hierarchy import (
        butterfly200_labelmap, labelmap_from_records)

    cv2 = _cv2()
    if cv2 is None:
        raise AssertionError("cv2 does not import on this machine")
    b200 = butterfly200_labelmap()
    root = os.path.join(EXPERIMENTS, "oe_h_data")
    rng = np.random.RandomState(0)
    records = []
    for leaf in range(n_leaves):
        path = b200.leaf_paths()[leaf * (b200.levels[-1] // n_leaves)]
        names = [b200.ix_to_name[l][path[l]] for l in range(4)]
        epithet = names[3].split(".", 1)[-1][len(names[2]) + 1:]
        for k in range(per_leaf):
            i = len(records)
            records.append({"token": f"s{i:05d}", "family": names[0],
                            "subfamily": names[1], "genus": names[2],
                            "specific_epithet": epithet,
                            "image_path": names[2],
                            "image_name": f"s{i:05d}.png"})
            d = os.path.join(root, "images", names[2])
            os.makedirs(d, exist_ok=True)
            cv2.imwrite(os.path.join(d, f"s{i:05d}.png"), rng.randint(
                0, 256, (*image_hw, 3)).astype(np.uint8))
    splits = data.stratified_split(records,
                                   labelmap_from_records(records))
    os.makedirs(os.path.join(root, "splits"), exist_ok=True)
    for name, rs in zip(("train", "val", "test"), splits):
        data.save_ethec_json(rs, os.path.join(root, "splits",
                                              f"{name}.json"))
    paths = {}
    res, seconds = _run_path("cli_oe_h_use_cnn", lambda: oe_h.main(
        ["--use_CNN", "--data_dir", os.path.join(root, "splits"),
         "--image_dir", os.path.join(root, "images"), "--set_mode", "train",
         "--n_epochs", "1", "--experiment_dir", EXPERIMENTS,
         "--experiment_name", "cli_oe_h", "--device", DEV]), paths)
    launches = paths["cli_oe_h_use_cnn"]
    # ResNet-18 has 20 BN layers: 20 + 20 launches a train step
    if not launches["bn_stats"] or launches["bn_stats"] % 20 or \
            launches["bn_corr"] != launches["bn_stats"]:
        raise AssertionError(f"oe_h --use_CNN launched {launches}")
    finals = [res["reconstruction_f1"]] + list(res["test_metrics"].values())
    if not all(map(math.isfinite, finals)):
        raise AssertionError(f"oe_h --use_CNN: {res['test_metrics']}")
    out = {"seconds": seconds, "decoder": f"cv2 {cv2.__version__}",
           "split_sizes": [len(s) for s in splits],
           "train_steps": launches["bn_stats"] // 20,
           "test_metrics": res["test_metrics"],
           "reconstruction_f1": res["reconstruction_f1"]}
    log(f"[oe_h] --use_CNN on {out['split_sizes']} PNG images "
        f"({out['decoder']}): {seconds:.1f} s, {out['train_steps']} steps, "
        f"test micro-F1 {res['test_metrics']['micro_f1']:.4f}, edge F1 "
        f"{res['test_metrics']['edge_f1']:.4f}; launches {launches}")
    return out, paths


# --------------------------------------------------------------------------
# phase 10: slice 6, the classifier experiment through its CLIs
# --------------------------------------------------------------------------
def _leaf_record(labelmap, leaf, i, image_name):
    """An ETHEC record of `labelmap`'s leaf `leaf`, token s{i}."""
    path = labelmap.leaf_paths()[leaf]
    names = [labelmap.ix_to_name[l][path[l]] for l in range(4)]
    epithet = names[3].split(".", 1)[-1][len(names[2]) + 1:]
    return {"token": f"s{i:05d}", "family": names[0],
            "subfamily": names[1], "genus": names[2],
            "specific_epithet": epithet, "image_path": "pool",
            "image_name": image_name}


#: BatchNorm layers and feature width of the backbones the phases run
BACKBONE_BN_FEATURES = {"resnet18": (20, 512), "resnet50": (53, 2048)}


def classifier_cli_phase(labelmap, n_train=1024, n_val=256, n_test=256,
                         pool=256, image_hw=(375, 500), image_size=448,
                         batch=128, workers=8, epochs=2, resume_to=3,
                         profile=2, backbone="resnet50"):
    """cli/ethec_experiments.py and cli/image_emb.py through main(argv) at
    the flagship width (ResNet-50@448, batch 128, multi_level, Adam lr
    1e-5) on `labelmap`'s taxonomy: records of every leaf in turn
    (n_train / n_val / n_test), each pointing at one of `pool` distinct
    PNGs the script writes, decoded by cv2 on `workers` threads. Runs,
    each a path of its own: (a) `epochs` epochs with --profile, (b)
    --resume to `resume_to`, (c) --set_mode test, (d) --loss multi_label
    --evaluator ML for one epoch, (e) image_emb on (a)'s experiment.
    Every train step launches 53 + 53 BN kernels (ResNet-50), no eval step
    any: each run's launches are exactly 53 + 53 times the train steps
    run_classifier reports, and (c), which only evaluates, launches
    none."""
    import numpy as np
    import torch

    from learning_embeddings_tpu_torch import data
    from learning_embeddings_tpu_torch.cli import ethec_experiments, image_emb
    from learning_embeddings_tpu_torch.data.pipeline import _cv2
    from learning_embeddings_tpu_torch.hierarchy import labelmap_from_records
    from learning_embeddings_tpu_torch.train.experiment import (
        Checkpointer, ExperimentDir)
    from learning_embeddings_tpu_torch.utils.profiling import summarize_trace

    cv2 = _cv2()
    if cv2 is None:
        raise AssertionError("cv2 does not import on this machine")
    root = os.path.join(EXPERIMENTS, "classifier_data")
    rng = np.random.RandomState(0)
    os.makedirs(os.path.join(root, "images", "pool"), exist_ok=True)
    t0 = time.perf_counter()
    for i in range(pool):
        cv2.imwrite(os.path.join(root, "images", "pool", f"p{i:03d}.png"),
                    rng.randint(0, 256, (*image_hw, 3)).astype(np.uint8))
    n_leaf = labelmap.levels[-1]
    records, i = {}, 0
    for split, n in (("train", n_train), ("val", n_val), ("test", n_test)):
        records[split] = []
        for _ in range(n):
            records[split].append(_leaf_record(
                labelmap, i % n_leaf, i, f"p{rng.randint(pool):03d}.png"))
            i += 1
        os.makedirs(os.path.join(root, "splits"), exist_ok=True)
        data.save_ethec_json(records[split], os.path.join(
            root, "splits", f"{split}.json"))
    write_s = time.perf_counter() - t0
    # the taxonomy the CLI builds from the records: all of `labelmap`'s
    # when every leaf has a train record
    n_classes = labelmap_from_records(
        [r for rs in records.values() for r in rs]).n_classes

    exp_dir = os.path.join(EXPERIMENTS, "classifier")
    base = ["--data_dir", os.path.join(root, "splits"), "--image_dir",
            os.path.join(root, "images"), "--experiment_dir", exp_dir,
            "--model", backbone, "--image_size", str(image_size),
            "--batch_size", str(batch), "--lr", "1e-5", "--n_workers",
            str(workers), "--device", DEV]
    steps_per_epoch = n_train // batch
    n_bn, width = BACKBONE_BN_FEATURES[backbone]
    runs = {
        "cli_classifier_train": (
            "e", base + ["--experiment_name", "e", "--loss", "multi_level",
                         "--n_epochs", str(epochs), "--set_mode", "train",
                         "--profile", str(profile)],
            epochs * steps_per_epoch + 1 + profile),
        "cli_classifier_resume": (
            "e", base + ["--experiment_name", "e", "--loss", "multi_level",
                         "--n_epochs", str(resume_to), "--set_mode",
                         "train", "--resume"],
            (resume_to - epochs) * steps_per_epoch),
        "cli_classifier_test": (
            "e", base + ["--experiment_name", "e", "--loss", "multi_level",
                         "--n_epochs", str(resume_to), "--set_mode",
                         "test"], 0),
        "cli_classifier_multi_label": (
            "ml", base + ["--experiment_name", "ml", "--loss",
                          "multi_label", "--evaluator", "ML", "--n_epochs",
                          "1", "--set_mode", "train"], steps_per_epoch),
    }
    paths, out, results = {}, {"runs": {}, "write_images_s": write_s}, {}
    for name, (exp_name, argv, want_steps) in runs.items():
        eroot = os.path.join(exp_dir, exp_name)
        seen = (len(_jsonl(eroot)) if os.path.exists(os.path.join(
            eroot, "logs", "metrics.jsonl")) else 0)
        torch.cuda.reset_peak_memory_stats()
        res, seconds = _run_path(
            name, lambda: ethec_experiments.main(argv), paths)
        results[name] = res
        launches = paths[name]
        if res["train_steps"] != want_steps:
            raise AssertionError(f"{name}: {res['train_steps']} train "
                                 f"steps, expected {want_steps}")
        for k in ("bn_stats", "bn_corr"):
            # n_bn a train step, none in the eval passes
            if launches[k] != n_bn * res["train_steps"]:
                raise AssertionError(
                    f"{name}: {k} launched {launches[k]} times in "
                    f"{res['train_steps']} train steps and the eval "
                    f"passes, expected {n_bn} a train step and none in "
                    f"an eval")
        metrics = _jsonl(eroot)[seen:]      # this run's records
        bad = [r for r in metrics if not math.isfinite(r["value"])]
        if bad or not all(map(math.isfinite, res["test_metrics"].values())):
            raise AssertionError(f"{name}: non-finite metrics {bad} "
                                 f"{res['test_metrics']}")

        def per_epoch(tag):
            return [r["value"] for r in metrics if r["tag"] == tag]
        out["runs"][name] = {
            "seconds": seconds, "train_steps": res["train_steps"],
            "launches_per_step": {
                k: launches[k] / max(res["train_steps"], 1)
                for k in ("bn_stats", "bn_corr")},
            "best_epoch": res["best_epoch"],
            "best_val_score": res["best_val_score"],
            "test_metrics": res["test_metrics"],
            "max_memory_allocated_gib":
                torch.cuda.max_memory_allocated() / 2**30,
            **{tag: per_epoch(tag) for tag in (
                "epoch_time", "epoch_time_train",
                "epoch_time_data_wait", "epoch_time_eval",
                "epoch_time_checkpoint", "train/loss")}}

    root_e = os.path.join(exp_dir, "e")
    a, b, c, d = (out["runs"][k] for k in runs)
    ckpt = Checkpointer(ExperimentDir(exp_dir, "e"))
    on_disk = sorted(os.listdir(ckpt.dir))
    want = [str(e) for e in range(resume_to)] + ["best_model"]
    if [f for f in on_disk if not f.startswith(".")] != want:
        raise AssertionError(f"checkpoints {on_disk}, expected {want}")
    if _steps(root_e, "train/loss") != list(range(resume_to)):
        raise AssertionError(f"train epochs {_steps(root_e, 'train/loss')}"
                             f", expected 0..{resume_to - 1} once each "
                             f"(the resumed run starts at {epochs})")
    scores = np.load(os.path.join(root_e, "stats", "predicted_scores.npy"))
    if scores.shape != (n_test, n_classes):
        raise AssertionError(f"predicted_scores {scores.shape}")
    # (c) restores best_model's weights only, as the JAX runner does: the
    # checkpoint it scored is the one (b) took at its best epoch
    scored = int(ckpt.load_raw("best_model")["best_epoch"])
    if scored != b["best_epoch"] or abs(
            c["test_metrics"]["micro_f1"]
            - b["test_metrics"]["micro_f1"]) > 1 / n_test:
        raise AssertionError(f"--set_mode test: best_model of epoch "
                             f"{scored}, micro-F1 "
                             f"{c['test_metrics']['micro_f1']}; the resumed "
                             f"run: {b['best_epoch']}, "
                             f"{b['test_metrics']['micro_f1']}")
    th = results["cli_classifier_multi_label"]["thresholds"]
    if th is None or th.shape != (n_classes,) or not np.isfinite(th).all():
        raise AssertionError(f"multi_label: per-class thresholds not tuned "
                             f"or not finite: {th}")
    if not 0.0 <= d["test_metrics"]["mAP"] <= 1.0:
        raise AssertionError(f"multi_label mAP {d['test_metrics']['mAP']}")

    # (e) the fc7 features of (a)'s best model: eval-mode BN, no kernel
    emb_dir = os.path.join(EXPERIMENTS, "classifier_emb")
    _, seconds = _run_path("cli_image_emb", lambda: image_emb.main(
        ["--data_dir", os.path.join(root, "splits"), "--image_dir",
         os.path.join(root, "images"), "--output_dir", emb_dir, "--model",
         backbone, "--experiment_load_dir", root_e, "--image_size",
         str(image_size), "--batch_size", str(batch), "--n_workers",
         str(workers), "--device", DEV]), paths)
    if paths["cli_image_emb"]["bn_stats"] or paths["cli_image_emb"][
            "bn_corr"]:
        raise AssertionError(f"image_emb launched {paths['cli_image_emb']}")
    for split, n in (("train", n_train), ("val", n_val), ("test", n_test)):
        with np.load(os.path.join(emb_dir, f"{split}.npz")) as z:
            f = z["features"]
            if f.shape != (n, width) or f.dtype != np.float32 or \
                    not np.isfinite(f).all() or len(z["paths"]) != n:
                raise AssertionError(f"image_emb {split}: {f.shape} "
                                     f"{f.dtype}")
    out["image_emb_s"] = seconds

    # the profile of (a), one checkpoint's save, load and size
    top = summarize_trace(os.path.join(root_e, "stats", "trace"), profile)
    out["profile_top"] = [{"name": n[:80], "ms_per_step": ms, "share": sh}
                          for n, ms, sh in top[:10]]
    t0 = time.perf_counter()
    payload = ckpt.load_raw("best_model")
    out["checkpoint_load_ms"] = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    ckpt.save("timed", payload)
    out["checkpoint_save_ms"] = 1e3 * (time.perf_counter() - t0)
    out["checkpoint_bytes"] = os.path.getsize(os.path.join(ckpt.dir,
                                                           "timed"))
    steps_s = [t - w for t, w in zip(a["epoch_time_train"] +
                                     b["epoch_time_train"],
                                     a["epoch_time_data_wait"] +
                                     b["epoch_time_data_wait"])]
    out.update({
        "n_train": n_train, "n_val": n_val, "n_test": n_test,
        "pool_images": pool, "image_hw": list(image_hw),
        "image_size": image_size, "batch": batch, "workers": workers,
        "backbone": backbone, "n_classes": n_classes,
        "steps_per_epoch": steps_per_epoch,
        "decoder": f"cv2 {cv2.__version__}",
        "epoch_steps_s": steps_s,
        "images_per_s_steps": [batch * steps_per_epoch / t
                               for t in steps_s],
        "images_per_s_train_pass": [
            batch * steps_per_epoch / t
            for t in a["epoch_time_train"] + b["epoch_time_train"]]})
    for name, r in out["runs"].items():
        log(f"[classifier] {name}: {r['train_steps']} train steps in "
            f"{r['seconds']:.1f} s, best "
            f"epoch {r['best_epoch']}, test " + ", ".join(
                f"{k} {v:.4f}" for k, v in r["test_metrics"].items()
                if "/" not in k) + f"; peak "
            f"{r['max_memory_allocated_gib']:.2f} GiB; launches "
            f"{paths[name]}")
        if r["epoch_time"]:
            log(f"[classifier]   epochs {r['epoch_time']} s: train pass "
                f"{r['epoch_time_train']} (data wait "
                f"{r['epoch_time_data_wait']}), eval "
                f"{r['epoch_time_eval']}, checkpoints "
                f"{r['epoch_time_checkpoint']}")
    log(f"[classifier] steps {[round(t, 3) for t in steps_s]} s an epoch: "
        f"{[round(x, 1) for x in out['images_per_s_steps']]} images/s "
        f"({[round(x, 1) for x in out['images_per_s_train_pass']]} over "
        f"the train pass); checkpoint {out['checkpoint_bytes']} bytes, "
        f"save {out['checkpoint_save_ms']:.1f} ms, load "
        f"{out['checkpoint_load_ms']:.1f} ms; image_emb {seconds:.1f} s")
    if not top:
        log("[classifier] the profiler saw no device time: top ops not "
            "measured")
    for t in out["profile_top"]:
        log(f"[classifier]   profile {t['ms_per_step']:9.3f} ms/step "
            f"{t['share']:.3f} {t['name']}")
    return out, paths


# --------------------------------------------------------------------------
# phase 11: slice 7, the fc7 joint trainer
# --------------------------------------------------------------------------
#: train images of the ETHEC split (47,978 − 5,286 val − 5,049 test): the
#: full-width fc7 graph's image count
ETHEC_TRAIN_IMAGES = 37643
FC7_DIM = 2048
#: (energy, label optimizer) of the fc7 runs
FC7_RUNS = (("hyp_cone", "adam"), ("hyp_cone", "rsgd"), ("order", "adam"))


def _fc7_graph(labelmap, n_images, seed=0):
    """(graph, train edges) of `n_images` synthetic images over every leaf
    in turn."""
    import numpy as np

    from learning_embeddings_tpu_torch.losses.joint_sampling import (
        build_joint_graph)

    leaves = np.arange(n_images) % labelmap.levels[-1]
    np.random.RandomState(seed).shuffle(leaves)
    return build_joint_graph(labelmap, labelmap.leaf_paths()[leaves])


def _fc7_features(n, gen):
    """(n, 2048) f32 on the card, uniform in [0, 1): non-negative, as the
    pooled ReLU features of a ResNet-50 trunk are."""
    import torch

    return torch.rand((n, FC7_DIM), generator=gen, device=DEV)


def _fc7_cfg(energy, opt, **kw):
    """JointTrainerConfig's defaults (dim 10, batch 10, ratio 5, alpha
    0.05, pick_per_level, lr 1e-2 / 1e-3) with `energy` and `opt`."""
    from learning_embeddings_tpu_torch.train.joint import JointTrainerConfig

    return JointTrainerConfig(energy=energy, optimizer_labels=opt,
                              feature_dim=FC7_DIM, device=DEV, **kw)


def fc7_small_phase(steps=3):
    """(a) a few train_steps on given negatives (drawn on the CPU) of each
    fc7 run at feature_dim 2048 on the card and on the CPU from the same
    seed: the loss (rel 1e-5), the label table and FeatNet (abs 1e-5) after
    every step, the step's energies (|Δ| ≤ 1e-5 + 1e-5·|E|); full f32
    matmuls on the card for the check."""
    import numpy as np
    import torch

    from learning_embeddings_tpu_torch.hierarchy import toy_labelmap
    from learning_embeddings_tpu_torch.train.joint import (
        JointEmbeddingTrainer)

    lm = toy_labelmap(3, 3)
    graph, edges = _fc7_graph(lm, 300)
    feats = np.random.RandomState(1).rand(300, FC7_DIM).astype(np.float32)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    try:
        for energy, opt in FC7_RUNS:
            tr = {dev: JointEmbeddingTrainer(
                lm, graph, edges, feats,
                dataclasses.replace(_fc7_cfg(energy, opt), device=dev))
                for dev in ("cpu", DEV)}
            sampler = tr["cpu"]._stage(())[1]
            gen = torch.Generator().manual_seed(0)
            errs = {"loss": 0.0, "params": 0.0, "energies": 0.0}
            for s in range(steps):
                e = torch.as_tensor(edges[s::steps][:10]).long()
                neg = sampler(gen, e[:, 0], e[:, 1])
                res = {dev: [x.cpu() for x in t.train_step(
                    e[:, 0], e[:, 1], *neg)] for dev, t in tr.items()}
                card, cpu = res[DEV], res["cpu"]   # loss, e_pos, e_neg
                errs["loss"] = max(errs["loss"], abs(float(
                    card[0] - cpu[0])) / abs(float(cpu[0])))
                errs["energies"] = max(errs["energies"], *(
                    ((a - b).abs() - 1e-5 * b.abs()).max().item()
                    for a, b in zip(card[1:], cpu[1:])))
                for name in ("embedder", "featnet"):
                    for v, w in zip(
                            getattr(tr["cpu"], name).state_dict().values(),
                            getattr(tr[DEV], name).state_dict().values()):
                        errs["params"] = max(errs["params"], (
                            w.cpu() - v).abs().max().item())
            limits = {"loss": 1e-5, "params": 1e-5, "energies": 1e-5}
            bad = {k: v for k, v in errs.items() if not v <= limits[k]}
            if bad:
                raise AssertionError(f"fc7 steps {energy} + {opt}: card and "
                                     f"CPU disagree on {bad} ({limits})")
            out[f"{energy}_{opt}"] = errs
            log(f"[fc7] {steps} steps {energy} + {opt} at feature_dim "
                f"{FC7_DIM}: card against CPU {errs} within {limits}")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return out


def fc7_step_phase(labelmap, n_images=ETHEC_TRAIN_IMAGES, steps=500,
                   warmup=2, profiled=5):
    """(b) the fc7 step at full width: JointTrainerConfig's defaults
    (hyp_cone, the hybrid Adam) on `labelmap`'s taxonomy with a train
    graph of `n_images` synthetic images over every leaf, 2048-wide f32
    features on the card; `warmup` then `steps` timed train_batch calls
    (negatives drawn on the card), waiting once at the end; the profiler's
    view of `profiled` steps; peak memory; the epoch time the step time
    implies for this graph."""
    import numpy as np
    import torch

    from learning_embeddings_tpu_torch.train.joint import (
        JointEmbeddingTrainer)
    from learning_embeddings_tpu_torch.utils import profiling

    # the phase's own memory: its peak above what earlier phases hold
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=DEV).manual_seed(0)
    graph, edges = _fc7_graph(labelmap, n_images)
    feats = _fc7_features(n_images, gen)
    cfg = _fc7_cfg("hyp_cone", "adam")
    profiling.reset_counts()
    trainer = JointEmbeddingTrainer(labelmap, graph, edges, feats, cfg)
    bs = cfg.batch_size
    order = edges[np.random.RandomState(0).permutation(len(edges))]
    n = warmup + steps + profiled
    e = trainer._ids(np.resize(order, (n * bs, 2)).reshape(n, bs, 2))
    losses = [trainer.train_batch(e[i, :, 0], e[i, :, 1])[0]
              for i in range(warmup)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(warmup, warmup + steps):
        losses.append(trainer.train_batch(e[i, :, 0], e[i, :, 1])[0])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = profiling.counts()
    peak = (torch.cuda.max_memory_allocated() - before) / 2**30
    losses = [float(x) for x in torch.stack(losses).cpu()]
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"fc7 step: non-finite losses {losses[:8]}")
    if any(launches.values()):
        raise AssertionError(f"fc7 step launched {launches}, expected no "
                             f"kernel of the port")
    first = warmup + steps

    def some_steps():
        for i in range(first, first + profiled):
            trainer.train_batch(e[i, :, 0], e[i, :, 1])

    prof = profile_phase(some_steps, "fc7 step")
    steps_per_epoch = len(edges) // bs
    ms = 1e3 * seconds / steps
    out = {"n_images": n_images, "n_labels": graph.n_labels,
           "train_edges": int(len(edges)),
           "features_bytes": int(feats.numel() * 4),
           "steps_timed": steps, "ms_per_step": ms,
           "steps_per_s": steps / seconds,
           "steps_per_epoch": steps_per_epoch,
           "implied_epoch_s": steps_per_epoch * ms / 1e3,
           "peak_memory_above_before_gib": peak,
           "memory_allocated_before_gib": before / 2**30,
           "profiled_steps": profiled,
           "profile_wall_ms_per_step": prof["wall_ms"] / profiled,
           "profile_device_busy_ms_per_step":
               prof["device_busy_ms"] / profiled,
           "device_entries_per_step": prof["device_entries"] / profiled,
           "idle_share": prof["idle_share"],
           "losses_first_last": [losses[0], losses[-1]],
           "launches": launches}
    log(f"[fc7] full-width step (hyp_cone + adam, {n_images} images, "
        f"{graph.n_labels} labels, {len(edges)} train edges, features "
        f"{out['features_bytes'] / 1e6:.1f} MB): {ms:.3f} ms/step, "
        f"{out['steps_per_s']:.1f} steps/s over {steps} steps; an epoch of "
        f"{steps_per_epoch} steps would take {out['implied_epoch_s']:.1f} "
        f"s; profiled {profiled} steps: {out['device_entries_per_step']:.0f}"
        f" device entries a step, idle share {prof['idle_share']}; peak "
        f"{peak:.3f} GiB above the {before / 2**30:.3f} GiB held before")
    return trainer, out


def _fc7_eval(trainer, splits):
    """The runner's eval sequence: val ranking and edge metrics (the
    threshold), reconstruction, test ranking and edge metrics at it;
    returns (metrics, seconds per stage)."""
    import torch

    sec, m = {}, {}
    for split in ("val", "test"):
        paths, feats = splits[split]
        t0 = time.perf_counter()
        m[split] = trainer.classification_metrics(paths, feats)
        sec[f"ranking_{split}_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        th = trainer.optimal_threshold if split == "test" else None
        m[f"{split}_edge"] = trainer.edge_metrics(paths, feats, threshold=th)
        if split == "val":
            trainer.optimal_threshold = float(m["val_edge"].threshold)
        sec[f"edge_{split}_s"] = time.perf_counter() - t0
        if split == "val":
            t0 = time.perf_counter()
            m["reconstruction"] = trainer.reconstruction()
            torch.cuda.synchronize()
            sec["reconstruction_s"] = time.perf_counter() - t0
    return m, sec


def fc7_epoch_phase(labelmap, n_images=2048, n_val=VAL_IMAGES,
                    n_test=TEST_IMAGES):
    """(c) one train_epoch of each fc7 run on a graph of `n_images`
    synthetic images, then the runner's eval on `n_val`- and
    `n_test`-row synthetic feature splits; each run is a path of its own.
    The order run's eval launches K3 three times (two rankings, one
    reconstruction), all on exact_d, and its energies are held against the
    plain version; the hyperbolic runs launch none and keep their label
    rows in [r0, 1 − 1e−5]."""
    import numpy as np
    import torch

    from learning_embeddings_tpu_torch.geometry import inner_radius
    from learning_embeddings_tpu_torch.ops import pairwise_order as k3
    from learning_embeddings_tpu_torch.train.joint import (
        JointEmbeddingTrainer)
    from learning_embeddings_tpu_torch.utils import profiling

    gen = torch.Generator(device=DEV).manual_seed(1)
    graph, edges = _fc7_graph(labelmap, n_images)
    feats = _fc7_features(n_images, gen)
    rng = np.random.RandomState(1)
    splits = {"val": (_split_paths(labelmap, n_val, rng),
                      _fc7_features(n_val, gen)),
              "test": (_split_paths(labelmap, n_test, rng),
                       _fc7_features(n_test, gen))}
    runs, paths = {}, {}
    for energy, opt in FC7_RUNS:
        name = f"fc7_epoch_{energy}_{opt}"
        cfg = _fc7_cfg(energy, opt)
        profiling.reset_counts()
        trainer = JointEmbeddingTrainer(labelmap, graph, edges, feats, cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = trainer.train_epoch(0, np.random.RandomState(0))
        epoch_s = time.perf_counter() - t0
        m, sec = _fc7_eval(trainer, splits)
        paths[name] = launches = profiling.counts()

        scal = [stats["loss"], stats["e_pos_mean"], stats["e_neg_mean"]] + [
            float(v) for k in ("val_edge", "test_edge", "reconstruction")
            for v in m[k]] + [m[s]["micro_f1"] for s in ("val", "test")]
        if not all(map(math.isfinite, scal)):
            raise AssertionError(f"{name}: non-finite {stats} {m}")
        if launches["bn_stats"] or launches["bn_corr"]:
            raise AssertionError(f"{name} launched {launches}")
        err = annulus = None
        if energy == "order":
            _k3_on_exact_d(name, launches, 3)
            if launches["pairwise_order"] != 3:
                raise AssertionError(f"{name}: {launches}, expected 3 K3 "
                                     f"launches (2 rankings, 1 "
                                     f"reconstruction)")
            lab = trainer.label_embeddings()
            img = trainer.image_embeddings(splits["val"][1])
            err = k3_compare(f"{name} eval energies",
                             k3.pairwise_order(lab, img),
                             k3.pairwise_order_plain(lab, img))
        else:
            if launches["pairwise_order"]:
                raise AssertionError(f"{name}: pairwise_order launched "
                                     f"{launches}, expected none")
            r0 = inner_radius(trainer.K)
            annulus = max(
                _annulus_error(trainer.label_embeddings(), r0),
                _annulus_error(trainer.embedder.embedding.detach(), r0)
                if opt != "rsgd" else 0.0)
            if annulus > ANNULUS_TOL:
                raise AssertionError(f"{name}: label rows lie {annulus} "
                                     f"outside the annulus")
        steps = max(len(edges) // cfg.batch_size, 1)
        runs[name] = {
            "energy": energy, "optimizer": opt, "n_images": n_images,
            "train_edges": int(len(edges)), "steps": steps,
            "epoch_s": epoch_s, "ms_per_step": 1e3 * epoch_s / steps,
            "stats": stats, "eval_s": sec, "eval_images": [n_val, n_test],
            "val_micro_f1": m["val"]["micro_f1"],
            "test_micro_f1": m["test"]["micro_f1"],
            "test_hit@1": m["test"]["hit@1"],
            "val_edge_f1": float(m["val_edge"].f1),
            "test_edge_f1": float(m["test_edge"].f1),
            "reconstruction_f1": float(m["reconstruction"].f1),
            "launches": launches, "eval_energy_max_abs_err": err,
            "label_annulus_error": annulus}
        log(f"[fc7] {name}: {steps} steps in {epoch_s:.2f} s "
            f"({runs[name]['ms_per_step']:.3f} ms/step), loss "
            f"{stats['loss']:.4g}; eval " + ", ".join(
                f"{k} {v:.3f}" for k, v in sec.items()) +
            f"; test micro-F1 {m['test']['micro_f1']:.4f}, edge F1 "
            f"{float(m['test_edge'].f1):.4f}, reconstruction F1 "
            f"{float(m['reconstruction'].f1):.4f}; launches {launches}" +
            ("" if err is None else f"; eval energies kernel vs plain max "
             f"err {err:.3g}"))
    return runs, paths


def fc7_runner_phase(warm_path, n_images=1024, n_val=1024, n_test=1024,
                     epochs=2, resume_to=3):
    """(d) run_joint_embedding at the trainer's defaults (hyp_cone, the
    hybrid Adam) on Butterfly200 (the taxonomy of phase 7's runs) with a
    graph of `n_images` synthetic images and held-out splits of
    `n_val`/`n_test` feature rows, warm-started from phase 7's hyperbolic
    best_model (its table and threshold): `epochs` epochs, then
    resume=True to `resume_to`; one checkpoint's size, save and load."""
    import argparse as _ap

    import numpy as np
    import torch

    from learning_embeddings_tpu_torch.cli._joint_main import load_warm_start
    from learning_embeddings_tpu_torch.hierarchy import butterfly200_labelmap
    from learning_embeddings_tpu_torch.train.experiment import (
        Checkpointer, ExperimentDir)
    from learning_embeddings_tpu_torch.train.runner import (
        run_joint_embedding)

    lm = butterfly200_labelmap()
    nl = lm.n_classes
    gen = torch.Generator(device=DEV).manual_seed(2)
    graph, edges = _fc7_graph(lm, n_images)
    feats = _fc7_features(n_images, gen)
    rng = np.random.RandomState(2)
    eval_paths = {"val": _split_paths(lm, n_val, rng),
                  "test": _split_paths(lm, n_test, rng)}
    eval_features = {"val": _fc7_features(n_val, gen),
                     "test": _fc7_features(n_test, gen)}
    table, thr = load_warm_start(_ap.Namespace(load_emb_from=warm_path,
                                               load_cosine_emb=None), nl)
    if table is None or table.shape != (nl, EMB_DIM) or thr is None:
        raise AssertionError(f"fc7 warm start from {warm_path}: {thr}")
    exp_dir = os.path.join(EXPERIMENTS, "fc7")
    paths, runs = {}, {}
    for name, kw in (("fc7_runner", dict(n_epochs=epochs,
                                         init_embeddings=table,
                                         init_threshold=thr)),
                     ("fc7_runner_resume", dict(n_epochs=resume_to,
                                                resume=True))):
        res, seconds = _run_path(name, lambda: run_joint_embedding(
            lm, graph, edges, feats, _fc7_cfg("hyp_cone", "adam"),
            experiment_dir=exp_dir, experiment_name="r",
            eval_features=eval_features, eval_paths=eval_paths,
            manifest_args={"phase": name}, **kw), paths)
        if any(paths[name].values()):
            raise AssertionError(f"{name} launched {paths[name]}")
        finals = [res["reconstruction_f1"]] + list(
            res["test_metrics"].values())
        if not all(map(math.isfinite, finals)):
            raise AssertionError(f"{name}: {res['test_metrics']}")
        runs[name] = {"seconds": seconds, "best_epoch": res["best_epoch"],
                      "best_val_micro_f1": res["best_val_micro_f1"],
                      "test_metrics": res["test_metrics"],
                      "reconstruction_f1": res["reconstruction_f1"],
                      "threshold": res["trainer"].optimal_threshold}
    root = os.path.join(exp_dir, "r")
    metrics = _jsonl(root)
    if _steps(root, "train/loss") != list(range(resume_to)):
        raise AssertionError(f"fc7 resume: train epochs "
                             f"{_steps(root, 'train/loss')}")
    if runs["fc7_runner_resume"]["best_val_micro_f1"] < runs["fc7_runner"][
            "best_val_micro_f1"]:
        raise AssertionError("fc7 resume lost the best val micro-F1")
    tr = res["trainer"]
    ckpt = Checkpointer(ExperimentDir(exp_dir, "r"))
    payload = tr.checkpoint_payload()
    t0 = time.perf_counter()
    ckpt.save("timed", payload)
    save_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    tr.restore_payload(ckpt.load("timed", payload))
    torch.cuda.synchronize()
    out = {"runs": runs, "n_images": n_images, "eval_images": [n_val, n_test],
           "warm_start_threshold": thr,
           "epoch_s": [r["value"] for r in metrics
                       if r["tag"] == "epoch_time"],
           "checkpoint_save_ms": save_ms,
           "checkpoint_load_ms": 1e3 * (time.perf_counter() - t0),
           "checkpoint_bytes": os.path.getsize(os.path.join(ckpt.dir,
                                                            "timed"))}
    log(f"[fc7] runner: epochs {[round(t, 2) for t in out['epoch_s']]} s; "
        + "; ".join(f"{k}: {v['seconds']:.1f} s, best epoch "
                    f"{v['best_epoch']}, val micro-F1 "
                    f"{v['best_val_micro_f1']:.4f}, test edge F1 "
                    f"{v['test_metrics'].get('edge_f1', float('nan')):.4f}"
                    for k, v in runs.items()) +
        f"; checkpoint {out['checkpoint_bytes']} bytes, save "
        f"{save_ms:.1f} ms, load {out['checkpoint_load_ms']:.1f} ms")
    return out, paths


def fc7_cli_phase():
    """(e) cli/oe_h.py (hyp_cone) and cli/oe.py (order) without --use_CNN,
    1 epoch each at the CLI defaults, on the 2048-wide {split}.npz features
    that phase 10's image_emb wrote for its records: the reference's
    two-stage pipeline. The order run's eval launches K3 three times, all
    on exact_d; the hyperbolic run's none."""
    from learning_embeddings_tpu_torch.cli import oe, oe_h

    root = os.path.join(EXPERIMENTS, "classifier_data")
    feats = os.path.join(EXPERIMENTS, "classifier_emb")
    paths, out = {}, {}
    for name, main, want in (("cli_oe_h_fc7", oe_h.main, 0),
                             ("cli_oe_fc7", oe.main, 3)):
        res, seconds = _run_path(name, lambda: main(
            ["--data_dir", os.path.join(root, "splits"), "--image_dir",
             os.path.join(root, "images"), "--features_dir", feats,
             "--set_mode", "train", "--n_epochs", "1", "--experiment_dir",
             EXPERIMENTS, "--experiment_name", name, "--device", DEV]),
            paths)
        launches = paths[name]
        if want:
            _k3_on_exact_d(name, launches, want)
        if launches["pairwise_order"] != want or launches["bn_stats"] or \
                launches["bn_corr"]:
            raise AssertionError(f"{name} launched {launches}, expected "
                                 f"{want} pairwise_order and no BN")
        tr = res["trainer"]
        finals = [res["reconstruction_f1"]] + list(
            res["test_metrics"].values())
        if tr.featnet.fc1.in_features != FC7_DIM or \
                not all(map(math.isfinite, finals)) or \
                "edge_f1" not in res["test_metrics"]:
            raise AssertionError(f"{name}: {tr.featnet} "
                                 f"{res['test_metrics']}")
        epoch_s = [r["value"] for r in _jsonl(os.path.join(EXPERIMENTS,
                                                           name))
                   if r["tag"] == "epoch_time"]
        out[name] = {"seconds": seconds, "energy": tr.cfg.energy,
                     "train_images": tr.graph.n_images,
                     "train_steps": len(tr.train_edges) // tr.cfg.batch_size,
                     "epoch_s": epoch_s, "test_metrics": res["test_metrics"],
                     "reconstruction_f1": res["reconstruction_f1"],
                     "launches": launches}
        log(f"[fc7] {name}: {seconds:.1f} s ({out[name]['train_steps']} "
            f"steps on {tr.graph.n_images} images; epoch {epoch_s} s), "
            f"test micro-F1 {res['test_metrics']['micro_f1']:.4f}, edge F1 "
            f"{res['test_metrics']['edge_f1']:.4f}; launches {launches}")
    return out, paths


# --------------------------------------------------------------------------
# phase 12: slice 8, inference and reports on phase 10's experiment
# --------------------------------------------------------------------------
def _as_f32(model):
    """`model` with float32 activations (the trunk and its BatchNorms cast
    their inputs to their `dtype`)."""
    import torch

    for m in model.modules():
        if isinstance(getattr(m, "dtype", None), torch.dtype):
            m.dtype = torch.float32
    return model


def inference_phase(n_samples=2, num_perturb=100, n_slic_segments=48,
                    timed_batches=10):
    """cli/inference.py's card work on phase 10's classifier experiment
    (ResNet-50@448, the taxonomy's multi-level head, best_model): the
    rebuild from the manifest, run_tsne (no drawing) over the val and test
    splits (batch 32), the eval forward's images/s and a profile of it,
    the occlusion maps of `n_samples` test images (225 occluded 448²
    images each, batches of 32) and LIME's per-level softmax and
    coefficients for the same samples (`num_perturb` perturbations, SLIC
    and the ridge fit on the host); one sample's logits on the card
    against the CPU path's (bf16 as run, and f32 with TF32 off); then
    cross_level_confusion on the experiment's score dumps and
    read_jsonl_scalars on its metrics. No BN kernel may launch: BatchNorm
    runs on its running statistics. The drawing functions (matplotlib,
    sklearn) are not called: the card's machine has neither."""
    import numpy as np
    import torch

    from learning_embeddings_tpu_torch.cli import inference
    from learning_embeddings_tpu_torch.data import ImagePipeline
    from learning_embeddings_tpu_torch.eval import cross_level_confusion
    from learning_embeddings_tpu_torch.utils.tblog import read_jsonl_scalars
    from learning_embeddings_tpu_torch.viz.lime import slic_segments

    exp_path = os.path.join(EXPERIMENTS, "classifier", "e")
    image_dir = os.path.join(EXPERIMENTS, "classifier_data", "images")
    paths, out = {}, {}
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    def card_work():
        t0 = time.perf_counter()
        lm, datasets, trainer, _, _, _ = inference.rebuild_from_manifest(
            exp_path, DEV)
        out["rebuild_s"] = time.perf_counter() - t0
        S = trainer.cfg.image_size

        # t-SNE dumps of every val and test image
        t0 = time.perf_counter()
        reps = inference.run_tsne(exp_path, image_dir, render=False,
                                  device=DEV)
        out["tsne_s"] = time.perf_counter() - t0
        width = trainer.model.trunk.feature_dim
        for split, (F, L) in reps.items():
            n = len(datasets[split])
            if F.shape != (n, width) or F.dtype != np.float32 or \
                    not np.isfinite(F).all() or L.shape != (n, lm.n_levels):
                raise AssertionError(f"run_tsne {split}: {F.shape} "
                                     f"{F.dtype} {L.shape}")
        out["tsne_images"] = {s: len(F) for s, (F, _) in reps.items()}

        # the eval forward alone, on one batch of (up to) 32 decoded test
        # images
        nb = min(32, len(datasets["test"]))
        pipe = ImagePipeline(datasets["test"], lm, image_dir, image_size=S,
                             batch_size=nb, train=False, num_workers=4)
        x = torch.as_tensor(next(iter(pipe.batches(np.arange(nb))))[
            "image"]).to(DEV)
        inference._trunk_apply(trainer, x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(timed_batches):
            inference._trunk_apply(trainer, x)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / timed_batches
        out["forward_batch"] = nb
        out["forward_ms_per_batch"] = ms
        out["forward_images_per_s"] = 1e3 * nb / ms
        out["forward_profile"] = profile_phase(
            lambda: inference._trunk_apply(trainer, x), "inference")

        # occlusion and LIME on the first test samples
        pipe1 = ImagePipeline(datasets["test"], lm, image_dir, image_size=S,
                              batch_size=1, train=False, num_workers=2)
        samples = list(pipe1.batches(np.arange(n_samples)))
        slices = inference.level_slices(trainer)
        if len(slices) != lm.n_levels:
            raise AssertionError(f"level slices {slices}")
        grid = len(range(0, S - min(56, S // 4) + 1, min(28, S // 4)))
        occ_ms = []
        for b in samples:
            t0 = time.perf_counter()
            maps = inference.occlusion_maps(trainer, b["image"],
                                            b["level_labels"][0], slices)
            occ_ms.append(1e3 * (time.perf_counter() - t0))
            if maps.shape != (lm.n_levels, grid, grid) or \
                    not np.isfinite(maps).all():
                raise AssertionError(f"occlusion maps {maps.shape}")
        out["occlusion"] = {"images_per_sample": grid * grid,
                            "ms_per_sample": occ_ms,
                            "images_per_s": [1e3 * (grid * grid + 1) / t
                                             for t in occ_ms]}

        predict = inference.lime_predict(trainer, slices)
        fwd = [0.0]

        def timed_predict(images):
            t = time.perf_counter()
            probs = predict(images)     # numpy: waits for the card
            fwd[0] += time.perf_counter() - t
            return probs
        lime = {"slic_ms": [], "forward_ms": [], "masks_and_ridge_ms": [],
                "ms_per_sample": []}
        for b in samples:
            img = b["image"][0]
            t0 = time.perf_counter()
            seg = slic_segments(img, n_segments=n_slic_segments)
            t1 = time.perf_counter()
            fwd[0] = 0.0
            coefs, probs0 = inference.lime_coefficients(
                timed_predict, img, seg, num_perturb)
            t2 = time.perf_counter()
            if coefs.shape != (lm.n_classes, seg.max() + 1) or \
                    not np.isfinite(coefs).all() or not np.allclose(
                        [probs0[a:b_].sum() for _, a, b_ in slices], 1.0,
                        atol=1e-4):
                raise AssertionError(f"LIME {coefs.shape} {probs0}")
            lime["slic_ms"].append(1e3 * (t1 - t0))
            lime["forward_ms"].append(1e3 * fwd[0])
            lime["masks_and_ridge_ms"].append(1e3 * (t2 - t1 - fwd[0]))
            lime["ms_per_sample"].append(1e3 * (t2 - t0))
        out["lime"] = dict(lime, perturbations=num_perturb,
                           segments=n_slic_segments)

        # one sample's logits, card against CPU, from the same weights
        cpu = inference.rebuild_from_manifest(exp_path, "cpu")[2]
        img = samples[0]["image"]
        cmp = {}
        prev = torch.backends.cudnn.allow_tf32
        try:
            for dtype, tol in (("bfloat16", 5e-2), ("float32", 1e-4)):
                if dtype == "float32":
                    torch.backends.cudnn.allow_tf32 = False
                    _as_f32(trainer.model), _as_f32(cpu.model)
                card = inference.logits_fn(trainer)(img).cpu().numpy()
                host = inference.logits_fn(cpu)(img).numpy()
                err = float(np.abs(card - host).max())
                scale = float(np.abs(host).max())
                cmp[dtype] = {"max_abs_err": err, "max_abs_logit": scale,
                              "tolerance": f"{tol} * max|logit|"}
                if not err <= tol * scale:
                    raise AssertionError(f"{dtype} logits: card and CPU "
                                         f"differ by {err} (max |logit| "
                                         f"{scale}, tolerance {tol}·max)")
        finally:
            torch.backends.cudnn.allow_tf32 = prev
        out["card_vs_cpu_logits"] = cmp

        # the reports of the experiment's dumps and logs
        stats = os.path.join(exp_path, "stats")
        scores = np.load(os.path.join(stats, "predicted_scores.npy"))
        ll = np.load(os.path.join(stats, "correct_labels.npy"))
        t0 = time.perf_counter()
        for p, g in ((0, lm.n_levels - 1), (lm.n_levels - 1,
                                            lm.n_levels - 1), (2, 1)):
            m, _, _ = cross_level_confusion(scores, ll, lm, p, g)
            if m.shape != (lm.levels[g], lm.levels[p]) or \
                    m.sum() != len(scores):
                raise AssertionError(f"confusion p{p} g{g}: {m.shape}")
        scalars = read_jsonl_scalars(os.path.join(exp_path, "logs",
                                                  "metrics.jsonl"))
        if [s for s, _ in scalars["train/loss"]] != [0, 1, 2]:
            raise AssertionError(f"metrics.jsonl: {scalars['train/loss']}")
        out["reports_ms"] = 1e3 * (time.perf_counter() - t0)

    _, seconds = _run_path("inference", card_work, paths)
    if paths["inference"]["bn_stats"] or paths["inference"]["bn_corr"]:
        raise AssertionError(f"inference launched {paths['inference']}")
    out["seconds"] = seconds
    out["peak_gib_above_held"] = (torch.cuda.max_memory_allocated()
                                  - held) / 2**30
    out["launches"] = paths["inference"]
    prof = out["forward_profile"]
    log(f"[inference] {seconds:.1f} s: rebuild {out['rebuild_s']:.2f} s, "
        f"run_tsne {out['tsne_s']:.2f} s ({out['tsne_images']} images); "
        f"eval forward {out['forward_ms_per_batch']:.2f} ms a batch of "
        f"{out['forward_batch']} ({out['forward_images_per_s']:.1f} images/s, idle share "
        f"{prof['idle_share']}); peak "
        f"{out['peak_gib_above_held']:.3f} GiB above the "
        f"{held / 2**30:.3f} GiB held; launches {paths['inference']}")
    log(f"[inference] occlusion ({out['occlusion']['images_per_sample']} "
        f"images a sample): "
        f"{[round(t, 1) for t in out['occlusion']['ms_per_sample']]} ms a "
        f"sample; LIME ({num_perturb} perturbations): SLIC "
        f"{[round(t, 1) for t in out['lime']['slic_ms']]} ms (host), "
        f"forward {[round(t, 1) for t in out['lime']['forward_ms']]} ms "
        f"(card), masks and ridge "
        f"{[round(t, 1) for t in out['lime']['masks_and_ridge_ms']]} ms "
        f"(host); logits card vs CPU {out['card_vs_cpu_logits']}; reports "
        f"{out['reports_ms']:.1f} ms")
    return out, paths


# --------------------------------------------------------------------------
# phase 13: slice 8, the CIFAR / FashionMNIST classifier CLIs
# --------------------------------------------------------------------------
def other_datasets_phase(image_size=224, batch=8):
    """cli/fashion_mnist.py and cli/cifar.py --dataset cifar10 through
    main(argv) at their defaults (ResNet-18, multi_level, Adam lr 1e-3,
    RandomResizedCrop) with --debug on the synthetic stand-in (no dataset
    files: 600 images, ~480 of them train), 1 epoch each. Every train step
    launches 20 + 20 BN kernels (FashionMNIST through the 1-channel stem),
    no eval step any, and no channels_last copy is made. Then the
    FashionMNIST step alone (a synthetic batch, after 3 warm-up steps:
    the epochs include cuDNN's autotuning of each new shape) with a
    profile, and K1 and K2 against their plain versions at the 20 BN
    shapes of that step."""
    import numpy as np
    import torch

    from learning_embeddings_tpu_torch.cli import cifar, fashion_mnist
    from learning_embeddings_tpu_torch.data import workloads

    paths, out = {}, {"runs": {}}
    n_bn, _ = BACKBONE_BN_FEATURES["resnet18"]
    for name, main, extra, lm in (
            ("cli_fashion_mnist", fashion_mnist.main, [],
             workloads.fmnist_labelmap()),
            ("cli_cifar10", cifar.main, ["--dataset", "cifar10"],
             workloads.cifar10_labelmap())):
        argv = ["--experiment_dir", EXPERIMENTS, "--experiment_name", name,
                "--debug", "--loss", "multi_level", "--set_mode", "train",
                "--n_epochs", "1", "--image_size", str(image_size),
                "--batch_size", str(batch), "--data_root",
                os.path.join(EXPERIMENTS, "no_dataset"), "--device", DEV,
                *extra]
        res, seconds = _run_path(name, lambda: main(argv), paths)
        launches = paths[name]
        copies = launches["channels_last_copies"]
        labels = workloads.synthetic_array_dataset(lm, 600).leaf_labels
        steps = len(workloads.stratified_index_split(labels)[0]) // batch
        if res["train_steps"] != steps:
            raise AssertionError(f"{name}: {res['train_steps']} train "
                                 f"steps, expected {steps}")
        for k in ("bn_stats", "bn_corr"):
            if launches[k] != n_bn * steps:
                raise AssertionError(f"{name}: {k} launched {launches[k]} "
                                     f"times in {steps} train steps and "
                                     f"the evals, expected {n_bn} a step")
        if copies:
            raise AssertionError(f"{name}: {copies} channels_last copies")
        metrics = _jsonl(os.path.join(EXPERIMENTS, name))
        bad = [r for r in metrics if not math.isfinite(r["value"])]
        if bad or not all(map(math.isfinite, res["test_metrics"].values())):
            raise AssertionError(f"{name}: non-finite {bad} "
                                 f"{res['test_metrics']}")

        def tag(t):
            return [r["value"] for r in metrics if r["tag"] == t][0]
        steps_s = tag("epoch_time_train") - tag("epoch_time_data_wait")
        out["runs"][name] = {
            "seconds": seconds, "train_steps": steps, "launches": launches,
            "channels_last_copies": copies,
            "train_loss": tag("train/loss"),
            "test_metrics": res["test_metrics"],
            "epoch_s": tag("epoch_time"),
            "train_pass_s": tag("epoch_time_train"),
            "data_wait_s": tag("epoch_time_data_wait"),
            "eval_s": tag("epoch_time_eval"),
            "checkpoint_s": tag("epoch_time_checkpoint"),
            "ms_per_step": 1e3 * steps_s / steps,
            "images_per_s": steps * batch / steps_s}
        r = out["runs"][name]
        log(f"[datasets] {name}: {seconds:.1f} s, {steps} steps "
            f"({r['ms_per_step']:.2f} ms a step without the data wait, "
            f"{r['images_per_s']:.1f} images/s), epoch {r['epoch_s']:.2f} "
            f"s (train pass {r['train_pass_s']:.2f}, data wait "
            f"{r['data_wait_s']:.2f}, eval {r['eval_s']:.2f}, checkpoints "
            f"{r['checkpoint_s']:.2f}); loss {r['train_loss']:.4f}, test "
            f"micro-F1 {res['test_metrics']['micro_f1']:.4f}; launches "
            f"{launches}, channels_last copies {copies}")
    from learning_embeddings_tpu_torch.data import multihot_from_level_labels
    from learning_embeddings_tpu_torch.train.classifier import (
        ClassifierConfig, ClassifierTrainer)

    lm = workloads.fmnist_labelmap()
    tr = ClassifierTrainer(lm, ClassifierConfig(
        backbone="resnet18", lr=1e-3, image_size=image_size,
        batch_size=batch, device=DEV), grayscale=True)
    rng = np.random.RandomState(0)
    ll = lm.leaf_paths()[rng.randint(0, lm.levels[-1], batch)]
    b = tr.put_batch(rng.randint(0, 256, (batch, image_size, image_size, 1))
                     .astype(np.uint8), ll,
                     multihot_from_level_labels(ll, lm))
    for _ in range(3):
        tr.train_step(tr.state, *b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        tr.train_step(tr.state, *b)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / 20
    out["step_alone"] = {"ms_per_step": ms, "images_per_s": 1e3 * batch / ms,
                         "profile": profile_phase(
                             lambda: tr.train_step(tr.state, *b),
                             "datasets")}
    log(f"[datasets] the FashionMNIST step alone (synthetic batch, after "
        f"warm-up): {ms:.2f} ms ({1e3 * batch / ms:.1f} images/s)")
    del tr, b

    per_image = {(R * image_size ** 2 // 224 ** 2, C): n
                 for (R, C), n in RESNET18_224_BN.items()}
    rows = kernels_phase(batch, shapes=per_image, ragged=None,
                         tag="datasets")
    torch.cuda.synchronize()
    out["bn_shapes"] = [{"R": r["R"], "C": r["C"], "layers": r["layers"],
                         **{k: r[k]["max_abs_err"]
                            for k in ("bn_stats", "bn_corr")}}
                        for r in rows]
    return out, paths, rows


# --------------------------------------------------------------------------
# phase 14: slice 9, the model zoo
# --------------------------------------------------------------------------
#: per-image (R, C) of the 8 train-mode BatchNorm layers of VGG11BN at
#: 448², with how many layers have each shape
VGG11BN_448_BN = {(200704, 64): 1, (50176, 128): 1, (12544, 256): 2,
                  (3136, 512): 2, (784, 512): 2}
#: the ghost route's statistics rows and VGG11BN's batch
GHOST_ROWS, VGG_BATCH = 8, 64
#: the ResNet-50@448 classifier options of phase 14: config fields and the
#: K1 / K2 launches a step (remat: the 52 block BatchNorms recompute)
ZOO_OPTIONS = {"s2d": (dict(stem="s2d"), 53, 53),
               "remat": (dict(remat=True), 105, 53),
               "ghost8": (dict(bn_stats_rows=GHOST_ROWS), 53, 53),
               "bf16_stats": (dict(bn_stats_dtype="bfloat16"), 53, 53),
               "flax": (dict(bn_impl="flax"), 0, 0)}
#: the small card-against-CPU steps: backbone, options, K1 / K2 launches
ZOO_SMALL = {"s2d": ("resnet18", dict(stem="s2d"), 20, 20),
             "remat": ("resnet18", dict(remat=True), 39, 20),
             "ghost2": ("resnet18", dict(bn_stats_rows=2), 20, 20),
             "bf16_stats": ("resnet18", dict(bn_stats_dtype="bfloat16"),
                            20, 20),
             "flax": ("resnet18", dict(bn_impl="flax"), 0, 0),
             "vgg11_bn": ("vgg11_bn", {}, 8, 8),
             "alexnet": ("alexnet", {}, 0, 0)}
#: profile classes of a step: (class, name patterns), the first match
#: counts; library_bn is the library's BatchNorm (ATen's channels_last
#: kernels or cuDNN's)
PROFILE_CLASSES = (
    ("bn_kernels_of_the_port", ("bn_stats_kernel", "bn_corr_kernel")),
    ("library_bn", ("bn_fw", "bn_bw", "batch_norm", "batchnorm",
                    "BatchNorm", "bn_")),
    ("conv", ("conv", "xmma", "cutlass", "gemm", "dgrad", "wgrad",
              "implicit", "nchwToNhwc", "nhwcToNchw", "cudnn")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "reduce",
                     "Memcpy", "Memset", "copy", "fill")))


def profile_classes(prof):
    """Device ms of a profile_phase() result by PROFILE_CLASSES (the rest
    under 'other')."""
    out = {c: 0.0 for c, _ in PROFILE_CLASSES}
    out["other"] = 0.0
    for name, ms in prof["per_name_ms"].items():
        cls = next((c for c, pats in PROFILE_CLASSES
                    if any(p in name for p in pats)), "other")
        out[cls] += ms
    return out


def k1_rows(shapes, batch, tag, round_sq=False, library=True):
    """K1 (or its bf16-rounding variant) against its plain version at
    `shapes` (per image) × `batch`, timed; the library call is
    torch.batch_norm_stats where it computes the same function."""
    import torch

    from learning_embeddings_tpu_torch.ops import bn, bn_triton

    gen = torch.Generator(device=DEV).manual_seed(0)
    rows = []
    for (R, C), mult in shapes.items():
        Rb = R * batch
        err, times = check_reduction(
            "bn_stats" + ("_bf16sq" if round_sq else ""),
            lambda x2: bn_triton.bn_stats(x2, round_sq),
            lambda x2: bn._stats_plain(x2, round_sq),
            (lambda x2, R=R: torch.batch_norm_stats(_as4d(x2, R), 1e-5))
            if library else None, Rb, C, 1, gen)
        rows.append({"R": Rb, "C": C, "layers": mult, "max_abs_err": err,
                     **times, "bound_ms": bound_ms(Rb, C, 1)})
        log(f"[{tag}] R={Rb:>9} C={C:>4} x{mult:<2} bn_stats"
            f"{' (bf16 x²)' if round_sq else ''} {times['ms'] * 1e3:7.1f}us "
            f"(plain {times['plain_ms'] * 1e3:7.1f}, library "
            + ("none" if times["library_ms"] is None
               else f"{times['library_ms'] * 1e3:7.1f}")
            + f", bound {rows[-1]['bound_ms'] * 1e3:6.1f}) err {err:.3g}")
    return rows


def zoo_kernels_phase(batch):
    """Phase 2's additions: K1/K2 at VGG11BN@448's 8 BN shapes (batch 64),
    K1 at the ghost route's prefix shapes of ResNet-50@448 (8 rows), and
    K1's bf16-rounding variant at ResNet-50@448's 12 shapes (batch
    `batch`), each on integer-valued (exact) and normal inputs."""
    return {
        "vgg11_bn_448_b64": kernels_phase(VGG_BATCH, shapes=VGG11BN_448_BN,
                                          ragged=None, tag="kernels-vgg"),
        "ghost_prefix_r50_448_rows8": k1_rows(RESNET50_448_BN, GHOST_ROWS,
                                              "kernels-ghost"),
        "bf16_square_r50_448": k1_rows(RESNET50_448_BN, batch,
                                       "kernels-bf16sq", round_sq=True,
                                       library=False)}


def _half_h(shapes):
    """Per-image (R, C) BN shapes with H halved: a rank's rows under
    spatial partitioning over two model ranks."""
    return {(R // 2, C): n for (R, C), n in shapes.items()}


def mesh_kernels_phase():
    """Phase 2's additions for phase 15: K1/K2 at the rows each rank gives
    them there, on integer-valued (exact) and normal inputs. ResNet-50@448
    at 64 rows ((a): 128 over two ranks), 16 rows ((b)'s tower: its
    batches' unique images bucketed to 32, 16 a rank) and 8 rows ((d), 8
    a card); ResNet-18@64 at 4 rows in f32 ((c): 8 over two data shards);
    the dryrun twin's bf16 ResNet-18 at 64² (4 rows; 2 in its grad_accum
    micro-steps) and at 32² (its tower, 8 edges bucketed to 8, 4 a
    rank); and (f)'s spatial shapes, each image's H halved over two model
    ranks: ResNet-50@448 at 128 images (the bf16 step), ResNet-18@64 at 8
    images in f32 (the small step) and at 4 and 2 images in bf16 (the
    dryrun twin's spatial stage on (2, 2), and JAX's 2 a micro-step)."""
    import torch

    tables = {"r50_448_rows64": (64, RESNET50_448_BN, None),
              "r50_448_rows16": (16, RESNET50_448_BN, None),
              "r50_448_rows8": (8, RESNET50_448_BN, None),
              "r18_64_rows4_f32": (4, RESNET18_64_BN, torch.float32),
              "r18_64_rows4": (4, RESNET18_64_BN, None),
              "r18_64_rows2": (2, RESNET18_64_BN, None),
              "r18_32_rows4": (4, RESNET18_32_BN, None),
              "spatial_r50_448_rows128_half_h": (
                  128, _half_h(RESNET50_448_BN), None),
              "spatial_r18_64_rows8_half_h_f32": (
                  8, _half_h(RESNET18_64_BN), torch.float32),
              "spatial_r18_64_rows4_half_h": (4, _half_h(RESNET18_64_BN),
                                              None),
              "spatial_r18_64_rows2_half_h": (2, _half_h(RESNET18_64_BN),
                                              None)}
    return {name: kernels_phase(rows, shapes=shapes, ragged=None,
                                tag=f"kernels-mesh {name}", dtype=dtype)
            for name, (rows, shapes, dtype) in tables.items()}


def small_zoo_phase(image_size=64, batch=8):
    """One f32 train-mode forward and backward of a small model for each
    zoo option (ZOO_SMALL) on the card (kernels) and on the CPU (plain
    versions) from the same weights, TF32 off: logits within 1e-5 of
    max|logit| (bf16 statistics: 1e-2, since the two sides' f32 sums round
    each channel's mean to bf16 and one that straddles a rounding boundary
    moves that channel by a bf16 step), and the card's K1/K2 launches."""
    import numpy as np
    import torch

    from learning_embeddings_tpu_torch.models import (HierarchicalCNN,
                                                      init_params_)
    from learning_embeddings_tpu_torch.ops.image import device_scale
    from learning_embeddings_tpu_torch.utils import profiling

    rng = np.random.RandomState(0)
    imgs = torch.from_numpy(rng.randint(0, 256, (batch, image_size,
                                                 image_size, 3))
                            .astype(np.uint8))
    levels = (2, 4, 8)
    w = torch.from_numpy(rng.randn(batch, sum(levels)).astype(np.float32))
    out = {}
    prev_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for name, (backbone, kw, n_stats, n_corr) in ZOO_SMALL.items():
            model = HierarchicalCNN(backbone, levels, dtype=torch.float32,
                                    **kw)
            init_params_(model, torch.Generator().manual_seed(0))
            state = {k: v.clone() for k, v in model.state_dict().items()}
            res = {}
            for dev in ("cpu", DEV):
                model.load_state_dict(state)
                model.to(device=dev, memory_format=torch.channels_last)
                model.train().zero_grad()
                x = device_scale(imgs.to(dev)).permute(0, 3, 1, 2)
                profiling.reset_counts()
                logits = model(x)
                (logits * w.to(dev)).sum().backward()
                if dev == DEV:
                    torch.cuda.synchronize()
                res[dev] = (logits.detach().cpu(), profiling.counts())
            (card, counts), (cpu, _) = res[DEV], res["cpu"]
            rel = ((card - cpu).abs().max() / cpu.abs().max()).item()
            limit = 1e-2 if "bf16" in name else 1e-5
            want = {"bn_stats": n_stats, "bn_corr": n_corr,
                    "bn_stats_rounded": n_stats if "bf16" in name else 0}
            got = {k: counts[k] for k in want}
            if not rel <= limit or got != want:
                raise AssertionError(
                    f"small {name} ({backbone}) step: card vs CPU logits "
                    f"{rel:.3g} of max|logit| (limit {limit}); launches "
                    f"{got}, expected {want}")
            out[name] = {"backbone": backbone, "rel_logit_err": rel,
                         "limit": limit, "launches": got}
            log(f"[zoo] small {name} ({backbone}) {image_size}² f32 step: "
                f"card vs CPU logits {rel:.2e} of max|logit| (limit "
                f"{limit}); launches {got}")
    finally:
        torch.backends.cudnn.allow_tf32 = prev_tf32
    return out


def zoo_step_phase(labelmap, name, cfg_kw, want, batch, backbone="resnet50",
                   steps=3, warmup=2, image_size=448):
    """The classifier step (multi_level_ce, Adam lr 1e-5, 448², bf16 trunk,
    synthetic uint8 input) with the zoo option `cfg_kw`, as slice_phase
    runs the default: `warmup` + `steps` steps, counts set to 0 just
    before and read just after. Asserts finite losses, `want` = (K1, K2)
    launches a step (bf16 statistics: every K1 the rounding variant) and
    no channels_last copy; records ms a step, images/s and the peak
    memory, above what was allocated before the trainer was built too."""
    import torch

    from learning_embeddings_tpu_torch.train.classifier import (
        ClassifierConfig, ClassifierTrainer)
    from learning_embeddings_tpu_torch.utils import profiling

    base_gib = torch.cuda.memory_allocated() / 2**30
    cfg = ClassifierConfig(backbone=backbone, criterion="multi_level_ce",
                           optimizer="adam", lr=1e-5, image_size=image_size,
                           batch_size=batch, seed=0, dtype=torch.bfloat16,
                           device=DEV, **cfg_kw)
    trainer = ClassifierTrainer(labelmap, cfg)
    gen = torch.Generator(device=DEV).manual_seed(0)
    images = torch.randint(0, 256, (batch, image_size, image_size, 3),
                           dtype=torch.uint8, device=DEV, generator=gen)
    paths = torch.as_tensor(labelmap.leaf_paths(), device=DEV)
    leaves = torch.randint(0, labelmap.levels[-1], (batch,), device=DEV,
                           generator=gen)
    batch_t = trainer.put_batch(images, paths[leaves],
                                torch.zeros((batch, labelmap.n_classes),
                                            device=DEV))
    profiling.reset_counts()
    state, losses = trainer.state, []
    for _ in range(warmup):
        state, loss = trainer.train_step(state, *batch_t)
        losses.append(loss)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, loss = trainer.train_step(state, *batch_t)
        losses.append(loss)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = profiling.counts()
    copies = launches["channels_last_copies"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(l) for l in losses]
    n_steps = warmup + steps
    per_step = {k: launches[k] / n_steps
                for k in ("bn_stats", "bn_stats_rounded", "bn_corr")}
    want_step = {"bn_stats": want[0], "bn_corr": want[1],
                 "bn_stats_rounded": want[0] if cfg.bn_stats_dtype
                 == "bfloat16" else 0}
    if not all(map(math.isfinite, losses)) or per_step != want_step or \
            copies:
        raise AssertionError(
            f"zoo {name}: losses {losses}, launches a step {per_step} "
            f"(expected {want_step}), channels_last copies {copies}")
    result = {"backbone": backbone, "batch": batch, "options": cfg_kw,
              "steps_timed": steps, "steps_total": n_steps,
              "losses": losses, "launches": launches,
              "launches_per_step": per_step, "channels_last_copies": copies,
              "ms_per_step": 1e3 * seconds / steps,
              "images_per_s": batch * steps / seconds,
              "max_memory_allocated_gib": peak,
              "memory_above_start_gib": peak - base_gib}
    log(f"[zoo] {name}: {backbone}@{image_size} batch {batch} {cfg_kw}: "
        f"{result['ms_per_step']:.2f} ms/step, {result['images_per_s']:.1f} "
        f"images/s, peak {peak:.2f} GiB ({peak - base_gib:.2f} above the "
        f"start), launches a step {per_step}, channels_last copies "
        f"{copies}; losses {[round(l, 4) for l in losses]}")
    return trainer, state, batch_t, result


def s2d_equivalence(labelmap, n=8, image_size=448):
    """The s2d ResNet-50 with conv7's weights (conv1 through
    s2d_stem_kernel) against the conv7 model on the card, eval mode at 448²:
    in f32 with TF32 off within 1e-5 of max|logit| (the same taps summed in
    another order), in bf16 within 5e-2 (every layer rounds to bf16)."""
    import torch

    from learning_embeddings_tpu_torch.models import (HierarchicalCNN,
                                                      init_params_)
    from learning_embeddings_tpu_torch.models.resnet import s2d_stem_kernel
    from learning_embeddings_tpu_torch.ops.image import device_scale

    gen = torch.Generator(device=DEV).manual_seed(1)
    x = device_scale(torch.randint(0, 256, (n, image_size, image_size, 3),
                                   dtype=torch.uint8, device=DEV,
                                   generator=gen)).permute(0, 3, 1, 2)
    out = {}
    prev_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for dtype, limit in ((torch.float32, 1e-5), (torch.bfloat16, 5e-2)):
            conv7 = HierarchicalCNN("resnet50", tuple(labelmap.levels),
                                    dtype=dtype)
            init_params_(conv7, torch.Generator().manual_seed(0))
            s2d = HierarchicalCNN("resnet50", tuple(labelmap.levels),
                                  dtype=dtype, stem="s2d")
            sd = conv7.state_dict()
            sd["trunk.conv1.weight"] = s2d_stem_kernel(
                sd["trunk.conv1.weight"])
            s2d.load_state_dict(sd, strict=True)
            with torch.no_grad():
                a = conv7.to(DEV, memory_format=torch.channels_last).eval()(x)
                b = s2d.to(DEV, memory_format=torch.channels_last).eval()(x)
            rel = ((a - b).abs().max() / a.abs().max()).item()
            if not rel <= limit:
                raise AssertionError(f"s2d against conv7 ({dtype}): logits "
                                     f"differ by {rel:.3g} of max|logit| "
                                     f"(limit {limit})")
            out[str(dtype)] = {"rel_logit_err": rel, "limit": limit}
            log(f"[zoo] s2d = conv7 with converted weights, {dtype}: "
                f"{rel:.2e} of max|logit| (limit {limit})")
            del conv7, s2d
    finally:
        torch.backends.cudnn.allow_tf32 = prev_tf32
    torch.cuda.empty_cache()
    return out


def zoo_joint_step(labelmap, tag, cfg_kw, want, image_size=448, batch=16,
                   n_train=2048, steps=3, warmup=2):
    """The hyperbolic joint --use_CNN step at the BASELINE width
    (joint_phase's configuration, energy hyp_cone) with `cfg_kw`, steps
    only: finite losses and `want` = (K1, K2) launches a step."""
    import numpy as np
    import torch

    from learning_embeddings_tpu_torch.losses.joint_sampling import (
        build_joint_graph)
    from learning_embeddings_tpu_torch.train.joint_cnn import (
        JointCNNConfig, JointCNNTrainer)
    from learning_embeddings_tpu_torch.utils import profiling

    nl = labelmap.n_classes
    rng = np.random.RandomState(0)
    graph, train_edges = build_joint_graph(
        labelmap, labelmap.leaf_paths()[rng.randint(0, labelmap.levels[-1],
                                                    n_train)])
    img_edges = train_edges[train_edges[:, 1] >= nl]
    bank = rng.randint(0, 256, (64, image_size, image_size, 3),
                       dtype=np.uint8)
    cfg = JointCNNConfig(energy="hyp_cone", backbone="resnet50",
                         embedding_dim=EMB_DIM, image_size=image_size,
                         batch_size=batch, neg_to_pos_ratio=5, alpha=0.05,
                         pick_per_level=True, lr_labels=1e-2,
                         lr_images=1e-3, tower_dtype="bfloat16", seed=0,
                         device=DEV, **cfg_kw)
    trainer = JointCNNTrainer(labelmap, graph, img_edges[:10000],
                              lambda rows: bank[np.asarray(rows) % 64], cfg)
    edges = img_edges[rng.permutation(len(img_edges))]
    prepared = [trainer.prepare_batch(*edges[i * batch:(i + 1) * batch].T)
                for i in range(warmup + steps)]
    torch.cuda.synchronize()
    profiling.reset_counts()
    losses = [trainer.train_prepared(p)[0] for p in prepared[:warmup]]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses += [trainer.train_prepared(p)[0] for p in prepared[warmup:]]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = profiling.counts()
    losses = [float(l) for l in losses]
    n_steps = len(losses)
    per_step = {k: launches[k] / n_steps for k in ("bn_stats", "bn_corr")}
    if not all(map(math.isfinite, losses)) or \
            (per_step["bn_stats"], per_step["bn_corr"]) != want:
        raise AssertionError(f"zoo joint {tag}: losses {losses}, launches "
                             f"a step {per_step}, expected {want}")
    result = {"options": cfg_kw, "losses": losses, "launches": launches,
              "launches_per_step": per_step,
              "tower_rows_per_step": [int(p[0].shape[0]) for p in prepared],
              "ms_per_step": 1e3 * seconds / steps,
              "max_memory_allocated_gib":
                  torch.cuda.max_memory_allocated() / 2**30}
    log(f"[zoo] joint {tag} (hyp_cone, resnet50@{image_size}, {batch} "
        f"edges): {result['ms_per_step']:.2f} ms/step, peak "
        f"{result['max_memory_allocated_gib']:.2f} GiB, launches a step "
        f"{per_step}; losses {[round(l, 4) for l in losses]}")
    del trainer, prepared
    torch.cuda.empty_cache()
    return result


def zoo_cli_phase(image_size=448, batch=VGG_BATCH):
    """cli/ethec_experiments.py --model vgg11_bn --bn_stats_rows 8
    --bn_stats_dtype bfloat16 for one epoch on phase 10's records (batch
    64, 448²): 8 + 8 BN launches a train step, every K1 the rounding
    variant; then cli/image_emb.py --model alexnet on the same records
    (4096-wide features, no BN launch) and cli/oe_h.py on them without
    --use_CNN for one epoch (the fc7 path's default model: no BN, no K3
    with the hyperbolic energy)."""
    import numpy as np

    from learning_embeddings_tpu_torch.cli import (ethec_experiments,
                                                   image_emb, oe_h)

    root = os.path.join(EXPERIMENTS, "classifier_data")
    splits, images = (os.path.join(root, "splits"),
                      os.path.join(root, "images"))
    paths, out = {}, {}
    name = "cli_ethec_vgg11_bn_ghost8_bf16"
    res, seconds = _run_path(name, lambda: ethec_experiments.main(
        ["--data_dir", splits, "--image_dir", images, "--experiment_dir",
         EXPERIMENTS, "--experiment_name", name, "--model", "vgg11_bn",
         "--loss", "multi_level", "--image_size", str(image_size),
         "--batch_size", str(batch), "--lr", "1e-5", "--n_workers", "8",
         "--n_epochs",
         "1", "--set_mode", "train", "--bn_stats_rows", str(GHOST_ROWS),
         "--bn_stats_dtype", "bfloat16", "--device", DEV]), paths)
    launches, steps = paths[name], res["train_steps"]
    want = {"bn_stats": 8 * steps, "bn_stats_rounded": 8 * steps,
            "bn_corr": 8 * steps}
    if steps < 1 or {k: launches[k] for k in want} != want or \
            not all(map(math.isfinite, res["test_metrics"].values())):
        raise AssertionError(f"{name}: {steps} train steps, launches "
                             f"{launches} (expected {want}), test "
                             f"{res['test_metrics']}")
    tags = {r["tag"]: r["value"] for r in _jsonl(os.path.join(EXPERIMENTS,
                                                              name))}
    out[name] = {"seconds": seconds, "train_steps": steps,
                 "launches": launches, "test_metrics": res["test_metrics"],
                 **{k: tags[k] for k in (
                     "epoch_time", "epoch_time_train", "epoch_time_data_wait",
                     "epoch_time_eval", "epoch_time_checkpoint")}}
    log(f"[zoo] {name}: {seconds:.1f} s, {steps} train steps (8 + 8 BN "
        f"launches each, K1 bf16 x²), epoch {tags['epoch_time']:.2f} s "
        f"(train pass {tags['epoch_time_train']:.2f}, data wait "
        f"{tags['epoch_time_data_wait']:.2f}, eval "
        f"{tags['epoch_time_eval']:.2f}); test micro-F1 "
        f"{res['test_metrics']['micro_f1']:.4f}; launches {launches}")

    feats = os.path.join(EXPERIMENTS, "alexnet_emb")
    name = "cli_image_emb_alexnet"
    written, seconds = _run_path(name, lambda: image_emb.main(
        ["--data_dir", splits, "--image_dir", images, "--model", "alexnet",
         "--image_size", str(image_size), "--batch_size", "128",
         "--n_workers", "8",
         "--output_dir", feats, "--device", DEV]), paths)
    shapes = {}
    for split, path in written.items():
        with np.load(path) as z:
            f = z["features"]
            shapes[split] = f.shape
            if f.shape[1] != 4096 or not np.isfinite(f).all():
                raise AssertionError(f"{name} {split}: {f.shape}")
    if any(paths[name][k] for k in ("bn_stats", "bn_corr")):
        raise AssertionError(f"{name} launched {paths[name]}")
    out[name] = {"seconds": seconds, "shapes": shapes,
                 "launches": paths[name]}
    log(f"[zoo] {name}: {seconds:.1f} s, features {shapes}")

    name = "cli_oe_h_alexnet_fc7"
    res, seconds = _run_path(name, lambda: oe_h.main(
        ["--data_dir", splits, "--image_dir", images, "--features_dir",
         feats, "--set_mode", "train", "--n_epochs", "1",
         "--experiment_dir", EXPERIMENTS, "--experiment_name", name,
         "--device", DEV]), paths)
    tr = res["trainer"]
    finals = [res["reconstruction_f1"]] + list(res["test_metrics"].values())
    if tr.featnet.fc1.in_features != 4096 or any(paths[name].values()) or \
            not all(map(math.isfinite, finals)):
        raise AssertionError(f"{name}: {tr.featnet}, launches "
                             f"{paths[name]}, {res['test_metrics']}")
    out[name] = {"seconds": seconds, "launches": paths[name],
                 "test_metrics": res["test_metrics"],
                 "reconstruction_f1": res["reconstruction_f1"]}
    log(f"[zoo] {name}: {seconds:.1f} s, 4096-wide FeatNet, test edge F1 "
        f"{res['test_metrics']['edge_f1']:.4f}; launches {paths[name]}")
    return out, paths


def zoo_phase(labelmap, batch, conv7_peak_gib, image_size=448,
              vgg_batch=VGG_BATCH, small_size=64):
    """Phase 14: the small card-against-CPU steps, the ResNet-50@448 step
    under each ZOO_OPTIONS entry (with s2d's equivalence to conv7, remat's
    peak memory below the conv7 step's `conv7_peak_gib`, and a profile of
    the flax step: the library BatchNorm yardstick), VGG11BN@448 at batch
    64, the zoo CLIs and the joint step with remat and bf16 statistics.
    Returns (details, launches by path)."""
    import torch

    t_start = time.perf_counter()
    out = {"small": small_zoo_phase(small_size), "steps": {}}
    paths = {}
    out["s2d_equivalence"] = s2d_equivalence(labelmap,
                                             image_size=image_size)
    for name, (kw, n_stats, n_corr) in ZOO_OPTIONS.items():
        trainer, state, batch_t, res = zoo_step_phase(
            labelmap, name, kw, (n_stats, n_corr), batch,
            image_size=image_size)
        if name == "flax":
            prof = profile_phase(lambda: trainer.train_step(state, *batch_t),
                                 "zoo-flax")
            res["profile"] = prof
            res["profile_classes_ms"] = profile_classes(prof)
            log(f"[zoo] flax step by class (device ms): "
                f"{res['profile_classes_ms']}")
        out["steps"][name] = res
        paths["zoo_resnet50_" + name] = res["launches"]
        del trainer, state, batch_t
        torch.cuda.empty_cache()
    remat = out["steps"]["remat"]["memory_above_start_gib"]
    if not remat < conv7_peak_gib:
        raise AssertionError(f"remat's peak {remat:.2f} GiB is not below "
                             f"the conv7 step's {conv7_peak_gib:.2f} GiB")
    trainer, state, batch_t, res = zoo_step_phase(
        labelmap, "vgg11_bn", {}, (8, 8), vgg_batch, backbone="vgg11_bn",
        image_size=image_size)
    out["steps"]["vgg11_bn"] = res
    paths["zoo_vgg11_bn"] = res["launches"]
    del trainer, state, batch_t
    torch.cuda.empty_cache()
    out["cli"], cli_paths = zoo_cli_phase(image_size, vgg_batch)
    paths.update(cli_paths)
    torch.cuda.empty_cache()
    out["joint"] = {}
    for tag, kw, want in (("remat", dict(remat=True), (105, 53)),
                          ("bf16_stats", dict(bn_stats_dtype="bfloat16"),
                           (53, 53))):
        out["joint"][tag] = zoo_joint_step(labelmap, tag, kw, want,
                                           image_size=image_size)
        paths["zoo_joint_" + tag] = out["joint"][tag]["launches"]
    out["seconds"] = time.perf_counter() - t_start
    log(f"[zoo] phase 14 took {out['seconds']:.1f} s")
    return out, paths


# --------------------------------------------------------------------------
# the kernels line
# --------------------------------------------------------------------------
# --------------------------------------------------------------------------
# phase 15: multi-GPU (slice 10)
# --------------------------------------------------------------------------
MESH_PROGRAMS = "learning_embeddings_tpu_torch.parallel.programs:"
#: the classifier criteria, all five run on the (2, 2) mesh
MESH_CRITERIA = ("multi_level_ce", "last_level_ce", "masked_ce",
                 "multi_label_sm", "hsoftmax")


def _ranks(name, world, kw, backend="gloo", timeout_s=600):
    """``run_ranks`` of a ``parallel/programs.py`` function on the card, in
    a scratch directory removed after; a failed rank raises."""
    import tempfile

    import torch

    from learning_embeddings_tpu_torch.parallel.launch import run_ranks

    torch.cuda.empty_cache()      # the parent's cached blocks, for them
    work = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        return run_ranks(MESH_PROGRAMS + name, world, kw, workdir=work,
                         device=DEV, backend=backend, timeout_s=timeout_s)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


def mesh_slice_phase(labelmap, batch=128, steps=3, timed=3,
                     backbone="resnet50", image_size=448, n_data=2,
                     backend="gloo"):
    """(a) The classifier step at full width (ResNet-50@448, bf16 trunk,
    multi_level_ce, Adam 1e-5) on an (n_data, 1) mesh (by default two gloo
    ranks sharing the card, 64 rows each), against the one-process step at
    the same global batch from the same weights and batches."""
    from learning_embeddings_tpu_torch.parallel.programs import (
        classifier_run)
    from learning_embeddings_tpu_torch.train.classifier import (
        ClassifierConfig)

    cfg = ClassifierConfig(backbone=backbone, criterion="multi_level_ce",
                           lr=1e-5, image_size=image_size, batch_size=batch,
                           bn_impl="pallas", device=DEV)
    kw = dict(labelmap=labelmap, cfg=cfg, synthetic=(steps, 0),
              timed_steps=timed)
    n_bn = BACKBONE_BN_FEATURES[backbone][0]
    t = time.perf_counter()
    one = classifier_run(**kw)
    res = _ranks("classifier_steps", n_data, dict(
        n_data=n_data, n_model=1, device=DEV, **kw), backend=backend)
    mesh = f"{backend} ({n_data},1)"
    for rank, r in enumerate(res):
        worst = max(_rel(a, b) for a, b in zip(r["losses"], one["losses"]))
        if not worst <= 1e-2:
            raise AssertionError(f"{mesh} rank {rank}: losses "
                                 f"{r['losses']} against {one['losses']}")
        c = r["counts"]
        want = n_bn * steps
        got = (c["bn_stats"], c["bn_corr"], c["collective_bn_stats"],
               c["collective_bn_corr"])
        if got != (want,) * 4:
            raise AssertionError(f"{mesh} rank {rank}: K1, K2, BN "
                                 f"all-reduces {got}, expected {want} each")
        for k, v in r["running"].items():
            if not (v == res[0]["running"][k]).all():
                raise AssertionError(f"running statistic {k} differs "
                                     f"between the ranks")
    out = {"one_process": {k: one.get(k) for k in ("losses", "ms_per_step",
                                                   "peak_gib")},
           "ranks": [{k: r.get(k) for k in ("losses", "counts",
                                            "ms_per_step", "timed_step_ms",
                                            "collective_ms",
                                            "collective_share", "peak_gib")}
                     for r in res],
           "seconds": time.perf_counter() - t}
    log(f"[mesh] ResNet-50@448 batch {batch} on {mesh} ranks: "
        f"{[round(x['ms_per_step'], 2) for x in out['ranks']]} ms/step "
        f"against {one['ms_per_step']:.2f} in one process; losses "
        f"{res[0]['losses']} vs {one['losses']}; peak "
        f"{[x['peak_gib'] for x in out['ranks']]} GiB a rank; "
        f"collectives {[round(x['collective_share'], 3) for x in out['ranks']]}"
        f" of a step; {n_bn} + {n_bn} K1/K2 and BN all-reduces a rank a "
        f"step")
    return out


def mesh_joint_phase(labelmap, image_size=448, batch=16, n_train=2048,
                     steps=3, eval_rows=512, backbone="resnet50",
                     n_val=VAL_IMAGES):
    """(b) The BASELINE hyperbolic joint step (ResNet-50@448 tower, 16
    edges, ratio 5) on the (2, 1) mesh against one process (the first
    step's loss within 1e-2 relative), with its eval on the mesh (ranking
    and reconstruction through pairwise_energy_sharded) before and after
    the steps (before: embeddings within 5e-2 of max|·| and hit@1 within
    0.01 of one process); the first step again at a small lr_images
    (``mesh_joint_small_lr``); then the order eval's K3 tiles at M × 5286,
    D = 10, on (2, 1) and (1, 2) splits, gathered: equal to the
    one-process kernel bit for bit, one exact_d launch a rank."""
    import numpy as np
    import torch

    from learning_embeddings_tpu_torch.losses.joint_sampling import (
        build_joint_graph)
    from learning_embeddings_tpu_torch.ops import pairwise_order as k3
    from learning_embeddings_tpu_torch.parallel.programs import (
        joint_cnn_run)
    from learning_embeddings_tpu_torch.train.joint_cnn import JointCNNConfig

    t = time.perf_counter()
    nl = labelmap.n_classes
    rng = np.random.RandomState(0)
    graph, train_edges = build_joint_graph(
        labelmap, labelmap.leaf_paths()[rng.randint(0, labelmap.levels[-1],
                                                    n_train)])
    img_edges = train_edges[train_edges[:, 1] >= nl]
    bank = rng.randint(0, 256, (64, image_size, image_size, 3),
                       dtype=np.uint8)
    n_bn = BACKBONE_BN_FEATURES[backbone][0]
    cfg = JointCNNConfig(energy="hyp_cone", backbone=backbone,
                         embedding_dim=EMB_DIM, image_size=image_size,
                         batch_size=batch, neg_to_pos_ratio=5, alpha=0.05,
                         pick_per_level=True, lr_labels=1e-2,
                         lr_images=1e-3, tower_dtype="bfloat16", seed=0,
                         prefetch=False, device=DEV)
    edges = img_edges[rng.permutation(len(img_edges))]
    kw = dict(labelmap=labelmap, graph=graph, edges=img_edges[:10000],
              bank=bank, cfg=cfg,
              batches=[tuple(edges[i * batch:(i + 1) * batch].T)
                       for i in range(steps)],
              eval_rows=np.arange(eval_rows), eval_batch_size=128,
              timed_steps=3, eval_at_start=True)
    one = joint_cnn_run(**kw)
    res = _ranks("joint_cnn_steps", 2, dict(n_data=2, device=DEV, **kw))
    want = [s["loss"] for s in one["steps"]]
    for rank, r in enumerate(res):
        got = [s["loss"] for s in r["steps"]]
        # the first step from the same weights; later ones after Adam
        # steps in which a near-zero gradient's sign is rounding noise
        if not (_rel(got[0], want[0]) <= 1e-2
                and all(map(math.isfinite, got))):
            raise AssertionError(f"joint mesh rank {rank}: losses {got} "
                                 f"against {want}")
        c = r["counts"]
        if (c["bn_stats"], c["bn_corr"]) != (n_bn * steps, n_bn * steps):
            raise AssertionError(f"joint mesh rank {rank}: K1/K2 "
                                 f"{c['bn_stats']}/{c['bn_corr']}")
        if r["eval_counts"]["collective_pairwise_tiles"] != 2:
            raise AssertionError(f"joint mesh eval: {r['eval_counts']}")
        # the meshed eval on the start weights: embeddings within bf16
        # rounding of the one-process tower's (cuDNN picks its algorithms
        # per batch size), so at most 1% of the rank decisions flip
        emb, ref = r["start_eval_embeddings"], one["start_eval_embeddings"]
        err = float(np.abs(emb - ref).max() / np.abs(ref).max())
        if not (err <= 5e-2
                and abs(r["start_hit@1"] - one["start_hit@1"]) <= 1e-2):
            raise AssertionError(
                f"joint mesh eval at the start: embeddings within {err} "
                f"of max|·|, hit@1 {r['start_hit@1']} against "
                f"{one['start_hit@1']}")
        if not (np.isfinite(r["hit@1"]) and np.isfinite(
                r["reconstruction_f1"])):
            raise AssertionError("joint mesh eval: non-finite metrics")
    out = {"one_process": {"losses": want, "ms_per_step":
                           one["ms_per_step"], "hit@1": one["hit@1"],
                           "reconstruction_f1": one["reconstruction_f1"]},
           "start_eval": {"hit@1": one["start_hit@1"],
                          "ranks_hit@1": [r["start_hit@1"] for r in res],
                          "embedding_err": [float(
                              np.abs(r["start_eval_embeddings"]
                                     - one["start_eval_embeddings"]).max()
                              / np.abs(one["start_eval_embeddings"]).max())
                              for r in res]},
           "ranks": [{"losses": [s["loss"] for s in r["steps"]],
                      "counts": r["counts"], "eval_counts": r["eval_counts"],
                      "ms_per_step": r["ms_per_step"],
                      "peak_gib": r.get("peak_gib"), "hit@1": r["hit@1"],
                      "reconstruction_f1": r["reconstruction_f1"]}
                     for r in res]}
    log(f"[mesh] (b) hyperbolic joint step on (2,1): "
        f"{[round(x['ms_per_step'], 2) for x in out['ranks']]} ms/step "
        f"against {one['ms_per_step']:.2f}; losses "
        f"{out['ranks'][0]['losses']} vs {want}; eval hit@1 "
        f"{res[0]['hit@1']:.4f} (one process {one['hit@1']:.4f})")
    out["small_lr_step"] = {
        dtype: mesh_joint_small_lr(kw, dtype, min_agree=min_agree)
        for dtype, min_agree in (("bfloat16", None), ("float32", 0.95))}

    gen = torch.Generator(device=DEV).manual_seed(0)
    u = torch.randn((nl, EMB_DIM), device=DEV, generator=gen)
    v = torch.randn((n_val, EMB_DIM), device=DEV, generator=gen)
    whole = k3.pairwise_order(u, v).cpu().numpy()
    out["k3_tiles"] = {}
    for n_data, n_model in ((2, 1), (1, 2)):
        tiles = _ranks("pairwise_tiles", 2, dict(
            n_data=n_data, n_model=n_model, device=DEV, kind="order",
            u=u.cpu().numpy(), v=v.cpu().numpy()))
        for rank, r in enumerate(tiles):
            if not np.array_equal(r["E"], whole):
                raise AssertionError(
                    f"K3 tiles on ({n_data},{n_model}) rank {rank}: "
                    f"max |Δ| {np.abs(r['E'] - whole).max()}")
            if (r["counts"]["pairwise_order"],
                    r["counts"]["pairwise_order_exact_d"]) != (1, 1):
                raise AssertionError(f"K3 tiles: {r['counts']}")
        out["k3_tiles"][f"{n_data}x{n_model}"] = [r["counts"]
                                                  for r in tiles]
        log(f"[mesh] (b) K3 tiles {nl}×{n_val}, D = {EMB_DIM}, on "
            f"({n_data},{n_model}): gathered equal to the whole bit for "
            f"bit, 1 exact_d launch a rank")
    out["seconds"] = time.perf_counter() - t
    return out


def mesh_joint_small_lr(kw, tower_dtype, lr_images=1e-5, min_agree=None):
    """(b)'s first step again at `lr_images` (as phase 2's small joint
    steps) with the tower in `tower_dtype` (float32: TF32 off), then the
    eval, on the (2, 1) mesh and in one process: the tower and the label
    table after the step equal on both ranks bit for bit, the embeddings
    after the step within 5e-2 of max|·| and hit@1 within 0.01 of one
    process (the start eval's limits). Adam's first step moves each tower
    entry by about ±lr_images, so a tower gradient reduced wrongly shows
    as moves of the other sign: their share of agreement with one
    process's, over the entries one process moved by more than
    lr_images / 2, is reported, and held to `min_agree` where given. In
    bf16 the rounding of the two runs flips many small gradients' signs;
    in f32 a wrong reduction stands out (on the CPU at ResNet-18@32, 4
    edges: f32 1.0000, and 0.6781 with the tower gradient not summed back
    to each image's rank; bf16 0.8918 and 0.6605)."""
    import numpy as np
    import torch

    from learning_embeddings_tpu_torch.parallel.programs import (
        joint_cnn_run)

    full_f32 = tower_dtype == "float32"
    small = dict(kw, cfg=dataclasses.replace(
        kw["cfg"], lr_images=lr_images, tower_dtype=tower_dtype),
        batches=kw["batches"][:1], timed_steps=0, eval_at_start=False)
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    if full_f32:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    try:
        start = joint_cnn_run(**dict(small, batches=(), eval_rows=None))
        one = joint_cnn_run(**small)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev
    res = _ranks("joint_cnn_steps", 2, dict(n_data=2, device=DEV,
                                            full_f32=full_f32, **small))
    for part in ("images", "labels"):
        for k, v in res[0][part].items():
            if not np.array_equal(v, res[1][part][k]):
                raise AssertionError(f"joint mesh, {tower_dtype} tower: "
                                     f"{part} {k} differs between the ranks")
    moved = agree = 0
    for k, p0 in start["images"].items():
        if "running_" in k:
            continue
        ref = one["images"][k] - p0
        got = res[0]["images"][k] - p0
        m = np.abs(ref) > lr_images / 2
        moved += int(m.sum())
        agree += int((np.sign(got[m]) == np.sign(ref[m])).sum())
    share = agree / max(moved, 1)
    emb, ref = res[0]["eval_embeddings"], one["eval_embeddings"]
    err = float(np.abs(emb - ref).max() / np.abs(ref).max())
    out = {"tower_dtype": tower_dtype, "lr_images": lr_images,
           "loss": res[0]["steps"][0]["loss"],
           "one_process_loss": one["steps"][0]["loss"],
           "entries_moved": moved, "sign_agreement": share,
           "min_agree": min_agree, "embedding_err": err,
           "hit@1": res[0]["hit@1"], "one_process_hit@1": one["hit@1"],
           "reconstruction_f1": res[0]["reconstruction_f1"],
           "one_process_reconstruction_f1": one["reconstruction_f1"]}
    log(f"[mesh] (b) one step at lr_images {lr_images}, {tower_dtype} "
        f"tower: moves of one process's sign on {share:.4f} of {moved} "
        f"entries (limit {min_agree}); embeddings within {err:.3g} of "
        f"max|·|; hit@1 {out['hit@1']:.4f} against "
        f"{out['one_process_hit@1']:.4f}")
    if not ((min_agree is None or share >= min_agree) and err <= 5e-2
            and abs(out["hit@1"] - out["one_process_hit@1"]) <= 1e-2):
        raise AssertionError(f"joint mesh after one step at lr_images "
                             f"{lr_images}: {out}")
    return out


def mesh_tp_phase(labelmaps, image_size=64, batch=8):
    """(c) A (2, 2) mesh of four ranks, f32 ResNet-18@64, every criterion
    on each taxonomy (Butterfly200's 344: the head column-parallel; an odd
    count: row-parallel; masked_ce's gradients summed), against one
    process: the logits within 1e-5 of max|logit|, the losses within 1e-5
    relative."""
    import numpy as np
    import torch

    from learning_embeddings_tpu_torch.parallel.programs import (
        classifier_run, synthetic_batches)
    from learning_embeddings_tpu_torch.train.classifier import (
        ClassifierConfig)

    t = time.perf_counter()
    cases = []
    for lm in labelmaps:
        for crit in MESH_CRITERIA:
            cfg = ClassifierConfig(backbone="resnet18", criterion=crit,
                                   lr=1e-3, image_size=image_size,
                                   batch_size=batch, dtype=torch.float32,
                                   device=DEV)
            cases.append(dict(labelmap=lm, cfg=cfg, synthetic=(1, 0),
                              eval_batch=synthetic_batches(
                                  lm, 1, batch, image_size, 1)[0]))
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False   # full f32 for this check
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        one = [classifier_run(**kw) for kw in cases]
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev
    res = _ranks("classifier_cases", 4, dict(n_data=2, n_model=2,
                                             cases=cases, device=DEV,
                                             full_f32=True))
    worst = worst_loss = 0.0
    forms = {}
    for i, kw in enumerate(cases):
        ref = one[i]
        scale = float(np.abs(ref["eval_scores"]).max())
        for rank, r in enumerate(res):
            got = r[i]
            err = float(np.abs(got["eval_scores"]
                               - ref["eval_scores"]).max())
            loss_err = max(_rel(got["eval_loss"], ref["eval_loss"]),
                           _rel(got["losses"][0], ref["losses"][0]))
            worst = max(worst, err / scale)
            worst_loss = max(worst_loss, loss_err)
            if err > 1e-5 * scale or loss_err > 1e-5:
                raise AssertionError(
                    f"(2,2) {kw['cfg'].criterion} on "
                    f"{kw['labelmap'].n_classes} classes rank {rank}: "
                    f"logits |Δ| {err:.3e} (limit 1e-5 of max|logit| "
                    f"{scale:.3e}), losses {loss_err:.3e} relative "
                    f"(limit 1e-5)")
        c = res[0][i]["counts"]
        forms[f"{kw['cfg'].criterion}/{kw['labelmap'].n_classes}"] = (
            "column" if c.get("collective_gather_cols") else
            "row" if c.get("collective_reduce_from_group") else "replicated")
    log(f"[mesh] (c) (2,2) ResNet-18@{image_size} f32, {len(cases)} cases: "
        f"logits within {worst:.2e} of max|logit|, losses within "
        f"{worst_loss:.2e} relative (limits 1e-5); head forms {forms}")
    return {"worst_logit_rel": worst, "worst_loss_rel": worst_loss,
            "head_forms": forms,
            "counts_rank0": [r["counts"] for r in res[0]],
            "seconds": time.perf_counter() - t}


def mesh_nccl_phase(labelmap, batch=8, backbone="resnet50",
                    image_size=448):
    """(d) An NCCL group over every card of the machine: (a)'s step at a
    small batch, then an all_reduce over the group of known values; on a
    machine of several cards also (a) itself over them, one rank a
    card."""
    import numpy as np
    import torch

    from learning_embeddings_tpu_torch.train.classifier import (
        ClassifierConfig)

    t = time.perf_counter()
    n = torch.cuda.device_count()
    cfg = ClassifierConfig(backbone=backbone, criterion="multi_level_ce",
                           lr=1e-5, image_size=image_size,
                           batch_size=batch * n,
                           bn_impl="pallas", device=DEV)
    res = _ranks("nccl_check", n, dict(labelmap=labelmap, cfg=cfg,
                                       synthetic=(2, 0)),
                 backend="nccl")
    for r in res:
        if r["backend"] != "nccl" or r["world"] != n:
            raise AssertionError(f"NCCL group: {r['backend']}, {r['world']}")
        if not np.array_equal(r["reduced"], np.full(4, n * (n + 1) / 2)):
            raise AssertionError(f"NCCL all_reduce gave {r['reduced']}")
        if not all(map(math.isfinite, r["losses"])):
            raise AssertionError(f"NCCL step losses {r['losses']}")
    log(f"[mesh] (d) NCCL group of {n} rank(s): started, reduced, losses "
        f"{res[0]['losses']}")
    out = {"world": n, "losses": res[0]["losses"],
           "counts": res[0]["counts"]}
    if n >= 2:
        out["cards"] = mesh_slice_phase(labelmap, batch=128 // n * n,
                                        n_data=n, backend="nccl")
    out["seconds"] = time.perf_counter() - t
    return out


def mesh_dryrun_phase(n=4):
    """(e) The twin of the JAX package's dryrun_multichip on the card."""
    from learning_embeddings_tpu_torch.entry import dryrun_multichip

    import torch

    t = time.perf_counter()
    torch.cuda.empty_cache()
    summary = dryrun_multichip(n, device=DEV)
    # the spatial stage on (n/2, 2): two micro-steps of ResNet-18@64, each
    # 18 forward and 17 backward halo exchanges a rank
    if (summary.get("ok") is not True
            or not math.isfinite(summary["spatial_grad_accum"])
            or summary["spatial_halos"] != {"halo": 36, "halo_grad": 34}):
        raise AssertionError(f"dryrun_multichip: {summary}")
    return {"summary": summary, "seconds": time.perf_counter() - t}


def mesh_spatial_phase(labelmap, one, batch=128, steps=3, timed=3,
                       backbone="resnet50", image_size=448):
    """(f) Spatial partitioning: the images' H over the 'model' axis of a
    (1, 2) gloo mesh of two ranks sharing the card, every layer of the
    ResNet-50@448 trunk H-sharded with halo exchanges. The bf16 step at
    batch 128 (multi_level_ce, Adam 1e-5) against `one`, (a)'s one-process
    step from the same weights and batches: losses within 1e-2 relative,
    53 + 53 K1/K2 launches a rank a step, the halo exchanges a step that
    ``spatial_halo_counts`` predicts, no channels_last copy, running
    statistics equal on both ranks bit for bit, peak memory a rank at most
    0.6 of one process's; ms/step and the collectives' share by tag. Then
    the f32 ResNet-18@64 step (TF32 off, batch 8): loss, eval loss and
    eval scores within 1e-5 of one process; and
    cli/ethec_experiments.py --spatial_partition --n_model 2 in the two
    ranks on 64/32/32 of phase 10's records (ResNet-50@448, batch 32)."""
    import numpy as np
    import torch

    from learning_embeddings_tpu_torch import data
    from learning_embeddings_tpu_torch.models.resnet import (
        make_trunk, spatial_halo_counts)
    from learning_embeddings_tpu_torch.parallel.programs import (
        classifier_run, synthetic_batches)
    from learning_embeddings_tpu_torch.train.classifier import (
        ClassifierConfig)

    t = time.perf_counter()
    cfg = ClassifierConfig(backbone=backbone, criterion="multi_level_ce",
                           lr=1e-5, image_size=image_size, batch_size=batch,
                           bn_impl="pallas", spatial_partition=True,
                           device=DEV)
    res = _ranks("classifier_steps", 2, dict(
        n_data=1, n_model=2, device=DEV, labelmap=labelmap, cfg=cfg,
        synthetic=(steps, 0), timed_steps=timed))
    n_bn = BACKBONE_BN_FEATURES[backbone][0]
    halos = spatial_halo_counts(make_trunk(backbone), image_size, 2)
    want = {"bn_stats": n_bn * steps, "bn_corr": n_bn * steps,
            "collective_halo": halos["halo"] * steps,
            "collective_halo_grad": halos["halo_grad"] * steps,
            "channels_last_copies": 0}
    for rank, r in enumerate(res):
        worst = max(_rel(a, b) for a, b in zip(r["losses"], one["losses"]))
        if not worst <= 1e-2:
            raise AssertionError(f"spatial (1,2) rank {rank}: losses "
                                 f"{r['losses']} against {one['losses']}")
        got = {k: r["counts"].get(k, 0) for k in want}
        if got != want:
            raise AssertionError(f"spatial (1,2) rank {rank}: {got}, "
                                 f"expected {want}")
        for k, v in r["running"].items():
            if not (v == res[0]["running"][k]).all():
                raise AssertionError(f"running statistic {k} differs "
                                     f"between the spatial ranks")
        if not r["peak_gib"] <= 0.6 * one["peak_gib"]:
            raise AssertionError(f"spatial (1,2) rank {rank}: peak "
                                 f"{r['peak_gib']:.2f} GiB against "
                                 f"{one['peak_gib']:.2f} in one process")
    out = {"halos_predicted": halos,
           "ranks": [{k: r.get(k) for k in ("losses", "counts",
                                            "ms_per_step", "timed_step_ms",
                                            "collective_ms",
                                            "collective_share", "peak_gib")}
                     for r in res]}
    log(f"[mesh] (f) spatial {backbone}@{image_size} batch {batch} on (1,2) "
        f"gloo ranks: {[round(x['ms_per_step'], 2) for x in out['ranks']]} "
        f"ms/step against {one['ms_per_step']:.2f} in one process; losses "
        f"{res[0]['losses']} vs {one['losses']}; peak "
        f"{[round(x['peak_gib'], 2) for x in out['ranks']]} GiB a rank "
        f"against {one['peak_gib']:.2f}; {n_bn} + {n_bn} K1/K2 and "
        f"{halos['halo']} + {halos['halo_grad']} halo exchanges a rank a "
        f"step; collectives "
        f"{[round(x['collective_share'], 3) for x in out['ranks']]} of a "
        f"step: {res[0]['collective_ms']} ms")

    # the f32 step at a small size, TF32 off
    small = ClassifierConfig(backbone="resnet18", criterion="multi_level_ce",
                             lr=1e-3, image_size=64, batch_size=8,
                             dtype=torch.float32, spatial_partition=True,
                             device=DEV)
    kw = dict(labelmap=labelmap, cfg=small, synthetic=(1, 0),
              eval_batch=synthetic_batches(labelmap, 1, 8, 64, 1)[0])
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ref = classifier_run(**kw)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev
    res32 = _ranks("classifier_cases", 2, dict(
        n_data=1, n_model=2, cases=[kw], device=DEV, full_f32=True))
    scale = float(np.abs(ref["eval_scores"]).max())
    small_halos = spatial_halo_counts(make_trunk("resnet18"), 64, 2)
    worst = 0.0
    for rank, (r,) in enumerate(res32):
        err = float(np.abs(r["eval_scores"] - ref["eval_scores"]).max())
        loss_err = max(_rel(r["losses"][0], ref["losses"][0]),
                       _rel(r["eval_loss"], ref["eval_loss"]))
        worst = max(worst, loss_err, err / scale)
        c = r["counts"]
        if (loss_err > 1e-5 or err > 1e-5 * scale
                or (c["bn_stats"], c["bn_corr"]) != (20, 20)
                or (c["collective_halo"], c["collective_halo_grad"])
                != (small_halos["halo"], small_halos["halo_grad"])):
            raise AssertionError(
                f"spatial f32 (1,2) rank {rank}: losses {r['losses']} / "
                f"{r['eval_loss']} against {ref['losses']} / "
                f"{ref['eval_loss']}, scores |Δ| {err:.3e} of {scale:.3e}, "
                f"counts {c}")
    out["f32"] = {"worst_rel": worst, "losses": res32[0][0]["losses"],
                  "one_process_losses": ref["losses"],
                  "counts": [r[0]["counts"] for r in res32]}
    log(f"[mesh] (f) spatial f32 ResNet-18@64 on (1,2): loss, eval loss "
        f"and scores within {worst:.2e} of one process (limit 1e-5)")

    # the CLI in the two ranks, on a cut of phase 10's records
    root = os.path.join(EXPERIMENTS, "classifier_data")
    cut = os.path.join(EXPERIMENTS, "spatial_splits")
    os.makedirs(cut, exist_ok=True)
    for split, n in (("train", 64), ("val", 32), ("test", 32)):
        recs = data.load_ethec_json(os.path.join(root, "splits",
                                                 f"{split}.json"))
        data.save_ethec_json(list(recs)[:n], os.path.join(cut,
                                                          f"{split}.json"))
    argv = ["--data_dir", cut, "--image_dir", os.path.join(root, "images"),
            "--experiment_dir", EXPERIMENTS, "--experiment_name",
            "spatial_cli", "--model", backbone, "--loss", "multi_level",
            "--image_size", str(image_size), "--batch_size", "32", "--lr",
            "1e-5", "--n_workers", "4", "--n_epochs", "1", "--set_mode",
            "train", "--spatial_partition", "--n_model", "2", "--device",
            DEV]
    t_cli = time.perf_counter()
    cli = _ranks("cli_main", 2, dict(
        module="learning_embeddings_tpu_torch.cli.ethec_experiments",
        argv=argv, keep=("best_epoch", "train_steps", "test_metrics"),
        jsonl_only=True, with_counts=True))
    steps_cli = cli[0]["train_steps"]
    for rank, r in enumerate(cli):
        c = r["counts"]
        if (steps_cli < 1 or r["train_steps"] != steps_cli
                or (c["bn_stats"], c["bn_corr"])
                != (n_bn * steps_cli, n_bn * steps_cli)
                or c["collective_halo_grad"]
                != halos["halo_grad"] * steps_cli
                or not all(map(math.isfinite, r["test_metrics"].values()))):
            raise AssertionError(f"spatial CLI rank {rank}: {r}")
    out["cli"] = {"seconds": time.perf_counter() - t_cli,
                  "train_steps": steps_cli,
                  "test_metrics": cli[0]["test_metrics"],
                  "counts": [r["counts"] for r in cli]}
    log(f"[mesh] (f) cli/ethec_experiments.py --spatial_partition --n_model "
        f"2 in two ranks: {steps_cli} train steps, {out['cli']['seconds']:.1f}"
        f" s, test micro-F1 {cli[0]['test_metrics']['micro_f1']:.4f}")
    out["seconds"] = time.perf_counter() - t
    log(f"[mesh] (f) took {out['seconds']:.1f} s")
    return out


def mesh_phase(labelmap):
    """Phase 15: (a)-(f); returns the records and the launches of each
    mesh path, rank by rank."""
    from learning_embeddings_tpu_torch.hierarchy import toy_labelmap

    t = time.perf_counter()
    out = {"slice": mesh_slice_phase(labelmap)}
    out["joint"] = mesh_joint_phase(labelmap)
    out["tp"] = mesh_tp_phase([labelmap, toy_labelmap(3, 3)])
    out["nccl"] = mesh_nccl_phase(labelmap)
    out["dryrun"] = mesh_dryrun_phase()
    out["spatial"] = mesh_spatial_phase(labelmap, out["slice"]["one_process"])
    out["seconds"] = time.perf_counter() - t
    log(f"[mesh] phase took {out['seconds']:.1f} s")
    paths = {}
    for rank, r in enumerate(out["slice"]["ranks"]):
        paths[f"mesh_classifier_2x1_rank{rank}"] = r["counts"]
    for rank, r in enumerate(out["joint"]["ranks"]):
        paths[f"mesh_joint_hyp_2x1_rank{rank}"] = r["counts"]
        paths[f"mesh_joint_eval_2x1_rank{rank}"] = r["eval_counts"]
    for split, counts in out["joint"]["k3_tiles"].items():
        for rank, c in enumerate(counts):
            paths[f"mesh_k3_tiles_{split}_rank{rank}"] = c
    paths["mesh_nccl_rank0"] = out["nccl"]["counts"]
    for rank, r in enumerate(out["spatial"]["ranks"]):
        paths[f"mesh_spatial_1x2_rank{rank}"] = r["counts"]
    for rank, c in enumerate(out["spatial"]["f32"]["counts"]):
        paths[f"mesh_spatial_f32_1x2_rank{rank}"] = c
    for rank, c in enumerate(out["spatial"]["cli"]["counts"]):
        paths[f"mesh_spatial_cli_1x2_rank{rank}"] = c
    return out, paths


def kernel_line(bn_rows, k3_result, slice_result, joint_result, prof,
                eval_prof, hyp_result, label_results, cli_paths, r18_rows,
                zoo_rows, mesh_rows, wa_result):
    """One record per kernel. BN kernels: one classifier step's 53
    launches at its shapes; pairwise_order: one joint eval's calls at its
    shapes through the route the wrapper takes (exact_d at D = 10), with
    generic_ms the generic kernel on the same inputs, by_shape both at
    every timed shape, and in_eval_profiler_ms its time inside the
    profiled val ranking call. `launches` counts each kernel's launches
    in the run of the path that drives it (the classifier path for the
    BN kernels, the joint path for pairwise_order; launches_by_route
    splits the latter by route); launches_by_path gives every kernel's
    count on every path, each counted from 0 over that path's run (the
    CLIs and runner runs of slices 5 and 6 and the fc7 runs of slice 7
    among them, with pairwise_order's exact_d count beside its total).
    The BN records also hold K1/K2 at ResNet-18@224's 20 shapes (batch 8,
    the CIFAR / FashionMNIST CLIs' step: `resnet18_224_b8`) and at
    VGG11BN@448's 8 (batch 64: `vgg11_bn_448_b64`), K1 at the ghost
    route's prefixes of ResNet-50@448 (8 rows: `ghost_prefix_r50_448_rows8`)
    and K1's bf16-rounding variant at ResNet-50@448's 12 shapes with its
    launches by path (`bf16_square_variant`), and the sums over the shapes
    of each mesh table of phase 2 (`mesh_shapes`, the spatial ones among
    them, each image's H halved); all their errors count in
    max_abs_err."""
    paths = {"classifier": slice_result["launches"],
             "joint_order": joint_result["launches"],
             "joint_hyp_cone": hyp_result["launches"]}
    paths.update({"label_only_" + k: v["launches"]
                  for k, v in label_results.items()})
    paths.update(cli_paths)

    def by_path(name):
        return {p: c.get(name, 0) for p, c in paths.items()}

    def summed(rows, k):
        return sum(r[k] * r["layers"] for r in rows)

    def shape_rows(rows):
        return [{k: r[k] for k in ("R", "C", "layers", "max_abs_err", "ms",
                                   "plain_ms", "library_ms", "bound_ms")}
                for r in rows]

    vgg = zoo_rows["vgg11_bn_448_b64"]
    ghost = zoo_rows["ghost_prefix_r50_448_rows8"]
    bf16sq = zoo_rows["bf16_square_r50_448"]
    kernels = []
    for name in ("bn_stats", "bn_corr"):
        tot = {k: sum(r[name][k] * r["layers"] for r in bn_rows)
               for k in ("ms", "eager_ms", "plain_ms", "library_ms",
                         "bound_ms")}
        zoo_err = [r[name]["max_abs_err"] for r in vgg] + (
            [r["max_abs_err"] for r in ghost + bf16sq]
            if name == "bn_stats" else []) + [
            r[name]["max_abs_err"] for rows in mesh_rows.values()
            for r in rows]
        kernels.append({
            "name": name, "route": "triton", "source": KERNEL_SRC[name],
            "replaces": TPU_KERNELS[name],
            "launches": slice_result["launches"][name],
            "max_abs_err": max([r[name]["max_abs_err"]
                                for r in bn_rows + r18_rows] + zoo_err),
            "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"], "bound_by": "bytes",
            "library_ms": tot["library_ms"], "eager_ms": tot["eager_ms"],
            "in_step_profiler_ms": (prof["kernels"][name]["ms"]
                                    if prof["kernels"][name] else None),
            "launches_joint_path": joint_result["launches"][name],
            "launches_by_path": by_path(name),
            "resnet18_224_b8": [
                {"R": r["R"], "C": r["C"], "layers": r["layers"],
                 **{k: r[name][k] for k in ("max_abs_err", "ms", "plain_ms",
                                            "library_ms", "bound_ms")}}
                for r in r18_rows],
            "vgg11_bn_448_b64": [
                {"R": r["R"], "C": r["C"], "layers": r["layers"],
                 **{k: r[name][k] for k in ("max_abs_err", "ms", "plain_ms",
                                            "library_ms", "bound_ms")}}
                for r in vgg],
            "mesh_shapes": {
                table: {**{k: sum(r[name][k] * r["layers"] for r in rows)
                           for k in ("ms", "plain_ms", "library_ms",
                                     "bound_ms")},
                        "max_abs_err": max(r[name]["max_abs_err"]
                                           for r in rows)}
                for table, rows in mesh_rows.items()},
        })
        if name == "bn_stats":
            kernels[-1]["ghost_prefix_r50_448_rows8"] = {
                **{k: summed(ghost, k) for k in ("ms", "plain_ms",
                                                 "library_ms", "bound_ms")},
                "shapes": shape_rows(ghost)}
            kernels[-1]["bf16_square_variant"] = {
                **{k: summed(bf16sq, k) for k in ("ms", "plain_ms",
                                                  "bound_ms")},
                "library_ms": None, "bound_by": "bytes",
                "max_abs_err": max(r["max_abs_err"] for r in bf16sq),
                "launches_by_path": by_path("bn_stats_rounded"),
                "shapes": shape_rows(bf16sq)}
    tot = {k: sum(r["bn_dx"][k] * r["layers"] for r in bn_rows)
           for k in ("ms", "eager_ms", "plain_ms", "library_ms", "bound_ms")}
    kernels.append({
        "name": "bn_dx", "route": "triton", "source": KERNEL_SRC["bn_dx"],
        "replaces": TPU_KERNELS["bn_dx"],
        "replaces_note": "no TPU kernel: the JAX package leaves dx to XLA",
        "launches": slice_result["launches"]["bn_dx"],
        "max_abs_err": max(r["bn_dx"]["max_abs_err"]
                           for rows in [bn_rows, r18_rows, vgg]
                           + list(mesh_rows.values()) for r in rows),
        **tot, "bound_by": "bytes",
        "library_note": "torch.batch_norm_backward_elemt, a yardstick the "
                        "port never calls",
        "launches_by_path": by_path("bn_dx"),
        "shapes": [{"R": r["R"], "C": r["C"], "layers": r["layers"],
                    **{k: r["bn_dx"][k] for k in (
                        "max_abs_err", "ms", "plain_ms", "library_ms",
                        "bound_ms")}} for r in bn_rows],
    })
    tot = {k: sum(r["bn_act"][k] * r["layers"] for r in bn_rows)
           for k in ("ms", "eager_ms", "plain_ms", "bound_ms")}
    kernels.append({
        "name": "bn_act", "route": "triton", "source": KERNEL_SRC["bn_act"],
        "replaces": TPU_KERNELS["bn_act"],
        "replaces_note": "no TPU kernel: the JAX package leaves the "
                         "normalisation, ReLU and residual add to XLA",
        "launches": slice_result["launches"]["bn_act"],
        "max_abs_err": max(r["bn_act"]["max_abs_err"]
                           for rows in [bn_rows, r18_rows, vgg]
                           + list(mesh_rows.values()) for r in rows),
        **tot, "library_ms": None, "bound_by": "bytes",
        "library_note": "no PyTorch call applies the BatchNorm with the "
                        "residual add and ReLU",
        "launches_by_path": by_path("bn_act"),
        "shapes": [{"R": r["R"], "C": r["C"], "layers": r["layers"],
                    **{k: r["bn_act"][k] for k in (
                        "max_abs_err", "residual_layers", "ms",
                        "residual_ms", "plain_ms", "residual_plain_ms",
                        "bound_ms")}} for r in bn_rows],
    })
    path = [r for r in k3_result["shapes"] if r["on_path"]]
    tot = {k: sum(r[k] for r in path)
           for k in ("ms", "generic_ms", "eager_ms", "plain_ms", "bound_ms")}
    by = {r["bound_by"] for r in path}
    kernels.append({
        "name": "pairwise_order", "route": "cuda",
        "source": KERNEL_SRC["pairwise_order"],
        "replaces": TPU_KERNELS["pairwise_order"],
        "launches": joint_result["launches"]["pairwise_order"],
        "launches_by_route": {
            r: joint_result["launches"]["pairwise_order_" + r]
            for r in ("exact_d", "generic")},
        "launches_by_path": by_path("pairwise_order"),
        "exact_d_launches_by_path": by_path("pairwise_order_exact_d"),
        "generic_ms": tot["generic_ms"],
        "max_abs_err": max([r["max_abs_err"] for r in k3_result["shapes"]]
                           + [joint_result["eval_energy_max_abs_err"]]
                           + [v["reconstruction_max_abs_err"]
                              for v in label_results.values()
                              if v["reconstruction_max_abs_err"]
                              is not None]),
        "ms": tot["ms"], "plain_ms": tot["plain_ms"],
        "bound_ms": tot["bound_ms"],
        "bound_by": by.pop() if len(by) == 1 else "bytes",
        "library_ms": None,
        "library_note": "no PyTorch call computes the one-sided hinge "
                        "sum (torch.cdist is a symmetric p-norm)",
        "eager_ms": tot["eager_ms"],
        "shapes": [[r["M"], r["N"], r["D"]] for r in path],
        "by_shape": [{k: r[k] for k in ("M", "N", "D", "route", "ms",
                                        "generic_ms", "bound_ms")}
                     for r in k3_result["shapes"] if "ms" in r],
        "in_eval_profiler_ms": (eval_prof["kernels"]["pairwise_order"]
                                ["ms"] if eval_prof["kernels"]
                                ["pairwise_order"] else None),
    })
    kernels.append(window_attention_record(wa_result, by_path))
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
    build = start_cuda_build()
    torch.backends.cudnn.benchmark = True
    labelmap = ethec_labelmap()

    t = time.perf_counter()
    bn_rows = kernels_phase(args.batch)
    zoo_rows = zoo_kernels_phase(args.batch)
    mesh_rows = mesh_kernels_phase()
    k3_result = k3_phase(build, labelmap.n_classes)
    wa_result = window_attention_phase(labelmap)
    bn_train_phase()
    small_step_phase(toy_labelmap(3, 3))
    small_joint_phase()
    small_hyp = small_hyp_joint_phase()
    log(f"[kernels] phase took {time.perf_counter() - t:.1f} s "
        f"(kernel builds included)")

    trainer, state, batch_t, result = slice_phase(labelmap, args.batch)
    prof = profile_phase(
        lambda: trainer.train_step(state, *batch_t), "measure")
    prof["classes_ms"] = profile_classes(prof)
    log(f"[measure] the conv7 step by class (device ms): "
        f"{prof['classes_ms']}")
    del trainer, state, batch_t
    torch.cuda.empty_cache()

    jtrainer, jbatch, (val_paths, val_emb), joint = joint_phase(labelmap)
    jprof = profile_phase(lambda: jtrainer.train_prepared(jbatch), "joint")
    eprof = profile_phase(
        lambda: jtrainer.classification_metrics(val_paths, val_emb), "eval")
    del jtrainer, jbatch
    torch.cuda.empty_cache()

    htrainer, hbatch, _, hyp = joint_phase(labelmap, energy="hyp_cone",
                                           tag="hypjoint")
    hprof = profile_phase(lambda: htrainer.train_prepared(hbatch),
                          "hypjoint")
    del htrainer, hbatch
    torch.cuda.empty_cache()

    label = label_only_phase(labelmap)

    shutil.rmtree(EXPERIMENTS, ignore_errors=True)
    try:
        cli, cli_paths, warm = label_cli_phase()
        runner, runner_paths = joint_runner_phase(warm)
        cli_paths.update(runner_paths)
        torch.cuda.empty_cache()
        oe_h_cli, oe_h_paths = oe_h_cli_phase()
        cli_paths.update(oe_h_paths)
        torch.cuda.empty_cache()
        classifier_cli, classifier_paths = classifier_cli_phase(labelmap)
        cli_paths.update(classifier_paths)
        torch.cuda.empty_cache()
        t = time.perf_counter()
        fc7 = {"small": fc7_small_phase()}
        ftrainer, fc7["step"] = fc7_step_phase(labelmap)
        cli_paths["fc7_step"] = fc7["step"]["launches"]
        del ftrainer
        torch.cuda.empty_cache()
        fc7["epochs"], fc7_paths = fc7_epoch_phase(labelmap)
        cli_paths.update(fc7_paths)
        fc7["runner"], fc7_paths = fc7_runner_phase(warm)
        cli_paths.update(fc7_paths)
        fc7["cli"], fc7_paths = fc7_cli_phase()
        cli_paths.update(fc7_paths)
        fc7["seconds"] = time.perf_counter() - t
        log(f"[fc7] phase took {fc7['seconds']:.1f} s")
        t = time.perf_counter()
        inference_result, inference_paths = inference_phase()
        cli_paths.update(inference_paths)
        torch.cuda.empty_cache()
        other, other_paths, r18_rows = other_datasets_phase()
        cli_paths.update(other_paths)
        log(f"[datasets] phases 12-13 took {time.perf_counter() - t:.1f} s")
        torch.cuda.empty_cache()
        zoo, zoo_paths = zoo_phase(labelmap, args.batch,
                                   result["max_memory_allocated_gib"])
        cli_paths.update(zoo_paths)
        torch.cuda.empty_cache()
        mesh, mesh_paths = mesh_phase(labelmap)
        cli_paths.update(mesh_paths)
    finally:
        shutil.rmtree(EXPERIMENTS, ignore_errors=True)
    kernels = kernel_line(bn_rows, k3_result, result, joint, prof, eprof,
                          hyp, label, cli_paths, r18_rows, zoo_rows,
                          mesh_rows, wa_result)

    details = {"nvidia_smi": smi, "torch": torch.__version__,
               "cuda": torch.version.cuda, "slice": result,
               "profile": prof, "joint": joint, "joint_profile": jprof,
               "eval_profile": eprof, "small_hyp_joint": small_hyp,
               "hyp_joint": hyp, "hyp_joint_profile": hprof,
               "label_only": label, "label_cli": cli,
               "joint_runner": runner, "oe_h_cli": oe_h_cli,
               "classifier_cli": classifier_cli, "fc7": fc7,
               "inference": inference_result, "other_datasets": other,
               "zoo": zoo, "zoo_kernel_shapes": zoo_rows, "mesh": mesh,
               "mesh_kernel_shapes": mesh_rows,
               "cli_launches": cli_paths,
               "kernel_shapes": bn_rows, "pairwise_order": k3_result,
               "window_attention": wa_result,
               "kernels": kernels,
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
