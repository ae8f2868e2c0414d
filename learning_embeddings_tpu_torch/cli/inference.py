"""Inference / interpretability harness: the port of
``learning_embeddings_tpu/cli/inference.py`` (the reference's
network/inference.py:42-372), on ``--device`` (default cuda):

* rebuilds a trained classifier experiment from its ``config_params.txt``
  manifest: the head it trained (``use_2d`` → bottleneck2d, ``loss`` →
  the criterion's head), grayscale input, and the weights and BN running
  statistics of ``best_model`` (else the latest numbered checkpoint),
  loaded strictly; never the optimizer state, so a run trained with any
  optimizer loads;
* ``--mode tsne``: the pooled trunk features per split
  (``{split}_representations.npy`` and ``{split}_level_labels.npy``, the
  forward-hook dump of inference.py:206-246) and a 3-D t-SNE per level;
* ``--mode lime``: per-sample × per-level LIME explanations
  (inference.py:248-362; ``viz/lime.py``): hide_color 0, 100
  perturbations, top-5 labels × top-10 segments, a markdown table with
  green/red predicted labels;
* ``--mode occlusion``: a gray patch slid over the image and the drop of
  the ground truth's score per level.

The model runs in eval mode (BatchNorm on its running statistics, so no
BN kernel runs) under ``torch.inference_mode``. The work on the device
sits in functions that need no matplotlib: ``logits_fn``,
``lime_predict`` with ``lime_coefficients``, and ``occlusion_maps``;
``run_lime`` and ``run_occlusion`` call them and then draw, with
matplotlib imported there, as in the JAX module.

    python -m learning_embeddings_tpu_torch.cli.inference \\
        --experiment_path <dir>/<name> --image_dir <images> \\
        --mode occlusion [--split test] [--n_samples 4] [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..data import ImagePipeline
from ..eval.reports import Summarize
from ..ops.image import device_scale
from ..train.classifier import ClassifierConfig, ClassifierTrainer
from ..train.experiment import Checkpointer, ExperimentDir, read_manifest
from ..viz.lime import (lime_explain, overlay_mask, slic_segments,
                        top_feature_mask)
from .common import DEFAULT_DATA_DIR, add_device_flag, load_ethec_data
from .ethec_experiments import LOSS_MAP


def rebuild_from_manifest(experiment_path: str, device="cuda"):
    """(labelmap, datasets, trainer with the checkpoint's weights on
    `device`, manifest, experiment dir, grayscale)."""
    manifest = read_manifest(os.path.join(experiment_path,
                                          "config_params.txt"))
    data_dir = manifest.get("data_dir", DEFAULT_DATA_DIR)
    debug = manifest.get("debug", "False") == "True"
    labelmap, datasets, _ = load_ethec_data(data_dir, debug)
    cfg = ClassifierConfig(
        backbone=manifest.get("model", "resnet50"),
        criterion=LOSS_MAP.get(manifest.get("loss", "multi_level"),
                               "multi_level_ce"),
        image_size=int(manifest.get("image_size", 448)),
        batch_size=int(manifest.get("batch_size", 8)),
        seed=int(manifest.get("random_seed", 0)),
        # structural flags: without them a --use_2d experiment rebuilds
        # the wrong head ('fc' against 'bottleneck'/'level_fc*') and its
        # checkpoint cannot load
        head_override=("bottleneck2d"
                       if manifest.get("use_2d", "False") == "True"
                       else None),
        optimizer=manifest.get("optimizer_method", "adam"),
        device=device,
    )
    grayscale = manifest.get("use_grayscale", "False") == "True"
    trainer = ClassifierTrainer(labelmap, cfg, grayscale=grayscale)
    exp = ExperimentDir(*os.path.split(experiment_path.rstrip("/")))
    ckpt = Checkpointer(exp)
    name = "best_model" if "best_model" in os.listdir(exp.weights) else \
        ckpt.find_existing_weights()
    if name is None:
        raise FileNotFoundError(f"no checkpoint under {exp.weights}")
    payload = ckpt.load_raw(name)
    trainer.model.load_state_dict({**payload["params"],
                                   **payload["batch_stats"]}, strict=True)
    trainer.model.eval()
    return labelmap, datasets, trainer, manifest, exp, grayscale


def _trunk_apply(trainer, images):
    """Pooled trunk (penultimate) features, (B, F) f32 on the trainer's
    device, of NHWC `images` (uint8, or float in [0, 1]; numpy or a
    tensor) — the reference's forward-hook dump on the fc input
    (inference.py:206-246)."""
    trunk = trainer.model.trunk.eval()
    with torch.inference_mode():
        x = device_scale(torch.as_tensor(images).to(trainer.device))
        return trunk(x.permute(0, 3, 1, 2))


def logits_fn(trainer):
    """images (B, H, W, C) → the classifier's raw f32 scores (B, width) on
    the trainer's device, eval mode."""
    model = trainer.model

    def fn(images):
        model.eval()
        with torch.inference_mode():
            return trainer._forward(model,
                                    torch.as_tensor(images).to(trainer.device))
    return fn


def level_slices(trainer):
    """(level, start, stop) of each explained level in the raw scores:
    every level at its ``level_start`` offset, or, for a 'leaf' head
    (last_level_ce: leaf logits only), the leaf level at [0, n_leaf).
    The per-level softmax blocks of ``lime_predict`` are concatenated in
    the same order, so the same offsets index its output."""
    lm, model = trainer.labelmap, trainer.model
    width = (sum(model.levels) if model.head == "bottleneck2d"
             else model.fc.out_features)
    if width == lm.n_classes:
        return [(l, int(lm.level_start[l]), int(lm.level_stop[l]))
                for l in range(lm.n_levels)]
    return [(lm.n_levels - 1, 0, width)]


def lime_predict(trainer, slices):
    """LIME's ``predict_fn``: numpy images (B, H, W, C) → the per-level
    softmaxes of the raw scores over `slices`, concatenated, as numpy
    (B, Σ widths); the forward runs on the trainer's device."""
    scores = logits_fn(trainer)

    def predict(images):
        raw = scores(images)
        return torch.cat([torch.softmax(raw[:, a:b], dim=-1)
                          for _, a, b in slices], dim=1).cpu().numpy()
    return predict


def lime_coefficients(predict, image, segments, num_perturb: int = 100):
    """(coefs, probs0) of one (H, W, C) image: ``lime_explain`` with the
    reference's call contract (hide_color 0, RandomState(0)). ONE
    perturbation pass serves every level: the perturbed images are the
    same for each (same segments, same masks), so `predict` scores all
    per-level softmaxes at once and the coefficients are sliced per level
    afterwards."""
    return lime_explain(image, predict, segments, num_samples=num_perturb,
                        hide_color=0.0, rng=np.random.RandomState(0))


def occlusion_maps(trainer, image, level_labels, slices, patch: int = 56,
                   stride: int = 28, batch_size: int = 32):
    """Occlusion saliency of one image (1, S, S, C), uint8 or float in
    [0, 1]: for each position of a patch × patch square of 0.5 (gray) on a
    stride grid, the ground truth's raw score on the clean image minus
    that on the occluded one, at each level of `slices` (its offset plus
    the level's label). Patch and stride are clamped to S // 4 so that
    small images keep a grid. Returns (len(slices), ny, nx) numpy f32. The
    occluded images are made on the device, `batch_size` at a time."""
    S = image.shape[1]
    patch = min(patch, max(S // 4, 1))
    stride = min(stride, patch)
    ys = range(0, S - patch + 1, stride)
    xs = range(0, S - patch + 1, stride)
    corners = [(y, x) for y in ys for x in xs]
    scores = logits_fn(trainer)
    with torch.inference_mode():
        img = device_scale(torch.as_tensor(image).to(trainer.device))
        gt = torch.tensor([a + int(level_labels[l]) for l, a, _ in slices],
                          device=trainer.device)
        base = scores(img)[0, gt]
        occ = []
        for s0 in range(0, len(corners), batch_size):
            chunk = img.repeat(len(corners[s0:s0 + batch_size]), 1, 1, 1)
            for k, (y, x) in enumerate(corners[s0:s0 + batch_size]):
                chunk[k, y:y + patch, x:x + patch] = 0.5
            occ.append(scores(chunk)[:, gt])
        drops = base - torch.cat(occ)
    return drops.T.reshape(len(slices), len(ys), len(xs)).cpu().numpy()


def run_tsne(experiment_path: str, image_dir: str, splits=("val", "test"),
             max_samples: int = 2000, render: bool = True,
             animate: bool = False, device="cuda"):
    labelmap, datasets, trainer, manifest, exp, gray = \
        rebuild_from_manifest(experiment_path, device)
    outputs = {}
    for split in splits:
        if split not in datasets:
            continue
        ds = datasets[split]
        n = min(len(ds), max_samples)
        pipe = ImagePipeline(ds, labelmap, image_dir,
                             image_size=trainer.cfg.image_size,
                             batch_size=32, train=False, grayscale=gray,
                             num_workers=4)
        feats, labels = [], []
        for batch in pipe.batches(np.arange(n)):
            feats.append(_trunk_apply(trainer, batch["image"]).cpu().numpy())
            labels.append(batch["level_labels"])
        F = np.concatenate(feats)
        L = np.concatenate(labels)
        np.save(os.path.join(exp.stats, f"{split}_representations.npy"), F)
        np.save(os.path.join(exp.stats, f"{split}_level_labels.npy"), L)
        outputs[split] = (F, L)
        if render:
            from ..viz.tsne import render_tsne

            render_tsne(F, L, labelmap,
                        os.path.join(exp.stats, f"tsne_{split}"),
                        animate=animate)
    return outputs


def run_lime(experiment_path: str, image_dir: str, split: str = "test",
             n_samples: int = 2, num_perturb: int = 100,
             n_slic_segments: int = 48, top_labels: int = 5,
             num_features: int = 10, device="cuda"):
    """Per-sample × per-level LIME explanations (inference.py:248-362):
    the reference's per-level `batch_predict` softmaxes the level slice of
    the classifier logits; `explain_instance(hide_color=0,
    num_samples=100, top_labels=5)` then `get_image_and_mask(
    positive_only=False, num_features=10)` per top label, rendered with
    boundary marks into a markdown table whose labels are green when the
    prediction matches the ground truth and red otherwise."""
    labelmap, datasets, trainer, manifest, exp, gray = \
        rebuild_from_manifest(experiment_path, device)
    ds = datasets[split]
    pipe = ImagePipeline(ds, labelmap, image_dir,
                         image_size=trainer.cfg.image_size, batch_size=1,
                         train=False, grayscale=gray, num_workers=2)
    slices = level_slices(trainer)
    predict = lime_predict(trainer, slices)

    out_dir = os.path.join(exp.stats, f"lime_{split}")
    summ = Summarize(out_dir)
    summ.make_heading(f"LIME explanations — {split}", 1)

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.image as mpimg

    for i, batch in enumerate(pipe.batches(np.arange(min(n_samples,
                                                         len(ds))))):
        img = batch["image"][0]                      # (H, W, C) in [0, 1]
        ll = batch["level_labels"][0]
        segments = slic_segments(img, n_segments=n_slic_segments)
        disp = img - img.min()
        disp = disp / max(float(disp.max()), 1e-6)   # [0,1] for rendering

        summ.make_heading(
            f"Data ID: {ds.image_paths[batch['index'][0]]}", 2)
        summ.make_heading("Ground truth", 3)
        for l in range(labelmap.n_levels):
            summ.make_text(f"{int(ll[l])} "
                           f"{labelmap.ix_to_name[l][int(ll[l])]}")
        summ.make_hrule()

        coefs, probs0 = lime_coefficients(predict, img, segments,
                                          num_perturb)
        for l, a, b in slices:
            top = np.argsort(-probs0[a:b])[:top_labels]
            cells, x_labels = [], []
            for rank, c in enumerate(top):
                mask = top_feature_mask(coefs[a + c], segments,
                                        num_features=num_features)
                png = f"{i}_{l}_{rank}.png"
                mpimg.imsave(os.path.join(out_dir, png),
                             overlay_mask(disp, segments, mask))
                cells.append(f"![x]({png})")
                color = "green" if int(c) == int(ll[l]) else "red"
                x_labels.append(
                    f'<span style="color:{color}">Predicted: {int(c)} '
                    f'{labelmap.ix_to_name[l][int(c)]}</span>')
            summ.make_heading(
                f"{labelmap.level_names[l]} - Top {len(top)}", 3)
            summ.make_table(data=[cells], x_labels=x_labels)
    print(f"wrote {out_dir}")
    return out_dir


def run_occlusion(experiment_path: str, image_dir: str, split: str = "test",
                  n_samples: int = 4, patch: int = 56, stride: int = 28,
                  device="cuda"):
    """Occlusion saliency per level (LIME-equivalent explainer): one
    figure a sample, the input beside each level's drop map."""
    labelmap, datasets, trainer, manifest, exp, gray = \
        rebuild_from_manifest(experiment_path, device)
    ds = datasets[split]
    pipe = ImagePipeline(ds, labelmap, image_dir,
                         image_size=trainer.cfg.image_size, batch_size=1,
                         train=False, grayscale=gray, num_workers=2)
    slices = level_slices(trainer)
    out_dir = os.path.join(exp.stats, f"occlusion_{split}")
    summ = Summarize(out_dir)
    summ.make_heading(f"Occlusion explanations — {split}", 1)

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    for i, batch in enumerate(pipe.batches(np.arange(min(n_samples,
                                                         len(ds))))):
        img = batch["image"]
        ll = batch["level_labels"][0]
        drops = occlusion_maps(trainer, img, ll, slices, patch, stride)
        summ.make_heading(f"Sample {i}: {ds.image_paths[batch['index'][0]]}",
                          2)
        fig, axes = plt.subplots(1, len(slices) + 1,
                                 figsize=(4 * (len(slices) + 1), 4))
        axes[0].imshow(img[0] if img.shape[-1] == 3 else img[0, ..., 0])
        axes[0].set_title("input")
        for j, (l, _, _) in enumerate(slices):
            axes[j + 1].imshow(drops[j], cmap="hot")
            axes[j + 1].set_title(
                f"L{l}: {labelmap.ix_to_name[l][int(ll[l])]}")
        fig.savefig(os.path.join(out_dir, f"sample_{i}.png"),
                    bbox_inches="tight", dpi=100)
        plt.close(fig)
        summ.make_image(f"sample_{i}.png", f"occlusion sample {i}")
    print(f"wrote {out_dir}")
    return out_dir


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--experiment_path", "--path_to_exp",
                        dest="experiment_path", type=str, required=True,
                        help="<experiment_dir>/<experiment_name> "
                             "(--path_to_exp = reference flag name)")
    parser.add_argument("--image_dir", type=str, required=True)
    parser.add_argument("--mode", type=str, required=True,
                        choices=["lime", "occlusion", "tsne"])
    parser.add_argument("--split", type=str, default="test")
    parser.add_argument("--n_samples", type=int, default=4)
    parser.add_argument("--animate", action="store_true",
                        help="tsne mode: rotating GIF per level (the "
                             "reference's mp4 counterpart)")
    add_device_flag(parser)
    return parser


def main(args=None):
    args = build_parser().parse_args(args)
    if args.mode == "tsne":
        return run_tsne(args.experiment_path, args.image_dir,
                        splits=(args.split,), animate=args.animate,
                        device=args.device)
    if args.mode == "lime":
        return run_lime(args.experiment_path, args.image_dir,
                        split=args.split, n_samples=args.n_samples,
                        device=args.device)
    return run_occlusion(args.experiment_path, args.image_dir,
                         split=args.split, n_samples=args.n_samples,
                         device=args.device)


if __name__ == "__main__":
    main()
