"""Experiment runners, the epoch loops behind the CLIs: the port of
``learning_embeddings_tpu/train/runner.py``.

* ``run_classifier`` — the ETHEC multi-head CNN classifier: a train pass
  an epoch over the threaded ``ImagePipeline`` in a weighted-resampled or
  shuffled order, val and test evals at intervals (per-level metrics,
  markdown reports; ML/MLST thresholds tuned on val), best model by val
  micro-F1, a final test pass on the best model with the score dumps.
* ``run_label_embedding`` — label-only order/cone embeddings: threshold
  calibration on val, that threshold on test, periodic graph
  reconstruction.
* ``run_joint_embedding`` — the fc7 joint image + label embeddings
  (``JointEmbeddingTrainer`` on precomputed features) and
* ``run_joint_cnn`` — the ``--use_CNN`` ones, both through
  ``_run_joint_loop``: val classification metrics pick the best model,
  the val edge pass calibrates the threshold, reconstruction and test on
  the best model.

The contract they keep: best-model bookkeeping rides in every checkpoint,
so --resume continues from the latest numbered checkpoint and keeps
competing against the original best; the best model (and its threshold)
is reloaded before the final test; a threshold is never swept on test
data.

Meshes, as in the JAX runners: ``mesh="auto"`` (the classifier's and the
label-only runner's default) takes every rank of the process group when
one is up (``torchrun``, ``parallel.mesh.init_from_env``) and the batch
divides over them, with ``n_model`` ranks of each data shard holding the
classifier's tensor-parallel head (and, with the config's
``spatial_partition``, the blocks of the images' H); without a process
group it means one device. A ``parallel.mesh.Mesh`` is used as it is;
None is one device. Unlike the JAX runner, "auto" raises where the batch
does not divide over several ranks, or where ``n_model > 1`` finds no
ranks to shard over: one device per rank would train copies side by
side. The classifier's evals
pad a ragged tail batch to the full batch on a mesh (the padding rows
dropped from the scores and the loss). Only rank 0 writes the manifest,
the metrics, the reports, the plots and the checkpoints
(``train/experiment.py``); every rank reads a checkpoint back.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..parallel.mesh import Mesh, is_writer, make_mesh
from .experiment import Checkpointer, ExperimentDir, MetricsLogger, write_manifest

__all__ = ["run_classifier", "run_label_embedding", "run_joint_embedding",
           "run_joint_cnn"]


def _resolve_mesh(mesh, batch_size: int, device, n_model: int = 1):
    """A Mesh or None as given; "auto": every rank of the process group
    (n_model of them to a data shard) when the batch divides over the data
    shards, one device without a process group (JAX
    ``train/runner.py:156-166, 365-373``). Raises where one device per
    rank would train side by side, or TP has no ranks to shard over."""
    n_model = max(1, int(n_model))
    if mesh is None or isinstance(mesh, Mesh):
        if n_model > 1 and (mesh is None or mesh.n_model != n_model):
            raise ValueError(f"n_model={n_model} asks for a tensor-parallel "
                             f"head but the mesh is {mesh}")
        return mesh
    if mesh != "auto":
        raise TypeError(f"mesh must be 'auto', None or a parallel.mesh.Mesh,"
                        f" got {mesh!r}")
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    if world == 1 and n_model == 1:
        return None
    n_data = max(world // n_model, 1)
    if batch_size % n_data:
        raise ValueError(
            f"batch_size {batch_size} must divide evenly over the "
            f"{n_data} 'data' shards of the {world} ranks")
    return make_mesh(world // n_model, n_model, device=device)


def _floats(stats: Dict) -> Dict[str, float]:
    """Stats as Python floats (a trainer may return 0-d tensors)."""
    return {k: float(v) for k, v in stats.items()}


# ---------------------------------------------------------------------------
# classifier
# ---------------------------------------------------------------------------

def _eval_pass(trainer, pipe, order):
    """Scores, level labels, multi-hots, the loss summed over rows and the
    row count of one split. On a mesh a ragged tail batch is padded to the
    full batch (repeating its last row) so that it shards evenly; the
    padding rows are dropped from the scores, and a padded batch's loss,
    whose mean includes them, counts only where no full batch does."""
    bs = trainer.cfg.batch_size
    scores, labels, multihots = [], [], []
    loss_sum, loss_rows = 0.0, 0
    pad_loss_sum, pad_loss_rows = 0.0, 0
    for batch in pipe.batches(order):
        n = len(batch["image"])
        padded = trainer.mesh is not None and n < bs
        if padded:
            batch = {k: np.concatenate([v, np.repeat(v[-1:], bs - n, 0)])
                     for k, v in batch.items()}
        b = trainer.put_batch(batch["image"], batch["level_labels"],
                              batch["multihot"])
        loss, s = trainer.eval_step(trainer.state, *b)
        scores.append(s.float().cpu().numpy()[:n])
        labels.append(batch["level_labels"][:n])
        multihots.append(batch["multihot"][:n])
        if padded:
            pad_loss_sum += float(loss) * n
            pad_loss_rows += n
        else:
            loss_sum += float(loss) * n
            loss_rows += n
    if loss_rows == 0:
        loss_sum, loss_rows = pad_loss_sum, pad_loss_rows
    return (np.concatenate(scores), np.concatenate(labels),
            np.concatenate(multihots), loss_sum, max(loss_rows, 1))


def _classifier_metrics(evaluator: str, scores, level_labels, multihot,
                        labelmap, thresholds=None):
    """Score dict + the scalar that selects the best model (val
    micro-F1, as the reference tracks)."""
    from ..eval import hierarchical_match_counts, multilevel_metrics
    from ..eval.multilabel import multilabel_metrics

    if evaluator in ("ML", "MLST"):
        th = thresholds if thresholds is not None else 0.0
        m = multilabel_metrics(scores, multihot, th, labelmap)
        flat = {"micro_f1": m["global"]["micro"]["f1"],
                "macro_f1": m["global"]["macro"]["f1"],
                "accuracy": m["global"]["accuracy_score"],
                "mAP": _mean_ap(scores, multihot)}
        for name in labelmap.level_names:
            flat[f"{name}/micro_f1"] = m[name]["micro"]["f1"]
            flat[f"{name}/macro_f1"] = m[name]["macro"]["f1"]
        return m, flat, flat["micro_f1"]
    m = multilevel_metrics(scores, level_labels, labelmap)
    match = hierarchical_match_counts(scores, level_labels, labelmap)
    flat = {"micro_f1": m["micro"]["f1"], "macro_f1": m["macro"]["f1"],
            "exact_match": match["exact_match"] / max(match["n"], 1)}
    for l, name in enumerate(labelmap.level_names):
        lv = m["levels"][l]
        flat[f"{name}/accuracy"] = lv.accuracy
        flat[f"{name}/micro_f1"] = lv.f1_micro
        flat[f"{name}/macro_f1"] = lv.f1_macro
    return m, flat, flat["micro_f1"]


def _mean_ap(scores, multihot):
    from ..eval.multilabel import per_class_pr

    _, mAP = per_class_pr(scores, multihot)
    return mAP


def _write_level_report(exp: ExperimentDir, phase: str, epoch: int,
                        flat: Dict[str, float]) -> None:
    from ..eval.reports import Summarize

    if not is_writer():
        return
    s = Summarize(os.path.join(exp.stats, f"{phase}{epoch}"))
    s.make_heading(f"Classification Summary - Epoch {epoch} {phase}", 1)
    s.make_table([[k, f"{v:.4f}"] for k, v in sorted(flat.items())],
                 x_labels=["metric", "value"])


def run_classifier(
    labelmap,
    datasets: Dict[str, object],            # split -> EncodedDataset
    image_root: str,
    cfg,
    *,
    experiment_dir: str,
    experiment_name: str,
    n_epochs: int,
    evaluator: str = "MLEVAL",              # ML | MLST | MLEVAL
    eval_interval: int = 1,
    n_workers: int = 4,
    weight_strategy: str = "inv",
    use_grayscale: bool = False,
    resume: bool = False,
    mesh="auto",
    manifest_args: Optional[Dict] = None,
    set_mode: str = "train",
    augment: str = "ethec",
    use_weighted_resampler: bool = True,
    generate_plots: bool = False,
    load_backbone_from: Optional[str] = None,
    n_model: int = 1,
    profile_steps: int = 0,
    input_dtype: str = "uint8",   # host→device transfer format; 'uint8'
    #   moves raw pixels and scales on the device, bit-identical to
    #   'float32' on the Python decode path
    loader: str = "python",   # 'native': the C++ JPEG loader (JPEG files)
):
    """The classifier experiment; returns {best_val_score, best_epoch,
    test_metrics, experiment} as the JAX runner does, plus the per-class
    (ML) or single (MLST) thresholds the final test pass used
    (``thresholds``, None for MLEVAL) and the train steps this call took
    (``train_steps``, the profiled ones included). Besides the JAX
    runner's metrics it logs
    per epoch the host's wait for the pipeline's batches
    (``epoch_time_data_wait``), the evals (``epoch_time_eval``) and the
    checkpoint writes (``epoch_time_checkpoint``)."""
    from ..data import ImagePipeline, WeightedResampler, shuffled_order
    from .classifier import ClassifierTrainer

    mesh = _resolve_mesh(mesh, cfg.batch_size, cfg.device, n_model)
    exp = ExperimentDir(experiment_dir, experiment_name)
    write_manifest(exp, manifest_args or {})
    logger = MetricsLogger(exp)
    ckpt = Checkpointer(exp)

    if cfg.lr_steps and cfg.steps_per_epoch <= 1:
        # lr_steps are epoch numbers: the optimizer needs the epoch length
        # in steps to place the boundaries
        cfg = dataclasses.replace(
            cfg,
            steps_per_epoch=max(len(datasets["train"]) // cfg.batch_size, 1))
    trainer = ClassifierTrainer(labelmap, cfg, grayscale=use_grayscale,
                                mesh=mesh)
    if load_backbone_from:
        trainer.load_backbone_state_dict(load_backbone_from)
    pipes = {
        split: ImagePipeline(
            ds, labelmap, image_root, image_size=cfg.image_size,
            batch_size=cfg.batch_size, train=(split == "train"),
            grayscale=use_grayscale, num_workers=n_workers, augment=augment,
            out_dtype=input_dtype, loader=loader)
        for split, ds in datasets.items()
    }
    resampler = (WeightedResampler(datasets["train"].leaf_labels,
                                   labelmap.levels[-1], weight_strategy)
                 if use_weighted_resampler else None)

    start_epoch = 0
    thresholds = None
    best_score, best_epoch = -1.0, -1
    train_steps = 0

    # the loop's best-model bookkeeping rides in every checkpoint, so
    # --resume competes against the original best
    def _payload():
        return dict(trainer.checkpoint_payload(),
                    best_score=float(best_score),
                    best_epoch=float(best_epoch))

    def _restore(payload):
        best = float(payload.pop("best_score")), int(payload.pop("best_epoch"))
        trainer.restore_payload(payload)
        return best

    like = _payload()
    if resume:
        latest = ckpt.find_existing_weights()
        if latest is not None:
            best_score, best_epoch = _restore(ckpt.load(latest, like))
            start_epoch = latest + 1

    rng = np.random.RandomState(cfg.seed)

    if profile_steps and set_mode == "train":
        # a profile of N train steps on the first batch (after one
        # untimed step) → exp/stats/trace; the top op classes are logged
        from ..utils.profiling import summarize_trace, trace_steps

        pb = next(iter(pipes["train"].batches(
            np.arange(min(len(datasets["train"]), cfg.batch_size)), seed=0)))
        b = trainer.put_batch(pb["image"], pb["level_labels"], pb["multihot"])
        trainer.state, _ = trainer.train_step(trainer.state, *b)
        tdir = os.path.join(exp.stats, "trace")

        def one_step():
            trainer.state, loss = trainer.train_step(trainer.state, *b)
            return loss

        if is_writer():
            trace_steps(one_step, profile_steps, tdir,
                        device=trainer.device, sync=lambda out: float(out))
            for name, ms, share in summarize_trace(tdir,
                                                   profile_steps)[:10]:
                logger.scalar(f"profile/{name}_ms", ms, 0)
        else:   # the same steps (and collectives), not traced
            for _ in range(profile_steps):
                float(one_step())
        train_steps += 1 + profile_steps

    def evaluate(split, epoch, tag):
        nonlocal thresholds
        from ..eval.multilabel import (tune_per_class_thresholds,
                                       tune_single_threshold)

        scores, ll, mh, loss, loss_rows = _eval_pass(
            trainer, pipes[split], np.arange(len(datasets[split])))
        if evaluator == "ML" and split == "val":
            thresholds = tune_per_class_thresholds(scores, mh)
        elif evaluator == "MLST" and split == "val":
            thresholds = tune_single_threshold(scores, mh)
        m, flat, score = _classifier_metrics(
            evaluator, scores, ll, mh, labelmap, thresholds)
        logger.scalars(tag, flat, epoch)
        logger.scalar(f"{tag}/loss", loss / loss_rows, epoch)
        _write_level_report(exp, tag, epoch, flat)
        if cfg.head_override == "bottleneck2d" and is_writer():
            # the per-eval 2-d label-vector plot
            from ..viz.contours import plot_label_vectors

            weights = [getattr(trainer.model, f"level_fc{l}").weight
                       .detach().cpu().numpy().T
                       for l in range(labelmap.n_levels)]
            plot_label_vectors(
                weights, labelmap,
                os.path.join(exp.stats, f"label_reps_{tag}{epoch}.png"))
        return scores, ll, score, flat

    if set_mode == "train":
        for epoch in range(start_epoch, n_epochs):
            t0 = time.time()
            order = (resampler.order(rng) if resampler is not None
                     else shuffled_order(len(datasets["train"]), rng))
            losses, n_seen, wait = [], 0, 0.0
            batches = pipes["train"].batches(order, seed=epoch)
            while True:
                tw = time.time()
                batch = next(batches, None)
                wait += time.time() - tw
                if batch is None:
                    break
                b = trainer.put_batch(batch["image"], batch["level_labels"],
                                      batch["multihot"])
                trainer.state, loss = trainer.train_step(trainer.state, *b)
                train_steps += 1
                losses.append(loss)      # summed once at the epoch's end
                n_seen += len(batch["image"])
            epoch_loss = (float(torch.stack(losses).double().sum())
                          if losses else 0.0)
            logger.scalar("train/loss", epoch_loss / max(n_seen, 1), epoch)
            logger.scalar("epoch_time_train", time.time() - t0, epoch)
            logger.scalar("epoch_time_data_wait", wait, epoch)

            t_eval = time.time()
            t_ckpt = 0.0
            if epoch % eval_interval == 0 or epoch == n_epochs - 1:
                _, _, val_score, _ = evaluate("val", epoch, "val")
                evaluate("test", epoch, "test")
                if val_score > best_score:
                    best_score, best_epoch = val_score, epoch
                    tc = time.time()
                    ckpt.save("best_model", _payload(), wait=False)
                    t_ckpt += time.time() - tc
            logger.scalar("epoch_time_eval", time.time() - t_eval - t_ckpt,
                          epoch)
            tc = time.time()
            ckpt.save(epoch, _payload(), wait=False)
            logger.scalar("epoch_time_checkpoint",
                          t_ckpt + time.time() - tc, epoch)
            logger.scalar("epoch_time", time.time() - t0, epoch)

    # the best model, then the final test pass with the score dumps
    if best_epoch >= 0 or set_mode != "train":
        # a failed load must not score freshly initialised weights: in
        # eval-only mode it is fatal; a train run tolerates only a
        # best_model that was never written (no eval interval hit). Only
        # the weights are restored, as in the JAX runner: an eval-only run
        # reports best_epoch -1 and tags its report with epoch 0
        try:
            _restore(ckpt.load("best_model", like))
        except FileNotFoundError:
            if set_mode != "train":
                raise
    if evaluator in ("ML", "MLST") and "val" in datasets and \
            (set_mode != "train" or best_epoch >= 0):
        # calibrate the thresholds on val with the weights that score
        # test: the reloaded best epoch's differ from the last epoch's
        evaluate("val", max(best_epoch, 0), "best_val")
    scores, ll, test_score, flat = evaluate(
        "test", max(best_epoch, 0), "best_test")
    if is_writer():
        np.save(os.path.join(exp.stats, "predicted_scores.npy"), scores)
        np.save(os.path.join(exp.stats, "correct_labels.npy"), ll)
    if generate_plots and is_writer():
        # per-class PR curves + F1 against train frequency
        from ..eval.multilabel import render_pr_curves, render_score_vs_freq

        mh_test = datasets["test"].multihot(labelmap)
        class_names = [n for names in labelmap.ix_to_name for n in names]
        render_pr_curves(scores, mh_test, class_names,
                         os.path.join(exp.stats, "pr_curves"))
        m_all, _, _ = _classifier_metrics("MLEVAL", scores, ll, mh_test,
                                          labelmap)
        train_freq = datasets["train"].multihot(labelmap).sum(axis=0)
        per_class_f1 = np.concatenate(
            [lv.per_class_f1 for lv in m_all["levels"]])
        render_score_vs_freq(per_class_f1, train_freq,
                             os.path.join(exp.stats, "f1_vs_train_freq.png"))
    logger.close()
    return {"best_val_score": best_score, "best_epoch": best_epoch,
            "test_metrics": flat, "experiment": exp,
            "thresholds": thresholds, "train_steps": train_steps}


# ---------------------------------------------------------------------------
# label-only embeddings
# ---------------------------------------------------------------------------

def run_label_embedding(
    labelmap,
    splits,
    config,
    *,
    experiment_dir: str,
    experiment_name: str,
    n_epochs: int,
    eval_interval: int = 1,
    check_reconstr_every: int = 10,
    resume: bool = False,
    manifest_args: Optional[Dict] = None,
    init_embeddings: Optional[np.ndarray] = None,
    mesh="auto",
):
    from .embedding import EmbeddingTrainer

    mesh = _resolve_mesh(mesh, config.batch_size, config.device)
    exp = ExperimentDir(experiment_dir, experiment_name)
    write_manifest(exp, manifest_args or {})
    logger = MetricsLogger(exp)
    ckpt = Checkpointer(exp)
    trainer = EmbeddingTrainer(labelmap, splits, config, mesh=mesh)
    if init_embeddings is not None:
        trainer.load_embedding_table(init_embeddings)

    start_epoch = 0
    best_f1, best_epoch = -1.0, -1

    # best_f1/best_epoch ride in every checkpoint so --resume keeps
    # competing against the ORIGINAL best instead of overwriting
    # best_model with the first post-resume eval
    def _payload():
        return dict(trainer.checkpoint_payload(),
                    best_f1=float(best_f1), best_epoch=float(best_epoch))

    like = _payload()

    def _restore(payload):
        best = float(payload.pop("best_f1")), int(payload.pop("best_epoch"))
        trainer.restore_payload(payload)
        return best

    if resume:
        latest = ckpt.find_existing_weights()
        if latest is not None:
            best_f1, best_epoch = _restore(ckpt.load(latest, like))
            start_epoch = latest + 1

    viz_every = (5 if config.embedding_dim == 2 else 0)
    # a resumed run starts its RandomState from the seed again, as the
    # JAX runner does
    rng = np.random.RandomState(config.seed)
    for epoch in range(start_epoch, n_epochs):
        t0 = time.time()
        stats = _floats(trainer.train_epoch(rng))
        logger.scalars("train", stats, epoch)
        if viz_every and epoch % viz_every == 0 and is_writer():
            from ..viz.toy import plot_toy_embedding

            plot_toy_embedding(
                trainer.all_embeddings().cpu().numpy(), labelmap,
                os.path.join(exp.stats, f"frames/epoch_{epoch:04d}.png"),
                energy=config.energy, K=trainer.K,
                title=f"epoch {epoch}")
        if epoch % eval_interval == 0 and len(splits.val):
            val = trainer.evaluate("val")
            logger.scalars("val", {"f1": float(val.f1),
                                   "threshold": float(val.threshold),
                                   "accuracy": float(val.accuracy)}, epoch)
            if float(val.f1) > best_f1:
                best_f1, best_epoch = float(val.f1), epoch
                ckpt.save("best_model", _payload())
        if check_reconstr_every and epoch % check_reconstr_every == 0:
            rec = trainer.reconstruction()
            logger.scalars("reconstruction", {
                "f1": float(rec.f1), "accuracy": float(rec.accuracy),
                "threshold": float(rec.threshold)}, epoch)
        ckpt.save(epoch, _payload())
        logger.scalar("epoch_time", time.time() - t0, epoch)

    results = {"best_val_f1": best_f1, "best_epoch": best_epoch}
    # final test and reconstruction on the BEST model with ITS calibrated
    # threshold
    if best_epoch >= 0:
        _restore(ckpt.load("best_model", like))
    if len(splits.test):
        if trainer.optimal_threshold is None and len(splits.val):
            # never sweep the threshold on test data: calibrate on val
            trainer.evaluate("val")
        if trainer.optimal_threshold is None:
            print("run_label_embedding: no val edges — skipping test "
                  "edge-F1 (no calibrated threshold)")
        else:
            test = trainer.evaluate("test")
            results["test_f1"] = float(test.f1)
            logger.scalars("test", {"f1": float(test.f1)}, n_epochs)
    rec = trainer.reconstruction()
    results["reconstruction_f1"] = float(rec.f1)
    logger.close()
    return {**results, "trainer": trainer, "experiment": exp}


# ---------------------------------------------------------------------------
# joint embeddings (the loop of the fc7 and --use_CNN paths)
# ---------------------------------------------------------------------------

def _run_joint_loop(
    trainer,
    eval_split,          # (split) -> (metrics dict, edge metrics or None)
    *,
    exp: ExperimentDir,
    n_epochs: int,
    eval_interval: int,
    has_val_edges: bool,  # whether eval_split('val') can calibrate a thresh
    resume: bool,
    seed: int,
):
    """Per-epoch train; val classification metrics select the best model;
    the val edge pass calibrates `optimal_threshold` (in every checkpoint);
    --resume from the latest numbered checkpoint; best reload (and val
    calibration if it has no threshold) before the final reconstruction
    and test."""
    logger = MetricsLogger(exp)
    ckpt = Checkpointer(exp)

    def _payload(best_f1, best_epoch):
        return dict(trainer.checkpoint_payload(),
                    best_f1=float(best_f1), best_epoch=float(best_epoch))

    like = _payload(-1.0, -1)
    best_f1, best_epoch = -1.0, -1
    start_epoch = 0
    if resume:
        latest = ckpt.find_existing_weights()
        if latest is not None:
            payload = ckpt.load(latest, like)
            best_f1 = float(payload.pop("best_f1"))
            best_epoch = int(payload.pop("best_epoch"))
            trainer.restore_payload(payload)
            start_epoch = latest + 1

    def _eval(split):
        m, em = eval_split(split)
        if em is not None and split == "val":
            trainer.optimal_threshold = float(em.threshold)
        return m, em

    rng = np.random.RandomState(seed)
    for epoch in range(start_epoch, n_epochs):
        t0 = time.time()
        stats = _floats(trainer.train_epoch(epoch, rng))
        logger.scalars("train", stats, epoch)
        if epoch % eval_interval == 0:
            m, em = _eval("val")
            scal = {k: v for k, v in m.items() if isinstance(v, float)}
            if em is not None:
                scal["edge_f1"] = float(em.f1)
                scal["edge_threshold"] = float(em.threshold)
            logger.scalars("val", scal, epoch)
            if m["micro_f1"] > best_f1:
                best_f1, best_epoch = m["micro_f1"], epoch
                ckpt.save("best_model", _payload(best_f1, best_epoch))
        ckpt.save(epoch, _payload(best_f1, best_epoch))
        logger.scalar("epoch_time", time.time() - t0, epoch)

    if best_epoch >= 0:
        payload = ckpt.load("best_model", like)
        payload.pop("best_f1")
        payload.pop("best_epoch")
        trainer.restore_payload(payload)
    if trainer.optimal_threshold is None and has_val_edges:
        # never sweep the edge threshold on test data: calibrate on val
        _eval("val")
    rec = trainer.reconstruction()
    logger.scalars("reconstruction", {"f1": float(rec.f1)}, n_epochs)
    mtest, em_test = _eval("test")
    test_metrics = {k: v for k, v in mtest.items() if isinstance(v, float)}
    if em_test is not None:
        test_metrics["edge_f1"] = float(em_test.f1)
    logger.close()
    return {"best_val_micro_f1": best_f1, "best_epoch": best_epoch,
            "test_metrics": test_metrics,
            "reconstruction_f1": float(rec.f1),
            "trainer": trainer, "experiment": exp}


def run_joint_embedding(
    labelmap,
    graph,
    train_edges,
    features,
    config,
    *,
    experiment_dir: str,
    experiment_name: str,
    n_epochs: int,
    eval_interval: int = 1,
    eval_features: Optional[Dict[str, np.ndarray]] = None,
    eval_paths: Optional[Dict[str, np.ndarray]] = None,
    resume: bool = False,
    manifest_args: Optional[Dict] = None,
    mesh=None,
    init_embeddings: Optional[np.ndarray] = None,
    init_threshold: Optional[float] = None,
):
    """fc7 joint runner. eval_features/eval_paths: per split ('val',
    'test') fc7 arrays and (n, L) global ancestor paths of held-out
    images; without them the train images are scored, with no edge pass.
    init_embeddings/init_threshold: the label table's warm start
    (--load_emb_from loads both)."""
    from .joint import JointEmbeddingTrainer

    mesh = _resolve_mesh(mesh, config.batch_size, config.device)
    exp = ExperimentDir(experiment_dir, experiment_name)
    write_manifest(exp, manifest_args or {})
    trainer = JointEmbeddingTrainer(labelmap, graph, train_edges, features,
                                    config, mesh=mesh)
    if init_embeddings is not None:
        trainer.load_embedding_table(init_embeddings)
    if init_threshold is not None:
        trainer.optimal_threshold = float(init_threshold)
    # each split's features go to the device once, not at every eval
    eval_features = {k: torch.as_tensor(v, dtype=torch.float32)
                     .to(trainer.device)
                     for k, v in (eval_features or {}).items()}

    def eval_split(split):
        if split not in eval_features:
            # no held-out features: score the train images, no edge pass
            # (never sweep a threshold on test data)
            return trainer.classification_metrics(), None
        m = trainer.classification_metrics(
            img_paths_global=eval_paths[split],
            features=eval_features[split])
        th = trainer.optimal_threshold if split == "test" else None
        if split == "test" and th is None:
            return m, None
        em = trainer.edge_metrics(eval_paths[split], eval_features[split],
                                  threshold=th)
        return m, em

    return _run_joint_loop(
        trainer, eval_split, exp=exp, n_epochs=n_epochs,
        eval_interval=eval_interval,
        has_val_edges="val" in eval_features,
        resume=resume, seed=config.seed)


def run_joint_cnn(
    labelmap,
    graph,
    train_edges,
    pixel_loader,
    config,
    *,
    experiment_dir: str,
    experiment_name: str,
    n_epochs: int,
    eval_interval: int = 1,
    eval_sets: Optional[Dict[str, tuple]] = None,   # split -> (paths, loader)
    eval_max_images: Optional[int] = None,
    resume: bool = False,
    manifest_args: Optional[Dict] = None,
    mesh=None,
    init_embeddings: Optional[np.ndarray] = None,
    init_threshold: Optional[float] = None,
    init_tower: Optional[tuple] = None,   # (trunk_params, trunk_stats)
    train_eval_loader=None,
):
    """--use_CNN joint runner. eval_sets[split] = ((n, L) global ancestor
    paths, loader(rows)->pixels); without them the train images are scored
    (with `train_eval_loader` where given: the train pixel_loader
    augments). eval_max_images caps the images embedded per split with a
    seeded random subsample, and says so (split jsons are taxon-ordered, so
    a prefix would score one branch only)."""
    from .joint_cnn import JointCNNTrainer

    mesh = _resolve_mesh(mesh, config.batch_size, config.device)
    exp = ExperimentDir(experiment_dir, experiment_name)
    write_manifest(exp, manifest_args or {})
    trainer = JointCNNTrainer(labelmap, graph, train_edges, pixel_loader,
                              config, mesh=mesh)
    if init_embeddings is not None:
        trainer.load_embedding_table(init_embeddings)
    if init_threshold is not None:
        trainer.optimal_threshold = float(init_threshold)
    if init_tower is not None:
        # the two-stage recipe: the joint image tower starts from a
        # finetuned classifier's trunk
        trainer.load_tower_trunk(*init_tower)

    def eval_split(split):
        held_out = bool(eval_sets and split in eval_sets)
        if held_out:
            paths, loader = eval_sets[split]
        else:
            paths = graph.image_paths_global
            loader = train_eval_loader or trainer.pixel_loader
            if train_eval_loader is None:
                print("run_joint_cnn: no eval_sets and no "
                      "train_eval_loader — scoring train images with the "
                      "AUGMENTING train loader (metrics will jitter)")
        paths = np.asarray(paths)
        rows = np.arange(len(paths))
        if eval_max_images is not None and len(rows) > eval_max_images:
            print(f"run_joint_cnn: capping {split} eval at "
                  f"{eval_max_images} of {len(rows)} images, seeded "
                  f"random subsample (--eval_max_images)")
            rows = np.random.RandomState(config.seed + 7).choice(
                len(rows), eval_max_images, replace=False)
        embs = trainer.image_embeddings_for_rows(
            rows, loader=loader, batch_size=config.batch_size)
        m = trainer.classification_metrics(paths[rows], embs)
        if not held_out:
            return m, None        # no edge pass on train images
        th = trainer.optimal_threshold if split == "test" else None
        if split == "test" and th is None:
            return m, None        # never sweep the threshold on test
        em = trainer.edge_metrics(paths[rows], embs, threshold=th)
        return m, em

    return _run_joint_loop(
        trainer, eval_split, exp=exp, n_epochs=n_epochs,
        eval_interval=eval_interval,
        has_val_edges=bool(eval_sets and "val" in eval_sets),
        resume=resume, seed=config.seed)
