"""Experiment runners, the epoch loops behind the CLIs: the port of
``run_label_embedding``, ``_run_joint_loop`` and ``run_joint_cnn`` from
``learning_embeddings_tpu/train/runner.py`` (lines 348-552, 612-692), on
one device.

* ``run_label_embedding`` — label-only order/cone embeddings: threshold
  calibration on val, that threshold on test, periodic graph
  reconstruction.
* ``run_joint_cnn`` — the ``--use_CNN`` joint image + label embeddings
  through ``_run_joint_loop``: val classification metrics pick the best
  model, the val edge pass calibrates the threshold, reconstruction and
  test on the best model.

The contract both keep: best-model bookkeeping rides in every checkpoint,
so --resume continues from the latest numbered checkpoint and keeps
competing against the original best; the best model and its threshold are
reloaded before the final test; the threshold is never swept on test data.

Still to port (ROADMAP.md): ``run_classifier`` and the fc7
``run_joint_embedding``. A mesh other than "auto" or None raises: "auto"
means one device here.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np

from .experiment import Checkpointer, ExperimentDir, MetricsLogger, write_manifest

__all__ = ["run_label_embedding", "run_joint_cnn"]


def _one_device(mesh) -> None:
    """"auto" and None mean the trainer's one device."""
    if mesh not in ("auto", None):
        raise NotImplementedError(
            "meshes are not ported yet (ROADMAP.md queue A item 21)")


def _floats(stats: Dict) -> Dict[str, float]:
    """Stats as Python floats (a trainer may return 0-d tensors)."""
    return {k: float(v) for k, v in stats.items()}


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

    _one_device(mesh)
    exp = ExperimentDir(experiment_dir, experiment_name)
    write_manifest(exp, manifest_args or {})
    logger = MetricsLogger(exp)
    ckpt = Checkpointer(exp)
    trainer = EmbeddingTrainer(labelmap, splits, config)
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
        if viz_every and epoch % viz_every == 0:
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
# joint embeddings (the loop the --use_CNN path runs)
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

    _one_device(mesh)
    exp = ExperimentDir(experiment_dir, experiment_name)
    write_manifest(exp, manifest_args or {})
    trainer = JointCNNTrainer(labelmap, graph, train_edges, pixel_loader,
                              config)
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
