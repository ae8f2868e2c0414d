"""Entry points of the port (twin of the repo's ``__graft_entry__.py``).

entry()           — the forward of the flagship model (ResNet-50 multi-head
                    hierarchical classifier at 448², bf16 trunk) with its
                    example arguments.
ethec_labelmap()  — the ETHEC merged taxonomy (6/21/135/561) when the
                    ETHEC split is present, else the shipped Butterfly200
                    taxonomy (5/23/116/200).
dryrun_multichip(n) — one sharded step of every trainer on an n-rank mesh
                    of gloo processes, spatial partitioning among them,
                    then the meshed evals (the twin of
                    ``__graft_entry__.py:127-337``); prints
                    ``DRYRUN_SUMMARY {...}`` last.

    python -m learning_embeddings_tpu_torch.entry dryrun 4 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from typing import Optional

import numpy as np
import torch

from .hierarchy import LabelMap, butterfly200_labelmap, labelmap_from_records
from .models.heads import HierarchicalCNN
from .models.resnet import init_params_
from .train.classifier import resolve_device

__all__ = ["entry", "ethec_labelmap", "dryrun_multichip"]

ETHEC_LEVELS = (6, 21, 135, 561)


def ethec_labelmap() -> LabelMap:
    """Taxonomy of the flagship run: built from ``val.json`` in the
    directory named by ``ETHEC_SPLITS_DIR`` (the variable the JAX package's
    CLIs read) when that file exists; otherwise the Butterfly200 taxonomy
    that ships with the package."""
    splits_dir = os.environ.get("ETHEC_SPLITS_DIR")
    path = os.path.join(splits_dir, "val.json") if splits_dir else None
    if path is None or not os.path.exists(path):
        return butterfly200_labelmap()
    with open(path) as f:
        lm = labelmap_from_records(list(json.load(f).values()))
    # a split missing a class would silently renumber everything
    if tuple(lm.levels) != ETHEC_LEVELS:
        raise ValueError(f"ETHEC taxonomy from {path} has levels "
                         f"{lm.levels}, expected {ETHEC_LEVELS}")
    return lm


def entry(device="cuda", batch_size: int = 8, image_size: int = 448,
          dtype: torch.dtype = torch.bfloat16):
    """(fn, example_args): ``fn(model, images)`` is the eval-mode forward
    of the flagship on NHWC f32 images; weights are random from seed 0."""
    device = resolve_device(device)
    labelmap = ethec_labelmap()
    model = HierarchicalCNN(backbone="resnet50", levels=labelmap.levels,
                            head="multi_head", dtype=dtype)
    init_params_(model, torch.Generator().manual_seed(0))
    model.to(device=device, memory_format=torch.channels_last).eval()
    images = torch.zeros((batch_size, image_size, image_size, 3),
                         dtype=torch.float32, device=device)

    @torch.no_grad()
    def fn(model, images):
        return model(images.permute(0, 3, 1, 2))

    return fn, (model, images)


def dryrun_multichip(n_devices: int, device="cuda",
                     timeout_s: float = 600.0,
                     threads: Optional[int] = None) -> dict:
    """One sharded step of every trainer on an `n_devices`-rank mesh, tiny
    shapes, in the order of the JAX package's ``dryrun_multichip``: the
    classifier step on (n/2, 2) when n ≥ 4 and even, else (n, 1); two
    grad_accum=2 micro-steps on that mesh, and (with a 'model' axis) the
    same with the images' H sharded over it (JAX's spatial stage,
    ``__graft_entry__.py:209-225``: its loss and halo exchanges a rank in
    the summary); an fc7 joint epoch; the ``--use_CNN`` step, cold and
    then with the tower warm-started from a classifier; the meshed evals
    (ragged rows, sharded hit@1 and reconstruction F1); a label-only
    epoch. The ranks are gloo processes on the CPU or sharing the card(s)
    (``parallel/launch.py``); any rank's failure raises; `threads` caps
    each rank's CPU threads (by default the host's cores shared out).
    Prints each stage's line and ``DRYRUN_SUMMARY {...}`` last; returns
    the summary."""
    from .parallel.launch import run_ranks

    if torch.device(device).type == "cuda":
        resolve_device(device)
    with tempfile.TemporaryDirectory(prefix="dryrun_") as work:
        results = run_ranks("learning_embeddings_tpu_torch.entry:"
                            "_dryrun_rank", n_devices, {"device": device},
                            workdir=work, device=device, backend="gloo",
                            timeout_s=timeout_s,
                            threads=threads or max(
                                1, (os.cpu_count() or 1) // n_devices))
    summary = results[0]
    if any(r["summary"] != summary["summary"] for r in results):
        raise RuntimeError(f"dryrun_multichip: the ranks disagree: "
                           f"{[r['summary'] for r in results]}")
    for line in summary["lines"]:
        print(line)
    out = dict(summary["summary"], ok=True)
    print("DRYRUN_SUMMARY " + json.dumps(out), flush=True)
    return out


def _dryrun_rank(device) -> dict:
    from .hierarchy import label_graph_from_paths, split_edges
    from .losses.joint_sampling import build_joint_graph
    from .parallel.mesh import make_mesh
    from .train.classifier import ClassifierConfig, ClassifierTrainer
    from .train.embedding import EmbeddingTrainer, EmbeddingTrainerConfig
    from .train.joint import JointEmbeddingTrainer, JointTrainerConfig
    from .train.joint_cnn import JointCNNConfig, JointCNNTrainer
    from .utils import profiling

    n = torch.distributed.get_world_size()
    labelmap = ethec_labelmap()
    n_model = 2 if n % 2 == 0 and n >= 4 else 1
    mesh = make_mesh(n_data=n // n_model, n_model=n_model, device=device)
    lines = []

    def say(msg):
        lines.append(f"dryrun_multichip({n}): {msg}")

    cfg = ClassifierConfig(backbone="resnet18", criterion="multi_level_ce",
                           lr=1e-3, image_size=64, batch_size=2 * n, seed=0,
                           device=device)
    trainer = ClassifierTrainer(labelmap, cfg, mesh=mesh)
    rng = np.random.RandomState(0)
    B = cfg.batch_size
    images = rng.rand(B, cfg.image_size, cfg.image_size, 3).astype(
        np.float32)
    paths = labelmap.leaf_paths()
    ll = paths[rng.randint(0, labelmap.levels[-1], B)].astype(np.int32)
    multihot = np.zeros((B, labelmap.n_classes), np.float32)
    multihot[np.arange(B)[:, None], ll + np.asarray(labelmap.level_start)] = 1
    summary = {"n_devices": n, "mesh": dict(mesh.shape)}
    batch = trainer.put_batch(images, ll, multihot)
    state, loss = trainer.train_step(trainer.state, *batch)
    summary["classifier"] = round(float(loss), 4)
    say(f"mesh={dict(mesh.shape)} classifier loss={float(loss):.4f} ok")

    # gradient accumulation on the same mesh: one update per 2 micro-steps
    ga = ClassifierTrainer(labelmap, ClassifierConfig(
        backbone="resnet18", criterion="multi_level_ce", lr=1e-3,
        image_size=64, batch_size=2 * n, seed=0, grad_accum=2,
        device=device), mesh=mesh)
    ga_batch = ga.put_batch(images, ll, multihot)
    ga.state, ga_loss = ga.train_step(ga.state, *ga_batch)
    ga.state, ga_loss = ga.train_step(ga.state, *ga_batch)
    summary["grad_accum"] = round(float(ga_loss), 4)
    say(f"grad-accum loss={float(ga_loss):.4f} ok")
    del ga, ga_batch

    # spatial partitioning + gradient accumulation on the same mesh: the
    # images' H over 'model', halo exchanges around each conv and pool
    if n_model > 1:
        sp = ClassifierTrainer(labelmap, ClassifierConfig(
            backbone="resnet18", criterion="multi_level_ce", lr=1e-3,
            image_size=64, batch_size=2 * n, seed=0, spatial_partition=True,
            grad_accum=2, device=device), mesh=mesh)
        sp_batch = sp.put_batch(images, ll, multihot)
        before = profiling.counts()
        sp.state, sp_loss = sp.train_step(sp.state, *sp_batch)
        sp.state, sp_loss = sp.train_step(sp.state, *sp_batch)
        summary["spatial_grad_accum"] = round(float(sp_loss), 4)
        halos = profiling.counts() - before
        summary["spatial_halos"] = {k: halos["collective_" + k]
                                    for k in ("halo", "halo_grad")}
        say(f"spatial-partition + grad-accum loss={float(sp_loss):.4f} ok "
            f"(halo exchanges a rank {summary['spatial_halos']})")
        del sp, sp_batch

    # the fc7 joint epoch: edge batches over 'data', FeatNet replicated
    leaves = rng.randint(0, labelmap.levels[-1], 4 * n)
    graph, train_edges = build_joint_graph(labelmap, paths[leaves])
    feats = rng.rand(len(leaves), 64).astype(np.float32)
    jt = JointEmbeddingTrainer(labelmap, graph, train_edges, feats,
                               JointTrainerConfig(
                                   energy="hyp_cone", embedding_dim=4,
                                   feature_dim=64, batch_size=2 * n,
                                   neg_to_pos_ratio=2, pick_per_level=True,
                                   seed=0, device=device), mesh=mesh)
    stats = jt.train_epoch(0, np.random.RandomState(0))
    summary["joint"] = round(stats["loss"], 4)
    say(f"joint loss={stats['loss']:.4f} ok")

    # the --use_CNN step: tower batch and edge slots over 'data'
    bank = rng.rand(16, 32, 32, 3).astype(np.float32)
    ccfg = JointCNNConfig(energy="hyp_cone", backbone="resnet18",
                          embedding_dim=4, image_size=32, batch_size=2 * n,
                          neg_to_pos_ratio=2, pick_per_level=True, seed=0,
                          prefetch=False, device=device)
    ct = JointCNNTrainer(labelmap, graph, train_edges,
                         lambda rows: bank[np.asarray(rows) % len(bank)],
                         ccfg, mesh=mesh)
    img_edges = train_edges[train_edges[:, 1] >= labelmap.n_classes]
    pf, pt = img_edges[:ccfg.batch_size, 0], img_edges[:ccfg.batch_size, 1]
    loss, _, _ = ct.train_batch(pf, pt)
    summary["joint_cnn"] = round(float(loss), 4)
    say(f"joint --use_CNN loss={loss:.4f} ok")

    # the two-stage warm start: the tower's trunk from a classifier's
    warm = ClassifierTrainer(labelmap, ClassifierConfig(
        backbone="resnet18", criterion="multi_level_ce", lr=1e-3,
        image_size=32, batch_size=4, seed=1, device=device))
    trunk = warm.model.trunk
    ct.load_tower_trunk(dict(trunk.named_parameters()),
                        dict(trunk.named_buffers()))
    loss, _, _ = ct.train_batch(pf, pt)
    summary["joint_cnn_tower_warm"] = round(float(loss), 4)
    say(f"joint --use_CNN (tower warm-started from classifier) "
        f"loss={loss:.4f} ok")
    del warm

    # the meshed evals, with ragged row counts
    ev_loss, _ = trainer.eval_step(state, *batch)
    embs = ct.image_embeddings_for_rows(np.arange(2 * n + 3), batch_size=n)
    fembs = jt.image_embeddings(feats[:n + 1])
    img_embs = ct.image_embeddings_for_rows(np.arange(graph.n_images),
                                            batch_size=n)
    cm = ct.classification_metrics(graph.image_paths_global, img_embs)
    rec = ct.reconstruction()
    summary["eval_meshed"] = {
        "classifier_loss": round(float(ev_loss), 4),
        "joint_cnn_rows": list(embs.shape),
        "joint_fc7_rows": list(fembs.shape),
        "pairwise_hit1": round(float(cm["hit@1"]), 4),
        "reconstruction_f1": round(float(rec.f1), 4)}
    say(f"meshed eval ok (classifier loss={float(ev_loss):.4f}, tower embs "
        f"{tuple(embs.shape)}, fc7 embs {tuple(fembs.shape)}, "
        f"sharded-pairwise hit@1={cm['hit@1']:.4f} "
        f"recon f1={float(rec.f1):.4f})")

    # the label-only epoch: edge batches over 'data'
    lsplits = split_edges(label_graph_from_paths(paths, labelmap), seed=0)
    lt = EmbeddingTrainer(labelmap, lsplits, EmbeddingTrainerConfig(
        energy="hyp_cone", embedding_dim=4, lr=1e-2, optimizer="adam",
        batch_size=2 * n, neg_to_pos_ratio=2, seed=0, device=device),
        mesh=mesh)
    lstats = lt.train_epoch(np.random.RandomState(0))
    summary["label_embedding"] = round(lstats["loss"], 4)
    say(f"label-embedding loss={lstats['loss']:.4f} ok")
    return {"summary": summary, "lines": lines}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="entry points of the port")
    sub = ap.add_subparsers(dest="cmd", required=True)
    dry = sub.add_parser("dryrun", help="dryrun_multichip(N)")
    dry.add_argument("n_devices", type=int)
    dry.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_devices, device=args.device)


if __name__ == "__main__":
    main()
