"""Programs that every rank of ``launch.run_ranks`` runs, each a function
of picklable arguments that builds its mesh (``make_mesh``), drives one
meshed path of the package and returns numpy results; with ``mesh=None``
the same code is the one-device run they are held against. They serve the
tests, ``entry.dryrun_multichip`` and ``chip_smoke.py``.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..utils import profiling
from . import mesh as pmesh
from .mesh import make_mesh

__all__ = ["classifier_run", "classifier_steps", "classifier_cases",
           "spatial_ops",
           "pairwise_run", "pairwise_tiles", "eval_metrics_run",
           "eval_metrics", "embedding_run", "embedding_epochs", "fc7_run",
           "fc7_epochs", "joint_cnn_run", "joint_cnn_steps",
           "collective_check", "nccl_check", "synthetic_batches",
           "runner_run", "cli_main"]


def _numpy(sd) -> Dict[str, np.ndarray]:
    """Copies (a CPU tensor's .numpy() shares its memory, which later
    steps overwrite)."""
    return {k: np.array(v.detach().float().cpu().numpy())
            for k, v in sd.items()}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _profiled_collectives(device, step):
    """(seconds, {tag: ms}) of one `step()` run under the profiler, which
    turns the collectives' device spans on: each tag's exposed time on the
    compute stream (its event pairs; on CPU tensors, its host spans). The
    card is synchronised before and after the step only."""
    from torch.profiler import ProfilerActivity, profile

    on_card = torch.device(device).type == "cuda"
    _sync(device)
    with profile(activities=[ProfilerActivity.CUDA if on_card
                             else ProfilerActivity.CPU]):
        t0 = time.perf_counter_ns()
        step()
        _sync(device)
        step_s = (time.perf_counter_ns() - t0) / 1e9
    ms: Dict[str, float] = {}
    for r in profiling.spans(since_ns=t0):
        if r.name.startswith("collective."):
            tag = r.name[len("collective."):]
            d = profiling.device_ms(r)
            ms[tag] = ms.get(tag, 0.0) + (r.host_ms if d is None else d)
    return step_s, ms


# ---------------------------------------------------------------------------
# classifier
# ---------------------------------------------------------------------------

def synthetic_batches(labelmap, n: int, batch: int, size: int,
                      seed: int = 0) -> List:
    """`n` (uint8 NHWC images, level labels, multi-hots) batches drawn
    from ``RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        imgs = rng.randint(0, 256, (batch, size, size, 3), dtype=np.uint8)
        ll = labelmap.leaf_paths()[rng.randint(0, labelmap.levels[-1],
                                               batch)].astype(np.int32)
        mh = np.zeros((batch, labelmap.n_classes), np.float32)
        mh[np.arange(batch)[:, None],
           ll + np.asarray(labelmap.level_start)] = 1.0
        out.append((imgs, ll, mh))
    return out


def classifier_run(labelmap, cfg, batches: Sequence = (), *, mesh=None,
                   weights: Optional[Dict] = None, eval_batch=None,
                   grayscale: bool = False, timed_steps: int = 0,
                   checkpoint_roundtrip: bool = False,
                   synthetic: Optional[Sequence[int]] = None,
                   state_keys: Sequence[str] = ()) -> Dict:
    """Train steps of ``ClassifierTrainer`` on the global `batches`
    ((images, level_labels, multihot) numpy tuples), from `weights` (a
    whole state dict) or the seeded start; then, with `timed_steps`, that
    many more steps on the last batch timed on the host clock around a
    synchronise (``ms_per_step``), and one more under the profiler
    (``timed_step_ms``, the profiler's cost included), whose collectives'
    spans give each tag's exposed milliseconds (``collective_ms``) and
    their share of an untraced step (``collective_share``).
    Returns the eval loss and scores of `eval_batch` at the start, the
    global losses, the running statistics and the `state_keys` entries of
    the whole state dict after the steps, and the kernel launches and
    collectives per rank over the untimed steps. `synthetic` = (n, seed)
    draws the batches with ``synthetic_batches`` at the config's batch
    and image size."""
    from ..train.classifier import ClassifierTrainer

    if synthetic is not None:
        batches = synthetic_batches(labelmap, synthetic[0], cfg.batch_size,
                                    cfg.image_size, synthetic[1])

    tr = ClassifierTrainer(labelmap, cfg, grayscale=grayscale, mesh=mesh)
    if weights is not None:
        tr.load_weights(weights)
    out: Dict = {"device": str(tr.device)}
    if eval_batch is not None:
        loss, scores = tr.eval_step(tr.state, *tr.put_batch(*eval_batch))
        out["eval_loss"] = float(loss)
        out["eval_scores"] = scores.float().cpu().numpy()
    if tr.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(tr.device)
    profiling.reset_counts()
    losses = []
    for b in batches:
        tr.state, loss = tr.train_step(tr.state, *tr.put_batch(*b))
        losses.append(float(loss))
    out["losses"] = losses
    out["counts"] = profiling.counts()
    if checkpoint_roundtrip:
        payload = tr.checkpoint_payload()
        out["payload_params"] = _numpy({k: payload["params"][k]
                                        for k in state_keys})
        tr.restore_payload(payload)
    whole = tr.whole_state_dict()
    out["state_dict"] = _numpy({k: whole[k] for k in state_keys})
    out["running"] = _numpy(dict(tr.state.model.named_buffers()))
    if timed_steps:
        b = tr.put_batch(*batches[-1])
        _sync(tr.device)
        t0 = time.perf_counter()
        for _ in range(timed_steps):
            tr.state, loss = tr.train_step(tr.state, *b)
        float(loss)
        _sync(tr.device)
        out["ms_per_step"] = (time.perf_counter() - t0) * 1e3 / timed_steps
        # one step under the profiler: each collective's span times it
        step_s, out["collective_ms"] = _profiled_collectives(
            tr.device, lambda: float(tr.train_step(tr.state, *b)[1]))
        out["timed_step_ms"] = step_s * 1e3
        out["collective_share"] = (sum(out["collective_ms"].values())
                                   / out["ms_per_step"])
    if tr.device.type == "cuda":
        out["peak_gib"] = torch.cuda.max_memory_allocated(tr.device) / 2**30
    return out


def classifier_steps(n_data: int, n_model: int, device: str = "cpu",
                     **kw) -> Dict:
    """``classifier_run`` on a fresh (n_data, n_model) mesh."""
    return classifier_run(mesh=make_mesh(n_data, n_model, device=device),
                          **kw)


def _tf32_off() -> None:
    """TF32 off in cuDNN's convolutions and in matmuls (for comparisons
    at f32 tolerances on the card)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def classifier_cases(n_data: int, n_model: int, cases: Sequence[Dict],
                     device: str = "cpu", full_f32: bool = False
                     ) -> List[Dict]:
    """``classifier_run`` of each case's keyword arguments on one (n_data,
    n_model) mesh; `full_f32` turns TF32 off."""
    if full_f32:
        _tf32_off()
    mesh = make_mesh(n_data, n_model, device=device)
    return [classifier_run(mesh=mesh, **kw) for kw in cases]


# ---------------------------------------------------------------------------
# spatial partitioning
# ---------------------------------------------------------------------------

def spatial_ops(n_model: int, specs: Sequence, shape: Sequence[int],
                seed: int = 0, device: str = "cpu") -> List[Dict]:
    """The ops of ``parallel/spatial.py`` on this rank's H block of a
    seeded f32 input x (B, C, H, W), on a (1, n_model) mesh. `specs`:
    ("conv", k, s, p), ("s2d_conv",) (the s2d stem's 4×4/s1 conv after
    its (2, 1) pad), ("pool", k, s, p), ("gather",) or ("mean",). Each op
    runs forward and backward against a seeded upstream gradient of the
    whole output (this rank takes its block where the output is sharded);
    returns per spec the output, x's gradient and the weight's gradient
    (this rank's share) as numpy."""
    from .spatial import SpatialShards

    mesh = make_mesh(1, n_model, device=device)
    sp = SpatialShards(mesh)
    B, C, H, W = shape
    h = H // n_model
    rows = slice(mesh.model_index * h, (mesh.model_index + 1) * h)
    out = []
    for i, spec in enumerate(specs):
        rng = np.random.RandomState(seed + i)
        x_all = (0.1 * rng.randn(B, C, H, W)).astype(np.float32)
        x = torch.tensor(x_all[:, :, rows], device=mesh.device).contiguous(
            memory_format=torch.channels_last).requires_grad_(True)
        w = None
        kind = spec[0]
        if kind in ("conv", "s2d_conv"):
            k = spec[1] if kind == "conv" else 4
            w = torch.tensor((rng.randn(5, C, k, k) / np.sqrt(C * k * k))
                             .astype(np.float32), device=mesh.device,
                             requires_grad=True)
            if kind == "conv":
                y = sp.conv2d(x, w, None, (spec[2], spec[2]),
                              (spec[3], spec[3]))
            else:
                y = sp.conv2d(torch.nn.functional.pad(x, (2, 1)), w, None,
                              (1, 1), (0, 0), pad_h=(2, 1))
        elif kind == "pool":
            y = sp.max_pool2d(x, spec[1], spec[2], spec[3])
        elif kind == "gather":
            y = sp.gather(x)
        elif kind == "mean":
            y = sp.mean(x)
        else:
            raise ValueError(f"unknown op {spec}")
        if kind in ("gather", "mean"):      # whole on every rank
            full = y.shape
        else:
            full = (y.shape[0], y.shape[1], y.shape[2] * n_model, y.shape[3])
        g_all = (0.1 * rng.randn(*full)).astype(np.float32)
        g = g_all if kind in ("gather", "mean") else g_all[
            :, :, mesh.model_index * y.shape[2]:
            (mesh.model_index + 1) * y.shape[2]]
        (y * torch.tensor(g, device=mesh.device)).sum().backward()
        out.append({"y": _numpy({"y": y})["y"],
                    "dx": _numpy({"dx": x.grad})["dx"],
                    "dw": None if w is None else _numpy({"dw": w.grad})["dw"],
                    "channels_last": y.ndim < 4 or y.is_contiguous(
                        memory_format=torch.channels_last),
                    "counts": profiling.counts()})
        profiling.reset_counts()
    return out


# ---------------------------------------------------------------------------
# sharded all-pairs energies
# ---------------------------------------------------------------------------

def pairwise_run(kind: str, u: np.ndarray, v: np.ndarray, *, mesh=None,
                 device: str = "cpu", **kw) -> Dict:
    """``pairwise_energy_sharded`` of numpy U, V on `mesh`; the energies
    and the order kernel's launches on this rank."""
    from ..geometry.pairwise import pairwise_energy_sharded

    dev = mesh.device if mesh is not None else torch.device(device)
    profiling.reset_counts()
    E = pairwise_energy_sharded(kind, torch.as_tensor(u, device=dev),
                                torch.as_tensor(v, device=dev), mesh=mesh,
                                **kw)
    return {"E": E.cpu().numpy(), "counts": profiling.counts()}


def pairwise_tiles(n_data: int, n_model: int, device: str = "cpu",
                   **kw) -> Dict:
    return pairwise_run(mesh=make_mesh(n_data, n_model, device=device),
                        **kw)


def eval_metrics_run(labelmap, label_emb, img_emb, paths_global, closure,
                     energy: str, *, mesh=None, **kw) -> Dict:
    """The joint ranking metrics and the reconstruction of numpy
    embeddings, with their energies tiled over `mesh`."""
    from ..eval.ranking import joint_classification_metrics
    from ..eval.reconstruction import reconstruction_metrics

    dev = mesh.device if mesh is not None else torch.device("cpu")
    lab = torch.as_tensor(label_emb, device=dev)
    m = joint_classification_metrics(lab, img_emb, paths_global, labelmap,
                                     energy=energy, mesh=mesh, **kw)
    r = reconstruction_metrics(lab, closure, energy=energy, mesh=mesh, **kw)
    return {"ranking": m, "reconstruction": {
        k: float(getattr(r, k)) for k in ("f1", "accuracy", "precision",
                                          "recall", "threshold")}}


def eval_metrics(n_data: int, n_model: int, device: str = "cpu",
                 **kw) -> Dict:
    return eval_metrics_run(mesh=make_mesh(n_data, n_model, device=device),
                            **kw)


def nccl_check(device: str = "cuda", **kw) -> Dict:
    """On a mesh over every rank of an NCCL group: ``classifier_run(**kw)``,
    then an all_reduce over the whole group of rank + 1 (its sum is
    world·(world + 1)/2) and a barrier."""
    import torch.distributed as dist

    mesh = make_mesh(device=device)
    out = classifier_run(mesh=mesh, **kw)
    t = torch.full((4,), float(mesh.rank + 1), device=mesh.device)
    pmesh.all_reduce_(t, dist.group.WORLD, "nccl_check")
    pmesh.barrier()
    out.update(backend=dist.get_backend(), world=dist.get_world_size(),
               reduced=t.cpu().numpy())
    return out


def collective_check(n_data: int, n_model: int,
                     device: str = "cpu") -> Dict:
    """The autograd collectives on known values: rank r contributes rows
    of value r + 1; returns forward values and input gradients of
    ``gather_rows`` (both gradient rules), ``copy_to_group`` and
    ``reduce_from_group``, and ``all_gather_rows`` of a bool block."""
    mesh = make_mesh(n_data, n_model, device=device)
    g = mesh.data_group
    r = float(mesh.rank + 1)
    out = {"rank": mesh.rank, "data_index": mesh.data_index,
           "model_index": mesh.model_index}
    for reduce_grad in (True, False):
        x = torch.full((2, 3), r, device=mesh.device, requires_grad=True)
        y = pmesh.gather_rows(x, g, reduce_grad=reduce_grad)
        w = torch.arange(y.numel(), dtype=torch.float32,
                         device=mesh.device).view(y.shape)
        (y * w * r).sum().backward()
        out[f"gather_{reduce_grad}"] = (y.detach().cpu().numpy(),
                                        x.grad.cpu().numpy())
    x = torch.full((3,), r, device=mesh.device, requires_grad=True)
    y = pmesh.copy_to_group(x, mesh.model_group)
    (y * r).sum().backward()
    out["copy"] = (y.detach().cpu().numpy(), x.grad.cpu().numpy())
    x = torch.full((3,), r, device=mesh.device, requires_grad=True)
    y = pmesh.reduce_from_group(x, mesh.model_group)
    (y * 2).sum().backward()
    out["reduce"] = (y.detach().cpu().numpy(), x.grad.cpu().numpy())
    flags = torch.tensor([mesh.rank % 2 == 0], device=mesh.device)
    out["bools"] = pmesh.all_gather_rows(flags, g, "bools").cpu().numpy()
    pmesh.barrier()
    return out


# ---------------------------------------------------------------------------
# label-only, fc7 and --use_CNN trainers
# ---------------------------------------------------------------------------

def embedding_run(labelmap, splits, cfg, *, mesh=None, epochs: int = 1,
                  seed: int = 0) -> Dict:
    """Label-only epochs (``EmbeddingTrainer``), then the val and test
    edge metrics and the reconstruction."""
    from ..train.embedding import EmbeddingTrainer

    tr = EmbeddingTrainer(labelmap, splits, cfg, mesh=mesh)
    rng = np.random.RandomState(seed)
    stats = [tr.train_epoch(rng) for _ in range(epochs)]
    val, test = tr.evaluate("val"), tr.evaluate("test")
    rec = tr.reconstruction()
    return {"stats": stats, "table": _numpy(tr.model.state_dict()),
            "val_f1": float(val.f1), "test_f1": float(test.f1),
            "reconstruction_f1": float(rec.f1),
            "reconstruction_threshold": float(rec.threshold),
            "counts": profiling.counts()}


def embedding_epochs(n_data: int, device: str = "cpu", **kw) -> Dict:
    return embedding_run(mesh=make_mesh(n_data, 1, device=device), **kw)


def fc7_run(labelmap, graph, edges, features, cfg, *, mesh=None,
            epochs: int = 1, eval_features=None, eval_paths=None,
            weights: Optional[Dict] = None, seed: int = 0) -> Dict:
    """fc7 joint epochs (``JointEmbeddingTrainer``) from `weights`
    ({"labels": table state dict, "images": FeatNet state dict}) or the
    seeded start, then the eval embeddings of `eval_features` (ragged
    rows), their ranking metrics and the reconstruction."""
    from ..train.joint import JointEmbeddingTrainer

    tr = JointEmbeddingTrainer(labelmap, graph, edges, features, cfg,
                               mesh=mesh)
    if weights is not None:
        tr.embedder.load_state_dict({k: torch.as_tensor(v) for k, v in
                                     weights["labels"].items()})
        tr.featnet.load_state_dict({k: torch.as_tensor(v) for k, v in
                                    weights["images"].items()})
    rng = np.random.RandomState(seed)
    stats = [tr.train_epoch(e, rng) for e in range(epochs)]
    out = {"stats": stats,
           "params": {"labels": _numpy(tr.embedder.state_dict()),
                      "images": _numpy(tr.featnet.state_dict())}}
    if eval_features is not None:
        emb = tr.image_embeddings(eval_features)
        out["eval_embeddings"] = emb.cpu().numpy()
        m = tr.classification_metrics(eval_paths, eval_features)
        out["hit@1"] = m["hit@1"]
        out["micro_f1"] = m["micro_f1"]
    rec = tr.reconstruction()
    out["reconstruction_f1"] = float(rec.f1)
    out["counts"] = profiling.counts()
    return out


def fc7_epochs(n_data: int, device: str = "cpu", **kw) -> Dict:
    return fc7_run(mesh=make_mesh(n_data, 1, device=device), **kw)


def _pixel_bank_loader(bank: np.ndarray):
    def load(rows):
        return bank[np.asarray(rows) % len(bank)]
    return load


def joint_cnn_run(labelmap, graph, edges, bank: np.ndarray, cfg, *,
                  mesh=None, batches: Sequence = (),
                  weights: Optional[Dict] = None, eval_rows=None,
                  eval_batch_size: int = 4, warm_trunk=None,
                  timed_steps: int = 0, eval_at_start: bool = False
                  ) -> Dict:
    """``--use_CNN`` joint steps on the (pos_from, pos_to) `batches`, with
    pixels ``bank[row % len(bank)]``; `weights` the whole start
    ({"labels": table, "images": tower state dict}); `warm_trunk`
    (params, stats) loads the tower's trunk after the steps and takes one
    more step (the warm start composing with the mesh). Then the eval
    embeddings of `eval_rows`, their ranking metrics and the
    reconstruction; with `eval_at_start` also before the steps, on the
    start weights ("start_" keys)."""
    from ..train.joint_cnn import JointCNNTrainer

    tr = JointCNNTrainer(labelmap, graph, edges, _pixel_bank_loader(bank),
                         cfg, mesh=mesh)
    if weights is not None:
        tr.embedder.load_state_dict({k: torch.as_tensor(v) for k, v in
                                     weights["labels"].items()})
        tr.featcnn.load_state_dict({k: torch.as_tensor(v) for k, v in
                                    weights["images"].items()})

    def evaluate(prefix):
        emb = tr.image_embeddings_for_rows(np.asarray(eval_rows),
                                           batch_size=eval_batch_size)
        paths = graph.image_paths_global[np.asarray(eval_rows)
                                         % graph.n_images]
        m = tr.classification_metrics(paths, emb)
        return {prefix + "eval_embeddings": emb, prefix + "hit@1": m["hit@1"],
                prefix + "reconstruction_f1": float(tr.reconstruction().f1)}

    out: Dict = evaluate("start_") if eval_at_start else {}
    if tr.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(tr.device)
    profiling.reset_counts()
    steps = []
    for pf, pt in batches:
        loss, e_pos, e_neg = tr.train_batch(np.asarray(pf), np.asarray(pt))
        steps.append({"loss": loss, "e_pos": e_pos.cpu().numpy(),
                      "e_neg": e_neg.cpu().numpy()})
    out.update(steps=steps, counts=profiling.counts(),
               labels=_numpy(tr.embedder.state_dict()),
               images=_numpy(tr.featcnn.state_dict()))
    if timed_steps:
        pf, pt = batches[-1]
        prepared = tr.prepare_batch(np.asarray(pf), np.asarray(pt))
        _sync(tr.device)
        t0 = time.perf_counter()
        for _ in range(timed_steps):
            loss = tr.train_prepared(prepared)[0]
        float(loss)
        _sync(tr.device)
        out["ms_per_step"] = (time.perf_counter() - t0) * 1e3 / timed_steps
    if warm_trunk is not None:
        params, stats = ({k: torch.as_tensor(v) for k, v in d.items()}
                         for d in warm_trunk)
        tr.load_tower_trunk(params, stats)
        pf, pt = batches[-1]
        out["warm_loss"] = tr.train_batch(np.asarray(pf), np.asarray(pt))[0]
    if eval_rows is not None:
        profiling.reset_counts()
        out.update(evaluate(""))
        out["eval_counts"] = profiling.counts()
    if tr.device.type == "cuda":
        out["peak_gib"] = torch.cuda.max_memory_allocated(tr.device) / 2**30
    return out


def joint_cnn_steps(n_data: int, device: str = "cpu",
                    full_f32: bool = False, **kw) -> Dict:
    """``joint_cnn_run`` on a fresh (n_data, 1) mesh; `full_f32` turns TF32
    off."""
    if full_f32:
        _tf32_off()
    return joint_cnn_run(mesh=make_mesh(n_data, 1, device=device), **kw)


def _quiet_logger(jsonl_only: bool, mkldnn: Optional[bool]) -> None:
    import sys

    if jsonl_only:
        # MetricsLogger keeps to its jsonl mirror (tensorboard's import
        # pulls in TensorFlow where it is installed)
        sys.modules["torch.utils.tensorboard"] = None
    if mkldnn is not None:
        # off for a bf16 trunk at tiny sizes on an AMX CPU, where oneDNN's
        # conv weight gradient writes NaN at padding-only taps
        # (onednn_dw_repro.py)
        torch.backends.mkldnn.enabled = mkldnn


def runner_run(runner: str, n_data: int, n_model: int = 1,
               device: str = "cpu", keep: Sequence[str] = (),
               jsonl_only: bool = False, mkldnn: Optional[bool] = None,
               **kw) -> Dict:
    """``train.runner``'s `runner` (a function name) on a fresh mesh; the
    result's keys in `keep` (the trainer itself does not leave the
    process)."""
    from ..train import runner as runners

    _quiet_logger(jsonl_only, mkldnn)
    res = getattr(runners, runner)(
        mesh=make_mesh(n_data, n_model, device=device), **kw)
    return {k: res[k] for k in keep}


def cli_main(module: str, argv: Sequence[str], keep: Sequence[str] = (),
             jsonl_only: bool = False, mkldnn: Optional[bool] = None,
             with_counts: bool = False) -> Dict:
    """A CLI's ``main(argv)`` in a rank of a running process group (its
    runner's ``mesh="auto"`` takes every rank); the result's keys in
    `keep`, and with `with_counts` this rank's ``profiling.counts()``
    over the run under "counts"."""
    import importlib

    _quiet_logger(jsonl_only, mkldnn)
    profiling.reset_counts()
    res = importlib.import_module(module).main(list(argv))
    out = {k: res[k] for k in keep}
    if with_counts:
        out["counts"] = profiling.counts()
    return out
