"""Experiment scaffolding: manifests, checkpoints, resume, metrics. The port
of ``learning_embeddings_tpu/train/experiment.py`` (lines 43-227):

* ``ExperimentDir``  — per-experiment layout <dir>/<name>/{weights,logs,stats}
* ``write_manifest`` / ``read_manifest`` — ``config_params.txt``: one sorted
  "key: value" line per key, the git commit and branch among them; the
  validate CLI rebuilds an experiment from this file, so the format is
  the contract (the bytes equal the JAX package's for the same dict)
* ``Checkpointer`` — one ``torch.save`` file per name under ``weights/``,
  with no extension: numbered epochs and ``best_model``, so
  ``"best_model" in os.listdir(weights)`` and ``epochs_on_disk``'s
  ``isdigit()`` hold as in the JAX package. The JAX package's orbax
  checkpoints are not read here (ROADMAP.md).
* ``MetricsLogger`` — tensorboard scalars where ``torch.utils.tensorboard``
  imports, and always a jsonl mirror with the same records.

Under a process group (a mesh run) only rank 0 writes: the manifest, the
checkpoints and the metrics; a checkpoint save ends in a barrier, so every
rank that reads it back after the save finds the whole file.
"""

from __future__ import annotations

import json
import os
import subprocess
import time
from typing import Any, Dict, Optional

import torch

from ..parallel.mesh import barrier, is_writer

__all__ = [
    "ExperimentDir",
    "write_manifest",
    "read_manifest",
    "Checkpointer",
    "MetricsLogger",
    "git_info",
    "load_checkpoint_file",
]


def git_info(repo_dir: Optional[str] = None) -> Dict[str, str]:
    """The commit and branch of the git checkout at `repo_dir` (default:
    the working directory); "unknown" where git cannot tell."""
    def run(*args):
        try:
            return subprocess.run(
                ["git", *args], cwd=repo_dir, capture_output=True, text=True,
                timeout=10).stdout.strip()
        except Exception:
            return "unknown"

    return {
        "git_commit": run("rev-parse", "HEAD"),
        "git_branch": run("rev-parse", "--abbrev-ref", "HEAD"),
    }


class ExperimentDir:
    def __init__(self, experiment_dir: str, experiment_name: str):
        self.root = os.path.join(experiment_dir, experiment_name)
        self.weights = os.path.join(self.root, "weights")
        self.logs = os.path.join(self.root, "logs")
        self.stats = os.path.join(self.root, "stats")
        for d in (self.root, self.weights, self.logs, self.stats):
            os.makedirs(d, exist_ok=True)

    @property
    def manifest_path(self) -> str:
        return os.path.join(self.root, "config_params.txt")


def write_manifest(exp: ExperimentDir, args: Dict[str, Any]) -> None:
    """'key: value' lines, sorted by key, with the git hash and branch
    (rank 0 writes; the others wait for the file)."""
    if is_writer():
        _write_manifest_file(exp, args)
    barrier()


def _write_manifest_file(exp: ExperimentDir, args: Dict[str, Any]) -> None:
    info = dict(args)
    info.update(git_info())
    with open(exp.manifest_path, "w") as f:
        for k in sorted(info):
            f.write(f"{k}: {info[k]}\n")


def read_manifest(path: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    with open(path) as f:
        for line in f:
            if ": " in line:
                k, v = line.rstrip("\n").split(": ", 1)
                out[k] = v
    return out


def load_checkpoint_file(path: str) -> Dict[str, Any]:
    """A checkpoint file's whole payload, tensors on the CPU: for reading
    another experiment's checkpoint (the --load_emb_from and
    --load_tower_from warm starts) as well as this one's."""
    return torch.load(path, map_location="cpu", weights_only=True)


class Checkpointer:
    """``torch.save`` checkpoints named as the reference names them:
    numbered epochs and 'best_model', each one file under ``weights/``."""

    def __init__(self, exp: ExperimentDir):
        self.dir = exp.weights

    def _path(self, name) -> str:
        return os.path.join(os.path.abspath(self.dir), str(name))

    def save(self, name, payload: Dict[str, Any], wait: bool = True) -> None:
        """Writes `payload` (tensors, optimizer state dicts, numbers) to
        weights/<name>, through a temporary file and a rename, so a reader
        never sees half a checkpoint. The write is synchronous, so `wait`
        changes nothing; it is kept for the JAX package's callers. Under a
        process group rank 0 writes and every rank waits for it."""
        if is_writer():
            path = self._path(name)
            tmp = os.path.join(os.path.dirname(path), f".{name}.tmp")
            torch.save(payload, tmp)
            os.replace(tmp, path)
        barrier()

    def wait_until_finished(self) -> None:
        """Nothing is in flight: every save returns when its file is
        written."""

    def load(self, name, like: Dict[str, Any]) -> Dict[str, Any]:
        """The checkpoint's entry for every key of the template `like`;
        keys the file lacks take the template's value (payloads gain
        bookkeeping keys over time, and older checkpoints predate them),
        and keys the template does not ask for are dropped. Tensors load
        on the CPU; ``load_state_dict`` moves them to the device."""
        raw = self.load_raw(name)
        return {k: (raw[k] if k in raw else like[k]) for k in like}

    def load_raw(self, name) -> Dict[str, Any]:
        """The whole payload, tensors on the CPU."""
        return load_checkpoint_file(self._path(name))

    def epochs_on_disk(self):
        out = []
        if os.path.isdir(self.dir):
            for d in os.listdir(self.dir):
                if d.isdigit():
                    out.append(int(d))
        return sorted(out)

    def find_existing_weights(self) -> Optional[int]:
        """Latest numbered checkpoint, for --resume."""
        epochs = self.epochs_on_disk()
        return epochs[-1] if epochs else None


class MetricsLogger:
    """Tensorboard scalars (with `use_tensorboard`, where tensorboard
    imports) + a jsonl mirror (metrics stay greppable without
    tensorboard); on rank 0 only."""

    def __init__(self, exp: ExperimentDir, use_tensorboard: bool = True):
        self.jsonl_path = os.path.join(exp.logs, "metrics.jsonl")
        self.writes = is_writer()
        self._tb = None
        if not (self.writes and use_tensorboard):
            return
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(log_dir=exp.logs)
        except Exception:
            self._tb = None

    def scalar(self, tag: str, value: float, step: int) -> None:
        if not self.writes:
            return
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps({"tag": tag, "value": float(value),
                                "step": int(step), "t": time.time()}) + "\n")

    def scalars(self, prefix: str, values: Dict[str, float], step: int) -> None:
        for k, v in values.items():
            self.scalar(f"{prefix}/{k}", v, step)

    def close(self):
        if self._tb is not None:
            self._tb.flush()
            self._tb.close()
