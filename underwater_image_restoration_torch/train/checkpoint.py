"""Checkpoints with best/latest tracking and full resume, the port's
counterpart of the JAX package's ``train/checkpoint.py`` (Orbax there,
``torch.save`` here).

Contents match the reference's torch.save payload (ModelTrainer.py:176-181:
epoch, model_state_dict, optimizer_state_dict, loss) plus the data loader's
iteration state, so a resumed run replays the exact remaining batch order:
``{params (the model's state_dict), opt_state (the optimizer's state_dict),
epoch, loss, loader, extra}``.

Layout: ``<dir>/<step>/state.pt`` beside ``<dir>/<step>/metrics.json``
(``{"val_loss": ...}``).  Each file is written to a temporary name and
moved into place with ``os.replace``, the metrics first, so a step with a
state always has its metrics and a killed save leaves no half-written
state.  ``max_to_keep`` keeps the newest steps, or with ``keep_best`` the
ones of least ``val_loss``.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Optional

import torch

STATE = "state.pt"
METRICS = "metrics.json"


def _abs(path: str) -> str:
    return os.path.abspath(os.path.expanduser(path))


def _replace_into(path: str, write):
    tmp = path + ".tmp"
    write(tmp)
    os.replace(tmp, path)


def _load(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: Optional[int] = None,
                 keep_best: bool = True):
        self.directory = _abs(directory)
        self.max_to_keep = max_to_keep
        self.keep_best = keep_best

    def all_steps(self) -> list:
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.exists(
                          os.path.join(self.directory, d, STATE)))

    def _val_loss(self, step: int) -> float:
        with open(os.path.join(self.directory, str(step), METRICS)) as f:
            return float(json.load(f)["val_loss"])

    def save(self, step: int, *, params, opt_state, epoch: int,
             val_loss: float, loader_state: Optional[dict] = None,
             extra: Optional[dict] = None):
        state = {
            "params": params,
            "opt_state": opt_state,
            "epoch": epoch,
            "loss": float(val_loss),
            "loader": loader_state or {},
            "extra": extra or {},
        }
        d = os.path.join(self.directory, str(step))
        os.makedirs(d, exist_ok=True)

        def metrics(tmp):
            with open(tmp, "w") as f:
                json.dump({"val_loss": float(val_loss)}, f)

        _replace_into(os.path.join(d, METRICS), metrics)
        _replace_into(os.path.join(d, STATE),
                      lambda tmp: torch.save(state, tmp))
        if self.max_to_keep:
            steps = self.all_steps()
            if self.keep_best:  # least val_loss first, the newer on a tie
                steps.sort(key=lambda s: (self._val_loss(s), -s))
            else:
                steps.reverse()
            for s in steps[self.max_to_keep:]:
                shutil.rmtree(os.path.join(self.directory, str(s)))

    def restore(self, step: Optional[int] = None) -> dict:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        return _load(os.path.join(self.directory, str(step), STATE))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def best_step(self) -> Optional[int]:
        steps = self.all_steps()
        return min(steps, key=lambda s: (self._val_loss(s), -s)) \
            if steps else None


def restore_params(path: str, step: Optional[int] = None):
    """Params-only restore for inference (reference
    Visualiser.loadModelFromWeights reads ['model_state_dict'],
    Visualiser.py:66).  ``path`` is a CheckpointManager directory (its
    latest step, or ``step``) or a single step directory."""
    path = _abs(path)
    if os.path.exists(os.path.join(path, STATE)):
        return _load(os.path.join(path, STATE))["params"]
    return CheckpointManager(path).restore(step)["params"]


def best_or_latest_params(directory: str):
    """(params, step): the step of least val_loss, or the latest."""
    mgr = CheckpointManager(_abs(directory))
    step = mgr.best_step()
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {mgr.directory}")
    return mgr.restore(step)["params"], step
