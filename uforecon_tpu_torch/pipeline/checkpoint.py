"""Checkpoints with the JAX package's retention semantics, on ``torch.save``
files.

Counterpart of the JAX package's ``pipeline/checkpoint.py`` (reference
main.py:197-203 ModelCheckpoint: monitor ``val/loss_depth_fine``, mode
min, top 15, plus loading for evaluation, main.py:186-188). A checkpoint
is ``{dir}/step_{N}.pt``; ``index.json`` keeps each step's monitored
metric so that retention and the best step survive restarts.

The fit loop saves ``{"state_dict": model.state_dict(), "optimizer": ...,
"step": N}``, which ``convert.load_weights`` (and so ``cli.run
--load_ckpt``) reads as it reads a Lightning checkpoint's ``state_dict``.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import torch


def _load(path: str) -> Any:
    return torch.load(path, map_location="cpu", weights_only=True)


class CheckpointManager:
    def __init__(self, directory: str, monitor: str = "val/loss_depth_fine",
                 mode: str = "min", save_top_k: int = 15):
        self.dir = os.path.abspath(directory)
        os.makedirs(self.dir, exist_ok=True)
        self.monitor = monitor
        self.mode = mode
        self.top_k = save_top_k
        self._index_path = os.path.join(self.dir, "index.json")
        self._index: Dict[str, Dict] = {}
        if os.path.exists(self._index_path):
            with open(self._index_path) as f:
                self._index = json.load(f)

    def _flush_index(self) -> None:
        with open(self._index_path, "w") as f:
            json.dump(self._index, f, indent=1)

    def path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step}.pt")

    def _score(self, rec: Dict) -> float:
        v = rec.get("metric")
        if v is None:
            return float("inf")
        return v if self.mode == "min" else -v

    def save(self, step: int, state: Any,
             metrics: Optional[Dict[str, float]] = None) -> str:
        """Save ``state`` (anything ``torch.save`` takes) and keep only the
        top k steps by the monitored metric, and always the latest."""
        path = self.path(step)
        torch.save(state, path)
        metric = None
        if metrics and self.monitor in metrics:
            metric = float(metrics[self.monitor])
        self._index[str(step)] = {"metric": metric,
                                  "metrics": {k: float(v) for k, v in (metrics or {}).items()}}
        steps = sorted(self._index, key=int)
        ranked = sorted(steps, key=lambda s: self._score(self._index[s]))
        keep = set(ranked[: self.top_k]) | {steps[-1]}
        for s in steps:
            if s not in keep:
                if os.path.exists(self.path(int(s))):
                    os.remove(self.path(int(s)))
                del self._index[s]
        self._flush_index()
        return path

    def best_step(self) -> Optional[int]:
        scored = [s for s in self._index if self._index[s].get("metric") is not None]
        if not scored:
            return int(max(self._index, key=int)) if self._index else None
        return int(min(scored, key=lambda s: self._score(self._index[s])))

    def latest_step(self) -> Optional[int]:
        present = [s for s in self._index if os.path.exists(self.path(int(s)))]
        return int(max(present, key=int)) if present else None

    def restore(self, step: Optional[int] = None) -> Any:
        """The saved object of ``step`` (default: the latest), on the CPU."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        return _load(self.path(step))


def save_params(path: str, params: Any) -> None:
    """One-shot save (no retention) for tools and tests."""
    torch.save(params, os.path.abspath(path))


def load_params(path: str) -> Any:
    return _load(os.path.abspath(path))


def load_eval_variables(path: str) -> Dict[str, torch.Tensor]:
    """The model state dict of a checkpoint file: a bare state dict or a
    saved training state (``{"state_dict": ...}``, as the fit loop writes)."""
    restored = load_params(path)
    if isinstance(restored, dict) and "state_dict" in restored:
        return restored["state_dict"]
    return restored
