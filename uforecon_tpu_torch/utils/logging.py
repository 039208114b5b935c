"""Console logging and a scalar-metric writer.

A copy of the JAX package's ``utils/logging.py`` (reference
misc/utils.py:70-116 Log; the Lightning TensorBoardLogger of
main.py:195) without JAX. Scalars go to ``{logdir}/metrics.jsonl``, the
file the JAX writer mirrors its TensorBoard scalars to (TensorBoard's
package, where installed, pulls in TensorFlow: the port does not use it).
"""
from __future__ import annotations

import json
import os
import sys
from typing import Dict


class Log:
    """Coloured console logging (reference misc/utils.py:70-116)."""

    _C = {"info": "\033[0;36m", "warn": "\033[0;33m", "error": "\033[0;31m",
          "ok": "\033[0;32m"}
    _R = "\033[0m"

    @classmethod
    def _emit(cls, level: str, *msg) -> None:
        tty = sys.stdout.isatty()
        print(f"{cls._C[level] if tty else ''}[{level.upper():5s}]"
              f"{cls._R if tty else ''}", *msg, flush=True)

    @classmethod
    def info(cls, *msg):
        cls._emit("info", *msg)

    @classmethod
    def warn(cls, *msg):
        cls._emit("warn", *msg)

    @classmethod
    def error(cls, *msg):
        cls._emit("error", *msg)

    @classmethod
    def ok(cls, *msg):
        cls._emit("ok", *msg)


class MetricWriter:
    """Scalar metrics, one JSON line per call: ``{"step": N, name: value}``."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")

    def scalars(self, step: int, values: Dict[str, float]) -> None:
        rec = {"step": int(step)}
        rec.update({k: float(v) for k, v in values.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def close(self) -> None:
        self._jsonl.close()
