"""Checkpoints with resume and a durable best-val slot (counterpart of
`vqvdb_tpu/train/checkpoint.py`, with the same methods and directories).

    <root>/step_<10-digit step>/state.pt      the whole TrainState
    <root>/step_<10-digit step>/metrics.json  the caller's metrics
    <root>/best/state.pt, best/metrics.json   the best-val state (+ "step")

`state.pt` is a `torch.save` of plain containers and tensors (params,
optimizer moments and counts, step), read back with `weights_only=True`
onto the template's device; a checkpoint whose tree or shapes differ from
the template raises ArtifactError. The rolling pool keeps the newest
`max_to_keep` steps; `save_best` writes `best/` (through `best.tmp/` and a
rename), which the pruner never touches. The JAX package's orbax
checkpoints are another format and are not read here.
"""

from __future__ import annotations

import json
import re
import shutil
from pathlib import Path
from typing import Any, Optional, Tuple, Union

import torch

from vqvdb_tpu_torch.train.train import TrainState, tree_leaves
from vqvdb_tpu_torch.utils.errors import ArtifactError

PathLike = Union[str, Path]

_STEP_RE = re.compile(r"^step_(\d+)$")
STATE_FILE = "state.pt"


def _to_saved(state: TrainState) -> dict:
    return {"params": state.params, "opt_state": state.opt_state, "step": int(state.step)}


def _structure(tree) -> Any:
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    return tuple(tree.shape) if isinstance(tree, torch.Tensor) else type(tree).__name__


class CheckpointManager:
    """Step-numbered checkpoints under a root dir, keeping the newest K."""

    def __init__(self, root: PathLike, *, max_to_keep: int = 3) -> None:
        self.root = Path(root).resolve()
        self.root.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    # -- save ------------------------------------------------------------
    def _write(self, path: Path, state: TrainState, metrics: Optional[dict]) -> None:
        if path.exists():
            shutil.rmtree(path)
        path.mkdir(parents=True)
        torch.save(_to_saved(state), path / STATE_FILE)
        if metrics is not None:
            (path / "metrics.json").write_text(json.dumps(metrics))

    def save(self, step: int, tree: TrainState, *, metrics: Optional[dict] = None) -> Path:
        path = self.root / f"step_{step:010d}"
        self._write(path, tree, metrics)
        self._prune()
        return path

    def save_best(self, step: int, tree: TrainState, *,
                  metrics: Optional[dict] = None) -> Path:
        """Write the best-val state to the durable `best/` slot."""
        path, tmp = self.root / "best", self.root / "best.tmp"
        self._write(tmp, tree, dict(metrics or {}, step=int(step)))
        if path.exists():
            shutil.rmtree(path)
        tmp.rename(path)
        return path

    def _prune(self) -> None:
        for s in self.all_steps()[: -self.max_to_keep]:
            shutil.rmtree(self.root / f"step_{s:010d}", ignore_errors=True)

    # -- restore ---------------------------------------------------------
    def all_steps(self) -> list:
        steps = []
        for p in self.root.iterdir():
            m = _STEP_RE.match(p.name)
            if m and p.is_dir():
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _read(self, path: Path, template: TrainState) -> TrainState:
        device = tree_leaves(template.params)[0].device
        if not (path / STATE_FILE).exists():
            raise ArtifactError(f"{path} holds no {STATE_FILE}: not a checkpoint of this "
                                "package (orbax checkpoints of the JAX package are not read)")
        saved = torch.load(path / STATE_FILE, map_location=device, weights_only=True)
        want = _structure(_to_saved(template))
        if _structure(saved) != want:
            raise ArtifactError(f"checkpoint {path} does not match the model's params "
                                "and optimizer state")
        return TrainState(saved["params"], saved["opt_state"], saved["step"])

    def restore(self, step: int, template: TrainState) -> TrainState:
        """Checkpoint `step`, checked against `template` and placed on its
        device."""
        return self._read(self.root / f"step_{step:010d}", template)

    def restore_latest(self, template: TrainState) -> Optional[Tuple[int, TrainState]]:
        step = self.latest_step()
        if step is None:
            return None
        return step, self.restore(step, template)

    def restore_best(self, template: TrainState) -> Optional[Tuple[int, TrainState]]:
        """The `best/` slot as (step, state), or None."""
        path = self.root / "best"
        if not path.exists():
            return None
        state = self._read(path, template)
        meta = self.read_best_metrics() or {}
        return int(meta.get("step", -1)), state

    def read_best_metrics(self) -> Optional[dict]:
        p = self.root / "best" / "metrics.json"
        return json.loads(p.read_text()) if p.exists() else None

    def read_metrics(self, step: int) -> Optional[dict]:
        p = self.root / f"step_{step:010d}" / "metrics.json"
        return json.loads(p.read_text()) if p.exists() else None
