"""Checkpointing: npz + manifest, atomic, async (port of
``repro.train.checkpoint``).

Layout (one directory per step), as the reference writes it:
  ckpt_dir/step_00000100.tmp/       <- written first
      manifest.json                  (step, leaf names, extra)
      shard_00000.npz                (leaf_i for the i-th name)
  ckpt_dir/step_00000100/           <- atomic rename on completion

Properties:
  * atomicity: readers only ever see fully written checkpoints (the rename
    is the commit point); a crashed writer leaves only a ``.tmp``
    directory, which the next manager garbage-collects;
  * async: ``save_async`` copies the tensors to the host on the caller's
    thread, then writes in a background thread, so the train loop waits
    only for the device-to-host copy;
  * retention: the ``keep`` most recent checkpoints are kept.

A tree is nested dicts, lists and tuples whose leaves are tensors, numpy
arrays or Python numbers (an optimizer's ``state_dict()`` is one); a
leaf's name is its path joined by ``/``. The training state
(``train_state_tree``) is the model's ``state_dict()`` under ``params/`` and
the optimizer's ``step``, ``m`` and ``v`` under ``opt/``, every name a port
key (``params/blocks.0.mixer.wq``). The reference's tree (group-stacked
blocks, ``opt_state/...``) is not read: ``convert.params_from_jax`` and
``convert.opt_state_from_jax`` carry a JAX state across instead.
bfloat16 leaves are stored as float32 (numpy has no bfloat16); a restore
casts every leaf to its target's dtype and device.
"""
from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..optim.adamw import full_value


def _flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out += _flatten(v, f"{prefix}/{k}" if prefix else str(k))
    return out


def _unflatten(tree: Any, leaves: Dict[str, Any], prefix: str = "") -> Any:
    def name(k):
        return f"{prefix}/{k}" if prefix else str(k)
    if isinstance(tree, dict):
        return {k: _unflatten(v, leaves, name(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves, name(i))
                          for i, v in enumerate(tree))
    return leaves[prefix]


def _to_host(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy().copy()
    return np.array(leaf)


class CheckpointManager:
    def __init__(self, directory, keep: int = 3) -> None:
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._gc_tmp()

    # ------------------------------------------------------------------ io
    def _gc_tmp(self) -> None:
        for p in self.dir.glob("*.tmp"):
            shutil.rmtree(p, ignore_errors=True)

    def _step_dir(self, step: int) -> Path:
        return self.dir / f"step_{step:08d}"

    def save(self, step: int, tree: Any, extra: Optional[Dict] = None
             ) -> Path:
        """Synchronous atomic save."""
        named = [(n, _to_host(v)) for n, v in _flatten(tree)]
        return self._write(step, named, extra or {})

    def save_async(self, step: int, tree: Any,
                   extra: Optional[Dict] = None) -> None:
        """Device-to-host copy now; file IO in a background thread."""
        self.wait()
        named = [(n, _to_host(v)) for n, v in _flatten(tree)]  # snapshot
        self._thread = threading.Thread(
            target=self._write, args=(step, named, extra or {}),
            daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, named: List[Tuple[str, np.ndarray]],
               extra: Dict) -> Path:
        tmp = self.dir / f"step_{step:08d}.tmp"
        final = self._step_dir(step)
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir(parents=True)
        np.savez(tmp / "shard_00000.npz",
                 **{f"leaf_{i}": v for i, (_, v) in enumerate(named)})
        manifest = {"step": step, "names": [n for n, _ in named],
                    "extra": extra}
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        shutil.rmtree(final, ignore_errors=True)
        tmp.rename(final)
        self._retain()
        return final

    def _retain(self) -> None:
        steps = self.available_steps()
        for s in steps[: max(len(steps) - self.keep, 0)]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -------------------------------------------------------------- restore
    def available_steps(self) -> List[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp" or not (p / "manifest.json").exists():
                continue
            out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.available_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target: Any) -> Tuple[Any, Dict]:
        """Restore into the structure of ``target``: each leaf gets the
        target leaf's dtype (and, for a tensor, its device). Returns
        ``(tree, extra)``. A leaf the checkpoint lacks raises ``KeyError``,
        a leaf of another shape ``ValueError``."""
        d = self._step_dir(step)
        manifest = json.loads((d / "manifest.json").read_text())
        with np.load(d / "shard_00000.npz") as data:
            by_name = {n: data[f"leaf_{i}"]
                       for i, n in enumerate(manifest["names"])}
        leaves = {}
        for name, leaf in _flatten(target):
            if name not in by_name:
                raise KeyError(f"checkpoint missing leaf {name}")
            arr = by_name[name]
            want = tuple(leaf.shape) if hasattr(leaf, "shape") \
                else np.shape(leaf)
            if tuple(arr.shape) != want:
                raise ValueError(f"shape mismatch for {name}: "
                                 f"{arr.shape} vs {want}")
            if isinstance(leaf, torch.Tensor):
                leaves[name] = torch.from_numpy(arr).to(device=leaf.device,
                                                        dtype=leaf.dtype)
            elif isinstance(leaf, (bool, int, float)):
                leaves[name] = type(leaf)(arr.item())
            else:
                leaves[name] = arr.astype(np.asarray(leaf).dtype)
        return _unflatten(target, leaves), manifest["extra"]


# ------------------------------------------------------- the train state

def train_state_tree(model: torch.nn.Module, optimizer) -> Dict[str, Any]:
    """The training state as a checkpoint tree: ``params`` (the model's
    ``state_dict()``) and ``opt`` (the optimizer's ``step``, ``m`` and
    ``v`` by parameter name). The tensors are the live ones: ``save``
    copies them, ``restore`` returns new ones. A DTensor (the sharded
    moments of a data-parallel run) is gathered whole, so every rank of
    its mesh calls this."""
    names = [n for n, _ in model.named_parameters()]
    st = optimizer.opt_state(names)
    full = {k: {n: full_value(t) for n, t in d.items()} for k, d in
            (("params", model.state_dict()), ("m", st.m), ("v", st.v))}
    return {"params": full["params"],
            "opt": {"step": torch.tensor(st.step), "m": full["m"],
                    "v": full["v"]}}


def load_train_state(model: torch.nn.Module, optimizer,
                     tree: Dict[str, Any]) -> int:
    """Load a restored ``train_state_tree`` into the model and optimizer;
    returns the optimizer's step."""
    from ..optim.adamw import OptState
    model.load_state_dict(tree["params"])
    opt = tree["opt"]
    names = [n for n, _ in model.named_parameters()]
    optimizer.load_opt_state(OptState(int(opt["step"]), opt["m"], opt["v"]),
                             names)
    return int(opt["step"])
