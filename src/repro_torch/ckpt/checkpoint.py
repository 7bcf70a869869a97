"""Atomic, async checkpointing in numpy files: the counterpart of
``src/repro/ckpt/checkpoint.py``.

Layout (device-independent — the logical tensors are saved whole):

    <dir>/step_<N>/
        arrays.npz          flat {path: np.ndarray} of params + opt state
        meta.json           step, arch, config name, key manifest
        _COMPLETE           commit marker (atomicity: written LAST)

* save is atomic: writes to ``step_<N>.tmp`` then renames;
* ``AsyncCheckpointer.save_async`` copies to the host on the caller's
  thread and writes on a daemon thread — ``wait()`` joins;
* ``latest_step`` ignores uncommitted (crashed mid-write) checkpoints;
* ``restore`` rebuilds the caller's tree, each leaf on the target leaf's
  device and in its dtype.

A tree is nested dicts / lists / NamedTuples (or a ``ParamTree``) of tensors;
paths join keys with "/".  bfloat16 leaves are stored as float32 (exact;
numpy has no bfloat16 of its own) and cast back on restore.
"""

from __future__ import annotations

import json
import shutil
import threading
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch


def _children(tree: Any):
    if isinstance(tree, tuple) and hasattr(tree, "_asdict"):    # NamedTuple
        return tree._asdict().items()
    if hasattr(tree, "items"):
        return tree.items()
    if isinstance(tree, (list, torch.nn.ModuleList)):          # pre_layers
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _host(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(leaf)


def _flatten(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    kids = _children(tree)
    if kids is None:
        return {prefix: _host(tree)}
    flat: dict[str, np.ndarray] = {}
    for k, v in kids:
        flat.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return flat


def _write(directory: Path, step: int, flat: dict[str, np.ndarray],
           meta: dict | None) -> Path:
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:08d}"
    tmp = directory / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    np.savez(tmp / "arrays.npz", **flat)
    (tmp / "meta.json").write_text(json.dumps(
        {"step": step, "keys": sorted(flat), **(meta or {})}, indent=2))
    (tmp / "_COMPLETE").write_text(str(time.time()))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    return final


def save(directory: str | Path, step: int, tree: Any,
         meta: dict | None = None) -> Path:
    return _write(Path(directory), step, _flatten(tree), meta)


class AsyncCheckpointer:
    """Fire-and-forget saves on a background thread (one in flight)."""

    def __init__(self, directory: str | Path, keep_last: int = 3):
        self.directory = Path(directory)
        self.keep_last = keep_last
        self._thread: threading.Thread | None = None
        self.saved: list[int] = []

    def save_async(self, step: int, tree: Any, meta: dict | None = None):
        self.wait()
        flat = _flatten(tree)                      # device -> host, here

        def run():
            _write(self.directory, step, flat, meta)
            self.saved.append(step)
            self._gc()

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(all_steps(self.directory))
        for s in steps[:-self.keep_last]:
            shutil.rmtree(self.directory / f"step_{s:08d}", ignore_errors=True)


def all_steps(directory: str | Path) -> list[int]:
    directory = Path(directory)
    if not directory.exists():
        return []
    out = []
    for p in directory.iterdir():
        if p.name.startswith("step_") and not p.name.endswith(".tmp") \
                and (p / "_COMPLETE").exists():
            out.append(int(p.name.split("_")[1]))
    return sorted(out)


def latest_step(directory: str | Path) -> int | None:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def restore(directory: str | Path, step: int, target_tree: Any) -> Any:
    """Restore into the structure of ``target_tree``: every leaf comes back
    as a tensor on that leaf's device and in its dtype (dicts and
    ``ParamTree``s come back as dicts, NamedTuples as their type)."""
    path = Path(directory) / f"step_{step:08d}"
    if not (path / "_COMPLETE").exists():
        raise FileNotFoundError(f"checkpoint {path} is incomplete")
    with np.load(path / "arrays.npz") as data:
        return _rebuild(target_tree, data, "")


def _rebuild(tree: Any, data, prefix: str) -> Any:
    kids = _children(tree)
    if kids is None:
        arr = torch.from_numpy(np.array(data[prefix]))
        return arr.to(device=tree.device, dtype=tree.dtype)
    out = {k: _rebuild(v, data, f"{prefix}/{k}" if prefix else str(k))
           for k, v in kids}
    if isinstance(tree, tuple) and hasattr(tree, "_asdict"):
        return type(tree)(**out)
    if isinstance(tree, (list, torch.nn.ModuleList)):
        return list(out.values())
    return out


def load_meta(directory: str | Path, step: int) -> dict:
    return json.loads(
        (Path(directory) / f"step_{step:08d}" / "meta.json").read_text())
