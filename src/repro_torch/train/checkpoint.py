"""Checkpoint/restart for training jobs (port of ``repro.train.checkpoint``).

The data needs no checkpoint: it lives in the log and is re-readable by
offset. What is saved is the model/optimizer state and the stream offsets
consumed so far, so a restarted job resumes exactly where a killed one
died.

The format is the JAX package's, byte for byte where it matters: a
``step_{n}`` directory holding ``arrays.npz`` (one array per leaf under
the flat key ``_flatten`` makes, ``"params/slots/s0/mixer/wq"``,
``"opt/step"``; bf16 stored as f32, losslessly) and ``manifest.json``
(step, offsets, meta), written to ``step_{n}.tmp`` and renamed into place.
So a checkpoint written by either package restores in the other.

Differences that belong to PyTorch: :func:`restore` copies each array
into the template's own tensor (its dtype and device) in place and
returns the template, so a restored state costs no second copy on the
card; ``CheckpointManager.save_async`` copies the state to the host
before it returns and writes on a background thread.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Mapping

import numpy as np
import torch

__all__ = ["CheckpointManager", "latest_step", "restore", "save"]

_STEP_RE = re.compile(r"^step_(\d+)$")


def _items(tree: Any, prefix: tuple = ()):
    """(path, leaf) pairs in JAX's flattening order: dict keys sorted,
    list and tuple entries by index."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, prefix + (f"[{i}]",))
    else:
        yield prefix, tree


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()  # numpy has no bf16: stored as f32, losslessly
        return t.numpy()
    return np.asarray(leaf)


def _flatten(tree: Any) -> dict[str, np.ndarray]:
    return {"/".join(path): _to_numpy(leaf) for path, leaf in _items(tree)}


def save(
    ckpt_dir: str,
    step: int,
    state: Any,
    *,
    offsets: Mapping[str, int] | None = None,
    meta: Mapping[str, Any] | None = None,
) -> str:
    """Synchronous atomic save. Returns the checkpoint path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays = _flatten(state)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {
        "step": step,
        "offsets": dict(offsets or {}),
        "meta": dict(meta or {}),
        "treedef": None,  # restored against a template tree
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [
        int(m.group(1))
        for d in os.listdir(ckpt_dir)
        if (m := _STEP_RE.match(d)) and os.path.isdir(os.path.join(ckpt_dir, d))
    ]
    return max(steps) if steps else None


@torch.no_grad()
def restore(
    ckpt_dir: str, template: Any, step: int | None = None
) -> tuple[Any, dict[str, int], dict[str, Any]]:
    """Restore (state, offsets, meta).

    ``template`` gives the tree; each of its tensors is filled in place
    (cast to its dtype, on its device) and the template is returned as
    the state.
    """
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as z:
        for keys, leaf in _items(template):
            key = "/".join(keys)
            src = torch.from_numpy(np.array(z[key]))  # (ascontiguousarray would make a 0-d leaf 1-d)
            if tuple(src.shape) != tuple(leaf.shape):
                raise ValueError(f"{key}: checkpoint shape {tuple(src.shape)} != template {tuple(leaf.shape)}")
            leaf.copy_(src.to(leaf.dtype))
    return template, dict(manifest.get("offsets", {})), dict(manifest.get("meta", {}))


class CheckpointManager:
    """Async checkpointing with retention.

    ``save_async`` copies the state to the host (the only synchronous
    part) and writes it on a daemon thread; ``wait`` joins the write in
    flight (before exit and in tests).
    """

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: threading.Thread | None = None
        os.makedirs(ckpt_dir, exist_ok=True)

    def save_async(self, step: int, state: Any, *, offsets=None, meta=None) -> None:
        self.wait()
        host_state = {"/".join(k): _to_numpy(v) for k, v in _items(state)}  # device -> host now

        def _write():
            save(self.ckpt_dir, step, host_state, offsets=offsets, meta=meta)
            self._gc()

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = sorted(
            int(m.group(1))
            for d in os.listdir(self.ckpt_dir)
            if (m := _STEP_RE.match(d))
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s}"), ignore_errors=True)

    def latest(self) -> int | None:
        return latest_step(self.ckpt_dir)
