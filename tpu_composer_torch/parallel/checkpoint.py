"""Train-state checkpoints (port of
``tpu_composer/parallel/checkpoint.py``).

``save`` writes ``directory/step_<n>/state.pt`` (``torch.save``) into a
temporary directory beside it, adds the completion marker ``COMMITTED``
last, and renames the directory into place, so a crash leaves either a
whole checkpoint or none under its final name. ``latest_step`` counts
only step directories that hold the marker (the role of orbax's
``_CHECKPOINT_METADATA``), so a torn write on a store without atomic
rename is skipped. ``restore`` maps the file (``weights_only=True``)
and copies onto the device asked for. A checkpoint holds the whole
state: over a mesh, ``trainer.fit`` has rank 0 save the gathered state,
and ``restore`` with a mesh keeps each rank's shards of it for that
mesh, which need not be the mesh that saved it (a live state moves with
``train.reshard_train_state``).
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Any, Dict, Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from tpu_composer_torch.device import DeviceLike, resolve_device
from tpu_composer_torch.parallel.train import (
    abstract_train_state,
    pipelined,
    shard_state,
    tree_leaves,
    tree_map,
)

MARKER = "COMMITTED"
_STATE = "state.pt"


def save(directory: str, state: Dict[str, Any], step: int) -> str:
    """Write one checkpoint under ``directory/step_<n>``; returns its
    path. Synchronous. A complete checkpoint at that step is never
    overwritten (``FileExistsError``); a torn one is replaced."""
    root = os.path.abspath(directory)
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, f"step_{step}")
    if os.path.exists(os.path.join(path, MARKER)):
        raise FileExistsError(f"checkpoint {path} already exists")
    tmp = tempfile.mkdtemp(prefix=f".step_{step}.", dir=root)
    try:
        torch.save({"step": step, "state": state}, os.path.join(tmp, _STATE))
        with open(os.path.join(tmp, MARKER), "w"):
            pass
        if os.path.exists(path):
            shutil.rmtree(path)  # a torn write without the marker
        os.rename(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return path


def latest_step(directory: str) -> Optional[int]:
    """Highest step with a complete checkpoint, or None."""
    root = os.path.abspath(directory)
    try:
        entries = os.listdir(root)
    except FileNotFoundError:
        return None
    steps = [int(e[5:]) for e in entries
             if e.startswith("step_") and e[5:].isdigit()
             and os.path.exists(os.path.join(root, e, MARKER))]
    return max(steps) if steps else None


def _layout(params) -> tuple:
    """(vocab, d_model, layers, "stacked" | "list") of a param tree."""
    layers = params["layers"]
    if isinstance(layers, dict):
        return (*params["embed"].shape, len(next(iter(layers.values()))),
                "stacked")
    return (*params["embed"].shape, len(layers), "list")


def restore(directory: str, tc, device: DeviceLike = "cuda",
            step: Optional[int] = None,
            mesh: Optional[DeviceMesh] = None) -> Dict[str, Any]:
    """``{"step": n, "state": {...}}`` of the checkpoint at ``step`` (default
    the newest complete one): the whole state on ``device``, or with
    ``mesh`` this rank's shards of it, laid out for that mesh, whichever
    mesh saved it. The file is mapped, not read (``mmap=True``), so only
    the shards a rank keeps are copied. Raises ``ValueError`` when the
    saved state does not fit ``tc`` on ``mesh``: vocab, width, depth,
    stacked or listed layers (a pipelined mesh stacks them), then every
    leaf's shard shape and dtype against :func:`abstract_train_state`."""
    dev = resolve_device(device)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(os.path.abspath(directory), f"step_{step}", _STATE)
    out = torch.load(path, map_location="cpu", mmap=True, weights_only=True)
    saved, c = out["state"], tc.model
    got = _layout(saved["params"])
    want = (c.vocab_size, c.d_model, c.n_layers,
            "stacked" if pipelined(tc, mesh) else "list")
    if got != want:
        raise ValueError(
            f"checkpoint {path} holds (vocab, d_model, layers, layout)"
            f" {got}, the config wants {want} on this mesh")
    local = shard_state(tc, saved, mesh, "cpu")
    have, like = tree_leaves(local), tree_leaves(abstract_train_state(tc,
                                                                      mesh))
    bad = [(tuple(a.shape), a.dtype, tuple(b.shape), b.dtype)
           for a, b in zip(have, like)
           if a.shape != b.shape or a.dtype != b.dtype]
    if bad or len(have) != len(like):
        raise ValueError(
            f"checkpoint {path}: {len(have)} leaves, the config wants"
            f" {len(like)}; (saved shape, dtype, wanted shape, dtype) of"
            f" the first that differ: {bad[:3]}")
    return {"step": int(out["step"]),
            "state": tree_map(lambda t: t.to(dev, copy=True), local)}
