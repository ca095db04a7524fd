"""Train-state checkpoints (port of
``tpu_composer/parallel/checkpoint.py``).

``save`` writes ``directory/step_<n>/state.pt`` (``torch.save``) into a
temporary directory beside it, adds the completion marker ``COMMITTED``
last, and renames the directory into place, so a crash leaves either a
whole checkpoint or none under its final name. ``latest_step`` counts
only step directories that hold the marker (the role of orbax's
``_CHECKPOINT_METADATA``), so a torn write on a store without atomic
rename is skipped. ``restore`` loads with ``weights_only=True`` onto the
device asked for. A checkpoint holds the whole state: over a mesh,
``trainer.fit`` has rank 0 save the gathered state and each rank keep
its shards of a restored one (``parallel/train.py``). Resharding a live
state onto another mesh comes with port slice 4b.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Any, Dict, Optional

import torch

from tpu_composer_torch.device import DeviceLike, resolve_device

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


def restore(directory: str, tc, device: DeviceLike = "cuda",
            step: Optional[int] = None) -> Dict[str, Any]:
    """``{"step": n, "state": {...}}`` of the checkpoint at ``step`` (default
    the newest complete one) on ``device``. Raises ``ValueError`` when the
    saved params do not fit ``tc.model`` (vocab, width, depth)."""
    dev = resolve_device(device)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(os.path.abspath(directory), f"step_{step}", _STATE)
    out = torch.load(path, map_location=dev, weights_only=True)
    params, c = out["state"]["params"], tc.model
    got = (*params["embed"].shape, len(params["layers"]))
    if got != (c.vocab_size, c.d_model, c.n_layers):
        raise ValueError(
            f"checkpoint {path} holds (vocab, d_model, layers) {got}, the"
            f" config wants {(c.vocab_size, c.d_model, c.n_layers)}")
    return {"step": int(out["step"]), "state": out["state"]}
