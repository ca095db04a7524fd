"""Training loop: loader, train step and checkpoint/resume tied into one
resumable ``fit`` call on one card (port of
``tpu_composer/workload/trainer.py``).

- **One source of truth for progress**: the checkpointed step. On resume
  the loader is fast-forwarded to exactly that step (the data stream is
  a pure function of the step), so the restored run consumes the same
  batches the uninterrupted run would have.
- **Few host syncs**: metrics are read on the host only at log points
  and checkpoints written every ``checkpoint_every`` steps; between them
  the steps stay queued on the device (no per-step ``loss.item()``).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from tpu_composer_torch.data.pipeline import PackedLMDataset, ShardedLoader
from tpu_composer_torch.device import DeviceLike, resolve_device
from tpu_composer_torch.parallel import checkpoint as ckpt
from tpu_composer_torch.parallel.train import (
    TrainConfig,
    make_train_state,
    make_train_step,
)

log = logging.getLogger("tpu_composer_torch.trainer")


@dataclass
class FitResult:
    state: Dict[str, Any]
    step: int
    history: List[Dict[str, float]] = field(default_factory=list)
    resumed_from: Optional[int] = None


def _host(metrics: Dict) -> Dict[str, float]:
    """The metrics on the host: a sync with the device."""
    return {"loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"])}


def fit(
    tc: TrainConfig,
    dataset: PackedLMDataset,
    total_steps: int,
    global_batch: int,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 0,
    log_every: int = 10,
    seed: int = 0,
    device: DeviceLike = "cuda",
) -> FitResult:
    """Train for ``total_steps`` optimizer steps, resuming from the newest
    complete checkpoint under ``checkpoint_dir`` when one exists.

    Returns the final state, the step reached, and the logged metric
    history (step, loss, grad_norm, steps_per_s at each log point).
    """
    if checkpoint_every and not checkpoint_dir:
        raise ValueError("checkpoint_every needs checkpoint_dir")
    dev = resolve_device(device)
    step_fn = make_train_step(tc)
    loader = ShardedLoader(dataset, global_batch, device=dev)

    start_step = 0
    resumed_from: Optional[int] = None
    if checkpoint_dir and (latest := ckpt.latest_step(checkpoint_dir)) is not None:
        restored = ckpt.restore(checkpoint_dir, tc, dev, step=latest)
        state = restored["state"]
        start_step = int(restored["step"])
        resumed_from = start_step
        log.info("resumed from %s at step %d", checkpoint_dir, start_step)
    else:
        state = make_train_state(tc, seed, dev)
    loader.load_state_dict({"step": start_step})

    history: List[Dict[str, float]] = []
    step = start_step
    # A checkpoint already exists at the resume step: the trailing save
    # must not write it again.
    last_saved = start_step if resumed_from is not None else -1
    t_mark = time.perf_counter()
    step_mark = step
    metrics = None
    batches = iter(loader)
    while step < total_steps:
        # Pull only when a step will run: a for-in loop would pack (and
        # prefetch) one batch past the end.
        batch = next(batches)
        state, metrics = step_fn(state, batch)
        step += 1
        if log_every and (step % log_every == 0 or step == total_steps):
            # The only host sync point: read the latest metrics once.
            m = _host(metrics)
            now = time.perf_counter()
            rec = {"step": float(step), **m,
                   "steps_per_s": (step - step_mark) / max(now - t_mark, 1e-9)}
            history.append(rec)
            log.info(
                "step %d loss %.4f grad_norm %.3f %.2f steps/s",
                step, rec["loss"], rec["grad_norm"], rec["steps_per_s"],
            )
            t_mark, step_mark = now, step
        if checkpoint_every and step % checkpoint_every == 0:
            ckpt.save(checkpoint_dir, state, step=step)
            last_saved = step
    batches.close()  # stops the prefetch thread
    if checkpoint_every and step > last_saved and step > 0:
        ckpt.save(checkpoint_dir, state, step=step)
    if metrics is not None and not history:
        history.append({"step": float(step), **_host(metrics),
                        "steps_per_s": 0.0})
    return FitResult(
        state=state, step=step, history=history, resumed_from=resumed_from
    )
