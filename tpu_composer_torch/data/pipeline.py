"""Input pipeline: deterministic packed-LM batching and the device feed
(port of ``tpu_composer/data/pipeline.py``).

- ``PackedLMDataset`` is the JAX package's numpy packing, copied: fixed
  (batch, seq) token blocks, so every step has one shape.
- The stream is a pure function of (seed, epoch, step):
  ``state_dict()``/``load_state_dict()`` restore the exact position, and a
  restored run consumes the same batches the uninterrupted one would.
- ``ShardedLoader`` feeds one device. Its one-deep prefetch thread does
  host work only: it slices the batch and packs it into pinned (page-
  locked) host memory when the target is the card. The consumer issues
  the ``non_blocking`` copy, so the worker thread never touches the
  card's stream.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, Sequence

import numpy as np
import torch

from tpu_composer_torch.device import DeviceLike, resolve_device


class PackedLMDataset:
    """Pack variable-length token documents into fixed-size LM blocks.

    Documents are concatenated in a seeded per-epoch order, separated by
    ``eos_id``, and sliced into ``seq_len``-token blocks (the loss shifts
    inputs and targets itself, so batches are plain (B, S)). The tail that
    does not fill a block is dropped (at most seq_len - 1 tokens an
    epoch).
    """

    def __init__(
        self,
        documents: Sequence[Sequence[int]],
        seq_len: int,
        eos_id: int = 0,
        seed: int = 0,
    ):
        if seq_len < 1:
            raise ValueError(f"seq_len must be >= 1, got {seq_len}")
        if not documents:
            raise ValueError("documents must be non-empty")
        self._docs: List[np.ndarray] = [
            np.asarray(d, dtype=np.int32) for d in documents
        ]
        self.seq_len = seq_len
        self.eos_id = eos_id
        self.seed = seed
        self.blocks_per_epoch = (
            sum(len(d) + 1 for d in self._docs) // seq_len
        )

    def epoch_blocks(self, epoch: int) -> np.ndarray:
        """All (n_blocks, seq_len) blocks of one epoch, deterministically
        shuffled by (seed, epoch). Pure function — the resume anchor."""
        order = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch])
        ).permutation(len(self._docs))
        stream: List[np.ndarray] = []
        eos = np.array([self.eos_id], np.int32)
        for di in order:
            stream.append(self._docs[di])
            stream.append(eos)
        tokens = np.concatenate(stream)
        block = self.seq_len
        n_blocks = len(tokens) // block
        if n_blocks == 0:
            raise ValueError(
                f"epoch holds {len(tokens)} tokens < one block ({block})"
            )
        return tokens[: n_blocks * block].reshape(n_blocks, block)


class ShardedLoader:
    """Iterate (global_batch, seq_len) int32 token batches on ``device``
    (the card unless the caller asks for the CPU), with one-deep
    background prefetch.

    The stream is a pure function of one integer, the global batch step:
    every epoch packs the same token count, so ``batch(step)`` is
    ``epoch_blocks(step // bpe)[(step % bpe) * B : ...]``. Resume is exact
    by construction: ``state_dict()`` is ``{"step": n}``. Blocks past the
    last full batch of an epoch are dropped. The name is the JAX
    package's; on one card there is nothing to shard.
    """

    def __init__(
        self,
        dataset: PackedLMDataset,
        global_batch: int,
        device: DeviceLike = "cuda",
        prefetch: bool = True,
    ):
        if global_batch < 1:
            raise ValueError(f"global_batch must be >= 1, got {global_batch}")
        self.dataset = dataset
        self.global_batch = global_batch
        self.device = resolve_device(device)
        self.prefetch = prefetch
        self._step = 0
        n_blocks = dataset.blocks_per_epoch
        self.batches_per_epoch = n_blocks // global_batch
        if self.batches_per_epoch == 0:
            raise ValueError(
                f"epoch has {n_blocks} blocks < global_batch {global_batch}"
            )

    # -- resume ------------------------------------------------------------
    def state_dict(self) -> Dict[str, int]:
        return {"step": self._step}

    def load_state_dict(self, state: Dict[str, int]) -> None:
        self._step = int(state["step"])

    # -- iteration ---------------------------------------------------------
    def _host_batches(self, start_step: int) -> Iterator[tuple]:
        """Yield (step, host batch) from start_step on. Tracks its own
        cursor so a prefetching worker can run ahead of the consumer; the
        consumer commits self._step only for batches it yielded."""
        step = start_step
        blocks = None
        blocks_epoch = -1
        on_card = self.device.type == "cuda"
        while True:
            epoch, offset = divmod(step, self.batches_per_epoch)
            if epoch != blocks_epoch:
                blocks = self.dataset.epoch_blocks(epoch)
                blocks_epoch = epoch
            start = offset * self.global_batch
            batch = torch.from_numpy(
                blocks[start: start + self.global_batch].copy())
            yield step, batch.pin_memory() if on_card else batch
            step += 1

    def _place(self, batch: torch.Tensor) -> torch.Tensor:
        return batch.to(self.device, non_blocking=True)

    def __iter__(self):
        host = self._host_batches(self._step)
        if not self.prefetch:
            for s, b in host:
                out = self._place(b)
                self._step = s + 1
                yield out
            return
        # One-deep prefetch: the worker stays one host batch ahead. The
        # stop flag and the drain below keep it from outliving the
        # iterator.
        q: "queue.Queue" = queue.Queue(maxsize=1)
        stop = threading.Event()

        def worker():
            try:
                for item in host:
                    if stop.is_set():
                        return
                    q.put(item)
            except Exception as e:  # surface errors at the consumer
                q.put(e)

        t = threading.Thread(
            target=worker, name="data-pipeline-prefetch", daemon=True
        )
        t.start()
        try:
            while True:
                item = q.get()
                if isinstance(item, Exception):
                    raise item
                s, b = item
                out = self._place(b)
                self._step = s + 1
                yield out
        finally:
            stop.set()
            # Unblock a worker waiting on the full queue.
            try:
                q.get_nowait()
            except queue.Empty:
                pass
