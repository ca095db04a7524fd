"""End-to-end LM training on one card: data pipeline -> train step ->
checkpoint/resume (the single-card counterpart of
``examples/train_lm.py``).

On the card (the default):

    python -m tpu_composer_torch.examples.train_lm

A quick local check on the CPU:

    python -m tpu_composer_torch.examples.train_lm --device cpu --steps 4

Sequence and tensor parallelism (``--sp``/``--tp`` > 1) need several
devices and wait for port slice 4.
"""

import argparse
import logging

import numpy as np
import torch

from tpu_composer_torch.data import PackedLMDataset
from tpu_composer_torch.device import resolve_device
from tpu_composer_torch.models.transformer import ModelConfig
from tpu_composer_torch.parallel.train import TrainConfig
from tpu_composer_torch.workload.trainer import fit


def zipf_documents(seed: int = 0, n_docs: int = 512, vocab: int = 1024):
    """Synthetic corpus: Zipf-ish random documents of 16-199 tokens,
    clipped to ``vocab``. Swap in real tokenized documents (any
    Sequence[Sequence[int]]) for actual training."""
    rng = np.random.default_rng(seed)
    return [rng.zipf(1.5, size=rng.integers(16, 200)).clip(0, vocab - 1)
            .tolist() for _ in range(n_docs)]


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", type=int, default=40)
    p.add_argument("--global-batch", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--checkpoint-dir", default="")
    p.add_argument("--sp", type=int, default=1, help="sequence-parallel axis")
    p.add_argument("--tp", type=int, default=1, help="tensor-parallel axis")
    p.add_argument("--n-kv-heads", type=int, default=0,
                   help="grouped-query kv heads (0 = MHA)")
    p.add_argument("--grad-accum", type=int, default=1,
                   help="sequential microbatches per optimizer update "
                        "(must divide the global batch)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args()
    if args.sp > 1 or args.tp > 1:
        p.error("--sp/--tp > 1 need several devices: port slice 4")

    device = resolve_device(args.device)  # raises without a card
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"device: {name}")

    dataset = PackedLMDataset(zipf_documents(), seq_len=args.seq_len, seed=0)

    tc = TrainConfig(
        model=ModelConfig(
            vocab_size=1024,
            d_model=256,
            n_layers=4,
            n_heads=8,
            n_kv_heads=args.n_kv_heads or None,
            d_ff=512,
            max_seq=args.seq_len,
            dtype=torch.bfloat16 if device.type == "cuda" else torch.float32,
        ),
        grad_accum_steps=args.grad_accum,
    )

    result = fit(
        tc, dataset,
        total_steps=args.steps,
        global_batch=args.global_batch,
        checkpoint_dir=args.checkpoint_dir or None,
        checkpoint_every=20 if args.checkpoint_dir else 0,
        log_every=10,
        device=device,
    )
    if result.history:
        last = result.history[-1]
        print(
            f"done: step {result.step} loss {last['loss']:.4f} "
            f"({last['steps_per_s']:.2f} steps/s"
            + (f", resumed from {result.resumed_from}" if result.resumed_from
               else "") + ")"
        )
    else:  # resume of an already-complete run: nothing left to train
        print(f"done: step {result.step} (already complete, nothing to do)")


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    main()
