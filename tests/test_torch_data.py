"""Port parity for the training loop's pieces: the packed-LM dataset and
its loader against the JAX package's (integer for integer), checkpoints,
and ``fit`` (twins of tests/test_data.py and tests/test_checkpoint.py,
on the CPU).

Tolerances: token blocks and batches exact; a checkpoint round trip
exact; kill-resume lands on the uninterrupted run's loss within 1e-5,
as in tests/test_data.py.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tpu_composer.data import PackedLMDataset as JaxDataset
from tpu_composer.data import ShardedLoader as JaxLoader
from tpu_composer_torch.data import PackedLMDataset, ShardedLoader
from tpu_composer_torch.models.transformer import ModelConfig
from tpu_composer_torch.parallel import checkpoint as ckpt
from tpu_composer_torch.parallel.train import (
    TrainConfig,
    make_train_state,
    make_train_step,
    tree_leaves,
)
from tpu_composer_torch.workload.trainer import fit

torch.set_num_threads(1)


def make_docs(n=40, seed=3):
    rng = np.random.default_rng(seed)
    return [
        rng.integers(1, 100, size=rng.integers(3, 30)).tolist()
        for _ in range(n)
    ]


def loader(ds, batch, prefetch=False):
    return ShardedLoader(ds, global_batch=batch, device="cpu",
                         prefetch=prefetch)


# -- the dataset and the loader -----------------------------------------------

@pytest.mark.parametrize("seq_len,seed,eos", [(16, 1, 0), (7, 5, 99)])
def test_epoch_blocks_equal_jax(seq_len, seed, eos):
    docs = make_docs()
    ours = PackedLMDataset(docs, seq_len=seq_len, eos_id=eos, seed=seed)
    ref = JaxDataset(docs, seq_len=seq_len, eos_id=eos, seed=seed)
    assert ours.blocks_per_epoch == ref.blocks_per_epoch
    for epoch in range(3):
        a, b = ours.epoch_blocks(epoch), ref.epoch_blocks(epoch)
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


def test_rejects_empty_and_tiny():
    with pytest.raises(ValueError):
        PackedLMDataset([], seq_len=8)
    with pytest.raises(ValueError):
        PackedLMDataset([[1]], seq_len=0)
    with pytest.raises(ValueError):
        PackedLMDataset([[1, 2]], seq_len=512).epoch_blocks(0)
    ds = PackedLMDataset(make_docs(4), seq_len=16)
    with pytest.raises(ValueError, match="global_batch"):
        ShardedLoader(ds, global_batch=0, device="cpu")
    with pytest.raises(ValueError, match="blocks < global_batch"):
        ShardedLoader(ds, global_batch=1000, device="cpu")


def test_loader_stream_equals_jax():
    docs = make_docs(12)
    ours = loader(PackedLMDataset(docs, seq_len=16, seed=1), 2)
    ref = JaxLoader(JaxDataset(docs, seq_len=16, seed=1), global_batch=2,
                    prefetch=False)
    n = ours.batches_per_epoch + 3  # across an epoch boundary
    assert n - 3 == ref.batches_per_epoch
    for (_, a), (_, b) in zip(zip(range(n), iter(ours)),
                              zip(range(n), iter(ref))):
        assert a.dtype == torch.int32 and a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_stream_is_pure_function_of_step():
    ds = PackedLMDataset(make_docs(), seq_len=16, seed=1)
    a = loader(ds, 4)
    first8 = [b.clone() for _, b in zip(range(8), iter(a))]
    assert a.state_dict() == {"step": 8}
    b = loader(ds, 4)
    b.load_state_dict({"step": 5})
    resumed = [x for _, x in zip(range(3), iter(b))]
    for i, r in enumerate(resumed):
        assert torch.equal(r, first8[5 + i])


def test_prefetch_matches_sync_and_tracks_consumed():
    ds = PackedLMDataset(make_docs(), seq_len=16, seed=2)
    sync = loader(ds, 4)
    pre = loader(ds, 4, prefetch=True)
    s_batches = [b for _, b in zip(range(6), iter(sync))]
    it = iter(pre)
    p_batches = [b for _, b in zip(range(6), it)]
    for a, b in zip(s_batches, p_batches):
        assert torch.equal(a, b)
    # state counts consumed batches, though the worker prefetched one more
    assert pre.state_dict() == {"step": 6}
    it.close()


def test_epoch_rollover():
    ds = PackedLMDataset(make_docs(10), seq_len=16, seed=0)
    ld = loader(ds, 2)
    n = ld.batches_per_epoch + 2
    batches = [b for _, b in zip(range(n), iter(ld))]
    assert len(batches) == n
    assert ld.state_dict() == {"step": n}


# -- checkpoints --------------------------------------------------------------

@pytest.fixture(scope="module")
def tc():
    return TrainConfig(model=ModelConfig(
        vocab_size=256, d_model=64, n_layers=2, n_heads=4, d_ff=128,
        max_seq=32, dtype=torch.float32))


def test_checkpoint_roundtrip(tc, tmp_path):
    state = make_train_state(tc, seed=0, device="cpu")
    state, _ = make_train_step(tc)(
        state, torch.randint(0, 256, (2, 32), dtype=torch.int32))
    path = ckpt.save(str(tmp_path), state, step=3)
    assert path.endswith("step_3")
    assert ckpt.latest_step(str(tmp_path)) == 3
    out = ckpt.restore(str(tmp_path), tc, "cpu")
    assert out["step"] == 3
    assert int(out["state"]["opt"]["count"]) == 1
    got, want = tree_leaves(out["state"]), tree_leaves(state)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(FileExistsError):
        ckpt.save(str(tmp_path), state, step=3)
    other = TrainConfig(model=ModelConfig(
        vocab_size=128, d_model=64, n_layers=2, n_heads=4, d_ff=128))
    with pytest.raises(ValueError, match="config wants"):
        ckpt.restore(str(tmp_path), other, "cpu")


def test_missing_directory_raises(tc, tmp_path):
    assert ckpt.latest_step(str(tmp_path / "nope")) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "nope"), tc, "cpu")


def test_partial_checkpoint_is_skipped(tc, tmp_path):
    """A crash mid-save leaves a step dir without the completion marker;
    restore falls back to the last complete step, and a later save of
    that step replaces the torn one."""
    state = make_train_state(tc, seed=0, device="cpu")
    ckpt.save(str(tmp_path), state, step=4)
    partial = tmp_path / "step_5"
    partial.mkdir()
    (partial / "state.pt").write_text("torn")
    assert ckpt.latest_step(str(tmp_path)) == 4
    assert ckpt.restore(str(tmp_path), tc, "cpu")["step"] == 4
    ckpt.save(str(tmp_path), state, step=5)
    assert ckpt.latest_step(str(tmp_path)) == 5
    assert ckpt.restore(str(tmp_path), tc, "cpu")["step"] == 5


# -- fit ---------------------------------------------------------------------

def _fit_setup():
    tc = TrainConfig(model=ModelConfig(
        vocab_size=128, d_model=64, n_layers=2, n_heads=4, d_ff=96,
        max_seq=32, dtype=torch.float32))
    ds = PackedLMDataset(make_docs(60, seed=9), seq_len=32, seed=4)
    return tc, ds


def test_fit_trains_and_logs():
    tc, ds = _fit_setup()
    res = fit(tc, ds, total_steps=6, global_batch=4, log_every=3,
              device="cpu")
    assert res.step == 6
    assert res.resumed_from is None
    assert len(res.history) == 2
    assert [r["step"] for r in res.history] == [3.0, 6.0]
    assert all(np.isfinite(r["loss"]) for r in res.history)
    assert res.history[-1]["loss"] < res.history[0]["loss"]


def test_kill_resume_is_bit_continuous(tmp_path):
    """6 steps straight against 3 steps + kill + resume for 3 more: the
    resumed run lands on the same loss (same params, same batches)."""
    tc, ds = _fit_setup()
    straight = fit(tc, ds, total_steps=6, global_batch=4, log_every=6,
                   device="cpu")
    cdir = str(tmp_path / "ckpt")
    first = fit(tc, ds, total_steps=3, global_batch=4, checkpoint_dir=cdir,
                checkpoint_every=3, log_every=3, device="cpu")
    assert first.step == 3
    second = fit(tc, ds, total_steps=6, global_batch=4, checkpoint_dir=cdir,
                 checkpoint_every=3, log_every=6, device="cpu")
    assert second.resumed_from == 3
    assert second.step == 6
    assert abs(second.history[-1]["loss"]
               - straight.history[-1]["loss"]) < 1e-5
    # Resuming a finished run trains nothing and saves nothing new.
    again = fit(tc, ds, total_steps=6, global_batch=4, checkpoint_dir=cdir,
                checkpoint_every=3, log_every=6, device="cpu")
    assert again.resumed_from == 6 and again.step == 6
    assert again.history == []


def test_fit_needs_a_checkpoint_dir_to_checkpoint():
    tc, ds = _fit_setup()
    with pytest.raises(ValueError, match="checkpoint_dir"):
        fit(tc, ds, total_steps=1, global_batch=4, checkpoint_every=1,
            device="cpu")
