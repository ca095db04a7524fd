"""Live reshard and restore onto another mesh (``reshard_train_state``,
``abstract_train_state`` and ``checkpoint.restore(mesh=...)`` of the
port): twins of ``tests/test_reshard.py``'s grow and shrink and of
``tests/test_checkpoint.py``'s restore onto a grown mesh.

One gloo world of 4 CPU ranks (``tests/torch_dist.py``) holds both
meshes of each case: a 2-rank mesh over ranks 0-1 (``make_mesh(...,
ranks=...)``) and a 4-rank one over the world, as the JAX tests hold a
4-device and an 8-device mesh over the 8 host devices. The contract is
the JAX tests': the resized run's losses equal the never-resized run's
within 2e-4 relative (``tests/test_reshard.py:74``), and training
progresses.

``tests/test_reshard.py``'s operator-driven case runs in the same world
(``test_operator_resize_drives_reshard``): rank 0 runs the port's
threaded operator over fake nodes, an H100 request grows from 2 to 4
GPUs, rank 0's watch (not a poll) sees it Running with 4 and broadcasts
the count, and every rank reshards the live state from the mesh of 2
onto the mesh of 4; the losses equal the never-resized run's within
2e-4 relative, the JAX test's tolerance.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tests.torch_dist import World
from tpu_composer_torch.models.transformer import ModelConfig
from tpu_composer_torch.parallel import train as ttrain

torch.set_num_threads(1)

N = 4
# tests/test_reshard.py's model.
MODEL = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, d_ff=128,
             max_seq=32, dtype="float32")
TWO, FOUR = [0, 1], None  # the ranks of the small mesh; the world


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(N, str(tmp_path_factory.mktemp("world")))
    yield w
    w.close()


def test_mesh_over_some_ranks(world):
    """``make_mesh(..., ranks=...)``: the ranks in it get their
    coordinates in mesh order; a rank outside it is told so, not given
    a 0; every rank reads the mesh's shape."""
    res = world.run("submesh_coords", {"dp": 1, "tp": 2}, [1, 3])
    for rank, (inside, got, shape, bad) in enumerate(res):
        assert shape == {"dp": 1, "tp": 2}
        assert inside == (rank in (1, 3))
        if inside:
            assert got == {"dp": 0, "tp": [1, 3].index(rank)}
        else:
            assert got.startswith("ValueError") and "not in the mesh" in got
        # Ranks the world lacks, and ranks out of order, are refused.
        assert all("distinct ranks of the world of 4 in increasing order"
                   in msg for msg in bad), bad


RESHARD_CASES = [
    # (train config, source (axes, ranks), target (axes, ranks), steps
    # before, steps after)
    pytest.param({}, ({"tp": 2}, TWO), ({"dp": 2, "tp": 2}, FOUR), 3, 2,
                 id="grow_2_to_4"),
    pytest.param({}, ({"dp": 2, "tp": 2}, FOUR), ({"tp": 2}, TWO), 2, 2,
                 id="shrink_4_to_2"),
    pytest.param({"pipeline_microbatches": 2}, ({"pp": 2}, TWO),
                 ({"dp": 2, "pp": 2}, FOUR), 2, 2, id="grow_pipelined"),
    # Each shard of the target is a part of one of the source's.
    pytest.param({}, ({"tp": 2}, TWO), ({"tp": 4}, FOUR), 2, 1,
                 id="split_tp2_to_tp4"),
    # Each shard of the target joins parts of two of the source's, and
    # the target's ranks are not the source's first ones.
    pytest.param({}, ({"tp": 4}, FOUR), ({"tp": 2}, [2, 3]), 2, 1,
                 id="join_tp4_to_tp2_on_ranks_2_3"),
    pytest.param({"pipeline_microbatches": 2}, ({"dp": 2, "pp": 2}, FOUR),
                 ({"pp": 2}, [2, 3]), 2, 1,
                 id="shrink_pipelined_to_ranks_2_3"),
]


@pytest.mark.parametrize("train,src,dst,before,after", RESHARD_CASES)
def test_reshard_is_loss_continuous(world, train, src, dst, before, after):
    res = world.run("reshard_run", MODEL, train, src, dst, before, after)
    dst_ranks = range(N) if dst[1] is None else dst[1]
    src_ranks = range(N) if src[1] is None else src[1]
    control = res[src_ranks[0]]["control"]
    assert control[-1] < control[0]  # training progresses
    kept = res[src_ranks[0]]["kept"]
    for rank, r in enumerate(res):
        assert (r["control"] is not None) == (rank in src_ranks)
        if rank in src_ranks:
            assert r["control"] == pytest.approx(control, rel=1e-6)
        # Every leaf lands on the target mesh's ranks, and only there.
        assert r["holds_state"] == (rank in dst_ranks)
        if rank in dst_ranks:
            assert r["lands"] and all(r["lands"]), r["lands"]
            # The move is data movement: the state gathered on the target
            # is the source's, bit for bit (params, step count, mu, nu).
            assert len(r["moved"]) == len(kept)
            for got, want in zip(r["moved"], kept):
                np.testing.assert_array_equal(got, want)
            assert r["resized"][before:] == pytest.approx(
                control[before:], rel=2e-4)
        if rank in src_ranks:
            assert r["resized"][:before] == pytest.approx(
                control[:before], rel=2e-4)


def test_reshard_between_layouts_is_refused(world):
    for msg in world.run("reshard_refused", MODEL, ({"pp": 2}, TWO),
                         ({"dp": 2, "tp": 2}, FOUR)):
        assert msg is not None and "layouts differ" in msg


CHECKPOINT_CASES = [
    pytest.param({}, ({"tp": 2}, TWO), ({"dp": 2, "tp": 2}, FOUR),
                 id="grow"),
    pytest.param({"pipeline_microbatches": 2}, ({"pp": 2}, TWO),
                 ({"dp": 2, "pp": 2}, FOUR), id="grow_stacked"),
]


@pytest.mark.parametrize("train,src,dst", CHECKPOINT_CASES)
def test_restore_onto_grown_mesh_is_loss_continuous(world, tmp_path, train,
                                                    src, dst):
    """Save on the small mesh after 2 steps, restore onto the grown one:
    the state gathered there is the saved one, bit for bit, and step 3's
    loss equals the run that never stopped."""
    res = world.run("checkpoint_grow", MODEL, train, src, dst,
                    str(tmp_path))
    _, control, saved, _ = res[0]
    assert control is not None and saved is not None
    for resumed, _, _, restored in res:
        assert len(restored) == len(saved)
        for got, want in zip(restored, saved):
            np.testing.assert_array_equal(got, want)
        assert resumed == pytest.approx(control, rel=2e-4)


def test_restore_refuses_the_other_layout(tmp_path):
    """A checkpoint with a layer list does not restore as a stacked one
    (nor the other way): the layout is part of the fit check."""
    from tpu_composer_torch.parallel import checkpoint as ckpt

    tc = ttrain.TrainConfig(model=ModelConfig(
        **{**MODEL, "dtype": torch.float32}))
    ckpt.save(str(tmp_path), ttrain.make_train_state(tc, device="cpu"),
              step=1)
    stacked = ttrain.build_params(tc, 0, "cpu")
    stacked["layers"] = {name: torch.stack([layer[name] for layer in
                                            stacked["layers"]])
                         for name in stacked["layers"][0]}
    ckpt.save(str(tmp_path / "stacked"),
              {"params": stacked, "opt": ttrain.init_opt_state(stacked)},
              step=1)
    with pytest.raises(ValueError, match="config wants"):
        ckpt.restore(str(tmp_path / "stacked"), tc, "cpu")
    out = ckpt.restore(str(tmp_path), tc, "cpu")
    assert isinstance(out["state"]["params"]["layers"], list)


def test_abstract_train_state_allocates_nothing():
    """Every leaf of the template is a ``meta`` tensor (no storage) of the
    state's shape and dtype. (On a pipelined mesh, ``reshard_run`` holds
    the stacked template's shards against the resharded state.)"""
    tc = ttrain.TrainConfig(model=ModelConfig(
        **{**MODEL, "dtype": torch.float32}))
    abstract = ttrain.abstract_train_state(tc)
    real = ttrain.make_train_state(tc, device="cpu")
    got, want = ttrain.tree_leaves(abstract), ttrain.tree_leaves(real)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.is_meta and a.shape == b.shape and a.dtype == b.dtype
    # Without a pp mesh the layers stay a list, as in the JAX package.
    assert isinstance(abstract["params"]["layers"], list)


def test_operator_resize_drives_reshard(world):
    res = world.run("operator_reshard", MODEL, 3, 2)
    slices = res[0]["slices"]
    assert [(s["topology"], s["num_hosts"], s["chips_per_host"])
            for s in slices] == [("2x1", 1, 2), ("4x1", 1, 4)]
    control = res[0]["control"]
    assert control[-1] < control[0]
    for rank, r in enumerate(res):
        # Every rank built its meshes from the counts rank 0's watch saw.
        assert r["counts"] == [2, 4]
        assert (r["control"] is not None) == (rank in (0, 1))
        if rank in (0, 1):
            assert r["resized"] == pytest.approx(control, rel=2e-4)
        else:
            assert r["resized"][3:] == pytest.approx(control[3:], rel=2e-4)
