"""Port parity for the coordinate env: ``api/types.SliceStatus``,
``admission/coordinates.py`` and ``workload/coords.py`` against the JAX
package's, and the GPU env by its own contract.

Exact: for TPU models ``slice_env`` and ``inject_pod_env`` give the JAX
package's dicts; ``SliceStatus`` round-trips as JAX's does. The GPU env
(``nvidia-h100-sxm``) round-trips through ``SliceCoords.from_env`` to
the worker count, GPU count and worker id that JAX's round trip of the
same ``SliceStatus`` gives; its launcher names are those the installed
``torch.distributed.run`` reads; ``bootstrap_distributed`` brings up a
gloo world of 2 hosts × 2 ranks from that env alone (each collective
bounded by ``tests/torch_dist.py``'s timeout, the world by its
deadline).
"""

from __future__ import annotations

import copy
import socket

import pytest
import torch
import torch.distributed as dist

from tests.torch_dist import run_bootstrapped
from tpu_composer.admission import inject_pod_env as jax_inject
from tpu_composer.admission import slice_env as jax_slice_env
from tpu_composer.api.types import SliceStatus as JaxSliceStatus
from tpu_composer.workload.coords import SliceCoords as JaxCoords
from tpu_composer_torch.admission import inject_pod_env, slice_env
from tpu_composer_torch.api.types import SliceStatus
from tpu_composer_torch.topology import solve_slice
from tpu_composer_torch.workload import SliceCoords, bootstrap_distributed

torch.set_num_threads(1)

H100 = "nvidia-h100-sxm"

SLICES = [
    dict(name="job-slice", topology="2x2x2", num_hosts=2, chips_per_host=4,
         worker_hostnames=["worker-0", "worker-1"]),
    dict(name="pod", topology="2x4x4", num_hosts=8, chips_per_host=4,
         worker_hostnames=[f"w{i}" for i in range(8)]),
    dict(name="v5e", topology="4x4", num_hosts=2, chips_per_host=8,
         worker_hostnames=["a", "b"]),
    dict(name="one", topology="1x1x2", num_hosts=1, chips_per_host=2,
         worker_hostnames=["solo"]),
    dict(name="pinned", topology="4x2x2", num_hosts=4, chips_per_host=4,
         worker_hostnames=["h0", "h1", "h2", "h3"]),
    dict(name="odd", topology="3x2x2", num_hosts=3, chips_per_host=4,
         worker_hostnames=["h0", "h1", "h2"]),
    dict(name="", topology="", num_hosts=0, chips_per_host=0,
         worker_hostnames=[]),
]


@pytest.mark.parametrize("fields", SLICES, ids=lambda f: f["name"] or "empty")
@pytest.mark.parametrize("model", ["tpu-v4", "tpu-v5p", "tpu-v5e", "tpu-v6e",
                                   ""])
def test_tpu_slice_env_and_pod_as_jax(fields, model):
    for worker in range(max(1, fields["num_hosts"])):
        got = slice_env(SliceStatus(**fields), worker, model)
        assert got == jax_slice_env(JaxSliceStatus(**fields), worker, model)
        pod = {"spec": {"containers": [
            {"name": "main",
             "env": [{"name": "TPU_WORKER_ID", "value": "keep"}]},
            {"name": "sidecar"}]}}
        assert inject_pod_env(copy.deepcopy(pod), SliceStatus(**fields),
                              worker, model) == \
            jax_inject(copy.deepcopy(pod), JaxSliceStatus(**fields), worker,
                       model)


@pytest.mark.parametrize("fields", SLICES, ids=lambda f: f["name"] or "empty")
def test_slice_status_round_trips_as_jax(fields):
    ours = SliceStatus(**fields)
    assert ours.to_dict() == JaxSliceStatus(**fields).to_dict()
    assert SliceStatus.from_dict(ours.to_dict()) == ours
    assert vars(SliceStatus.from_dict(ours.to_dict())) == vars(
        JaxSliceStatus.from_dict(ours.to_dict()))


def _h100_status(count: int) -> SliceStatus:
    shape = solve_slice(H100, count)
    return SliceStatus(name=f"gpu-{count}", topology=shape.topology,
                       num_hosts=shape.num_hosts,
                       chips_per_host=shape.chips_per_host,
                       worker_hostnames=[f"node-{i}"
                                         for i in range(shape.num_hosts)])


@pytest.mark.parametrize("count", [1, 4, 8, 16, 40])
def test_gpu_env_round_trips_as_jax_coords(count):
    ss = _h100_status(count)
    for worker in range(ss.num_hosts):
        env = slice_env(ss, worker, H100, master_port=29511)
        c = SliceCoords.from_env(env)
        j = JaxCoords.from_env(jax_slice_env(JaxSliceStatus(**vars(ss)),
                                             worker, H100))
        assert (c.num_workers, c.num_chips, c.worker_id) == \
            (j.num_workers, j.num_chips, j.worker_id)
        assert (c.worker_hostnames, c.chips_per_host, c.topology,
                c.slice_name, c.model) == \
            (ss.worker_hostnames, ss.chips_per_host, ss.topology, ss.name,
             H100)
        assert c.coordinator_address == "node-0:29511"
        assert int(env["WORLD_SIZE"]) == count
        assert [c.rank(r) for r in range(c.chips_per_host)] == list(range(
            worker * c.chips_per_host, (worker + 1) * c.chips_per_host))
    with pytest.raises(ValueError, match="local rank"):
        SliceCoords.from_env(slice_env(ss, 0, H100)).rank(ss.chips_per_host)


def test_default_coordinator_port_is_the_envs_master_port():
    """The port's ``DEFAULT_COORDINATOR_PORT`` (the JAX package's name) is
    the port the slice env writes when given none, and the coordinator
    address of a worker whose env names no port."""
    from tpu_composer_torch.workload.coords import DEFAULT_COORDINATOR_PORT

    ss = _h100_status(16)
    env = slice_env(ss, 1, H100)
    assert env["MASTER_PORT"] == str(DEFAULT_COORDINATOR_PORT) == "29500"
    del env["MASTER_PORT"]
    assert SliceCoords.from_env(env).coordinator_address == (
        f"node-0:{DEFAULT_COORDINATOR_PORT}")


def test_gpu_env_names_are_torchruns(monkeypatch):
    """Every PET_ variable is one the installed torchrun reads, and with
    the env alone torchrun's parser starts this host's share of the
    world; the worker variables are those torchrun gives its workers."""
    import torch.distributed.run as run

    env = slice_env(_h100_status(16), 1, H100)
    assert sorted(env) == sorted([
        "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "GROUP_RANK",
        "LOCAL_WORLD_SIZE", "PET_MASTER_ADDR", "PET_MASTER_PORT",
        "PET_NNODES", "PET_NODE_RANK", "PET_NPROC_PER_NODE",
        "COMPOSER_SLICE_NAME", "COMPOSER_TOPOLOGY",
        "COMPOSER_ACCELERATOR_MODEL", "COMPOSER_WORKER_HOSTNAMES"])
    options = {f"PET_{a.dest.upper()}"
               for a in run.get_args_parser()._actions}
    assert {k for k in env if k.startswith("PET_")} <= options
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    args = run.get_args_parser().parse_args(["train.py"])
    assert (args.nnodes, args.nproc_per_node, args.node_rank,
            args.master_addr, int(args.master_port)) == (
        "2", "8", 1, "node-0", 29500)


def test_gpu_pod_injection_pins_the_worker():
    ss = _h100_status(16)
    pod = {"spec": {"containers": [
        {"name": "main", "env": [{"name": "MASTER_PORT", "value": "1234"}]}]}}
    inject_pod_env(pod, ss, 1, H100)
    env = {e["name"]: e["value"] for e in pod["spec"]["containers"][0]["env"]}
    assert env["MASTER_PORT"] == "1234"  # the user's value wins
    assert env["GROUP_RANK"] == "1" and env["MASTER_ADDR"] == "node-0"
    assert pod["spec"]["nodeSelector"]["kubernetes.io/hostname"] == "node-1"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_bootstrap_brings_up_two_hosts_of_two_ranks_from_the_env():
    ss = SliceStatus(name="gloo-slice", topology="2x2", num_hosts=2,
                     chips_per_host=2,
                     worker_hostnames=["127.0.0.1", "127.0.0.1"])
    port = _free_port()
    envs = [slice_env(ss, w, H100, master_port=port) for w in range(2)]
    got = run_bootstrapped([(envs[w], lr) for w in range(2)
                            for lr in range(2)])
    assert got == [(r, 4, 6.0, True) for r in range(4)]


def test_bootstrap_of_one_gpu_is_a_no_op():
    env = slice_env(_h100_status(1), 0, H100)
    c = bootstrap_distributed(env=env, device="cpu")
    assert c.num_chips == 1 and not dist.is_initialized()
