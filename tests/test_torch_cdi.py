"""Port parity for CDI specs: ``tpu_composer_torch/agent/cdi.py`` against
``tpu_composer/agent/cdi.py`` (the twins of ``tests/test_agent.py``'s CDI
cases), and the NVIDIA device nodes and library mounts.

Exact: a TPU group's document, path and name are JAX's, byte for byte as
written; a GPU group's document holds its ``/dev/nvidia<N>`` nodes,
NVIDIA's control nodes, the CUDA and NVML library mounts and the
coordinate env ``slice_env`` writes for it.
"""

from __future__ import annotations

import json
import os

import pytest

from tpu_composer.agent import cdi as jax_cdi
from tpu_composer_torch.admission import slice_env
from tpu_composer_torch.agent.cdi import (
    CDI_CLASS_GPU,
    CdiSpec,
    generate_cdi_spec,
    list_cdi_specs,
    remove_cdi_spec,
    spec_path,
    write_cdi_spec,
)
from tpu_composer_torch.api.types import SliceStatus
from tpu_composer_torch.topology import solve_slice

H100 = "nvidia-h100-sxm"

TPU_CASES = [
    ("req1-slice", 2, [0, 1, 2, 3], {"TPU_WORKER_ID": "2"}, False),
    ("s", 0, [0, 1], None, True),
    ("s1", 0, [0], None, False),
    ("", 0, [2, 3], {"B": "2", "A": "1"}, False),
]


@pytest.mark.parametrize("case", TPU_CASES, ids=lambda c: c[0] or "unnamed")
def test_tpu_spec_as_jax(case, tmp_path):
    name, worker, chips, env, vfio = case
    ours = generate_cdi_spec(name, worker, chips, env=env, use_vfio=vfio)
    theirs = jax_cdi.generate_cdi_spec(name, worker, chips, env=env,
                                       use_vfio=vfio)
    assert (ours.name, ours.device_nodes, ours.env, ours.qualified_name) == \
        (theirs.name, theirs.device_nodes, theirs.env, theirs.qualified_name)
    assert ours.to_dict() == theirs.to_dict()
    a, b = tmp_path / "ours", tmp_path / "theirs"
    pa, pb = write_cdi_spec(str(a), ours), jax_cdi.write_cdi_spec(str(b),
                                                                   theirs)
    assert os.path.basename(pa) == os.path.basename(pb)
    assert open(pa).read() == open(pb).read()


def test_generate_accel_nodes_and_env():
    spec = generate_cdi_spec(
        "req1-slice", 2, [0, 1, 2, 3], env={"TPU_WORKER_ID": "2"}
    )
    assert spec.name == "req1-slice-worker2"
    assert spec.qualified_name == "tpu.composer.dev/tpu=req1-slice-worker2"
    edits = spec.to_dict()["devices"][0]["containerEdits"]
    assert [n["path"] for n in edits["deviceNodes"]] == [
        "/dev/accel0", "/dev/accel1", "/dev/accel2", "/dev/accel3",
    ]
    assert edits["env"] == ["TPU_WORKER_ID=2"]
    assert edits["mounts"][0]["containerPath"] == "/lib/libtpu.so"
    assert spec.to_dict()["cdiVersion"] == "0.6.0"


def test_vfio_mode():
    spec = generate_cdi_spec("s", 0, [0, 1], use_vfio=True)
    assert spec.device_nodes == ["/dev/vfio/vfio", "/dev/vfio/0",
                                 "/dev/vfio/1"]
    with pytest.raises(ValueError, match="TPU chips only"):
        generate_cdi_spec("s", 0, [0, 1], use_vfio=True, model=H100)


@pytest.mark.parametrize("cdi_class,model", [("tpu", ""), (CDI_CLASS_GPU,
                                                             H100)])
def test_write_list_remove_roundtrip(tmp_path, cdi_class, model):
    cdi = str(tmp_path / "cdi")
    spec = generate_cdi_spec("s1", 0, [0], model=model)
    path = write_cdi_spec(cdi, spec)
    assert path == spec_path(cdi, spec)
    assert json.load(open(path))["kind"] == f"tpu.composer.dev/{cdi_class}"
    assert not os.path.exists(path + ".tmp")  # written whole, then renamed
    assert list_cdi_specs(cdi, cdi_class) == ["s1-worker0"]
    other = "tpu" if cdi_class == CDI_CLASS_GPU else CDI_CLASS_GPU
    assert list_cdi_specs(cdi, other) == []
    assert remove_cdi_spec(cdi, "s1-worker0", cdi_class)
    assert list_cdi_specs(cdi, cdi_class) == []
    assert not remove_cdi_spec(cdi, "s1-worker0", cdi_class)
    assert list_cdi_specs(str(tmp_path / "absent")) == []


def test_gpu_nodes_mounts_and_coordinate_env():
    ss = SliceStatus(name="train", topology="8x2", num_hosts=2,
                     chips_per_host=8, worker_hostnames=["n0", "n1"])
    env = slice_env(ss, 1, H100)
    spec = generate_cdi_spec("train", 1, list(range(8)), env=env, model=H100)
    assert spec.qualified_name == "tpu.composer.dev/gpu=train-worker1"
    d = spec.to_dict()
    assert d["cdiVersion"] == "0.6.0" and d["kind"] == "tpu.composer.dev/gpu"
    edits = d["devices"][0]["containerEdits"]
    assert [n["path"] for n in edits["deviceNodes"]] == [
        f"/dev/nvidia{i}" for i in range(8)] + [
        "/dev/nvidiactl", "/dev/nvidia-uvm", "/dev/nvidia-uvm-tools"]
    mounts = {os.path.basename(m["hostPath"]): m for m in edits["mounts"]}
    assert sorted(mounts) == ["libcuda.so.1", "libnvidia-ml.so.1"]
    for m in mounts.values():
        assert m["containerPath"] == m["hostPath"]
        assert m["options"] == ["ro", "nosuid", "nodev", "bind"]
    assert "/lib/libtpu.so" not in json.dumps(d)
    assert edits["env"] == [f"{k}={v}" for k, v in sorted(env.items())]
    assert "GROUP_RANK=1" in edits["env"]


def test_gpu_worker1_of_8x2_names_host_local_nodes():
    shape = solve_slice(H100, 16)
    assert shape.topology == "8x2"
    chips = shape.worker_chip_indices(1)
    assert chips == list(range(8, 16))
    spec = generate_cdi_spec("train", 1, chips, model=H100)
    assert spec.device_nodes[:8] == [f"/dev/nvidia{i}" for i in range(8)]


def test_gpu_subset_of_a_host():
    spec = generate_cdi_spec("s", 0, [4, 5], model=H100)
    assert spec.device_nodes[:2] == ["/dev/nvidia4", "/dev/nvidia5"]
    assert isinstance(spec, CdiSpec) and spec.cdi_class == CDI_CLASS_GPU


def test_gpu_nodes_are_ordinals_that_the_agent_rebases_onto_minors(tmp_path):
    """The spec names GPU ordinals; the node agent that publishes it writes
    the minor of the host's GPU of each ordinal. On a host listing minors
    0 and 3 (and no 1), ordinal 1 is /dev/nvidia3."""
    from tests.torch_operator import nvidia_host
    from tpu_composer_torch.agent.nodeagent import LocalNodeAgent

    spec = generate_cdi_spec("s", 0, [1], model=H100)
    assert spec.device_nodes[0] == "/dev/nvidia1"
    agent = LocalNodeAgent(**nvidia_host(str(tmp_path), minors=(0, 3)))
    agent.refresh_device_stack("n0", spec=spec)
    with open(os.path.join(agent.cdi_dir, "tpu.composer.dev-gpu-s-worker0.json")) as f:
        edits = json.load(f)["devices"][0]["containerEdits"]
    assert [n["path"] for n in edits["deviceNodes"]][0] == "/dev/nvidia3"
    # Everything else in the spec is as generated.
    assert [n["path"] for n in edits["deviceNodes"]][1:] == spec.device_nodes[1:]
