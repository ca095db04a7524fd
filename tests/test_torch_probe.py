"""The staged probe (``tpu_composer_torch/workload/probe.py``): the twins of
``tests/test_probe.py`` over scripted children, a real child on the CPU,
and the flash record against the JAX package's.

The failure path must produce evidence: a wedge yields a named stage, a
thread stack dump and a retry record; a stage that dies keeps its
``STAGE_PARTIAL`` numbers; a card that does not come up is never
replaced by the CPU (no ``cpu_fallback`` or ``tpu_aot_compile`` record
ever appears). The flash record has JAX's keys, and its numerics hold
to JAX's envelope (fwd < 0.1·t, bwd < 0.5·t, t = max(1, sqrt(S/2048))).
"""

from __future__ import annotations

import socket

import jax
import pytest
import torch

import tpu_composer.ops.attention as jax_attention
import tpu_composer.workload.probe as jax_probe
import tpu_composer_torch.workload.probe as probe

torch.set_num_threads(1)

ORDER = ["devnodes", "backend_init", "matmul", "flash_attn", "qualify",
         "qualify_large", "decode"]

# A child that completes every stage instantly.
_FAST_CHILD = r"""
import json
for stage in ("backend_init", "matmul", "flash_attn", "qualify",
              "qualify_large", "decode"):
    print("STAGE_RESULT " + json.dumps({"stage": stage, "seconds": 0.0, "ok": True}),
          flush=True)
"""

# A child that wedges inside backend_init, with the real child's watchdog.
_WEDGED_CHILD = r"""
import faulthandler, os, time
_budget = float(os.environ.get("TPUC_PROBE_STAGE_BUDGET_S", "120"))
faulthandler.dump_traceback_later(max(_budget - 10.0, 2.0), exit=True)
time.sleep(600)
"""

# A child that reaches decode, prints its quant numbers as a partial
# record and dies there the way a watchdog exit would.
_DIES_IN_DECODE = r"""
import json, os
for stage in ("backend_init", "matmul", "flash_attn", "qualify",
              "qualify_large"):
    print("STAGE_RESULT " + json.dumps({"stage": stage, "seconds": 0.0}),
          flush=True)
print("STAGE_PARTIAL decode " + json.dumps({"bf16_tokens_per_s": 12.5}),
      flush=True)
os._exit(1)
"""


def _no_fallback(r):
    assert "cpu_fallback" not in r and "tpu_aot_compile" not in r


def test_all_stages_complete(monkeypatch):
    monkeypatch.setattr(probe, "_CHILD", _FAST_CHILD)
    r = probe.staged_accelerator_probe(timeouts={"backend_init": 10.0})
    assert r["completed"] == ORDER
    assert "failed_stage" not in r and "diagnosis" not in r
    assert set(r["stages"]) == set(ORDER)
    _no_fallback(r)


def test_wedged_backend_init_yields_stack_and_retries(monkeypatch):
    monkeypatch.setattr(probe, "_CHILD", _WEDGED_CHILD)
    r = probe.staged_accelerator_probe(timeouts={"backend_init": 6.0},
                                       retries=1)
    assert r["failed_stage"] == "backend_init"
    assert r["completed"] == ["devnodes"]
    d = r["diagnosis"]
    assert d["attempts"] == 2 and len(d["earlier_attempts"]) == 1
    assert d["timeout_s"] == 6.0
    # The in-child faulthandler dump reached the recorded stderr tail.
    assert any("time.sleep" in line or "Thread" in line
               for line in d["stderr_tail"]), d["stderr_tail"]
    for key in ("nvidia_nodes_present", "driver_version", "rendezvous"):
        assert key in d
    _no_fallback(r)


def test_partial_records_are_kept(monkeypatch):
    monkeypatch.setattr(probe, "_CHILD", _DIES_IN_DECODE)
    r = probe.staged_accelerator_probe(timeouts={"backend_init": 10.0})
    assert r["failed_stage"] == "decode"
    assert r["completed"] == ORDER[:-1]
    assert r["stages"]["decode"] == {"bf16_tokens_per_s": 12.5,
                                     "partial": True}
    assert r["diagnosis"]["attempts"] == 1  # only backend_init retries
    _no_fallback(r)


def test_real_child_on_the_cpu(monkeypatch):
    """The real child, asked for the CPU: every stage it can run there
    completes, the card-only ones report skipped, and nothing was built
    or launched. Its qualify stage trains at the real (4, 512), on two
    threads so the rest of the suite keeps its cores."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    r = probe.staged_accelerator_probe(device="cpu", retries=0)
    assert r["completed"] == ORDER, r.get("diagnosis")
    st = r["stages"]
    assert st["backend_init"]["backend"] == "cpu"
    assert st["matmul"] == {"ok": True, "result_dtype": "bfloat16",
                            "seconds": st["matmul"]["seconds"]}
    for stage in ("flash_attn", "qualify_large", "decode"):
        assert set(st[stage]) == {"skipped", "seconds"}, st[stage]
    q = st["qualify"]
    assert q["attn_impl"] == "flash" and q["n_devices"] == 1.0
    assert q["launches"] == dict.fromkeys(q["launches"], 0)
    assert q["built"] == []
    assert set(st["devnodes"]) == {"nvidia_nodes", "env", "driver_version",
                                   "rendezvous"}
    _no_fallback(r)


def test_flash_record_has_jaxs_keys_and_numerics(monkeypatch):
    kw = dict(batch=1, heads=2, seq=128, head_dim=64, kv_heads=1)
    ours = probe.flash_attention_on_chip(**kw, device="cpu")
    # JAX's record off the TPU: the Pallas kernels in interpret mode, as
    # the JAX package's own tests run them on the CPU.
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jax_attention, "_default_interpret", lambda: True)
    theirs = jax_probe.flash_attention_on_chip(**kw)
    assert set(ours) == set(theirs)
    assert ours["numerics_ok"] is True and theirs["numerics_ok"] is True
    assert (ours["seq"], ours["kv_heads"]) == (128, 1)
    assert ours["fwd_max_err"] < 0.1 and ours["bwd_max_err"] < 0.5


def test_sweep_and_card_stages_refuse_the_cpu():
    assert "skipped" in probe.flash_sweep_on_chip("cpu")
    assert [c["seq"] for c in probe.FLASH_SWEEP] == [1024, 2048, 4096, 8192]


def test_rendezvous_preflight():
    assert probe.probe_rendezvous({}) == []
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        s.listen(1)
        port = s.getsockname()[1]
        up = probe.probe_rendezvous({"MASTER_ADDR": "127.0.0.1",
                                     "MASTER_PORT": str(port)})
    assert up[0]["endpoint"] == f"127.0.0.1:{port}" and up[0]["reachable"]
    down = probe.probe_rendezvous({"MASTER_ADDR": "127.0.0.1",
                                   "MASTER_PORT": str(port)},
                                  timeout_s=0.5)
    assert down[0]["reachable"] is False and "error" in down[0]
