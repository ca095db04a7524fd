"""A bounded gloo world for the port's multi-rank tests, and the work its
ranks do. Imports torch and the port only, never JAX, so that spawned
ranks do not import JAX.

A test file starts one :class:`World` (module-scoped fixture) and sends
each case to it with :meth:`World.run`: the name of a function below and
its (numpy) arguments. Every rank runs the function and sends back its
result; the call returns them in rank order. A rank that raises, dies or
does not answer within the deadline fails the case and the world is
torn down (every rank killed), so that a collective that waits forever
cannot stall the test run; the next case starts a fresh world. Each rank
runs one torch thread and joins its group through a file under the
test's ``tmp_path`` (no fixed port, so worlds of parallel test workers
never meet), with a timeout on every collective.
"""

from __future__ import annotations

import itertools
import os
import queue
import sys
import time
import traceback
from typing import Any, Dict, List

import numpy as np
import torch

GROUP_TIMEOUT_S = 60  # a collective that waits longer raises
CASE_TIMEOUT_S = 240  # a case whose ranks have not all answered fails


class World:
    """``n`` spawned ranks over gloo on the CPU."""

    def __init__(self, n: int, workdir: str):
        self.n, self.workdir = n, workdir
        self._procs: List = []
        self._starts = itertools.count()

    def _start(self) -> None:
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        init = f"file://{self.workdir}/world{next(self._starts)}"
        self._tasks = [ctx.Queue() for _ in range(self.n)]
        self._results = ctx.Queue()
        self._procs = [ctx.Process(target=_rank_main, daemon=True, args=(
            r, self.n, init, self._tasks[r], self._results))
            for r in range(self.n)]
        for p in self._procs:
            p.start()

    def run(self, fn: str, *args, timeout: float = CASE_TIMEOUT_S) -> list:
        """``fn(*args)`` on every rank: the results in rank order."""
        if not self._procs:
            self._start()
        for q in self._tasks:
            q.put((fn, args))
        got: Dict[int, Any] = {}
        deadline = time.monotonic() + timeout
        dead_since = None
        while len(got) < self.n:
            try:
                rank, err, out = self._results.get(timeout=1)
            except queue.Empty:
                now = time.monotonic()
                dead = [r for r, p in enumerate(self._procs)
                        if not p.is_alive() and r not in got]
                if dead and dead_since is None:
                    dead_since = now
                if now > deadline or (dead and now - dead_since > 5):
                    self.close()
                    raise AssertionError(
                        f"{fn}: ranks {sorted(set(range(self.n)) - set(got))}"
                        f" gave no result (dead: {dead}; timeout {timeout} s)")
                continue
            if err is not None:
                self.close()
                raise AssertionError(f"{fn}: rank {rank} raised:\n{err}")
            got[rank] = out
        return [got[r] for r in range(self.n)]

    def close(self) -> None:
        """Stop every rank: asked first, killed when it does not go."""
        for q, p in zip(getattr(self, "_tasks", []), self._procs):
            if p.is_alive():
                q.put(None)
        for p in self._procs:
            p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
        self._procs = []


def _rank_main(rank: int, n: int, init: str, tasks, results) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from tpu_composer_torch.parallel.mesh import init_world

    init_world("gloo", rank, n, init, "cpu", timeout_s=GROUP_TIMEOUT_S)
    try:
        while True:
            task = tasks.get()
            if task is None:
                break
            name, args = task
            try:
                out = globals()[name](*args)
                results.put((rank, None, out))
            except Exception:
                results.put((rank, traceback.format_exc(), None))
    finally:
        dist.destroy_process_group()


# -- the ranks' work -----------------------------------------------------------

_MESHES: Dict[tuple, Any] = {}


def mesh(axes: Dict[str, int]):
    """The world's mesh of ``axes`` (built once per world: building one
    is a collective)."""
    from tpu_composer_torch.parallel.mesh import make_mesh

    key = tuple(axes.items())
    if key not in _MESHES:
        _MESHES[key] = make_mesh(dict(axes), "cpu")
    return _MESHES[key]


def coords(axes: Dict[str, int]) -> Dict[str, int]:
    """This rank's coordinate along each dim of ``axes``."""
    from tpu_composer_torch.parallel.mesh import axis_index

    m = mesh(axes)
    return {name: axis_index(m, name) for name in axes}


def solve_and_make(axes: Dict[str, int]):
    """``make_mesh`` of ``axes``: its dim names and shape, or the
    ``ValueError`` it raises, as text."""
    from tpu_composer_torch.parallel.mesh import make_mesh

    try:
        m = make_mesh(dict(axes), "cpu")
    except ValueError as e:
        return "ValueError: " + str(e)
    return list(m.mesh_dim_names), list(m.shape)


def collective(axes, dim: str, op: str, x: np.ndarray, w: np.ndarray,
               kw: Dict[str, Any]):
    """``op`` over ``dim`` of this rank's input ``x[i]`` (i its index
    along ``dim``), and the gradient of Σ out ⊙ w[i] with respect to
    it."""
    from tpu_composer_torch.parallel import collectives as coll

    m = mesh(axes)
    i = coords(axes)[dim]
    xt = torch.from_numpy(x[i]).requires_grad_()
    out = getattr(coll, op)(xt, m, dim, **kw)
    (out * torch.from_numpy(w[i])).sum().backward()
    return out.detach().numpy(), xt.grad.numpy(), coords(axes)


def sp_attention(axes, impl: str, inner: str, causal: bool, q, k, v, g):
    """The sequence-parallel attention ``impl`` ("ring", "zigzag",
    "ulysses") of this rank's chunk of the global q, k, v (B, S, H, D)
    over 'sp': its output chunk and the gradients of Σ out ⊙ g's chunk
    with respect to q, k and v, whole (the slices' cotangents gathered
    over 'sp')."""
    from tpu_composer_torch.ops.attention import flash_attention
    from tpu_composer_torch.parallel import collectives as coll
    from tpu_composer_torch.parallel.ring_attention import (
        ring_attention,
        ring_attention_zigzag,
    )
    from tpu_composer_torch.parallel.ulysses import ulysses_attention

    m = mesh(axes)
    full = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    local = [coll.shard(t, m, "sp", axis=1) for t in full]
    if impl == "ulysses":
        fn = ulysses_attention
        extra = {"attn_fn": flash_attention} if inner == "flash" else {}
    else:
        fn = ring_attention if impl == "ring" else ring_attention_zigzag
        extra = {"inner": inner}
    out = fn(*local, m, "sp", causal=causal, **extra)
    g_local = coll.shard(torch.from_numpy(g), m, "sp", axis=1)
    (out * g_local).sum().backward()
    return (out.detach().numpy(), [t.grad.numpy() for t in full],
            coords(axes))


def sp_attention_error(axes, q, k, v):
    """Ulysses on heads that sp does not divide: the error text."""
    from tpu_composer_torch.parallel import collectives as coll
    from tpu_composer_torch.parallel.ulysses import ulysses_attention

    m = mesh(axes)
    local = [coll.shard(torch.from_numpy(a), m, "sp", axis=1)
             for a in (q, k, v)]
    try:
        ulysses_attention(*local, m, "sp", causal=True)
    except ValueError as e:
        return str(e)
    return None


def _configs(model: Dict[str, Any], moe: bool, train: Dict[str, Any]):
    from tpu_composer_torch.models.moe import MoEConfig
    from tpu_composer_torch.models.transformer import ModelConfig
    from tpu_composer_torch.parallel.train import TrainConfig

    fields = dict(model)
    fields["dtype"] = getattr(torch, fields["dtype"])
    cfg = MoEConfig(**fields) if moe else ModelConfig(**fields)
    return TrainConfig(model=cfg, **train)


def _params(tc, params_np):
    """The port's tree from the JAX tree's leaves (float32 numpy), each
    leaf in the dtype the model keeps it in."""
    from tpu_composer_torch.convert import params_from_jax

    cfg = tc.model
    tree = params_from_jax(params_np, cfg, device="cpu") \
        if cfg.dtype == torch.float32 else _cast(params_np, cfg)
    return tree


def _cast(params_np, cfg):
    """A float32 copy of a bf16 JAX tree back in bf16 (exact), norms and
    routers kept in fp32."""
    def leaf(a, name):
        t = torch.from_numpy(np.asarray(a, np.float32))
        keep = name.startswith("ln") or name == "w_router"
        return t if keep else t.to(cfg.dtype)

    return {"embed": leaf(params_np["embed"], "embed"),
            "layers": [{n: leaf(w, n) for n, w in layer.items()}
                       for layer in params_np["layers"]],
            "ln_f": leaf(params_np["ln_f"], "ln_f")}


def train_steps(axes, model, moe: bool, train, params_np, tokens,
                steps: int):
    """``steps`` train steps over the mesh from the given params, on the
    same global batch each step: losses, grad norms, and the first
    step's gradients gathered whole (tree leaves in order)."""
    from tpu_composer_torch.parallel.train import (
        gather_params,
        init_opt_state,
        make_grad_fn,
        make_train_step,
        shard_params,
        tree_leaves,
        tree_unflatten,
    )

    tc = _configs(model, moe, train)
    m = mesh(axes)
    params = shard_params(tc, _params(tc, params_np), m)
    state = {"params": params, "opt": init_opt_state(params)}
    toks = torch.from_numpy(tokens)
    _, grads, _ = make_grad_fn(tc, m)(state["params"], toks)
    full = gather_params(tc, tree_unflatten(params, grads), m)
    step = make_train_step(tc, m)
    losses, norms = [], []
    for _ in range(steps):
        state, metrics = step(state, toks)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    return losses, norms, [g.float().numpy() for g in tree_leaves(full)]


def moe_forward(axes, model, params_np, tokens):
    """The MoE forward over the mesh: this rank's logits rows and aux,
    with the row block it holds."""
    from tpu_composer_torch.models import moe
    from tpu_composer_torch.parallel.train import (
        data_index,
        local_batch,
        shard_params,
    )

    tc = _configs(model, True, {})
    m = mesh(axes)
    params = shard_params(tc, _params(tc, params_np), m)
    with torch.no_grad():
        logits, aux = moe.forward(
            params, local_batch(tc, torch.from_numpy(tokens), m), tc.model,
            mesh=m)
    return logits.numpy(), float(aux), data_index(tc, m)


def fit_resume(axes, model, workdir: str, steps: int, global_batch: int,
               seq: int):
    """``fit`` over the mesh, straight through and killed after half the
    steps then resumed from its checkpoint: both histories' losses and
    the resume step."""
    from tpu_composer_torch.data import PackedLMDataset
    from tpu_composer_torch.examples.train_lm import zipf_documents
    from tpu_composer_torch.workload.trainer import fit

    tc = _configs(model, False, {})
    m = mesh(axes)
    docs = zipf_documents(0, n_docs=64, vocab=tc.model.vocab_size)
    ds = PackedLMDataset(docs, seq_len=seq, seed=0)
    kw = dict(global_batch=global_batch, log_every=1, device="cpu", mesh=m)
    whole = fit(tc, ds, total_steps=steps, **kw)
    fit(tc, ds, total_steps=steps // 2, checkpoint_dir=workdir,
        checkpoint_every=steps // 2, **kw)
    resumed = fit(tc, ds, total_steps=steps, checkpoint_dir=workdir,
                  checkpoint_every=steps // 2, **kw)
    return ([r["loss"] for r in whole.history],
            {int(r["step"]): r["loss"] for r in resumed.history},
            resumed.resumed_from)


def fit_indivisible(axes, model, global_batch: int):
    """``fit`` with a batch the data axes do not divide: the error."""
    from tpu_composer_torch.data import PackedLMDataset
    from tpu_composer_torch.examples.train_lm import zipf_documents
    from tpu_composer_torch.workload.trainer import fit

    tc = _configs(model, False, {})
    ds = PackedLMDataset(zipf_documents(0, n_docs=32, vocab=64),
                         seq_len=16, seed=0)
    try:
        fit(tc, ds, total_steps=1, global_batch=global_batch,
            device="cpu", mesh=mesh(axes))
    except ValueError as e:
        return str(e)
    return None


def qualify(axes, model, batch: int, seq: int):
    """``qualify_slice`` over the mesh (or its default mesh when
    ``axes`` is None)."""
    from tpu_composer_torch.workload.acceptance import qualify_slice

    tc = _configs(model, False, {})
    return qualify_slice(device="cpu", batch=batch, seq=seq,
                         model_config=tc.model, allreduce_mb=1.0, steps=1,
                         mesh=None if axes is None else mesh(axes))


def bandwidth(axes):
    """The allreduce probe over the mesh, in GB/s, and its transport."""
    from tpu_composer_torch.parallel.collectives import (
        allreduce_bandwidth_gbps,
        backend,
    )

    m = mesh(axes)
    return allreduce_bandwidth_gbps(m, size_mb=1.0, iters=2), backend(m)
