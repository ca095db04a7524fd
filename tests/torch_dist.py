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


def mesh(axes: Dict[str, int], ranks=None):
    """The world's mesh of ``axes`` (over ``ranks`` when given; built once
    per world: building one is a collective)."""
    from tpu_composer_torch.parallel.mesh import make_mesh

    key = (tuple(axes.items()), None if ranks is None else tuple(ranks))
    if key not in _MESHES:
        _MESHES[key] = make_mesh(dict(axes), "cpu", ranks=ranks)
    return _MESHES[key]


def coords(axes: Dict[str, int]) -> Dict[str, int]:
    """This rank's coordinate along each dim of ``axes``."""
    from tpu_composer_torch.parallel.mesh import axis_index

    m = mesh(axes)
    return {name: axis_index(m, name) for name in axes}


def submesh_coords(axes: Dict[str, int], ranks):
    """On a mesh over ``ranks``: whether this rank is in it, its
    coordinates (or the error text ``axis_index`` raises outside it), and
    the errors of meshes over ranks the world lacks or out of order."""
    from tpu_composer_torch.parallel.mesh import (
        axis_index,
        in_mesh,
        make_mesh,
        mesh_shape,
    )

    m = mesh(axes, ranks)
    try:
        got = {name: axis_index(m, name) for name in axes}
    except ValueError as e:
        got = "ValueError: " + str(e)
    bad = []
    for wrong in ([r + 100 for r in ranks], ranks[::-1]):
        try:
            make_mesh(dict(axes), "cpu", ranks=wrong)
            bad.append(None)
        except ValueError as e:
            bad.append(str(e))
    return in_mesh(m), got, mesh_shape(m), bad


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
               seq: int, train=None):
    """``fit`` over the mesh, straight through and killed after half the
    steps then resumed from its checkpoint: both histories' losses and
    the resume step."""
    from tpu_composer_torch.data import PackedLMDataset
    from tpu_composer_torch.examples.train_lm import zipf_documents
    from tpu_composer_torch.workload.trainer import fit

    tc = _configs(model, False, train or {})
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


def pipeline_forward(axes, model, train, params_np, tokens):
    """``pipelined_forward`` under ``no_grad`` over the mesh from the JAX
    state's (stacked) params: this rank's logits rows and the row block
    it holds."""
    from tpu_composer_torch.parallel.pipeline import pipelined_forward
    from tpu_composer_torch.parallel.train import (
        data_index,
        local_batch,
        shard_params,
    )

    tc = _configs(model, False, train)
    m = mesh(axes)
    params = shard_params(tc, _params(tc, params_np), m)
    with torch.no_grad():
        logits = pipelined_forward(
            params, local_batch(tc, torch.from_numpy(tokens), m), tc.model,
            m, tc.pipeline_microbatches)
    return logits.numpy(), data_index(tc, m)


def pipeline_refusals(axes, model):
    """The errors of the refused pipelined configurations on a pp mesh:
    MoE, the flash inner, a depth pp does not divide."""
    from tpu_composer_torch.parallel.train import make_train_step

    m = mesh(axes)
    out = {}
    for label, moe, fields, train in (
            ("moe", True, {"n_experts": 4, "top_k": 2, "moe_period": 2}, {}),
            ("flash", False, {}, {"sp_inner": "flash"}),
            ("depth", False, {"n_layers": 3}, {})):
        tc = _configs({**model, **fields}, moe,
                      {"pipeline_microbatches": 2, **train})
        try:
            make_train_step(tc, m)
            out[label] = None
        except ValueError as e:
            out[label] = str(e)
    return out


def _batches(vocab: int, n: int, b: int = 4, s: int = 32, seed: int = 7):
    """``n`` batches of Zipf(1.5) tokens (text-like, so a few steps
    learn their unigram skew and the loss falls)."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(
        rng.zipf(1.5, (b, s)).clip(0, vocab - 1).astype(np.int32))
        for _ in range(n)]


def _steps(tc, m, state, batches):
    from tpu_composer_torch.parallel.train import make_train_step

    step = make_train_step(tc, m)
    losses = []
    for toks in batches:
        state, metrics = step(state, toks)
        losses.append(float(metrics["loss"]))
    return state, losses


def reshard_run(model, train, src, dst, n_before: int, n_after: int):
    """The never-resized run over mesh ``src`` and the resized one:
    ``n_before`` steps on ``src``, ``reshard_train_state`` onto ``dst``,
    ``n_after`` steps there (``src``, ``dst``: (axes, ranks or None)).
    Returns the losses each rank took part in; the whole state gathered
    on ``src`` just before the move (its ranks) and on ``dst`` just after
    it (the target's ranks), as numpy leaves; and on the target's ranks
    whether every leaf has its ``abstract_train_state`` shape and dtype
    (the shards of ``dst``)."""
    from tpu_composer_torch.parallel.mesh import in_mesh
    from tpu_composer_torch.parallel.train import (
        abstract_train_state,
        gather_state,
        make_train_state,
        reshard_train_state,
        tree_leaves,
    )

    def leaves(state, m):
        # Copies: the steps after update the state in place.
        return [x.numpy().copy()
                for x in tree_leaves(gather_state(tc, state, m))]

    tc = _configs(model, False, train)
    a, b = mesh(*src), mesh(*dst)
    batches = _batches(tc.model.vocab_size, n_before + n_after)
    control = resized = state = moved = kept = None
    if in_mesh(a):
        control = _steps(tc, a, make_train_state(tc, 0, "cpu", a),
                         batches)[1]
        state, resized = _steps(tc, a, make_train_state(tc, 0, "cpu", a),
                                batches[:n_before])
        kept = leaves(state, a)
    state = reshard_train_state(tc, state, b, a, "cpu")
    lands = None
    if in_mesh(b):
        moved = leaves(state, b)
        state, after = _steps(tc, b, state, batches[n_before:])
        resized = (resized or [None] * n_before) + after
        want = tree_leaves(abstract_train_state(tc, b))
        lands = [(tuple(x.shape), str(x.dtype), x.device.type)
                 == (tuple(w.shape), str(w.dtype), "cpu")
                 for x, w in zip(tree_leaves(state), want)]
        lands.append(all(w.is_meta for w in want))
    return {"control": control, "resized": resized, "lands": lands,
            "holds_state": state is not None, "kept": kept, "moved": moved}


def reshard_refused(model, src, dst):
    """A pipelined state resharded onto a mesh without pp: the error."""
    from tpu_composer_torch.parallel.mesh import in_mesh
    from tpu_composer_torch.parallel.train import (
        make_train_state,
        reshard_train_state,
    )

    tc = _configs(model, False, {"pipeline_microbatches": 2})
    a, b = mesh(*src), mesh(*dst)
    state = make_train_state(tc, 0, "cpu", a) if in_mesh(a) else None
    try:
        reshard_train_state(tc, state, b, a, "cpu")
    except ValueError as e:
        return str(e)
    return None


def checkpoint_grow(model, train, src, dst, workdir: str):
    """Save after 2 steps on ``src`` (rank 0 writes the gathered state),
    restore onto ``dst`` and take step 3 there; and step 3 of the run
    that never stopped. Returns (resumed loss, control loss, the saved
    state's leaves, the restored state's leaves gathered on ``dst``) on
    the ranks that hold them."""
    import torch.distributed as dist

    from tpu_composer_torch.parallel import checkpoint as ckpt
    from tpu_composer_torch.parallel.mesh import in_mesh
    from tpu_composer_torch.parallel.train import (
        gather_state,
        make_train_state,
        tree_leaves,
    )

    tc = _configs(model, False, train)
    a, b = mesh(*src), mesh(*dst)
    batches = _batches(tc.model.vocab_size, 3)
    control = resumed = saved = restored = None
    if in_mesh(a):
        control = _steps(tc, a, make_train_state(tc, 0, "cpu", a),
                         batches)[1][2]
        state, _ = _steps(tc, a, make_train_state(tc, 0, "cpu", a),
                          batches[:2])
        full = gather_state(tc, state, a)
        if dist.get_rank() == 0:
            ckpt.save(workdir, full, step=2)
            saved = [x.numpy().copy() for x in tree_leaves(full)]
    dist.barrier()
    if in_mesh(b):
        out = ckpt.restore(workdir, tc, "cpu", mesh=b)
        assert out["step"] == 2
        restored = [x.numpy().copy() for x in tree_leaves(
            gather_state(tc, out["state"], b))]
        resumed = _steps(tc, b, out["state"], batches[2:])[1][0]
    return resumed, control, saved, restored


def collective_bytes_step(axes, model, tokens):
    """One train step of the model (fields as ``_configs`` takes them)
    over the mesh of ``axes`` under ``record_collectives``: the summary,
    the bytes of this rank's gradients (its param shards), and its rows
    of the batch."""
    from tpu_composer_torch.parallel.train import (
        local_batch,
        make_train_state,
        make_train_step,
        tree_leaves,
    )
    from tpu_composer_torch.workload.collective_bytes import (
        record_collectives,
    )

    tc = _configs(model, False, {})
    m = mesh(axes)
    state = make_train_state(tc, 0, "cpu", m)
    toks = torch.from_numpy(tokens)
    grad_bytes = sum(p.numel() * p.element_size()
                     for p in tree_leaves(state["params"]))
    step = make_train_step(tc, m)
    with record_collectives(m) as rec:
        step(state, toks)
    return rec.summary(), grad_bytes, local_batch(tc, toks, m).shape[0]


# -- a world that joins from a coordinate env alone ---------------------------

def _bootstrapped_rank(env: Dict[str, str], local_rank: int, results) -> None:
    """``bootstrap_distributed`` from ``env`` on the CPU, then an
    all-reduce of the ranks: (rank, world size, the sum)."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    try:
        from tpu_composer_torch.workload import bootstrap_distributed

        coords = bootstrap_distributed(env=env, local_rank=local_rank,
                                       device="cpu",
                                       timeout_s=GROUP_TIMEOUT_S)
        again = bootstrap_distributed(env=env, local_rank=local_rank,
                                      device="cpu")  # a second call: no-op
        x = torch.tensor([float(dist.get_rank())])
        dist.all_reduce(x)
        results.put((coords.rank(local_rank), None, (
            dist.get_rank(), dist.get_world_size(), float(x[0]),
            again == coords)))
    except Exception:
        results.put((None, traceback.format_exc(), None))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_bootstrapped(procs, timeout: float = CASE_TIMEOUT_S) -> list:
    """One spawned process per (coordinate env, local rank) of ``procs``,
    each joining the world from that env alone: their results in rank
    order. A process that raises or does not answer in time fails the
    call; every process is gone when it returns."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    ps = [ctx.Process(target=_bootstrapped_rank, daemon=True,
                      args=(env, lr, results)) for env, lr in procs]
    for p in ps:
        p.start()
    got: Dict[int, Any] = {}
    deadline = time.monotonic() + timeout
    try:
        while len(got) < len(ps):
            try:
                rank, err, out = results.get(
                    timeout=max(0.1, deadline - time.monotonic()))
            except queue.Empty:
                raise AssertionError(
                    f"bootstrapped world: {len(ps) - len(got)} processes"
                    f" gave no result within {timeout} s") from None
            if err is not None:
                raise AssertionError(f"bootstrapped rank raised:\n{err}")
            got[rank] = out
    finally:
        for p in ps:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
    return [got[r] for r in sorted(got)]


def recorded_collective(axes, dim: str, op: str, shape, kw):
    """``op`` over ``dim`` of a float32 tensor of ``shape`` and its
    backward, under ``record_collectives``: the summary."""
    from tpu_composer_torch.parallel import collectives as coll
    from tpu_composer_torch.workload.collective_bytes import (
        record_collectives,
    )

    m = mesh(axes)
    x = torch.ones(shape, requires_grad=True)
    with record_collectives(m) as rec:
        if op == "sum_over_":
            coll.sum_over_(x.detach().clone(), m, [dim])
        else:
            getattr(coll, op)(x, m, dim, **kw).sum().backward()
    return rec.summary()
