"""SwiGLU's element-wise step (``ops/swiglu.py``, kernel
``csrc/swiglu.cu``) and its two call sites, the dense FFN
(``models/transformer.swiglu_ffn``) and the MoE experts
(``models/moe._moe_ffn``).

On the CPU: the shared eager chain gives the bits of the chain the call
sites ran inline before it; the dispatch rule picks the chain for CPU,
non-bf16, non-contiguous and autograd-recorded operands; the forward and
the gradients through both call sites are those of the inline chain; and
the engine's spans carry ``swiglu_fused`` (0 on the CPU). The tests
marked ``cuda`` hold the kernel to the eager chain bit for bit (the
cells' shapes, ragged and unaligned operands, every bf16 gate against
the edge values, inside a CUDA graph) and the engines' spans to their
layer counts. Tolerances: none, every comparison is bit for bit. This
file imports no JAX; on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_swiglu.py -q
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tpu_composer_torch.models import moe, transformer
from tpu_composer_torch.models.serving import ContinuousBatchingEngine
from tpu_composer_torch.ops import swiglu as S
from tpu_composer_torch.runtime import tracing

torch.set_num_threads(1)

SPECIAL = [0.0, -0.0, 1.0, -1.0, math.inf, -math.inf, math.nan, 88.5,
           -88.5, 100.0, -100.0, 3.3895e38, -3.3895e38, 9.2e-41]


def _inline(gate, up, dtype):
    """The chain both call sites ran inline before the shared one."""
    return (F.silu(gate.float()) * up.float()).to(dtype)


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _same(a, b):
    return a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


def _operands(shape, dtype, seed=0, device="cpu"):
    """(gate, up) of ``shape``: N(0, 4) draws with the edge values
    (±0, ±inf, NaN, |x| past 88, the largest finite and a subnormal)
    written over the first elements."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        x = rng.standard_normal(int(np.prod(shape)), np.float32) * 2.0
        n = min(len(SPECIAL), x.size)
        x[:n] = np.array(SPECIAL[:n], np.float32)
        rng.shuffle(x)
        out.append(torch.from_numpy(x.reshape(shape)).to(device, dtype))
    return out


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape", [(3, 5), (2, 4, 16), (8, 1, 7, 12)])
def test_the_shared_chain_equals_the_inline_chain(shape, dtype):
    """``swiglu_plain``, and ``swiglu`` on the CPU, give the inline
    chain's bits, edge values included."""
    gate, up = _operands(shape, dtype)
    want = _inline(gate, up, dtype)
    assert _same(S.swiglu_plain(gate, up), want)
    assert _same(S.swiglu(gate, up), want)


def _case(name):
    gate, up = _operands((4, 8), torch.bfloat16)
    if name == "cpu":
        return gate, up
    if name == "fp32":
        return gate.float(), up.float()
    if name == "fp16":
        return gate.half(), up.half()
    if name == "mixed":
        return gate, up.float()
    if name == "transposed":
        return gate.t(), up.t()
    if name in ("grad", "grad-off"):
        return gate.requires_grad_(), up
    raise AssertionError(name)


@pytest.mark.parametrize("name,reason", [
    ("cpu", "device"), ("fp32", "dtype"), ("fp16", "dtype"),
    ("mixed", "dtype"), ("transposed", "layout"), ("grad", "autograd"),
    ("grad-off", "device")])
def test_the_dispatch_rule_picks_the_eager_chain(name, reason):
    """Each operand the kernel does not take names its reason, the first
    that applies; with autograd off a leaf that requires grad is no
    reason. ``swiglu`` then gives the eager chain's bits."""
    gate, up = _case(name)
    launched = S.swiglu_cuda.launches
    if name == "grad-off":
        with torch.no_grad():
            assert S.eager_reason(gate, up) == reason
            got = S.swiglu(gate, up)
    else:
        assert S.eager_reason(gate, up) == reason
        got = S.swiglu(gate, up)
    assert S.swiglu_cuda.launches == launched
    assert _same(got, S.swiglu_plain(gate, up))


def test_the_kernel_refuses_cpu_operands():
    gate, up = _operands((4, 8), torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        S.swiglu_cuda(gate, up)


def _ffn_inline(h, layer, dtype):
    """``swiglu_ffn`` as it was written before the shared chain."""
    gate = F.silu(torch.einsum("bsd,df->bsf", h, layer["w_gate"]).float())
    up = torch.einsum("bsd,df->bsf", h, layer["w_up"]).float()
    return torch.einsum("bsf,fd->bsd", (gate * up).to(dtype),
                        layer["w_down"])


def _leaves(names, dtype, seed):
    rng = np.random.default_rng(seed)
    return {n: torch.from_numpy(rng.standard_normal(shape, np.float32)
                                * scale).to(dtype).requires_grad_()
            for n, (shape, scale) in names.items()}


def _grads(fn, leaves, seed):
    out = fn()
    cot = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        out.shape, np.float32)).to(out.dtype)
    grads = torch.autograd.grad(out, list(leaves.values()), cot)
    return out.detach(), grads


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_swiglu_ffn_keeps_its_forward_and_gradients(dtype):
    """The dense FFN through the shared chain against the inline one:
    the same output and gradients for the input and all three weights,
    bit for bit."""
    d, f = 16, 40
    leaves = _leaves({"h": ((2, 5, d), 1.0), "w_gate": ((d, f), 0.3),
                      "w_up": ((d, f), 0.3), "w_down": ((f, d), 0.3)},
                     dtype, 1)
    layer = {k: v for k, v in leaves.items() if k != "h"}
    got = _grads(lambda: transformer.swiglu_ffn(leaves["h"], layer, dtype),
                 leaves, 2)
    want = _grads(lambda: _ffn_inline(leaves["h"], layer, dtype), leaves, 2)
    assert _same(got[0], want[0])
    for a, b in zip(got[1], want[1]):
        assert _same(a, b)


def _moe_config(dtype, capacity_factor=None):
    return moe.MoEConfig(vocab_size=64, d_model=16, n_layers=2, n_heads=2,
                         d_ff=24, max_seq=32, dtype=dtype, n_experts=4,
                         top_k=2, capacity_factor=capacity_factor,
                         moe_period=1)


@pytest.mark.parametrize("capacity_factor", [None, 1.25],
                         ids=["dropless", "capacity"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_moe_ffn_keeps_its_forward_and_gradients(monkeypatch, dtype,
                                                 capacity_factor):
    """The MoE experts through the shared chain against the inline one
    (patched in where ``_moe_ffn`` calls it): the same output, aux loss
    and gradients for the input and the layer's weights, bit for bit."""
    c = _moe_config(dtype, capacity_factor)
    params = moe.init_params(c, seed=3, device="cpu")
    layer = {k: v.detach().clone().requires_grad_()
             for k, v in params["layers"][0].items()
             if k in ("w_gate", "w_up", "w_down", "w_router")}
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 6, c.d_model), np.float32)).to(dtype).requires_grad_()
    leaves = {"x": x, **layer}

    def run():
        out, aux = moe._moe_ffn(x, layer, c)
        return out.float() + aux

    got = _grads(run, leaves, 5)
    monkeypatch.setattr(moe, "swiglu",
                        lambda g, u: _inline(g, u, c.dtype))
    want = _grads(run, leaves, 5)
    assert _same(got[0], want[0])
    for a, b in zip(got[1], want[1]):
        assert _same(a, b)


# -- the engine's spans ------------------------------------------------------

@pytest.fixture
def ring():
    was = tracing.enabled()
    tracing.set_enabled(True)
    tracing.reset()
    yield tracing
    tracing.set_enabled(was)
    tracing.reset()


def _dense(device, dtype):
    """Three layers; head_dim 64 on the card (K1's), 16 on the CPU."""
    d = 256 if device == "cuda" else 64
    c = transformer.ModelConfig(
        vocab_size=256, d_model=d, n_layers=3, n_heads=4, n_kv_heads=2,
        d_ff=2 * d, max_seq=256, dtype=dtype,
        attn_impl="flash" if device == "cuda" else "reference")
    return c, transformer.init_params(c, seed=0, device=device)


def _moe(device, dtype):
    """Four layers, two of them MoE (dropless, 8 experts, top-2)."""
    c = moe.MoEConfig(vocab_size=256, d_model=64, n_layers=4, n_heads=4,
                      n_kv_heads=2, d_ff=128, max_seq=256, dtype=dtype,
                      capacity_factor=None, moe_period=2)
    return c, moe.init_params(c, seed=0, device=device)


ENGINES = {"dense": (_dense, {}), "dense-chunked": (_dense,
                                                    {"prefill_chunk": 8}),
           "moe": (_moe, {})}


def _spans(kind, device, dtype, graphed=True):
    """Serve five requests through ``kind``'s engine, one submitted a
    step; return (config, every ``serving.admit``/``serving.decode``
    span, every ``moe.experts`` span)."""
    make, kw = ENGINES[kind]
    c, params = make(device, dtype)
    eng = ContinuousBatchingEngine(params, c, slots=3, num_blocks=48,
                                   block_size=8, **kw)
    eng._graphed = eng._graphed and graphed
    rng = np.random.default_rng(1)
    for n, new in ((11, 4), (5, 6), (19, 3), (8, 5), (14, 4)):
        eng.submit(rng.integers(0, 256, n).tolist(), new)
        eng.step()
    eng.run()
    events = tracing.snapshot(cat="serving")
    steps = [e for e in events
             if e["name"] in ("serving.admit", "serving.decode")]
    experts = [e for e in events if e["name"] == "moe.experts"]
    return c, steps, experts


@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_the_spans_count_no_fused_products_on_the_cpu(ring, kind):
    """On the CPU every admission and decode span reads
    ``swiglu_fused`` 0 and every ``moe.experts`` span ``fused`` 0."""
    c, steps, experts = _spans(kind, "cpu", torch.bfloat16)
    assert {e["name"] for e in steps} == {"serving.admit", "serving.decode"}
    assert [e["args"]["swiglu_fused"] for e in steps] == [0] * len(steps)
    if kind == "moe":
        assert [e["args"]["moe_grouped"] for e in steps] == [0] * len(steps)
    assert len(experts) == (2 * len(steps) if kind == "moe" else 0)
    assert all(e["args"]["fused"] == 0 for e in experts)


# -- on the card -------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 128, 14336), (128, 14336),
                                   (2048, 14336), (8, 1024, 14336),
                                   (37, 1003)],
                         ids=["moe-decode", "dense-decode", "dense-prefill",
                              "moe-admit", "ragged"])
def test_the_kernel_equals_the_eager_chain_on_the_card(shape):
    """The kernel's output has the eager chain's bits, edge values
    included, and launches once."""
    dev = _card()
    gate, up = _operands(shape, torch.bfloat16, seed=7, device=dev)
    launched = S.swiglu_cuda.launches
    got = S.swiglu(gate, up)
    assert S.swiglu_cuda.launches == launched + 1
    assert _same(got, S.swiglu_plain(gate, up))


@pytest.mark.cuda
def test_every_bf16_gate_matches_the_eager_chain_on_the_card():
    """Every bf16 bit pattern as the gate against up values that hold
    the edge values: the kernel's bits are the eager chain's; and on an
    operand that is not 16-byte aligned (the scalar path)."""
    dev = _card()
    gate = torch.arange(-32768, 32768, dtype=torch.int32).to(
        torch.int16).view(torch.bfloat16)
    up = torch.tensor(SPECIAL + list(np.linspace(-6, 6, 50)),
                      dtype=torch.float32).to(torch.bfloat16)
    gate = gate[:, None].expand(-1, len(up)).contiguous().to(dev)
    up = up[None, :].expand(65536, -1).contiguous().to(dev)
    assert _same(S.swiglu_cuda(gate, up), S.swiglu_plain(gate, up))
    flat_g, flat_u = gate.reshape(-1)[1:8 * 1003 + 1], up.reshape(-1)[:8 * 1003]
    assert flat_g.data_ptr() % 16 != 0
    assert _same(S.swiglu_cuda(flat_g, flat_u),
                 S.swiglu_plain(flat_g, flat_u))


@pytest.mark.cuda
def test_a_captured_kernel_replays_the_eager_result_on_the_card():
    """Captured in a CUDA graph on fresh inputs, the kernel's replay
    gives the eager chain's bits for the inputs copied in after."""
    dev = _card()
    gate, up = _operands((8, 128, 14336), torch.bfloat16, seed=8,
                         device=dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        S.swiglu(gate, up)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = S.swiglu(gate, up)
    new_g, new_u = _operands((8, 128, 14336), torch.bfloat16, seed=9,
                             device=dev)
    gate.copy_(new_g)
    up.copy_(new_u)
    graph.replay()
    torch.cuda.synchronize()
    assert _same(out, S.swiglu_plain(new_g, new_u))


@pytest.mark.cuda
@pytest.mark.parametrize("graphed", [True, False], ids=["graph", "eager"])
@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_the_spans_count_every_layer_fused_on_the_card(ring, kind, graphed):
    """A bf16 engine on the card runs every dense layer's SwiGLU through
    the kernel, and every MoE layer's inside the grouped path's gate/up
    kernel (``csrc/moe_grouped.cu``): each admission and decode span
    reads ``swiglu_fused`` equal to the dense layers and ``moe_grouped``
    to the MoE layers, replayed or eager, and each ``moe.experts`` span
    ``fused`` 0 and ``grouped`` 1."""
    dev = _card()
    c, steps, experts = _spans(kind, dev.type, torch.bfloat16, graphed)
    n_moe = sum(map(getattr(c, "is_moe_layer", lambda i: False),
                    range(c.n_layers)))
    assert {e["name"] for e in steps} == {"serving.admit", "serving.decode"}
    assert [e["args"]["swiglu_fused"] for e in steps] == (
        [c.n_layers - n_moe] * len(steps))
    assert all(e["args"]["fused"] == 0 and e["args"]["grouped"] == 1
               for e in experts)
    if kind == "moe":
        assert n_moe == 2 and experts
        assert [e["args"]["moe_grouped"] for e in steps] == (
            [n_moe] * len(steps))
        # A replay's rows are the captured layers' B·S·k, as its real.
        replays = [e["args"] for e in steps if e["args"]["graph"]
                   and e["name"] == "serving.decode"]
        assert bool(replays) == graphed
        assert all(a["rows"] == a["real"] == 3 * c.top_k * n_moe
                   for a in replays)
