"""The dropless MoE layer's grouped path (``models/moe._grouped_ffn``,
``ops/moe_grouped.py``, kernels ``csrc/moe_grouped.cu``) against the
(E, B, C) path it replaces on the card.

On the CPU: the grouped path's plain twins, forced on through
``moe._grouped_reason``, give each layer's output within 1e-6 of the
(E, B, C) path in float32 (the products are the same rows summed in
another order) and the same routing record, over softmax top-2 of 8 and
sigmoid top-6 of 64 with shared experts after a dense layer, at decode
and prompt shapes, under a skewed router, at T·k off the row tile and
with ``drop_free`` on a capacity config; the grouping holds every
(token, choice) once, in order within its expert; and the rule keeps
the (E, B, C) path under autograd, on the CPU, over a mesh, where tokens
can drop and on operands the kernels do not take.

The tests marked ``cuda`` hold each kernel to its twin (the grouping
exactly; the products within bf16 tolerance, 2e-2, as the products'
sums run in another order; the combine bit for bit given the same y),
the whole layer to the (E, B, C) path within that tolerance, two
launches and a CUDA graph's replay to the same bits, experts with no
rows and with every row, and calls with no rows, which launch no
product and no combine.

The JAX package holds the grouped path twice: ``tests/test_torch_moe.py``
forces the twins against ``_moe_ffn`` of the JAX package on the same
inputs, and ``data/moe_grouped_jax.npy`` keeps that function's bf16
output on one drop-free layer (:func:`golden_layer`), which the twin here
and the kernels on the card are held to at the parity tests' bf16
tolerance, 2e-2 (``test_the_jax_golden_is_the_jax_output`` in that file
checks the kept output against the JAX package). This file imports no
JAX; on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_moe_grouped.py -q
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from tpu_composer_torch.models import moe
from tpu_composer_torch.ops import moe_grouped as G

torch.set_num_threads(1)

TOL_BF16 = 2e-2

CONFIGS = {
    "softmax": dict(n_experts=8, top_k=2),
    "sigmoid": dict(n_experts=64, top_k=6, scoring_func="sigmoid",
                    n_shared_experts=2, first_k_dense_replace=1,
                    routed_scaling_factor=2.446),
    "capacity": dict(n_experts=8, top_k=2, capacity_factor=1.25),
}


def _config(kind, dtype=torch.float32, d=64, f=64):
    kw = dict(CONFIGS[kind])
    kw.setdefault("capacity_factor", None)
    return moe.MoEConfig(vocab_size=64, d_model=d, n_layers=3, n_heads=4,
                         d_ff=f, moe_period=1, dtype=dtype, **kw)


def _layers(c, seed, skew=False, device="cpu"):
    """The config's FFN layers (dense where it says so), N(0, 0.05)
    weights; ``skew``: a selection bias of 10 on experts 1, 3, ... so that
    every token takes the same k experts."""
    g = torch.Generator().manual_seed(seed)

    def w(*shape):
        return (torch.randn(*shape, generator=g) * 0.05).to(device, c.dtype)

    d, f, e = c.d_model, c.d_ff, c.n_experts
    layers = []
    for i in range(c.n_layers):
        if not c.is_moe_layer(i):
            layers.append({"w_gate": w(d, f), "w_up": w(d, f),
                           "w_down": w(f, d)})
            continue
        layer = {"w_gate": w(e, d, f), "w_up": w(e, d, f),
                 "w_down": w(e, f, d),
                 "w_router": w(d, e).float()}
        if c.scoring_func == "sigmoid":
            bias = torch.randn(e, generator=g) * 0.05
            if skew:
                bias[1:2 * c.top_k:2] += 10.0
            layer["e_score_correction_bias"] = bias.to(device)
        if c.n_shared_experts:
            fs = c.n_shared_experts * f
            layer.update(shared_w_gate=w(d, fs), shared_w_up=w(d, fs),
                         shared_w_down=w(fs, d))
        layers.append(layer)
    return layers


def _run(c, layers, h, drop_free, grouped, monkeypatch):
    """Each layer's FFN delta on ``h[i]`` and each MoE layer's expert ids,
    with the grouped path forced on or off."""
    reason = moe._grouped_reason
    monkeypatch.setattr(moe, "_grouped_reason",
                        (lambda *a: None) if grouped else
                        (lambda *a: "forced"))
    ids = []
    out = [moe.ffn_delta(h[i], layer, i, c, drop_free=drop_free,
                         record=lambda li, x: ids.append((li, x)))[0]
           for i, layer in enumerate(layers)]
    monkeypatch.setattr(moe, "_grouped_reason", reason)
    return out, ids


CASES = {  # config, rows B, tokens S, skewed router, drop_free
    "softmax-decode": ("softmax", 128, 1, False, False),
    "softmax-prompt": ("softmax", 2, 512, False, False),
    "sigmoid-decode": ("sigmoid", 128, 1, False, False),
    "sigmoid-prompt": ("sigmoid", 2, 512, False, False),
    "sigmoid-skewed-decode": ("sigmoid", 128, 1, True, False),
    "sigmoid-skewed-prompt": ("sigmoid", 1, 300, True, False),
    "softmax-ragged": ("softmax", 3, 7, False, False),
    "sigmoid-ragged": ("sigmoid", 5, 3, False, False),
    "capacity-drop-free": ("capacity", 4, 16, False, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_grouped_twin_equals_the_ebc_path(case, monkeypatch):
    kind, b, s, skew, drop_free = CASES[case]
    c = _config(kind)
    layers = _layers(c, 7, skew)
    g = torch.Generator().manual_seed(11)
    h = [torch.randn(b, s, c.d_model, generator=g) for _ in layers]
    want, want_ids = _run(c, layers, h, drop_free, False, monkeypatch)
    got, got_ids = _run(c, layers, h, drop_free, True, monkeypatch)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=0, atol=1e-6)
    assert [li for li, _ in got_ids] == [li for li, _ in want_ids] == [
        i for i in range(c.n_layers) if c.is_moe_layer(i)]
    assert all(torch.equal(a, w) for (_, a), (_, w) in zip(got_ids,
                                                            want_ids))
    if skew:
        chosen = set(want_ids[0][1].unique().tolist())
        assert chosen == set(range(1, 2 * c.top_k, 2))


@pytest.mark.parametrize("kind", ["softmax", "sigmoid"])
def test_the_grouping_holds_each_pair_once_in_order(kind):
    """Each (token, choice) lies at one sorted row of its expert, the
    rows of an expert keep the (token, choice) order, and the offsets
    count each expert's pairs."""
    c = _config(kind)
    g = torch.Generator().manual_seed(3)
    experts = torch.stack([torch.randperm(c.n_experts, generator=g)[
        :c.top_k] for _ in range(37)])
    offsets, tok, row = G.group_plain(experts, c.n_experts)
    t, k = experts.shape
    flat = experts.reshape(-1)
    assert offsets.dtype == tok.dtype == row.dtype == torch.int32
    assert offsets[0] == 0 and offsets[-1] == t * k
    assert torch.equal(offsets.diff().long(),
                       torch.bincount(flat, minlength=c.n_experts))
    assert sorted(row.tolist()) == list(range(t * k))
    for i in range(t * k):
        r = int(row[i])
        e = int(flat[i])
        assert offsets[e] <= r < offsets[e + 1]
        assert int(tok[r]) == i // k
    pairs = torch.empty(t * k, dtype=torch.long)
    pairs[row.long()] = torch.arange(t * k)
    for e in range(c.n_experts):
        span = pairs[int(offsets[e]):int(offsets[e + 1])]
        assert torch.equal(span, span.sort().values)


def _operands(kind, dtype=torch.bfloat16, b=2, s=4, requires_grad=False):
    c = _config(kind, dtype)
    layer = _layers(c, 1)[c.first_k_dense_replace]
    if requires_grad:
        layer["w_gate"].requires_grad_()
    x = torch.randn(b, s, c.d_model).to(dtype)
    return c, layer, x


@pytest.mark.parametrize("what,reason", [
    ("cpu", "device"), ("autograd", "autograd"), ("fp32", "dtype"),
    ("quantized", "dtype"), ("transposed", "layout"), ("mesh", "mesh"),
    ("capacity", "capacity")])
def test_the_rule_keeps_the_ebc_path(what, reason):
    """Each call the grouped kernels cannot take, or on which a token
    can drop, names its reason; on the CPU the layer launches no kernel
    and builds its queue slots."""
    kind = "capacity" if what == "capacity" else "softmax"
    c, layer, x = _operands(kind, torch.float32 if what == "fp32"
                            else torch.bfloat16,
                            requires_grad=what == "autograd")
    mesh = object() if what == "mesh" else None
    if what == "quantized":
        from tpu_composer_torch.models.quant import quantize_decode_params
        layer = quantize_decode_params({
            "embed": torch.zeros(c.vocab_size, c.d_model), "ln_f": None,
            "layers": [layer]})["layers"][0]
    if what == "transposed":
        layer["w_up"] = layer["w_up"].transpose(1, 2).contiguous(
        ).transpose(1, 2)
    assert moe._grouped_reason(x, layer, c.capacity(x.shape[1]),
                               mesh) == reason
    if what in ("cpu", "capacity"):
        before = G.group_cuda.launches
        slots = []
        route = moe._route

        def seen(logits, top_k, capacity):
            out = route(logits, top_k, capacity)
            slots.append(out[1])
            return out

        moe._route = seen
        try:
            moe._moe_ffn(x, layer, c)
        finally:
            moe._route = route
        assert G.group_cuda.launches == before
        assert slots and slots[0] is not None


def test_drop_free_lifts_the_capacity_reason():
    c, layer, x = _operands("capacity", b=1, s=64)
    assert c.capacity(64) < 64
    assert moe._grouped_reason(x, layer, c.capacity(64), None) == "capacity"
    assert moe._grouped_reason(x, layer, 64, None) == "device"


def test_the_kernels_refuse_cpu_operands():
    c, layer, x = _operands("softmax")
    experts = torch.zeros((8, 2), dtype=torch.long)
    with pytest.raises(ValueError, match="CUDA"):
        G.group_cuda(experts, c.n_experts)
    offsets, tok, row = G.group_plain(experts, c.n_experts)
    with pytest.raises(ValueError, match="CUDA"):
        G.gate_up_cuda(x.reshape(8, -1), tok, layer["w_gate"],
                       layer["w_up"], offsets)
    with pytest.raises(ValueError, match="CUDA"):
        G.combine_cuda(torch.zeros((16, c.d_model), dtype=torch.bfloat16),
                       row, torch.zeros((8, 2)))


def test_the_combine_twin_is_the_ebc_combine():
    """The twin's arithmetic is the (E, B, C) path's last step: gates
    rounded to bf16, fp32 products summed in choice order, the shared
    output added, one rounding."""
    g = torch.Generator().manual_seed(5)
    t, k, d = 9, 6, 32
    y = torch.randn(t * k, d, generator=g).to(torch.bfloat16)
    row = torch.randperm(t * k, generator=g).to(torch.int32)
    gates = torch.rand(t, k, generator=g)
    shared = torch.randn(t, d, generator=g).to(torch.bfloat16)
    picked = y[row.long()].reshape(t, k, d).float()
    w = gates.to(torch.bfloat16).float()
    want = w[:, 0, None] * picked[:, 0]
    for j in range(1, k):
        want = want + w[:, j, None] * picked[:, j]
    want = (want + shared.float()).to(torch.bfloat16)
    assert torch.equal(G.combine_plain(y, row, gates, shared), want)


#: One drop-free softmax top-2 of 8 layer at widths the kernels take, and
#: the JAX package's bf16 ``_moe_ffn`` output on it, as float32.
GOLDEN_FIELDS = dict(vocab_size=128, d_model=128, n_layers=2, n_heads=4,
                     d_ff=128, max_seq=64, n_experts=8, top_k=2,
                     capacity_factor=1.25, moe_period=1)
GOLDEN_FILE = Path(__file__).parent / "data" / "moe_grouped_jax.npy"


def golden_layer(seed=2028, b=4, s=16):
    """The golden layer's inputs as float32 numpy arrays: x (B, S, D) and
    the layer's w_gate, w_up (E, D, F), w_down (E, F, D) (to be rounded to
    bf16 on both sides) and w_router (D, E) (kept in float32). The rule
    gives the layer 5 slots an expert, so the call passes the drop-free
    capacity S."""
    rng = np.random.default_rng(seed)
    d, f, e = (GOLDEN_FIELDS[k] for k in ("d_model", "d_ff", "n_experts"))
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    layer = {name: (rng.standard_normal(shape) * 0.1).astype(np.float32)
             for name, shape in (("w_gate", (e, d, f)), ("w_up", (e, d, f)),
                                 ("w_down", (e, f, d)),
                                 ("w_router", (d, e)))}
    return x, layer


def _golden_run(device, grouped, monkeypatch):
    """The port's ``_moe_ffn`` on the golden layer in bf16, with the grouped
    path forced on the CPU (``grouped``) or taken by the rule on the card;
    (output as float32 numpy, group launches it made)."""
    x, layer = golden_layer()
    c = moe.MoEConfig(dtype=torch.bfloat16, **GOLDEN_FIELDS)
    tl = {k: torch.from_numpy(v).to(device, torch.float32 if k == "w_router"
                                    else torch.bfloat16)
          for k, v in layer.items()}
    tx = torch.from_numpy(x).to(device, torch.bfloat16)
    assert c.capacity(x.shape[1]) < x.shape[1]
    if grouped:
        monkeypatch.setattr(moe, "_grouped_reason", lambda *a: None)
    before = G.group_cuda.launches
    out, _ = moe._moe_ffn(tx, tl, c, capacity=x.shape[1])
    return out.float().cpu().numpy(), G.group_cuda.launches - before


def test_the_grouped_twin_matches_the_jax_golden(monkeypatch):
    got, launched = _golden_run("cpu", True, monkeypatch)
    assert launched == 0
    want = np.load(GOLDEN_FILE)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_BF16)


# -- on the card -------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


#: (config, E, k, D, F, tokens): the two cells' widths at a decode step
#: and an admission, a narrow case with N % 128 == 64 in the down product
#: and T·k off every tile, and one expert per token.
CARD_SHAPES = {
    "moonlight-decode": (64, 6, 2048, 1408, 128),
    "mixtral-decode": (8, 2, 4096, 14336, 128),
    "moonlight-admit": (64, 6, 2048, 1408, 1024),
    "narrow-ragged": (8, 2, 192, 320, 37),
    "top1": (4, 1, 128, 64, 300),
}


def _card_inputs(name, dev, seed=0, skew=False):
    e, k, d, f, t = CARD_SHAPES[name]
    g = torch.Generator(device=dev).manual_seed(seed)

    def w(*shape, std=0.02):
        return (torch.randn(*shape, generator=g, device=dev) * std).to(
            torch.bfloat16)

    x = w(t, d, std=1.0)
    if skew:
        experts = torch.arange(k, device=dev).expand(t, k).contiguous()
    else:
        scores = torch.rand(t, e, generator=g, device=dev)
        experts = scores.topk(k, dim=-1).indices
    gates = torch.rand(t, k, generator=g, device=dev)
    return (x, experts, gates, w(e, d, f), w(e, d, f), w(e, f, d),
            w(t, d, std=0.1))


@pytest.mark.cuda
@pytest.mark.parametrize("skew", [False, True], ids=["spread", "skewed"])
@pytest.mark.parametrize("name", sorted(CARD_SHAPES))
def test_each_kernel_matches_its_twin_on_the_card(name, skew):
    dev = _card()
    x, experts, gates, wg, wu, wd, shared = _card_inputs(name, dev, 1, skew)
    e = wg.shape[0]
    launches = [f.launches for f in (G.group_cuda, G.gate_up_cuda,
                                     G.down_cuda, G.combine_cuda)]
    offsets, tok, row = G.group_cuda(experts, e)
    want = G.group_plain(experts, e)
    assert all(torch.equal(a, b) for a, b in zip((offsets, tok, row), want))
    if skew:  # experts k.. hold no row, experts 0..k-1 every token
        counts = offsets.diff()
        assert (counts[:experts.shape[1]] == experts.shape[0]).all()
        assert (counts[experts.shape[1]:] == 0).all()
    h = G.gate_up_cuda(x, tok, wg, wu, offsets)
    torch.testing.assert_close(h.float(), G.gate_up_plain(
        x, tok, wg, wu, offsets).float(), rtol=TOL_BF16, atol=TOL_BF16)
    y = G.down_cuda(h, wd, offsets)
    torch.testing.assert_close(y.float(), G.down_plain(
        h, wd, offsets).float(), rtol=TOL_BF16, atol=TOL_BF16)
    for sh in (None, shared):
        assert torch.equal(G.combine_cuda(y, row, gates, sh),
                           G.combine_plain(y, row, gates, sh))
    torch.cuda.synchronize()
    assert [f.launches for f in (G.group_cuda, G.gate_up_cuda, G.down_cuda,
                                 G.combine_cuda)] == [
        launches[0] + 1, launches[1] + 1, launches[2] + 1, launches[3] + 2]


def _grouped_layer(inputs):
    x, experts, gates, wg, wu, wd, shared = inputs
    offsets, tok, row = G.group_cuda(experts, wg.shape[0])
    h = G.gate_up_cuda(x, tok, wg, wu, offsets)
    return G.combine_cuda(G.down_cuda(h, wd, offsets), row, gates, shared)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CARD_SHAPES))
def test_two_launches_and_a_replay_give_the_same_bits(name):
    dev = _card()
    inputs = _card_inputs(name, dev, 2)
    first = _grouped_layer(inputs)
    assert torch.equal(first, _grouped_layer(inputs))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _grouped_layer(inputs)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = _grouped_layer(inputs)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, first)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,b,s,skew", [
    ("softmax", 128, 1, False), ("sigmoid", 128, 1, False),
    ("sigmoid", 1, 300, True), ("softmax", 2, 200, False)])
def test_the_layer_matches_the_ebc_path_on_the_card(kind, b, s, skew,
                                                    monkeypatch):
    """The grouped layer on the card against the (E, B, C) path on the
    same bf16 operands: the same routing record, outputs within bf16
    tolerance."""
    dev = _card()
    c = _config(kind, torch.bfloat16, d=256, f=192)
    layers = _layers(c, 9, skew, device=dev)
    g = torch.Generator(device=dev).manual_seed(4)
    h = [torch.randn(b, s, c.d_model, generator=g, device=dev).to(
        torch.bfloat16) for _ in layers]
    i = c.first_k_dense_replace
    assert moe._grouped_reason(h[i], layers[i], s, None) is None
    before = G.group_cuda.launches
    ids = []
    got = [moe.ffn_delta(h[i], layer, i, c, drop_free=True,
                         record=lambda li, x: ids.append(x))[0]
           for i, layer in enumerate(layers)]
    assert G.group_cuda.launches == before + len(ids)
    want, want_ids = _run(c, layers, h, True, False, monkeypatch)
    for a, w in zip(got, want):
        torch.testing.assert_close(a.float(), w.float(), rtol=TOL_BF16,
                                   atol=TOL_BF16)
    assert all(torch.equal(a, w) for a, (_, w) in zip(ids, want_ids))


@pytest.mark.cuda
def test_the_layer_matches_the_jax_golden_on_the_card(monkeypatch):
    """The kernels on the golden layer, the grouped path taken by the
    rule, against the JAX package's output on the same bf16 inputs."""
    dev = _card()
    got, launched = _golden_run(dev, False, monkeypatch)
    assert launched == 1
    np.testing.assert_allclose(got, np.load(GOLDEN_FILE), rtol=0,
                               atol=TOL_BF16)


@pytest.mark.cuda
@pytest.mark.parametrize("with_shared", [False, True])
def test_a_call_with_no_rows_launches_no_product(with_shared):
    """No token: the grouping still launches (it writes the offsets, all
    0); the products and the combine launch nothing and count nothing."""
    dev = _card()
    x, _, _, wg, wu, wd, shared = _card_inputs("narrow-ragged", dev)
    e, k = wg.shape[0], CARD_SHAPES["narrow-ragged"][1]
    fns = (G.group_cuda, G.gate_up_cuda, G.down_cuda, G.combine_cuda)
    before = [f.launches for f in fns]
    offsets, tok, row = G.group_cuda(
        torch.empty((0, k), dtype=torch.long, device=dev), e)
    h = G.gate_up_cuda(x[:0], tok, wg, wu, offsets)
    y = G.down_cuda(h, wd, offsets)
    out = G.combine_cuda(y, row, torch.empty((0, k), device=dev),
                         shared[:0] if with_shared else None)
    torch.cuda.synchronize()
    assert (offsets == 0).all() and tok.numel() == row.numel() == 0
    assert h.shape == (0, wg.shape[-1]) and y.shape == (0, wd.shape[-1])
    assert out.shape == (0, x.shape[-1])
    assert [f.launches for f in fns] == [before[0] + 1] + before[1:]
