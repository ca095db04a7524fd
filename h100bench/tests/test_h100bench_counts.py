"""The operation and byte counts against their closed forms."""

import json

from h100bench import counts as C
from h100bench.tests.small import HERE


def load(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def test_mistral_closed_form():
    d = C.Dims(load("mistral-7b"))
    attn = 4096 * 32 * 128 + 2 * 4096 * 8 * 128 + 32 * 128 * 4096
    ffn = 3 * 4096 * 14336
    assert d.layer_matmul_params() == attn + ffn
    assert d.matmul_params() == 32 * (attn + ffn) + 32768 * 4096
    assert d.kv_bytes_per_position() == 2 * 8 * 128 * 2 * 32  # 128 KiB
    assert d.kv_bytes_per_position() == 128 * 1024


def test_causal_attention_without_padding():
    d = C.Dims(load("mistral-7b"))
    n = 1000
    pairs = n * (n + 1) // 2
    assert C.prompt_flops(d, n) == 2.0 * d.matmul_params() * n + 4 * 32 * 128 * 32 * pairs
    assert C.decode_flops(d, 777) == 2.0 * d.matmul_params() + d.attn_pair_flops() * 777


def test_decode_attention_bytes():
    d = C.Dims(load("mistral-7b"))
    row = C.decode_attention_bytes(d, 100)
    assert row == 100 * 2 * 8 * 128 * 2 * 32 + 2 * 32 * 128 * 2 * 32


def test_peaks_by_card_name():
    assert C.peaks("NVIDIA H100 80GB HBM3")["bf16_flops"] == 989e12
    assert C.peaks("NVIDIA H100 80GB HBM3")["hbm_bytes_s"] == 3.35e12
    assert C.peaks("NVIDIA A100-SXM4-80GB") is None
