"""A run with the timed path broken underneath comes out not correct:
each fault a cell can have, planted in the program, on the CPU at a small
size (the harness's look for a chip skipped)."""

import pytest

from h100bench import judge as J
from h100bench import run as R
from h100bench.tests.small import BENCH, EXACT, cell, config, mix
from tpu_composer_torch.models import paged, serving


@pytest.fixture(autouse=True)
def exact(monkeypatch):
    monkeypatch.setattr(J, "limits", lambda name: EXACT)


def serve():
    return R.execute(BENCH, cell(), 2**31 + 21, 0.6, False, "cpu",
                     cfg=config(), mix=mix())


def altered_token(monkeypatch):
    emit = serving.ContinuousBatchingEngine._emit
    monkeypatch.setattr(serving.ContinuousBatchingEngine, "_emit",
                        lambda self, slot, tok: emit(self, slot, (tok + 1) % 256))


def state_unchanged(monkeypatch):
    write = paged._write_kv_layer
    monkeypatch.setattr(paged, "_write_kv_layer",
                        lambda cache, li, index, k, v: write(cache, li, None, k, v))


def half_batch(monkeypatch):
    step = serving.paged_decode_step

    def half(*a, **kw):
        logits, cache, ok = step(*a, **kw)
        logits = logits.clone()
        logits[logits.shape[0] // 2:] = 0
        return logits, cache, ok

    monkeypatch.setattr(serving, "paged_decode_step", half)


@pytest.mark.parametrize("fault", [altered_token, state_unchanged, half_batch])
def test_serving_fault_is_not_correct(monkeypatch, fault):
    assert serve()["correct"]
    fault(monkeypatch)
    out = serve()
    assert not out["correct"]
    assert out["checks"]["max_gap"]["value"] > 1e-3


def test_a_wrong_token_id_counts_as_failed(monkeypatch):
    emit = serving.ContinuousBatchingEngine._emit
    monkeypatch.setattr(serving.ContinuousBatchingEngine, "_emit",
                        lambda self, slot, tok: emit(self, slot, 10**6))
    with pytest.raises((IndexError, RuntimeError, ValueError)):
        serve()
