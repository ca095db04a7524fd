"""The trace's reduction on plain intervals: busy time, kernel time by
name, idle gaps by what the host was doing."""

import pytest

from h100bench.trace import kernel_name, summarize

MS = 1_000_000  # ns


def test_busy_kernels_and_gaps():
    window = (0, 100 * MS)
    device = [(10 * MS, 30 * MS, "void (anonymous namespace)::k2<float>(float*)"),
              (20 * MS, 40 * MS, "gemm"), (60 * MS, 70 * MS, "gemm"),
              (95 * MS, 120 * MS, "gemm")]
    spans = [(0, 50 * MS, "engine.step"), (50 * MS, 100 * MS, "engine.step")]
    ops = [(0, 8 * MS, "aten::mul"), (2 * MS, 4 * MS, "aten::copy_"),
           (45 * MS, 58 * MS, "aten::einsum")]
    t = summarize(window, device, spans, ops)
    assert t.window_s == pytest.approx(0.1)
    assert t.busy_s == pytest.approx(0.045)  # 10-40, 60-70, 95-100
    assert t.kernels["(anonymous namespace)::k2<float>"] == pytest.approx(0.02)
    assert t.kernel_seconds(["gemm"]) == pytest.approx(0.035)
    assert t.gaps["engine.step>aten::mul"] == pytest.approx(0.01)
    assert t.gaps["engine.step>aten::einsum"] == pytest.approx(0.02)
    assert t.gaps["engine.step"] == pytest.approx(0.025)
    assert sum(t.gaps.values()) == pytest.approx(0.1 - 0.045)
    b = t.breakdown(top=2)
    assert [k for k, _ in b["device_ops"]] == ["gemm", "(anonymous namespace)::k2<float>"]
    assert len(b["idle_gaps"]) == 2


def test_kernel_names_lose_their_arguments():
    assert kernel_name("void f<int>(int, float*)") == "f<int>"
    assert kernel_name("nvjet_tst_256x128") == "nvjet_tst_256x128"
