"""K1's share of its roofline at MLA's expanded prefill (192-wide query
and key, 128-wide value) over the traced admissions: the causal (q, k)
pairs of the padded length each admission runs (``serving.admit``'s
``padded``; h100bench/spans.py), each 2·H·(192 + 128) operations a
layer (``mla_counts.MLADims.pair_flops``), at the card's bf16 peak, over
the device time of K1's 192 instances. The kernel's own work is larger:
it runs v zero-padded to 192, which this count leaves out."""

from h100bench.mla_counts import MLADims
from h100bench.spans import trees

LAYER = "attention kernels (ops/, csrc/)"
UNIT = "%"
MOVES = "gen_tok_s"
KERNELS = ("flash_fwd_tc_kernel<192",)


def read(run):
    if run.peaks is None or run.trace is None:
        return None
    seconds = run.trace.kernel_seconds(KERNELS)
    steps = [s for s in run.traced_steps if s["admit"]]
    if seconds <= 0 or not steps:
        return None
    ts = trees(steps)
    if ts is None:
        return None
    padded = [e["args"]["padded"] for t in ts for e in t.named("serving.admit")]
    if not padded:
        return None
    pairs = sum(n * (n + 1) // 2 for n in padded)
    flops = pairs * MLADims(run.cfg).pair_flops()
    return 100.0 * flops / run.peaks["bf16_flops"] / seconds
