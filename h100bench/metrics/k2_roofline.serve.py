"""K2's share of its roofline over the traced steps: the bytes the decode
attention must move (every live K and V read once, q in, the output out;
``h100bench/counts.py``) at the card's HBM bandwidth, over the device time
of the kernels named below. K2 is bound by bytes: its operations at the
bf16 peak take under a tenth of that time."""

from h100bench.counts import decode_attention_bytes

LAYER = "attention kernels (ops/, csrc/)"
UNIT = "%"
MOVES = "gen_tok_s"
KERNELS = ("paged_decode_split_kernel", "paged_decode_merge_kernel")


def read(run):
    if run.peaks is None or run.trace is None:
        return None
    seconds = run.trace.kernel_seconds(KERNELS)
    steps = run.traced_steps
    if seconds <= 0 or not steps:
        return None
    d = run.dims
    moved = sum(decode_attention_bytes(d, 0) * s["rows"]
                + d.kv_bytes_per_position() * s["keys"] for s in steps)
    return 100.0 * moved / run.peaks["hbm_bytes_s"] / seconds
