"""K3's share of its roofline over the traced steps: the bytes the latent
decode attention must move (every latent entry it reads once, 1,152
bytes a position and layer at the published widths, each row's absorbed
query in and latent output out; ``h100bench/mla_counts.py``) at the
card's HBM bandwidth, over the device time of the kernels named below.
The entries read are the ``latent_positions`` of each traced step's
``serving.decode`` span (``h100bench/spans.py``). K3 is bound by bytes:
its operations, about 30 a byte, take a tenth of that time at the bf16
peak."""

from h100bench.mla_counts import MLADims
from h100bench.spans import trees

LAYER = "attention kernels (ops/, csrc/)"
UNIT = "%"
MOVES = "gen_tok_s"
KERNELS = ("mla_decode_split_kernel", "mla_decode_merge_kernel")


def read(run):
    if run.peaks is None or run.trace is None:
        return None
    seconds = run.trace.kernel_seconds(KERNELS)
    steps = [s for s in run.traced_steps if s["rows"]]
    if seconds <= 0 or not steps:
        return None
    ts = trees(steps)
    if ts is None:
        return None
    spans = [e["args"] for t in ts for e in t.named("serving.decode")]
    if not spans or any("latent_positions" not in a for a in spans):
        return None
    d = MLADims(run.cfg)
    moved = (sum(a["latent_positions"] for a in spans) * d.latent * d.bytes
             + d.row_io_bytes() * sum(s["rows"] for s in steps))
    return 100.0 * moved / run.peaks["hbm_bytes_s"] / seconds
