"""The process's peak of allocated device memory
(``torch.cuda.max_memory_allocated`` when the window closes) over the
card's memory."""

LAYER = "device"
UNIT = "%"
MOVES = "gen_tok_s"


def read(run):
    total = run.device.get("memory_total_bytes")
    if not total:
        return None
    return 100.0 * run.device["memory_peak_bytes"] / total
