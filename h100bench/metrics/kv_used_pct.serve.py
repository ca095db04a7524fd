"""Blocks of the paged pool that hold live tokens (each in-flight row's
written positions, in whole blocks), over the pool's blocks, the mean
over the window's steps."""

LAYER = "paged cache (models/paged.py)"
UNIT = "%"
MOVES = "gen_tok_s"


def read(run):
    if not run.steps:
        return None
    e = run.mix["engine"]
    pool = int(e["slots"]) * int(e["blocks_per_slot"])
    mean = sum(s["live_blocks"] for s in run.steps) / len(run.steps)
    return 100.0 * mean / pool
