"""Serving: the program's ``ContinuousBatchingEngine`` under a mix's
closed loop of clients, timed on the host clock, its served tokens held
against the plain reference.

The engine admits prompts by bucketed prefill, keeps its K/V pool in
bfloat16 and reads decode steps through the paged decode kernel (K2).

Set-up makes the weights on the device, builds the engine, runs one short
request at every padded prompt shape (kernels built and loaded, every
shape warm), and fills the engine: one request per client, stepped until
each of them has its first token, so every slot has been admitted once,
and no later request waits for its own. The window then opens and the
engine steps until ``--seconds`` have passed; each step ends in the
engine's own host read of the picked tokens, so a step's events are on
the host when it returns.

Per step the benchmark books, from the events alone: whether the step
carried an admission (a submitted request had no first token when it
began), the rows it decoded and the keys each attended, the prompt
lengths of requests whose first token it gave, and the blocks that hold
live tokens after it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from tpu_composer_torch.models.serving import ContinuousBatchingEngine

from h100bench.traffic import ServeTraffic, rng


@dataclass
class Rec:
    """One request's life as the benchmark saw it."""

    index: int
    prompt: np.ndarray
    max_new: int
    req: object
    client: int
    t_submit: float
    t_first: Optional[float] = None
    t_last: Optional[float] = None
    n: int = 0


def build_engine(program_cfg, weights, mix: Dict) -> ContinuousBatchingEngine:
    e = mix["engine"]
    return ContinuousBatchingEngine(
        weights, program_cfg, slots=int(e["slots"]),
        num_blocks=int(e["slots"]) * int(e["blocks_per_slot"]),
        block_size=int(e["block_size"]), attn_impl="kernel",
        blocks_per_row=int(e["blocks_per_slot"]))


class Loop:
    """The traffic loop around one engine."""

    def __init__(self, eng, traffic: ServeTraffic, mix: Dict, clock, tracer):
        self.eng = eng
        self.traffic = traffic
        self.clock = clock
        self.tracer = tracer
        self.block = int(mix["engine"]["block_size"])
        self.vocab = traffic.vocab
        self.live: Dict[int, Rec] = {}
        self.done: List[Rec] = []
        self.next_index = 0
        self.t0 = clock()
        self.bad = 0

    def submit(self, client: int) -> Rec:
        r = self.traffic.request(self.next_index)
        self.next_index += 1
        req = self.eng.submit(r.prompt.tolist(), r.max_new)
        rec = Rec(index=r.index, prompt=r.prompt, max_new=r.max_new, req=req,
                  client=client, t_submit=self.clock())
        self.live[req.req_id] = rec
        return rec

    def step(self) -> Dict:
        admit = any(r.n == 0 for r in self.live.values())
        before = {k: r.n for k, r in self.live.items()}
        t0 = self.clock()
        with self.tracer.span("engine.step"):
            events = self.eng.step()
        t1 = self.clock()
        got: Dict[int, List[int]] = {}
        for rid, tok in events:
            got.setdefault(rid, []).append(tok)
        rows = keys = 0
        prompts: List[int] = []
        finished: List[Rec] = []
        for rid, toks in got.items():
            rec = self.live[rid]
            n0 = before.get(rid, 0)
            if n0 == 0:
                rec.t_first = t1
                prompts.append(len(rec.prompt))
            rec.n = n0 + len(toks)
            rec.t_last = t1
            self.bad += sum(1 for t in toks if not 0 <= t < self.vocab)
            if len(toks) - (1 if n0 == 0 else 0) == 1:
                rows += 1
                keys += len(rec.prompt) + rec.n - 1
            if rec.req.done:
                finished.append(rec)
        for rec in finished:
            del self.live[rec.req.req_id]
            if len(rec.req.tokens) != rec.max_new:
                self.bad += 1
            self.done.append(rec)
            self.submit(rec.client)
        live_blocks = sum(math.ceil((len(r.prompt) + r.n - 1) / self.block)
                          for r in self.live.values() if r.n > 0)
        return {"t0": t0, "t1": t1, "admit": admit, "rows": rows,
                "keys": keys, "prompts": prompts,
                "tokens": len(events), "live_blocks": live_blocks,
                "traced": self.tracer.active}


def warm_up(eng, traffic: ServeTraffic, seed: int) -> None:
    """One two-token request at each padded prompt shape, drained."""
    r = rng(seed, "warm")
    for n in traffic.warm_lengths():
        req = eng.submit(r.integers(0, traffic.vocab, n).tolist(), 2)
        while not req.done:
            eng.step()


def run(ctx) -> Dict:
    cfg, mix = ctx.cfg, ctx.mix
    weights = ctx.make_weights()
    eng = build_engine(ctx.program_config(), weights, mix)
    traffic = ServeTraffic(mix, int(cfg["vocab_size"]), ctx.seed)
    warm_up(eng, traffic, ctx.seed)
    loop = Loop(eng, traffic, mix, ctx.clock, ctx.tracer)
    # Steady state: every client's first request has been admitted and the
    # requests that finished meanwhile are admitted too, so no backlog
    # from the fill runs into the window.
    first = [loop.submit(c) for c in range(traffic.clients)]
    while (any(r.t_first is None for r in first)
           or any(r.n == 0 for r in loop.live.values())):
        loop.step()
    ctx.sync()
    ctx.log(f"filled in {ctx.clock() - loop.t0:.2f} s")
    t_open = ctx.open_window()
    # A traced run traces the window's last ``trace_seconds``, and reduces
    # the trace once the window has closed.
    trace_from = t_open + ctx.seconds - min(
        float(mix.get("trace_seconds", ctx.seconds)), ctx.seconds)
    steps = []
    while True:
        steps.append(loop.step())
        now = steps[-1]["t1"]
        if now >= t_open + ctx.seconds:
            break
        if ctx.tracer.enabled and now >= trace_from and not ctx.tracer.active:
            ctx.tracer.start()
            ctx.log(f"trace started in {ctx.clock() - now:.3f} s")
    t_close = steps[-1]["t1"]
    ctx.close_window()
    ctx.tracer.stop()
    window_s = t_close - t_open
    in_window = [r for r in loop.done if r.t_last > t_open]
    attempted = len(in_window) + sum(1 for r in loop.live.values()
                                     if r.t_last is not None and r.t_last > t_open)
    e2e = {"gen_tok_s": sum(s["tokens"] for s in steps) / window_s}
    ctx.log(f"window {window_s:.3f} s, {len(steps)} steps, "
            f"{len(in_window)} requests finished")
    sample = pick_sample(in_window, int(mix.get("check_tokens", 1024)),
                         ctx.seed)
    served = [(torch.as_tensor(r.prompt), list(r.req.tokens)) for r in sample]
    failed = loop.bad
    del eng, loop
    ctx.free()
    checks = ctx.judge.serve(ctx, weights, served)
    requests = [{"submit": r.t_submit, "first": r.t_first, "last": r.t_last,
                 "tokens": r.n, "prompt": len(r.prompt)} for r in in_window]
    return {"e2e": e2e, "steps": steps, "requests": requests,
            "window_s": window_s, "attempted": attempted, "failed": failed,
            "checks": checks}


def pick_sample(done: List[Rec], tokens: int, seed: int) -> List[Rec]:
    """The longest finished request, then others drawn from the seed until
    ``tokens`` served tokens are in the sample."""
    if not done:
        return []
    order = sorted(done, key=lambda r: (-r.n, r.index))
    sample, rest = [order[0]], order[1:]
    r = rng(seed, "sample")
    for i in r.permutation(len(rest)):
        if sum(s.n for s in sample) >= tokens:
            break
        sample.append(rest[int(i)])
    return sample
