"""Serving a latent-attention MoE model (Moonlight): ``serve_moe.py``'s
closed loop of clients around the program's
``ContinuousBatchingEngine`` with its routing record on, made from this
family's weights (``mla_weights.py``), its served tokens held against the
plain reference under the routing the program used
(``h100bench/judge_moe.py``, which reads ``references/mla_moe_lm.py``
through the configuration's ``reference``).

The engine keeps one latent pool in bfloat16, admits prompts by bucketed
prefill (the expanded form, K1 at 192/128) and replays its decode step
from a CUDA graph, each layer's attention through the latent decode
kernel K3. Set-up, the window and the booking of steps are
``serve.py``'s.
"""

from __future__ import annotations

from typing import Dict

import torch

from h100bench.drivers.serve import Loop, pick_sample, warm_up
from h100bench.drivers.serve_moe import build_engine
from h100bench.judge_moe import MoEJudge
from h100bench.mla_weights import make_weights
from h100bench.traffic import ServeTraffic


def run(ctx, judge=None) -> Dict:
    """One run of the cell; ``judge`` replaces :class:`MoEJudge` (the
    control's)."""
    cfg, mix = ctx.cfg, ctx.mix
    # The program's config first: a program without latent attention
    # refuses the family before the weights are made.
    program_cfg = ctx.program_config()
    weights = make_weights(cfg, ctx.seed, ctx.device)
    eng = build_engine(program_cfg, weights, mix)
    traffic = ServeTraffic(mix, int(cfg["vocab_size"]), ctx.seed)
    warm_up(eng, traffic, ctx.seed)
    loop = Loop(eng, traffic, mix, ctx.clock, ctx.tracer)
    first = [loop.submit(c) for c in range(traffic.clients)]
    while (any(r.t_first is None for r in first)
           or any(r.n == 0 for r in loop.live.values())):
        loop.step()
    ctx.sync()
    ctx.log(f"filled in {ctx.clock() - loop.t0:.2f} s")
    t_open = ctx.open_window()
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
    served = [(torch.as_tensor(r.prompt), list(r.req.tokens), r.req.routes)
              for r in sample]
    failed = loop.bad
    del eng, loop
    ctx.free()
    checks = (judge or MoEJudge()).serve(ctx, weights, served)
    requests = [{"submit": r.t_submit, "first": r.t_first, "last": r.t_last,
                 "tokens": r.n, "prompt": len(r.prompt)} for r in in_window]
    return {"e2e": e2e, "steps": steps, "requests": requests,
            "window_s": window_s, "attempted": attempted, "failed": failed,
            "checks": checks}
