"""How ``correct`` is decided for the MoE family: the served tokens
against the plain reference (``references/moe_lm.py``) run under the
program's own routing, each compared number against the limit that
``limits/<cell>.json`` sets for it (``judge.compare``, ``judge.verdict``).

The reference reads each sampled request's prompt and served tokens once
(teacher-forced), every layer at every position using the experts the
program recorded it used. bfloat16 rounding moves a router's near-ties,
and each move changes what every later layer sees; under its own routing
the float32 reference would follow other experts and the served tokens'
gaps would grow with depth whatever the program's quality. Forced onto
the program's routing, it gives two readings the limits compare:

- ``max_gap``, as the dense family's judge: the widest gap by which a
  served token's logit lies below the reference's best;
- ``route_gap_max``: the widest routing gap over every (layer, position)
  of the sample, the reference's own k-th largest router logit minus the
  lower of the program's experts' logits (0 where they agree).

Printed beside them: the mean gaps, the share of served tokens that are
not the reference's best, the share of (layer, position) whose experts
are not the reference's own choice, and the count of routing decisions
checked.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from h100bench import judge as J

#: One sampled request: prompt, served tokens, and its routing record
#: (layers, len(prompt) + len(tokens) − 1, k).
Served = Tuple[torch.Tensor, List[int], torch.Tensor]


def readings(read, tokens: torch.Tensor) -> Dict[str, float]:
    """The judge's numbers from a reference :class:`Read` and the token
    judged at each of its positions."""
    best = torch.cat([z.max(-1).values for z in read.logits])
    z = torch.cat(read.logits)
    out = J.gap_readings(best - z.gather(1, tokens[:, None])[:, 0])
    gaps = torch.cat([g.reshape(-1) for g in read.gaps])
    own = torch.cat([o.reshape(-1) for o in read.own])
    out.update(route_gap_max=float(gaps.max()),
               route_gap_mean=float(gaps.mean()),
               route_mismatch_pct=float((~own).float().mean() * 100),
               route_checks=float(gaps.numel()))
    return out


def serve_readings(cfg: Dict, weights: Dict, served: Sequence[Served],
                   prec_kind: str = "fp32") -> Dict[str, Dict[str, float]]:
    """``program``: the reference under each request's recorded routing,
    read at the served tokens. With ``prec_kind`` other than fp32 also
    ``control``: the reference in that precision routes itself, its
    routing is then forced on the float32 reference, which is read at
    the tokens that precision puts first."""
    ref = J.reference(cfg)
    dev = weights["embed"].device
    seqs, starts, toks, routes = [], [], [], []
    for prompt, tokens, route in served:
        seqs.append(torch.cat([prompt.to(dev), torch.as_tensor(
            tokens[:-1], dtype=torch.long, device=dev)]))
        starts.append(len(prompt) - 1)
        toks.append(torch.as_tensor(tokens, dtype=torch.long, device=dev))
        routes.append(route.to(dev))
    out = {"program": readings(
        ref.logits(cfg, weights, seqs, starts, routes=routes),
        torch.cat(toks))}
    if prec_kind != "fp32":
        low = ref.logits(cfg, weights, seqs, starts, ref.Precision(prec_kind))
        pick = torch.cat([z.argmax(-1) for z in low.logits])
        out["control"] = readings(
            ref.logits(cfg, weights, seqs, starts, routes=low.experts), pick)
    return out


class MoEJudge:
    """The checks the MoE driver calls once the window has closed."""

    def serve(self, ctx, weights: Dict, served: Sequence[Served]
              ) -> List[Dict]:
        if not served:
            return J.compare(ctx.cell["name"], {"max_gap": float("nan")})
        t0 = ctx.clock()
        read = serve_readings(ctx.cfg, weights, served)["program"]
        ctx.log(f"reference over {len(served)} requests in "
                f"{ctx.clock() - t0:.2f} s")
        return J.compare(ctx.cell["name"], read)
