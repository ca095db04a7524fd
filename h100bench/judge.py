"""How ``correct`` is decided: the program's outputs against the plain
reference, each compared number against the limit that
``limits/<cell>.json`` sets for it.

The reference reads each sampled request's prompt and served tokens once
(teacher-forced) and gives, at every served position, the gap by which
the served token's logit lies below its best logit. The readings are the
widest gap (``max_gap``), the mean gap and the share of served tokens
that are not the reference's best.

A number the limits file names is compared (value ≤ limit); the others
are printed beside them as readings only. With no limits file nothing is
compared and the run is not correct.
"""

from __future__ import annotations

import importlib
import json
import math
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

HERE = Path(__file__).resolve().parent


def reference(cfg: Dict):
    mod = importlib.import_module(f"h100bench.references.{cfg['reference']}")
    mod.no_tf32()
    return mod


def limits(cell: str) -> Optional[Dict[str, float]]:
    path = HERE / "limits" / f"{cell}.json"
    if not path.exists():
        return None
    return {k: float(v["limit"]) for k, v in
            json.loads(path.read_text())["compare"].items()}


def serve_gaps(cfg: Dict, weights: Dict,
               served: List[Tuple[torch.Tensor, List[int]]],
               prec_kind: str = "fp32") -> Dict[str, torch.Tensor]:
    """Per served position: the reference's gap of the served token, and
    with ``prec_kind`` other than fp32 also the gap of the token that
    precision puts first (the control's reading)."""
    ref = reference(cfg)
    dev = weights["embed"].device
    seqs, starts, toks = [], [], []
    for prompt, tokens in served:
        seqs.append(torch.cat([prompt.to(dev), torch.as_tensor(
            tokens[:-1], dtype=torch.long, device=dev)]))
        starts.append(len(prompt) - 1)
        toks.append(torch.as_tensor(tokens, dtype=torch.long, device=dev))
    out = ref.logits(cfg, weights, seqs, starts)
    best = torch.cat([z.max(-1).values for z in out])
    tok = torch.cat(toks)
    z_all = torch.cat(out)
    gaps = {"served": best - z_all.gather(1, tok[:, None])[:, 0]}
    if prec_kind != "fp32":
        low = ref.logits(cfg, weights, seqs, starts, ref.Precision(prec_kind))
        pick = torch.cat([z.argmax(-1) for z in low])
        gaps["control"] = best - z_all.gather(1, pick[:, None])[:, 0]
    return gaps


def gap_readings(gaps: torch.Tensor) -> Dict[str, float]:
    return {"max_gap": float(gaps.max()), "mean_gap": float(gaps.mean()),
            "mismatch_pct": float((gaps > 0).float().mean() * 100),
            "tokens": float(gaps.numel())}


def compare(cell: str, readings: Dict[str, float]) -> List[Dict]:
    """Each reading with its limit (None where not compared)."""
    lim = limits(cell) or {}
    return [{"name": k, "value": v, "limit": lim.get(k)}
            for k, v in readings.items()]


def verdict(cell: str, checks: List[Dict]) -> bool:
    lim = limits(cell)
    if not lim:
        return False
    seen = {c["name"]: c["value"] for c in checks}
    return all(k in seen and not math.isnan(seen[k]) and seen[k] <= v
               for k, v in lim.items())


class Judge:
    """The checks the drivers call once the window has closed."""

    def serve(self, ctx, weights: Dict, served) -> List[Dict]:
        if not served:
            return compare(ctx.cell["name"], {"max_gap": float("nan")})
        t0 = ctx.clock()
        gaps = serve_gaps(ctx.cfg, weights, served)["served"]
        ctx.log(f"reference over {len(served)} requests in "
                f"{ctx.clock() - t0:.2f} s")
        return compare(ctx.cell["name"], gap_readings(gaps))
