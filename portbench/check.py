"""The comparison that decides ``correct``.

These numbers, each against its limit in the traffic file's ``check``
where the file gives one (a number without a limit is not compared):

* ``unfinished``: requests of the window that never resolved, or resolved
  with another count of tokens than they asked for (limit 0);
* ``stream_mismatch``: tokens and gaps the engine reports for a request
  (its resolving stage's tokens, every visited stage's gaps) that differ
  from what that stage's calls returned for it (limit 0);
* ``decision_mismatch``: requests whose path through the cascade differs
  from the cascade's rule replayed here over the gaps each stage returned:
  a float64 EWMA of the gaps (the first from the prefill), an escalation
  mid-stream once ``min_tokens`` tokens are out and the certainty is under
  ``early_margin`` times the threshold, and at the end of the stream under
  the threshold; the last stage resolves at its end (limit 0);
* on a sample of the finished requests drawn from the seed, the longest
  among them, and at every stage each visited, the plain float32
  reference's logits over the prompt and the tokens that stage served:
  ``token_gap``, the widest gap by which a served token's logit lies below
  the reference's best at its position; ``gap_err``, the median over the
  positions of the difference between the top-2 gap the stage returned
  (the certainty every decision of the cascade is made from) and the
  reference's; and ``gap_rank_loss``, one less the rank correlation of
  the returned gaps with the reference's.

The reference runs after the window, once the port's state is freed, on the
weights the benchmark drew. Its control (``readings`` with ``control``) is
the same reference with both operands of every product with a weight
matrix rounded to float8 e4m3 (the weight with a scale per output column,
the activations with a scale per token), read at each position at the
token it ranks first and at its own top-2 gap.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["replay", "decision_mismatch", "stream_mismatch", "unfinished",
           "sample", "readings", "verdict"]


def replay(gaps: Sequence[float], max_new: int, threshold: Optional[float],
           min_tokens: int, early_margin: float, beta: float
           ) -> Tuple[int, str]:
    """(tokens streamed when the stage decides, "escalate" | "resolve"),
    or (len(gaps), "none") if it never decides over ``gaps``."""
    ewma = float(gaps[0])
    for i in range(1, len(gaps)):
        ewma += beta * (float(gaps[i]) - ewma)
        pos = i + 1
        if pos >= max_new:
            low = threshold is not None and ewma < threshold
            return pos, "escalate" if low else "resolve"
        if (threshold is not None and pos >= min_tokens
                and ewma < threshold * early_margin):
            return pos, "escalate"
    return len(gaps), "none"


def unfinished(bursts) -> int:
    n = 0
    for b in bursts:
        for r in b.requests:
            res = b.results.get(r.rid)
            if res is None or res.resolver < 0 or res.done_step < 0 \
                    or len(res.tokens) != r.max_new:
                n += 1
    return n


def stream_mismatch(bursts, streams) -> int:
    n = 0
    for b in bursts:
        for rid, res in b.results.items():
            bad = False
            for si, gaps in res.stage_gaps.items():
                got = streams.get((rid, si))
                if got is None or got[1][:len(gaps)] != list(gaps):
                    bad = True
            got = streams.get((rid, res.resolver))
            if got is None or got[0][:len(res.tokens)] != list(res.tokens):
                bad = True
            n += bad
    return n


def decision_mismatch(bursts, traffic: dict) -> int:
    n = 0
    for b in bursts:
        thresholds = b.thresholds
        n_stages = len(thresholds) + 1
        max_new = {r.rid: r.max_new for r in b.requests}
        for rid, res in b.results.items():
            bad = False
            path = sorted(res.stage_gaps)
            if path != list(range(len(path))) or not path:
                n += 1
                continue
            for si in path:
                thr = thresholds[si] if si < n_stages - 1 else None
                used, what = replay(res.stage_gaps[si], max_new[rid], thr,
                                    traffic["min_tokens"],
                                    traffic["early_margin"],
                                    traffic["beta"])
                last = si == path[-1]
                want = "resolve" if last else "escalate"
                if used != len(res.stage_gaps[si]) or what != want:
                    bad = True
            if res.resolver != path[-1] or res.hops != len(path) - 1:
                bad = True
            n += bad
    return n


def sample(bursts, seed_rng: np.random.Generator, n: int) -> List[Tuple]:
    """Up to ``n`` finished (burst, request) pairs: the one with the most
    served tokens (then the longest prompt), and the rest drawn."""
    done = [(b, r) for b in bursts for r in b.requests
            if b.results[r.rid].resolver >= 0]
    if not done:
        return []
    longest = max(range(len(done)), key=lambda i: (
        done[i][1].max_new, len(done[i][1].prompt), -i))
    rest = [i for i in range(len(done)) if i != longest]
    picked = seed_rng.choice(len(rest), size=min(n - 1, len(rest)),
                             replace=False) if n > 1 else []
    return [done[longest]] + [done[rest[int(i)]] for i in sorted(picked)]


def _top2(logits: torch.Tensor) -> torch.Tensor:
    top = torch.topk(logits, 2, dim=-1).values
    return top[:, 0] - top[:, 1]


def _rank_loss(a: torch.Tensor, b: torch.Tensor) -> float:
    """1 - Spearman's rank correlation of ``a`` and ``b`` (1-D)."""
    if a.numel() < 2:
        return 0.0
    ra = a.double().argsort().argsort().double()
    rb = b.double().argsort().argsort().double()
    ra, rb = ra - ra.mean(), rb - rb.mean()
    den = float(ra.norm() * rb.norm())
    return 1.0 - float((ra * rb).sum()) / den if den > 0 else 1.0


def readings(picked, streams, stages: List[dict], params: List[dict],
             refs: List, device, control: bool = False,
             head_chunk: int = 256) -> Dict[str, float]:
    """The port's numbers on the sample ``picked``, over every stage each
    request visited: ``token_gap`` (widest), ``gap_err`` (the median of
    |gap - the reference's top-2 gap| over the positions) and
    ``gap_rank_loss`` (1 - the rank correlation of the port's gaps with
    the reference's); with ``control``, the float8 control's, keyed
    ``control_<name>``."""
    out = {"token_gap": 0.0, "positions": 0}
    errs = {"": [], "control_": []}
    pairs = {"": ([], []), "control_": ([], [])}
    if control:
        out["control_token_gap"] = 0.0
    for si, (model, tree, ref) in enumerate(zip(stages, params, refs)):
        seqs, starts, toks, gaps = [], [], [], []
        for b, r in picked:
            served = b.results[r.rid].stage_gaps.get(si)
            if not served:
                continue
            t = streams[(r.rid, si)][0][:len(served)]
            p = np.asarray(r.prompt, np.int64)
            seqs.append(torch.as_tensor(
                np.concatenate([p, np.asarray(t[:-1], np.int64)]),
                device=device))
            starts.append(p.size - 1)
            toks += t
            gaps += list(served)
        if not seqs:
            continue
        precisions = ("f32", "fp8") if control else ("f32",)
        hidden = {pr: ref.final_hidden(model, tree, seqs, starts, pr)
                  for pr in precisions}
        tok = torch.as_tensor(toks, device=device, dtype=torch.int64)
        gap = torch.as_tensor(gaps, device=device, dtype=torch.float32)
        for lo in range(0, tok.numel(), head_chunk):
            hi = min(lo + head_chunk, tok.numel())
            ref32 = ref.logits(model, tree, hidden["f32"][lo:hi], "f32")
            best = ref32.max(dim=-1).values
            ref_gap = _top2(ref32)
            deficit = best - ref32.gather(1, tok[lo:hi, None])[:, 0]
            out["token_gap"] = max(out["token_gap"], float(deficit.max()))
            served_gaps = {"": gap[lo:hi]}
            if control:
                ctl = ref.logits(model, tree, hidden["fp8"][lo:hi], "fp8")
                first = ctl.argmax(dim=-1)
                cdef = best - ref32.gather(1, first[:, None])[:, 0]
                out["control_token_gap"] = max(out["control_token_gap"],
                                               float(cdef.max()))
                served_gaps["control_"] = _top2(ctl)
            for key, g in served_gaps.items():
                errs[key].append((g - ref_gap).abs().cpu())
                pairs[key][0].append(g.cpu())
                pairs[key][1].append(ref_gap.cpu())
            out["positions"] += hi - lo
    for key in ("", "control_") if control else ("",):
        if not errs[key]:
            continue
        out[key + "gap_err"] = float(torch.cat(errs[key]).median())
        out[key + "gap_rank_loss"] = _rank_loss(torch.cat(pairs[key][0]),
                                                torch.cat(pairs[key][1]))
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float]
            ) -> Tuple[bool, Dict[str, dict]]:
    """(every number within its limit, {name: {value, limit}})."""
    shown = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = all(numbers[k] <= limits[k] for k in limits)
    return ok, shown
