"""The comparison that decides ``correct`` for a served model.

Once the window has closed, a sample of the finished requests, drawn from
``--seed`` and always holding the longest, is run through the plain
reference over each prompt and its served tokens (teacher forcing). At
each served token the reference's best logit lies some gap above the
served token's logit (0 where they agree). The numbers compared are those
the configuration's ``limits`` name, among the widest gap over the sample
(``logit_gap``), the mean gap (``mean_logit_gap``) and the count of
served tokens whose gap exceeds one logit (``logit_gaps_over_1``): a few
wrong tokens raise the count by one each. Greedy serving is held to the
target's own choice by them, position by position: the prefill's first
token, then every token verified through the cache.

The control is the reference in the next precision below the served one
(``reference.model`` with ``precision="fp8"`` for bfloat16): at the same
positions, the gap of the token it puts first. It is judged by the same
limits as the served tokens (``harness.check`` with its side) and has to
come out not correct."""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from ptb.traffic import _seed_words

SAMPLE_TOKENS = 768         # served tokens the sample reaches at least
SAMPLE_MAX = 6              # requests at most


def sample(finished: Sequence[dict], seed: int, min_tokens: int = SAMPLE_TOKENS,
           max_requests: int = SAMPLE_MAX) -> List[dict]:
    """The longest finished request, then others in an order drawn from
    ``seed``, until the sample holds ``min_tokens`` served tokens."""
    if not finished:
        return []
    by_len = sorted(finished, key=lambda r: (-len(r["served"]), r["index"]))
    rest = by_len[1:]
    order = np.random.default_rng(np.random.SeedSequence(_seed_words(seed) + [0xC0DE])
                                  ).permutation(len(rest))
    out = [by_len[0]]
    for i in order:
        if sum(len(r["served"]) for r in out) >= min_tokens or len(out) >= max_requests:
            break
        out.append(rest[int(i)])
    return out


def teacher_inputs(reqs: Sequence[dict]):
    """Each request's prompt and served tokens but the last, and the row
    of its first served token's prediction (the prompt's last position)."""
    seqs = [list(r["prompt"]) + list(r["served"][:-1]) for r in reqs]
    first = [len(r["prompt"]) - 1 for r in reqs]
    return seqs, first


def gaps(logits, tokens) -> "np.ndarray":
    """Per row, the best logit minus the logit of ``tokens[row]``."""
    import torch

    t = torch.as_tensor(np.asarray(tokens), dtype=torch.long, device=logits.device)
    best = logits.max(dim=-1).values
    return (best - logits.gather(1, t[:, None])[:, 0]).cpu().numpy()


SIDES = ("served", "control", "witness")


def compare(params, cfg: dict, reqs: Sequence[dict],
            sides: Sequence[str] = ("served",)) -> Dict[str, float]:
    """The numbers of each side over ``reqs``, keyed ``<side>_<number>``
    (``summary``), each gap taken against the float32 reference's best
    logit: ``served``, the program's tokens; ``control``, the first choices
    of the reference computed in float8 (the control of ``correct``);
    ``witness``, those of the reference computed in bfloat16, the served
    precision (a reading beside the program's, never judged)."""
    from reference import model as ref

    unknown = set(sides) - set(SIDES)
    if unknown:
        raise ValueError(f"sides {sorted(unknown)}; pick from {SIDES}")
    seqs, first = teacher_inputs(reqs)
    picks = {}
    for side, precision in (("control", "fp8"), ("witness", "bfloat16")):
        if side in sides:
            picks[side] = [lg.argmax(dim=-1).cpu().numpy()
                           for lg in ref.logits(params, cfg, seqs, first, precision=precision)]
    exact = ref.logits(params, cfg, seqs, first, precision="float32")
    if "served" in sides:
        picks["served"] = [r["served"] for r in reqs]
    out: Dict[str, float] = {"served_tokens": float(sum(len(r["served"]) for r in reqs))}
    for side in sides:
        out.update(summary(side, np.concatenate([gaps(lg, p)
                                                 for lg, p in zip(exact, picks[side])])))
    return out


# the configuration's limit names -> the number of ``summary`` each compares
NUMBERS = {"logit_gap": "gap", "mean_logit_gap": "mean_gap", "logit_gaps_over_1": "over_1"}
QUANTILES = (90, 95, 99)
OVER = (0.5, 1.0, 2.0, 3.0)


def summary(side: str, g: "np.ndarray") -> Dict[str, float]:
    """The widest gap, the mean gap and the gaps' upper quantiles, and
    beside them the share of tokens off the reference's first choice and
    the counts of gaps over ``OVER``."""
    out = {f"{side}_gap": float(g.max()), f"{side}_mean_gap": float(g.mean()),
           f"{side}_off_share": float((g > 0).mean())}
    for q in QUANTILES:
        out[f"{side}_p{q}_gap"] = float(np.percentile(g, q))
    for t in OVER:
        out[f"{side}_over_{t:g}"] = float((g > t).sum())
    return out
