"""Faults planted in the timed path, for the checks that ``correct`` fails
on a broken program: the server's step wrapped, after the build, so that
every round from then on is broken the same way."""
from __future__ import annotations

FAULTS = ("altered_token", "unchanged_state", "half_batch")


def plant(cr, fault: str) -> None:
    """Break ``cr.srv.step`` (``cr`` a built ``harness.CellRun``):
    ``altered_token``, the last token each slot gets a round is replaced
    by the next id; ``unchanged_state``, a round returns nothing and moves
    nothing on; ``half_batch``, the slots of the upper half get nothing."""
    if fault not in FAULTS:
        raise ValueError(f"fault {fault!r}; pick one of {FAULTS}")
    step, V, B = cr.srv.step, int(cr.cfg["vocab_size"]), cr.B

    def broken():
        if fault == "unchanged_state":
            return {}
        out = step()
        if fault == "altered_token":
            return {b: toks[:-1] + [(toks[-1] + 1) % V] for b, toks in out.items()}
        return {b: toks for b, toks in out.items() if b < B // 2}
    cr.srv.step = broken


def altered_record(window, index: int, count: int, vocab_size: int):
    """A copy of ``window`` in which request ``index``'s served tokens are
    altered to the next id at ``count`` places spread evenly over them:
    a few wrong tokens among right ones, as the judge would read them."""
    import dataclasses

    reqs = []
    for r in window.requests:
        if r["index"] == index and r["served"]:
            served = list(r["served"])
            n = len(served)
            for k in range(count):
                i = (2 * k + 1) * n // (2 * count)
                served[i] = (served[i] + 1) % vocab_size
            r = dict(r, served=served)
        reqs.append(r)
    return dataclasses.replace(window, requests=reqs)
