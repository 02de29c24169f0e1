"""Synthetic data: the Spec-Bench-style task suite and an LM training
stream; a copy of the reference's ``data/pipeline.py``, array for array.

Each task is a synthetic token process with the property that matters to
speculative decoding: its n-gram reuse rate (how often the continuation
copies from the prompt) and its local predictability. Summarization and RAG
copy heavily (PLD shines), translation reuses little, math is in between
with long runs.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, Iterator, List, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class TaskSpec:
    name: str
    copy_rate: float        # P(continuation copies a prompt span)
    span_len: Tuple[int, int]   # copied-span length range
    vocab_hot: int          # size of the "hot" local vocabulary
    prompt_len: int = 96


SPEC_TASKS: Dict[str, TaskSpec] = {
    "mtbench": TaskSpec("mtbench", copy_rate=0.30, span_len=(2, 6), vocab_hot=64),
    "translation": TaskSpec("translation", copy_rate=0.05, span_len=(1, 3), vocab_hot=96),
    "summarization": TaskSpec("summarization", copy_rate=0.65, span_len=(4, 10), vocab_hot=48),
    "qa": TaskSpec("qa", copy_rate=0.20, span_len=(2, 5), vocab_hot=80),
    "math": TaskSpec("math", copy_rate=0.35, span_len=(2, 7), vocab_hot=32),
    "rag": TaskSpec("rag", copy_rate=0.60, span_len=(4, 9), vocab_hot=56),
}


def make_task_prompts(task: TaskSpec, n: int, vocab_size: int, seed: int = 0) -> List[np.ndarray]:
    """Prompts whose statistics induce the task's n-gram reuse profile."""
    # a per-task seed from crc32, which (unlike str hash) is the same in
    # every process
    rng = np.random.default_rng(seed + zlib.crc32(task.name.encode()) % 10_000)
    prompts = []
    for _ in range(n):
        hot = rng.integers(2, vocab_size, size=task.vocab_hot)
        toks = []
        while len(toks) < task.prompt_len:
            if toks and rng.random() < task.copy_rate:
                # repeat an earlier span (the raw material for PLD)
                L = int(rng.integers(*task.span_len))
                start = int(rng.integers(0, max(len(toks) - L, 1)))
                toks.extend(toks[start: start + L])
            else:
                toks.append(int(hot[rng.integers(task.vocab_hot)]))
        prompts.append(np.asarray(toks[: task.prompt_len], np.int32))
    return prompts


def synthetic_corpus(vocab_size: int, n_tokens: int, seed: int = 0, order: int = 2) -> np.ndarray:
    """A learnable Markov token stream: a fixed random transition structure
    with copy bursts."""
    rng = np.random.default_rng(seed)
    n_states = 256
    table = rng.integers(2, vocab_size, size=(n_states, 8))
    out = np.zeros(n_tokens, np.int32)
    state = 0
    for i in range(n_tokens):
        nxt = table[state, rng.integers(0, 8 if rng.random() < 0.2 else 2)]
        out[i] = nxt
        state = int((state * 31 + nxt) % n_states)
    return out


def lm_batches(corpus: np.ndarray, batch: int, seq_len: int,
               seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite iterator of {tokens (B, S)} windows."""
    rng = np.random.default_rng(seed)
    n = len(corpus) - seq_len - 1
    while True:
        starts = rng.integers(0, n, size=batch)
        toks = np.stack([corpus[s: s + seq_len] for s in starts])
        yield {"tokens": toks.astype(np.int32)}
