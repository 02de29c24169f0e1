"""Data of the port: the byte tokenizer and the synthetic Spec-Bench-style
task suite, numpy copies of the reference's ``data/``."""
from repro_torch.data.pipeline import (
    SPEC_TASKS,
    TaskSpec,
    lm_batches,
    make_task_prompts,
    synthetic_corpus,
)
from repro_torch.data.tokenizer import ByteTokenizer

__all__ = [
    "ByteTokenizer",
    "SPEC_TASKS",
    "TaskSpec",
    "lm_batches",
    "make_task_prompts",
    "synthetic_corpus",
]
