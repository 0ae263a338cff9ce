"""Deterministic, exactly-resumable synthetic data stream (the counterpart
of ``repro/data/pipeline.py``, numpy only).

Every batch is a pure function of (seed, step), so the iterator state in a
checkpoint is those two integers: a restart replays the stream with no
gap or repeat.  The batches are bit-identical to the JAX package's (the
same ``np.random.default_rng(SeedSequence([seed, step]))`` draws), so a
checkpoint's data state resumes in either package.  Tasks:

  * ``lm``    -- uniform random tokens;
  * ``copy``  -- the second half of each sequence repeats the first half
    (learnable, so a short run shows a falling loss);
  * ``arith`` -- t_{i+1} = (t_i + t_{i-1}) mod vocab after a random prefix.

``make_batch`` returns numpy int32 arrays ``tokens`` and ``labels`` of
shape (batch, seq - 1): the next-token pairs of one drawn sequence.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class DataConfig:
    batch: int = 8
    seq: int = 128
    vocab: int = 256
    task: str = "copy"
    seed: int = 0


class SyntheticStream:
    def __init__(self, cfg: DataConfig, step: int = 0):
        self.cfg = cfg
        self.step = step

    def state(self) -> dict:
        return {"seed": self.cfg.seed, "step": self.step,
                "task": self.cfg.task}

    @staticmethod
    def from_state(cfg: DataConfig, state: dict) -> "SyntheticStream":
        return SyntheticStream(cfg, step=int(state["step"]))

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        batch = make_batch(self.cfg, self.step)
        self.step += 1
        return batch


def make_batch(cfg: DataConfig, step: int) -> dict:
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step]))
    b, s, v = cfg.batch, cfg.seq, cfg.vocab
    if cfg.task == "copy":
        half = s // 2
        first = rng.integers(2, v, size=(b, half))
        toks = np.concatenate([first, first], axis=1)[:, :s]
    elif cfg.task == "arith":
        toks = rng.integers(2, v, size=(b, s))
        for i in range(2, s):
            toks[:, i] = (toks[:, i - 1] + toks[:, i - 2]) % v
    else:
        toks = rng.integers(0, v, size=(b, s))
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}
