"""What the drivers share: the end of the window, the seeds of a run, and
the steps a run keeps for the comparison with the reference."""

from __future__ import annotations

import numpy as np
import torch

from portbench import check


class Deadline(Exception):
    """Raised from a step's callback when the window has closed."""


def run_seeds(seed: int, index: int, n: int) -> list[int]:
    """``n`` seeds of run ``index`` under ``--seed`` (any size), each below
    2**63."""
    ss = np.random.SeedSequence([int(seed) % 2**128, int(index)])
    words = ss.generate_state(2 * n, dtype=np.uint32).astype(np.uint64)
    return [int((words[2 * i] << np.uint64(31)) ^ words[2 * i + 1])
            for i in range(n)]


def sample_steps(seed: int, index: int, count: int, lo: int, hi: int) -> set:
    """The steps of run ``index`` kept for the comparison: its first step
    (from the initial state) and ``count`` more drawn from ``lo .. hi - 1``
    by the seed."""
    rng = np.random.default_rng([int(seed) % 2**128, int(index), 1])
    more = rng.choice(np.arange(lo, hi), size=count, replace=False)
    return {0} | {int(k) for k in more}


class Sampler:
    """Keeps the sampled steps of a window: for step ``n``, the state
    before it (None at a stream's start), the generator's state before its
    draws, where it lies in the stream, and the state after it."""

    def __init__(self, steps: set):
        self.steps = steps
        self.kept: dict[int, dict] = {}

    def before(self, n: int, k: int, state, gen: torch.Generator) -> None:
        """Step ``n`` (index ``k`` of its stream) is about to run from
        ``state`` (None: the stream's initial state)."""
        if n in self.steps:
            self.kept[n] = {
                "k": k, "gen": gen.get_state(),
                "pre": None if state is None else check.flatten(
                    check.clone(state))}

    def after(self, n: int, state) -> None:
        if n in self.kept:
            self.kept[n]["post"] = check.clone(state)

    def done(self) -> list[dict]:
        """The kept steps that ran to their end, in order."""
        return [dict(v, n=n) for n, v in sorted(self.kept.items())
                if "post" in v]
