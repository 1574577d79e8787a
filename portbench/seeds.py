"""Sub-seeds of a run's seed: one independent stream per use."""

import numpy as np

WEIGHTS, POOL, ORDER, WARP, PHOTOMETRIC, DROPOUT, SAMPLE = range(7)


def subseed(seed: int, use: int) -> int:
    """A 62-bit seed for ``use`` from the run's ``seed`` (any whole number >= 0)."""
    state = np.random.SeedSequence([int(seed), 0x9E3779B9, use]).generate_state(2, np.uint32)
    return (int(state[0]) << 30) ^ int(state[1])


def rng(seed: int, use: int) -> np.random.Generator:
    return np.random.default_rng(subseed(seed, use))
