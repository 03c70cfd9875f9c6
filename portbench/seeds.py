"""Independent integer streams derived from a run's ``--seed``."""

import zlib

import numpy as np


def substream(seed: int, tag: str) -> int:
    """A 63-bit seed for the part of the run named ``tag`` (weights, a
    field's ids, the check's sample), so each part's draws depend on the
    run's seed and its own name alone."""
    state = np.random.SeedSequence([seed, zlib.crc32(tag.encode())]).generate_state(1, np.uint64)
    return int(state[0] >> np.uint64(1))
