"""Edge rows for the tests of the K-min select (ops/select.py), made with
numpy from a seed.  Imports neither JAX nor torch, so the card's tests can
use it where JAX is not installed.

Each block of rows stresses the rule for rows with fewer than K entries
below BIG: the plain version overwrites each pick with BIG, so once a row
runs out of such entries the next pick is the lowest column whose value is
<= BIG, which may be a column picked before.
"""

import numpy as np

BIG = np.float32(1e30)
HUGE = np.float32(3e30)     # above BIG, below +inf
INF = np.float32(np.inf)


def edge_rows(C: int, K: int, seed: int, reps: int = 3):
    """d [S, C] float32 and ids [S, C] int32: `reps` rows of each kind."""
    rng = np.random.default_rng(seed)
    rows = []

    def below(m, rest):
        """m entries below BIG at random columns, the others drawn from
        `rest`: BIG columns then lie before and after them."""
        d = rng.choice(np.asarray(rest, np.float32), C)
        cols = rng.permutation(C)[:m]
        d[cols] = np.round(rng.uniform(0, 1, len(cols)) * 4) / 4
        return d

    for _ in range(reps):
        tied = np.round(rng.uniform(0, 1, C) * 8) / 8
        tied[rng.random(C) < 0.3] = BIG
        rows.append(tied)                                   # ties, 30% BIG
        rows.append(np.full(C, BIG))                        # all BIG
        rows.append(np.full(C, INF))                        # all +inf
        rows.append(rng.choice([INF, HUGE, BIG], C))        # above and at BIG
        rows.append(rng.choice([INF, HUGE], C))             # above BIG only
        for m in range(1, K):
            rows.append(below(m, [BIG]))
            rows.append(below(m, [INF, HUGE]))
            rows.append(below(m, [INF, HUGE, BIG]))
        rows.append(rng.choice(np.float32([0.25, 0.5]), C))  # exact ties
        rows.append(np.round(rng.uniform(-1, 1, C) * 4) / 4 + 0.0)  # signs
    d = np.stack(rows).astype(np.float32)
    ids = rng.integers(0, 1 << 30, d.shape).astype(np.int32)
    return d, ids
