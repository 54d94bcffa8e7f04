"""The driver's schedule, frozen: the seeds of the draw streams and the
class-major epoch order (copies of the port's ``run/driver.py``
``batch_seed`` and ``_epoch_order``)."""
from __future__ import annotations

import numpy as np

EVAL_STREAM = 2 ** 30     # eval of epoch k draws from stream 2**30 + k
SERVE_RUN = 1             # serving's streams: run 1, one per request


def batch_seed(seed, run, n):
    """The 64-bit generator seed of draw stream n of a run."""
    return int(np.random.SeedSequence([int(seed) % (1 << 64), run, n])
               .generate_state(1, np.uint64)[0])


def epoch_order(shuffle_rng, class_members):
    """Class-major shuffle: the class visit order, then each class's
    batches (one class: a plain shuffle)."""
    if len(class_members) > 1:
        class_seq = [int(c) for c in
                     shuffle_rng.permutation(len(class_members))]
    else:
        class_seq = [0]
    local = {ci: shuffle_rng.permutation(len(class_members[ci]))
             for ci in class_seq}
    return [class_members[ci][j] for ci in class_seq for j in local[ci]]


def class_members(batch_edges):
    """Batch ids grouped by padded edge count, largest class first."""
    shapes = sorted(set(batch_edges), reverse=True)
    return [[i for i, e in enumerate(batch_edges) if e == s]
            for s in shapes]
