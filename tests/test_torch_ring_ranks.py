"""Rank-side functions of tests/test_torch_ring.py.

The rank processes of its pool run these (they are pickled by reference,
so each rank imports this module, which loads no JAX); every rank of the
pool calls each one.  The module holds no tests.
"""

import logging

import numpy as np
import torch.distributed as dist

from mcevidence_tpu_torch.parallel import ring


class _Messages(logging.Handler):
    def __init__(self):
        super().__init__(logging.DEBUG)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def call_logging(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` and the messages ``parallel/ring.py`` logged
    meanwhile."""
    log = logging.getLogger("mcevidence_tpu_torch.parallel.ring")
    handler, level = _Messages(), log.level
    log.addHandler(handler)
    log.setLevel(logging.DEBUG)
    try:
        return fn(*args, **kwargs), handler.messages
    finally:
        log.removeHandler(handler)
        log.setLevel(level)


def device_refine_with_overflow(*args, **kwargs):
    """``sharded_device_refine_evidence`` with its partials' first sum made
    +inf on every rank (a double overflow of the f64 product), and the
    messages it logged."""
    real = ring.make_sharded_device_refine

    def bad_make(*a, **k):
        fn = real(*a, **k)

        def wrapped(*fa):
            parts = np.asarray(fn(*fa), np.float64)
            parts[0, 0] = np.inf
            return parts
        return wrapped

    ring.make_sharded_device_refine = bad_make
    try:
        return call_logging(ring.sharded_device_refine_evidence, *args,
                            **kwargs)
    finally:
        ring.make_sharded_device_refine = real


def grid_device_refine_defer(chains, **kwargs):
    """The eager batched device-refine answer, and the deferred one."""
    eager = ring.sharded_grid_device_refine_evidence(chains, **kwargs)
    fin = ring.sharded_grid_device_refine_evidence(chains, defer=True,
                                                   **kwargs)
    return eager, callable(fin), fin()


def selections_by_world_size(query, ref, k, sizes, **kwargs):
    """``sharded_knn_candidates`` on rings of each size in ``sizes``: ranks
    0 .. size-1 of the pool (one rank alone: ``LOCAL``).  Every rank builds
    every ring's group; returns {size: indices} of the rings this rank is
    on."""
    groups = {n: dist.new_group(list(range(n))) for n in sizes if n > 1}
    out = {}
    for n in sizes:
        if dist.get_rank() < n:
            out[n] = ring.sharded_knn_candidates(
                query, ref, k, group=groups.get(n, ring.LOCAL), **kwargs)
    return out


def layout_of(dp):
    """This rank's place in the dp x ring layout of the pool."""
    layout = ring.grid_layout(dp)
    return layout.dp_index, layout.ring.ranks, layout.ring.rank
