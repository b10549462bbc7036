"""The port's ``MCSamples`` surface against ``mcevidence_tpu.compat``.

Each case of tests/test_compat.py that concerns ``MCSamples`` and
``split_var`` runs on both classes with the same inputs and seeds; every
array they return must be byte-identical (same dtype, shape and bits).
"""

import numpy as np
import pytest

from mcevidence_tpu import compat as jax_compat
from mcevidence_tpu_torch import compat


@pytest.fixture
def files(tmp_path, rng):
    for c in (1, 2):
        a = np.column_stack([np.full(100, 2.0), rng.random(100),
                             rng.normal(size=(100, 3))])
        np.savetxt(tmp_path / f"r_{c}.txt", a)
    return str(tmp_path / "r")


def assert_identical(got, want):
    if want is None:
        assert got is None
        return
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            assert_identical(g, w)
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def both(*args, **kw):
    return (compat.MCSamples(*args, **kw),
            jax_compat.MCSamples(*args, **kw))


def assert_same_state(got, want):
    assert set(got.data) == set(want.data)
    for name in want.data:
        assert got.get_shape(name) == want.get_shape(name)
        assert_identical(got.arrays(name), want.arrays(name))
        assert_identical(got.data[name].adjusted_weights,
                         want.data[name].adjusted_weights)
    assert_identical(got.all_sample_arrays(), want.all_sample_arrays())
    for attr in ("names", "labels", "nparamMC", "split", "s1frac",
                 "shuffle"):
        assert getattr(got, attr) == getattr(want, attr), attr


def test_split_var_is_the_same_record():
    got = compat.split_var(split=True, frac=0.3, shuffle=False)
    want = jax_compat.split_var(split=True, frac=0.3, shuffle=False)
    assert got._fields == want._fields and tuple(got) == tuple(want)


def test_mcsamples_from_files(files):
    got, want = both(files, burnlen=0.1, thinlen=0)
    assert got.get_shape("s1") == (180, 3) and got.nparamMC == 3
    assert_same_state(got, want)


def test_mcsamples_split(files):
    kw = dict(csplit=compat.split_var(split=True, frac=0.5, shuffle=True),
              seed=0)
    got = compat.MCSamples(files, **kw)
    want = jax_compat.MCSamples(
        files, csplit=jax_compat.split_var(split=True, frac=0.5,
                                           shuffle=True), seed=0)
    assert got.split and "s2" in got.data
    assert_same_state(got, want)
    assert_identical(got.arrays("all"), want.arrays("all"))


@pytest.mark.parametrize("thinlen", [0.0, 0.5, 2.0])
def test_mcsamples_mutating_ops(files, thinlen):
    got, want = both(files, seed=1, thinlen=thinlen)
    for gd in (got, want):
        gd.removeBurn(0.5, name="s1")
        gd.importance_sample(lambda s: 0.1 * s[:, 0], name="s1")
        gd.thin(2, name="s1")
    assert_same_state(got, want)


def test_mcsamples_dict_input(rng):
    src = {"samples": rng.normal(size=(50, 4)),
           "loglikes": rng.normal(size=50)}
    got, want = both(src, names=["a", "b", "c", "d"], px="y")
    assert got.get_shape("s1") == (50, 4)
    assert_same_state(got, want)


def test_mcsamples_chain_arguments_and_quirks(files):
    got, want = both(files, seed=2)
    chain = np.column_stack([np.full(30, 2.0), np.zeros(30),
                             np.arange(30.0)])
    assert_identical(got.thin(2, chain=chain), want.thin(2, chain=chain))
    assert_identical(got.thin(3, chain=chain), want.thin(3, chain=chain))
    assert_identical(got.removeBurn(0.3, chain=chain),
                     want.removeBurn(0.3, chain=chain))
    assert got.removeBurn(0.3) == want.removeBurn(0.3) == 0.3
    assert got.thin(1) is None and want.thin(1) is None
    with pytest.raises(ValueError, match="burn-in failed"):
        got.removeBurn(500, name="s1")
