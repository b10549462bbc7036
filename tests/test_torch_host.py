"""The port's copied host modules against the JAX package's originals.

The same files and seeds go through ``mcevidence_tpu`` and
``mcevidence_tpu_torch``; every array that comes out must be equal
(``np.array_equal``), since the copies are the same numpy code.
"""

import dataclasses
import importlib
import math

import numpy as np
import pytest

import mcevidence_tpu.chains.preprocess as jpp
import mcevidence_tpu.chains.reader as jreader
import mcevidence_tpu.registry as jreg
import mcevidence_tpu.utils.batch as jbatch
import mcevidence_tpu_torch.chains.preprocess as tpp
import mcevidence_tpu_torch.chains.reader as treader
import mcevidence_tpu_torch.registry as treg
import mcevidence_tpu_torch.utils.batch as tbatch
from mcevidence_tpu.ops.whiten import whiten_stats as j_whiten_stats
from mcevidence_tpu_torch import interop
from mcevidence_tpu_torch.ops.whiten import apply_whiten, whiten_stats

# the priors packages re-export a function named params_info over the module
jpi = importlib.import_module("mcevidence_tpu.priors.params_info")
tpi = importlib.import_module("mcevidence_tpu_torch.priors.params_info")


def assert_same(a, b, path="result"):
    """Equal structure, equal scalars, ``np.array_equal`` arrays."""
    if dataclasses.is_dataclass(a):
        assert dataclasses.is_dataclass(b), path
        assert [f.name for f in dataclasses.fields(a)] == \
            [f.name for f in dataclasses.fields(b)], path
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name),
                        f"{path}.{f.name}")
    elif isinstance(a, np.ndarray):
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), path
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for key in a:
            assert_same(a[key], b[key], f"{path}[{key!r}]")
    elif isinstance(a, float) and math.isnan(a):
        assert math.isnan(b), path
    else:
        assert a == b, path


def _cosmomc_root(tmp_path, rng, weights=None):
    for c in (1, 2, 3):
        n = 120
        w = np.ones(n) if weights is None else weights(n)
        a = np.column_stack([w, rng.random(n), rng.normal(size=(n, 3))])
        np.savetxt(tmp_path / f"root_{c}.txt", a)
    (tmp_path / "root.ranges").write_text(
        "omegabh2 0.02 0.03\ntau 0.01 0.2\nfixed 1 1\nnuis 0 10\n")
    return str(tmp_path / "root")


def case_cosmomc_ranges(mod, tmp_path, rng):
    root = _cosmomc_root(tmp_path, rng)
    pinfo = mod["pi"].params_info(root, cosmo=True)
    return (mod["reader"].resolve_chain_files(root),
            mod["reader"].load_chains(root),
            mod["reader"].ingest(root),
            (pinfo.names, pinfo.volume, pinfo.ndim),
            mod["pi"].get_prior_volume(root))


def case_montepython_log_param(mod, tmp_path, rng):
    d = tmp_path / "mp"
    d.mkdir(exist_ok=True)
    (d / "log.param").write_text(
        "data.parameters['omega_b'] = [2.2, 1.8, 2.6, 0.01, 0.01, 'cosmo']\n"
        "data.parameters['H0'] = [67, 60, 80, 1, 1, 'cosmo']\n"
        "data.parameters['A_act'] = [1, 0, 2, 0.1, 1, 'nuisance']\n"
        "data.parameters['sigma8'] = [0.8, None, None, 0, 1, 'derived']\n")
    out = []
    for cosmo in (True, False):
        info = mod["pi"].params_info(str(d), cosmo=cosmo)
        out.append((info.names, info.volume, info.ndim))
    return out


def case_cobaya(mod, tmp_path, rng):
    from tests.test_cobaya import _write_run
    root, _ = _write_run(tmp_path, rng, n=300)
    info = mod["pi"].params_info(root, cosmo=False)
    return (mod["reader"].load_chains(root), mod["reader"].ingest(root),
            (info.names, info.volume, info.ndim))


def case_burn_fraction(mod, tmp_path, rng):
    root = _cosmomc_root(tmp_path, rng)
    return [mod["reader"].ingest(root, burnlen=b) for b in (0.3, 17)]


def case_poisson_thin_with_seed(mod, tmp_path, rng):
    root = _cosmomc_root(tmp_path, rng,
                         weights=lambda n: rng.integers(1, 5, n).astype(float))
    return mod["reader"].ingest(root, burnlen=0.1, thinlen=0.4,
                                rng=np.random.default_rng(11))


def case_weighted_thin(mod, tmp_path, rng):
    root = _cosmomc_root(tmp_path, rng,
                         weights=lambda n: rng.integers(1, 5, n).astype(float))
    return mod["reader"].ingest(root, thinlen=3)


def case_split_with_seed(mod, tmp_path, rng):
    chains = [np.column_stack([np.ones(100), rng.random(100),
                               rng.normal(size=(100, 3))]) for _ in range(2)]
    return (mod["pp"].build_chain_pair(chains, split=True, s1frac=0.4,
                                       rng=np.random.default_rng(5)),
            mod["pp"].split_rows(77, 0.5, rng=np.random.default_rng(9)))


def case_dict_source_importance(mod, tmp_path, rng):
    theta = rng.normal(size=(200, 3))
    pair = mod["reader"].ingest({"samples": theta,
                                 "loglikes": -np.sum(theta ** 2, 1)})
    return mod["pp"].importance_sample(pair, lambda s: 0.3 * s[:, 0])


def case_registry_paramsfile(mod, tmp_path, rng):
    pf = tmp_path / "extra.txt"
    pf.write_text("mycustom  # a note\nother\n")
    try:
        names = mod["reg"].load_params_file(str(pf))
        return (names, mod["reg"].iscosmo_param("mycustom"),
                mod["reg"].iscosmo_param("nope"),
                mod["reg"].iscosmo_param("omegabh2"))
    finally:
        mod["reg"].reset_cosmo_params()


def case_batch_plans(mod, tmp_path, rng):
    mk = mod["batch"].make_batch_plan
    plans = [mk([1000]), mk([1000, 900], nbatch=2, brange=[2.5, 3.0],
                           bscale="logpower"),
             mk([1000], nbatch=3, brange=[100, 600], bscale="linear"),
             mk([1000], nbatch=2, brange=200, bscale="constant")]
    return [(p.nbatch, p.batch_sizes_s1()) for p in plans]


JAX = {"reader": jreader, "pp": jpp, "pi": jpi, "reg": jreg, "batch": jbatch}
PORT = {"reader": treader, "pp": tpp, "pi": tpi, "reg": treg,
        "batch": tbatch}
CASES = [case_cosmomc_ranges, case_montepython_log_param, case_cobaya,
         case_burn_fraction, case_poisson_thin_with_seed, case_weighted_thin,
         case_split_with_seed, case_dict_source_importance,
         case_registry_paramsfile, case_batch_plans]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__[5:])
def test_host_copies_match_reference(case, tmp_path):
    # both runs write the same files (same seed) into the same directory,
    # so that paths in the results agree too
    want = case(JAX, tmp_path, np.random.default_rng(2024))
    got = case(PORT, tmp_path, np.random.default_rng(2024))
    assert_same(want, got)


def test_interop_round_trips(rng):
    chains = [np.column_stack([rng.integers(1, 4, 150).astype(float),
                               rng.random(150), rng.normal(size=(150, 4))])
              for _ in range(2)]
    for split in (False, True):
        jpair = jpp.build_chain_pair(chains, split=split, burnlen=0.1,
                                     rng=np.random.default_rng(3))
        tpair = tpp.build_chain_pair(chains, split=split, burnlen=0.1,
                                     rng=np.random.default_rng(3))
        carried = interop.chain_pair_from_reference(jpair)
        assert type(carried) is type(tpair)
        assert_same(carried, tpair)
    samples = jpair.all_samples()
    jstats = j_whiten_stats(samples)
    carried = interop.whiten_stats_from_reference(jstats)
    assert_same(carried, whiten_stats(samples))
    np.testing.assert_array_equal(apply_whiten(samples, carried),
                                  apply_whiten(samples, whiten_stats(samples)))


def test_every_reference_export_resolves_on_the_port():
    """Every name of ``mcevidence_tpu.__all__`` resolves on the port."""
    import mcevidence_tpu
    import mcevidence_tpu_torch
    for name in sorted(mcevidence_tpu.__all__):
        assert getattr(mcevidence_tpu_torch, name) is not None, name
        assert name in mcevidence_tpu_torch.__all__, name
    assert mcevidence_tpu_torch.cosmo_params_list == \
        mcevidence_tpu.cosmo_params_list
    assert (mcevidence_tpu_torch.params_info.__module__
            == "mcevidence_tpu_torch.priors.params_info")
