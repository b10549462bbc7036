"""Command-line interface.

Mirrors the reference CLI flag set (reference MCEvidence.py:1342-1474):
``root_name`` positional plus -k/--kmax, -ic/--idchain, -np/--ndim,
--paramsfile, --burn/--burnlen, --thin/--thinlen, -vb/--verbose,
-pv/--pvolume, --allparams, --cross, --version — with the JAX
package's additions (--seed, --engine, --precision, --unit-volume-fallback,
--error, --bootstrap, --parse-cache) and --device, which says where the kNN
selection runs.  ``--json`` is not ported yet and exits 2 with the ROADMAP
item it waits for.

Run as ``python -m mcevidence_tpu_torch <root> [...]``.
"""

from __future__ import annotations

import logging
import sys
from argparse import ArgumentParser

from ._version import __version__
from .evidence import (MCEvidence, check_precision, evidence_bootstrap,
                       evidence_with_error)
from .ops.knn import ENGINES, resolve_engine
from .priors.params_info import get_prior_volume
from .registry import load_params_file
from .utils.device import resolve_device
from .utils.logging import configure

DESC = ("MCEvidence (PyTorch/CUDA). Returns the log Bayesian Evidence "
        "computed using the kth NN")
CITE = """
**
When using this code in published work, please cite the following paper: **
Heavens et. al. (2017)
Marginal Likelihoods from Monte Carlo Markov Chains
https://arxiv.org/abs/1704.03472
"""

CROSS_HELP = """flag to split chain(s) to estimate cross Evidence.
Cross evidence is computed using two independent chains: the nearest
neighbour of point "A" in MCMC sample MC1 is searched in MCMC sample MC2.
The reference documents a ~sqrt(2) smaller cross error; measured, that
holds only for two independent FULL-SIZE chains — splitting one chain
(what this flag does) halves both sample sets and gives equal-or-larger
scatter than auto mode (docs/VALIDATION_STUDY.md)."""


def build_parser() -> ArgumentParser:
    p = ArgumentParser(prog="mcevidence", add_help=True, description=DESC,
                       epilog=CITE)
    p.add_argument("root_name",
                   help="Root filename for MCMC chains")
    p.add_argument("--version", action="version",
                   version=f"%(prog)s {__version__}")
    p.add_argument("-k", "--kmax", dest="kmax", default=2, type=int,
                   help="maximum K-NN: evidence reported for k=1..kmax-1")
    p.add_argument("-ic", "--idchain", dest="idchain", default=0, type=int,
                   help="which chain to use, e.g. 1 reads only *_1.txt "
                        "(default=0 - use all available)")
    p.add_argument("-np", "--ndim", dest="ndim", default=None, type=int,
                   help="how many parameters to use (default - all params)")
    p.add_argument("--paramsfile", dest="paramsfile", default="", type=str,
                   help="text file of additional parameter names to treat as "
                        "cosmological")
    p.add_argument("--burn", "--burnlen", dest="burnlen", default=0,
                   type=float,
                   help="burn-in length or fraction (burnlen<1 means "
                        "fraction, e.g. 0.3)")
    p.add_argument("--thin", "--thinlen", dest="thinlen", default=0,
                   type=float,
                   help="thinning: 0<thinlen<1 Poisson-samples weights; "
                        "thinlen>1 getdist weighted thinning; thinlen<0 "
                        "thins by the chain's own estimated autocorrelation "
                        "length scaled by |thinlen| (the reference "
                        "documented this mode but never implemented it, "
                        "quirk Q9)")
    p.add_argument("-vb", "--verbose", dest="verbose", default=1, type=int,
                   help="0: warnings, 1: info, 2: debug")
    p.add_argument("-pv", "--pvolume", dest="priorvolume", default=None,
                   type=float,
                   help="prior volume to use when *.ranges / log.param "
                        "metadata is unavailable")
    p.add_argument("--allparams", action="store_true",
                   help="use all params (skip the cosmo-parameter filter)")
    p.add_argument("--cross", action="store_true", help=CROSS_HELP)
    # additions beyond the reference CLI
    p.add_argument("--seed", default=None, type=int,
                   help="RNG seed for split/thinning (default: "
                        "nondeterministic, like the reference)")
    p.add_argument("--engine", default="auto", choices=list(ENGINES),
                   help="kNN selection engine: 'auto', 'cuda' (alias "
                        "'pallas') and 'pallas_exact' run the exact "
                        "k-dependent CUDA kernel dispatch (the plain PyTorch "
                        "selection on --device cpu); 'pallas_smalld' the "
                        "small-d kernel where candidates are refined "
                        "(d <= 16); 'torch' (alias 'xla') the plain PyTorch "
                        "selection")
    p.add_argument("--device", default="cuda",
                   help="where the kNN selection runs: 'cuda' (default; "
                        "fails without a GPU) or 'cpu'")
    p.add_argument("--precision", default="refine",
                   choices=["device", "refine", "fast"],
                   help="'refine': f32 select + host f64 refinement "
                        "(sklearn parity ~1e-14); 'device': f32 select + "
                        "f64 refinement and reduction on --device, "
                        "scalars-only fetch (~1e-13 of refine); 'fast': the "
                        "f32 selection distances used directly (~1e-3)")
    p.add_argument("--unit-volume-fallback", action="store_true",
                   help="proceed with prior_volume=1 when metadata files are "
                        "missing (results then include the prior ratio)")
    p.add_argument("--error", action="store_true",
                   help="also report a statistical error bar from per-chain "
                        "scatter (needs >= 2 chain files)")
    p.add_argument("--bootstrap", type=int, default=0, metavar="N",
                   help="also report a Bayesian-bootstrap error bar from N "
                        "Dirichlet-reweighting replicates (works with a "
                        "single chain; honors --cross)")
    p.add_argument("--parse-cache", default="", metavar="DIR",
                   help="cache raw parsed chain tables as .npy under DIR "
                        "(keyed on path+size+mtime)")
    p.add_argument("--json", action="store_true",
                   help="print ONE machine-readable JSON line instead of "
                        "the human report (not ported yet)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.json:
        print("error: --json is not ported yet; it waits for the JSON-lines "
              "service (ROADMAP.md Queue 1, item 8)", file=sys.stderr)
        return 2
    try:
        check_precision(args.precision)
        resolve_engine(args.engine)
        resolve_device(args.device)
    except (ValueError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    configure(args.verbose)
    logger = logging.getLogger(__name__)

    if args.paramsfile:
        names = load_params_file(args.paramsfile)
        print(f"Adding additional parameter names to cosmo_params list "
              f"from {args.paramsfile}..")
        print("adding the following names:", names)

    try:
        prior_volume, ndim_meta = get_prior_volume(
            args.root_name, cosmo=not args.allparams,
            priorvolume=args.priorvolume,
            allow_unit_fallback=args.unit_volume_fallback
            or args.priorvolume is not None)
    except (FileNotFoundError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        print("hint: pass -pv/--pvolume or --unit-volume-fallback to proceed "
              "without prior metadata", file=sys.stderr)
        return 2
    ndim = args.ndim if args.ndim is not None else ndim_meta

    if args.parse_cache:
        from .chains.reader import set_parse_cache
        set_parse_cache(args.parse_cache)

    print()
    print("Using file: ", args.root_name)
    # parse each chain file exactly ONCE: the raw per-chain arrays feed both
    # the combined estimate and the per-chain error bars (chain parsing is
    # the documented host bottleneck; re-ingesting for --error doubled it)
    from .chains.reader import load_chains
    try:
        chains = load_chains(args.root_name, idchain=args.idchain)
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    mce = MCEvidence(chains, split=args.cross, ndim=ndim,
                     priorvolume=prior_volume,
                     kmax=args.kmax, verbose=args.verbose,
                     burnlen=args.burnlen, thinlen=args.thinlen,
                     seed=args.seed, engine=args.engine,
                     precision=args.precision, device=args.device)
    mle = mce.evidence()
    for k in range(1, mce.kmax):
        print(f"   ln(B)[k={k}] = {mle[k - 1]}")
    # nested-sampling roots carry the sampler's own evidence — print the
    # cross-check the method paper (arXiv:1704.03472) makes by hand.
    # (MCEvidence received pre-loaded arrays here, so its info dict cannot
    # carry the keys; this is the path's single stats-file parse.)
    from .chains.nested import sampler_lnz
    own = sampler_lnz(args.root_name)
    if own is not None:
        print(f"   sampler's own ln(Z) from its stats file: {own[0]} "
              f"+/- {own[1]}")
    if args.error:
        try:
            # split forwarded: the error bar must quantify the SAME
            # estimator (cross vs auto) as the lnz it accompanies, exactly
            # as the serve protocol does
            mean, err, _ = evidence_with_error(
                chains, kmax=args.kmax, ndim=ndim,
                priorvolume=prior_volume, burnlen=args.burnlen,
                thinlen=args.thinlen, seed=args.seed, engine=args.engine,
                split=args.cross, precision=args.precision,
                device=args.device)
            for k in range(1, mce.kmax):
                print(f"   per-chain ln(B)[k={k}] = {mean[k - 1]} "
                      f"+/- {err[k - 1]}")
        except ValueError as e:
            print(f"error bars unavailable: {e}", file=sys.stderr)
    if args.bootstrap > 0:
        try:
            # print the bootstrap's OWN center: with --cross and no --seed
            # its internal split is a different realization than the main
            # run's, and pairing one realization's center with another's
            # spread would be inconsistent
            blnz, berr, _ = evidence_bootstrap(
                chains, kmax=args.kmax, n_boot=args.bootstrap,
                seed=args.seed or 0, ndim=ndim, priorvolume=prior_volume,
                burnlen=args.burnlen, thinlen=args.thinlen,
                split=args.cross, engine=args.engine,
                precision=args.precision, device=args.device)
            # iterate over blnz's own length: the bootstrap clips k to its
            # (possibly split) partition size, which can be shorter than
            # the facade's kmax on tiny chains
            for k in range(1, len(blnz) + 1):
                print(f"   bootstrap ln(B)[k={k}] = {blnz[k - 1]} "
                      f"+/- {berr[k - 1]}")
        except ValueError as e:
            print(f"bootstrap error bars unavailable: {e}", file=sys.stderr)
    print("* ln(B)[k] is the natural logarithm of the Bayesian evidence "
          "estimated using the kth Nearest Neighbour.")
    print(CITE)
    return 0


if __name__ == "__main__":
    sys.exit(main())
