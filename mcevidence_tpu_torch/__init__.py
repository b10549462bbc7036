"""mcevidence_tpu_torch — the PyTorch/CUDA port of ``mcevidence_tpu``.

The Heavens et al. (2017, arXiv:1704.03472) kNN marginal-likelihood
estimator in ``refine``, ``device`` and ``fast`` precision: host chain
ingestion, burn-in, thinning and split, whitening, the O(N^2 d)
nearest-neighbour candidate selection in hand-written CUDA kernels on an
NVIDIA Hopper GPU (one chain, or a batch of chains in one launch), the f64
refinement and estimator on the host or on the card (or the f32 estimator
on the card in ``fast`` precision), the Planck grid driver
(``python -m mcevidence_tpu_torch.planck``), the JSON-lines service
(``python -m mcevidence_tpu_torch.serve``), the model comparison
(``python -m mcevidence_tpu_torch.compare``), the reference's
``MCSamples`` surface, the ring over ``torch.distributed`` ranks
(``parallel/ring.py``, ``graft_entry.py``), and the validation harness:
the NUTS and stretch-move samplers (``samplers.py``) and the
analytic-truth examples (``python -m mcevidence_tpu_torch.examples``).
It imports torch and numpy, never jax.

The API is exported lazily, so that importing the package stays cheap.
"""

from ._version import __version__
from .registry import COSMO_PARAMS as _COSMO_PARAMS

_EXPORTS = {
    "MCEvidence": "evidence",
    "MCSamples": "compat",
    "split_var": "compat",
    "compare_models": "compare",
    "evidence_fn": "evidence",
    "evidence_with_error": "evidence",
    "evidence_bootstrap": "evidence",
    "device_refine_evidence": "ops.pipeline",
    "fast_auto_evidence": "ops.pipeline",
    "sharded_grid_device_refine_evidence": "parallel.ring",
    "sharded_grid_auto_evidence": "parallel.ring",
    "sharded_auto_evidence": "parallel.ring",
    "sharded_cross_evidence": "parallel.ring",
    "sharded_device_refine_evidence": "parallel.ring",
    "load_nested_chains": "chains.nested",
    "sampler_lnz": "chains.nested",
    "COSMO_PARAMS": "registry",
    "extend_cosmo_params": "registry",
    "iscosmo_param": "registry",
    "get_prior_volume": "priors.params_info",
    "params_info": "priors.params_info",
    "nuts_sample": "samplers",
    "stretch_sample": "samplers",
}


# the reference-compatible alias (mcevidence_tpu/__init__.py:23-24)
cosmo_params_list = list(_COSMO_PARAMS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib
        module = importlib.import_module(f".{_EXPORTS[name]}", __name__)
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["__version__", "cosmo_params_list", *_EXPORTS]
