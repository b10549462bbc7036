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
(``python -m mcevidence_tpu_torch.compare``) and the reference's
``MCSamples`` surface.  It imports torch and numpy, never jax.

The API is exported lazily, so that importing the package stays cheap.
"""

from ._version import __version__

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
}


def __getattr__(name):
    if name in _EXPORTS:
        import importlib
        module = importlib.import_module(f".{_EXPORTS[name]}", __name__)
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["__version__", *_EXPORTS]
