"""Entry points of the port: the fused evidence step, and a dry run of the
ring on n ranks.

The counterpart of the repository's ``__graft_entry__.py``:

* ``entry()`` returns ``(fn, example_args)``: the fused auto-evidence step
  (whitening from the moments, the kernel's self selection of kmax
  neighbours, the f32 estimator) and a synthetic Planck-sized chain
  (4096 x 8, kmax = 5), as tensors on the card unless ``device="cpu"``.
* ``dryrun_multichip(n)`` starts n ranks of one process group (processes
  with a file rendezvous, ``parallel/launch.py``) and runs every sharded
  program on them: the ring's auto and cross evidence, its refine and
  device precisions and, for even n >= 4, the 2 x (n/2) dp x ring grid
  and its cross legs, with the asserts of ``__graft_entry__.py`` and, which
  it never had, each answer held to the same estimate on one card.  The
  ranks run on the host's cards (rank r on ``cuda:(r mod cards)``) unless
  ``device="cpu"``; over gloo (host copies of the shards, so ranks may
  share a card) or, with n cards, NCCL.

JAX's relay probes (``_probe_backend``, ``_initialized_device_count``)
guard a remote TPU backend and have no counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch

KMAX = 5


def _synthetic_chain(n, ndim, seed=0):
    """``__graft_entry__.py``'s chain: drawn from its own normalised
    Gaussian likelihood, as f32."""
    rng = np.random.default_rng(seed)
    mean = np.arange(1.0, ndim + 1.0)
    sigma = np.full(ndim, 0.05)
    theta = rng.normal(mean, sigma, size=(n, ndim))
    dm = (theta - mean) / sigma
    lnl = (-0.5 * np.sum(dm * dm, axis=1)
           - 0.5 * ndim * np.log(2 * np.pi) - np.sum(np.log(sigma)))
    return theta.astype(np.float32), lnl.astype(np.float32)


def evidence_step(samples: torch.Tensor, lnlike: torch.Tensor,
                  weights: torch.Tensor) -> torch.Tensor:
    """Auto evidence of one chain on the tensors' device, in f32: the
    (KMAX,) MLE row, column 0 unused."""
    from .ops.estimator import log_evidence_from_knn
    from .ops.knn_hopper import knn_select_cuda
    from .ops.whiten import whiten_masked
    valid = torch.ones_like(lnlike)
    white, log_j, _ = whiten_masked(samples, valid)
    d2, _ = knn_select_cuda(white, white, KMAX, self_mode=True)
    return log_evidence_from_knn(
        d2, lnlike, weights, weights.sum(), samples.shape[1],
        log_jacobian=log_j, log_prior_volume=0.0, k_start=1, squared=True)


def entry(device="cuda"):
    """(fn, example_args): the fused evidence step and a 4096 x 8 chain as
    f32 tensors on ``device``."""
    from .utils.device import resolve_device
    dev = resolve_device(device)
    theta, lnl = _synthetic_chain(4096, 8)
    w = np.ones(len(theta), np.float32)
    return evidence_step, tuple(torch.as_tensor(a, device=dev)
                                for a in (theta, lnl, w))


def _close(name, got, want, tol):
    gap = float(np.max(np.abs(np.asarray(got) - np.asarray(want))))
    assert gap <= tol, f"{name}: |dlnZ| {gap} > {tol} ({got} vs {want})"
    return gap


def _dryrun_rank(n_devices: int, device: str) -> dict:
    """One rank of ``dryrun_multichip``: every sharded program, its
    asserts, and each answer against the one-card estimate."""
    import torch.distributed as dist

    from .evidence import evidence_fn
    from .parallel.ring import (make_sharded_evidence, pad_for_mesh,
                                sharded_auto_evidence,
                                sharded_cross_evidence,
                                sharded_device_refine_evidence,
                                sharded_grid_auto_evidence,
                                sharded_grid_device_refine_evidence,
                                sharded_grid_evidence_refine)
    rank = dist.get_rank()
    if device != "cpu":
        device = f"cuda:{rank % torch.cuda.device_count()}"
    out, gaps = {}, {}

    def say(msg):
        if rank == 0:
            print(f"dryrun_multichip({n_devices}): {msg}", flush=True)

    n, ndim, kmax = 257, 4, 3          # uneven on purpose: exercises padding
    theta, lnl = _synthetic_chain(n, ndim, seed=1)
    s, lnl_p, w, valid = pad_for_mesh(theta.astype(np.float64), lnl, None,
                                      n_devices)
    fn = make_sharded_evidence(kmax=kmax, ndim=ndim, device=device)
    mle = fn(s, lnl_p, w, valid, n, 0.0)
    assert mle.shape == (kmax,), mle.shape
    assert np.all(np.isfinite(mle[1:])), mle
    one = evidence_fn(theta, lnl, kmax=kmax, precision="fast", device=device)
    gaps["auto_fast"] = _close("auto vs one card", mle[1:], one, 3e-3)
    out["auto"] = mle[1:]
    say(f"auto lnZ[k=1..{kmax - 1}] = {mle[1:]}")

    # cross evidence: s1 query shards stay, s2 reference shards go round
    n1 = 131
    cross = sharded_cross_evidence(theta[:n1], lnl[:n1], theta[n1:],
                                   kmax=kmax, device=device)
    assert cross.shape == (kmax - 1,) and np.all(np.isfinite(cross)), cross
    one = evidence_fn(theta[:n1], lnl[:n1], samples2=theta[n1:], kmax=kmax,
                      precision="fast", device=device)
    gaps["cross_fast"] = _close("cross vs one card", cross, one, 3e-3)
    out["cross"] = cross
    say(f"cross lnZ = {cross}")

    # the parity path: ring selection, host f64 refinement
    ref = sharded_auto_evidence(theta, lnl, kmax=kmax, precision="refine",
                                device=device)
    assert np.all(np.isfinite(ref)), ref
    _close("refine vs fast", ref, mle[1:], 2e-2)
    one_ref = evidence_fn(theta, lnl, kmax=kmax, device=device)
    gaps["auto_refine"] = _close("refine vs one card", ref, one_ref, 1e-9)
    out["refine"] = ref
    say(f"refine-path lnZ = {ref}")

    # device precision: each rank's query shard refined and reduced on its
    # card, partials gathered
    dev = sharded_device_refine_evidence(theta, lnl, kmax=kmax,
                                         device=device)
    assert np.all(np.isfinite(dev)), dev
    gaps["auto_device"] = _close("device-refine vs refine", dev, ref, 1e-8)
    out["device_refine"] = dev
    say(f"device-refine lnZ = {dev}")

    if n_devices >= 4 and n_devices % 2 == 0:
        # dp x ring: a batch of chains over 2 rings of n/2 ranks
        t2, l2 = _synthetic_chain(193, ndim, seed=2)
        batch = [(theta, lnl), (t2, l2), (theta[:150], lnl[:150])]
        grid = sharded_grid_auto_evidence(batch, kmax=kmax, dp=2,
                                          device=device)
        assert grid.shape == (3, kmax - 1) and np.all(np.isfinite(grid))
        one = np.array([evidence_fn(t, ll, kmax=kmax, precision="fast",
                                    device=device) for t, ll in batch])
        gaps["grid_fast"] = _close("grid vs one card", grid, one, 3e-3)
        out["grid"] = grid
        say(f"dp x ring grid lnZ = {grid[:, 0]}")

        gdev = sharded_grid_device_refine_evidence(batch[:2], kmax=kmax,
                                                   dp=2, device=device)
        assert gdev.shape == (2, kmax - 1) and np.all(np.isfinite(gdev))
        _close("grid device-refine vs refine", gdev[0], ref, 1e-6)
        one = np.array([evidence_fn(t, ll, kmax=kmax, device=device)
                        for t, ll in batch[:2]])
        gaps["grid_device"] = _close("grid device-refine vs one card",
                                     gdev, one, 1e-8)
        out["grid_device"] = gdev
        say(f"dp x ring device-refine lnZ = {gdev[:, 0]}")

        # the cross legs: a per-chain reference partition (k0 = 0)
        xchains = [(theta[:n1], lnl[:n1]), (t2[:97], l2[:97])]
        xrefs = [theta[n1:], t2[97:]]
        gx = sharded_grid_evidence_refine(xchains, chains2=xrefs, kmax=kmax,
                                          dp=2, device=device)
        assert gx.shape == (2, kmax - 1) and np.all(np.isfinite(gx)), gx
        _close("grid cross refine vs cross", gx[0], cross, 2e-2)
        gxd = sharded_grid_device_refine_evidence(
            xchains, chains2=xrefs, kmax=kmax, dp=2, device=device)
        _close("grid cross device-refine vs refine", gxd, gx, 1e-8)
        one = np.array([evidence_fn(t, ll, samples2=r, kmax=kmax,
                                    device=device)
                        for (t, ll), r in zip(xchains, xrefs)])
        gaps["grid_cross_refine"] = _close("grid cross refine vs one card",
                                           gx, one, 1e-9)
        out["grid_cross_refine"], out["grid_cross_device"] = gx, gxd
        say(f"dp x ring cross refine lnZ = {gx[:, 0]}, device-refine lnZ "
            f"= {gxd[:, 0]}")
    out = {k: np.asarray(v).tolist() for k, v in out.items()}
    out["max_abs_dlnz_vs_one_card"] = gaps
    out["ran_on"] = device if device == "cpu" else "cuda"
    return out


def dryrun_multichip(n_devices: int, *, device: str = "cuda",
                     backend: str = "gloo", timeout: float = 900.0) -> dict:
    """Run every sharded program on ``n_devices`` ranks over ``backend``
    (on the cards unless ``device="cpu"``); raises if a rank fails or the
    ranks disagree.  Returns rank 0's lnZ values and its gaps to the
    one-card estimates."""
    from .parallel.launch import RankPool, check_backend
    cards = ["cpu"] * n_devices
    if device != "cpu":
        from .utils.device import resolve_device
        resolve_device(device)           # no card: fail before any rank
        cards = [f"cuda:{r % torch.cuda.device_count()}"
                 for r in range(n_devices)]
    check_backend(backend, cards)
    with RankPool(n_devices, backend=backend, timeout=timeout) as pool:
        results = pool.run(_dryrun_rank, n_devices, device)
    for r, got in enumerate(results[1:], 1):
        for key, val in got.items():
            if key != "max_abs_dlnz_vs_one_card" and val != results[0][key]:
                raise AssertionError(f"dryrun_multichip: rank {r}'s {key} "
                                     f"{val} != rank 0's {results[0][key]}")
    return results[0]
