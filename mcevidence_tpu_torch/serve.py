"""Resident evidence service: JSON-lines requests over stdin/stdout.

The counterpart of ``mcevidence_tpu/serve.py``, with the same protocol.  A
process pays its one-off costs once (the CUDA kernels are built and loaded
at the first launch, or by ``--warmup``), after which every evidence call
runs at steady-state speed, instead of paying them per invocation the way
the one-shot CLI does.

Protocol: one JSON object per input line, one JSON object per output
line (flushed immediately).  Request fields mirror the CLI flags::

    {"root": "/path/chains/toy", "kmax": 3, "burn": 0.1, "thin": 2,
     "cross": false, "seed": 0, "priorvolume": null, "allparams": false,
     "unit_volume_fallback": false, "idchain": 0, "ndim": null,
     "engine": "auto", "precision": "refine", "error": false,
     "bootstrap": 0, "id": "anything-echoed-back"}

Only ``root`` is required.  Responses::

    {"id": ..., "ok": true, "lnz": [...], "kmax": 3,
     "prior_volume": ..., "ndim": ..., "wall_s": ...}
    {"id": ..., "ok": false, "error": "..."}

plus, when ``root`` is a nested-sampling product (MultiNest/PolyChord/
UltraNest), ``sampler_lnz``/``sampler_lnz_err`` — the run's own evidence
parsed from its stats file.

A blank line is ignored; EOF ends the service with exit code 0.  Run as
``python -m mcevidence_tpu_torch.serve``; ``--device`` (where the selection
runs: ``cuda``, the default, or ``cpu``; a process-level option, as the
protocol has no such field), ``--parse-cache DIR``, ``--warmup N,D`` (build
and load the kernels and run one device-precision estimate of an N-row,
D-param chain before accepting requests) and ``--workers N`` (overlap up to
N requests; responses stay strictly in request order, so clients need no
changes) are process-level options.  Worker threads share the default CUDA
stream; the kernel library is built and loaded under a lock.
"""

from __future__ import annotations

import json
import logging
import math
import os
import sys
import time
from argparse import ArgumentParser
from typing import Optional, TextIO

logger = logging.getLogger(__name__)

_ALLOWED = {
    "id", "root", "kmax", "idchain", "ndim", "burn", "thin", "cross",
    "seed", "priorvolume", "allparams", "unit_volume_fallback", "engine",
    "precision", "error", "bootstrap",
}


def _floats(values) -> list:
    """JSON-safe float list: RFC 8259 has no NaN/Infinity tokens, and
    json.dumps would emit them by default, breaking strict client parsers
    mid-protocol — non-finite values become null."""
    return [float(v) if math.isfinite(v) else None for v in values]


def handle_request(req: dict, *, device="cuda") -> dict:
    """One evidence request -> one response dict (raises nothing).
    ``device``: where the selection runs, the service's process-level
    option."""
    rid = req.get("id") if isinstance(req, dict) else None

    def fail(msg: str) -> dict:
        return {"id": rid, "ok": False, "error": msg}

    if not isinstance(req, dict):
        return fail("request must be a JSON object")
    unknown = set(req) - _ALLOWED
    if unknown:
        return fail(f"unknown request fields: {sorted(unknown)}")
    root = req.get("root")
    if not isinstance(root, str) or not root:
        return fail("request needs a 'root' string (chain root/file path)")

    engine = req.get("engine", "auto")
    precision = req.get("precision", "refine")
    t0 = time.perf_counter()
    try:
        from .chains.reader import load_chains
        from .evidence import MCEvidence
        from .priors.params_info import get_prior_volume

        priorvolume = req.get("priorvolume")
        prior_volume, ndim_meta = get_prior_volume(
            root, cosmo=not req.get("allparams", False),
            priorvolume=priorvolume,
            allow_unit_fallback=bool(req.get("unit_volume_fallback", False))
            or priorvolume is not None)
        ndim = req.get("ndim", None)
        ndim = ndim if ndim is not None else ndim_meta
        kmax = int(req.get("kmax", 2))
        chains = load_chains(root, idchain=int(req.get("idchain", 0)))
        mce = MCEvidence(chains, split=bool(req.get("cross", False)),
                         ndim=ndim, priorvolume=prior_volume, kmax=kmax,
                         verbose=0, burnlen=float(req.get("burn", 0)),
                         thinlen=float(req.get("thin", 0)),
                         seed=req.get("seed"), engine=engine,
                         precision=precision, device=device)
        lnz = mce.evidence()
        # prior_volume can itself be inf ('N' = unbounded in a .ranges file)
        resp = {"id": rid, "ok": True, "lnz": _floats(lnz),
                "kmax": mce.kmax,
                "prior_volume": _floats([prior_volume])[0],
                "ndim": mce.ndim}
        # nested-sampling roots: the sampler's own ln Z beside ours
        from .chains.nested import sampler_lnz
        own = sampler_lnz(root)
        if own is not None:
            resp["sampler_lnz"], resp["sampler_lnz_err"] = _floats(own)
    except Exception as e:  # per-request isolation: the service must live on
        logger.info("request failed: %s", e)
        return fail(f"{type(e).__name__}: {e}")
    # optional error-bar legs degrade per leg, like the CLI: a leg failure
    # must not discard the evidence just computed
    if req.get("error", False):
        try:
            from .evidence import evidence_with_error
            # split forwarded: the error bar quantifies the SAME estimator
            # (cross vs auto) as the lnz it accompanies
            mean, err, _ = evidence_with_error(
                chains, kmax=kmax, ndim=ndim, priorvolume=prior_volume,
                burnlen=float(req.get("burn", 0)),
                thinlen=float(req.get("thin", 0)), seed=req.get("seed"),
                split=bool(req.get("cross", False)), engine=engine,
                precision=precision, device=device)
            resp["per_chain_mean"] = _floats(mean)
            resp["per_chain_err"] = _floats(err)
        except Exception as e:
            resp["error_bars_error"] = f"{type(e).__name__}: {e}"
    try:
        # null / non-numeric values degrade like a failed leg
        nboot = int(req.get("bootstrap") or 0)
    except (TypeError, ValueError) as e:
        resp["bootstrap_error"] = f"bad 'bootstrap' value: {e}"
        nboot = 0
    if nboot > 0:
        try:
            from .evidence import evidence_bootstrap
            blnz, berr, _ = evidence_bootstrap(
                chains, kmax=kmax, n_boot=nboot,
                seed=req.get("seed") or 0, ndim=ndim,
                priorvolume=prior_volume,
                burnlen=float(req.get("burn", 0)),
                thinlen=float(req.get("thin", 0)),
                split=bool(req.get("cross", False)), engine=engine,
                precision=precision, device=device)
            resp["bootstrap_lnz"] = _floats(blnz)
            resp["bootstrap_err"] = _floats(berr)
        except Exception as e:
            resp["bootstrap_error"] = f"{type(e).__name__}: {e}"
    resp["wall_s"] = round(time.perf_counter() - t0, 6)
    return resp


def serve(stream_in: TextIO, stream_out: TextIO, workers: int = 1, *,
          device="cuda") -> int:
    """Request loop.  ``workers>1`` overlaps requests: up to ``workers``
    are in flight at once (one thread each: host prep for request N+1 runs
    while request N waits on the card), while responses stay strictly in
    request order, so the single-client protocol is byte-identical to
    serial mode.  Returns 0, 1 when the output failed, or 2 when in-flight
    requests made no progress during shutdown (a wedged call)."""
    def handle(req):
        return handle_request(req, device=device)

    if workers <= 1:
        for line in stream_in:
            line = line.strip()
            if not line:
                continue
            try:
                req = json.loads(line)
            except ValueError as e:
                resp = {"id": None, "ok": False, "error": f"bad JSON: {e}"}
            else:
                resp = handle(req)
            print(json.dumps(resp), file=stream_out, flush=True)
        return 0

    import threading
    from concurrent.futures import Future, ThreadPoolExecutor
    from queue import Queue

    pool = ThreadPoolExecutor(max_workers=workers)
    out_q: Queue = Queue()          # response futures, request order
    # backpressure: the reader blocks once 2*workers requests are in flight
    # or completed but unwritten, so a client that floods requests without
    # reading responses cannot grow memory without bound
    slots = threading.Semaphore(2 * workers)
    writer_dead = threading.Event()
    written = [0]                   # writer progress, read by the shutdown
    completed = [0]                 # finished handlers, in any order
    wedged = [False]

    def writer():
        # a dedicated writer thread lets lock-step clients work: the reader
        # blocks on stdin between requests, so it can never be the one to
        # emit a response that completes meanwhile
        while True:
            fut = out_q.get()
            if fut is None:
                return
            try:
                try:
                    resp = fut.result()
                except Exception:
                    # handle_request raises nothing, so this is a bug: log
                    # it and keep the service alive with an error response
                    logger.exception("request handler raised")
                    resp = {"id": None, "ok": False,
                            "error": "internal error (see service log)"}
                if not writer_dead.is_set():
                    print(json.dumps(resp), file=stream_out, flush=True)
                written[0] += 1
            except Exception as e:   # e.g. the client closed its read end
                logger.info("writer: output failed (%s: %s); shutting down",
                            type(e).__name__, e)
                writer_dead.set()
            finally:
                slots.release()

    wt = threading.Thread(target=writer, name="serve-writer", daemon=True)
    wt.start()
    try:
        for line in stream_in:
            if writer_dead.is_set():
                break
            line = line.strip()
            if not line:
                continue
            slots.acquire()          # one slot per queued future, always
            try:
                req = json.loads(line)
            except ValueError as e:
                fut: Future = Future()   # keep ordering for malformed lines
                fut.set_result({"id": None, "ok": False,
                                "error": f"bad JSON: {e}"})
            else:
                fut = pool.submit(handle, req)
            fut.add_done_callback(lambda _f: completed.__setitem__(
                0, completed[0] + 1))
            out_q.put(fut)
    finally:
        out_q.put(None)
        # Bounded shutdown: join as long as requests keep completing (in
        # any order: the writer drains in request order, so a slow
        # head-of-line request must not mask later completions).  A whole
        # stall window without progress means a wedged request: report rc 2,
        # on which main() hard-exits, since the pool's threads are
        # non-daemon and interpreter exit would join the wedged one.  Raise
        # MCE_SERVE_SHUTDOWN_STALL_S for requests slower than that window.
        stall = float(os.environ.get("MCE_SERVE_SHUTDOWN_STALL_S", "120"))
        last = (-1, -1)
        while wt.is_alive():
            wt.join(timeout=stall)
            if not wt.is_alive():
                break
            progress = (written[0], completed[0])
            if progress == last:
                logger.warning(
                    "shutdown: no response progress in %.0fs with requests "
                    "still in flight (wedged device call?); exiting without "
                    "them", stall)
                writer_dead.set()
                wedged[0] = True
                break
            last = progress
        pool.shutdown(wait=False)
    if wedged[0]:
        return 2
    return 1 if writer_dead.is_set() else 0


def _warmup(spec: str, device) -> None:
    """Build and load the kernels and run one device-precision estimate of
    an N-row, D-param chain, so that the first request finds them ready."""
    import numpy as np

    from .ops.pipeline import device_refine_evidence
    n, d = (int(x) for x in spec.split(","))
    rng = np.random.default_rng(0)
    theta = rng.normal(size=(n, d))
    lnl = -0.5 * np.sum(theta * theta, axis=1)
    device_refine_evidence(theta, lnl, kmax=2, device=device)
    logger.info("warmup for (%d, %d) on %s done", n, d, device)


def main(argv: Optional[list] = None) -> int:
    p = ArgumentParser(
        prog="mcevidence-serve",
        description="Resident MCEvidence service: JSON-lines over "
                    "stdin/stdout (one warm process, many requests)")
    p.add_argument("--device", default="cuda",
                   help="where the kNN selection runs: 'cuda' (default; "
                        "fails without a GPU) or 'cpu'")
    p.add_argument("--parse-cache", default="", metavar="DIR",
                   help="cache raw parsed chain tables as .npy under DIR")
    p.add_argument("--warmup", default="", metavar="N,D",
                   help="build and load the kernels and run one estimate of "
                        "an N-row D-param chain before accepting requests")
    p.add_argument("--workers", default=1, type=int, metavar="N",
                   help="overlap up to N requests (responses stay in "
                        "request order); 1 = strictly serial")
    p.add_argument("-vb", "--verbose", dest="verbose", default=0, type=int)
    args = p.parse_args(argv)
    from .utils.device import resolve_device
    from .utils.logging import configure
    configure(args.verbose)
    try:
        device = resolve_device(args.device)
    except (ValueError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.parse_cache:
        from .chains.reader import set_parse_cache
        set_parse_cache(args.parse_cache)
    if args.warmup:
        _warmup(args.warmup, device)
    rc = serve(sys.stdin, sys.stdout, workers=max(1, args.workers),
               device=device)
    if rc == 2:
        # a wedged in-flight call: the executor's threads are non-daemon and
        # are joined at interpreter exit, so sys.exit would block on the
        # wedged thread.  Flush and hard-exit.
        sys.stdout.flush()
        sys.stderr.flush()
        logging.shutdown()
        os._exit(2)
    return rc


if __name__ == "__main__":
    sys.exit(main())
