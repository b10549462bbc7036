"""Certification of every selection kernel against its plain version.

The counterpart of the repository's ``scripts/tpu_kernel_cert.py``.  Run
as

    python -m mcevidence_tpu_torch.kernel_cert [N] [d] [k] [--device cuda|cpu]

(defaults 4096, 12, 5).  Every wrapper of ``ops/knn_hopper.py`` that
launches a kernel (``kernel_bench.KERNELS``) runs its legs on N rows of
width d, whose rows past ``nr`` = N - 137 are garbage (1e6 times a normal
draw), each held to its plain version on the same tensors:

* self mode with the runtime count ``nr`` (every wrapper);
* cross mode, N / 2 query rows against the same reference rows and count
  (every wrapper but the prologue study's, which is a self-mode kernel);
* the batched forms (``knn_select_batched``, and the 3-D forms of
  ``knn_select_smalld``, ``knn_select_packed`` and ``knn_select_wide``) on
  three members whose counts differ: N - 137, N / 2 and N;
* the retry leg at k = min(26, nr - 1), the candidates of the refine
  guard's reselection, on every wrapper that takes that many (self; cross
  and batched on the large-k body's).

The packed selections run at 11 and 12 low bits, the prologue study in
both its variants.  Criterion (``scripts/tpu_kernel_cert.py:40-68``): the
d2 recomputed in f64 from the raw rows at the returned indices, sorted,
within ``REL_TOL`` (2^-10) relative of the plain version's sorted d2, d2
under the f32 centring's rounding floor held to that floor; absent slots
and the self pin equal; nothing selected at or past a member's count.
Prints one PASS/FAIL line a check; exits 0 only if every check passes.
On ``--device cpu`` the wrappers take their plain version.

``compare`` and ``compare_batched`` are the legs ``chip_smoke.py``'s
kernel phase runs; they print one JSON line a leg (``json_line``) unless
given another ``emit``.
"""

from __future__ import annotations

import functools
import json
import math
import sys
from argparse import ArgumentParser

import numpy as np
import torch

REL_TOL = 2.0 ** -10          # the kernel-cert criterion
D2_REL_TOL = 2.0 ** -18       # returned f32 d2 vs the plain version's
PACKED_D2_REL_TOL = 2.0 ** -11  # one quantum of a packed selection's d2
GARBAGE = 1e6                 # rows past a count: 1e6 times a normal draw
RETRY_K = 26                  # the guard's reselection at kmax=2: 4*4+8+2


class CertFailure(AssertionError):
    """A leg whose d2 missed its tolerance (its line is printed)."""


def f64_d2_at(query, ref, idx):
    """f64 squared distances at the returned indices, -1 -> +inf."""
    safe = idx.clamp(min=0).long()
    diff = query.double()[:, None, :] - ref.double()[safe]
    d2 = (diff * diff).sum(-1)
    return torch.where(idx < 0, torch.full_like(d2, math.inf), d2)


def returned_d2_rel(kd2, pd2):
    """Largest relative gap between the kernel's returned f32 d2 and the
    plain version's, both sorted per row; zero distances must match."""
    k = torch.sort(kd2.double(), dim=1).values
    p = torch.sort(pd2.double(), dim=1).values
    fin = torch.isfinite(p)
    if bool(((p[fin] == 0) != (k[fin] == 0)).any()):
        raise AssertionError("returned d2: zero distances differ")
    pos = fin & (p > 0)
    if not bool(pos.any()):
        return 0.0
    return float(((k[pos] - p[pos]).abs() / p[pos]).max())


def check_selection(name, query, ref, kd2, kidx, pd2, pidx, self_mode,
                    nr=None):
    """One selection against the plain version's; returns (max_rel,
    max_abs, returned_rel) of the d2."""
    if kd2.shape != pd2.shape:
        raise AssertionError(f"{name}: shape {tuple(kd2.shape)} vs "
                             f"{tuple(pd2.shape)}")
    if not bool(((kidx < 0) == (pidx < 0)).all()) or not bool(
            (torch.isinf(kd2) == torch.isinf(pd2)).all()):
        raise AssertionError(f"{name}: absent slots differ")
    if self_mode:
        rows = torch.arange(query.shape[0], device=kidx.device)
        if not bool((kidx[:, 0] == rows).all()) or bool(kd2[:, 0].any()):
            raise AssertionError(f"{name}: self pin broken")
    if nr is not None and bool((kidx >= nr).any()):
        raise AssertionError(f"{name}: selected a row at or past nr={nr}")
    # the f64 d2 of the raw rows at the kernel's indices against the plain
    # version's f32 d2 of centred rows.  Centring in f32 moves each
    # coordinate difference by at most e = 2^-23 (max|x| + max|mu|), so a d2
    # by at most 2 sqrt(d d2) e + d e^2: that stays below REL_TOL of any d2
    # above floor = 5 d e^2 / REL_TOL^2, and below REL_TOL * floor under it.
    # The mean is taken here in f64 over the valid rows, apart from the
    # port's, so garbage reaching the port's mean shows as a gap.
    valid = ref[:ref.shape[0] if nr is None else nr].double()
    scale = float(query.double().abs().max()) if query.numel() else 0.0
    if valid.numel():
        scale = max(scale, float(valid.abs().max())) + float(
            valid.mean(0).abs().max())
    e = 2.0 ** -23 * scale
    floor = 5.0 * query.shape[-1] * e * e / REL_TOL ** 2
    got = torch.sort(f64_d2_at(query, ref, kidx), dim=1).values
    want = torch.sort(pd2.double(), dim=1).values
    fin = torch.isfinite(want)
    num = (got[fin] - want[fin]).abs()
    rel = abs_err = 0.0
    if num.numel():
        rel = float((num / want[fin].clamp(min=max(floor, 1e-30))).max())
        abs_err = float((kd2.double()[fin] - want[fin]).abs().max())
    return rel, abs_err, returned_d2_rel(kd2, pd2)


def truncated_bits_set(kd2, low_bits):
    """Whether any finite returned d2 has one of its low ``low_bits``
    mantissa bits set (the packed selections clear them)."""
    fin = torch.isfinite(kd2)
    bits = kd2[fin].contiguous().view(torch.int32) & ((1 << low_bits) - 1)
    return bool(bits.any())


def json_line(record):
    """A leg's record as ``chip_smoke.py`` prints it."""
    print(json.dumps({"phase": "kernel_vs_plain", **record}), flush=True)


def pass_fail_line(record):
    """A leg's record as ``scripts/tpu_kernel_cert.py`` prints it."""
    print(f"{'PASS' if record['ok'] else 'FAIL'} {record['leg']:60s} "
          f"max_rel_d2_err={record['max_rel_d2_err']:.3e} "
          f"returned_d2_rel_err={record['returned_d2_rel_err']:.3e}",
          flush=True)


def report(name, k, nq, nr, rel, abs_err, d2_rel, returned, low_bits=0,
           emit=json_line):
    """``returned``: the leg also holds the returned d2 to D2_REL_TOL, or
    with ``low_bits`` (a packed selection against the plain version with
    the same truncation) to one quantum, PACKED_D2_REL_TOL; its low bits
    are checked to be zero on every leg.  ``emit`` prints the record;
    raises ``CertFailure`` past a tolerance."""
    d2_tol = PACKED_D2_REL_TOL if low_bits else D2_REL_TOL
    ok = rel <= REL_TOL and (not returned or d2_rel <= d2_tol)
    emit(dict(leg=name, k=k, nq=nq, nr=nr, max_rel_d2_err=rel,
              max_abs_d2_err=abs_err, returned_d2_rel_err=d2_rel,
              returned_d2_checked=returned, returned_d2_tol=d2_tol,
              low_bits=low_bits, ok=ok))
    if not ok:
        raise CertFailure(f"{name}: max_rel_d2_err {rel} > {REL_TOL} or "
                          f"returned d2 {d2_rel} > {d2_tol}")
    return rel, abs_err


def _synchronize(t):
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def compare(name, kernel, query, ref, k, self_mode, nr=None,
            returned=False, low_bits=0, plain=None, emit=json_line):
    """One unbatched kernel-vs-plain leg; ``low_bits``: the truncation the
    plain version applies too; ``plain``: another plain version than
    ``knn_select_torch``."""
    from .ops.knn_hopper import knn_select_torch
    kd2, kidx = kernel(query, ref, k, self_mode=self_mode, nr=nr)
    if plain is None:
        pd2, pidx = knn_select_torch(query, ref, k, self_mode=self_mode,
                                     nr=nr, low_bits=low_bits)
    else:
        pd2, pidx = plain(query, ref, k, self_mode=self_mode, nr=nr)
    _synchronize(kd2)
    if low_bits and truncated_bits_set(kd2, low_bits):
        raise AssertionError(f"{name}: a returned d2 keeps its low bits")
    res = check_selection(name, query, ref, kd2, kidx, pd2, pidx, self_mode,
                          nr)
    return report(name, k, query.shape[0],
                  ref.shape[0] if nr is None else nr, *res, returned,
                  low_bits, emit=emit)


def compare_batched(name, query, ref, k, self_mode, nr, nq, kernel=None,
                    returned=False, low_bits=0, emit=json_line):
    """One batched kernel-vs-plain leg: member b's first nq[b] rows are
    checked like an unbatched leg against its first nr[b] reference rows;
    its padded query rows must come back absent."""
    from .ops import knn_hopper as kh
    kernel = kernel or kh.knn_select_batched
    kd2, kidx = kernel(query, ref, k, self_mode=self_mode, nr=nr, nq=nq)
    pd2, pidx = kh.knn_select_torch_batched(query, ref, k,
                                            self_mode=self_mode, nr=nr,
                                            nq=nq, low_bits=low_bits)
    _synchronize(kd2)
    if low_bits and truncated_bits_set(kd2, low_bits):
        raise AssertionError(f"{name}: a returned d2 keeps its low bits")
    rel = abs_err = d2_rel = 0.0
    for b, (n_q, n_r) in enumerate(zip(nq, nr)):
        if not bool((kidx[b, n_q:] == -1).all()) or not bool(
                torch.isinf(kd2[b, n_q:]).all()):
            raise AssertionError(f"{name}: member {b} padded rows not "
                                 "absent")
        r_b, a_b, d_b = check_selection(
            f"{name} member {b}", query[b, :n_q], ref[b], kd2[b, :n_q],
            kidx[b, :n_q], pd2[b, :n_q], pidx[b, :n_q], self_mode, n_r)
        rel, abs_err, d2_rel = max(rel, r_b), max(abs_err, a_b), max(d2_rel,
                                                                     d_b)
    return report(name, k, list(nq), list(nr), rel, abs_err, d2_rel,
                  returned, low_bits, emit=emit)


def tie_order_broken(kidx, self_mode, nr):
    """With every row one point, all d2 are 0 and the slots must hold the
    indices in order: the self row first in self mode, then 0, 1, ... (the
    self row skipped), absent past nr."""
    nq, k = kidx.shape
    rows = torch.arange(nq, device=kidx.device)[:, None]
    rank = torch.arange(k, device=kidx.device)[None, :]
    if self_mode:
        want = rank - 1 + (rank - 1 >= rows).long()
        want = torch.where(rank == 0, rows, want)
        valid = rank < min(nr, k)
    else:
        want = rank.expand(nq, k)
        valid = rank < min(nr, k)
    want = torch.where(valid, want, -1)
    return not bool((kidx.long() == want).all())


def _variants(kh):
    """(label, wrapper name, function, low_bits, plain) of every 2-D
    selection the cert runs; the prologue study's with its own plain
    version."""
    out = [("small_k", "knn_select_small_k", kh.knn_select_small_k, 0, None),
           ("large_k", "knn_select_large_k", kh.knn_select_large_k, 0, None),
           ("smalld", "knn_select_smalld", kh.knn_select_smalld, 0, None)]
    for lb in kh.PACKED_LOW_BITS:
        out.append((f"packed{lb}", "knn_select_packed", functools.partial(
            kh.knn_select_packed, low_bits=lb), lb, None))
    for v in kh.PROLOGUE_CUTS:
        out.append((f"prologue_{v}", "knn_select_prologue",
                    functools.partial(kh.knn_select_prologue, variant=v), 12,
                    kh.knn_select_prologue_torch))
    out.append(("wide", "knn_select_wide", kh.knn_select_wide, 0, None))
    return out


def cert_legs(n, d, k, device, seed=7):
    """The cert's legs at N=``n`` rows of width ``d`` and ``k`` neighbours
    on ``device``: a list of (name, wrapper name, call), each call taking
    an ``emit`` and running one ``compare``/``compare_batched``."""
    from .ops import knn_hopper as kh
    rng = np.random.default_rng(seed)

    def dev_rows(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    nr = n - 137
    full = rng.normal(size=(n, d))
    full[nr:] = GARBAGE * rng.normal(size=(n - nr, d))
    x = dev_rows(full)
    qry = dev_rows(rng.normal(size=(n // 2, d)))
    nrs = [n - 137, n // 2, n]
    batch = rng.normal(size=(3, n, d))
    for b, m in enumerate(nrs):
        batch[b, m:] = GARBAGE * rng.normal(size=(n - m, d))
    xb = dev_rows(batch)
    kr = min(RETRY_K, nr - 1)
    small_max = kh.SMALL_K_MAX
    legs = []

    def leg(name, wname, fn, *args, batched=False, **kw):
        if batched:
            def call(emit):
                return compare_batched(name, *args, kernel=fn, emit=emit,
                                       **kw)
        else:
            def call(emit):
                return compare(name, fn, *args, emit=emit, **kw)
        legs.append((name, wname, call))

    for label, wname, fn, lb, plain in _variants(kh):
        if wname == "knn_select_smalld" and d > kh.SMALLD_MAX:
            continue
        extra = dict(low_bits=lb, plain=plain)
        fits = k - 1 <= small_max if wname == "knn_select_prologue" else (
            k <= small_max if wname == "knn_select_small_k" else True)
        if fits:
            leg(f"{label}/self nr={nr}", wname, fn, x[:nr], x, k, True, nr,
                **extra)
            if wname != "knn_select_prologue":
                leg(f"{label}/cross nr={nr}", wname, fn, qry, x, k, False,
                    nr, **extra)
        if wname not in ("knn_select_small_k", "knn_select_prologue"):
            leg(f"{label}/self nr={nr} @k{kr}", wname, fn, x[:nr], x, kr,
                True, nr, **extra)
    leg(f"large_k/cross nr={nr} @k{kr}", "knn_select_large_k",
        kh.knn_select_large_k, qry, x, kr, False, nr)
    batched = [("batched", "knn_select_batched", kh.knn_select_batched, 0),
               ("smalld_batched", "knn_select_smalld", kh.knn_select_smalld,
                0)]
    batched += [(f"packed{lb}_batched", "knn_select_packed",
                 functools.partial(kh.knn_select_packed, low_bits=lb), lb)
                for lb in kh.PACKED_LOW_BITS]
    batched.append(("wide_batched", "knn_select_wide", kh.knn_select_wide, 0))
    for label, wname, fn, lb in batched:
        if wname == "knn_select_smalld" and d > kh.SMALLD_MAX:
            continue
        for kk in (k, kr):
            leg(f"{label}/self nr={nrs} @k{kk}", wname, fn, xb, xb, kk, True,
                nrs, nrs, batched=True, low_bits=lb)
    return legs


def run_cert(n, d, k, device, emit=pass_fail_line):
    """Every leg of ``cert_legs``; a leg that fails prints its FAIL line
    and the rest still run.  Returns (checks, failures) as leg names."""
    checks, failures = [], []
    for name, _, call in cert_legs(n, d, k, device):
        checks.append(name)
        try:
            call(emit)
        except CertFailure:
            failures.append(name)
        except AssertionError as exc:
            print(f"FAIL {name:60s} {exc}", flush=True)
            failures.append(name)
    return checks, failures


def main(argv=None) -> int:
    p = ArgumentParser(prog="python -m mcevidence_tpu_torch.kernel_cert",
                       description="every selection kernel against its "
                                   "plain version; one PASS/FAIL line a "
                                   "check")
    p.add_argument("n", nargs="?", type=int, default=4096)
    p.add_argument("d", nargs="?", type=int, default=12)
    p.add_argument("k", nargs="?", type=int, default=5)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; fails without a GPU) or 'cpu' "
                        "(the plain versions)")
    args = p.parse_args(argv)
    from .utils.device import gpu_name_and_power_limit, resolve_device
    dev = resolve_device(args.device)
    gpu = gpu_name_and_power_limit() if dev.type == "cuda" else None
    print(f"device={dev} gpu={gpu} n={args.n} d={args.d} k={args.k}",
          flush=True)
    checks, failures = run_cert(args.n, args.d, args.k, dev)
    if failures:
        print(f"FAILED: {len(failures)} of {len(checks)} checks: "
              f"{failures}", flush=True)
        return 1
    print(f"ALL PASS: {len(checks)} checks on {dev}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
