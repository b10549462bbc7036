"""The small-k body's screen (``csrc/knn_common.cuh``) in a float32
emulation: the kernel passes a pair to the exact recheck unless its score
lies under its query row's floor, so no pair whose difference-form key beats
the worst kept key may score under the floor that key gives.

``fma32`` rounds the exact a * b + c once to f32, as CUDA's ``fmaf`` does;
the emulation follows the kernel's order of operations: the difference form
(``diff_d2``: subtract, then FMA, in coordinate order), the start values
(``screen_start``), the scores (``scores``: W FMAs onto the start value) and
the floor (``screen_floor``: two FMAs from the worst key's high word and
|q|^2).  Each case gives every pair the hardest worst key it beats (its own
key plus one), under ``ExactKey`` and ``TruncKey<11/12>``, at W = 8 and 16.
``select_exact`` is the selection the body must return, bit for bit (the k
smallest keys, the self slot pinned); the card tests hold the kernels to it.
"""

import os
import re

import numpy as np
import pytest

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "mcevidence_tpu_torch", "csrc")

# the screen's constants as csrc/knn_common.cuh defines them
SLACK_STEP = 2.0 ** -19          # screen_slack<W>() = (W + 2) * 2^-19
ABS_SLACK = np.float32(2.0 ** -100)
QUERY_NORM_CAP = np.float32(2.0 ** 100)
ROW_NORM_CAP = np.float32(2.0 ** 126)
SENTINEL = np.float32(1e18)       # the prologue cut's padding rows
INF_BITS = 0x7F800000
EMPTY = 0xFFFFFFFFFFFFFFFF


def slack(width):
    return np.float32((width + 2) * SLACK_STEP)


def fma32(a, b, c):
    """f32 a * b + c rounded once (round to nearest even), elementwise: the
    product is exact in f64, the sum's rounding error is recovered by
    TwoSum, and a sum that lands on an f32 midpoint is sent the way of that
    error."""
    a, b, c = np.broadcast_arrays(np.float32(a) if np.isscalar(a) else a,
                                  np.float32(b) if np.isscalar(b) else b,
                                  np.float32(c) if np.isscalar(c) else c)
    with np.errstate(all="ignore"):
        p = a.astype(np.float64) * b.astype(np.float64)
        cc = c.astype(np.float64)
        s = p + cc
        bb = s - p
        err = (p - (s - bb)) + (cc - bb)
        r = s.astype(np.float32)
        toward = np.where(s > r.astype(np.float64), np.float32(np.inf),
                          np.float32(-np.inf))
        other = np.nextafter(r, toward)
        mid = (r.astype(np.float64) + other.astype(np.float64)) / 2
        fix = np.isfinite(err) & (err != 0) & (s == mid)
        up = np.maximum(r, other)
        down = np.minimum(r, other)
        return np.where(fix, np.where(err > 0, up, down), r).astype(
            np.float32)


def diff_d2(q, r):
    """(nq, nr) d2 by differences in coordinate order: the value a list
    keeps and returns."""
    d2 = np.zeros((q.shape[0], r.shape[0]), np.float32)
    with np.errstate(all="ignore"):
        for c in range(q.shape[1]):
            t = q[:, c, None] - r[None, :, c]
            d2 = fma32(t, t, d2)
    return d2


def square_norm(x):
    n = np.zeros(x.shape[0], np.float32)
    for c in range(x.shape[1]):
        n = fma32(x[:, c], x[:, c], n)
    return n


def screen_start(r):
    """Each reference row's start value, -|r|^2 (1 - e) / 2, or +inf past
    the row cap or for a NaN norm."""
    n = square_norm(r)
    shrink = np.float32(-0.5) * (np.float32(1) - slack(r.shape[1]))
    with np.errstate(all="ignore"):
        return np.where(n <= ROW_NORM_CAP, n * shrink,
                        np.float32(np.inf)).astype(np.float32)


def scores(q, r):
    """(nq, nr) scores: W FMAs onto each reference row's start value."""
    s = np.broadcast_to(screen_start(r)[None, :],
                        (q.shape[0], r.shape[0])).copy()
    for c in range(q.shape[1]):
        s = fma32(q[:, c, None], r[None, :, c], s)
    return s


def widest(high, low_bits):
    return high | ((1 << low_bits) - 1) if low_bits else high


def screen_floor(worst_high, qn, width, low_bits):
    """A query row's floor from its worst key's high word (uint32 array) and
    |q|^2 (f32 array)."""
    e = slack(width)
    h = widest(np.asarray(worst_high, np.uint64), low_bits)
    w = (h & 0xFFFFFFFF).astype(np.uint32).view(np.float32)
    t = fma32(-qn, np.float32(1) - e, fma32(w, np.float32(1) + e, ABS_SLACK))
    floor = np.float32(-0.5) * t
    passes_all = (h >= INF_BITS) | ~(qn <= QUERY_NORM_CAP)
    return np.where(passes_all, np.float32(-np.inf), floor).astype(
        np.float32)


def high_words(d2, low_bits):
    bits = d2.view(np.uint32).astype(np.uint64)
    return bits & ~np.uint64((1 << low_bits) - 1) if low_bits else bits


def keys(d2, low_bits):
    """uint64 keys (high word << 32) | j of an (nq, nr) d2."""
    j = np.arange(d2.shape[1], dtype=np.uint64)[None, :]
    return (high_words(d2, low_bits) << np.uint64(32)) | j


def select_exact(q, r, k, self_mode, low_bits=0, nr=None, cut=False,
                 nan_bits=None):
    """The selection the small-k body returns: per query row the k smallest
    keys of the difference-form d2 over the first nr reference rows (self
    row left out and pinned to slot 0 in self mode), d2 decoded from the
    key, absent slots (+inf, -1); with ``cut`` (kCutBound) a slot whose d2
    is past 1e30 is absent.  ``nan_bits``: the bits every NaN d2 takes (the
    card's arithmetic gives one NaN, 0x7FFFFFFF; the host's keeps
    payloads)."""
    nr = r.shape[0] if nr is None else nr
    d2 = diff_d2(q, r[:nr])
    if nan_bits is not None:
        d2[np.isnan(d2)] = np.uint32(nan_bits).view(np.float32)
    kk = keys(d2, low_bits)
    if self_mode:
        rows = np.arange(q.shape[0])
        inside = rows < nr
        kk[rows[inside], rows[inside]] = np.uint64(EMPTY)
    first = int(self_mode)
    keep = k - first
    d2 = np.full((q.shape[0], k), np.inf, np.float32)
    idx = np.full((q.shape[0], k), -1, np.int32)
    if self_mode:
        d2[:, 0] = 0.0
        idx[:, 0] = np.arange(q.shape[0])
    best = np.sort(kk, axis=1)[:, :keep]
    if best.shape[1] < keep:
        best = np.concatenate([best, np.full(
            (q.shape[0], keep - best.shape[1]), EMPTY, np.uint64)], 1)
    got = best != np.uint64(EMPTY)
    vals = (best >> np.uint64(32)).astype(np.uint32).view(np.float32)
    if cut:
        got &= ~(vals > np.float32(1e30))
    d2[:, first:] = np.where(got, vals, np.float32(np.inf))
    idx[:, first:] = np.where(got, (best & np.uint64(0xFFFFFFFF)).astype(
        np.int64), -1)
    return d2, idx


def _rows(rng, n, width, scale=1.0, offset=0.0):
    return (rng.normal(size=(n, width)) * scale + offset).astype(np.float32)


def case_inputs(case, width, seed=0):
    """(query, reference) f32 rows of one adversarial case."""
    rng = np.random.default_rng(seed + width)
    if case == "near_duplicates":       # d2 << |q|^2
        base = _rows(rng, 40, width, 3.0)
        r = np.repeat(base, 8, 0) + _rows(rng, 320, width, 1e-4)
        q = r[::7] + _rows(rng, 46, width, 1e-5)
    elif case == "exact_duplicates":
        r = np.repeat(_rows(rng, 30, width), 10, 0)
        q = r[::9].copy()
    elif case == "uncentred":           # |q|^2 ~ 1e4
        r = _rows(rng, 300, width, 1.0, 100.0 / np.sqrt(width))
        q = r[::6] + _rows(rng, 50, width, 1e-3)
    elif case == "lattice":             # every distance tied many times
        pts = np.array(np.meshgrid(*[np.arange(4)] * 4)).reshape(4, -1).T
        r = np.zeros((len(pts), width), np.float32)
        r[:, :4] = pts
        q = r[::5] + np.float32(0.5) * (np.arange(width) < 4)
    elif case == "sentinel":            # kCutBound's padding rows
        r = np.concatenate([_rows(rng, 200, width),
                            np.full((56, width), SENTINEL, np.float32)])
        q = r[:200:4].copy()
    elif case == "nonfinite":           # +-inf and NaN coordinates
        r = _rows(rng, 260, width)
        q = r[::5].copy()
        r[3, 1], r[7, 0], r[11, 2] = np.inf, -np.inf, np.nan
        r[13] = np.inf
        q[2, 0], q[5, 3], q[8, 1] = np.inf, np.nan, -np.inf
    elif case == "tiny":                # d2 in the subnormal range
        r = _rows(rng, 260, width, 1e-21)
        q = r[::5] + _rows(rng, 52, width, 1e-24)
    elif case == "huge":                # |q|^2 and |r|^2 past the caps
        r = _rows(rng, 260, width, 1.0)
        r[:20] *= np.float32(3e19)
        r[20:40] *= np.float32(3e14)
        q = r[::5].copy()
    else:
        raise ValueError(case)
    return np.ascontiguousarray(q), np.ascontiguousarray(r)


CASES = ("near_duplicates", "exact_duplicates", "uncentred", "lattice",
         "sentinel", "nonfinite", "tiny", "huge")
KEYS = {"exact": 0, "trunc11": 11, "trunc12": 12}


@pytest.mark.parametrize("key", sorted(KEYS))
@pytest.mark.parametrize("width", [8, 16, 32, 64])
@pytest.mark.parametrize("case", CASES)
def test_screen_passes_every_pair_that_beats_its_key(case, width, key):
    """Every pair scores at least the floor of the worst key it beats: its
    own key plus one, the hardest such key (a larger worst key gives a
    lower floor)."""
    low_bits = KEYS[key]
    q, r = case_inputs(case, width)
    d2 = diff_d2(q, r)
    floor = screen_floor(high_words(d2, low_bits), square_norm(q)[:, None],
                         width, low_bits)
    s = scores(q, r)
    rejected = s < floor                 # NaN scores pass, as on the card
    assert not rejected.any(), (
        f"{int(rejected.sum())} pairs rejected, e.g. d2 "
        f"{d2[rejected][:3]}, score {s[rejected][:3]}, floor "
        f"{floor[rejected][:3]}")
    # the floor is monotone in the worst key: one step up never rejects
    up = screen_floor(high_words(d2, low_bits) + (1 << low_bits),
                      square_norm(q)[:, None], width, low_bits)
    assert not (s < up).any()


@pytest.mark.parametrize("width", [1, 5, 8, 16, 64])
def test_screen_rejects_far_pairs(width):
    """Against the 9th neighbour's key of whitened rows, the screen passes
    few pairs beyond those within that distance: the slack is small."""
    rng = np.random.default_rng(width)
    r = _rows(rng, 2000, width)
    q = r[:200]
    d2 = diff_d2(q, r)
    worst = np.sort(d2, axis=1)[:, 9:10]
    floor = screen_floor(worst.view(np.uint32), square_norm(q)[:, None],
                         width, 0)
    passed = ~(scores(q, r) < floor)
    within = d2 <= worst
    assert (passed | ~within).all()
    assert passed.sum() <= within.sum() + 0.001 * d2.size


def test_fma32_rounds_once():
    """fma32 against exact rational arithmetic on values where rounding
    the f64 sum to f32 would round twice."""
    from fractions import Fraction
    rng = np.random.default_rng(7)
    a = rng.normal(size=4000).astype(np.float32)
    b = rng.normal(size=4000).astype(np.float32)
    c = (a.astype(np.float64) * b.astype(np.float64)).astype(np.float32)
    # c - a b is tiny, so the sum has bits far below f32's
    c = np.nextafter(c, np.float32(np.inf) * np.sign(rng.normal(size=4000)
                                                     ).astype(np.float32))
    got = fma32(a, b, -c)
    for x, y, z, g in zip(a[:400], b[:400], -c[:400], got[:400]):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        lo = np.float32(float(exact))
        cands = [np.nextafter(lo, np.float32(-np.inf)), lo,
                 np.nextafter(lo, np.float32(np.inf))]
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                         int(np.float32(v).view(np.uint32))
                                         & 1))
        assert g == best
    # a midpoint that f64 rounding hides: 1 + 2^-24 + 2^-60
    assert fma32(np.float32(1 + 2 ** -23), np.float32(1 + 2 ** -23),
                 np.float32(0)) == np.float32(1 + 2 ** -22)
    one = np.float32(1)
    half_ulp = np.float32(2.0 ** -24)
    assert fma32(half_ulp, np.float32(1 + 2 ** -23), one) == np.nextafter(
        one, np.float32(2))


@pytest.mark.parametrize("nr", [None, 5], ids=["all", "under_k"])
@pytest.mark.parametrize("self_mode", [True, False], ids=["self", "cross"])
def test_select_exact_is_the_plain_selection(self_mode, nr):
    """On rows whose f32 sums are exact (integer coordinates) the emulated
    selection returns the plain version's d2 and ranks ties by the smaller
    index (a stable f64 sort), the self slot pinned, absent slots past
    nr."""
    import torch
    from mcevidence_tpu_torch.ops import knn_hopper as kh
    rng = np.random.default_rng(3)
    r = rng.integers(-4, 5, size=(300, 6)).astype(np.float32)
    q = (r[:nr] if nr else r) if self_mode else rng.integers(
        -4, 5, size=(40, 6)).astype(np.float32)
    d2, idx = select_exact(q, r, 9, self_mode, nr=nr)
    want = kh.knn_select_torch(torch.from_numpy(q), torch.from_numpy(r), 9,
                               self_mode=self_mode, nr=nr, center=False)
    np.testing.assert_array_equal(d2, want[0].numpy())
    n = r.shape[0] if nr is None else nr
    f64 = ((q[:, None, :].astype(np.float64) - r[None, :n]) ** 2).sum(-1)
    if self_mode:
        f64[np.arange(len(q)), np.arange(len(q))] = -1.0
    order = np.argsort(f64, axis=1, kind="stable")[:, :9]
    np.testing.assert_array_equal(idx[:, :order.shape[1]], order)
    assert (idx[:, order.shape[1]:] == -1).all()


def test_constants_match_the_source():
    with open(os.path.join(CSRC, "knn_common.cuh")) as fh:
        src = fh.read()
    assert re.search(r"return \(W \+ 2\) \* 0x1p-19f;", src)
    for name, value in (("kScreenAbsSlack", "0x1p-100f"),
                        ("kQueryNormCap", "0x1p100f"),
                        ("kRowNormCap", "0x1p126f")):
        assert re.search(rf"constexpr float {name} = {value};", src), name
    assert float(ABS_SLACK) == 2.0 ** -100
    assert float(ROW_NORM_CAP) > 64 * float(SENTINEL) ** 2
