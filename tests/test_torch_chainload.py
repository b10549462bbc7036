"""The port's native chain parser (``mcevidence_tpu_torch/native``) against
the JAX package's and Python's ``float()``, bit for bit.

The port parses a file in one pass and reads CosmoMC's ``%16.7E`` fields
with a fixed-layout decoder, every other token with the general one; the
JAX package's parser converts every token with the general one.  Both must
give ``strtod``'s bits (``float()``'s) on every input, refuse the same
files, and the port must count the fields its fixed-layout decoder took:
those of the layout whose exponent e has |e - 7| <= 22.  A parse in row
slices, one thread a slice, gives the one-slice table bit for bit.
"""

import os
import re
import sys
import time

import numpy as np
import pytest

from mcevidence_tpu.native import chainload as ref_chainload
from mcevidence_tpu_torch import planck
from mcevidence_tpu_torch.chains import reader
from mcevidence_tpu_torch.native import chainload
from mcevidence_tpu_torch.utils.spans import collect

FIXED = re.compile(r"[+-]?\d\.\d{7}E([+-]\d\d)")
PAGE = 4096


@pytest.fixture(scope="module")
def ref():
    """The JAX package's loader.  Its library is built by the first test
    process that needs it; one that met another's build half-written tries
    again once that build is done."""
    for _ in range(3):
        if ref_chainload._get_lib() is not None:
            return ref_chainload
        ref_chainload._build_failed = False
        time.sleep(5)
    pytest.fail("the JAX package's native parser did not build")


@pytest.fixture(scope="module")
def lib():
    assert chainload._get_lib() is not None, "the native parser did not build"


def tokens(text):
    return [t for line in text.splitlines()
            if line.strip() and not line.lstrip().startswith("#")
            for t in line.split()]


def n_fixed(text):
    """The tokens the fixed-layout decoder should take."""
    return sum(1 for t in tokens(text)
               if (m := FIXED.fullmatch(t)) and abs(int(m[1]) - 7) <= 22)


def as_float(tok):
    return float(tok.replace("D", "E").replace("d", "e"))


def check(path, text, ncols):
    """Port, JAX package and ``float()`` agree bit for bit; the fixed
    count is the layout's."""
    got, nfixed, _ = chainload.parse_table(str(path))
    want = np.array([as_float(t) for t in tokens(text)]).reshape(-1, ncols)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.int64), want.view(np.int64))
    other = ref_chainload.load_table(str(path))
    np.testing.assert_array_equal(got.view(np.int64),
                                  other.view(np.int64))
    np.testing.assert_array_equal(chainload.load_table(str(path)), got)
    assert nfixed == n_fixed(text)
    return got, nfixed


def write(tmp_path, text, name="t.txt"):
    p = tmp_path / name
    p.write_bytes(text.encode())
    return p


def fixed_values(rng, n):
    """n values whose ``%16.7E`` exponents run over -99..99, both sides of
    the decoder's window, with signed zeros and each window edge."""
    e = rng.integers(-99, 100, size=n)
    v = rng.uniform(1.0, 10.0, size=n) * 10.0 ** e.astype(float)
    v *= rng.choice([-1.0, 1.0], size=n)
    edges = [s * m * 10.0 ** x for x in (-16, -15, 29, 30)
             for s in (-1, 1) for m in (1.0, 9.9999999)]
    v[:len(edges)] = edges
    v[len(edges):len(edges) + 4] = [0.0, -0.0, 1.0, -1.0]
    return v


def test_random_fixed_layout_fields_match_bit_for_bit(tmp_path, rng, ref,
                                                      lib):
    v = fixed_values(rng, 100_000).reshape(1000, 100)
    text = "".join("".join("%16.7E" % x for x in row) + "\n" for row in v)
    got, nfixed = check(write(tmp_path, text), text, 100)
    assert 0 < nfixed < got.size          # both sides of the window
    assert np.any((got == 0) & np.signbit(got))       # -0.0 kept


@pytest.mark.parametrize("fmt", ["%.6e", "%.8g", "%.4f", "%d", "D", "%.20g",
                                 "%.17E", "%16.7e", "mixed"])
def test_other_formats_take_the_general_path_with_the_same_bits(
        tmp_path, rng, ref, lib, fmt):
    # Fortran's D exponent is read inside the general decoder's exact
    # window alone (strtod knows no D): such tokens keep to it here
    span = 6 if fmt == "D" else 30
    v = rng.normal(size=(200, 7)) * 10.0 ** rng.integers(-span, span,
                                                         size=(200, 7))
    fmts = ["%.6e", "%.8g", "%.4f", "%.20g", "%16.7E", "%.17E", "%.3e"]

    def one(x, j):
        if fmt == "%d":
            return "%d" % int(np.clip(x, -1e15, 1e15))
        if fmt == "D":
            return ("%.9E" % x).replace("E", "D")
        f = fmts[j] if fmt == "mixed" else fmt
        return f % x

    text = "".join(" ".join(one(x, j) for j, x in enumerate(row)) + "\n"
                   for row in v)
    _, nfixed = check(write(tmp_path, text), text, 7)
    assert (nfixed > 0) == (fmt == "mixed")


@pytest.mark.parametrize("case", ["tabs", "crlf", "comments", "no_newline",
                                  "page_multiple", "page_multiple_general",
                                  "comments_only"])
def test_layout_edge_cases_match(tmp_path, rng, ref, lib, case):
    v = rng.normal(size=(50, 6))
    rows = ["".join("%16.7E" % x for x in row) for row in v]
    if case == "tabs":
        text = "".join("\t".join(r.split()) + "\t\n" for r in rows)
    elif case == "crlf":
        text = "".join(r + "\r\n" for r in rows)
    elif case == "comments":
        text = ("# weight like p1 p2\n\n" + "\n# mid\n   \n".join(rows)
                + "\n\n")
    elif case == "no_newline":
        text = "\n".join(rows)
    elif case.startswith("page_multiple"):
        # the last token ends on a page boundary with no newline after it
        last = "-1.2345678E+01" if case == "page_multiple" else "-12.5e0"
        body = "\n".join(rows[:-1]) + "\n" + rows[-1][:-16] + "  " + last
        pad = (-(len(body) + 2)) % PAGE
        text = "#" + "x" * pad + "\n" + body
        assert len(text) % PAGE == 0
    else:
        text = "# nothing\n\n# here\n"
    p = write(tmp_path, text)
    if case == "comments_only":
        got = chainload.load_table(str(p))
        assert got.shape == ref.load_table(str(p)).shape == (0, 0)
        return
    got, nfixed = check(p, text, 6)
    assert nfixed == got.size - (case == "page_multiple_general")


@pytest.mark.parametrize("case", ["ragged", "unparsable", "overlong",
                                  "empty", "bad_first_line",
                                  "d_exponent_outside_window"])
def test_what_the_parser_refuses_gives_none(tmp_path, ref, lib, case):
    text = {"ragged": " 1.0000000E+00 2.0000000E+00\n 3.0000000E+00\n",
            "unparsable": "1.0 2.0\n3.0 abc\n",
            "d_exponent_outside_window": "1.0 2.0\n3.0 1.5D-40\n",
            "overlong": "1.0 1." + "0" * 200 + "5e0\n2.0 3.0\n",
            "empty": "",
            "bad_first_line": "x 1.0\n2.0 3.0\n"}[case]
    p = write(tmp_path, text)
    assert chainload.parse_table(str(p)) is None
    assert chainload.load_table(str(p)) is None
    assert ref.load_table(str(p)) is None


def test_the_fixed_count_is_every_field_or_none(tmp_path, rng, lib):
    v = rng.normal(size=(300, 9))
    p = write(tmp_path, "".join(
        "".join("%16.7E" % x for x in row) + "\n" for row in v), "e.txt")
    got, nfixed, _ = chainload.parse_table(str(p))
    assert nfixed == got.size == v.size
    q = write(tmp_path, "".join(
        " ".join("%.6f" % x for x in row) + "\n" for row in v), "f.txt")
    got, nfixed, _ = chainload.parse_table(str(q))
    assert nfixed == 0 and got.size == v.size


def test_parse_chain_file_counts_under_a_collector(tmp_path, rng,
                                                   monkeypatch):
    monkeypatch.setattr(reader, "_PARSE_CACHE_DIR", None)
    v = rng.normal(size=(40, 5))
    p = write(tmp_path, "".join(
        "".join("%16.7E" % x for x in row) + "\n" for row in v)
        + "1.5 2.5 3.5 4.5 5.5\n")
    timings = {}
    with collect(timings, []):
        got = reader.parse_chain_file(str(p))
    assert got.shape == (41, 5)
    assert timings == {"parse_files": 1, "parse_slices": 1,
                       "parse_fields": 205, "parse_fields_fixed": 200}
    # a read from the parse cache converts nothing and counts nothing
    reader.set_parse_cache(str(tmp_path / "cache"))
    reader.parse_chain_file(str(p))
    timings = {}
    with collect(timings, []):
        np.testing.assert_array_equal(reader.parse_chain_file(str(p)), got)
    assert timings == {}


@pytest.mark.parametrize("batched", [True, False])
def test_the_grid_driver_hands_the_prefetch_threads_counts_to_the_pass(
        tmp_path, batched, monkeypatch):
    monkeypatch.setattr(reader, "_PARSE_CACHE_DIR", None)
    # slices of 8 KiB: each file of ~40 rows of 70 fields takes several
    monkeypatch.setattr(chainload, "SLICE_BYTES", 8192)
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(range(8)),
                        raising=False)
    perfbench = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "perfbench")
    sys.path.insert(0, perfbench)
    try:
        import json

        from gen_grid import write_grid
        with open(os.path.join(perfbench, "configs",
                               "planck-r2-grid-1ds.json")) as fh:
            cfg = json.load(fh)
    finally:
        sys.path.remove(perfbench)
    cfg.update(models=["base", "base_w"], rows=[120, 160])
    root = str(tmp_path / "grid")
    shapes = write_grid(root, 2147483677, cfg)
    timings = {}
    with collect(timings, []):
        rc = planck.main(["--rootdir", root, "-o", str(tmp_path / "out"),
                          "-nd", "1", "-v", "0", "--device", "cpu",
                          "--batch-cells" if batched else "--no-batch-cells"])
    assert rc == 0
    fields = sum(rows for _, _, rows in shapes) * cfg["columns"]
    assert timings["parse_fields"] == timings["parse_fields_fixed"] == fields
    # two models of four files; the two prefetch threads' parses in flight
    # take 3 slices each of the 7 CPUs left, one alone up to 7
    assert timings["parse_files"] == 8
    assert 8 * 3 <= timings["parse_slices"] <= 8 * 7


def edge(text, slices, j):
    """Where slice j of ``slices`` starts, as the native parser cuts: just
    past the first '\n' at or after byte len(text) * j // slices."""
    data = text.encode()
    at = data.find(b"\n", len(data) * j // slices)
    return len(data) if at < 0 else at + 1


def sliced_text(rng, case, slices):
    """A layout case, shaped so that a comment line or a CRLF falls on an
    edge of the ``slices`` slices."""
    v = rng.normal(size=(60, 6))
    rows = ["".join("%16.7E" % x for x in row) for row in v]
    if case == "tabs":
        return "".join("\t".join(r.split()) + "\t\n" for r in rows)
    if case == "comments":
        return ("# weight like p1 p2\n\n" + "\n# mid\n   \n".join(rows)
                + "\n\n")
    if case == "blank_lines":
        return "\n\n" + "\n\n\n".join(rows) + "\n   \n"
    if case == "no_newline":
        return "\n".join(rows)
    if case == "fewer_lines":
        return "\n".join(rows[:3]) + "\n"
    if case == "comment_at_edge":
        # each line that starts a slice made a comment of its own length
        text = "".join(r + "\n" for r in rows)
        for j in range(1, slices):
            at = edge(text, slices, j)
            n = text.find("\n", at) - at
            if n > 0:
                text = text[:at] + "#" + "x" * (n - 1) + text[at + n:]
        return text
    assert case == "crlf_at_edge"
    # a header whose length puts the first edge's offset on a '\r'
    body = "".join(r + "\r\n" for r in rows)
    for pad in range(4 * len(rows[0])):
        text = "#" + "x" * pad + "\r\n" + body
        if slices == 1 or text[len(text) // slices] == "\r":
            return text
    raise AssertionError("no header puts an edge on a CRLF")


@pytest.mark.parametrize("slices", [1, 2, 3, 8])
@pytest.mark.parametrize("case", ["tabs", "comments", "blank_lines",
                                  "no_newline", "fewer_lines",
                                  "comment_at_edge", "crlf_at_edge"])
def test_row_slices_give_the_one_slice_table_bit_for_bit(tmp_path, rng, ref,
                                                         lib, case, slices):
    text = sliced_text(rng, case, slices)
    p = str(write(tmp_path, text))
    one, one_fixed, _ = chainload._parse(p, 1)
    got, nfixed, used = chainload._parse(p, slices)
    assert used == slices
    assert got.shape == one.shape == (len(tokens(text)) // 6, 6)
    np.testing.assert_array_equal(got.view(np.int64), one.view(np.int64))
    np.testing.assert_array_equal(got.view(np.int64),
                                  ref.load_table(p).view(np.int64))
    want = np.array([as_float(t) for t in tokens(text)]).reshape(-1, 6)
    np.testing.assert_array_equal(got.view(np.int64), want.view(np.int64))
    assert nfixed == one_fixed == n_fixed(text)


@pytest.mark.parametrize("slices", [1, 2, 3, 8])
@pytest.mark.parametrize("case", ["ragged", "unparsable", "overlong"])
def test_a_bad_row_in_the_last_slice_refuses_the_file(tmp_path, rng, lib,
                                                      case, slices):
    v = rng.normal(size=(40, 3))
    good = "".join("".join("%16.7E" % x for x in row) + "\n" for row in v)
    bad = {"ragged": " 1.0000000E+00 2.0000000E+00\n",
           "unparsable": "1.0 2.0 abc\n",
           "overlong": "1.0 2.0 1." + "0" * 200 + "5e0\n"}[case]
    p = str(write(tmp_path, good + bad))
    assert edge(good + bad, slices, slices - 1) <= len(good)
    assert chainload._parse(p, slices) is None
    assert chainload._parse(p, 1) is None
    got, _, _ = chainload._parse(str(write(tmp_path, good, "g.txt")), slices)
    assert got.shape == (40, 3)


def test_the_slice_count_follows_size_cpus_and_parses_in_flight(monkeypatch):
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(range(8)),
                        raising=False)
    mb2 = chainload.SLICE_BYTES
    assert chainload._slices(0, 1) == chainload._slices(mb2, 1) == 1
    assert chainload._slices(mb2 + 1, 1) == 2
    # seven CPUs besides the caller's: shared by the parses in flight
    assert chainload._slices(20 * mb2, 1) == 7
    assert chainload._slices(20 * mb2, 2) == 3
    assert chainload._slices(20 * mb2, 7) == 1
    assert chainload._slices(20 * mb2, 9) == 1
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: {0},
                        raising=False)
    assert chainload._slices(20 * mb2, 1) == 1


def test_parse_chain_file_counts_the_slices_it_used(tmp_path, rng, lib,
                                                    monkeypatch):
    monkeypatch.setattr(reader, "_PARSE_CACHE_DIR", None)
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(range(8)),
                        raising=False)
    # a slice a 8 KiB of its ~44 KiB, within seven CPUs
    monkeypatch.setattr(chainload, "SLICE_BYTES", 8192)
    v = rng.normal(size=(300, 9))
    text = "".join("".join("%16.7E" % x for x in row) + "\n" for row in v)
    p = str(write(tmp_path, text))
    timings = {}
    with collect(timings, []):
        got = reader.parse_chain_file(p)
    assert (timings["parse_files"], timings["parse_slices"]) == (
        1, -(-len(text) // 8192))
    np.testing.assert_array_equal(got.view(np.int64),
                                  chainload._parse(p, 1)[0].view(np.int64))


def test_parses_in_flight_on_many_threads_keep_their_tables_and_count(
        tmp_path, rng, lib, monkeypatch):
    import threading
    monkeypatch.setattr(chainload, "SLICE_BYTES", 4096)
    v = rng.normal(size=(200, 7))
    p = str(write(tmp_path, "".join(
        "".join("%16.7E" % x for x in row) + "\n" for row in v)))
    want = chainload._parse(p, 1)[0].view(np.int64)
    bad = []

    def worker():
        for _ in range(20):
            got = chainload.parse_table(p)
            if got is None or not np.array_equal(got[0].view(np.int64),
                                                 want):
                bad.append(got)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker)
                   for _ in range(4 * (os.cpu_count() or 1))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert bad == []
    # every parse that came in went out: no count lost
    assert chainload._in_flight == 0
