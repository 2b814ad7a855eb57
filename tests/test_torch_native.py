"""The port's native host input (tf_repos_tpu_torch/data/native.py over its
own copies of the C++ sources) against the JAX package's native module
and against the port's plain Python versions, on the CPU: the libsvm and
Ali-CCP parsers, the line splitter and the duplicate combine, with the
JAX package's edge cases (malformed tokens, huge exponents, scientific
notation, extra colons); and the build (into tf_repos_tpu_torch/_build/,
named by the sources' hash, rebuilt when a source changes, one library
from concurrent builders, a failed compile raises).

Tolerances: against the JAX package's native module, bit for bit (the
same C++); against the plain Python versions, ids, labels and every
Ali-CCP array bit for bit, libsvm values to 1e-6 relative (the C++
float parse accumulates digits in double and may round the last bit
differently from Python's float()), combined weights to k_max * 2**-24
relative, k_max the most occurrences of one id in a row (the native
combine adds in f32 in slot order, rounding up to k_max - 1 times; the
plain one sums in f64 and rounds once)."""

import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

from tf_repos_tpu.data import native as JN
from tf_repos_tpu_torch.data import native as TN
from tf_repos_tpu_torch.data import ragged as TR
from tf_repos_tpu_torch.data import sparse_batch as TSB
from tf_repos_tpu_torch.data.libsvm import parse_libsvm_lines
from tf_repos_tpu_torch.data.synthetic import write_synthetic_aliccp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

LIBSVM_LINES = [
    b"1 1:0.5 2:1 3:0.25",
    b"0 4:1 5:2e-2 6:-1.5",
    b"1 7:1 8:1",  # ragged: fewer than field_size
    b"0 9:1 10:1 11:1 12:1",  # surplus: truncated
    b"1 13 14:",  # no colon -> val 1.0; empty val -> 1.0
]


def _equal(got, want, what=""):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype, what
        np.testing.assert_array_equal(g, w, err_msg=what)


def test_parse_libsvm_lines_matches_jax_and_plain():
    got = TN.parse_libsvm_lines(LIBSVM_LINES, 3)
    _equal(got, JN.parse_libsvm_lines(LIBSVM_LINES, 3))
    ids, vals, labels = parse_libsvm_lines(LIBSVM_LINES, 3)
    np.testing.assert_array_equal(got[0], ids)
    np.testing.assert_allclose(got[1], vals, rtol=1e-6)
    np.testing.assert_array_equal(got[2], labels)
    _equal(TN.parse_libsvm_lines([], 3), JN.parse_libsvm_lines([], 3))


@pytest.mark.parametrize("max_lines", [None, 2])
def test_parse_libsvm_blob_and_split_lines_match_jax(max_lines):
    blob = b"1 1:0.5 2:1\n\n\r\n0 3:1 4:0.25\n1 5:1 6:2\n0 7:3"  # blank lines, no final newline
    got = TN.parse_libsvm_blob(blob, 2, max_lines)
    _equal(got, JN.parse_libsvm_blob(blob, 2, max_lines))
    n = 2 if max_lines else 4
    assert got[0].shape == (n, 2)
    np.testing.assert_array_equal(got[0][:2], [[1, 2], [3, 4]])
    offsets = TN.split_lines(blob, max_lines)
    assert len(offsets) == n + 1 and offsets[0] == 0 and offsets[1] == blob.index(b"0 3:1")
    # every line the splitter finds parses as the plain parser reads it
    lines = [blob[offsets[i]:offsets[i + 1]].strip() for i in range(n)]
    np.testing.assert_array_equal(parse_libsvm_lines(lines, 2)[0], got[0])


def test_malformed_tokens_resync():
    lines = [
        b"1 xx 2:0.5 3:1",  # leading junk token skipped, rest parsed
        b"0 4:1x 5:2",  # trailing junk in a token: the cursor resyncs
        b"1 6:1e-2 7:2E3",  # scientific notation
    ]
    got = TN.parse_libsvm_lines(lines, 2)
    _equal(got, JN.parse_libsvm_lines(lines, 2))
    np.testing.assert_array_equal(got[0], [[2, 3], [4, 5], [6, 7]])
    np.testing.assert_allclose(got[1], [[0.5, 1.0], [1.0, 2.0], [0.01, 2000.0]], rtol=1e-6)


def test_huge_exponent_saturates_without_stalling():
    lines = [b"1 1:1e2000000000 2:0.5", b"0 3:1e-2000000000 4:2.0", b"1 5:2e30 6:1.0"]
    t0 = time.time()
    ids, vals, labels = TN.parse_libsvm_lines(lines, 2)
    assert time.time() - t0 < 2.0  # an unclamped exponent loop would spin for minutes
    _equal((ids, vals, labels), JN.parse_libsvm_lines(lines, 2))
    np.testing.assert_array_equal(ids, [[1, 2], [3, 4], [5, 6]])
    assert np.isinf(vals[0, 0]) and vals[0, 1] == 0.5
    assert vals[1, 0] == 0.0 and vals[1, 1] == 2.0
    np.testing.assert_allclose(vals[2], [2e30, 1.0], rtol=1e-6)


EDGE_ALICCP = [
    b"s_a,1,0,205:77:1.0",  # one common field: the rest take their defaults
    b"bad line without commas",  # malformed: mask 0
    b"s_b,0,0," + b" ".join(b"109_14:%d:1.0" % i for i in range(100, 120)),  # truncated
    b"s_c,1,1,206:5:1.0 210:9:1.0 150_14:44:0.5 999:1:1.0",  # unknown field ignored
    b"s0,1,0,205:7:1e-2 109_14:44:2E1 206:5:1.0:junk 207:9:0.5",  # e-notation, 4-part token
    b"s1,0,1,101:3:1.0,extra",  # five parts: mask 0
]


@pytest.mark.parametrize("pad", [4, 16])
def test_parse_aliccp_matches_jax_and_plain(tmp_path, pad):
    p = tmp_path / "s.txt"
    write_synthetic_aliccp(str(p), 300, feature_size=5000, multi_hot=6, seed=3)
    lines = open(p, "rb").read().splitlines() + EDGE_ALICCP
    got = TN.parse_aliccp_lines(lines, pad)
    jax_native = JN.parse_aliccp_lines(lines, pad)
    plain = TR.parse_aliccp_lines(lines, pad)
    assert set(got) == set(jax_native) == set(plain)
    for k in plain:
        np.testing.assert_array_equal(got[k], jax_native[k], err_msg=f"{k} pad {pad}")
        np.testing.assert_array_equal(got[k], plain[k], err_msg=f"{k} pad {pad}")
        assert got[k].dtype == plain[k].dtype, k
    # the blob form: the same rows
    blob = b"\n".join(lines) + b"\n"
    from_blob = TN.parse_aliccp_blob(blob, pad)
    want_blob = JN.parse_aliccp_blob(blob, pad)
    for k in plain:
        np.testing.assert_array_equal(from_blob[k], got[k], err_msg=k)
        np.testing.assert_array_equal(want_blob[k], got[k], err_msg=k)
    edge = {k: v[300:] for k, v in got.items()}
    assert list(edge["mask"]) == [1, 0, 1, 1, 1, 0]
    assert edge["feat_ids"][4, 9] == 7 and edge["a_catids"][4] == 16 and edge["a_shopids"][4] == 9


@pytest.mark.parametrize("shape,p_live,hi", [((8, 32), 0.7, 9), ((16, 64), 0.9, 5), ((5, 7), 0.0, 3),
                                             ((64, 512), 0.3, 4000)])
def test_combine_dups_matches_jax_in_order(shape, p_live, hi):
    rng = np.random.default_rng(shape[1])
    a = np.where(rng.random(shape) < p_live, rng.integers(1, hi, size=shape), 0).astype(np.int32)
    a[0, :3] = -1  # negative ids are dead too
    v = rng.random(shape).astype(np.float32)
    for vals in (None, v):
        got = TSB.combine_dups(a, vals)
        _equal(got, JN.combine_dups(a, vals))
        plain = TSB.combine_dups(a, vals, use_native=False)
        np.testing.assert_array_equal(plain[0], got[0])
        np.testing.assert_array_equal(plain[2], got[2])
        k_max = max([np.unique(r[r > 0], return_counts=True)[1].max(initial=1) for r in a])
        np.testing.assert_allclose(plain[1], got[1], rtol=k_max * 2 ** -24)
        # first-seen order inside each row, rows ascending
        rows = np.split(got[0], np.cumsum(got[2])[:-1])
        for r, ids in enumerate(rows):
            live = a[r][a[r] > 0]
            _, first = np.unique(live, return_index=True)
            np.testing.assert_array_equal(ids, live[np.sort(first)])


def test_packer_streams_equal_on_native_and_plain_combine():
    """The COO packer with combine on the native and the plain combine:
    the same idx, dest and counts, in order; w within one f32 rounding a
    summand."""
    from tf_repos_tpu_torch.data.synthetic import PUBLISHED_MH_AVG_LENS, synthetic_aliccp_batch

    lens = {k: v / 10 for k, v in PUBLISHED_MH_AVG_LENS.items()}
    raw = synthetic_aliccp_batch(np.random.default_rng(3), 32, 300, multi_hot_pad=64,
                                 avg_lens=lens, zipf_a=1.2)
    groups = (("u_cat", True), ("u_shop", True), ("u_brand", True), ("u_int", True), ("a_int", False))
    nat = TSB.MhCooPacker(groups, floor=64, combine=True)(dict(raw))
    plain = TSB.MhCooPacker(groups, floor=64, combine=True, use_native=False)(dict(raw))
    assert nat.keys() == plain.keys()
    for k in nat:
        if k != TSB.MHC_W:
            np.testing.assert_array_equal(nat[k], plain[k], err_msg=k)
    k_max = max(np.unique(r[r > 0], return_counts=True)[1].max(initial=1)
                for f, _ in groups for r in raw[f + "ids"])
    np.testing.assert_allclose(nat[TSB.MHC_W], plain[TSB.MHC_W], rtol=k_max * 2 ** -24)


def test_combine_dups_rejects_mismatched_vals():
    with pytest.raises(ValueError, match="vals"):
        TN.combine_dups(np.ones((2, 3), np.int32), np.ones((2, 4), np.float32))


# ------------------------------------------------------------------ build
def _copy_sources(dst):
    os.makedirs(dst, exist_ok=True)
    for name in TN.SOURCES:
        shutil.copy(os.path.join(TN.SRC_DIR, name), dst)
    return str(dst)


def test_library_lands_in_build_dir():
    path = TN.library_path()
    assert os.path.dirname(path) == os.path.join(REPO, "tf_repos_tpu_torch", "_build")
    TN.load()
    assert os.path.isfile(path)


def test_rebuilt_when_a_source_changes(tmp_path):
    src = _copy_sources(tmp_path / "src")
    build = str(tmp_path / "build")
    first = TN.build(src, build)
    assert first == TN.library_path(src, build) and os.path.isfile(first)
    assert TN.build(src, build) == first  # built once
    with open(os.path.join(src, "coo_combine.cpp"), "a") as f:
        f.write("\n// edited\n")
    second = TN.build(src, build)
    assert second != first and os.path.isfile(second)
    assert not [f for f in os.listdir(build) if f.endswith(".tmp")]


def test_failed_build_raises_with_the_compiler_output(tmp_path):
    src = _copy_sources(tmp_path / "src")
    with open(os.path.join(src, "aliccp_parser.cpp"), "a") as f:
        f.write("\nthis is not C++;\n")
    with pytest.raises(RuntimeError, match=r"g\+\+ failed(.|\n)*aliccp_parser\.cpp"):
        TN.build(src, str(tmp_path / "build"))
    assert not os.path.exists(TN.library_path(src, str(tmp_path / "build")))


def test_concurrent_builders_share_one_library(tmp_path):
    """Six processes start the same build at once (the test workers of one
    checkout do): the flock serialises them, each gets the same complete
    library, and no temporary file is left."""
    src = _copy_sources(tmp_path / "src")
    build = str(tmp_path / "build")
    code = (
        "import sys, ctypes\n"
        "from tf_repos_tpu_torch.data import native\n"
        "p = native.build(sys.argv[1], sys.argv[2])\n"
        "ctypes.CDLL(p).combine_dups\n"
        "print(p)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", code, src, build], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    assert {o.strip() for o, _ in outs} == {TN.library_path(src, build)}
    assert [f for f in os.listdir(build) if f.endswith(".so")] == [
        os.path.basename(TN.library_path(src, build))]
