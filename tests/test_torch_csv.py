"""The port's Criteo CSV input (tf_repos_tpu_torch/data/csv.py and the
CSV writer of data/synthetic.py) against the JAX package's: the same
bytes from the same seed, the same parse of edge lines, and the same
batches, bit for bit, shuffled and not, with the padded last batch, and
from the packed cache (built, then hit)."""

import os
import shutil

import numpy as np
import pytest

from tf_repos_tpu.data import csv as JC
from tf_repos_tpu.data import synthetic as JS
from tf_repos_tpu_torch.data import csv as TC
from tf_repos_tpu_torch.data import synthetic as TS


@pytest.mark.parametrize("cat_buckets,seed", [(100, 0), (10_000, 7)])
def test_write_synthetic_csv_is_byte_equal(tmp_path, cat_buckets, seed):
    TS.write_synthetic_csv(str(tmp_path / "t.csv"), 300, cat_buckets=cat_buckets, seed=seed)
    JS.write_synthetic_csv(str(tmp_path / "j.csv"), 300, cat_buckets=cat_buckets, seed=seed)
    data = (tmp_path / "t.csv").read_bytes()
    assert data == (tmp_path / "j.csv").read_bytes()
    assert data.count(b"\n") == 300


def test_synthetic_cli_writes_csv(tmp_path):
    TS.main(["--out_dir", str(tmp_path / "t"), "--format", "csv", "--train", "40", "--valid",
             "10", "--test", "5", "--seed", "3"])
    JS.main(["--out_dir", str(tmp_path / "j"), "--format", "csv", "--train", "40", "--valid",
             "10", "--test", "5", "--seed", "3"])
    for split in ("tr", "va", "te"):
        assert (tmp_path / "t" / f"{split}.csv").read_bytes() == \
            (tmp_path / "j" / f"{split}.csv").read_bytes()


EDGE_LINES = [
    b"1,0.5,1,2,3,4,5,6,7,8,9,10,11,12.25," + b",".join(str(i).encode() for i in range(26)),
    b"0,,,,,,,,,,,,,," + b"," * 25,            # every column empty
    b"1,0.1,0.2",                              # short: the rest default
    b"  0,3.0,,7,,,,,,,,,,,5.9,-3,99999,1e3  \n",  # blanks, int(float()), negatives
    b"1," + b",".join([b"1"] * 45),            # long: extra columns ignored
]


def test_parse_csv_lines_matches_jax():
    got, want = TC.parse_csv_lines(EDGE_LINES), JC.parse_csv_lines(EDGE_LINES)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["cat"][3, :4].tolist() == [5, -3, 99999, 1000]


def _files(tmp_path, n_files=3, rows=(70, 45, 33)):
    paths = []
    for i in range(n_files):
        p = str(tmp_path / f"tr{i}.csv")
        JS.write_synthetic_csv(p, rows[i], cat_buckets=1000, seed=10 + i)
        paths.append(p)
    return paths


def _equal_streams(ta, ja):
    tb, jb = list(ta), list(ja)
    assert len(tb) == len(jb) and tb
    for i, (x, y) in enumerate(zip(tb, jb)):
        assert x.keys() == y.keys()
        for k in y:
            assert x[k].dtype == y[k].dtype and x[k].shape == y[k].shape, (i, k)
            np.testing.assert_array_equal(x[k], y[k], err_msg=f"batch {i} {k}")
    return tb


@pytest.mark.parametrize("shuffle", [False, True])
def test_csv_batches_match_jax(tmp_path, shuffle):
    """148 rows a pass at B=32 over two passes: the epochs run on in one
    stream, whose last batch is padded (mask 0 on the pad rows)."""
    files = _files(tmp_path)
    kw = dict(batch_size=32, num_epochs=2, perform_shuffle=shuffle, shuffle_buffer=40, seed=5)
    batches = _equal_streams(TC.CsvDataset(files, **kw), JC.CsvDataset(files, **kw))
    assert len(batches) == 10  # 296 rows: 9 full batches and one of 8 live rows
    assert batches[-1]["mask"].sum() == 8 and batches[-1]["label"][8:].sum() == 0


@pytest.mark.parametrize("shuffle", [False, True])
def test_csv_packed_cache_matches_jax(tmp_path, shuffle):
    """Each package builds the csv40 cache on its first pass (equal
    batches); then each reads the JAX package's cache (equal batches
    again, no sidecar rewritten)."""
    files = _files(tmp_path)
    kw = dict(batch_size=32, num_epochs=2, perform_shuffle=shuffle, shuffle_buffer=40, seed=5,
              packed_cache=True)
    cache_dir = tmp_path / ".packed_cache"
    built = list(TC.CsvDataset(files, **kw))
    shutil.rmtree(cache_dir)
    _equal_streams(built, JC.CsvDataset(files, **kw))
    metas = sorted(p for p in os.listdir(cache_dir) if p.endswith(".meta.json"))
    assert metas == [f"tr{i}.csv.csv40.meta.json" for i in range(3)]
    stamps = {p: os.stat(cache_dir / p).st_mtime_ns for p in os.listdir(cache_dir)}
    batches = _equal_streams(TC.CsvDataset(files, **kw), JC.CsvDataset(files, **kw))
    assert {p: os.stat(cache_dir / p).st_mtime_ns for p in os.listdir(cache_dir)} == stamps
    assert sum(float(b["mask"].sum()) for b in batches) == 2 * 148
