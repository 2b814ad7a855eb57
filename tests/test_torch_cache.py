"""The port's packed cache (tf_repos_tpu_torch/data/cache.py, --packed_cache)
on the CPU: build, hit and invalidation for the libsvm and Ali-CCP
readers; a cache written by the JAX package reads in the port and the
other way round, to identical batches; and shuffled multi-epoch runs
(the build pass, then memmapped chunks) equal to the JAX package's on
the same seed. Everything is held bit-exact."""

import json
import os
import shutil

import numpy as np
import pytest

from tf_repos_tpu.data import cache as JC
from tf_repos_tpu.data import libsvm as JL
from tf_repos_tpu.data import ragged as JR
from tf_repos_tpu_torch.data import cache as TC
from tf_repos_tpu_torch.data import libsvm as TL
from tf_repos_tpu_torch.data import ragged as TR
from tf_repos_tpu_torch.data.synthetic import write_synthetic_aliccp, write_synthetic_libsvm


def _same(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]), err_msg=k)


def _twin(path, tmp_path, name):
    """A copy of ``path`` (same bytes and mtime) in a directory of its own."""
    d = tmp_path / name
    d.mkdir()
    dst = str(d / os.path.basename(path))
    shutil.copy2(path, dst)
    return dst


def _libsvm(path, **kw):
    return list(TL.LibsvmDataset([path], field_size=39, batch_size=10, **kw))


def _aliccp(path, **kw):
    return list(TR.AliccpDataset([path], batch_size=10, multi_hot_pad=8, **kw))


def test_libsvm_cache_builds_hits_and_invalidates(tmp_path):
    path = str(tmp_path / "tr.libsvm")
    write_synthetic_libsvm(path, 25, feature_size=500)
    plain = _libsvm(path)
    built = _libsvm(path, packed_cache=True)
    meta = tmp_path / ".packed_cache" / "tr.libsvm.f39.meta.json"
    assert json.loads(meta.read_text())["rows"] == 25
    assert json.loads(meta.read_text())["version"] == TC.FORMAT_VERSION == JC.FORMAT_VERSION == 2
    hit = _libsvm(path, packed_cache=True)
    _same(built, plain)
    _same(hit, plain)
    assert isinstance(TC.PackedCache.open(path, "f39").arrays["ids"], np.memmap)
    assert not [f for f in os.listdir(tmp_path / ".packed_cache") if ".tmp." in f]
    # a new source (other size and mtime) invalidates the cache
    write_synthetic_libsvm(path, 12, feature_size=500, seed=7)
    os.utime(path, ns=(1, 1))
    assert TC.PackedCache.open(path, "f39") is None
    after = _libsvm(path, packed_cache=True)
    assert int(sum(b["mask"].sum() for b in after)) == 12
    assert json.loads(meta.read_text())["rows"] == 12
    # the same bytes with only a new mtime invalidate it too
    os.utime(path, ns=(2, 2))
    assert TC.PackedCache.open(path, "f39") is None


def test_aliccp_cache_builds_hits_and_invalidates(tmp_path):
    path = str(tmp_path / "tr.txt")
    write_synthetic_aliccp(path, 37, 5000)
    plain = _aliccp(path)
    built = _aliccp(path, packed_cache=True)
    assert (tmp_path / ".packed_cache" / "tr.txt.p8.meta.json").exists()
    hit = _aliccp(path, packed_cache=True)
    assert len(plain) == 4 and plain[-1]["mask"].sum() == 7
    _same(built, plain)
    _same(hit, plain)
    # a cache of another pad is another tag: both live side by side
    list(TR.AliccpDataset([path], batch_size=10, multi_hot_pad=16, packed_cache=True))
    assert TC.PackedCache.open(path, "p16") is not None and TC.PackedCache.open(path, "p8") is not None
    os.utime(path, ns=(3, 3))
    assert TC.PackedCache.open(path, "p8") is None
    _same(_aliccp(path, packed_cache=True), plain)


@pytest.mark.parametrize("fmt", ["libsvm", "aliccp"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cache_written_by_one_package_reads_in_the_other(tmp_path, fmt, writer):
    if fmt == "libsvm":
        path = str(tmp_path / "tr.libsvm")
        write_synthetic_libsvm(path, 43, feature_size=500, seed=2)
        tag = "f39"
        port = lambda **kw: _libsvm(path, **kw)  # noqa: E731
        jax = lambda **kw: list(JL.LibsvmDataset([path], field_size=39, batch_size=10, **kw))  # noqa: E731
    else:
        path = str(tmp_path / "tr.txt")
        write_synthetic_aliccp(path, 43, 5000, seed=2)
        tag = "p8"
        port = lambda **kw: _aliccp(path, **kw)  # noqa: E731
        jax = lambda **kw: list(JR.AliccpDataset([path], batch_size=10, multi_hot_pad=8, **kw))  # noqa: E731
    build, read = (jax, port) if writer == "jax" else (port, jax)
    want = build(packed_cache=True)
    cache = (JC if writer == "jax" else TC).PackedCache.open(path, tag)
    assert cache is not None and cache.rows == 43
    files = sorted(os.listdir(tmp_path / ".packed_cache"))
    mtimes = [os.stat(tmp_path / ".packed_cache" / f).st_mtime_ns for f in files]
    got = read(packed_cache=True)
    _same(got, want)
    # the reader hit the cache: nothing was rewritten
    assert sorted(os.listdir(tmp_path / ".packed_cache")) == files
    assert [os.stat(tmp_path / ".packed_cache" / f).st_mtime_ns for f in files] == mtimes
    other = (TC if writer == "jax" else JC).PackedCache.open(path, tag)
    assert other is not None and sorted(other.arrays) == sorted(cache.arrays)
    for k in cache.arrays:
        np.testing.assert_array_equal(other.arrays[k], cache.arrays[k])


@pytest.mark.parametrize("fmt", ["libsvm", "aliccp"])
def test_shuffled_cache_epochs_match_jax(tmp_path, fmt):
    """Three shuffled epochs on --packed_cache: the first parses and writes
    the cache, the later ones read it; the port's batches equal the JAX
    package's on the same seed, each package with its own cache (a twin
    of the file), then both over one cache the JAX package wrote."""
    if fmt == "libsvm":
        src = str(tmp_path / "tr.libsvm")
        write_synthetic_libsvm(src, 130, feature_size=500, seed=3)
        kw = dict(field_size=39, batch_size=16, num_epochs=3, perform_shuffle=True, seed=9,
                  packed_cache=True)
        port = lambda p: list(TL.LibsvmDataset([p], **kw))  # noqa: E731
        jax = lambda p: list(JL.LibsvmDataset([p], **kw))  # noqa: E731
    else:
        src = str(tmp_path / "tr.txt")
        write_synthetic_aliccp(src, 130, 5000, seed=3)
        kw = dict(batch_size=16, num_epochs=3, perform_shuffle=True, seed=9, multi_hot_pad=8,
                  packed_cache=True)
        port = lambda p: list(TR.AliccpDataset([p], **kw))  # noqa: E731
        jax = lambda p: list(JR.AliccpDataset([p], **kw))  # noqa: E731
    a, b = _twin(src, tmp_path, "port"), _twin(src, tmp_path, "jax")
    got, want = port(a), jax(b)
    assert len(got) == 25
    _same(got, want)
    _same(port(b), jax(b))  # both on the cache the JAX package wrote
