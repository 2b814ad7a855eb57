"""The port's TFRecord input (tf_repos_tpu_torch/data/tfrecord.py) on the
CPU: the record framing and its masked CRC32C (a corrupt record raises),
the converter's bytes against the JAX package's, a store the JAX package
wrote read by the port's AliccpDataset to the JAX package's batches
(shuffled or not, streamed or through the packed cache), records equal
to the sample lines they came from, absent fields with the reference's
defaults 12..19, the refusal of mixed inputs and of multi_hot_pad=0 on
records, and the converter's CLI. Everything is held bit-exact."""

import os

import numpy as np
import pytest

from tf_repos_tpu.data import ragged as JR
from tf_repos_tpu.data import tfrecord as JT
from tf_repos_tpu.utils.tb_events import _masked_crc
from tf_repos_tpu_torch.data import ragged as TR
from tf_repos_tpu_torch.data import tfrecord as TT
from tf_repos_tpu_torch.data.synthetic import write_synthetic_aliccp


def _same(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]), err_msg=k)


def test_masked_crc_matches_jax():
    rng = np.random.default_rng(0)
    for n in (0, 1, 7, 8, 100, 4096):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert TT.masked_crc(data) == _masked_crc(data)
    assert TT.crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value


def test_record_framing_roundtrip_and_crc(tmp_path):
    path = str(tmp_path / "x.tfrecord")
    payloads = [b"alpha", b"", b"x" * 10_000]
    TT.write_records(path, payloads)
    assert list(TT.iter_records(path)) == payloads == list(JT.iter_records(path))
    good = open(path, "rb").read()
    blob = bytearray(good)
    blob[20] ^= 0xFF  # a payload byte
    open(path, "wb").write(bytes(blob))
    with pytest.raises(ValueError, match="CRC"):
        list(TT.iter_records(path))
    open(path, "wb").write(good[:26])  # the first record (21 bytes), then 5 of a header
    with pytest.raises(ValueError, match="truncated"):
        list(TT.iter_records(path))


def test_convert_sample_file_bytes_match_jax(tmp_path):
    src = str(tmp_path / "tr.samples")
    write_synthetic_aliccp(src, 120, feature_size=500, multi_hot=3, seed=1)
    with open(src, "ab") as f:  # a malformed line (dropped) and absent fields
        f.write(b"no commas here\ns9,1,0,101:5:1.0\ns10,0,0,\n")
    a = TT.convert_sample_file(src, str(tmp_path / "port.tfrecord"))
    b = JT.convert_sample_file(src, str(tmp_path / "jax.tfrecord"))
    assert open(a, "rb").read() == open(b, "rb").read()
    assert len(list(TT.iter_records(a))) == 122
    assert TT.convert_sample_file(src) == src + ".tfrecord"
    assert TT.example_from_sample_line(b"no commas here") is None


def test_absent_fields_take_the_reference_defaults():
    ex = TT.example_from_sample_line(b"s1,1,0,101:5:1.0")
    got = TT.parse_aliccp_examples([ex], multi_hot_pad=4)
    want = JT.parse_aliccp_examples([ex], multi_hot_pad=4)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert [got[f"u_{f}ids"][0, 0] for f in ("cat", "shop", "brand", "int")] == [12, 13, 14, 15]
    assert [got[f"u_{f}vals"][0, 0] for f in ("cat", "shop", "brand", "int")] == [1.0] * 4
    assert (got["a_catids"][0], got["a_shopids"][0], got["a_intids"][0, 0], got["a_brandids"][0]) \
        == (16, 17, 18, 19)
    np.testing.assert_array_equal(got["feat_ids"][0], [5, *range(2, 12)])
    lines = TR.parse_aliccp_lines([b"s1,1,0,101:5:1.0"], 4)
    for k in lines:
        np.testing.assert_array_equal(got[k], lines[k], err_msg=k)


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("packed", [False, True])
def test_jax_written_store_reads_to_jax_batches(tmp_path, shuffle, packed):
    src = str(tmp_path / "tr.samples")
    write_synthetic_aliccp(src, 300, feature_size=500, multi_hot=3, seed=1)
    (tmp_path / "rec").mkdir()
    rec = JT.convert_sample_file(src, str(tmp_path / "rec" / "tr.tfrecord"))
    kw = dict(batch_size=32, num_epochs=2, perform_shuffle=shuffle, shuffle_buffer=64, seed=5,
              multi_hot_pad=8)
    want = list(JR.AliccpDataset([rec], packed_cache=packed, **kw))
    got = list(TR.AliccpDataset([rec], packed_cache=packed, **kw))  # packed: JAX's cache
    lines = list(TR.AliccpDataset([src], packed_cache=packed, **kw))
    assert len(got) == 19
    _same(got, want)
    _same(got, lines)  # the records give the sample lines' batches


def test_mixed_inputs_and_auto_pad_rejected(tmp_path):
    src = str(tmp_path / "tr.samples")
    write_synthetic_aliccp(src, 10, feature_size=100, seed=0)
    rec = TT.convert_sample_file(src)
    for mod in (TR, JR):
        with pytest.raises(ValueError, match="mixed"):
            mod.AliccpDataset([src, rec], batch_size=4)
        with pytest.raises(ValueError, match="multi_hot_pad=0"):
            mod.AliccpDataset([rec], batch_size=4, multi_hot_pad=0)


def test_converter_cli(tmp_path):
    (tmp_path / "in").mkdir()
    for part in ("tr-0", "va-0"):
        write_synthetic_aliccp(str(tmp_path / "in" / part), 20, feature_size=100, seed=1)
    TT.main(["--input_dir", str(tmp_path / "in"), "--output_dir", str(tmp_path / "out")])
    assert sorted(os.listdir(tmp_path / "out")) == ["tr-0.tfrecord", "va-0.tfrecord"]
    assert len(list(TT.iter_records(str(tmp_path / "out" / "tr-0.tfrecord")))) == 20
