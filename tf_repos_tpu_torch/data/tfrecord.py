"""TFRecord input for the Ali-CCP reader (the port's own copy of the JAX
package's data/tfrecord.py).

The reference converts its joined sample lines into TFRecord-framed
tf.Example protos (get_aliccp_tfrecord.py:38-102); a ``*.tfrecord``
input feeds ``AliccpDataset`` and gives the same fixed-shape padded
batches as the sample lines it was converted from. Dependency-free:
record framing with masked CRC32C below, tf.Example encode/decode from
serve/example_proto.py.

Per-record schema written by the reference converter:
  y, z                     float_list[1]        labels
  feat_ids                 int64_list[11]       the common fields, one
                                                value each (default: the
                                                field's 1..11 position)
  u_{cat,shop,brand,int}ids / ...vals           user multi-hot ids+vals
                                                (default id 12..15 with
                                                val 1.0)
  a_{cat,shop,int,brand}ids                     ad ids (default 16..19)

``convert_sample_file`` writes such a store from sample lines, as the
reference converter does; ``python -m tf_repos_tpu_torch.data.tfrecord
--input_dir ... --output_dir ...`` converts a directory.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from tf_repos_tpu_torch.data.ragged import (
    AD_MH_FIELD,
    AD_SCALAR_FIELDS,
    COMMON_FIELDS,
    NUM_COMMON,
    UMH_FIELDS,
)
from tf_repos_tpu_torch.serve.example_proto import decode_example, encode_example

Batch = Dict[str, np.ndarray]


# ------------------------------------------------------------------ crc32c
def _crc_table() -> List[int]:
    poly = 0x82F63B78  # Castagnoli, reflected
    tab = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        tab.append(c)
    return tab


_CRC_TABLE = _crc_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    tab = _CRC_TABLE
    for b in data:
        crc = tab[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc(data: bytes) -> int:
    """TFRecord's masked CRC32C of ``data``."""
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------------- record framing
def write_records(path: str, payloads: Sequence[bytes]) -> None:
    """TFRecord framing: uint64le(len) + crc(len) + payload + crc(payload)."""
    with open(path, "wb") as f:
        for p in payloads:
            head = struct.pack("<Q", len(p))
            f.write(head)
            f.write(struct.pack("<I", masked_crc(head)))
            f.write(p)
            f.write(struct.pack("<I", masked_crc(p)))


def iter_records(path: str, verify_crc: bool = True) -> Iterator[bytes]:
    """Yield record payloads; CRC-checked so a truncated/corrupt store
    fails loudly instead of training on garbage."""
    with open(path, "rb") as f:
        while True:
            head = f.read(8)
            if not head:
                return
            if len(head) != 8:
                raise ValueError(f"{path}: truncated record length header")
            (n,) = struct.unpack("<Q", head)
            (hcrc,) = struct.unpack("<I", f.read(4))
            payload = f.read(n)
            (pcrc,) = struct.unpack("<I", f.read(4))
            if len(payload) != n:
                raise ValueError(f"{path}: truncated record payload")
            if verify_crc and (
                masked_crc(head) != hcrc or masked_crc(payload) != pcrc
            ):
                raise ValueError(f"{path}: record CRC mismatch")
            yield payload


def is_tfrecord_file(path: str) -> bool:
    return path.endswith(".tfrecord")


# --------------------------------------------------------- Example <-> batch
def example_from_sample_line(line: bytes) -> Optional[bytes]:
    """One joined sample line -> serialized tf.Example, replicating the
    reference converter (get_aliccp_tfrecord.py:38-102): lines without
    exactly 4 comma-fields are dropped; absent fields get their default
    id (val 1.0 for user multi-hot)."""
    parts = line.strip().split(b",")
    if len(parts) != 4:
        return None
    feats: Dict[str, object] = {
        "y": [float(parts[1])],
        "z": [float(parts[2])],
    }
    by_field: Dict[str, List[bytes]] = {}
    by_field_vals: Dict[str, List[bytes]] = {}
    for tok in parts[3].split():
        fv = tok.split(b":")
        if len(fv) != 3:
            continue
        field = fv[0].decode()
        by_field.setdefault(field, []).append(fv[1])
        by_field_vals.setdefault(field, []).append(fv[2])

    feat_ids: List[int] = []
    for field, pos in COMMON_FIELDS.items():
        vals = by_field.get(field)
        feat_ids.extend(int(v) for v in vals) if vals else feat_ids.append(pos)
    feats["feat_ids"] = feat_ids

    for field, (fname, def_id) in UMH_FIELDS.items():
        if field in by_field:
            feats[fname + "ids"] = [int(v) for v in by_field[field]]
            feats[fname + "vals"] = [float(v) for v in by_field_vals[field]]
        else:
            feats[fname + "ids"] = [def_id]
            feats[fname + "vals"] = [1.0]

    ad_fields = dict(AD_SCALAR_FIELDS)
    ad_fields[AD_MH_FIELD[0]] = (AD_MH_FIELD[1], AD_MH_FIELD[2])
    for field, (fname, def_id) in ad_fields.items():
        if field in by_field:
            feats[fname + "ids"] = [int(v) for v in by_field[field]]
        else:
            feats[fname + "ids"] = [def_id]
    return encode_example(feats)


def convert_sample_file(in_path: str, out_path: Optional[str] = None) -> str:
    """Sample-line file -> reference-format .tfrecord (the migration /
    materialization tool; reference converter writes
    <basename>.tfrecord into --output_dir)."""
    out_path = out_path or in_path + ".tfrecord"
    payloads: List[bytes] = []
    with open(in_path, "rb") as f:
        for line in f:
            ex = example_from_sample_line(line)
            if ex is not None:
                payloads.append(ex)
    write_records(out_path, payloads)
    return out_path


def parse_aliccp_examples(
    payloads: Sequence[bytes], multi_hot_pad: int = 64
) -> Batch:
    """Serialized Examples -> the exact batch dict of
    ragged.parse_aliccp_lines: y/z/label, feat_ids int32[B,11], padded
    multi-hot u_*ids/u_*vals and a_intids, scalar a_cat/a_shop/a_brand
    (last value wins, matching the line parser), mask."""
    n = len(payloads)
    p = multi_hot_pad
    out: Batch = {
        "y": np.zeros((n,), np.float32),
        "z": np.zeros((n,), np.float32),
        "feat_ids": np.zeros((n, NUM_COMMON), np.int32),
        "a_catids": np.full((n,), 16, np.int32),
        "a_shopids": np.full((n,), 17, np.int32),
        "a_brandids": np.full((n,), 19, np.int32),
        "a_intids": np.zeros((n, p), np.int32),
        "mask": np.ones((n,), np.float32),
    }
    for _, (fname, _) in UMH_FIELDS.items():
        out[f"{fname}ids"] = np.zeros((n, p), np.int32)
        out[f"{fname}vals"] = np.zeros((n, p), np.float32)

    for r, payload in enumerate(payloads):
        ex = decode_example(payload)
        out["y"][r] = ex["y"][0]
        out["z"][r] = ex["z"][0]
        ids = ex["feat_ids"]
        if ids.shape[0] != NUM_COMMON:
            raise ValueError(
                f"feat_ids holds {ids.shape[0]} values, expected "
                f"{NUM_COMMON} (the reference trainer's FixedLenFeature "
                "shape, DeepCvrMTL.py:70)"
            )
        out["feat_ids"][r] = ids.astype(np.int32)
        for _, (fname, _) in UMH_FIELDS.items():
            mh_ids = ex[f"{fname}ids"][:p]
            mh_vals = ex[f"{fname}vals"][: mh_ids.shape[0]]
            out[f"{fname}ids"][r, : mh_ids.shape[0]] = mh_ids.astype(np.int32)
            out[f"{fname}vals"][r, : mh_vals.shape[0]] = mh_vals
        for _, (fname, _) in AD_SCALAR_FIELDS.items():
            vals = ex[f"{fname}ids"]
            if vals.shape[0]:
                out[f"{fname}ids"][r] = int(vals[-1])
        a_int = ex[f"{AD_MH_FIELD[1]}ids"][:p]
        out["a_intids"][r, : a_int.shape[0]] = a_int.astype(np.int32)
    out["label"] = out["y"]
    return out


def main(argv=None):  # pragma: no cover - thin CLI
    import argparse
    import glob

    ap = argparse.ArgumentParser(
        description="sample lines -> reference-format TFRecords "
        "(get_aliccp_tfrecord.py behavior)"
    )
    ap.add_argument("--input_dir", required=True)
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--pattern", default="*-*")
    a = ap.parse_args(argv)
    os.makedirs(a.output_dir, exist_ok=True)
    for path in sorted(glob.glob(os.path.join(a.input_dir, a.pattern))):
        out = os.path.join(
            a.output_dir, os.path.basename(path) + ".tfrecord"
        )
        convert_sample_file(path, out)
        print(out)


if __name__ == "__main__":  # pragma: no cover
    main()
