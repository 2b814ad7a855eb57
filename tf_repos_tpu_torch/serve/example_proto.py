"""tf.Example wire-format codec — dependency-free (the port's own copy of
the JAX package's serve/example_proto.py, the same codec byte for byte).

The reference's wide_n_deep servable exposes a PARSING signature: the
client builds a tensorflow.Example proto with features I1..I13
(float_list) and C1..C26 (int64_list), serializes it, and ships the
bytes through a DT_STRING input tensor
(wide_n_deep_serving_client.cpp:45-62, wide_n_deep.py:240-242). For
wire-format parity this module speaks the ACTUAL Example proto:

  Example   { 1: Features }
  Features  { 1: repeated MapEntry { 1: string key, 2: Feature } }
  Feature   { 1: BytesList | 2: FloatList | 3: Int64List }
  FloatList { 1: repeated float  (packed) }
  Int64List { 1: repeated int64  (packed) }

Encoder emits the packed form TF produces; decoder accepts packed and
unpacked. Transport follows the TF-Serving REST convention for binary
string tensors: {"instances": [{"b64": "<base64(Example)>"}]}.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np

FeatureValue = Union[Sequence[float], Sequence[int], Sequence[bytes]]


# ----------------------------------------------------------------- encoding
def _varint(n: int) -> bytes:
    if n < 0:
        n &= (1 << 64) - 1  # proto int64 negatives: 10-byte varint
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _len_field(num: int, payload: bytes) -> bytes:
    return _varint((num << 3) | 2) + _varint(len(payload)) + payload


def _feature(value: FeatureValue) -> bytes:
    vals = list(value)
    if vals and isinstance(vals[0], (bytes, str)):
        body = b"".join(
            _len_field(1, v.encode() if isinstance(v, str) else v) for v in vals
        )
        return _len_field(1, body)  # BytesList
    if vals and isinstance(vals[0], (float, np.floating)):
        packed = b"".join(struct.pack("<f", float(v)) for v in vals)
        return _len_field(2, _len_field(1, packed))  # FloatList, packed
    packed = b"".join(_varint(int(v)) for v in vals)
    return _len_field(3, _len_field(1, packed))  # Int64List, packed


def encode_example(features: Dict[str, FeatureValue]) -> bytes:
    entries = b"".join(
        _len_field(1, _len_field(1, k.encode()) + _len_field(2, _feature(v)))
        for k, v in features.items()
    )
    return _len_field(1, entries)


# ----------------------------------------------------------------- decoding
def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    out = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7


def _fields(buf: bytes):
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        num, wire = key >> 3, key & 7
        if wire == 2:
            ln, i = _read_varint(buf, i)
            yield num, buf[i : i + ln]
            i += ln
        elif wire == 0:
            v, i = _read_varint(buf, i)
            yield num, v
        elif wire == 5:
            yield num, buf[i : i + 4]
            i += 4
        elif wire == 1:
            yield num, buf[i : i + 8]
            i += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")


def _decode_float_list(buf: bytes) -> np.ndarray:
    vals: List[float] = []
    for num, payload in _fields(buf):
        if num != 1:
            continue
        if isinstance(payload, bytes) and len(payload) % 4 == 0 and len(payload) != 4:
            vals.extend(struct.unpack(f"<{len(payload)//4}f", payload))
        elif isinstance(payload, bytes) and len(payload) == 4:
            vals.append(struct.unpack("<f", payload)[0])
        else:  # unpacked fixed32 arrives as 4-byte chunk above
            raise ValueError("bad float list payload")
    return np.asarray(vals, np.float32)


def _decode_int64_list(buf: bytes) -> np.ndarray:
    vals: List[int] = []
    for num, payload in _fields(buf):
        if num != 1:
            continue
        if isinstance(payload, int):  # unpacked varint
            vals.append(payload)
        else:  # packed varints
            i = 0
            while i < len(payload):
                v, i = _read_varint(payload, i)
                vals.append(v)
    out = np.asarray(
        [v - (1 << 64) if v >= (1 << 63) else v for v in vals], np.int64
    )
    return out


def decode_example(data: bytes) -> Dict[str, np.ndarray]:
    """Example bytes -> {name: float32[n] | int64[n] | object[n] bytes}."""
    out: Dict[str, np.ndarray] = {}
    for num, features_buf in _fields(data):
        if num != 1 or not isinstance(features_buf, bytes):
            continue
        for fnum, entry in _fields(features_buf):
            if fnum != 1 or not isinstance(entry, bytes):
                continue
            name = None
            value: np.ndarray | None = None
            for enum_, payload in _fields(entry):
                if enum_ == 1 and isinstance(payload, bytes):
                    name = payload.decode()
                elif enum_ == 2 and isinstance(payload, bytes):
                    for knum, list_buf in _fields(payload):
                        if not isinstance(list_buf, bytes):
                            continue
                        if knum == 2:
                            value = _decode_float_list(list_buf)
                        elif knum == 3:
                            value = _decode_int64_list(list_buf)
                        elif knum == 1:
                            value = np.asarray(
                                [
                                    b
                                    for n2, b in _fields(list_buf)
                                    if n2 == 1 and isinstance(b, bytes)
                                ],
                                object,
                            )
            if name is not None and value is not None:
                out[name] = value
    return out


# --------------------------------------------------- named-feature mapping
def instance_from_example(
    features: Dict[str, np.ndarray], input_names: Sequence[str]
) -> Dict[str, np.ndarray]:
    """Map decoded Example features onto a servable's input tensors.

    The wide_n_deep convention (the reference's parsing signature):
    I1..I13 float features -> 'cont' [13]; C1..C26 int features ->
    'cat' [26]. Servables whose inputs are named directly (feat_ids,
    feat_vals, ...) take features by exact name."""
    inst: Dict[str, np.ndarray] = {}
    if "cont" in input_names and any(k.startswith("I") for k in features):
        inst["cont"] = np.concatenate(
            [np.asarray(features[f"I{i}"], np.float32) for i in range(1, 14)]
        )
    if "cat" in input_names and any(k.startswith("C") for k in features):
        inst["cat"] = np.concatenate(
            [np.asarray(features[f"C{i}"], np.int64) for i in range(1, 27)]
        ).astype(np.int32)
    for name in input_names:
        if name not in inst and name in features:
            inst[name] = features[name]
    missing = [n for n in input_names if n not in inst and n != "mask"]
    if missing:
        raise ValueError(f"example missing features for inputs {missing}")
    return inst
