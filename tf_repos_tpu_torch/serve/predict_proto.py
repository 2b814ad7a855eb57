"""TF-Serving PredictionService wire-format codec — dependency-free (the
port's own copy of the JAX package's serve/predict_proto.py, the same
codec byte for byte).

The reference serves over gRPC `tensorflow.serving.PredictionService/
Predict` (deep_fm_serving_client.cpp:69): PredictRequest carries raw
dense TensorProtos (`feat_ids` int64 [1,39], `feat_vals` float [1,39],
:42-62) and the response is decoded TensorProto -> values (:78-97).
For transport parity this module hand-encodes the
ACTUAL protos, like serve/example_proto.py does for tf.Example, so the
gRPC endpoint (serve/grpc_server.py) and the grpc-web route
(serve/server.py) are wire-compatible with stock TF-Serving clients:

  PredictRequest  { 1: ModelSpec, 2: map<string, TensorProto> inputs }
  PredictResponse { 2: ModelSpec, 1: map<string, TensorProto> outputs }
  ModelSpec       { 1: name, 2: Int64Value version, 3: signature_name }
  TensorProto     { 1: DataType dtype, 2: TensorShapeProto shape,
                    4: bytes tensor_content,
                    5: packed float float_val, 7: packed int32 int_val,
                    8: repeated bytes string_val, 10: packed int64 int64_val }
  TensorShapeProto{ 2: repeated Dim { 1: int64 size } }

Encoder emits the packed value-list form TF produces; decoder accepts
packed, unpacked, and raw little-endian `tensor_content`.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from tf_repos_tpu_torch.serve.example_proto import (
    _fields,
    _len_field,
    _read_varint,
    _varint,
)

DT_FLOAT, DT_INT32, DT_STRING, DT_INT64 = 1, 3, 7, 9
_DTYPES = {DT_FLOAT: np.float32, DT_INT32: np.int32, DT_INT64: np.int64}


def _field(num: int, wire: int) -> bytes:
    return _varint((num << 3) | wire)


# ------------------------------------------------------------------ encoding
def encode_tensor(arr: np.ndarray) -> bytes:
    arr = np.asarray(arr)
    shape = b"".join(
        _len_field(2, _field(1, 0) + _varint(int(d))) for d in arr.shape
    )
    out = _len_field(2, shape)
    flat = arr.reshape(-1)
    if arr.dtype == np.object_ or arr.dtype.kind in ("S", "U"):
        out = _field(1, 0) + _varint(DT_STRING) + out
        for v in flat:
            b = v.encode() if isinstance(v, str) else bytes(v)
            out += _len_field(8, b)
        return out
    if arr.dtype.kind == "f":
        packed = np.asarray(flat, np.float32).tobytes()
        return _field(1, 0) + _varint(DT_FLOAT) + out + _len_field(5, packed)
    if arr.dtype == np.int64:
        packed = b"".join(_varint(int(v)) for v in flat)
        return _field(1, 0) + _varint(DT_INT64) + out + _len_field(10, packed)
    packed = b"".join(_varint(int(v)) for v in np.asarray(flat, np.int64))
    return _field(1, 0) + _varint(DT_INT32) + out + _len_field(7, packed)


def _encode_model_spec(
    name: str, signature: str = "", version: Optional[int] = None
) -> bytes:
    out = _len_field(1, name.encode())
    if version is not None:
        out += _len_field(2, _field(1, 0) + _varint(int(version)))
    if signature:
        out += _len_field(3, signature.encode())
    return out


def encode_predict_request(
    inputs: Dict[str, np.ndarray],
    model_name: str,
    signature_name: str = "serving_default",
) -> bytes:
    out = _len_field(1, _encode_model_spec(model_name, signature_name))
    for k, v in inputs.items():
        entry = _len_field(1, k.encode()) + _len_field(2, encode_tensor(v))
        out += _len_field(2, entry)
    return out


def encode_predict_response(
    outputs: Dict[str, np.ndarray],
    model_name: str,
    version: Optional[int] = None,
) -> bytes:
    out = b"".join(
        _len_field(1, _len_field(1, k.encode()) + _len_field(2, encode_tensor(v)))
        for k, v in outputs.items()
    )
    return out + _len_field(2, _encode_model_spec(model_name, version=version))


# ------------------------------------------------------------------ decoding
def _decode_shape(buf: bytes) -> List[int]:
    dims: List[int] = []
    for num, payload in _fields(buf):
        if num == 2 and isinstance(payload, bytes):
            size = 0
            for dnum, dval in _fields(payload):
                if dnum == 1 and isinstance(dval, int):
                    size = dval
            dims.append(size)
    return dims


def _unpack_varints(payload) -> List[int]:
    if isinstance(payload, int):
        return [payload]
    vals: List[int] = []
    i = 0
    while i < len(payload):
        v, i = _read_varint(payload, i)
        vals.append(v)
    return vals


def decode_tensor(buf: bytes) -> np.ndarray:
    dtype = DT_FLOAT
    shape: List[int] = []
    content = b""
    floats: List[float] = []
    ints: List[int] = []
    strings: List[bytes] = []
    for num, payload in _fields(buf):
        if num == 1 and isinstance(payload, int):
            dtype = payload
        elif num == 2 and isinstance(payload, bytes):
            shape = _decode_shape(payload)
        elif num == 4 and isinstance(payload, bytes):
            content = payload
        elif num == 5:
            if isinstance(payload, bytes) and len(payload) != 4:
                floats.extend(
                    struct.unpack(f"<{len(payload) // 4}f", payload)
                )
            elif isinstance(payload, bytes):
                floats.append(struct.unpack("<f", payload)[0])
        elif num in (7, 10):
            ints.extend(_unpack_varints(payload))
        elif num == 8 and isinstance(payload, bytes):
            strings.append(payload)
    if strings:
        arr = np.asarray(strings, object)
    elif content:
        arr = np.frombuffer(content, _DTYPES.get(dtype, np.float32))
    elif dtype == DT_FLOAT:
        arr = np.asarray(floats, np.float32)
    else:
        signed = [v - (1 << 64) if v >= (1 << 63) else v for v in ints]
        arr = np.asarray(signed, _DTYPES.get(dtype, np.int64))
    if shape:
        arr = arr.reshape(shape)
    return arr


def decode_predict_request(
    data: bytes,
) -> Tuple[Dict[str, np.ndarray], str, str]:
    """-> (inputs, model_name, signature_name)."""
    inputs: Dict[str, np.ndarray] = {}
    name, signature = "", ""
    for num, payload in _fields(data):
        if not isinstance(payload, bytes):
            continue
        if num == 1:  # ModelSpec
            for mnum, mval in _fields(payload):
                if mnum == 1 and isinstance(mval, bytes):
                    name = mval.decode()
                elif mnum == 3 and isinstance(mval, bytes):
                    signature = mval.decode()
        elif num == 2:  # inputs map entry
            key, tensor = None, None
            for enum_, eval_ in _fields(payload):
                if enum_ == 1 and isinstance(eval_, bytes):
                    key = eval_.decode()
                elif enum_ == 2 and isinstance(eval_, bytes):
                    tensor = decode_tensor(eval_)
            if key is not None and tensor is not None:
                inputs[key] = tensor
    return inputs, name, signature


def decode_predict_response(
    data: bytes,
) -> Tuple[Dict[str, np.ndarray], str, Optional[int]]:
    """-> (outputs, model_name, version)."""
    outputs: Dict[str, np.ndarray] = {}
    name: str = ""
    version: Optional[int] = None
    for num, payload in _fields(data):
        if not isinstance(payload, bytes):
            continue
        if num == 1:  # outputs map entry
            key, tensor = None, None
            for enum_, eval_ in _fields(payload):
                if enum_ == 1 and isinstance(eval_, bytes):
                    key = eval_.decode()
                elif enum_ == 2 and isinstance(eval_, bytes):
                    tensor = decode_tensor(eval_)
            if key is not None and tensor is not None:
                outputs[key] = tensor
        elif num == 2:  # ModelSpec
            for mnum, mval in _fields(payload):
                if mnum == 1 and isinstance(mval, bytes):
                    name = mval.decode()
                elif mnum == 2 and isinstance(mval, bytes):
                    for vnum, vval in _fields(mval):
                        if vnum == 1 and isinstance(vval, int):
                            version = vval
    return outputs, name, version


# ----------------------------------------------------- request -> instances
def instances_from_inputs(
    inputs: Dict[str, np.ndarray], input_names
) -> List[Dict[str, np.ndarray]]:
    """Batched input tensors [N, ...] -> per-example instance dicts for
    the scorer. A single DT_STRING tensor (any name) carries serialized
    tf.Examples — the reference wide_n_deep client's parsing signature
    (wide_n_deep_serving_client.cpp:52-62)."""
    from tf_repos_tpu_torch.serve.example_proto import (
        decode_example,
        instance_from_example,
    )

    if len(inputs) == 1:
        (arr,) = inputs.values()
        if arr.dtype == np.object_:
            return [
                instance_from_example(decode_example(bytes(ex)), input_names)
                for ex in arr.reshape(-1)
            ]
    n = None
    for k, v in inputs.items():
        if v.ndim == 0:
            raise ValueError(f"input {k!r} must be batched [N, ...]")
        if n is None:
            n = v.shape[0]
        elif v.shape[0] != n:
            raise ValueError("inputs disagree on batch size")
    return [{k: v[i] for k, v in inputs.items()} for i in range(n or 0)]
