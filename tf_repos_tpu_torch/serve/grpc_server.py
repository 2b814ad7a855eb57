"""gRPC PredictionService endpoint — the reference's serving transport
(counterpart of the JAX package's serve/grpc_server.py, on grpcio).

The reference's C++ clients call `tensorflow.serving.PredictionService/
Predict` over gRPC (deep_fm_serving_client.cpp:35-69). This registers
that exact method on a grpcio server with RAW bytes (de)serializers —
the messages are decoded/encoded by serve/predict_proto.py's hand-rolled
codec, so no TF/TF-Serving proto stubs are needed and ANY stock
TF-Serving gRPC client can point here unchanged.

Shares the MicroBatcher with the HTTP server (serve/server.py): both
transports coalesce into the same scored device batches.
"""

from __future__ import annotations

from concurrent import futures
from typing import Optional

import grpc

from tf_repos_tpu_torch.serve.predict_proto import (
    decode_predict_request,
    encode_predict_response,
    instances_from_inputs,
)

SERVICE = "tensorflow.serving.PredictionService"


def make_grpc_server(
    scorer,
    batcher,
    host: str = "127.0.0.1",
    port: int = 8500,
    workers: int = 64,
):
    """-> (grpc.Server, bound_port). Caller owns start()/stop().
    ``workers`` bounds the RPCs in flight (each parks in
    batcher.submit); admission control is the batcher's queue cap
    (OverloadedError), not the RPC pool's."""

    def predict(request_bytes: bytes, context) -> bytes:
        # context.abort raises a private grpcio exception — it must not
        # fall into the generic handler below, so aborts are decided
        # first and the work is wrapped separately
        inputs, name, _signature = decode_predict_request(request_bytes)
        model_name = scorer.signature["model"]
        if name and name != model_name:
            context.abort(
                grpc.StatusCode.NOT_FOUND,
                f"model {name!r} not found (serving {model_name!r})",
            )
        from tf_repos_tpu_torch.serve.server import OverloadedError

        try:
            names = list(scorer.signature["inputs"].keys())
            instances = instances_from_inputs(inputs, names)
            out = batcher.submit(instances)
            return encode_predict_response(
                out, model_name, version=int(scorer.version)
            )
        except OverloadedError as e:
            # fast-fail shed (bounded micro-batcher backlog) — the
            # TF-Serving overload status
            context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, str(e))
        except Exception as e:  # surface as INVALID_ARGUMENT, like TF-Serving
            context.abort(
                grpc.StatusCode.INVALID_ARGUMENT, f"{type(e).__name__}: {e}"
            )

    handler = grpc.method_handlers_generic_handler(
        SERVICE,
        {
            "Predict": grpc.unary_unary_rpc_method_handler(
                predict,
                request_deserializer=None,  # raw bytes in
                response_serializer=None,  # raw bytes out
            )
        },
    )
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=workers))
    server.add_generic_rpc_handlers((handler,))
    bound = server.add_insecure_port(f"{host}:{port}")
    return server, bound


class GrpcPredictClient:
    """Persistent-channel PredictionService client — the form a real
    client (including the reference's C++ ServingClient, which holds one
    stub for its whole run, deep_fm_serving_client.cpp:35-40) uses: a
    channel per request (grpc_predict below) pays TCP + HTTP/2 channel
    setup on every call."""

    def __init__(self, host: str, port: int, model_name: str,
                 signature_name: str = "serving_default"):
        self.model_name = model_name
        self.signature_name = signature_name
        self._ch = grpc.insecure_channel(f"{host}:{port}")
        self._call = self._ch.unary_unary(f"/{SERVICE}/Predict")

    def predict(self, inputs, timeout: float = 30.0):
        from tf_repos_tpu_torch.serve.predict_proto import (
            decode_predict_response,
            encode_predict_request,
        )

        resp = self._call(
            encode_predict_request(
                inputs, self.model_name, self.signature_name
            ),
            timeout=timeout,
        )
        return decode_predict_response(resp)

    def close(self):
        self._ch.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def grpc_predict(
    host: str,
    port: int,
    inputs,
    model_name: str,
    signature_name: str = "serving_default",
    timeout: float = 30.0,
):
    """One-shot raw-bytes gRPC call (tests / CLI probes) — opens and
    tears down a channel PER CALL; use GrpcPredictClient for anything
    latency- or throughput-sensitive."""
    with GrpcPredictClient(host, port, model_name, signature_name) as c:
        return c.predict(inputs, timeout=timeout)
