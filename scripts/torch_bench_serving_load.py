"""Serving under concurrent load on the PyTorch port (the port of
scripts/bench_serving_load.py).

scripts/torch_bench_serving.py measures one client's latency against
batch size; this drives the micro-batcher toward saturation: C
closed-loop clients (each sends one request, waits, sends the next) per
protocol

  rest     POST /v1/models/M:predict, JSON instances
  grpc     the native tensorflow.serving PredictionService/Predict
           (needs grpcio; one persistent channel a client thread)
  example  POST with {"b64": <serialized tf.Example>} instances
           (the TF-Serving REST binary convention the C++ WDL client uses)

and reports, per offered concurrency: throughput (req/s), client p50/p99
latency, and the server's micro-batch occupancy (mean instances per
scored batch, from /stats). The knee is where occupancy stops growing
and p99 lifts off. Beside each level it prints the K1 launches (the
serving gather, one launch a scored micro-batch on the card; none on
the CPU, which runs the plain version) and the micro-batches the server
scored in it.

The reference's production curve is latency = 0.5256*ads + 15.449 ms
(deep_ctr/README.md:74-81), a fit of its CPU TF Serving under offered
ad-batch load; compare its shape with the `rest` rows (per-request
batch --per_req).

    python scripts/torch_bench_serving_load.py [--duration 5] [--device cpu]
    python scripts/torch_bench_serving_load.py --small --device=cpu   # a CPU run

--device defaults to cuda and raises without a GPU. --small is the
small model (V=10,000, K=4, towers 8/4); it does not imply the CPU.
Asking for grpc without grpcio raises an ImportError before anything
runs.
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_bench_serving as bench_serving  # noqa: E402
from tf_repos_tpu_torch.ops import sparse_rows as SR  # noqa: E402
from tf_repos_tpu_torch.utils.platform import card_label, resolve_device  # noqa: E402

PROTOCOLS = ("rest", "grpc", "example")


def _ensure_servable(tmp: str, vocab: int, small: bool, device: str = "cuda") -> str:
    """torch_bench_serving's servable at this vocab, small or not, with
    this script's dropout flag (the JAX script's)."""
    return bench_serving._ensure_servable(tmp, device, vocab, small, dropout="1.0,1.0")


def require_grpcio() -> None:
    try:
        import grpc  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "--protocols=grpc needs grpcio (the grpc package), which is not installed; "
            "leave grpc out of --protocols"
        ) from e


def request_bodies(vocab: int, per_req: int):
    """The three protocols' payloads for one request of per_req instances
    (ids from a seeded generator): the REST body, the tf.Example body and
    the gRPC inputs."""
    from tf_repos_tpu_torch.serve.example_proto import encode_example

    rng = np.random.default_rng(0)
    ids = rng.integers(1, vocab, (per_req, 39))
    vals = np.ones((per_req, 39), np.float32)
    insts = [
        {"feat_ids": [int(x) for x in ids[i]], "feat_vals": [1.0] * 39}
        for i in range(per_req)
    ]
    rest_body = json.dumps({"instances": insts}).encode()
    ex_insts = [{"b64": base64.b64encode(encode_example(inst)).decode()} for inst in insts]
    ex_body = json.dumps({"instances": ex_insts}).encode()
    grpc_inputs = {"feat_ids": ids.astype(np.int64), "feat_vals": vals}
    return rest_body, ex_body, grpc_inputs


def _client_loop(send, stop_at, lats, errs, sheds):
    while time.perf_counter() < stop_at:
        t0 = time.perf_counter()
        try:
            send()
            lats.append((time.perf_counter() - t0) * 1e3)
        except Exception as e:
            msg = str(e)
            if "429" in msg or "RESOURCE_EXHAUSTED" in msg or "backlog" in msg:
                sheds.append(1)  # shed: the client should back off and retry
            else:
                errs.append(1)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--servable_model_dir", default="")
    p.add_argument("--duration", type=float, default=5.0)
    p.add_argument("--per_req", type=int, default=4,
                   help="instances per request (the reference's 'ads per query' axis)")
    p.add_argument("--concurrency", default="1,2,4,8,16,32,64")
    p.add_argument("--protocols", default="rest,grpc,example")
    p.add_argument("--small", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default; raises without a GPU) or cpu")
    a = p.parse_args(argv)
    protos = [s for s in a.protocols.split(",") if s]
    unknown = sorted(set(protos) - set(PROTOCOLS))
    if unknown:
        raise ValueError(f"unknown protocols {unknown} (of {', '.join(PROTOCOLS)})")
    if "grpc" in protos:
        require_grpcio()
    levels = [int(c) for c in a.concurrency.split(",")]
    dev = resolve_device(a.device)
    card = card_label(dev)

    from tf_repos_tpu_torch.serve.server import PredictionServer

    vocab = 10_000 if a.small else 117_581
    servable = a.servable_model_dir or _ensure_servable(
        tempfile.mkdtemp(prefix="bench_srv_load_"), vocab, a.small, a.device)
    print(f"servable: {servable}")
    srv = PredictionServer(servable, port=0, reload_secs=0,
                           grpc_port=0 if "grpc" in protos else -1, device=a.device)
    srv.start()
    model = srv.model_name
    url = f"http://127.0.0.1:{srv.port}/v1/models/{model}:predict"
    rest_body, ex_body, grpc_inputs = request_bodies(vocab, a.per_req)

    def send_rest(body=rest_body):
        req = urllib.request.Request(
            url, data=body, headers={"Content-Type": "application/json"}
        )
        resp = json.loads(urllib.request.urlopen(req, timeout=60).read())
        assert len(resp["predictions"]) == a.per_req

    def send_example():
        send_rest(ex_body)

    # one persistent channel a client thread (a fresh channel a request
    # would measure the TCP + HTTP/2 handshake, not the server)
    _tls = threading.local()
    clients = []

    def send_grpc():
        c = getattr(_tls, "grpc", None)
        if c is None:
            from tf_repos_tpu_torch.serve.grpc_server import GrpcPredictClient

            c = _tls.grpc = GrpcPredictClient("127.0.0.1", srv.grpc_port, model)
            clients.append(c)
        out, _, _ = c.predict(grpc_inputs)
        assert out["prob"].shape[0] == a.per_req

    senders = {"rest": send_rest, "grpc": send_grpc, "example": send_example}
    results, counts = {}, {}
    try:
        for proto in protos:
            send = senders[proto]
            send()  # warm the bucket caches outside timing
            for c in levels:
                lats, errs, sheds = [], [], []
                stop_at = time.perf_counter() + a.duration
                threads = [
                    threading.Thread(
                        target=_client_loop, args=(send, stop_at, lats, errs, sheds)
                    )
                    for _ in range(c)
                ]
                k0, s0 = SR.expand_rows.launches, srv.batcher.scored
                t0 = time.perf_counter()
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
                wall = time.perf_counter() - t0
                launches, scored = SR.expand_rows.launches - k0, srv.batcher.scored - s0
                stats = json.loads(urllib.request.urlopen(
                    f"http://127.0.0.1:{srv.port}/stats", timeout=10
                ).read())
                lat = np.asarray(lats) if lats else np.asarray([float("nan")])
                cell = {
                    "requests": len(lats),
                    "errors": len(errs),
                    "shed": len(sheds),
                    "req_per_s": round(len(lats) / wall, 1),
                    "examples_per_s": round(len(lats) * a.per_req / wall, 1),
                    "p50_ms": round(float(np.median(lat)), 2),
                    "p99_ms": round(float(np.percentile(lat, 99)), 2),
                    "batch_occupancy_mean": stats.get("n", {}).get("mean", 1.0),
                    "device_ms_p50": stats.get("device_ms", {}).get("p50"),
                    "shed_total": stats.get("shed", 0),
                }
                name = f"{proto}_c{c}"
                results[name] = cell
                counts[name] = {"k1_launches": launches, "scored_batches": scored}
                print(f"{name} on {card}: {cell['req_per_s']} req/s, p50 {cell['p50_ms']} ms, "
                      f"p99 {cell['p99_ms']} ms, occupancy {cell['batch_occupancy_mean']}; "
                      f"K1 launches {launches} in {scored} scored micro-batches", flush=True)
                print(json.dumps({name: cell}), flush=True)
    finally:
        for c in clients:
            c.close()
        srv.stop()
    print(f"device: {card}")
    print("RESULT " + json.dumps(results), flush=True)
    return {"servable": servable, "card": card, "result": results, "counts": counts,
            "max_batch": srv.batcher.max_batch, "per_req": a.per_req}


if __name__ == "__main__":
    main()
