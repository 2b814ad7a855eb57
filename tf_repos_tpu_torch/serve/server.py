"""HTTP + gRPC prediction server with request micro-batching (counterpart
of the JAX package's serve/server.py: the same transports, routes,
status codes and JSON shapes). Three wire protocols over ONE
micro-batcher, so any reference client can switch with a URL change:

  POST /v1/models/<name>:predict   {"instances": [ {input: value, ...} ]}
      (also the columnar {"inputs": {input: [...]}} form and
      {"b64": <serialized tf.Example>} instances)
      -> {"predictions": [...], "model_version": "<ts>"}   (REST)
  POST /tensorflow.serving.PredictionService/Predict
      application/grpc-web+proto framed PredictRequest     (grpc-web)
  gRPC :<grpc_port> tensorflow.serving.PredictionService/Predict
      (serve/grpc_server.py, imported only when grpc_port >= 0)
  GET  /v1/models/<name>           model status + version
  GET  /stats                      batchify / device / score ms, batch
                                   occupancy, shed count
  GET  /healthz                    liveness

Concurrent requests are coalesced by the micro-batcher (up to
``max_batch`` instances or ``max_wait_ms``, scored once, replies
scattered), so the device sees static-bucket batches; its worker thread
runs the scorer, whose K1 launches go to that thread's current CUDA
stream and whose outputs are copied to the host (the sync) before they
are sliced to the requests. A bounded backlog (``max_queued``) sheds
load with HTTP 429 / gRPC RESOURCE_EXHAUSTED. Version hot reload is
polled every ``reload_secs``. The HTTP/1.1 side needs only the standard
library and the hand-rolled codecs.
"""

from __future__ import annotations

import argparse
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

import numpy as np

from tf_repos_tpu_torch.serve.scorer import Scorer


class _Pending:
    __slots__ = ("instances", "event", "result", "error")

    def __init__(self, instances):
        self.instances = instances
        self.event = threading.Event()
        self.result: Optional[Dict[str, np.ndarray]] = None
        self.error: Optional[str] = None


class OverloadedError(RuntimeError):
    """Queue admission rejected the request (bounded micro-batcher
    backlog). Transports map this to a FAST retryable signal — HTTP 429
    / gRPC RESOURCE_EXHAUSTED — the way TF Serving sheds load, instead
    of letting p99 grow without bound past the saturation knee."""


class MicroBatcher:
    """Coalesces concurrent predict requests into one scored batch."""

    def __init__(self, scorer: Scorer, max_batch: int = 512, max_wait_ms: float = 2.0,
                 max_queued: int = 8192):
        self.scorer = scorer
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        # admission control: at most max_queued EXAMPLES waiting (~16
        # full batches at the default 512); 0 disables the cap
        self.max_queued = max_queued
        self.shed = 0  # rejected requests, surfaced via GET /stats
        self.scored = 0  # micro-batches scored since start (each one scorer.score)
        self._queued = 0
        self._qlock = threading.Lock()
        self.q: "queue.Queue[_Pending]" = queue.Queue()
        self.timings: list = []  # rolling window for GET /stats
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()

    def submit(self, instances: List[Dict[str, Any]], timeout: float = 30.0):
        n = len(instances)
        with self._qlock:
            if self.max_queued and self._queued + n > self.max_queued:
                self.shed += 1
                raise OverloadedError(
                    f"micro-batcher backlog full ({self._queued} queued, "
                    f"cap {self.max_queued}); retry later"
                )
            self._queued += n
        p = _Pending(instances)
        self.q.put(p)
        if not p.event.wait(timeout):
            raise TimeoutError("scoring timed out")
        if p.error:
            raise RuntimeError(p.error)
        return p.result

    def stop(self):
        self._stop.set()
        self.thread.join(timeout=2)

    def _worker(self):
        while not self._stop.is_set():
            try:
                first = self.q.get(timeout=0.1)
            except queue.Empty:
                continue
            group = [first]
            total = len(first.instances)
            deadline = time.monotonic() + self.max_wait
            while total < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self.q.get(timeout=remaining)
                except queue.Empty:
                    break
                group.append(nxt)
                total += len(nxt.instances)
            with self._qlock:
                self._queued -= total
            flat = [inst for p in group for inst in p.instances]
            try:
                t0 = time.perf_counter()
                out = self.scorer.score(flat)
                rec = dict(self.scorer.last_timing)
                rec["score_ms"] = (time.perf_counter() - t0) * 1e3
                rec["n"] = len(flat)
                self.timings.append(rec)
                self.scored += 1
                if len(self.timings) > 512:
                    del self.timings[:256]
                off = 0
                for p in group:
                    n = len(p.instances)
                    p.result = {k: v[off : off + n] for k, v in out.items()}
                    off += n
            except Exception as e:  # propagate per-request
                for p in group:
                    p.error = f"{type(e).__name__}: {e}"
            finally:
                for p in group:
                    p.event.set()


class PredictionServer:
    def __init__(
        self,
        servable_dir: str,
        host: str = "127.0.0.1",
        port: int = 8501,
        max_batch: int = 512,
        max_wait_ms: float = 2.0,
        reload_secs: float = 30.0,
        grpc_port: int = -1,  # >=0: also serve gRPC (0 = ephemeral port)
        max_queued: int = 8192,
        device: str = "cuda",
    ):
        self.scorer = Scorer(servable_dir, device=device)
        self.batcher = MicroBatcher(
            self.scorer, max_batch, max_wait_ms, max_queued=max_queued
        )
        self.model_name = self.scorer.signature["model"]
        self.grpc_server = None
        self.grpc_port = None
        if grpc_port >= 0:
            from tf_repos_tpu_torch.serve.grpc_server import make_grpc_server

            self.grpc_server, self.grpc_port = make_grpc_server(
                self.scorer, self.batcher, host, grpc_port
            )
        self.reload_secs = reload_secs
        self._stop = threading.Event()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _reply(self, code: int, payload: Dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._reply(200, {"status": "ok"})
                elif self.path == "/stats":
                    # server-side latency decomposition (batchify vs
                    # device leg) over the recent scoring window
                    import numpy as _np

                    t = outer.batcher.timings[-256:]
                    if not t:
                        self._reply(200, {"count": 0})
                        return
                    agg = {"count": len(t)}
                    # "n" = micro-batch occupancy (instances per scored
                    # batch): under concurrent load it shows how well the
                    # batcher coalesces
                    for k in ("batchify_ms", "device_ms", "score_ms", "n"):
                        v = _np.asarray([r[k] for r in t if k in r])
                        if len(v):
                            agg[k] = {
                                "p50": round(float(_np.median(v)), 3),
                                "p99": round(float(_np.percentile(v, 99)), 3),
                                "mean": round(float(_np.mean(v)), 3),
                            }
                    agg["shed"] = outer.batcher.shed
                    agg["queued"] = outer.batcher._queued
                    self._reply(200, agg)
                elif self.path.startswith("/v1/models/"):
                    self._reply(
                        200,
                        {
                            "model_version_status": [
                                {
                                    "version": outer.scorer.version,
                                    "state": "AVAILABLE",
                                    "model": outer.model_name,
                                }
                            ]
                        },
                    )
                else:
                    self._reply(404, {"error": "not found"})

            def _reply_grpc_web(self, msg: bytes, status: int = 0, detail: str = ""):
                # grpc-web framing: DATA frame (flag 0x00) then TRAILERS
                # frame (flag 0x80) carrying grpc-status/-message
                trailer = f"grpc-status: {status}\r\n"
                if detail:
                    trailer += f"grpc-message: {detail}\r\n"
                tb = trailer.encode()
                body = b""
                if msg:
                    body += b"\x00" + len(msg).to_bytes(4, "big") + msg
                body += b"\x80" + len(tb).to_bytes(4, "big") + tb
                self.send_response(200)
                self.send_header("Content-Type", "application/grpc-web+proto")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _do_grpc_web(self):
                from tf_repos_tpu_torch.serve.predict_proto import (
                    decode_predict_request,
                    encode_predict_response,
                    instances_from_inputs,
                )

                try:
                    length = int(self.headers.get("Content-Length", "0"))
                    body = self.rfile.read(length)
                    if len(body) < 5 or body[0] & 0x80:
                        raise ValueError("missing grpc-web DATA frame")
                    n = int.from_bytes(body[1:5], "big")
                    inputs, name, _sig = decode_predict_request(body[5 : 5 + n])
                    if name and name != outer.model_name:
                        self._reply_grpc_web(
                            b"", status=5,  # NOT_FOUND
                            detail=f"model {name!r} not found",
                        )
                        return
                    names = list(outer.scorer.signature["inputs"].keys())
                    out = outer.batcher.submit(
                        instances_from_inputs(inputs, names)
                    )
                    msg = encode_predict_response(
                        out, outer.model_name, version=int(outer.scorer.version)
                    )
                    self._reply_grpc_web(msg)
                except OverloadedError as e:
                    self._reply_grpc_web(
                        b"", status=8,  # RESOURCE_EXHAUSTED
                        detail=str(e),
                    )
                    return
                except Exception as e:
                    self._reply_grpc_web(
                        b"", status=3,  # INVALID_ARGUMENT
                        detail=f"{type(e).__name__}: {e}",
                    )

            def do_POST(self):
                if self.path == "/tensorflow.serving.PredictionService/Predict":
                    self._do_grpc_web()
                    return
                if not self.path.startswith("/v1/models/") or ":predict" not in self.path:
                    self._reply(404, {"error": "not found"})
                    return
                name = self.path[len("/v1/models/"):].split(":", 1)[0]
                if name != outer.model_name:
                    self._reply(
                        404, {"error": f"model {name!r} not found (serving {outer.model_name!r})"}
                    )
                    return
                try:
                    length = int(self.headers.get("Content-Length", "0"))
                    req = json.loads(self.rfile.read(length))
                    instances = req.get("instances")
                    if instances is None and "inputs" in req:
                        # columnar form: {"inputs": {k: [[...], ...]}}
                        cols = req["inputs"]
                        n = len(next(iter(cols.values())))
                        instances = [
                            {k: v[i] for k, v in cols.items()} for i in range(n)
                        ]
                    if instances and isinstance(instances[0], dict) and "b64" in instances[0]:
                        # parsing signature: each instance is a serialized
                        # tf.Example (TF-Serving REST binary convention;
                        # wide_n_deep_serving_client.cpp:45-62 parity)
                        import base64

                        from tf_repos_tpu_torch.serve.example_proto import (
                            decode_example,
                            instance_from_example,
                        )

                        names = list(outer.scorer.signature["inputs"].keys())
                        instances = [
                            instance_from_example(
                                decode_example(base64.b64decode(inst["b64"])), names
                            )
                            for inst in instances
                        ]
                    out = outer.batcher.submit(instances)
                    preds = _predictions_payload(out)
                    self._reply(
                        200,
                        {"predictions": preds, "model_version": outer.scorer.version},
                    )
                except OverloadedError as e:
                    # fast-fail shed: clients back off and retry (the
                    # TF-Serving overload contract)
                    self._reply(429, {"error": str(e)})
                except Exception as e:
                    self._reply(400, {"error": f"{type(e).__name__}: {e}"})

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._serve_thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._reload_thread = threading.Thread(target=self._reloader, daemon=True)

    def _reloader(self):
        while not self._stop.wait(self.reload_secs):
            try:
                if self.scorer.maybe_reload():
                    print(f"INFO: reloaded servable version {self.scorer.version}")
            except Exception as e:
                print(f"WARN: reload failed: {e}")

    def start(self):
        self._serve_thread.start()
        if self.grpc_server is not None:
            self.grpc_server.start()
        if self.reload_secs > 0:
            self._reload_thread.start()

    def stop(self):
        self._stop.set()
        self.httpd.shutdown()
        self.httpd.server_close()  # release the listening socket too
        if self.grpc_server is not None:
            self.grpc_server.stop(grace=1).wait(2)
        self.batcher.stop()

    def serve_forever(self):
        self.start()
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            self.stop()


def _predictions_payload(out: Dict[str, np.ndarray]) -> List:
    keys = list(out.keys())
    n = len(out[keys[0]])
    if len(keys) == 1:
        return [float(x) for x in out[keys[0]]]
    return [{k: float(out[k][i]) for k in keys} for i in range(n)]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--servable_model_dir", required=True)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8501)
    p.add_argument("--max_batch", type=int, default=512)
    p.add_argument("--max_wait_ms", type=float, default=2.0)
    p.add_argument("--reload_secs", type=float, default=30.0)
    p.add_argument(
        "--grpc_port", type=int, default=8500,
        help="gRPC PredictionService port (TF-Serving's default); -1 disables",
    )
    p.add_argument(
        "--max_queued", type=int, default=8192,
        help="admission cap: max examples waiting in the micro-batcher "
        "(fast 429/RESOURCE_EXHAUSTED beyond it); 0 = unbounded",
    )
    p.add_argument(
        "--device", default="cuda",
        help="torch device: cuda (default; raises without a GPU) or cpu",
    )
    a = p.parse_args(argv)
    srv = PredictionServer(
        a.servable_model_dir, a.host, a.port, a.max_batch, a.max_wait_ms,
        a.reload_secs, grpc_port=a.grpc_port, max_queued=a.max_queued,
        device=a.device,
    )
    grpc_note = f" grpc :{srv.grpc_port}" if srv.grpc_port is not None else ""
    print(f"serving {srv.model_name} v{srv.scorer.version} on :{srv.port}{grpc_note}")
    srv.serve_forever()


if __name__ == "__main__":
    main()
