"""The port's serving benchmarks (scripts/torch_bench_serving.py and
scripts/torch_bench_serving_load.py) on the CPU, against the JAX
package's scripts (scripts/bench_serving.py, scripts/bench_serving_load.py):
the servable each builds (the same data files byte for byte, the same
harness flags), the load bench's cells and RESULT keys at --small on the
CPU, the load bench's request bodies answered alike by the port's
server and the JAX package's on one servable exported by JAX (2e-5
relative: f32 towers, the same function), and the refusal of grpc
without grpcio. The scripts import nothing of JAX
(tests/test_torch_imports.py)."""

import importlib.util
import json
import os
import shutil
import sys
import urllib.request

import jax
import numpy as np
import pytest

from tf_repos_tpu.config import Config as JaxConfig
from tf_repos_tpu.models import create_model as jax_create_model
from tf_repos_tpu.serve.export import export_servable as jax_export
from tf_repos_tpu_torch.serve.grpc_server import GrpcPredictClient
from tf_repos_tpu_torch.serve.server import PredictionServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_VOCAB = 10_000


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


bench = _script("torch_bench_serving")
load = _script("torch_bench_serving_load")
jax_bench = _script("bench_serving")
jax_load = _script("bench_serving_load")

# the harness flags both scripts' servables are built with
FLAGS = ("model", "feature_size", "field_size", "embedding_size", "deep_layers", "dropout",
         "batch_size", "num_epochs", "log_steps", "dt_dir", "eval_throttle_secs")


@pytest.mark.parametrize("case", ["serving", "load_small", "load_full"])
def test_ensure_servable_writes_the_jax_scripts_files(tmp_path, monkeypatch, case):
    """_ensure_servable of each port script writes the JAX script's data
    files byte for byte and runs the harness (train, then export) with
    the same flags; the harness itself is recorded, not run."""
    import tf_repos_tpu.train.harness as JH
    import tf_repos_tpu_torch.train.harness as TH

    ran = {"jax": [], "port": []}
    monkeypatch.setattr(JH, "run_task", lambda cfg: ran["jax"].append(cfg))
    monkeypatch.setattr(TH, "run_task", lambda cfg: ran["port"].append(cfg))
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    if case == "serving":
        got = bench._ensure_servable(str(port_dir), "cpu")
        want = jax_bench._ensure_servable(str(jax_dir))
    else:
        small = case == "load_small"
        vocab = SMALL_VOCAB if small else 117_581
        got = load._ensure_servable(str(port_dir), vocab, small, "cpu")
        want = jax_load._ensure_servable(str(jax_dir), vocab, small)
    assert os.path.relpath(got, port_dir) == os.path.relpath(want, jax_dir)
    names = sorted(os.listdir(jax_dir / "data"))
    assert names == ["tr.libsvm", "va.libsvm"] and sorted(os.listdir(port_dir / "data")) == names
    for n in names:
        assert (port_dir / "data" / n).read_bytes() == (jax_dir / "data" / n).read_bytes(), n
    assert [c.task_type for c in ran["port"]] == [c.task_type for c in ran["jax"]] == \
        ["train", "export"]
    for pc, jc in zip(ran["port"], ran["jax"]):
        assert {f: getattr(pc, f) for f in FLAGS} == {f: getattr(jc, f) for f in FLAGS}
        assert pc.device == "cpu"


def _result(out: str):
    lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
    assert len(lines) == 1, out[-2000:]
    return json.loads(lines[0][len("RESULT "):])


@pytest.fixture(scope="module")
def jax_servable(tmp_path_factory):
    """The --small DeepFM (V=10,000, K=4, towers 8/4) on JAX's init,
    exported by the JAX package."""
    cfg = JaxConfig(model="DeepFM", feature_size=SMALL_VOCAB, field_size=39, embedding_size=4,
                    deep_layers="8,4", dropout="1.0,1.0")
    jm = jax_create_model(cfg)
    jp, js = jm.init(jax.random.PRNGKey(0))
    d = str(tmp_path_factory.mktemp("jax_bench_servable") / "servable")
    jax_export(d, jm, jp, js)
    return d


def test_load_bench_small_on_cpu_gives_the_jax_scripts_cells(jax_servable, capsys):
    """The --small CPU run of the port's load bench: every cell has
    requests and no error, the cells and their keys are the JAX script's
    (run on a JAX export at the same levels and protocols), and each
    level's scored micro-batches lie between its instances over
    max_batch and its requests."""
    res = load.main(["--small", "--device=cpu", "--duration=0.5", "--concurrency=1,4",
                     "--protocols=rest,grpc,example"])
    got = _result(capsys.readouterr().out)
    shutil.rmtree(os.path.dirname(res["servable"]), ignore_errors=True)
    assert got == res["result"]
    jax_load.main([f"--servable_model_dir={jax_servable}", "--small", "--duration=0.2",
                   "--concurrency=1,4", "--protocols=rest,grpc,example"])
    want = _result(capsys.readouterr().out)
    assert list(got) == list(want) == [f"{p}_c{c}" for p in ("rest", "grpc", "example")
                                       for c in (1, 4)]
    for name, cell in got.items():
        assert list(cell) == list(want[name]), name
        assert cell["errors"] == 0 and cell["requests"] > 0, (name, cell)
        assert cell["batch_occupancy_mean"] >= 1, (name, cell)
        n = res["counts"][name]
        assert n["k1_launches"] == 0  # the CPU runs K1's plain version
        assert cell["requests"] * 4 / res["max_batch"] <= n["scored_batches"] <= \
            cell["requests"], (name, cell, n)


def _post(port, path, body: bytes):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 headers={"Content-Type": "application/json"})
    return json.loads(urllib.request.urlopen(req, timeout=30).read())


def test_port_and_jax_servers_answer_the_bench_requests_alike(jax_servable):
    """The load bench's three payloads (REST, tf.Example, gRPC) sent to the
    port's server on the CPU and to the JAX package's server, both on
    the JAX export: the same predictions within 2e-5 relative."""
    from tf_repos_tpu.serve.server import PredictionServer as JaxServer

    rest_body, ex_body, grpc_inputs = load.request_bodies(SMALL_VOCAB, 4)
    preds = {}
    for side, srv in (("port", PredictionServer(jax_servable, port=0, reload_secs=0, grpc_port=0,
                                                device="cpu")),
                      ("jax", JaxServer(jax_servable, port=0, reload_secs=0, grpc_port=0))):
        srv.start()
        try:
            url = f"/v1/models/{srv.model_name}:predict"
            with GrpcPredictClient("127.0.0.1", srv.grpc_port, srv.model_name) as c:
                grpc_out = c.predict(grpc_inputs)[0]["prob"]
            preds[side] = {"rest": _post(srv.port, url, rest_body)["predictions"],
                           "example": _post(srv.port, url, ex_body)["predictions"],
                           "grpc": grpc_out}
        finally:
            srv.stop()
    for proto in ("rest", "example", "grpc"):
        got = np.asarray(preds["port"][proto], np.float64)
        want = np.asarray(preds["jax"][proto], np.float64)
        assert got.shape == want.shape == (4,), proto
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-7, err_msg=proto)
    np.testing.assert_array_equal(preds["port"]["rest"], preds["port"]["example"])


def test_grpc_without_grpcio_raises_before_anything_runs(monkeypatch):
    """Asking for grpc where grpcio is missing (a None entry in
    sys.modules makes its import fail) raises an ImportError naming
    grpcio before a servable is built or a level runs; rest alone is
    not refused for it."""
    monkeypatch.setitem(sys.modules, "grpc", None)
    built = []
    monkeypatch.setattr(load, "_ensure_servable", lambda *a: built.append(a))
    with pytest.raises(ImportError, match="grpcio"):
        load.main(["--small", "--device=cpu", "--protocols=rest,grpc"])
    assert not built
    with pytest.raises(ValueError, match="unknown protocols"):
        load.main(["--small", "--device=cpu", "--protocols=rest,http3"])


@pytest.mark.parametrize("script", ["torch_bench_serving", "torch_bench_serving_load"])
def test_scripts_default_to_the_card(script, monkeypatch):
    """--device defaults to cuda: without CUDA the scripts raise, naming
    --device=cpu, before they build anything."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = bench if script == "torch_bench_serving" else load
    monkeypatch.setattr(mod, "_ensure_servable", lambda *a: pytest.fail("built a servable"))
    with pytest.raises(RuntimeError, match="--device=cpu"):
        mod.main(["--protocols=rest"] if mod is load else [])
