"""The port's serving slice on the CPU, against the JAX package's
(tests/test_serving.py is the behaviour it is held to): the serving
lookup (K1 over a whole table, the ids normalised as JAX's gather treats
them); both wire codecs; export in both directions for DeepFM, ESMM and
DIN on the same weights (JAX init -> utils/convert.params_from_jax);
out-of-range and negative ids; the scorer's buckets, padding and hot
reload; the micro-batcher; the HTTP, grpc-web and gRPC transports,
overload shedding and the persistent gRPC client; scorer vs
task_type=infer; and the JAX package's C++ client against the port's
server (skipped without g++).

Tolerances: the lookup and the codecs bit-exact; probabilities 2e-5
relative (f32 towers: the same function, f32 sums in another order);
two paths of the port on the same weights 1e-6."""

import base64
import json
import os
import shutil
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_repos_tpu.config import Config as JaxConfig
from tf_repos_tpu.models import create_model as jax_create_model
from tf_repos_tpu.serve import example_proto as JEP
from tf_repos_tpu.serve import predict_proto as JPP
from tf_repos_tpu.serve.export import _flatten as jax_flatten
from tf_repos_tpu.serve.export import export_servable as jax_export
from tf_repos_tpu.serve.export import load_servable as jax_load
from tf_repos_tpu.serve.scorer import Scorer as JaxScorer
from tf_repos_tpu_torch.config import Config
from tf_repos_tpu_torch.data.libsvm import LibsvmDataset
from tf_repos_tpu_torch.data.synthetic import (
    synthetic_aliccp_batch,
    write_synthetic_aliccp,
    write_synthetic_libsvm,
)
from tf_repos_tpu_torch.models import create_model
from tf_repos_tpu_torch.ops import sparse_rows as SR
from tf_repos_tpu_torch.serve import example_proto as EP
from tf_repos_tpu_torch.serve import predict_proto as PP
from tf_repos_tpu_torch.serve.export import export_servable, latest_version_dir
from tf_repos_tpu_torch.serve.scorer import Scorer
from tf_repos_tpu_torch.serve.server import MicroBatcher, OverloadedError, PredictionServer
from tf_repos_tpu_torch.train.harness import Harness, run_task
from tf_repos_tpu_torch.utils.convert import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPP_DIR = os.path.join(REPO, "tf_repos_tpu", "serve", "cpp")

SMALL = {
    "DeepFM": dict(model="DeepFM", feature_size=300, field_size=39, embedding_size=4,
                   deep_layers="8,4", dropout="1.0,1.0"),
    "ESMM": dict(model="ESMM", feature_size=600, field_size=11, embedding_size=4,
                 deep_layers="8,4", dropout="1.0,1.0", multi_hot_pad=8),
    "DIN": dict(model="DIN", feature_size=600, field_size=11, embedding_size=4,
                deep_layers="8,4", attention_layers="8", dropout="1.0,1.0", multi_hot_pad=8),
    # the zoo on libsvm lines: LR's 1-D table, a fused [V, 1+K] table, a [V, K] one
    "LR": dict(model="LR", feature_size=300, field_size=39),
    "IPNN": dict(model="ipnn", feature_size=300, field_size=39, embedding_size=4,
                 deep_layers="8,4", dropout="1.0,1.0"),
    "DCN": dict(model="DCN", feature_size=300, field_size=39, embedding_size=4,
                deep_layers="8,4", dropout="1.0,1.0", cross_layers=2),
}
LIBSVM = ("DeepFM", "LR", "IPNN", "DCN")
ALICCP_INPUTS = ("feat_ids", "a_catids", "a_shopids", "a_brandids", "a_intids",
                 "u_catids", "u_catvals", "u_shopids", "u_shopvals", "u_brandids",
                 "u_brandvals", "u_intids", "u_intvals")


def _wild(v):
    """Ids outside [0, v): JAX's gather clamps them after adding v once to
    a negative id."""
    return np.array([-1, v, v + 7, 2**31 - 1, -(2**31), -v, -v - 3, v - 1, 0], np.int64)


def _instances(name, n, seed=0, wild=False):
    kw = SMALL[name]
    v, rng = kw["feature_size"], np.random.default_rng(seed)
    if name in LIBSVM:
        ids = rng.integers(1, v, size=(n, kw["field_size"]))
        vals = (rng.random((n, kw["field_size"])) + 0.5).astype(np.float32)
        if wild:
            ids[:, ::3] = rng.choice(_wild(v), size=ids[:, ::3].shape)
        return [{"feat_ids": ids[i], "feat_vals": vals[i]} for i in range(n)]
    batch = synthetic_aliccp_batch(rng, n, v, multi_hot_pad=kw["multi_hot_pad"])
    batch = {k: batch[k].astype(np.int64) if k.endswith("ids") else batch[k] for k in ALICCP_INPUTS}
    if wild:
        for k in ("feat_ids", "u_catids", "a_intids"):
            batch[k][:, ::2] = rng.choice(_wild(v), size=batch[k][:, ::2].shape)
        batch["a_catids"][:] = rng.choice(_wild(v), size=n)
    return [{k: a[i] for k, a in batch.items()} for i in range(n)]


def _close(got, want, rtol=2e-5):
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=1e-7, err_msg=k)


def _post(port, path, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    return json.loads(urllib.request.urlopen(req, timeout=30).read())


def _get(port, path):
    return json.loads(urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10).read())


def _json_instances(inst):
    return [{k: np.asarray(v).tolist() for k, v in i.items()} for i in inst]


# ------------------------------------------------------------ serving lookup
def test_normalize_ids_is_jax_gather_rule():
    ids = torch.tensor([4, 5, 99, -1, -6, -100], dtype=torch.int32)
    np.testing.assert_array_equal(SR.normalize_ids(ids, 5).numpy(), [4, 4, 4, 4, 0, 0])


@pytest.mark.parametrize("fused_view", [False, True], ids=["table", "store_view"])
def test_serving_lookup_matches_jax_gather(fused_view):
    """Any int id reads the row JAX's table[ids] reads; a fused store's
    [V, K] view takes V from the view, not the store."""
    v, c = 50, 17
    rng = np.random.default_rng(0)
    table = rng.standard_normal((v, c)).astype(np.float32)
    ids = rng.integers(-2 * v, 2 * v, size=(6, 9)).astype(np.int32)
    ids[0, :9] = _wild(v).astype(np.int32)
    want = np.asarray(jnp.asarray(table)[jnp.asarray(ids)])
    t = torch.from_numpy(table)
    if fused_view:
        store = torch.zeros((v + 1, 3 * c))
        store[:v, :c] = t
        t = store[:-1, :c]
    lookup = SR.make_serving_lookup()
    SR.reset_launches()
    got = lookup(t, torch.from_numpy(ids))
    assert lookup.static_slice_ok and not got.requires_grad
    assert SR.expand_rows.launches == 0  # the CPU takes the plain version
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_serving_lookup_on_a_1d_table_matches_jax_gather(dtype):
    """LR's [V] table: the serving lookup gathers its [V, 1] view and
    drops the last axis, reading for any id the entry JAX's table[ids]
    reads."""
    v = 50
    rng = np.random.default_rng(2)
    table = rng.standard_normal(v).astype(np.float32)
    ids = rng.integers(-2 * v, 2 * v, size=(4, 39)).astype(dtype)
    ids[0, :9] = _wild(v).astype(dtype)
    ids[1, :3] = [-1, v, 2**31 - 1]
    want = np.asarray(jnp.asarray(table)[jnp.asarray(ids)])
    SR.reset_launches()
    got = SR.make_serving_lookup()(torch.from_numpy(table), torch.from_numpy(ids))
    assert SR.expand_rows.launches == 0  # the CPU takes the plain version
    assert got.shape == want.shape == (4, 39)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("cols", [None, (13, 39), (5, 6)],
                         ids=["contiguous", "fields-view", "one-column-view"])
def test_clamped_gather_matches_jax_gather(dtype, cols):
    """expand_rows_clamped, the serving gather, reads for ids of either
    width, contiguous or a view of a wider batch (DeepFM's ids[:, 13:]),
    the rows JAX's table[ids] reads, int32 extremes included."""
    v, c = 50, 16
    rng = np.random.default_rng(1)
    table = rng.standard_normal((v, c)).astype(np.float32)
    ids = rng.integers(-2 * v, 2 * v, size=(7, 39)).astype(dtype)
    ids[0, :9] = _wild(v).astype(dtype)
    ids[1, 13:22] = _wild(v).astype(dtype)
    ids[2, 5] = -(2**31)
    t = torch.from_numpy(ids)
    if cols:
        t, ids = t[:, cols[0]:cols[1]], ids[:, cols[0]:cols[1]]
    want = np.asarray(jnp.asarray(table)[jnp.asarray(ids)])
    SR.reset_launches()
    got = SR.expand_rows_clamped(torch.from_numpy(table), t)
    assert SR.expand_rows.launches == 0  # the CPU takes the plain version
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape,index", [
    ((6, 9), (slice(None),)),
    ((512, 39), (slice(None), slice(13, None))),  # DeepFM's dynamic fields
    ((512, 39), (slice(None), slice(5, 6))),
    ((4, 8, 10), (slice(None), slice(None), slice(2, 7))),
    ((40,), (slice(3, 4),)),
])
def test_id_rows_addresses_every_id(shape, index):
    """The clamped kernel reads output row i's id at storage offset
    (i // cols) * ld + i % cols from the view's first element: that rule,
    on id_rows' (cols, ld), reaches every id of the view in order."""
    base = torch.arange(int(np.prod(shape)), dtype=torch.int64).reshape(shape)
    ids = base[index]
    cols, ld = SR.id_rows(ids)
    i = torch.arange(ids.numel())
    at = ids.storage_offset() + (i // cols) * ld + i % cols
    assert torch.equal(base.reshape(-1)[at], ids.reshape(-1))


def test_id_rows_refuses_what_the_kernel_cannot_read():
    base = torch.zeros((6, 9), dtype=torch.int32)
    for ids in (base.t(), base[:, ::2], base[::2, 1:4].t()):
        with pytest.raises(ValueError, match="adjacent ids"):
            SR.id_rows(ids)


# -------------------------------------------------------------------- codecs
def test_example_proto_roundtrip_and_bytes_match_jax():
    feats = {"I1": [0.5], "I2": [1.25, -3.5], "C1": [123], "C2": [0, -1, 2**40],
             "raw": [b"ab", b""]}
    enc = EP.encode_example(feats)
    assert enc == JEP.encode_example(feats)
    out = EP.decode_example(enc)
    np.testing.assert_allclose(out["I2"], [1.25, -3.5])
    np.testing.assert_array_equal(out["C2"], [0, -1, 2**40])
    assert list(out["raw"]) == [b"ab", b""]
    jout = JEP.decode_example(enc)
    for k in feats:
        np.testing.assert_array_equal(out[k], jout[k])


def test_predict_proto_roundtrip_and_bytes_match_jax():
    ids = np.arange(78, dtype=np.int64).reshape(2, 39)
    vals = np.linspace(0, 1, 78, dtype=np.float32).reshape(2, 39)
    inputs = {"feat_ids": ids, "feat_vals": vals}
    req = PP.encode_predict_request(inputs, "DeepFM", "serving_default")
    assert req == JPP.encode_predict_request(inputs, "DeepFM", "serving_default")
    got, name, sig = PP.decode_predict_request(req)
    assert name == "DeepFM" and sig == "serving_default"
    np.testing.assert_array_equal(got["feat_ids"], ids)
    np.testing.assert_array_equal(got["feat_vals"], vals)
    out = {"prob": np.asarray([0.25, 0.75], np.float32)}
    resp = PP.encode_predict_response(out, "DeepFM", version=1700000000)
    assert resp == JPP.encode_predict_response(out, "DeepFM", version=1700000000)
    outputs, name2, version = PP.decode_predict_response(resp)
    assert name2 == "DeepFM" and version == 1700000000
    np.testing.assert_array_equal(outputs["prob"], out["prob"])
    neg = PP.decode_tensor(PP.encode_tensor(np.asarray([[-5, 3]], np.int64)))
    np.testing.assert_array_equal(neg, [[-5, 3]])


# ------------------------------------------------- export in both directions
def _jax_weights(name, seed=0):
    jm = jax_create_model(JaxConfig(**SMALL[name]))
    jp, js = jm.init(jax.random.PRNGKey(seed))
    if name == "LR":  # its init is all zeros
        jp["w"] = jnp.asarray(np.random.default_rng(seed).standard_normal(jp["w"].shape),
                              jnp.float32)
    return jm, jp, js


@pytest.mark.parametrize("name", ["DeepFM", "ESMM", "DIN", "LR", "IPNN", "DCN"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_export_loads_and_scores_in_the_other_package(tmp_path, name, writer):
    """A servable written by either package loads in both; on the same
    weights the port's scorer gives the JAX scorer's probabilities."""
    jm, jp, js = _jax_weights(name)
    d = str(tmp_path / "servable")
    if writer == "jax":
        jax_export(d, jm, jp, js)
    else:
        tm = create_model(Config(**SMALL[name], device="cpu"))
        tp, ts = params_from_jax(jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, js))
        export_servable(d, tm, tp, ts)
        # the files JAX would write: signature (but the version) and arrays
        vdir = latest_version_dir(d)
        sig = json.load(open(os.path.join(vdir, "saved_model.json")))
        jsig_dir = jax_export(str(tmp_path / "jax_servable"), jm, jp, js)
        jsig = json.load(open(os.path.join(jsig_dir, "saved_model.json")))
        assert {k: v for k, v in sig.items() if k != "version"} == \
            {k: v for k, v in jsig.items() if k != "version"}
        data = np.load(os.path.join(vdir, "variables.npz"))
        want = {f"params/{k}": a for k, a in jax_flatten(jp).items()}
        want.update({f"state/{k}": a for k, a in jax_flatten(js).items()})
        assert sorted(data.files) == sorted(want)
        for k, a in want.items():
            assert data[k].dtype == np.float32
            np.testing.assert_array_equal(data[k], a)
        jax_load(vdir)  # the JAX package's loader takes it
    port = Scorer(d, batch_buckets=(8,), warmup=False, device="cpu")
    ref = JaxScorer(d, batch_buckets=(8,), warmup=False)
    assert port.signature == ref.signature and port.model.cfg.device == "cpu"
    inst = _instances(name, 5, seed=1)
    _close(port.score(inst), ref.score(inst))


@pytest.mark.parametrize("name", ["DeepFM", "ESMM", "DIN", "LR"])
def test_out_of_range_and_negative_ids_scored_as_jax(tmp_path, name):
    jm, jp, js = _jax_weights(name, seed=3)
    d = str(tmp_path / "servable")
    jax_export(d, jm, jp, js)
    port = Scorer(d, batch_buckets=(8,), warmup=False, device="cpu")
    ref = JaxScorer(d, batch_buckets=(8,), warmup=False)
    inst = _instances(name, 7, seed=2, wild=True)
    got = port.score(inst)
    _close(got, ref.score(inst))
    assert all(np.isfinite(a).all() for a in got.values())


@pytest.mark.parametrize("name,flags", [
    ("DeepFM", dict(static_fields=13)),
    ("ESMM", dict(dma_scatter=True, mh_coo=True)),
], ids=["DeepFM_fused", "ESMM_fused_dma"])
def test_export_of_a_fused_row_store_is_the_bare_table(tmp_path, name, flags):
    """After init_opt_state the table is a strided view of the [V+1, 3K]
    (or lane-padded [V+1, 128]) w|m|v store; export writes the [V, K]
    table alone, which the JAX package loads."""
    cfg = Config(**SMALL[name], **flags, sparse_table_update=True, fused_table=True,
                 device="cpu", model_dir=str(tmp_path / "m"), dt_dir="x")
    state = Harness(cfg).init_train_state()
    table = "fm_wv" if name == "DeepFM" else "emb"
    view = state["params"][table]
    assert not view.is_contiguous() and view.shape[0] == cfg.feature_size
    vdir = export_servable(str(tmp_path / "s"), create_model(cfg), state["params"], state["mstate"])
    data = np.load(os.path.join(vdir, "variables.npz"))
    np.testing.assert_array_equal(data[f"params/{table}"], view.numpy())
    _, jparams, _, _ = jax_load(vdir)
    assert jparams[table].shape == tuple(view.shape)


# -------------------------------------------------- a trained DeepFM servable
@pytest.fixture(scope="module")
def servable(tmp_path_factory):
    """Tiny DeepFM trained and exported through the port's harness on the
    CPU: the lazy sparse step over a fused store, 13 static fields."""
    tmp = tmp_path_factory.mktemp("torch_serving")
    data = tmp / "data"
    data.mkdir()
    write_synthetic_libsvm(str(data / "tr.libsvm"), 96, feature_size=300, seed=0)
    write_synthetic_libsvm(str(data / "va.libsvm"), 48, feature_size=300, seed=1)
    shutil.copy(data / "va.libsvm", data / "te.libsvm")
    cfg = Config(**SMALL["DeepFM"], batch_size=32, num_epochs=1, log_steps=5,
                 data_dir=str(data), model_dir=str(tmp / "model"), dt_dir="20260101",
                 eval_throttle_secs=0, servable_model_dir=str(tmp / "servable"),
                 sparse_table_update=True, fused_table=True, pallas_expand=True,
                 static_fields=13, device="cpu")
    run_task(cfg)
    run_task(cfg.replace(task_type="export"))
    return cfg


@pytest.fixture(scope="module")
def jax_scorer(servable):
    """The JAX package's scorer over the port's export: the reference."""
    return JaxScorer(servable.servable_model_dir, batch_buckets=(8, 64), warmup=False)


@pytest.fixture(scope="module")
def server(servable):
    srv = PredictionServer(servable.servable_model_dir, port=0, reload_secs=0, grpc_port=0,
                           device="cpu")
    srv.start()
    yield srv
    srv.stop()


def test_scorer_buckets_and_padding(servable):
    s = Scorer(servable.servable_model_dir, batch_buckets=(1, 8, 64), warmup=False, device="cpu")
    for n, bucket in ((1, 1), (3, 8), (8, 8), (20, 64), (64, 64), (100, 64)):
        out = s.score(_instances("DeepFM", n))
        assert out["prob"].shape == (n,) and s.last_timing["bucket"] == bucket
        assert np.all((out["prob"] >= 0) & (out["prob"] <= 1))
    assert set(s.last_timing) == {"batchify_ms", "device_ms", "bucket"}
    # padding must not affect real rows: one instance alone and in a batch
    one = s.score(_instances("DeepFM", 1, seed=7))["prob"]
    many = s.score(_instances("DeepFM", 1, seed=7) + _instances("DeepFM", 5))["prob"]
    np.testing.assert_allclose(one[0], many[0], rtol=1e-6)
    assert s.score([])["prob"].shape == (0,)


def test_scorer_hot_reload(servable):
    s = Scorer(servable.servable_model_dir, batch_buckets=(8,), warmup=False, device="cpu")
    assert not s.maybe_reload()
    v0 = s.version
    time.sleep(1.1)  # version dirs are unix-timestamp named
    Harness(servable.replace(task_type="export")).export()
    assert s.maybe_reload()
    assert s.version != v0 and s.version_dir == latest_version_dir(servable.servable_model_dir)
    assert s.score(_instances("DeepFM", 2))["prob"].shape == (2,)


def test_micro_batcher_coalesces(servable):
    s = Scorer(servable.servable_model_dir, batch_buckets=(64,), warmup=False, device="cpu")
    mb = MicroBatcher(s, max_batch=64, max_wait_ms=20)
    results = {}

    def call(i):
        results[i] = mb.submit(_instances("DeepFM", 2, seed=i))

    threads = [threading.Thread(target=call, args=(i,)) for i in range(8)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        mb.stop()
    for i in range(8):
        np.testing.assert_allclose(results[i]["prob"], s.score(_instances("DeepFM", 2, seed=i))["prob"],
                                   rtol=1e-6)
    assert sum(r["n"] for r in mb.timings) == 16 and len(mb.timings) < 8  # coalesced


def test_http_predict_roundtrip(servable, server, jax_scorer):
    inst = _instances("DeepFM", 3)
    resp = _post(server.port, "/v1/models/DeepFM:predict", {"instances": _json_instances(inst)})
    assert resp["model_version"] == server.scorer.version
    np.testing.assert_allclose(resp["predictions"], jax_scorer.score(inst)["prob"], rtol=2e-5)
    status = _get(server.port, "/v1/models/DeepFM")
    assert status["model_version_status"][0]["state"] == "AVAILABLE"
    assert _get(server.port, "/healthz") == {"status": "ok"}
    stats = _get(server.port, "/stats")
    assert stats["count"] >= 1 and "device_ms" in stats and stats["shed"] == 0
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server.port, "/v1/models/NoSuchModel:predict", {"instances": _json_instances(inst)})
    assert e.value.code == 404


def test_http_columnar_example_and_grpc_web_forms(servable, server):
    """The columnar ``inputs`` form, serialized tf.Example ``b64``
    instances and a grpc-web framed PredictRequest all score as the
    ``instances`` form does."""
    inst = _instances("DeepFM", 4, seed=9)
    url = "/v1/models/DeepFM:predict"
    want = _post(server.port, url, {"instances": _json_instances(inst)})["predictions"]
    cols = {k: [np.asarray(i[k]).tolist() for i in inst] for k in inst[0]}
    np.testing.assert_allclose(_post(server.port, url, {"inputs": cols})["predictions"], want,
                               rtol=1e-6)
    ex = [{"b64": base64.b64encode(EP.encode_example(
        {"feat_ids": [int(x) for x in i["feat_ids"]],
         "feat_vals": [float(x) for x in i["feat_vals"]]})).decode()} for i in inst]
    np.testing.assert_allclose(_post(server.port, url, {"instances": ex})["predictions"], want,
                               rtol=1e-6)
    msg = PP.encode_predict_request(
        {"feat_ids": np.stack([i["feat_ids"] for i in inst]),
         "feat_vals": np.stack([i["feat_vals"] for i in inst])}, "DeepFM", "serving_default")
    req = urllib.request.Request(
        f"http://127.0.0.1:{server.port}/tensorflow.serving.PredictionService/Predict",
        data=b"\x00" + len(msg).to_bytes(4, "big") + msg,
        headers={"Content-Type": "application/grpc-web+proto"},
    )
    body = urllib.request.urlopen(req, timeout=30).read()
    assert body[0] == 0
    n = int.from_bytes(body[1:5], "big")
    outputs, name, version = PP.decode_predict_response(body[5 : 5 + n])
    assert name == "DeepFM" and version == int(server.scorer.version)
    assert b"grpc-status: 0" in body[5 + n :]
    np.testing.assert_allclose(outputs["prob"], want, rtol=1e-6)


def test_scorer_matches_harness_infer(servable, tmp_path):
    """The servable path (export -> scorer) scores as the checkpoint path
    (task_type=infer) does."""
    out_path = Harness(servable).infer(out_path=str(tmp_path / "pred.txt"))
    infer_preds = np.asarray([float(x) for x in open(out_path).read().split()])
    s = Scorer(servable.servable_model_dir, batch_buckets=(64,), warmup=False, device="cpu")
    scored = []
    for b in LibsvmDataset([os.path.join(servable.data_dir, "te.libsvm")], field_size=39,
                           batch_size=64):
        live = [i for i in range(len(b["label"])) if b["mask"][i] > 0]
        scored.append(s.score([{"feat_ids": b["feat_ids"][i], "feat_vals": b["feat_vals"][i]}
                               for i in live])["prob"])
    scored = np.concatenate(scored)
    assert len(scored) == len(infer_preds) == 48
    np.testing.assert_allclose(scored, infer_preds, rtol=1e-5, atol=1e-6)  # pred.txt's 6 decimals


def test_esmm_export_and_scoring(tmp_path):
    """ESMM trained with --mh_coo --dma_scatter through the port's CLI
    harness, exported, and scored by the port and by the JAX package."""
    d = tmp_path / "data"
    d.mkdir()
    write_synthetic_aliccp(str(d / "tr.samples.txt"), 96, feature_size=600, seed=0)
    write_synthetic_aliccp(str(d / "va.samples.txt"), 48, feature_size=600, seed=1)
    cfg = Config(**SMALL["ESMM"], batch_size=16, num_epochs=1, log_steps=5, data_dir=str(d),
                 model_dir=str(tmp_path / "m"), dt_dir="e", eval_throttle_secs=0,
                 servable_model_dir=str(tmp_path / "servable"), sparse_table_update=True,
                 fused_table=True, pallas_expand=True, mh_coo=True, dma_scatter=True,
                 device="cpu")
    run_task(cfg)
    run_task(cfg.replace(task_type="export"))
    s = Scorer(str(tmp_path / "servable"), batch_buckets=(8,), warmup=True, device="cpu")
    inst = _instances("ESMM", 5, seed=3)
    out = s.score(inst)
    assert set(out) == {"pctcvr", "pctr", "pcvr"}
    np.testing.assert_allclose(out["pctcvr"], out["pctr"] * out["pcvr"], rtol=1e-5)
    _close(out, JaxScorer(str(tmp_path / "servable"), batch_buckets=(8,), warmup=False).score(inst))


# ---------------------------------------------------------------------- gRPC
def _grpc_inputs(inst):
    return {"feat_ids": np.stack([i["feat_ids"] for i in inst]).astype(np.int64),
            "feat_vals": np.stack([i["feat_vals"] for i in inst])}


def test_grpc_predict_roundtrip(servable, server):
    from tf_repos_tpu_torch.serve.grpc_server import grpc_predict

    inst = _instances("DeepFM", 3, seed=11)
    outputs, name, version = grpc_predict("127.0.0.1", server.grpc_port, _grpc_inputs(inst), "DeepFM")
    assert name == "DeepFM" and version == int(server.scorer.version)
    np.testing.assert_allclose(outputs["prob"], server.batcher.submit(inst)["prob"], rtol=1e-6)


def test_grpc_predict_wrong_model_name(servable, server):
    import grpc

    from tf_repos_tpu_torch.serve.grpc_server import grpc_predict

    with pytest.raises(grpc.RpcError) as e:
        grpc_predict("127.0.0.1", server.grpc_port,
                     {"feat_ids": np.zeros((1, 39), np.int64),
                      "feat_vals": np.zeros((1, 39), np.float32)}, "NoSuchModel")
    assert e.value.code() == grpc.StatusCode.NOT_FOUND


def test_grpc_persistent_client_roundtrip(servable, server):
    from tf_repos_tpu_torch.serve.grpc_server import GrpcPredictClient

    inst = _instances("DeepFM", 3, seed=5)
    with GrpcPredictClient("127.0.0.1", server.grpc_port, "DeepFM") as c:
        o1, _, _ = c.predict(_grpc_inputs(inst))
        o2, _, _ = c.predict(_grpc_inputs(inst))
    np.testing.assert_allclose(o1["prob"], o2["prob"], rtol=1e-6)
    np.testing.assert_allclose(o1["prob"], server.batcher.submit(inst)["prob"], rtol=1e-6)


def test_overload_shed_http_and_grpc(servable):
    """A scorer stalled behind a slow request and a tiny max_queued force
    the admission path: HTTP 429 and gRPC RESOURCE_EXHAUSTED, counted
    in /stats."""
    import grpc

    from tf_repos_tpu_torch.serve.grpc_server import GrpcPredictClient

    srv = PredictionServer(servable.servable_model_dir, port=0, reload_secs=0, grpc_port=0,
                           max_queued=2, max_batch=1, device="cpu")
    srv.start()
    fillers = []
    try:
        inst = _instances("DeepFM", 2)
        orig_score = srv.scorer.score

        def slow_score(insts):
            time.sleep(1.0)
            return orig_score(insts)

        srv.scorer.score = slow_score
        fillers = [threading.Thread(target=lambda: srv.batcher.submit([inst[0]]), daemon=True)
                   for _ in range(3)]  # 1 in flight (slow) + 2 queued = the cap
        for f in fillers:
            f.start()
            time.sleep(0.05)
        with pytest.raises(OverloadedError):
            srv.batcher.submit(inst)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(srv.port, "/v1/models/DeepFM:predict", {"instances": _json_instances(inst)})
        assert ei.value.code == 429
        with GrpcPredictClient("127.0.0.1", srv.grpc_port, "DeepFM") as c:
            with pytest.raises(grpc.RpcError) as gi:
                c.predict(_grpc_inputs(inst))
            assert gi.value.code() == grpc.StatusCode.RESOURCE_EXHAUSTED
        for f in fillers:
            f.join(timeout=10)
        assert _get(srv.port, "/stats")["shed"] >= 3
    finally:
        for f in fillers:
            f.join(timeout=10)
        srv.stop()


def test_server_without_grpc_port_never_imports_grpc(servable):
    """grpc_port=-1 serves REST and grpc-web with the standard library
    alone, so a host without grpcio can serve."""
    code = (
        "import sys, json, urllib.request\n"
        "from tf_repos_tpu_torch.serve.server import PredictionServer\n"
        "import tf_repos_tpu_torch.main, tf_repos_tpu_torch.serve\n"
        f"srv = PredictionServer({servable.servable_model_dir!r}, port=0, grpc_port=-1,\n"
        "                       reload_secs=0, device='cpu')\n"
        "srv.start()\n"
        "urllib.request.urlopen(f'http://127.0.0.1:{srv.port}/healthz', timeout=10).read()\n"
        "srv.stop()\n"
        "sys.exit(1 if any(m == 'grpc' or m.startswith('grpc.') for m in sys.modules) else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr[-3000:]


# ---------------------------------------------- the JAX package's C++ client
@pytest.fixture(scope="module")
def cpp_client(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no C++ toolchain")
    build = tmp_path_factory.mktemp("torch_cppbuild") / "cpp"
    shutil.copytree(CPP_DIR, build)
    subprocess.run(["make", "-s", "clean", "all"], cwd=build, check=True, timeout=180)
    return str(build / "ctr_client")


def _cpp_pctr(cpp_client, port, *mode):
    out = subprocess.run([cpp_client, "127.0.0.1", str(port), "DeepFM", *mode],
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    pline = [line for line in out.stdout.splitlines() if line.startswith("pctr = ")]
    assert len(pline) == 1
    return out.stdout, float(pline[0].split("=")[1])


def test_cpp_client_rest_against_port_server(servable, server, cpp_client):
    stdout, p = _cpp_pctr(cpp_client, server.port, "39")
    assert "AVAILABLE" in stdout
    # the client's probe: ids 1..39, values 0.5 for the 13 continuous fields
    probe = [{"feat_ids": np.arange(1, 40), "feat_vals": np.where(np.arange(39) < 13, 0.5, 1.0)}]
    assert abs(p - float(server.scorer.score(probe)["prob"][0])) < 1e-5


def test_cpp_client_grpc_web_against_port_server(servable, server, cpp_client):
    _, p = _cpp_pctr(cpp_client, server.port, "grpc", "39")
    _, p_rest = _cpp_pctr(cpp_client, server.port, "39")
    assert 0.0 <= p <= 1.0 and abs(p - p_rest) < 1e-5
