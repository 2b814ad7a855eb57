"""Several hosts (--dist_mode=2) on the CPU: each "host" an OS process of
the port's CLI (``python -m tf_repos_tpu_torch.main --dist_mode=2
--worker_hosts=127.0.0.1:P,127.0.0.1:Q --task_index=i --device=cpu``)
spawning its ranks of the mesh over gloo, against the JAX package.

  * shard_files_for_host and synchronized_iterator equal the JAX
    package's (under one fake agree_min, on an exhaustion at a window
    boundary and on an uneven one);
  * GlobalUidsUnion in two gloo processes equals one JAX
    SparseBatchMapper over the concatenated global batch: the global uid
    set, the remapped ids, the COO arrays (their cross-host bucket) and
    the --mh_bucket widths;
  * two-host sparse DeepFM on a 2x2 mesh (two ranks a host), with
    mid-train eval, --steps_per_dispatch=2 and --packed_cache: both hosts
    log the same losses, and the losses and the row store equal the JAX
    package's single-process 2x2 build_sharded_sparse_train_step on the
    same global batches (host 0's batch, then host 1's) at rtol 1e-5;
    its final eval equal to the one-process eval, then infer (te files of
    90 and 40 rows at batch 32: the template path) and export on two
    hosts; infer merges to the one-process pred.txt at rtol 1e-5, atol
    1e-7;
  * two-host ESMM --mh_coo (one rank a host) against JAX's 2x1 step on
    the same global batches, then eval with --mh_bucket on two hosts
    equal to the one-process eval;
  * a SIGTERM to one host stops both at the same step, checkpointed,
    exit 0;
  * --slim_transfer on a one-host 2x2 mesh: slim off and on agree within
    1e-6 on the train loss, eval loss, AUC and predictions, and both are
    held to the JAX package's run of the same flags on its 2x2 mesh.

Every spawned process has its own communicate(timeout=...)."""

import ast
import json
import os
import signal
import socket
import subprocess
import sys
import time
import warnings

import jax
import numpy as np
import pytest

from tf_repos_tpu.config import Config as JaxConfig
from tf_repos_tpu.data import pipeline as JP
from tf_repos_tpu.data.sparse_batch import MhCooPacker as JaxPacker
from tf_repos_tpu.data.sparse_batch import MhPadBucketer as JaxBucketer
from tf_repos_tpu.data.sparse_batch import SparseBatchMapper as JaxMapper
from tf_repos_tpu.data.synthetic import synthetic_aliccp_batch, synthetic_criteo_batch
from tf_repos_tpu.train.harness import Harness as JaxHarness
from tf_repos_tpu.train.harness import run_task as jax_run_task
from tf_repos_tpu_torch import main as M
from tf_repos_tpu_torch.config import parse_config
from tf_repos_tpu_torch.data import pipeline as TP
from tf_repos_tpu_torch.data.ragged import MH_PAIRS
from tf_repos_tpu_torch.data.synthetic import write_synthetic_aliccp, write_synthetic_libsvm
from tf_repos_tpu_torch.models import input_format
from tf_repos_tpu_torch.train.checkpoint import CheckpointManager
from tf_repos_tpu_torch.train.harness import Harness
from tf_repos_tpu_torch.utils.convert import params_from_jax, sparse_state_from_jax
from test_torch_mesh_ranks import rank_jobs, shared, spawn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST_TIMEOUT_S = 240


# ------------------------------------------------------------ file shards
@pytest.mark.parametrize("n_files", [5, 1])
def test_shard_files_for_host_matches_jax(n_files):
    files = [f"tr.part{i}" for i in range(n_files)]
    for i in range(2):
        with warnings.catch_warnings(record=True) as got_w:
            warnings.simplefilter("always")
            got = TP.shard_files_for_host(files, i, 2)
        with warnings.catch_warnings(record=True) as want_w:
            warnings.simplefilter("always")
            want = JP.shard_files_for_host(files, i, 2)
        assert got == want
        assert [str(w.message) for w in got_w] == [str(w.message) for w in want_w]
        assert len(got_w) == (n_files < 2)


# ----------------------------------------------------- lockstep iterator
@pytest.mark.parametrize("mine,other", [(8, 12), (12, 8), (9, 30), (4, 4)],
                         ids=["window_boundary", "longer", "uneven", "equal"])
def test_synchronized_iterator_matches_jax(capsys, mine, other):
    """This host yields ``mine`` batches, the other ``other``; agree_min
    takes the min with the other host's signal of the same window."""

    def run(fn):
        sync = 4

        def signals(n):
            # the other host's signal of each window: sync + 1 while it
            # fills a window, then its last (short, maybe empty) count
            out, left = [], n
            while True:
                take = min(sync, left)
                left -= take
                if take < sync:
                    return out + [take]
                out.append(sync + 1)

        theirs = signals(other)
        seen = []

        def agree_min(n):
            seen.append(n)
            k = len(seen) - 1
            return min(n, theirs[k] if k < len(theirs) else 0)

        items = list(fn(iter(range(mine)), sync_every=sync, agree_min=agree_min))
        return items, seen, capsys.readouterr().out

    got, want = run(TP.synchronized_iterator), run(JP.synchronized_iterator)
    assert got == want
    assert len(got[0]) == min(mine, other)


# ------------------------------------------------------------ uid union
UNION_CASES = {
    "deepfm": (dict(model="DeepFM", feature_size=400, field_size=39, embedding_size=4,
                    sparse_table_update=True, static_fields=13, batch_size=16), False),
    "esmm_coo": (dict(model="ESMM", feature_size=400, field_size=11, embedding_size=4,
                      multi_hot_pad=8, sparse_table_update=True, mh_coo=True, batch_size=16),
                 False),
    "esmm_bucket": (dict(model="ESMM", feature_size=400, field_size=11, embedding_size=4,
                         multi_hot_pad=8, sparse_table_update=True, mh_bucket="pow2",
                         batch_size=16), True),
}


def _global_batches(kw, n=3):
    b = 2 * kw["batch_size"]
    out = []
    for i in range(n):
        rng = np.random.default_rng(40 + i)
        if kw["model"] == "DeepFM":
            g = synthetic_criteo_batch(rng, b, kw["feature_size"])
        else:
            g = synthetic_aliccp_batch(rng, b, kw["feature_size"],
                                       multi_hot_pad=kw["multi_hot_pad"])
            if i == 1:  # a narrow batch: the widths must not shrink
                for ids_f, vals_f in MH_PAIRS:
                    g[ids_f][:, 2:] = 0
                    if vals_f:
                        g[vals_f][:, 2:] = 0
        out.append(g)
    return out


def _host_halves(kw):
    half = kw["batch_size"]
    return [[{k: v[h * half:(h + 1) * half] for k, v in g.items()} for g in _global_batches(kw)]
            for h in range(2)]


@pytest.fixture(scope="module")
def unions(tmp_path_factory):
    """Every case's unioned batches of both processes, from one spawn."""
    jobs = [("rank_uids_union", (kw, _host_halves(kw), bucket))
            for kw, bucket in UNION_CASES.values()]
    return shared(tmp_path_factory, "multihost-union",
                  lambda: dict(zip(UNION_CASES, spawn(rank_jobs, jobs, mesh=(2, 1)))))


@pytest.mark.parametrize("case", list(UNION_CASES))
def test_uids_union_in_two_processes_matches_one_jax_mapper(unions, case):
    kw, bucket = UNION_CASES[case]
    globals_ = _global_batches(kw)
    half = kw["batch_size"]
    every = unions[case]
    from tf_repos_tpu.models import create_model as jax_create_model

    model = jax_create_model(JaxConfig(**kw))
    chain = []
    if bucket:
        from tf_repos_tpu.data.ragged import MH_PAIRS as JAX_PAIRS

        chain.append(JaxBucketer(JAX_PAIRS, "pow2"))
    if kw.get("mh_coo"):
        chain.append(JaxPacker(model.mh_coo_groups(), n_data=2, floor=8, cdest_aux=False))
    chain.append(JaxMapper(model.sparse_slots()))
    for i, g in enumerate(globals_):
        want = dict(g)
        for stage in chain:
            want = stage(want)
        for h in range(2):
            got = every[h][i]
            assert sorted(got) == sorted(want), (sorted(got), sorted(want))
            for k, v in want.items():
                v = np.asarray(v)
                if k.startswith("__uids_"):
                    np.testing.assert_array_equal(got[k], v, err_msg=k)
                elif k.startswith("__mhc_"):
                    if k == "__mhc_cnt":  # the port's counts ride along: [D, G, B/D]
                        continue
                    np.testing.assert_array_equal(got[k][0], v[h], err_msg=k)
                else:
                    np.testing.assert_array_equal(got[k], v[h * half:(h + 1) * half], err_msg=k)


# ------------------------------------------------------- host processes
def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env():
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = REPO
    return env


def _start_hosts(argv):
    hosts = f"127.0.0.1:{_free_port()},127.0.0.1:{_free_port()}"
    return [subprocess.Popen(
        [sys.executable, "-m", "tf_repos_tpu_torch.main", *argv, "--device=cpu",
         "--dist_mode=2", f"--worker_hosts={hosts}", f"--task_index={i}", "--job_name=worker"],
        cwd=REPO, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)]


def _join(procs):
    outs = []
    for i, p in enumerate(procs):
        try:
            out, err = p.communicate(timeout=HOST_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, f"host {i} exited {p.returncode}:\n{err[-3000:]}"
        outs.append(out)
    return outs


def _run_hosts(argv):
    """Both hosts' stdout and RESULT of one task."""
    outs = _join(_start_hosts(argv))
    results = []
    for out in outs:
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT: ")][-1][len("RESULT: "):]
        try:
            results.append(ast.literal_eval(line))
        except (ValueError, SyntaxError):  # a path (infer, export)
            results.append(line)
    return outs, results


def _lines(out, prefix):
    return [ln for ln in out.splitlines() if ln.startswith(prefix)]


def _losses(model_dir):
    with open(os.path.join(model_dir, "metrics.jsonl")) as f:
        return [r["loss"] for r in map(json.loads, f) if r["kind"] == "train"]


def _jax_mesh_state(argv, data, model):
    """The JAX harness's initial state on a data x model mesh (its own
    seeded init), with its harness for stepping."""
    cfg = parse_config(argv)
    jcfg = JaxConfig(**{k: v for k, v in vars(cfg).items() if k != "device"})
    jcfg = jcfg.replace(pallas_expand=False, mesh_data=data, mesh_model=model, dist_mode=0,
                        worker_hosts="", model_dir=cfg.model_dir + "jax/")
    jh = JaxHarness(jcfg)
    return jh, jh.init_train_state()


def _save_as_port_checkpoint(argv, jts):
    """The JAX state, its tables unpadded, as the port's step-0 checkpoint
    in the run's model_dir (which every host then restores)."""
    cfg = parse_config([*argv, "--device=cpu"])
    h = Harness(cfg)
    state = h.init_train_state()
    names = list(h.model.sparse_slots())
    vocab = {t: s.vocab for t, s in h.model.sparse_slots().items()}
    params = jax.tree.map(np.asarray, jts["params"])
    tp, tm = params_from_jax({k: (v[:vocab[k]] if k in names else v) for k, v in params.items()},
                             jax.tree.map(np.asarray, jts["mstate"]))
    for k, v in tp.items():
        if k not in names:
            state["params"][k] = v
    for t in names:
        aux = {n: (np.asarray(a)[:vocab[t]] if np.ndim(a) and np.shape(a)[0] > vocab[t] else a)
               for n, a in jts["opt_state"]["sparse"][t].items()}
        state["opt_state"]["sparse"][t] = sparse_state_from_jax(aux, params[t][:vocab[t]])
        state["params"][t] = h._sopt.table(state["opt_state"]["sparse"][t])
    state["mstate"] = tm
    CheckpointManager(h.model_dir).save(0, state)
    return h


def _host_batches(h, n_hosts=2):
    """Each host's training batches as its CLI reads them (its file shard,
    shuffled by --seed), from the port's reader."""
    files = h._glob_split("tr", shuffle=True)
    return [list(h._build_reader(TP.shard_files_for_host(files, i, n_hosts),
                                 input_format(h.model), shuffle=True, epochs=h.cfg.num_epochs))
            for i in range(n_hosts)]


def _jax_steps(jh, jts, host_batches, chain):
    """JAX's sharded sparse step on the global batches (host 0's rows,
    then host 1's), each through ``chain``: the losses and the state."""
    step = jh._get_train_step()
    state = {k: jts[k] for k in ("params", "opt_state", "mstate")}
    losses = []
    for i, parts in enumerate(zip(*host_batches)):
        g = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
        for stage in chain:
            g = stage(g)
        state, loss = step(state, jh._place(g), jax.random.PRNGKey(100 + i))
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, state)


DEEPFM = ["--model=DeepFM", "--feature_size=400", "--field_size=39", "--embedding_size=4",
          "--deep_layers=8,4", "--dropout=1.0,1.0", "--batch_size=32", "--num_epochs=1",
          "--log_steps=1", "--learning_rate=0.01", "--seed=7", "--dt_dir=x",
          "--sparse_table_update=true", "--fused_table=true", "--pallas_expand=true",
          "--mesh_data=2", "--mesh_model=2", "--eval_throttle_secs=-1", "--eval_decision_steps=2"]


@pytest.fixture(scope="module")
def deepfm(tmp_path_factory):
    return shared(tmp_path_factory, "multihost-deepfm",
                  lambda: _deepfm(tmp_path_factory.mktemp("mh_deepfm")))


def _deepfm(tmp):
    d = tmp / "data"
    d.mkdir()
    write_synthetic_libsvm(str(d / "tr.part0.libsvm"), 128, feature_size=400, seed=0)
    write_synthetic_libsvm(str(d / "tr.part1.libsvm"), 128, feature_size=400, seed=3)
    write_synthetic_libsvm(str(d / "va.libsvm"), 64, feature_size=400, seed=1)
    write_synthetic_libsvm(str(d / "te.part0.libsvm"), 90, feature_size=400, seed=2)
    write_synthetic_libsvm(str(d / "te.part1.libsvm"), 40, feature_size=400, seed=4)
    argv = [*DEEPFM, f"--data_dir={d}", f"--model_dir={tmp}/m/"]
    jh, jts = _jax_mesh_state(argv, 2, 2)
    h = _save_as_port_checkpoint(argv, jts)
    batches = _host_batches(h)
    want_losses, want_state = _jax_steps(jh, jts, batches, [JaxMapper(jh.model.sparse_slots())])
    train_argv = ["--task_type=train", *argv, "--steps_per_dispatch=2", "--packed_cache=true"]
    outs, res = _run_hosts(train_argv)
    store = CheckpointManager(h.model_dir).restore("cpu")["opt_state"]["sparse"]["fm_wv"]["wmv"]
    out = {"outs": outs, "res": res, "losses": _losses(h.model_dir), "want": want_losses,
           "store": store[:-1].numpy(), "want_store": want_state["opt_state"]["sparse"]
           ["fm_wv"]["wmv"][:400], "argv": argv, "data": str(d)}
    # infer and export on two hosts (eval: the train run's final one, and
    # ESMM's test runs the eval task), and the one-process infer and eval
    _, out["infer"] = _run_hosts(["--task_type=infer", *argv])
    out["pred"] = np.loadtxt(str(d / "pred.txt"))
    _, out["export"] = _run_hosts(["--task_type=export", *argv])
    one = M.main(["--task_type=infer", *argv, "--device=cpu", "--mesh_data=1", "--mesh_model=1"])
    out["pred_one"] = np.loadtxt(one)
    out["eval_one"] = M.main(["--task_type=eval", *argv, "--device=cpu", "--mesh_data=1",
                              "--mesh_model=1"])
    return out


def test_two_host_deepfm_matches_jax_single_process_mesh(deepfm):
    """Both hosts log the same loss lines; the chief's losses and the final
    w|m|v store equal JAX's single-process 2x2 sharded sparse step on the
    same global batches (under --steps_per_dispatch=2 a loss is logged
    every second step)."""
    outs, res = deepfm["outs"], deepfm["res"]
    assert "over 2 hosts on gloo" in outs[0]
    steps0, steps1 = _lines(outs[0], "INFO: step = "), _lines(outs[1], "INFO: step = ")
    assert len(steps0) == 2
    assert [s.split(" (")[0] for s in steps0] == [s.split(" (")[0] for s in steps1]
    assert res[0]["step"] == res[1]["step"] == len(deepfm["want"]) == 4
    np.testing.assert_allclose(deepfm["losses"], deepfm["want"][1::2], rtol=1e-5)
    np.testing.assert_allclose(deepfm["store"], deepfm["want_store"], rtol=1e-5, atol=1e-7)


def test_two_host_midtrain_eval_with_packed_cache(deepfm):
    """Mid-train eval at every second step (the chief's verdict) under
    --steps_per_dispatch=2 and --packed_cache: the same eval lines on
    both hosts, no deadlock."""
    outs = deepfm["outs"]
    e0, e1 = _lines(outs[0], "INFO: eval:"), _lines(outs[1], "INFO: eval:")
    assert len(e0) >= 3 and e0 == e1
    assert os.path.isdir(os.path.join(deepfm["data"], ".packed_cache"))


def test_two_host_eval_infer_export(deepfm):
    """The two hosts' final eval equals the one-process eval of the
    checkpoint; infer's te files (90 and 40 rows: host 1 feeds the
    template batch while host 0 finishes) merge to the one-process
    pred.txt; export writes one servable."""
    for k, v in deepfm["eval_one"].items():
        for r in deepfm["res"]:
            assert r[k] == pytest.approx(v, rel=1e-5), k
    assert deepfm["pred"].shape == deepfm["pred_one"].shape == (130,)
    np.testing.assert_allclose(deepfm["pred"], deepfm["pred_one"], rtol=1e-5, atol=1e-7)
    path = deepfm["export"][0]
    assert os.path.isfile(os.path.join(path, "saved_model.json"))


ESMM = ["--model=ESMM", "--feature_size=400", "--field_size=11", "--embedding_size=4",
        "--deep_layers=8,4", "--dropout=1.0,1.0", "--batch_size=16", "--num_epochs=1",
        "--log_steps=1", "--learning_rate=0.01", "--seed=7", "--dt_dir=x", "--multi_hot_pad=8",
        "--sparse_table_update=true", "--fused_table=true", "--pallas_expand=true",
        "--mh_coo=true", "--mh_coo_floor=8", "--mh_bucket=pow2", "--mesh_data=2",
        "--mesh_model=1", "--eval_throttle_secs=0"]


def test_two_host_esmm_coo_matches_jax_and_evaluates_with_mh_bucket(tmp_path):
    """ESMM --mh_coo over two hosts (each host packs its own rows, the
    union agrees the COO bucket): losses equal JAX's 2x1 step on the same
    global batches; then eval with --mh_bucket on two hosts equals the
    one-process eval."""
    d = tmp_path / "data"
    d.mkdir()
    write_synthetic_aliccp(str(d / "tr.part0"), 64, feature_size=400, seed=0)
    write_synthetic_aliccp(str(d / "tr.part1"), 64, feature_size=400, seed=3)
    write_synthetic_aliccp(str(d / "va.part0"), 48, feature_size=400, seed=1)
    argv = [*ESMM, f"--data_dir={d}", f"--model_dir={tmp_path}/m/"]
    jh, jts = _jax_mesh_state(argv, 2, 1)
    h = _save_as_port_checkpoint(argv, jts)
    chain = [JaxPacker(jh.model.mh_coo_groups(), n_data=2, floor=8, cdest_aux=False),
             JaxMapper(jh.model.sparse_slots())]
    want, _ = _jax_steps(jh, jts, _host_batches(h), chain)
    outs, res = _run_hosts(["--task_type=train", *argv])
    assert len(want) == 4 and res[0]["step"] == res[1]["step"] == 4
    np.testing.assert_allclose(_losses(h.model_dir), want, rtol=1e-5)
    _, ev = _run_hosts(["--task_type=eval", *argv])
    one = M.main(["--task_type=eval", *argv, "--device=cpu", "--mesh_data=1"])
    for k, v in one.items():
        assert ev[0][k] == pytest.approx(v, rel=1e-5) and ev[1][k] == ev[0][k], k


def test_sigterm_to_one_host_stops_both_at_one_step(tmp_path):
    d = tmp_path / "data"
    d.mkdir()
    write_synthetic_libsvm(str(d / "tr.part0.libsvm"), 96, feature_size=400, seed=0)
    write_synthetic_libsvm(str(d / "tr.part1.libsvm"), 96, feature_size=400, seed=3)
    argv = ["--task_type=train", *DEEPFM[:-2], "--num_epochs=5000", "--log_steps=2",
            "--eval_throttle_secs=0", "--eval_decision_steps=2", "--mesh_model=1",
            f"--data_dir={d}", f"--model_dir={tmp_path}/m/"]
    procs = _start_hosts(argv)
    metrics = tmp_path / "m" / "x" / "metrics.jsonl"
    deadline = time.time() + 120
    while time.time() < deadline and not (metrics.exists() and metrics.stat().st_size > 0):
        time.sleep(0.25)
    procs[1].send_signal(signal.SIGTERM)
    outs = _join(procs)
    assert "graceful shutdown" in outs[0] and "graceful shutdown" in outs[1]
    results = [ast.literal_eval(_lines(o, "RESULT: ")[-1][len("RESULT: "):]) for o in outs]
    assert results[0]["step"] == results[1]["step"] > 0
    assert results[0]["stopped_by_signal"] == 1.0
    assert CheckpointManager(str(tmp_path / "m" / "x")).latest_step() == results[0]["step"]


SLIM = ["--model=DeepFM", "--feature_size=500", "--field_size=39", "--embedding_size=4",
        "--deep_layers=8,4", "--dropout=1.0,1.0", "--batch_size=32", "--num_epochs=1",
        "--log_steps=1", "--learning_rate=0.01", "--seed=7", "--dt_dir=x", "--static_fields=13",
        "--sparse_table_update=true", "--mesh_data=2", "--mesh_model=2",
        "--eval_throttle_secs=0"]


def test_slim_transfer_on_a_one_host_mesh_equals_unwired_and_jax(tmp_path):
    """Train (its step losses and final eval) and infer, slim off and on,
    from the JAX package's init; then the JAX package's own run of the
    same flags with the wire on its 2x2 mesh."""
    d = tmp_path / "data"
    d.mkdir()
    write_synthetic_libsvm(str(d / "tr.part0.libsvm"), 96, feature_size=500, seed=0)
    write_synthetic_libsvm(str(d / "va.part0.libsvm"), 48, feature_size=500, seed=1)
    write_synthetic_libsvm(str(d / "te.part0.libsvm"), 32, feature_size=500, seed=2)
    results = {}
    jts = None
    for slim in ("false", "true"):
        argv = [*SLIM, f"--data_dir={d}", f"--model_dir={tmp_path}/s{slim}/",
                f"--slim_transfer={slim}", "--device=cpu"]
        if jts is None:
            _, jts = _jax_mesh_state(argv, 2, 2)
        h = _save_as_port_checkpoint(argv, jts)
        tr = M.main(["--task_type=train", *argv])
        preds = np.loadtxt(M.main(["--task_type=infer", *argv]))
        results[slim] = (_losses(h.model_dir), tr["loss"], tr["auc"], preds)
    off, on = results["false"], results["true"]
    assert len(on[0]) == 3
    np.testing.assert_allclose(off[0], on[0], rtol=0, atol=1e-6)
    assert abs(off[1] - on[1]) < 1e-6 and abs(off[2] - on[2]) < 1e-6
    np.testing.assert_allclose(off[3], on[3], atol=1e-6)
    cfg = parse_config([*SLIM, f"--data_dir={d}", f"--model_dir={tmp_path}/jax/",
                        "--slim_transfer=true"])
    jcfg = JaxConfig(**{k: v for k, v in vars(cfg).items() if k != "device"})
    jtr = jax_run_task(jcfg)
    np.testing.assert_allclose(on[0], _losses(f"{tmp_path}/jax/x"), rtol=2e-5)
    assert on[1] == pytest.approx(jtr["loss"], rel=2e-5)
    assert on[2] == pytest.approx(jtr["auc"], rel=2e-5, abs=1e-6)


def test_packed_cache_on_a_mesh_gives_every_rank_the_cache_stream(tmp_path):
    """--packed_cache on a mesh whose file has no cache yet: a cache build
    shuffles other batches than a cache read (parsed blobs against
    65,536-row slices), so the host's first rank completes the cache
    before any rank reads, and every rank trains on the cache's stream:
    the 2x1 mesh's losses equal a one-process run's on the cache it left
    (a file of two blobs and two cache slices)."""
    d = tmp_path / "data"
    d.mkdir()
    write_synthetic_libsvm(str(d / "tr.libsvm"), 70_000, feature_size=400, seed=0)
    argv = ["--task_type=train", "--model=DeepFM", "--feature_size=400", "--field_size=39",
            "--embedding_size=4", "--deep_layers=8,4", "--dropout=1.0,1.0", "--batch_size=8192",
            "--num_epochs=1", "--log_steps=1", "--learning_rate=0.01", "--dt_dir=x",
            "--eval_throttle_secs=0", "--packed_cache=true", "--device=cpu", f"--data_dir={d}"]
    M.main([*argv, "--mesh_data=2", f"--model_dir={tmp_path}/mesh/"])
    assert os.path.isdir(d / ".packed_cache")
    M.main([*argv, "--mesh_data=1", f"--model_dir={tmp_path}/one/"])
    mesh, one = _losses(f"{tmp_path}/mesh/x"), _losses(f"{tmp_path}/one/x")
    assert len(mesh) == len(one) == 9
    np.testing.assert_allclose(mesh, one, rtol=1e-5)
