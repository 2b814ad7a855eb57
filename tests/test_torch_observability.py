"""The port's observability (utils/observability.py, utils/tb_events.py)
against the JAX package's: metrics.jsonl and the TensorBoard records of
one CLI run from the same weights on the same files equal JAX's but for
wall times (and the rate, which is one); the event files read back with
the tensorboard package's own reader; --profile_steps writes a
torch.profiler trace under <model_dir>/profile, the port's spans in it,
and logs their device ms a step; --check_numerics raises
FloatingPointError where JAX's raises (a feature value past the f32
range: the FM's inf - inf makes the NaN), on one process and on a mesh."""

import glob
import json
import os

import jax
import numpy as np
import pytest
from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

from tf_repos_tpu import main as JAX_CLI
from tf_repos_tpu.config import Config as JaxConfig
from tf_repos_tpu.models import create_model as jax_create_model
from tf_repos_tpu_torch import main as CLI
from tf_repos_tpu_torch.config import parse_config
from tf_repos_tpu_torch.data.synthetic import write_synthetic_libsvm
from tf_repos_tpu_torch.train.checkpoint import CheckpointManager
from tf_repos_tpu_torch.train.harness import Harness
from tf_repos_tpu_torch.utils.convert import params_from_jax
from tf_repos_tpu_torch.utils.observability import RECORDER, MetricsWriter
from tf_repos_tpu_torch.utils.tree import tree_leaves

FLAGS = ["--model=DeepFM", "--feature_size=400", "--field_size=39", "--embedding_size=4",
         "--deep_layers=8,4", "--dropout=1.0,1.0", "--batch_size=32", "--num_epochs=1",
         "--learning_rate=0.01", "--log_steps=2", "--dt_dir=x", "--seed=3",
         "--eval_throttle_secs=-1", "--eval_decision_steps=3", "--compute_dtype=float32"]
# clock-made values: compared by presence only
CLOCK = {"wall", "wall_time", "examples_per_sec"}


@pytest.fixture
def data_dir(tmp_path):
    d = tmp_path / "data"
    d.mkdir()
    write_synthetic_libsvm(str(d / "tr.libsvm"), 160, feature_size=400, seed=0)
    write_synthetic_libsvm(str(d / "va.libsvm"), 64, feature_size=400, seed=1)
    return d


def _records(model_dir):
    with open(os.path.join(model_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _scalars(model_dir):
    acc = EventAccumulator(str(model_dir))
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)] for tag in acc.Tags()["scalars"]}


def test_metrics_and_tensorboard_records_match_jax(tmp_path, data_dir):
    jargv = [*FLAGS, f"--data_dir={data_dir}", f"--model_dir={tmp_path}/jm/", "--mesh_data=1"]
    targv = [*FLAGS, f"--data_dir={data_dir}", f"--model_dir={tmp_path}/tm/", "--device=cpu"]
    # the port starts from the JAX package's init: a step-0 checkpoint
    cfg = parse_config(targv)
    jcfg = JaxConfig(**{k: v for k, v in vars(cfg).items() if k != "device"})
    jp, js = jax_create_model(jcfg).init(jax.random.PRNGKey(jcfg.seed))
    h = Harness(cfg)
    state = h.init_train_state()
    tp, tm = params_from_jax(jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, js))
    for dst, s in zip(tree_leaves(state["params"]), tree_leaves(tp)):
        dst.copy_(s)
    state["mstate"] = tm
    CheckpointManager(h.model_dir).save(0, state)

    JAX_CLI.main(jargv)
    CLI.main(targv)
    want, got = _records(f"{tmp_path}/jm/x"), _records(f"{tmp_path}/tm/x")
    assert [(r["step"], r["kind"], sorted(r)) for r in got] == \
        [(r["step"], r["kind"], sorted(r)) for r in want]
    assert {r["kind"] for r in got} == {"train", "eval", "final"}
    for a, b in zip(got, want):
        for k in b:
            if k not in CLOCK and k not in ("step", "kind"):
                np.testing.assert_allclose(a[k], b[k], rtol=2e-5, atol=1e-6, err_msg=k)
    jt, tt = _scalars(f"{tmp_path}/jm/x"), _scalars(f"{tmp_path}/tm/x")
    assert sorted(tt) == sorted(jt)
    for tag in jt:
        assert [s for s, _ in tt[tag]] == [s for s, _ in jt[tag]], tag
        if tag.split("/")[-1] not in CLOCK:
            np.testing.assert_allclose([v for _, v in tt[tag]], [v for _, v in jt[tag]],
                                       rtol=2e-5, atol=1e-6, err_msg=tag)


def test_metrics_writer_emits_both_formats(tmp_path):
    w = MetricsWriter(str(tmp_path))
    w.write(1, {"loss": 0.69, "examples_per_sec": 1e6})
    w.write(2, {"loss": 0.65})
    w.write(2, {"auc": 0.801}, kind="eval")
    w.close()
    assert len(glob.glob(str(tmp_path / "events.out.tfevents.*"))) == 1
    with open(w.path) as f:
        rec = [json.loads(line) for line in f]
    assert rec[2]["auc"] == 0.801 and rec[2]["kind"] == "eval"
    sc = _scalars(tmp_path)
    assert {"train/loss", "train/examples_per_sec", "eval/auc"} <= set(sc)
    assert [s for s, _ in sc["train/loss"]] == [1, 2]
    assert abs(sc["train/loss"][0][1] - 0.69) < 1e-6 and abs(sc["eval/auc"][0][1] - 0.801) < 1e-6


def test_profile_trace_written(tmp_path, data_dir, capsys):
    argv = [*FLAGS, f"--data_dir={data_dir}", f"--model_dir={tmp_path}/m/", "--device=cpu",
            "--profile_steps=2", "--profile_start_step=1", "--eval_throttle_secs=0",
            "--sparse_table_update=true", "--fused_table=true", "--pallas_expand=true"]
    CLI.main(["--task_type=train", *argv])
    traces = glob.glob(str(tmp_path / "m" / "x" / "profile" / "*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    # the window's steps ran under it: the row kernels' plain versions
    names = {e.get("name", "") for e in events}
    assert any("index_select" in n for n in names) and any("index_add" in n for n in names)
    # the port's spans over them, and the host input's wait between steps
    assert {"step.forward", "step.backward", "step.update", "input.wait"} <= names
    # the exit's line of device ms a step, then an empty recorder
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("INFO: spans")]
    assert len(lines) == 1
    assert all(f" {n} " in lines[0] for n in ("step.forward", "model.embed.bwd", "input.wait"))
    assert RECORDER.records() == []


def _poison(data_dir):
    """A feature value of 1e39 (inf in f32; both readers parse "nan" as 0)
    in the third training line."""
    p = data_dir / "tr.libsvm"
    lines = p.read_text().splitlines()
    head, rest = lines[2].split(" ", 1)
    fid = rest.split(" ")[14].split(":")[0]
    lines[2] = " ".join([head, *rest.split(" ")[:14], f"{fid}:1e39", *rest.split(" ")[15:]])
    p.write_text("\n".join(lines) + "\n")


def test_check_numerics_raises_where_jax_raises(tmp_path, data_dir):
    _poison(data_dir)
    common = [*FLAGS, f"--data_dir={data_dir}", "--eval_throttle_secs=0", "--check_numerics=true"]
    # --check_numerics turns jax_debug_nans on for the whole process: put
    # it back, or the tests after this one in the worker see it
    debug_nans = jax.config.jax_debug_nans
    try:
        with pytest.raises(FloatingPointError):
            JAX_CLI.main([*common, f"--model_dir={tmp_path}/jm/", "--mesh_data=1"])
    finally:
        jax.config.update("jax_debug_nans", debug_nans)
    with pytest.raises(FloatingPointError):
        CLI.main([*common, f"--model_dir={tmp_path}/tm/", "--device=cpu"])
    # without the flag both carry on to a NaN loss
    res = CLI.main([*common[:-1], f"--model_dir={tmp_path}/tn/", "--device=cpu"])
    assert np.isnan(res["loss"])
    # on a mesh: the ranks' FloatingPointError ends the run
    with pytest.raises(Exception, match="FloatingPointError"):
        CLI.main([*common, f"--model_dir={tmp_path}/tmm/", "--device=cpu", "--mesh_model=2"])
