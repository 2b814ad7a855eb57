"""The port's zoo AUC ladder (scripts/torch_zoo_auc.py) on the CPU,
against the JAX package's (scripts/zoo_auc.py): the same ladder rows and
flags, the wide rows' CSV view byte-equal on a 5,000-line surrogate, a
DeepFM and an LR (wide) row trained through the port's harness with the
setup (feature_size, Bayes ceiling) the JAX package computes on the same
files, finished rows read back from the script's own --out, a failing
row recorded with its error, and an --out that never names the JAX
package's records.

The surrogate's label calibration runs at a small probe (the default
takes half a minute a process) in both packages alike: configure()
drops the cached calibration, so both modules' configure is wrapped to
calibrate at PROBE right after (once for each module and line count)."""

import dataclasses
import importlib.util
import json
import os
import tempfile

import pytest

from tf_repos_tpu.data import criteo_surrogate as JCS
from tf_repos_tpu.features import criteo as JC
from tf_repos_tpu_torch.data import criteo_surrogate as CS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE = 20_000
LINES = 5_000


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


zoo = _script("torch_zoo_auc")
jax_zoo = _script("zoo_auc")


@pytest.fixture(scope="module", autouse=True)
def small_calibration():
    cal = {}  # (module, lines) -> its calibration, made once
    with pytest.MonkeyPatch.context() as mp:
        for mod in (CS, JCS):
            def configure(n_lines, _mod=mod, _orig=mod.configure):
                _orig(n_lines)
                key = (_mod.__name__, n_lines)
                if key in cal:
                    _mod._CAL = cal[key]
                else:
                    cal[key] = _mod.calibration(probe=PROBE)

            mp.setattr(mod, "configure", configure)
        yield
    for mod in (CS, JCS):
        mod._CAL = None
        mod._FIELDS = None


@pytest.fixture(scope="module")
def raw_train(tmp_path_factory):
    raw = tmp_path_factory.mktemp("zoo_raw")
    CS.configure(LINES)
    CS.generate_raw(str(raw / "train.txt"), LINES, seed=0)
    return str(raw / "train.txt")


def test_ladder_is_the_jax_scripts():
    assert zoo.LADDER == jax_zoo.LADDER
    assert [r[0] for r in zoo.LADDER] == ["DCN", "LR", "IPNN", "DeepFM", "wide_n_deep", "FNN",
                                          "NFM", "OPNN", "AFM", "DeepMVM"]


def test_csv_view_bytes_equal_jax(tmp_path, raw_train):
    zoo.make_csv_view(raw_train, str(tmp_path / "port"))
    jax_zoo.make_csv_view(raw_train, str(tmp_path / "jax"))
    for name in ("tr.csv", "va.csv"):
        got = (tmp_path / "port" / name).read_bytes()
        assert got and got == (tmp_path / "jax" / name).read_bytes(), name
    assert sorted(os.listdir(tmp_path / "port")) == ["tr.csv", "va.csv"]


def _records():
    return {r: open(os.path.join(REPO, r), "rb").read() for r in zoo.JAX_RECORDS
            if os.path.exists(os.path.join(REPO, r))}


def test_main_trains_deepfm_and_lr_rows_on_the_jax_setup(tmp_path, monkeypatch, capsys):
    """main on a 5,000-line surrogate, DeepFM and LR on the CPU. --epochs=20:
    at one epoch DeepFM takes 17 steps of lr 1e-4 and ranks the va lines
    at chance (AUC ~0.49), so the AUC check needs the longer run. The
    feature_size and the ceiling are the JAX package's on the files the
    script wrote; a second run reads both rows back from --out."""
    before = _records()
    work, out = tmp_path / "work", str(tmp_path / "z.json")
    argv = [f"--train_lines={LINES}", "--models=DeepFM,LR", "--device=cpu", f"--out={out}",
            f"--work_dir={work}", "--test_lines=500", "--epochs=20"]
    res = zoo.main(argv)
    with open(out) as f:
        on_disk = json.load(f)
    assert on_disk == res and sorted(res["runs"]) == ["DeepFM", "LR"]
    for name, r in res["runs"].items():
        assert "error" not in r, r
        assert 0.5 <= r["auc"] <= 1.0, (name, r)
        assert r["device"] == "cpu" and r["wall_s"] > 0
    assert res["runs"]["LR"]["model"] == "wide" and res["runs"]["LR"]["optimizer"] == "wdl"
    # the JAX package's setup on the same raw files
    JCS.configure(LINES)
    info = JC.preprocess(str(work / "raw"), str(tmp_path / "jax_proc"),
                         cutoff=JCS.scaled_cutoff(LINES))
    assert res["train_lines"] == LINES
    assert res["feature_size"] == info["feature_size"]
    assert res["bayes_ceiling"] == round(JCS.bayes_ceiling(), 4)
    for name in ("feature_map", "tr.libsvm", "va.libsvm", "te.libsvm"):
        assert (work / "proc" / name).read_bytes() == (tmp_path / "jax_proc" / name).read_bytes()
    report = open(out[: -len(".json")] + ".md").read()
    assert f"feature_size {res['feature_size']:,}" in report
    for name, r in res["runs"].items():
        assert f"| {name} | {r['ref_auc']:.3f} | {r['auc']:.4f} |" in report
    # finished rows are read from --out: nothing trains again
    import tf_repos_tpu_torch.train.harness as TH

    monkeypatch.setattr(TH, "run_task", lambda cfg: pytest.fail(f"retrained {cfg.model}"))
    capsys.readouterr()
    assert zoo.main(argv) == res
    assert capsys.readouterr().out.count("[skip]") == 2
    assert _records() == before


def test_a_failing_row_is_recorded_and_the_ladder_goes_on(tmp_path, monkeypatch):
    import tf_repos_tpu_torch.train.harness as TH

    def run_task(cfg):
        if cfg.model == "fnn":
            raise FloatingPointError("loss is nan")
        return {"auc": 0.75, "loss": 0.5}

    monkeypatch.setattr(TH, "run_task", run_task)
    out = str(tmp_path / "z.json")
    res = zoo.main([f"--train_lines={LINES}", "--models=FNN,DCN", "--device=cpu", f"--out={out}",
                    f"--work_dir={tmp_path / 'work'}", "--test_lines=500"])
    assert res["runs"]["FNN"] == {"error": "FloatingPointError: loss is nan"}
    assert res["runs"]["DCN"]["auc"] == 0.75
    assert "| FNN | — | FAILED | FloatingPointError: loss is nan |" in open(
        out[: -len(".json")] + ".md").read()


def test_rows_run_with_the_jax_scripts_configs(tmp_path, monkeypatch):
    """Both scripts' main on the same work dir, each package's run_task
    recording its Config: every row runs with the same flags (all the
    fields the two Configs share; the port's --device aside)."""
    import tf_repos_tpu.train.harness as JH
    import tf_repos_tpu_torch.train.harness as TH

    ran = {"jax": {}, "port": {}}

    def recorder(side):
        def run_task(cfg):
            ran[side][cfg.model] = cfg
            return {"auc": 0.75, "loss": 0.5}
        return run_task

    monkeypatch.setattr(JH, "run_task", recorder("jax"))
    monkeypatch.setattr(TH, "run_task", recorder("port"))
    work = str(tmp_path / "work")
    argv = ["--train_lines=2000", "--test_lines=300", f"--work_dir={work}"]
    zoo.main([*argv, "--device=cpu", f"--out={tmp_path / 'port.json'}"])
    jax_zoo.main([*argv, f"--out={tmp_path / 'jax.json'}"])
    assert sorted(ran["port"]) == sorted(ran["jax"]) == sorted(r[1] for r in zoo.LADDER)
    shared = ({f.name for f in dataclasses.fields(ran["jax"]["DCN"])}
              & {f.name for f in dataclasses.fields(ran["port"]["DCN"])}) - {"device"}
    assert {"optimizer", "steps_per_dispatch", "packed_cache", "data_dir", "model_dir",
            "clear_existing_model", "learning_rate", "embedding_size"} <= shared
    for model, jc in ran["jax"].items():
        pc = ran["port"][model]
        assert {f: getattr(pc, f) for f in shared} == {f: getattr(jc, f) for f in shared}, model
        assert pc.device == "cpu"
    assert ran["port"]["wide"].data_dir == os.path.join(work, "csv")
    assert ran["port"]["DeepFM"].data_dir == os.path.join(work, "proc")


def test_work_dir_files_are_reused_only_for_the_same_lines(tmp_path, monkeypatch):
    """The default work dir lies in the temp directory, one a line count;
    files in a work dir are reused only when its stamp names the same
    --train_lines and --test_lines, else made again."""
    import tf_repos_tpu_torch.train.harness as TH

    monkeypatch.setattr(TH, "run_task", lambda cfg: {"auc": 0.75, "loss": 0.5})
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))

    def run(lines, *extra):
        zoo.main([f"--train_lines={lines}", "--test_lines=300", "--models=FNN", "--device=cpu",
                  f"--out={tmp_path / f'z{lines}.json'}", *extra])

    def made(work):
        raw = os.path.join(work, "raw", "train.txt")
        with open(raw) as f:
            n = sum(1 for _ in f)
        return n, os.stat(raw).st_mtime_ns, zoo.read_stamp(work)

    run(2000)
    work = str(tmp_path / "criteo_parity_torch_2000_300")
    n, _, stamp = made(work)
    assert n == 2000 and stamp == {"train_lines": 2000, "test_lines": 300}
    # other lines in the same work dir: made again, and stamped so
    run(3000, f"--work_dir={work}")
    n, t_made, stamp = made(work)
    assert n == 3000 and stamp == {"train_lines": 3000, "test_lines": 300}
    fs = sum(1 for _ in open(os.path.join(work, "proc", "feature_map")))
    assert json.load(open(tmp_path / "z3000.json"))["feature_size"] == fs
    # the same lines: reused as they are
    run(3000, f"--work_dir={work}")
    assert made(work) == (3000, t_made, stamp)


def test_out_never_names_the_jax_records(tmp_path):
    default = zoo.parser().get_default("out")
    assert default == "ZOO_AUC_H100.json"
    json_path, md_path = zoo.out_paths(default)
    assert (json_path, md_path) == (os.path.join(REPO, "ZOO_AUC_H100.json"),
                                    os.path.join(REPO, "ZOO_AUC_H100.md"))
    for bad in ("ZOO_AUC.json", "ZOO_AUC_45M.json", os.path.join(REPO, "ZOO_AUC.json"),
                "ZOO_AUC.md"):
        with pytest.raises(ValueError):
            zoo.out_paths(bad)
    assert zoo.out_paths(str(tmp_path / "a.json")) == (str(tmp_path / "a.json"),
                                                       str(tmp_path / "a.md"))
    # the work dir: one a line count, in the temp directory (TMPDIR)
    assert zoo.parser().get_default("work_dir") == ""
    assert zoo.work_dir_for(2_000_000, 200_000) == os.path.join(
        tempfile.gettempdir(), "criteo_parity_torch_2000000_200000")


def test_ladder_defaults_to_the_card(monkeypatch, tmp_path):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device=cpu"):
        zoo.main([f"--work_dir={tmp_path}", f"--out={tmp_path / 'z.json'}"])
    assert not os.listdir(tmp_path)
