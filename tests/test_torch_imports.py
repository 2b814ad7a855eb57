"""Import hygiene of the PyTorch port: the package, chip_smoke.py and
the port's scripts (scripts/torch_*.py) import neither JAX nor anything
of the JAX package, checked in a fresh interpreter (this test process
has JAX loaded already) and by a scan of the sources. The scan admits
one form of the JAX package's name: a ``<package>/<file>.py:<line>``
citation of a TPU kernel's source line, which chip_smoke.py's kernel
report must name; it is a string, never an import."""

import ast
import glob
import os
import pkgutil
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "tf_repos_tpu_torch")


def _modules():
    names = ["tf_repos_tpu_torch"]
    for m in pkgutil.walk_packages([PKG], prefix="tf_repos_tpu_torch."):
        names.append(m.name)
    return sorted(names)


def _scripts():
    return sorted(glob.glob(os.path.join(REPO, "scripts", "torch_*.py")))


def _chip_smoke_imports():
    tree = ast.parse(open(os.path.join(REPO, "chip_smoke.py")).read())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            mods.add(node.module)
    return sorted(mods)


def test_modules_listed():
    mods = _modules()
    assert "tf_repos_tpu_torch.ops.sparse_rows" in mods
    assert "tf_repos_tpu_torch.ops.coo_pool" in mods
    assert "tf_repos_tpu_torch.ops.sorted_seg" in mods
    assert "tf_repos_tpu_torch.ops.row_scatter" in mods
    assert "tf_repos_tpu_torch.ops.field_block" in mods
    assert "tf_repos_tpu_torch.features.criteo" in mods
    assert "tf_repos_tpu_torch.models.esmm" in mods
    assert "tf_repos_tpu_torch.models.din" in mods
    assert "tf_repos_tpu_torch.models.wide_deep" in mods
    assert "tf_repos_tpu_torch.data.csv" in mods
    assert "tf_repos_tpu_torch.train.optimizers" in mods
    assert "tf_repos_tpu_torch.data.ragged" in mods
    assert "tf_repos_tpu_torch.train.harness" in mods
    assert "tf_repos_tpu_torch.serve.server" in mods
    assert "tf_repos_tpu_torch.serve.export" in mods
    assert "tf_repos_tpu_torch.ops.rounding" in mods
    assert "tf_repos_tpu_torch.utils.convert" in mods
    for m in ("aliccp", "criteo", "frappe", "smart", "stats"):
        assert f"tf_repos_tpu_torch.features.{m}" in mods
    for m in ("native", "pipeline", "cache", "tfrecord", "slim_wire", "criteo_surrogate"):
        assert f"tf_repos_tpu_torch.data.{m}" in mods
    for m in ("mesh", "launch", "distributed", "step", "sparse_step"):
        assert f"tf_repos_tpu_torch.parallel.{m}" in mods
    for m in ("observability", "tb_events"):
        assert f"tf_repos_tpu_torch.utils.{m}" in mods
    assert len(mods) >= 20
    assert [os.path.basename(p) for p in _scripts()] == [
        "torch_bench_serving.py", "torch_bench_serving_load.py", "torch_gate_flips.py",
        "torch_kernel_ab.py", "torch_zoo_auc.py"]


def test_import_leaves_jax_out():
    code = (
        "import importlib, importlib.util, sys\n"
        f"for m in {_modules() + _chip_smoke_imports()!r}:\n"
        "    importlib.import_module(m)\n"
        f"for i, path in enumerate({_scripts()!r}):\n"
        "    spec = importlib.util.spec_from_file_location(f'_script{i}', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'tf_repos_tpu' or m.startswith('tf_repos_tpu.'))\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr[-3000:]


def _sources():
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith((".py", ".cu", ".cuh", ".cpp")):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")
    yield from _scripts()


@pytest.mark.parametrize(
    "pattern",
    [r"\bimport\s+jax\b|\bfrom\s+jax\b", r"tf_repos_tpu(?!_torch)(?![\w/]*\.py:\d+)"],
)
def test_source_scan(pattern):
    hits = []
    for path in _sources():
        for i, line in enumerate(open(path), 1):
            if re.search(pattern, line):
                hits.append(f"{os.path.relpath(path, REPO)}:{i}: {line.strip()}")
    assert not hits, "\n".join(hits)


def test_native_build_reads_only_the_ports_sources(tmp_path, monkeypatch):
    """The g++ command of the native host input names only sources under
    tf_repos_tpu_torch/data/native_src, and writes under the build dir."""
    from tf_repos_tpu_torch.data import native

    assert os.path.realpath(native.SRC_DIR) == os.path.join(PKG, "data", "native_src")
    assert os.path.realpath(native.BUILD_DIR) == os.path.join(PKG, "_build")
    seen = []
    real_run = subprocess.run

    def spy(cmd, *a, **kw):
        seen.append(list(cmd))
        return real_run(cmd, *a, **kw)

    monkeypatch.setattr(native.subprocess, "run", spy)
    out = native.build(native.SRC_DIR, str(tmp_path))
    assert os.path.isfile(out) and len(seen) == 1
    cmd = seen[0]
    assert cmd[0] == "g++"
    inputs = [a for a in cmd if a.endswith((".cpp", ".cc", ".c", ".h", ".hpp"))]
    assert sorted(os.path.basename(a) for a in inputs) == sorted(native.SOURCES)
    for a in inputs:
        assert os.path.dirname(os.path.realpath(a)) == os.path.join(PKG, "data", "native_src")
    assert os.path.dirname(cmd[cmd.index("-o") + 1]) == str(tmp_path)
