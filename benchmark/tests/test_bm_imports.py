"""Nothing under benchmark/ imports JAX, Flax or the JAX package, by
top-level name compared whole (tf_repos_tpu_torch is not tf_repos_tpu):
by a scan of the sources, and in a process that runs a cell."""

import ast
import json
import os
import subprocess
import sys
import textwrap

from bm_util import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "tf_repos_tpu"}


def imported_tops(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0]


def test_no_source_imports_jax_or_the_jax_package():
    found = {}
    for d, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                tops = set(imported_tops(os.path.join(d, f))) & FORBIDDEN
                if tops:
                    found[os.path.join(d, f)] = tops
    assert not found
    assert "tf_repos_tpu_torch" in set(imported_tops(os.path.join(BENCH, "program.py")))


def test_a_run_loads_no_jax_module():
    code = textwrap.dedent(f'''
        import json, sys
        sys.path.insert(0, {ROOT!r}); sys.path.insert(0, {os.path.join(BENCH, "tests")!r})
        import torch
        from bm_util import tiny_cell
        from benchmark import harness
        harness.run(tiny_cell("din.train.aliccp"), 3, 0.2, True, torch.device("cpu"),
                    harness.process_start_s())
        print(json.dumps(harness.forbidden_modules()))
        print(json.dumps(sorted(m for m in sys.modules if m.startswith("tf_repos_tpu"))))
    ''')
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-3000:]
    bad, loaded = (json.loads(x) for x in out.stdout.strip().splitlines()[-2:])
    assert bad == []
    assert loaded and all(m.split(".")[0] == "tf_repos_tpu_torch" for m in loaded)
