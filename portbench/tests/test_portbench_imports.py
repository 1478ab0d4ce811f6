"""What the measuring process loads: no JAX, no JAX package (top-level names
compared whole), and a reference that takes nothing from the program."""

import ast
import subprocess
import sys

from conftest import ROOT
from portbench.harness import runner


def test_top_level_names_are_compared_whole(monkeypatch):
    for name in ("transeditor_tpu_torch", "transeditor_tpu_torch.serve",
                 "jax_like", "jaxtyping"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert runner.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "transeditor_tpu.config", sys)
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", sys)
    assert runner.forbidden_modules() == ["jaxlib", "transeditor_tpu"]


def test_a_run_loads_no_jax():
    """Everything a run imports, imported in a fresh process."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import torch\n"
        "from portbench.harness import runner, flops, train_check, program\n"
        "runner.load_file('traffic', 'gan_train')\n"
        "import pathlib\n"
        "for m in pathlib.Path(%r).glob('*.py'):\n"
        "    runner.load_file('metrics', m.name[:-3])\n"
        "import transeditor_tpu_torch.train.loop\n"
        "import transeditor_tpu_torch.train.gan\n"
        "print(runner.forbidden_modules())\n") % (
        str(ROOT), str(ROOT / "portbench" / "metrics"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_reference_imports_nothing_of_the_program():
    allowed = {"__future__", "copy", "dataclasses", "math", "typing", "torch",
               "torch.nn", "torch.nn.functional"}
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n in allowed, f"{path.name} imports {n}"


def test_no_program_file_is_named_by_the_command():
    import json
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for word in bench["command"]:
        assert not word.startswith("/") and ".." not in word
        if "/" in word:
            assert any(word.startswith(p + "/") for p in bench["paths"])
