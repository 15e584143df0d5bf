"""The port stands alone: no JAX and nothing of the reference package.

Every module of ``repro_torch`` and ``chip_smoke.py`` must import in a
process where ``jax`` and ``repro`` cannot be imported at all, and an AST
scan shows that no file of the port names either.  ``chip_smoke.py`` must
fail, printing no result line, on a host without a CUDA device and in a
directory that holds nothing else of the repository.
"""
import ast
import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SMOKE = ROOT / "chip_smoke.py"
FORBIDDEN = ("jax", "jaxlib", "repro")


def port_modules():
    return sorted(["repro_torch"] + [
        m.name for m in pkgutil.walk_packages([str(PORT)], "repro_torch.")])


def port_files():
    return sorted(PORT.rglob("*.py")) + [SMOKE]


def test_port_has_the_slice_modules():
    mods = set(port_modules())
    for name in ("utils.misc", "core.schema", "core.pattern", "core.parser",
                 "core.matcher", "core.optimizer", "graphops.csr",
                 "core.graph", "kernels.ops", "kernels.ref", "kernels.build",
                 "core.executor", "core.plan", "core.maintenance",
                 "core.views", "data.synthetic", "configs.mv4pg", "interop"):
        assert f"repro_torch.{name}" in mods, name
    assert (PORT / "kernels" / "csrc" / "block_spmm.cu").is_file()


@pytest.mark.parametrize("path", port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_imports_jax_or_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names = [str(node.args[0].value)]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, \
                f"{path.relative_to(ROOT)}:{node.lineno} imports {name}"


_BLOCKED = """
import importlib, importlib.util, sys
for name in {forbidden!r}:
    sys.modules[name] = None          # any import of these raises
for name in {modules!r}:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", {smoke!r})
spec.loader.exec_module(importlib.util.module_from_spec(spec))
loaded = sorted(m for m in sys.modules if m.split(".")[0] in {forbidden!r}
                and sys.modules[m] is not None)
assert not loaded, loaded
print("IMPORTED", len({modules!r}))
"""


def test_every_module_imports_without_jax():
    mods = port_modules()
    code = _BLOCKED.format(forbidden=FORBIDDEN, modules=mods,
                           smoke=str(SMOKE))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert f"IMPORTED {len(mods)}" in out.stdout


def _run_smoke(cwd: Path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, env=env,
                          timeout=300)


def _assert_no_result(out):
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _assert_no_result(_run_smoke(ROOT))


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(SMOKE, tmp_path / "chip_smoke.py")
    _assert_no_result(_run_smoke(tmp_path))


def test_chip_smoke_phases_rehearse_on_cpu():
    """The smoke's session phases, at a tiny scale on the host: every check
    they make (views on == off, kernel session == segment session, views
    consistent after CE/DE/DV) runs here with the plain kernel version."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke", SMOKE)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.snb_phase(0.02, device="cpu")["nodes"] > 0
    assert smoke.finbench_phase(0.02, device="cpu") == {
        "max_memory_allocated": None}
