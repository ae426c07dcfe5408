"""What the port imports: no module of JAX, flax or the JAX package, neither
when its modules are imported nor inside any function of its sources or of
``chip_smoke.py``."""

import ast
import pathlib
import subprocess
import sys
from torch_cases import one_torch_thread  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "flax", "mumpy_tpu")


def test_port_imports_no_jax():
    """Importing every module of the port loads none of jax, flax or the JAX
    package (the serving CLI imports the data pipeline only when it runs)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import mumpy_tpu_torch\n"
        "for m in pkgutil.walk_packages(mumpy_tpu_torch.__path__, 'mumpy_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'flax', 'mumpy_tpu'))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_port_sources_name_no_jax_module():
    """Every import statement in the port's sources and in chip_smoke.py,
    at any depth (the serving CLI once imported the JAX package's data
    pipeline inside ``main``), names no module of JAX, flax or the JAX
    package."""
    files = sorted((ROOT / "mumpy_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}:{node.lineno} {n}" for n in names
                    if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad
