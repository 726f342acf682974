"""The port and its examples (``examples/torch/``) import neither jax nor
the JAX package, and its entry points refuse to run on a missing card
instead of falling back to the CPU."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
EXAMPLES = REPO / "examples" / "torch"

_PROBE = """
import importlib, importlib.util, pathlib, pkgutil, sys
import repro_torch, repro_torch.launch.serve_cnn, repro_torch.launch.serve
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
for f in sorted(pathlib.Path(sys.argv[1]).glob("*.py")):
    spec = importlib.util.spec_from_file_location("example_" + f.stem, f)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_import_loads_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _PROBE, str(EXAMPLES)],
                          env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_file_imports_jax_or_repro():
    files = sorted(PORT.rglob("*.py"))
    assert len(files) > 30
    assert PORT / "nn" / "mamba.py" in files
    assert PORT / "core" / "quant.py" in files
    for name in ("model.py", "engine.py", "slice_sim.py", "explore.py"):
        assert PORT / "core" / name in files
    for name in ("specs.py", "hlo_stats.py", "dryrun.py", "dryrun_cnn.py"):
        assert PORT / "launch" / name in files
    examples = sorted(EXAMPLES.glob("*.py"))
    assert [f.name for f in examples] == [
        "quickstart.py", "serve_lm.py", "train_cnn.py", "train_lm.py"]
    bad = [(str(f.relative_to(REPO)), m) for f in files + examples
           for m in _imported_modules(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad


def test_builder_without_cpu_request_raises_when_cuda_absent():
    from repro_torch.configs import CNN_SMOKES
    from repro_torch.engine import ExecutionPolicy
    from repro_torch.launch.serve_cnn import build_server
    from repro_torch.serve import ServeConfig

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_server(CNN_SMOKES["vgg16"], ExecutionPolicy(),
                     ServeConfig(buckets=(1,)))
