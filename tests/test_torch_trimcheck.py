"""trimcheck's lock-ownership and silent-except passes over the port's
threaded serve layer (``src/repro_torch/serve``), ``tools/`` unchanged.

The lock map holds the port's ``Server._cv`` and ``BucketBatcher._lock``
to the JAX package's guarded names (``tools.analysis.locks.
DEFAULT_LOCK_MAP``), and the lock pass's blocking calls are extended by
torch's host syncs (``synchronize``, ``item``, ``cpu``, ``tolist``): any
of them under a lock stalls every producer thread.  The tree has no
finding; a tmp copy seeded with one violation per rule has exactly that
one, so the passes are seen to bite on the port's files.
"""
import pathlib
import shutil

import pytest

from tools.analysis import locks
from tools.analysis.core import Config, run_analysis

REPO = pathlib.Path(__file__).resolve().parent.parent
SERVE = "src/repro_torch/serve"
#: the port's threaded files, each under its JAX counterpart's contracts
PORT_LOCK_MAP = {
    f"{SERVE}/server.py": locks.DEFAULT_LOCK_MAP["src/repro/serve/server.py"],
    f"{SERVE}/batching.py":
        locks.DEFAULT_LOCK_MAP["src/repro/serve/batching.py"],
}
TORCH_SYNCS = {"synchronize", "item", "cpu", "tolist"}
RULES = ("lock-guarded-attr", "lock-wait-while", "lock-blocking-call",
         "silent-except")


@pytest.fixture
def torch_syncs(monkeypatch):
    monkeypatch.setattr(locks, "BLOCKING_NAMES",
                        locks.BLOCKING_NAMES | TORCH_SYNCS)


def _run(root: pathlib.Path):
    return run_analysis(Config(
        root=str(root), lock_map=PORT_LOCK_MAP, trace_dirs=(),
        pallas_dirs=(), hygiene_dirs=(), except_dirs=(SERVE,), docs=False))


def test_lock_map_names_the_port_classes():
    for rel, specs in PORT_LOCK_MAP.items():
        text = (REPO / rel).read_text()
        for spec in specs:
            assert f"class {spec.cls}" in text, (rel, spec.cls)
            assert f"self.{spec.lock_attr} = " in text, (rel, spec.lock_attr)
            for name in spec.guarded:
                assert f"self.{name}" in text, (rel, name)


def test_port_serve_layer_has_no_lock_or_except_findings(torch_syncs):
    findings = _run(REPO)
    assert findings == [], "\n".join(
        f"{f.path}:{f.line} {f.rule} {f.message}" for f in findings)


# one violation of each rule, appended to the copy of the file it targets
SEEDS = {
    "lock-guarded-attr": ("server.py", "Server", '''
    def _seeded_peek(self):
        return self._running
'''),
    "lock-wait-while": ("server.py", "Server", '''
    def _seeded_wait(self):
        with self._cv:
            self._cv.wait(0.1)
'''),
    "lock-blocking-call": ("batching.py", "BucketBatcher", '''
    def _seeded_sync(self):
        with self._lock:
            torch.cuda.synchronize()
'''),
    "silent-except": ("server.py", None, '''

def _seeded_swallow(fn):
    try:
        fn()
    except Exception:
        pass
'''),
}


def _seed(root: pathlib.Path, rule: str) -> None:
    name, cls, code = SEEDS[rule]
    path = root / SERVE / name
    text = path.read_text()
    if cls is None:
        text += code
    else:   # into the class body, before the next top-level statement
        start = text.index(f"\nclass {cls}")
        nxt = [i for i in (text.find("\nclass ", start + 1),
                           text.find("\ndef ", start + 1)) if i > 0]
        end = min(nxt) if nxt else len(text)
        text = text[:end].rstrip("\n") + "\n" + code + text[end:]
    path.write_text(text)


@pytest.mark.parametrize("rule", RULES)
def test_each_seeded_violation_is_found(rule, tmp_path, torch_syncs):
    shutil.copytree(REPO / SERVE, tmp_path / SERVE,
                    ignore=shutil.ignore_patterns("__pycache__"))
    assert _run(tmp_path) == []
    _seed(tmp_path, rule)
    findings = _run(tmp_path)
    assert [f.rule for f in findings] == [rule], [
        (f.path, f.line, f.rule, f.message) for f in findings]
    assert findings[0].path.startswith(SERVE)


def test_torch_syncs_are_what_the_blocking_rule_adds(tmp_path, monkeypatch):
    """Without the torch names the seeded ``synchronize`` under the lock
    passes: the extension is what makes the rule see torch's syncs."""
    shutil.copytree(REPO / SERVE, tmp_path / SERVE,
                    ignore=shutil.ignore_patterns("__pycache__"))
    _seed(tmp_path, "lock-blocking-call")
    assert _run(tmp_path) == []
    monkeypatch.setattr(locks, "BLOCKING_NAMES",
                        locks.BLOCKING_NAMES | TORCH_SYNCS)
    assert [f.rule for f in _run(tmp_path)] == ["lock-blocking-call"]
