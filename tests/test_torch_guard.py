"""The port stands alone: nothing under flowmirror_hydravox_tpu_torch/ (its
preprocess/ stages, its trainers and its tools among them) and nothing in
chip_smoke.py imports jax or the JAX package, nor a library the GPU machine
lacks (`optax`, `datasets`, `matplotlib`, `safetensors`; `pyarrow` only in
`shard_list_iterator`'s parquet branch, where its ImportError is the
refusal)."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flowmirror_hydravox_tpu")
ABSENT_ON_CARD = ("optax", "datasets", "matplotlib", "safetensors", "pyarrow")
SOURCES = sorted((ROOT / "flowmirror_hydravox_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(tree: ast.AST):
    """(module name, line) of every import in `tree`."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module, node.lineno
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value), node.lineno


def _imported_modules(path: pathlib.Path):
    for name, _ in _imports(ast.parse(path.read_text(), filename=str(path))):
        yield name


def _parquet_branch_lines(tree: ast.AST) -> set:
    """The lines of the body of the `.parquet` branch of
    `shard_list_iterator` (train/data.py)."""
    lines = set()
    for fn in ast.walk(tree):
        if isinstance(fn, ast.FunctionDef) and fn.name == "shard_list_iterator":
            for node in ast.walk(fn):
                if isinstance(node, ast.If) and ".parquet" in ast.unparse(node.test):
                    for stmt in node.body:
                        lines.update(range(stmt.lineno, stmt.end_lineno + 1))
    return lines


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    assert path.exists(), path
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_package_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flowmirror_hydravox_tpu', 'optax'):\n"
        "    sys.modules[name] = None\n"
        "import importlib, pkgutil\n"
        "import flowmirror_hydravox_tpu_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "for name in ('runtime.server', 'runtime.continuous', 'runtime.profiling',\n"
        "             'runtime.streaming', 'preprocess.resample', 'preprocess.vad',\n"
        "             'preprocess.vad_model', 'preprocess.asr_model', 'preprocess.transcribe',\n"
        "             'preprocess.extract_tokens', 'preprocess.merge', 'train.augment',\n"
        "             'train.train_frontend', 'train.train_vad', 'train.train_asr',\n"
        "             'tools.eval_frontend_real', 'tools.make_demo_samples', 'tools.loadgen',\n"
        "             'tools.bench_serving', 'runtime.webui', 'utils.i18n'):\n"
        "    assert 'flowmirror_hydravox_tpu_torch.' + name in mods, name\n"
        "print(len(mods))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 15


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_library_absent_on_the_card(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    allowed = (_parquet_branch_lines(tree)
               if path == ROOT / "flowmirror_hydravox_tpu_torch" / "train" / "data.py" else set())
    bad = [(m, line) for m, line in _imports(tree) if m.split(".")[0] in ABSENT_ON_CARD
           and not (m.split(".")[0] == "pyarrow" and line in allowed)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_pyarrow_only_in_the_parquet_branch():
    """train/data.py keeps its parquet branch, and its one pyarrow import
    lies there."""
    path = ROOT / "flowmirror_hydravox_tpu_torch" / "train" / "data.py"
    tree = ast.parse(path.read_text(), filename=str(path))
    allowed = _parquet_branch_lines(tree)
    found = [line for m, line in _imports(tree) if m.split(".")[0] == "pyarrow"]
    assert allowed and found and set(found) <= allowed
