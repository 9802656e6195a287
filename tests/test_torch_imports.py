"""The port (``src/repro_torch``) and ``chip_smoke.py`` stand alone: they
import neither JAX nor any module of the reference package ``repro``."""
import ast
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        parts = path.relative_to(ROOT / "src").with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_importing_the_whole_port_leaves_jax_out():
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.') or k == 'repro' or k.startswith('repro.'))\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         cwd=str(ROOT))
    assert res.returncode == 0, res.stderr


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_port_file_imports_repro_or_jax():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 30
    bad = {str(f.relative_to(ROOT)): sorted(set(_imported_roots(f))
                                             & {"repro", "jax", "jaxlib"})
           for f in files}
    assert not {f: r for f, r in bad.items() if r}


def test_dynamic_config_import_points_at_the_port():
    from repro_torch.configs import ARCH_IDS, get_config
    for arch in ARCH_IDS:
        assert type(get_config(arch)).__module__ == "repro_torch.configs.base"


def test_kernels_import_nothing_above_them():
    """The kernel layer sits under the model, the dispatcher and the
    runtime: no module of ``kernels/`` imports theirs, at the top or inside
    a function."""
    above = ("models", "launch", "runtime", "core")
    files = sorted((PORT / "kernels").glob("*.py"))
    assert len(files) > 5
    bad = {}
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module] + [f"{node.module}.{alias.name}"
                                         for alias in node.names]
            else:
                continue
            hits = [m for m in names if m.split(".")[:2] in
                    [["repro_torch", a] for a in above]]
            if hits:
                bad.setdefault(path.name, []).extend(hits)
    assert not bad, bad
