"""PyTorch port: the package stands alone.

``repro_torch``, ``chip_smoke.py`` and ``renewal_scan_ab.py`` import
neither ``jax`` nor any part of the reference package ``repro``; every
module imports with ``jax`` made unimportable, and importing them builds no
kernel.
"""
import ast
import os
import pathlib
import subprocess
import sys
import textwrap

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts), path


def _imported_names(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_sources_import_no_jax_and_no_reference():
    files = [p for _, p in _modules()] + [ROOT / "chip_smoke.py",
                                          ROOT / "renewal_scan_ab.py"]
    for path in files:
        for name in _imported_names(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {name}"


def test_every_module_imports_without_jax():
    mods = [m for m, _ in _modules()]
    code = textwrap.dedent(f"""
        import importlib, sys
        sys.modules["jax"] = None          # any `import jax` now fails
        sys.modules["repro"] = None
        for m in {mods!r}:
            importlib.import_module(m)
        from repro_torch.kernels import _build
        assert not _build._loaded, "importing must not build kernels"
        assert "jax" not in [k for k, v in sys.modules.items() if v is not None]
        print("ok", len({mods!r}))
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(ROOT), timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
    assert len(mods) >= 13
