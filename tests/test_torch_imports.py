"""The port stands alone: it imports neither JAX nor the JAX package."""
import ast
import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro", "benchmarks")


def _bad_imports(path: str):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            if _forbidden(name):
                yield f"{path}:{node.lineno}: {name}"


def test_no_jax_or_reference_imports_in_port_sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 60
    bad = [b for f in files for b in _bad_imports(f)]
    assert bad == []


def test_import_and_query_load_no_jax_or_reference(tmp_path):
    code = textwrap.dedent(f"""
        import sys
        import repro_torch.api as db
        with db.connect({str(tmp_path / 'wh')!r}, engine="auto") as conn:
            conn.execute("CREATE TABLE t (x INT, y DOUBLE)")
            conn.execute("INSERT INTO t VALUES (1, 2.5), (2, 3.5), (2, 1.0)")
            rows = conn.execute(
                "SELECT x, SUM(y) FROM t WHERE x > 0 GROUP BY x ORDER BY x"
            ).fetchall()
        assert rows == [(1, 2.5), (2, 4.5)], rows
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        print("BAD", bad)
        sys.exit(1 if bad else 0)
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_lint_is_clean():
    from repro_torch.analysis import lint_paths

    assert lint_paths([PORT]) == []
