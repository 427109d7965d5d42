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


def test_lm_prefill_loads_no_jax_or_reference():
    """Building reduced mamba2-130m (the configs load their per-arch files
    by an importlib string, which the AST walk does not see) and running
    one prefill and one decode step on the CPU import neither JAX nor the
    JAX package."""
    code = textwrap.dedent("""
        import sys
        import torch
        from repro_torch.configs.base import get_config, reduced_config
        from repro_torch.models import model as M
        from repro_torch.train.steps import make_prefill_step, make_serve_step
        cfg = reduced_config(get_config("mamba2-130m"))
        gen = torch.Generator().manual_seed(0)
        model = M.init_params(cfg, gen, device="cpu")
        tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen)
        nxt = make_prefill_step(cfg)(model, tokens)
        cache = M.init_cache(cfg, 2, 16, device="cpu")
        tok, cache = make_serve_step(cfg)(model, cache, nxt, 0)
        assert nxt.shape == tok.shape == (2,)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        print("BAD", bad)
        sys.exit(1 if bad else 0)
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_train_path_loads_no_jax_or_reference(tmp_path):
    """The training modules (optimizer, train step, checkpoints, the
    warehouse-fed loop, optimiser-state transfer): one train step of
    reduced mamba2-130m on the CPU and a checkpoint round trip import
    neither JAX nor the JAX package."""
    code = textwrap.dedent(f"""
        import sys
        import torch
        from repro_torch.configs.base import get_config, reduced_config
        from repro_torch.distributed.checkpoint import CheckpointManager
        from repro_torch.models import model as M
        from repro_torch.train import lm_from_warehouse
        from repro_torch.train.optimizer import adamw_init, opt_state_from_jax
        from repro_torch.train.steps import make_train_step
        cfg = reduced_config(get_config("mamba2-130m"))
        gen = torch.Generator().manual_seed(0)
        model = M.init_params(cfg, gen, device="cpu")
        tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen)
        model, opt, m = make_train_step(cfg, microbatches=2)(
            model, adamw_init(model), {{"inputs": tokens, "labels": tokens}})
        ckpt = CheckpointManager({str(tmp_path)!r})
        tree = {{"params": dict(model.named_parameters()), "opt": opt}}
        ckpt.save(1, tree, blocking=False)
        ckpt.wait()
        restored, step = ckpt.restore(tree)
        assert step == 1 and torch.isfinite(m["loss"])
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        print("BAD", bad)
        sys.exit(1 if bad else 0)
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
