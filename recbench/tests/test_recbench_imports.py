"""What the harness and the reference load: no JAX and no JAX package
(top-level module names compared whole, so ``repro_torch`` is not
``repro``), and nothing of the program in the reference."""

import json
import subprocess
import sys
import textwrap

from _recbench_tiny import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def loaded_after(code: str, cwd) -> set:
    script = textwrap.dedent(f"""
        import json, sys
        sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}, {str(ROOT / 'recbench/tests')!r}]
    """) + textwrap.dedent(code) + "\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    out = subprocess.run([sys.executable, "-c", script], cwd=cwd, capture_output=True, text=True,
                         timeout=300, env={"PATH": "/usr/bin:/bin", "RECROSS_VALIDATE": "0"})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax(tmp_path):
    top = loaded_after("""
        from pathlib import Path
        from _recbench_tiny import make_root, run_tiny
        root = make_root(Path.cwd())
        line, _ = run_tiny(root, "tiny.cooc", traced=True)
        assert line["correct"], line
    """, tmp_path)
    assert "repro_torch" in top and "torch" in top
    assert not top & FORBIDDEN, top & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program(tmp_path):
    top = loaded_after("import recbench.reference", tmp_path)
    assert not top & (FORBIDDEN | {"repro_torch"}), top


def test_forbidden_names_are_compared_whole():
    from recbench import run

    assert run.forbidden_modules(["repro_torch", "repro_torch.core", "reprox", "jaxtyping"]) == []
    assert run.forbidden_modules(["repro.core", "jax", "flax.linen"]) == ["flax", "jax", "repro"]


def test_nothing_reads_the_old_benchmark_folder():
    old = "bench" + "marks"
    for path in (ROOT / "recbench").rglob("*.py"):
        text = path.read_text()
        assert f"import {old}" not in text and f"from {old}" not in text, path
        assert f"{old}/" not in text and "BENCH" + "_" not in text, path
