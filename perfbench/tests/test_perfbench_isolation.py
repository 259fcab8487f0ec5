"""Nothing under perfbench/ imports JAX or the JAX package (compared by
whole top-level name: the port's name begins with the JAX package's),
and the reference imports nothing of the program."""

import ast
import pathlib

HERE = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    out = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out.extend(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and not node.level:
            out.append(node.module or "")
    return [m.split(".")[0] for m in out]


def test_no_jax_or_jax_package():
    files = sorted(HERE.rglob("*.py"))
    assert len(files) > 20
    bad = {str(f.relative_to(HERE)): sorted(set(_imports(f)) & FORBIDDEN)
           for f in files}
    assert not {k: v for k, v in bad.items() if v}


def test_reference_imports_nothing_of_the_program():
    for f in sorted((HERE / "reference").rglob("*.py")):
        tops = set(_imports(f))
        assert not tops & {"repro_torch", "perfbench"}, f
        assert tops <= {"__future__", "math", "torch"}, (f, tops)


def test_no_file_reads_the_old_benchmarks_folder():
    for f in sorted(HERE.rglob("*.py")):
        assert "benchmarks" not in set(_imports(f)), f
