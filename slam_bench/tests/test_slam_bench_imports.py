"""Nothing the benchmark's command runs imports JAX or the JAX package,
and the reference imports nothing of the port: each module's top-level
name is compared whole (the port's name begins with the JAX package's)."""

import ast
import glob
import os

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
JAX_PKG = "orb_slam3_detailed_comments_kor_tpu"
PORT = JAX_PKG + "_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", JAX_PKG}


def imported(path):
    """Every module name that ``path`` imports, anywhere in the file."""
    names = []
    for node in ast.walk(ast.parse(open(path).read(), path)):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
            names += [f"{node.module}.{a.name}" for a in node.names]
    return names


def module_file(name):
    """The benchmark's own file for a module name, or None."""
    if name.split(".")[0] != "slam_bench":
        return None
    base = os.path.join(ROOT, *name.split("."))
    for cand in (base + ".py", os.path.join(base, "__init__.py")):
        if os.path.exists(cand):
            return cand
    return None


def reachable():
    """Files reachable from run.py, plus the modules it loads by name
    (every generator and metric reader) and the control script."""
    todo = [os.path.join(BENCH, "run.py"), os.path.join(BENCH, "control.py")]
    todo += glob.glob(os.path.join(BENCH, "generators", "*.py")) + glob.glob(os.path.join(BENCH, "metrics", "*.py"))
    seen = set()
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        for name in imported(path):
            f = module_file(name)
            if f:
                todo.append(f)
    return seen


def test_nothing_reachable_imports_jax_or_the_jax_package():
    files = reachable()
    assert os.path.join(BENCH, "sut.py") in files and os.path.join(BENCH, "harness.py") in files
    bad = [(os.path.relpath(f, ROOT), n) for f in files for n in imported(f) if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_the_port_is_imported_and_compared_whole():
    # the port's top-level name is not the JAX package's
    names = {n.split(".")[0] for n in imported(os.path.join(BENCH, "sut.py"))}
    assert PORT in names and JAX_PKG not in names


def test_reference_imports_nothing_of_the_port():
    files = glob.glob(os.path.join(BENCH, "reference", "*.py"))
    assert files
    bad = [(os.path.relpath(f, ROOT), n) for f in files for n in imported(f)
           if n.split(".")[0] in FORBIDDEN | {PORT}]
    assert not bad, bad


def test_only_sut_imports_the_port():
    files = reachable()
    users = sorted(os.path.relpath(f, BENCH) for f in files
                   if any(n.split(".")[0] == PORT for n in imported(f)))
    assert users == ["sut.py"], users
