"""Nothing under portbench imports JAX or the JAX package, compared by
whole top-level module name (the port's package name begins with the JAX
package's), the reference imports nothing of the port, and no file reads
the JAX package's bench or its records."""

import ast
import os

from portbench import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "rfs_slam_tpu"}


def imports(path: str) -> set:
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def python_files(top: str):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_anywhere():
    for path in python_files(spec.HERE):
        assert not imports(path) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_port():
    for path in python_files(os.path.join(spec.HERE, "reference")):
        assert "rfs_slam_tpu_torch" not in imports(path), path
        assert "portbench" not in imports(path), path


def test_no_file_reads_the_jax_bench():
    words = ("bench" + ".py", "BENCH" + "_", "MULTICHIP" + "_",
             "BASELINE" + ".json")
    for path in python_files(spec.HERE):
        text = open(path).read()
        assert not any(w in text for w in words), path
