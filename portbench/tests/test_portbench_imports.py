"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference side imports nothing of the port. Top-level names are compared
whole: the port's name begins with the JAX package's."""
import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "druid_tpu"}
PORT = "druid_tpu_torch"
# the side that decides `correct` and makes the load: never the port's
INDEPENDENT = ["reference.py", "roofline.py", "clients.py", "registry.py",
               "control.py", "gen"]


def _top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def _files(names):
    for n in names:
        p = HERE / n
        yield from (sorted(p.rglob("*.py")) if p.is_dir() else [p])


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_anywhere(path):
    assert not set(_top_level_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", list(_files(INDEPENDENT)),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_reference_side_imports_nothing_of_the_port(path):
    assert PORT not in set(_top_level_imports(path))


def test_names_are_compared_whole():
    from portbench import harness
    assert harness.forbidden_modules(
        ["druid_tpu_torch", "druid_tpu_torch.engine", "jaxtyping"]) == []
    assert harness.forbidden_modules(
        ["druid_tpu.engine", "jax._src", "druid_tpu_torch"]) == \
        ["druid_tpu", "jax"]
