"""Nothing under mp3bench/ imports jax, jaxlib, flax or the JAX package
mp3tpu: every import statement's top-level name, compared whole (the
port, mp3tpu_torch, begins with the JAX package's name and is allowed);
the reference (ref/) imports nothing of the port either."""
import ast
import os

from mp3bench import harness

BANNED = {"jax", "jaxlib", "flax", "mp3tpu"}


def imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def files():
    for d, _, names in os.walk(harness.HERE):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(d, n)


def test_no_jax_anywhere():
    found = {(p, m) for p in files() for m in imports(p) if m in BANNED}
    assert not found


def test_the_reference_stands_alone():
    ref = os.path.join(harness.HERE, "ref")
    for n in os.listdir(ref):
        if n.endswith(".py"):
            assert set(imports(os.path.join(ref, n))) <= {
                "numpy", "torch", "os"}, n


def test_whole_names_are_compared():
    assert "mp3tpu_torch" not in BANNED
    assert harness.FORBIDDEN == ("jax", "jaxlib", "flax", "mp3tpu")
