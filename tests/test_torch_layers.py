"""The layering of ``bodge_tpu_torch/ops``, read from the sources with ``ast``:
the kernel modules import nothing above them, the module-level imports form
no cycle, the sweep layer imports at module level only, and the sweeps that
take a halo exchange (``ring``) live in ``bodge_tpu_torch.parallel``."""

import ast
import pathlib

import pytest

OPS = pathlib.Path(__file__).resolve().parents[1] / "bodge_tpu_torch" / "ops"
KERNEL_MODULES = ("cuda_ell", "cuda_gather", "cuda_filter", "cuda_probes")
ABOVE_KERNELS = ("bodge_tpu_torch.ops.cuda_spmm", "bodge_tpu_torch.ops.chebyshev", "bodge_tpu_torch.ops.lanczos",
                 "bodge_tpu_torch.hamiltonian", "bodge_tpu_torch.parallel", "bodge_tpu_torch.models")


def _trees():
    return {path.stem: ast.parse(path.read_text(), filename=str(path)) for path in sorted(OPS.glob("*.py"))}


def _imported(node) -> list:
    """Dotted names of the modules an import statement in ``bodge_tpu_torch.ops`` loads."""
    if isinstance(node, ast.Import):
        return [alias.name for alias in node.names]
    base = "bodge_tpu_torch.ops".split(".")
    base = base[:len(base) - node.level + 1] if node.level else []
    module = ".".join(base + ([node.module] if node.module else []))
    if node.module:
        return [module]
    return [f"{module}.{alias.name}" for alias in node.names]  # ``from . import x``: x is a module


def _module_level_imports(tree) -> set:
    return {name for node in tree.body if isinstance(node, (ast.Import, ast.ImportFrom)) for name in _imported(node)}


def _cycle(graph: dict):
    """A cycle of ``graph`` as a list of nodes, or ``None``."""
    state = {}

    def visit(node, path):
        state[node] = "open"
        for nxt in graph[node]:
            if state.get(nxt) == "open":
                return path[path.index(nxt):] + [nxt]
            if nxt not in state:
                found = visit(nxt, path + [nxt])
                if found:
                    return found
        state[node] = "done"
        return None

    for node in graph:
        if node not in state:
            found = visit(node, [node])
            if found:
                return found
    return None


def check_no_cycle(trees):
    prefix = "bodge_tpu_torch.ops."
    graph = {name: {m[len(prefix):] for m in _module_level_imports(tree) if m.startswith(prefix)} & set(trees)
             for name, tree in trees.items()}
    assert _cycle(graph) is None, f"module-level imports among ops/ form a cycle: {_cycle(graph)}"


def check_kernels_import_nothing_above(trees):
    for name in KERNEL_MODULES:
        above = sorted(m for m in _module_level_imports(trees[name])
                       if any(m == a or m.startswith(a + ".") for a in ABOVE_KERNELS))
        assert not above, f"ops/{name}.py imports {above} at module level"


def check_sweep_layer_imports_at_module_level(trees):
    local = sorted({inner.lineno for node in ast.walk(trees["cuda_spmm"])
                    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                    for inner in ast.walk(node) if isinstance(inner, (ast.Import, ast.ImportFrom))})
    assert not local, f"ops/cuda_spmm.py imports inside functions at lines {local}"


def check_no_ring_parameter(trees):
    takers = [f"{name}.{node.name}" for name, tree in trees.items() for node in ast.walk(tree)
              if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
              and "ring" in {a.arg for a in node.args.posonlyargs + node.args.args + node.args.kwonlyargs}]
    assert not takers, f"functions of ops/ take a halo exchange: {takers}"


@pytest.mark.parametrize("check", [check_no_cycle, check_kernels_import_nothing_above,
                                   check_sweep_layer_imports_at_module_level, check_no_ring_parameter],
                         ids=lambda check: check.__name__)
def test_ops_layering(check):
    check(_trees())
