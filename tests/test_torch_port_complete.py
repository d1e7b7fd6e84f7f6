"""The port is complete: every module of the JAX package (``src/repro``)
has its twin under ``src/repro_torch`` at the same path, and every public
top-level name of a reference module is defined or imported in its twin,
unless :data:`NOT_PORTED` gives the reason it is not (the list
``ROADMAP.md`` keeps under "Not ported, and why").  A name the reference
gains later fails here until it is ported or given a reason; a reason
for a name the twin now has fails too.  The port, its examples and
``chip_smoke.py`` import nothing of the reference and nothing of JAX.

Sources are read with ``ast``: nothing here imports either package.

A module's public names are those it binds at top level (``def``,
``class``, an assignment, also under a top-level ``if`` or ``try``) that
do not start with ``_``; a package's ``__init__.py`` also re-exports the
names it imports; and a name imported from a module of the reference
that has no source (``repro.dist.sharding``, ``repro.dist.fault``) counts
as the importing module's own, since nothing else could give it."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF, PORT = ROOT / "src" / "repro", ROOT / "src" / "repro_torch"
#: reference modules whose twin has another name
STAND_INS = {"utils/hlo.py": "utils/op_costs.py"}

_TPU_COST = ("a TPU cost model: the port's twins are the analytical_h100 models, "
             "utils/roofline.H100 and HopperTimedCost")
_XLA_CACHE = ("the XLA executable cache: the port builds one library at first use "
              "(kernels/build.py), not one executable per state")
_TPU_MEMORY = ("models TPU memory and tiling: the port's analyzer has Hopper launch and "
               "waste rules in their place (core/analysis.py), and breakdown gives smem_bytes")
_NO_MODULE = ("imported from repro.dist.{sharding,fault}, which do not exist (reference "
              "gaps): they configure a mesh and restarts the port's one card has not")
_INIT = ("a JAX initializer: the port's init_params/init_block draw the same tree, and "
         "params_from_reference carries the reference's across")
_NN = "the networks' functional JAX layers and Adam: the port's are torch modules"

NOT_PORTED = {
    "core/__init__.py": {"AnalyticalTPUCost": _TPU_COST, "FlashAnalyticalCost": _TPU_COST,
                         "TpuSpec": _TPU_COST},
    "core/analysis.py": {"gemm_working_set_bytes": _TPU_MEMORY,
                         "flash_working_set_bytes": _TPU_MEMORY,
                         "register_padding_model": _TPU_MEMORY},
    "core/cost/__init__.py": {"AnalyticalTPUCost": _TPU_COST, "FlashAnalyticalCost": _TPU_COST,
                              "TpuSpec": _TPU_COST, "XLATimedCost": _TPU_COST,
                              "PallasInterpretCost": _TPU_COST},
    "core/cost/analytical.py": {"AnalyticalTPUCost": _TPU_COST, "TpuSpec": _TPU_COST},
    "core/cost/flash_analytical.py": {"FlashAnalyticalCost": _TPU_COST},
    "core/cost/measured.py": {"XLATimedCost": _TPU_COST, "PallasInterpretCost": _TPU_COST,
                              "ExecutableCache": _XLA_CACHE},
    "core/records.py": {"compile_cache_dir_for": _XLA_CACHE},
    "core/tuners/nn.py": dict.fromkeys(
        ["init_linear", "linear_apply", "init_mlp", "mlp_apply", "init_gru", "gru_step",
         "adam_init", "adam_update"], _NN),
    "dist/api.py": {"resolve_spec": "maps logical names onto a device mesh's axes; one card "
                                    "has no mesh (reference gap: repro.dist.sharding)"},
    "kernels/gemm.py": {"gemm_pallas": "the Pallas launch of _gemm_kernel: the port's is "
                                       "kernels/gemm.gemm_tiled over csrc/gemm.cu"},
    "launch/dryrun.py": {"shd": _NO_MODULE},
    "launch/train.py": {"StragglerWatchdog": _NO_MODULE, "run_with_restarts": _NO_MODULE},
    "train/trainer.py": {"shd": _NO_MODULE, "StragglerWatchdog": _NO_MODULE,
                         "FailureInjector": _NO_MODULE},
    "models/common.py": {"init_dense": _INIT, "init_norm": _INIT, "trunc_normal": _INIT,
                         "scan_or_unroll": "the layer lax.scan: eager PyTorch runs the stacked "
                                           "layers in a Python loop (models/transformer."
                                           "unbind_layers)"},
    "models/transformer.py": {"init_attn": _INIT, "init_mlp": _INIT, "init_moe": _INIT,
                              "moe_apply_a2a": "needs a device mesh, and has no reference that "
                                               "works (both tests/test_moe_a2a.py tests fail)"},
    "utils/roofline.py": {"V5E": _TPU_COST},
}

_FORBIDDEN_ROOTS = {"repro", "jax", "jaxlib", "flax"}


def _modules(root: pathlib.Path) -> list[str]:
    return sorted(p.relative_to(root).as_posix() for p in root.rglob("*.py"))


def _top_level(tree: ast.Module):
    """The statements a module runs at import, through top-level ``if``
    and ``try`` blocks."""
    todo = list(tree.body)
    while todo:
        node = todo.pop(0)
        if isinstance(node, ast.If):
            todo += node.body + node.orelse
        elif isinstance(node, ast.Try):
            todo += node.body + node.orelse + node.finalbody
            for handler in node.handlers:
                todo += handler.body
        else:
            yield node


def _targets(node) -> list[str]:
    if isinstance(node, ast.Name):
        return [node.id]
    if isinstance(node, (ast.Tuple, ast.List)):
        return [n for elt in node.elts for n in _targets(elt)]
    return []


def _source_of(parts: list[str]):
    """The reference's source of module ``repro.<parts>``, or None."""
    base = REF.joinpath(*parts)
    for path in (base.with_suffix(".py"), base / "__init__.py"):
        if path.exists():
            return path
    return None


def _loadable(parts: list[str], name: str) -> bool:
    """Whether ``from repro.<parts> import name`` has something to load:
    a submodule, or a name the module defines or imports."""
    if _source_of(parts + [name]) is not None:
        return True
    source = _source_of(parts)
    if source is None:
        return False
    defined, imported = _bound(ast.parse(source.read_text()))
    return name in defined or name in imported


def _imported_module(rel: str, node: ast.ImportFrom):
    """``repro``'s module path (as parts) that ``node`` imports from, or
    None for an import from outside the reference."""
    if node.level:
        package = rel.split("/")[:-1]
        parts = package[:len(package) + 1 - node.level]
        return parts + (node.module.split(".") if node.module else [])
    mod = (node.module or "").split(".")
    return mod[1:] if mod[0] == "repro" else None


def _bound(tree: ast.Module) -> tuple[set, dict]:
    """``(names defined at top level, {imported name: ImportFrom node})``."""
    defined, imported = set(), {}
    for node in _top_level(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            defined.add(node.name)
        elif isinstance(node, ast.Assign):
            defined.update(n for t in node.targets for n in _targets(t))
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
            defined.update(_targets(node.target))
        elif isinstance(node, ast.ImportFrom):
            imported.update({a.asname or a.name: node for a in node.names})
        elif isinstance(node, ast.Import):
            imported.update({(a.asname or a.name).split(".")[0]: node for a in node.names})
    return defined, imported


def _public_names(rel: str) -> set[str]:
    """The public top-level names of reference module ``rel`` (see the
    module docstring)."""
    defined, imported = _bound(ast.parse((REF / rel).read_text()))
    names = set(defined)
    for name, node in imported.items():
        if not isinstance(node, ast.ImportFrom):
            continue
        if rel.endswith("__init__.py"):
            names.add(name)
            continue
        parts = _imported_module(rel, node)
        if parts is None:
            continue
        original = next(a.name for a in node.names if (a.asname or a.name) == name)
        if not _loadable(parts, original):
            names.add(name)  # an import that has nothing to load
    return {n for n in names if not n.startswith("_")}


def _twin_names(rel: str) -> set[str]:
    defined, imported = _bound(ast.parse((PORT / STAND_INS.get(rel, rel)).read_text()))
    return defined | set(imported)


def test_every_reference_module_has_its_twin():
    missing = [rel for rel in _modules(REF) if not (PORT / STAND_INS.get(rel, rel)).exists()]
    assert missing == []
    assert set(NOT_PORTED) <= set(_modules(REF))


@pytest.mark.parametrize("rel", [r for r in _modules(REF) if r not in STAND_INS])
def test_every_public_name_is_ported_or_has_a_reason(rel):
    names, twin = _public_names(rel), _twin_names(rel)
    reasons = NOT_PORTED.get(rel, {})
    assert sorted(n for n in names - twin if n not in reasons) == [], \
        f"{rel}: port these names or give NOT_PORTED a reason"
    assert sorted(n for n in reasons if n not in names or n in twin) == [], \
        f"{rel}: these NOT_PORTED entries are ported, or no longer the reference's"
    assert all(reason.strip() for reason in reasons.values())


def test_the_stand_in_of_hlo_counts_ops_as_hlo_did():
    """``utils/hlo.py`` reads XLA's HLO text, which eager PyTorch has not;
    ``utils/op_costs.py`` counts the ops of a run in its place."""
    assert {"OpCounter", "kernel_ran"} <= _twin_names("utils/hlo.py")


def _forbidden_imports(path: pathlib.Path) -> list[str]:
    bad = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and not node.level:
            roots = [(node.module or "").split(".")[0]]
        else:
            continue
        bad += [f"{path.relative_to(ROOT)}:{node.lineno} imports {r}"
                for r in roots if r in _FORBIDDEN_ROOTS]
    return bad


def test_the_port_imports_neither_the_reference_nor_jax():
    files = sorted(PORT.rglob("*.py")) + sorted((ROOT / "examples_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > len(_modules(REF))
    assert [b for f in files for b in _forbidden_imports(f)] == []
