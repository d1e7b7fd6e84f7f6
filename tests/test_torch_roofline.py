"""The port's roofline and the dry run's pure parts held against the JAX
package's, for all 40 (arch x shape) cells and all ten archs.

``repro.launch.dryrun`` cannot be imported (it imports
``repro.dist.sharding``, which does not exist), so its depth helpers,
extrapolation and analytic attention term are taken from its source:
the function definitions are compiled on their own, unchanged.  The
reference's ``V5E`` spec is handed to the port's ``roofline_from_costs``
as a duck-typed input.  Abstract trees: the port's ``meta`` tensors
against the reference's ``jax.eval_shape`` trees, path for path, shape
and type (the cache's ``len`` is int64 in the port, a device-side index
that torch's indexing takes as int64, int32 in the reference).  Every
comparison is exact: the same formulas on the same integers."""

import ast
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeSpec as RefShapeSpec
from repro.configs.registry import get_arch as ref_get_arch
from repro.configs.registry import get_shape as ref_get_shape
from repro.models.api import Model as RefModel
from repro.utils.roofline import V5E
from repro.utils.roofline import model_flops as ref_model_flops
from repro.utils.roofline import roofline_from_costs as ref_roofline
from repro_torch.configs.registry import ARCHS, SHAPES, get_arch, get_shape
from repro_torch.launch import dryrun, mesh
from repro_torch.models.api import Model
from repro_torch.utils.roofline import H100, model_flops, roofline_from_costs
from repro_torch.utils.tree import tree_paths

REF_DRYRUN = os.path.join(os.path.dirname(__file__), "..", "src", "repro", "launch",
                          "dryrun.py")
CELLS = [(a, s) for a in ARCHS for s in SHAPES]


def _reference_functions(*names) -> dict:
    """The named top-level functions of the reference's dry run, compiled
    from its source without importing the module."""
    with open(REF_DRYRUN) as f:
        tree = ast.parse(f.read())
    body = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name in names]
    ns = {"dataclasses": dataclasses, "ShapeSpec": RefShapeSpec}
    exec(compile(ast.Module(body, []), REF_DRYRUN, "exec"), ns)
    assert set(names) <= set(ns)
    return ns


REF = _reference_functions("_depth_variant", "_depth_units", "analytic_chunked_attn_flops",
                           "_extrapolate")


def _ref_tree(tree) -> dict:
    return {"/".join(str(k.key) for k in path): (tuple(x.shape), np.dtype(x.dtype).name)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_tree(tree) -> dict:
    return {path: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for path, t in tree_paths(tree)}


@pytest.mark.parametrize("arch,shape", CELLS, ids=[f"{a}-{s}" for a, s in CELLS])
def test_cell_matches_reference(arch, shape):
    """model_flops bit for bit, the analytic attention term, supports_shape
    and the batch specs (names, shapes, types) of every cell."""
    cfg, shp = get_arch(arch), get_shape(shape)
    rcfg, rshp = ref_get_arch(arch), ref_get_shape(shape)
    assert model_flops(cfg, shp) == ref_model_flops(rcfg, rshp)
    assert dryrun.analytic_chunked_attn_flops(cfg, shp) == \
        REF["analytic_chunked_attn_flops"](rcfg, rshp)
    model, ref = Model(cfg, device="meta"), RefModel(rcfg)
    assert model.supports_shape(shp) == ref.supports_shape(rshp)
    specs = model.batch_specs(shp)
    assert all(t.device.type == "meta" for t in specs.values())
    assert _port_tree(specs) == _ref_tree(ref.batch_specs(rshp))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_depth_variants_match_reference(arch):
    cfg, rcfg = get_arch(arch), ref_get_arch(arch)
    assert dryrun._depth_units(cfg) == REF["_depth_units"](rcfg)
    for units in (1.0, 2.0):
        got = dataclasses.asdict(dryrun._depth_variant(cfg, units))
        assert got.pop("layer_pattern") == ""  # the port's own field, empty in the registry
        assert got == dataclasses.asdict(REF["_depth_variant"](rcfg, units))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_abstract_params_match_reference(arch):
    """Leaf paths, shapes and types at full size; nothing is allocated."""
    params = Model(get_arch(arch), device="meta").abstract_params()
    assert all(t.device.type == "meta" for _, t in tree_paths(params))
    ref = RefModel(ref_get_arch(arch)).abstract_params()
    assert _port_tree(params) == _ref_tree(ref)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_abstract_cache_matches_reference(arch):
    """The decode_32k cache (128 x 32768 deep) of every arch; a model on
    the card asks for the same meta tree."""
    shp = get_shape("decode_32k")
    cache = Model(get_arch(arch), device="meta").abstract_cache(shp.global_batch, shp.seq_len)
    ref = RefModel(ref_get_arch(arch)).abstract_cache(shp.global_batch, shp.seq_len)
    got, want = _port_tree(cache), _ref_tree(ref)
    assert got.pop("len") == ((), "int64") and want.pop("len") == ((), "int32")
    assert got == want


ROOFLINE_CASES = [
    (3.2e14, 7.1e11, {}, 1, 1.9e14),
    (1.0e12, 4.0e12, {"all-reduce": {"count": 3, "operand_bytes": 2e9, "result_bytes": 2e9},
                      "total_operand_bytes": 2e9}, 256, 5.0e13),
    (5.5e13, 1.0e9, {"all-gather": {"count": 1, "operand_bytes": 4e10, "result_bytes": 6e11},
                     "reduce-scatter": {"count": 2, "operand_bytes": 1e10, "result_bytes": 1e9},
                     "all-to-all": {"count": 1, "operand_bytes": 3e9, "result_bytes": 3e9},
                     "collective-permute": {"count": 1, "operand_bytes": 1e8,
                                            "result_bytes": 1e8},
                     "total_operand_bytes": 5.31e10}, 512, 1.1e16),
    (0.0, 0.0, {"total_operand_bytes": 0}, 1, 0.0),
]


@pytest.mark.parametrize("case", range(len(ROOFLINE_CASES)))
def test_roofline_terms_match_reference_field_for_field(case):
    """The reference's V5E given as ``hw``: every field equal."""
    flops, nbytes, coll, chips, mf = ROOFLINE_CASES[case]
    got = roofline_from_costs(flops, nbytes, coll, chips, mf, hw=V5E())
    assert got.as_dict() == ref_roofline(flops, nbytes, coll, chips, mf, hw=V5E()).as_dict()
    h = roofline_from_costs(flops, nbytes, coll, chips, mf)  # the H100 default
    assert h.compute_s == flops / 989e12 and h.memory_s == nbytes / 3.35e12


def test_extrapolate_matches_reference():
    rng = np.random.default_rng(0)

    def measurement():
        coll = {k: {"count": int(rng.integers(0, 9)), "operand_bytes": float(rng.integers(0, 1e9)),
                    "result_bytes": float(rng.integers(0, 1e9))}
                for k in ("all-reduce", "all-gather")}
        coll["total_operand_bytes"] = sum(v["operand_bytes"] for v in coll.values())
        return {"flops": float(rng.integers(1, 1e15)), "bytes": float(rng.integers(1, 1e12)),
                "collectives": coll}

    for u_full in (1.0, 32.0, 38 / 6):
        m1, m2 = measurement(), measurement()
        assert dryrun._extrapolate(m1, m2, 1.0, 2.0, u_full) == \
            REF["_extrapolate"](m1, m2, 1.0, 2.0, u_full)


def test_h100_figures_by_card_name():
    assert H100() == H100(peak_flops=989e12, hbm_bw=3.35e12, ici_bw=450e9, hbm_bytes=80e9)
    assert H100.for_device("NVIDIA H100 80GB HBM3") == H100()
    pcie = H100.for_device("NVIDIA H100 PCIe")
    assert (pcie.peak_flops, pcie.hbm_bw) == (756e12, 2.0e12)
    h200 = H100.for_device("NVIDIA H200")
    assert (h200.peak_flops, h200.hbm_bw, h200.hbm_bytes) == (989e12, 4.8e12, 141e9)


def test_one_card_has_no_mesh():
    assert mesh.make_production_mesh() is None and mesh.make_local_mesh(1, 1) is None
    with pytest.raises(ValueError, match="dist.sharding"):
        mesh.make_production_mesh(multi_pod=True)
    with pytest.raises(ValueError, match="dist.sharding"):
        mesh.make_local_mesh(2, 4)
    assert mesh.rules_for_mesh(None) == mesh.MeshRules()
    with pytest.raises(ValueError, match="one card"):
        dryrun.run_cell("yi-6b", "decode_32k", "multi", out_dir="/nonexistent")


def test_abstract_params_draw_nothing():
    """The meta tree comes from ``init_params`` with a CPU generator,
    which it leaves untouched: nothing is drawn on meta."""
    gen = torch.Generator().manual_seed(3)
    state = gen.get_state()
    Model(get_arch("yi-6b").reduced(), device="meta").init_params(generator=gen)
    assert torch.equal(gen.get_state(), state)
