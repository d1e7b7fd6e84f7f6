"""Device meshes — the twin of the JAX package's ``launch/mesh.py``.

The reference builds a 16 x 16 (or 2 x 16 x 16) mesh of TPU chips and
production sharding rules for it.  The port runs on one card, where no
mesh exists (``dist/api.mesh_context`` takes only ``None``), and the
reference's own sharding rules (``repro.dist.sharding``) do not exist
either, so a multi-card mesh has nothing to read.  These functions keep
the reference's names: the single-card mesh is ``None``, and any other
mesh raises.  Nothing in the port calls them: the dry run's only mesh
is ``single`` and needs no mesh object.  They stand for the reference's
API and its tests' twins.
"""

from __future__ import annotations

from repro_torch.dist.api import MeshRules

__all__ = ["make_production_mesh", "rules_for_mesh", "make_local_mesh"]

_NO_MESH = ("the port runs on one card and has no device mesh: a multi-card mesh needs "
            "the sharding rules of the reference's dist.sharding, which does not exist")


def make_production_mesh(*, multi_pod: bool = False):
    """The single-card dry run's mesh: ``None``.  ``multi_pod`` raises."""
    if multi_pod:
        raise ValueError(_NO_MESH)
    return None


def rules_for_mesh(mesh, sequence_parallel: bool = True) -> MeshRules:
    """One card shards nothing: the identity rules."""
    return MeshRules()


def make_local_mesh(data: int = 1, model: int = 1):
    """``None`` for the one-card ``(1, 1)`` mesh; any other shape raises."""
    if (data, model) != (1, 1):
        raise ValueError(f"mesh ({data}, {model}): {_NO_MESH}")
    return None
