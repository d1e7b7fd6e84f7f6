"""Roofline math for the dry run, on one NVIDIA Hopper card — the twin of
the JAX package's ``utils/roofline.py``, which holds a TPU's constants.

Three terms, all in seconds, from the work a traced step counts
(``utils/op_costs.py``):

  compute   = FLOPs_per_device / peak_FLOP/s
  memory    = bytes_per_device / HBM_bw
  collective= wire_bytes_per_device / link_bw      (ring factors applied)

The port runs on one card, so the counts are the device's own and the
collective term is 0 (no collective is dispatched); the ring factors and
the term are kept so a record reads as the reference's does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["H100", "RooflineTerms", "roofline_from_costs", "model_flops"]


@dataclasses.dataclass(frozen=True)
class H100:
    """One H100 SXM (NVIDIA's data sheet): the dense bf16 tensor-core peak,
    the HBM3 rate and size, and NVLink's rate a direction.  The field
    names are the reference's, so either spec reads the same way."""

    peak_flops: float = 989e12  # dense bf16 FLOP/s
    hbm_bw: float = 3.35e12  # B/s
    ici_bw: float = 450e9  # NVLink B/s each way (900 GB/s both)
    hbm_bytes: float = 80e9

    @classmethod
    def for_device(cls, name: Optional[str] = None) -> "H100":
        """The data sheet's figures for the card named ``name`` (the
        current card's name when None): the H100 PCIe's or the H200's where
        the name says so, else the H100 SXM's."""
        if name is None:
            import torch

            name = torch.cuda.get_device_name(0)
        if "PCIe" in name:
            return cls(peak_flops=756e12, hbm_bw=2.0e12, ici_bw=300e9)
        if "H200" in name:
            return cls(hbm_bw=4.8e12, hbm_bytes=141e9)
        return cls()


# ring-algorithm wire factors (fraction of payload actually serialized
# on the slowest link): all-reduce moves ~2x the shard, gather/scatter ~1x
_WIRE_FACTOR = {
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_device: float
    bytes_per_device: float
    wire_bytes_per_device: float
    model_flops: float  # 6·N·D (or serve-step equivalent)
    useful_ratio: float  # model_flops / (flops_per_device × chips)
    dominant: str

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def roofline_from_costs(
    flops_per_device: float,
    bytes_per_device: float,
    collective: dict,
    chips: int,
    mflops: float,
    hw=H100(),
) -> RooflineTerms:
    """The three terms of one step's counted work on ``chips`` devices of
    ``hw`` (anything with ``peak_flops``, ``hbm_bw`` and ``ici_bw``)."""
    wire = 0.0
    for kind, factor in _WIRE_FACTOR.items():
        st = collective.get(kind)
        if st:
            wire += factor * st["operand_bytes"]
    compute_s = flops_per_device / hw.peak_flops
    memory_s = bytes_per_device / hw.hbm_bw
    collective_s = wire / hw.ici_bw
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    dominant = max(terms, key=terms.get)
    total_flops = flops_per_device * chips
    return RooflineTerms(
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        flops_per_device=flops_per_device,
        bytes_per_device=bytes_per_device,
        wire_bytes_per_device=wire,
        model_flops=mflops,
        useful_ratio=(mflops / total_flops) if total_flops else 0.0,
        dominant=dominant,
    )


def model_flops(cfg, shape) -> float:
    """The reference's model flops: 6·N·D for training (N = params, MoE:
    active params), 2·N·D for a forward-only prefill, 2·N per token for
    decode (D = tokens processed in the step).  N includes the embedding
    table and no attention term is added."""
    n = cfg.n_active_params()
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        return 2.0 * n * tokens
    # decode: one token per sequence in the batch
    return 2.0 * n * shape.global_batch
