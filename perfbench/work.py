"""The benchmark's yardstick: the card's peaks and the work of a served
batch, counted from the configuration's widths and the traffic's lengths.

This arithmetic is the benchmark's own, frozen here so that a change to
the program cannot move it.  An architecture's module
(``architectures/<name>.py``) maps its configuration's file onto
:class:`Widths` and calls these functions.  It follows the port's
``utils/op_costs`` (a product of ``(M, K)`` by ``(K, N)`` is ``2·M·K·N``
operations and moves ``M·K + K·N + M·N`` elements, each read or written
once) and its ``utils/roofline.H100`` peaks.  Everything here is plain
Python on ints.

Two counts, for two uses:

* **Served products** (:func:`served_products`): the dense products the
  serving engine asks of the GEMM kernel for one batch, at the shapes it
  serves them: every position of the padded prompt bucket in prefill, one
  row a sequence in each decode step, and the head at one position a
  sequence.  Experts' batched products and the router are not GEMM-kernel
  work and are left out.  The head counts the published vocabulary, not
  the port's padded one, so the count never exceeds what the kernel did.
* **Model work** (:func:`request_model_flops`): what a request needs of the
  model, whatever the engine pads: ``2·N_active`` a token through the
  layers, causal attention over the real context, and the head once for
  every position whose logits are used (the last prompt position and each
  decoded token).
"""

from __future__ import annotations

import dataclasses

__all__ = [
    "PEAK_FLOPS_BF16",
    "PEAK_BYTES_PER_S",
    "Widths",
    "product_bound_s",
    "served_products",
    "causal_attention_flops",
    "flash_bound_s",
    "request_model_flops",
]

#: NVIDIA H100 SXM, dense bf16 tensor-core rate and HBM3 bandwidth (the
#: data sheet; the port's ``utils/roofline.H100``), at the 700 W limit
PEAK_FLOPS_BF16 = 989e12
PEAK_BYTES_PER_S = 3.35e12
#: bytes of one bf16 element
BF16 = 2


@dataclasses.dataclass(frozen=True)
class Widths:
    """The widths of a decoder that the arithmetic needs."""

    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int  # the dense FFN's width, or one expert's
    vocab: int
    n_experts: int = 0
    experts_per_token: int = 0

    @property
    def moe(self) -> bool:
        return self.n_experts > 0

    def layer_params_active(self) -> int:
        """Weights one token multiplies in one layer (MoE: its routed
        experts and the router)."""
        d, hd = self.d_model, self.head_dim
        attn = d * (self.n_heads + 2 * self.n_kv_heads) * hd + self.n_heads * hd * d
        if self.moe:
            return attn + self.experts_per_token * 3 * d * self.d_ff + d * self.n_experts
        return attn + 3 * d * self.d_ff


def product_bound_s(m: int, k: int, n: int, elem_bytes: int = BF16) -> float:
    """The least time the card takes for one ``(m, k) @ (k, n)`` product:
    the larger of its operations at the bf16 peak and its bytes at the
    memory's peak."""
    return max(2 * m * k * n / PEAK_FLOPS_BF16,
               (m * k + k * n + m * n) * elem_bytes / PEAK_BYTES_PER_S)


def served_products(w: Widths, rows: int, bucket: int, gen: int) -> list[tuple[int, int, int]]:
    """Every dense product the engine serves one batch of ``rows``
    sequences in ``bucket`` with ``gen`` tokens each, as ``(M, K, N)``
    (repeated once per launch): prefill over all ``rows × bucket``
    positions, then ``gen - 1`` decode steps of ``rows`` rows."""
    d, hd, h, kv = w.d_model, w.head_dim, w.n_heads, w.n_kv_heads

    def layer(m: int) -> list[tuple[int, int, int]]:
        out = [(m, d, h * hd), (m, d, kv * hd), (m, d, kv * hd), (m, h * hd, d)]
        if not w.moe:
            out += [(m, d, w.d_ff), (m, d, w.d_ff), (m, w.d_ff, d)]
        return out

    prods = layer(rows * bucket) * w.n_layers + [(rows, d, w.vocab)]
    step = layer(rows) * w.n_layers + [(rows, d, w.vocab)]
    return prods + step * (gen - 1)


def causal_attention_flops(w: Widths, length: int) -> int:
    """Operations of causal attention over ``length`` positions in one
    layer: ``Q·Kᵀ`` and ``P·V`` over the ``length·(length + 1) / 2`` pairs
    a causal mask keeps, two operations a multiply-add."""
    pairs = length * (length + 1) // 2
    return 2 * 2 * w.n_heads * w.head_dim * pairs


def flash_bound_s(w: Widths, length: int) -> float:
    """The least time of one sequence's causal attention over ``length``
    real positions in one layer: operations at the bf16 peak against
    Q, K, V read and O written once."""
    nbytes = (2 * w.n_heads + 2 * w.n_kv_heads) * length * w.head_dim * BF16
    return max(causal_attention_flops(w, length) / PEAK_FLOPS_BF16,
               nbytes / PEAK_BYTES_PER_S)


def request_model_flops(w: Widths, prompt_len: int, gen: int) -> int:
    """Model operations of one request: ``prompt_len`` prompt tokens and
    ``gen - 1`` decoded ones through every layer (the last served token is
    never fed back), causal attention over each token's real context, and
    the head at the last prompt position and at each decoded token."""
    per_token = 2 * w.layer_params_active() * w.n_layers
    fed = prompt_len + gen - 1
    attn = causal_attention_flops(w, prompt_len)
    # decoded token j (1-based) attends over prompt_len + j positions
    attn += sum(4 * w.n_heads * w.head_dim * (prompt_len + j) for j in range(1, gen))
    head = 2 * w.d_model * w.vocab * gen
    return per_token * fed + attn * w.n_layers + head
