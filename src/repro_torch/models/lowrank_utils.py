"""Small helpers shared by model layers for factored params.

``dense_kernel(params)`` is the (in, out) kernel of dense or factored
params, ``u@v + u2@v2`` (``core.lowrank.dense_equivalent``), for where a
weight takes part in something other than a matmul with the activations:
MLA's absorbed decode folds ``wkv_b`` into the query and the output.  It is
kv_lora_rank rows tall there, so building it is cheap, and it runs plain
matmuls: no nested kernel launches."""

from __future__ import annotations

from repro_torch.core.lowrank import dense_equivalent as dense_kernel

__all__ = ["dense_kernel"]
