"""Plain PyTorch versions of the nested low-rank matmul: the single form
and the batched (per-expert) form."""

import torch


def nested_lowrank_matmul_ref(x, u, v, u2, v2):
    y = torch.matmul(torch.matmul(x, u), v)
    return y + torch.matmul(torch.matmul(x, u2), v2)


def nested_lowrank_matmul_batched_ref(x, u, v, u2, v2):
    """x (E, C, K), u (E, K, k1), v (E, k1, N), u2 (E, K, k2), v2 (E, k2, N)
    -> (E, C, N)."""
    y = torch.bmm(torch.bmm(x, u), v)
    return y + torch.bmm(torch.bmm(x, u2), v2)
