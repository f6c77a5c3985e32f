"""Plain PyTorch version of the nested low-rank matmul."""

import torch


def nested_lowrank_matmul_ref(x, u, v, u2, v2):
    y = torch.matmul(torch.matmul(x, u), v)
    return y + torch.matmul(torch.matmul(x, u2), v2)
