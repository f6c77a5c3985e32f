"""Plain PyTorch version of the calibration Gram: fp32 ``X^T X`` over the
flattened rows of x, plus the per-channel sum |x|.  Full fp32: TF32 must be
off on the card (``calib.gram.calibration_precision``)."""

import torch


def gram_accumulate_ref(x: torch.Tensor):
    """x (..., n) -> (G (n, n) fp32, sum |x| (n,) fp32)."""
    flat = x.reshape(-1, x.shape[-1]).float()
    return flat.T @ flat, flat.abs().sum(0)
