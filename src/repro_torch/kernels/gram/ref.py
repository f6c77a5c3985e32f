"""Plain PyTorch versions of the calibration Gram: fp32 ``X^T X`` over the
flattened rows of x, plus the per-channel sum |x| (and the same per expert
of a batch).  Full fp32: TF32 must be
off on the card (``calib.gram.calibration_precision``).  Also the scale of
the per-element check that holds the kernels to it."""

import torch


def gram_accumulate_ref(x: torch.Tensor):
    """x (..., n) -> (G (n, n) fp32, sum |x| (n,) fp32)."""
    flat = x.reshape(-1, x.shape[-1]).float()
    return flat.T @ flat, flat.abs().sum(0)


def gram_accumulate_batched_ref(buf: torch.Tensor):
    """buf (E, C, n) -> (G (E, n, n) fp32, sum |x| (E, n) fp32) per expert."""
    b = buf.float()
    return torch.bmm(b.transpose(1, 2), b), b.abs().sum(1)


def _wide(t: torch.Tensor) -> torch.dtype:
    """fp64 for an fp64 Gram (the fp32 gate's reference), else fp32."""
    return torch.promote_types(t.dtype, torch.float32)


def gram_elem_scale(g: torch.Tensor) -> torch.Tensor:
    """sqrt(G_ii G_jj) for every (i, j): the natural scale of a Gram entry.
    By Cauchy-Schwarz it bounds sum_k |x_ki x_kj|, so any summation-order
    error of entry (i, j) over R rows is at most this times gamma_R.  A
    batch of Grams (E, n, n) scales each by its own diagonal."""
    d = torch.diagonal(g, dim1=-2, dim2=-1).to(_wide(g)).clamp_min(0).sqrt()
    return d[..., :, None] * d[..., None, :]


def gram_elem_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Max over entries of |got - want| / sqrt(want_ii want_jj) (0 where
    both are 0, as in a channel that is all zeros), in fp64 when want is
    fp64, else in fp32."""
    diff = (got.to(_wide(want)) - want.to(_wide(want))).abs()
    return float((diff / gram_elem_scale(want).clamp_min(1e-30)).max())
