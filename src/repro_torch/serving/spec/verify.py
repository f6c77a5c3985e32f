"""Device-side speculative verification: batched accept/resample.

Plain torch functions on whole (B, ...) tensors: no per-row Python loop and
no host sync, shared by ``make_spec_verify_step`` (launch/steps.py) and the
distribution tests, which pin the statistical guarantee (temperature > 0
rejection sampling preserves the target distribution, Leviathan et al.
2023) on ``verify_tail`` directly.

Chunk indexing (K = number of draft proposals):

    chunk fed to the target = [t0, d_1, ..., d_K]        (B, K+1) tokens
    target logits L_i at chunk index i = distribution of the token AFTER
    the prefix ending at chunk[i]; so P_{i-1} = softmax(L_{i-1}/tau) is the
    target distribution d_i is judged against, and q[i-1] (0-based) is the
    draft distribution d_i was sampled from.

Acceptance: greedy rows (temp <= 0) accept d_i iff argmax(L_{i-1}) == d_i
(exact prefix match: token-identical to plain greedy decoding by
induction).  Temperature rows accept d_i with probability
min(1, P_{i-1}(d_i)/q_{i-1}(d_i)), drawn as u * q < p to avoid the divide.
After the accepted prefix of length m: a rejection resamples from
norm(max(P_m - q_m, 0)) (P_m when that sum is 0); a full window (m ==
min(K, k_row), no rejection) samples the bonus token from P_m directly --
the k_row cutoff is a scheduling decision, not a rejection, so the
residual would bias it.

Random draws come from the port's counter-hash stream (``launch/steps``),
not threefry: a row's K uniforms at its key's draw counter c and the
resample's Gumbel noise (V values) at c + 1, after which the counter
advances by 2.  So a row's draws depend only on (seed, uid, prompt), the
invariant the reference pins.
"""

from __future__ import annotations

import torch

from repro_torch.launch.steps import _uniform


def _advance(key_data: torch.Tensor, n: int) -> torch.Tensor:
    """Key data with its draw counter advanced by ``n`` (a new tensor)."""
    return torch.stack([key_data[:, 0], key_data[:, 1] + n], dim=1)


def verify_tail(key_data, logits, q_probs, proposals, temps, k_row):
    """Batched accept/resample over a verification chunk.

    key_data: (B, 2) int64, logits: (B, K+1, V) target logits over
    [t0, d_1..d_K], q_probs: (B, K, V) draft probs, proposals: (B, K),
    temps: (B,), k_row: (B,) per-row speculation window (1..K).

    Returns (new key_data, m (B,) int32 accepted counts, t_new (B,) int32
    the correction or bonus token, out_tokens (B, K+1) int32 the committed
    token matrix [d_1..d_m, t_new, <t_new fill>]).
    """
    b, k = proposals.shape
    vocab = logits.shape[-1]
    d = proposals.long()
    kr = k_row.long()
    sampled = temps > 0
    greedy_tok = torch.argmax(logits, dim=-1)  # (B, K+1)
    p = torch.softmax(logits.float() / temps.clamp(min=1e-6)[:, None, None], dim=-1)

    u = _uniform(key_data, k)  # (B, K)
    p_d = p[:, :k].gather(2, d[..., None])[..., 0]  # P_{i-1}(d_i)
    q_d = q_probs.gather(2, d[..., None])[..., 0]  # q_{i-1}(d_i)
    ar = torch.arange(k, device=logits.device)
    acc = torch.where(sampled[:, None], u * q_d < p_d, greedy_tok[:, :k] == d)
    acc = acc & (ar[None, :] < kr[:, None])
    m = torch.cumprod(acc.long(), dim=1).sum(dim=1)  # accepted prefix length

    def row(t, i):  # t[r, i[r]] over the last axis's rows: (B, V)
        return t.gather(1, i[:, None, None].expand(b, 1, vocab))[:, 0]

    p_m = row(p, m)  # target dist after the accepted prefix
    q_m = row(q_probs, m.clamp(max=k - 1))  # draft dist of the REJECTED position
    resid = (p_m - q_m).clamp(min=0.0)
    resid = torch.where(resid.sum(-1, keepdim=True) > 0, resid, p_m)  # numerical guard
    full = m == kr.clamp(max=k)  # window exhausted, no rejection event
    dist = torch.where(full[:, None], p_m, resid)
    gumbel = -torch.log(-torch.log(_uniform(_advance(key_data, 1), vocab)))
    drawn = torch.argmax(torch.log(dist.double() + 1e-30) + gumbel, dim=-1)
    t_new = torch.where(sampled, drawn, greedy_tok.gather(1, m[:, None])[:, 0]).to(torch.int32)

    idx = torch.arange(k + 1, device=logits.device)[None, :]
    padded = torch.cat([proposals, proposals[:, -1:]], dim=1).to(torch.int32)
    out_tokens = torch.where(idx < m[:, None], padded, t_new[:, None])
    return _advance(key_data, 2), m.to(torch.int32), t_new, out_tokens
