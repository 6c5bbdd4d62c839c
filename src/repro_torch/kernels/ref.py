"""Plain PyTorch oracles of the FISH and SSD kernels (exact, unblocked),
the counterparts of ``src/repro/kernels/ref.py``."""

from __future__ import annotations

import torch

__all__ = ["fish_count_ref", "fish_epoch_count_ref", "ssd_ref",
           "ssd_chunked_ref"]


def fish_count_ref(table_keys, batch_keys):
    """Oracle of ``fish_count``: the full equality matrix."""
    eq = (batch_keys[:, None] == table_keys[None, :]) \
        & (table_keys[None, :] >= 0)
    return eq.sum(0).to(torch.float32), eq.any(1)


def fish_epoch_count_ref(table_keys, table_counts, batch_keys, *,
                         alpha: float):
    """Oracle of ``fish_epoch_count``: decay + match + histogram, all as
    full equality matrices."""
    delta, matched = fish_count_ref(table_keys, batch_keys)
    a = torch.tensor(alpha, dtype=torch.float32, device=table_keys.device)
    new_counts = table_counts.to(torch.float32) * a + delta
    self_eq = batch_keys[:, None] == batch_keys[None, :]
    cand = self_eq.sum(1).to(torch.float32)
    idx = torch.arange(batch_keys.shape[0], device=batch_keys.device)
    first = ~(self_eq & (idx[None, :] < idx[:, None])).any(1)
    return new_counts, matched, cand, first


def _heads(t, h):
    return t.repeat_interleave(h // t.shape[2], dim=2)


def ssd_ref(x, a, b, c, initial_state=None):
    """Exact sequential SSD recurrence (oracle of the chunked kernels).

    x: (B, S, H, P); a: (B, S, H) log decay; b, c: (B, S, G, N).
    returns y (B, S, H, P), final_state (B, H, N, P), all float32.
    """
    bsz, s, h, p = x.shape
    n = b.shape[3]
    x, a = x.float(), a.float()
    bh, ch = _heads(b.float(), h), _heads(c.float(), h)
    state = (torch.zeros((bsz, h, n, p), dtype=torch.float32,
                         device=x.device)
             if initial_state is None else initial_state.float())
    ys = []
    for t in range(s):
        state = state * torch.exp(a[:, t])[..., None, None] \
            + bh[:, t, :, :, None] * x[:, t, :, None, :]
        ys.append(torch.einsum("bhn,bhnp->bhp", ch[:, t], state))
    return torch.stack(ys, 1), state


def ssd_chunked_ref(x, a, b, c, chunk: int, initial_state=None):
    """Chunked-math oracle (the kernels' algorithm, as einsums).  Shapes as
    in :func:`ssd_ref`; ``S`` must be a multiple of ``chunk``."""
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    nc = s // chunk
    xc = x.reshape(bsz, nc, chunk, h, p).float()
    ac = a.reshape(bsz, nc, chunk, h).float()
    bh = _heads(b.reshape(bsz * nc, chunk, g, n).float(), h).reshape(
        bsz, nc, chunk, h, n)
    ch = _heads(c.reshape(bsz * nc, chunk, g, n).float(), h).reshape(
        bsz, nc, chunk, h, n)
    a_cum = torch.cumsum(ac, dim=2)
    a_tot = a_cum[:, :, -1, :]
    decay = torch.exp(a_tot[:, :, None, :] - a_cum)
    states = torch.einsum("bcqh,bcqhn,bcqhp->bchnp", decay, bh, xc)
    prev = (torch.zeros((bsz, h, n, p), dtype=torch.float32,
                        device=x.device)
            if initial_state is None else initial_state.float())
    prevs = []
    for i in range(nc):
        prevs.append(prev)
        prev = prev * torch.exp(a_tot[:, i])[..., None, None] + states[:, i]
    prev_states = torch.stack(prevs, 1)
    mask = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    rel = a_cum[:, :, :, None, :] - a_cum[:, :, None, :, :]
    m5 = mask[None, None, :, :, None]
    l_mat = torch.where(m5, torch.exp(rel.masked_fill(~m5, 0.0)), 0.0)
    scores = torch.einsum("bcqhn,bcshn->bcqsh", ch, bh)
    y_diag = torch.einsum("bcqsh,bcshp->bcqhp", scores * l_mat, xc)
    y_off = torch.einsum("bcqhn,bcqh,bchnp->bcqhp", ch, torch.exp(a_cum),
                         prev_states)
    return (y_diag + y_off).reshape(bsz, s, h, p), prev
