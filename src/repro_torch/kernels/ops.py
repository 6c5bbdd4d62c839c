"""Public entry points of the port's kernels.

Each dispatches on the tensors' device: the CUDA kernel on a card, its
plain PyTorch version on the CPU.  ``store_probe`` is the keyed-state
probe (:mod:`.store_probe`); ``fish_count`` / ``fish_epoch_count`` the
Alg. 1 epoch pass and ``fish_epoch_update`` the whole epoch
(:mod:`.fish_count`); ``ssd_scan`` the Mamba-2 layer
scan around the SSD chunk kernels (:mod:`.ssd`).
"""

from __future__ import annotations

import torch

from . import fish_count as _fish_count
from . import ssd as _ssd
from .store_probe import store_probe

__all__ = ["fish_count", "fish_epoch_count", "fish_epoch_update",
           "ssd_scan", "store_probe"]


def fish_count(table_keys: torch.Tensor, batch_keys: torch.Tensor):
    """Epoch match-and-count: counts (K,) f32, matched (N,) bool.

    The kernel takes any table length (its tiles are masked), so the table
    is passed as it is; the reference pads it to the TPU's lane width."""
    return _fish_count.fish_count(table_keys, batch_keys)


def fish_epoch_count(table_keys: torch.Tensor, table_counts: torch.Tensor,
                     batch_keys: torch.Tensor, *, alpha: float):
    """Fused epoch pass (decay + match-count + candidate histogram), the
    ``fused_fn`` of :func:`repro_torch.core.fish.epoch_update`.  Unpadded,
    as :func:`fish_count`."""
    return _fish_count.fish_epoch_count(table_keys, table_counts,
                                        batch_keys, alpha=alpha)


def fish_epoch_update(table_keys: torch.Tensor, table_counts: torch.Tensor,
                      batch_keys: torch.Tensor, *, alpha: float,
                      max_new: int = 64, ties: str = "first"):
    """One whole Alg. 1 epoch in one launch: the new table (keys, counts).
    The ``epoch_fn`` of :func:`repro_torch.core.fish.epoch_update`; ties go
    as on the fused path (``ties="first"``) or, bound with
    ``functools.partial(..., ties="key")``, as on the match path.  Epochs
    of up to 8,192 keys, tables up to 4,480 slots at that epoch (the one
    block's shared memory, ``fish_count.check_epoch_shape``); larger ones
    raise ``ValueError``."""
    return _fish_count.fish_epoch_update(table_keys, table_counts,
                                         batch_keys, alpha=alpha,
                                         max_new=max_new, ties=ties)


def ssd_scan(x, a, b, c, *, chunk: int = 128, initial_state=None):
    """Full SSD layer scan: the two chunk kernels with the cross-chunk
    combine between them.

    x: (B, S, H, P); a: (B, S, H) log decay (<= 0); b, c: (B, S, G, N).
    returns y (B, S, H, P) f32 and final_state (B, H, N, P) f32.
    """
    # pad the sequence to a chunk multiple: zero x/b/c with zero log decay
    # leave the carried state untouched through the padding steps
    s_orig = x.shape[1]
    pad = -s_orig % chunk
    if pad:
        x, a, b, c = (torch.nn.functional.pad(
            t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in (x, a, b, c))
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    nc = s // chunk
    xc = x.reshape(bsz * nc, chunk, h, p).float()
    bc_ = b.reshape(bsz * nc, chunk, g, n).float()
    cc = c.reshape(bsz * nc, chunk, g, n).float()
    a_cum = torch.cumsum(a.reshape(bsz * nc, chunk, h).float(), dim=1)

    states, a_tot = _ssd.ssd_chunk_state(xc, bc_, a_cum)
    states = states.reshape(bsz, nc, h, n, p)
    decay = torch.exp(a_tot.reshape(bsz, nc, h))[..., None, None]
    prev_states = torch.empty_like(states)
    prev = (torch.zeros((bsz, h, n, p), dtype=torch.float32,
                        device=x.device)
            if initial_state is None else initial_state.float())
    for i in range(nc):  # the state entering each chunk
        prev_states[:, i] = prev
        prev = prev * decay[:, i] + states[:, i]

    y = _ssd.ssd_chunk_output(xc, bc_, cc, a_cum,
                              prev_states.reshape(bsz * nc, h, n, p))
    return y.reshape(bsz, s, h, p)[:, :s_orig], prev
