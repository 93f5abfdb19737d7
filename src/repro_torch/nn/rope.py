"""Rotary position embeddings: standard RoPE and Qwen2-VL's M-RoPE.

M-RoPE splits the head_dim/2 frequency bands into sections (temporal,
height, width); each section takes its rotation angle from the matching
row of a 3-row position-id tensor. Text tokens carry identical (t, h, w)
ids, which makes M-RoPE degenerate to RoPE for them.
"""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float,
               device: torch.device | str | None = None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, H, S, Dh); positions: (B, S) int. Rotates in float32 and
    returns x's dtype."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)            # (Dh/2,)
    ang = positions[:, None, :, None].float() * freqs           # (B,1,S,Dh/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: tuple[int, ...]) -> torch.Tensor:
    """x: (B, H, S, Dh); positions3: (3, B, S) int; ``sections`` sum to
    Dh/2. Rotates in float32 and returns x's dtype."""
    dh = x.shape[-1]
    if sum(sections) != dh // 2:
        raise ValueError(f"M-RoPE sections {sections} do not sum to head "
                         f"dim / 2 = {dh // 2}")
    freqs = rope_freqs(dh, theta, x.device)                     # (Dh/2,)
    # each band of frequencies takes its angle from its own position row
    # (sliced, not indexed: an index tensor would be a host-to-device
    # copy, which waits for the card, at every call)
    ang, lo = [], 0
    for row, n in enumerate(sections):
        ang.append(positions3[row][:, None, :, None].float()
                   * freqs[lo:lo + n])
        lo += n
    ang = torch.cat(ang, dim=-1)                                # (B,1,S,Dh/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
