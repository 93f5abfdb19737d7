"""Rotary position embeddings (standard RoPE; Qwen2-VL's M-RoPE is not
ported yet, ROADMAP.md Queue 1 item 7.5)."""
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
