"""Where attention's probabilities P are rounded: the reference's Pallas
kernel multiplies V by float32 P, and so does the port's plain version.

The Pallas kernel casts v to float32 before ``p.astype(v.dtype)``, so that
cast keeps float32 even on bfloat16 inputs. The port's tensor-core kernel
rounds P to bfloat16 before P V (wgmma's A operand is bfloat16): that is
the port's own choice, not the reference's, and the card holds it to the
plain version by relative norm (5e-3, ``ATTN_REL`` in chip_smoke.py).

On the CPU, on bfloat16 inputs: the Pallas kernel in interpret mode must
agree with the plain version far more closely than with the same
computation rounding P to bfloat16, which lives only in this test.

JAX and the reference package are imported inside a fixture only.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref

# relative norm ||a - b|| / ||b|| of bfloat16 outputs. Both sides keeping
# P in float32 differ only where a float32 sum order moves an output's
# bfloat16 rounding (read: ~2e-5); rounding P to bfloat16 (2^-9 relative
# a probability) moves ~a third of the outputs (read: ~2e-3).
SAME_P_REL = 1e-4
P_ROUNDING_REL = 5e-4


@pytest.fixture(scope="module")
def pallas_flash():
    pytest.importorskip("jax")
    from repro.kernels.flash_attention import flash_attention
    return flash_attention


def _mask(sq, skv, window):
    qpos = torch.arange(sq)[:, None] + (skv - sq)
    kpos = torch.arange(skv)[None, :]
    keep = kpos <= qpos
    if window is not None:
        keep &= kpos > qpos - window
    return keep


def _plain_p_bf16(q, k, v, *, window=None):
    """The plain version (causal) with P rounded to bfloat16 before P V,
    the denominator summing the float32 P: the tensor-core kernel's
    arithmetic, up to its per-tile running max."""
    b, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    qf = q.float().reshape(b, hkv, hq // hkv, sq, dh)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float()) * dh ** -0.5
    logits = logits.masked_fill(~_mask(sq, skv, window), float("-inf"))
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    out = torch.einsum("bhgqk,bhkd->bhgqd", p.bfloat16().float(), v.float())
    out = out / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return out.reshape(b, hq, sq, dh).to(q.dtype)


def _rel(a, b):
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm()).item()


@pytest.mark.parametrize("b,hq,hkv,s,dh,window", [
    (1, 4, 1, 128, 256, 48),     # MQA, dh 256, window (recurrentgemma)
    (1, 4, 2, 128, 128, None),   # GQA, dh 128 (the dense LMs)
    (2, 4, 4, 64, 64, None),     # MHA, dh 64 (minicpm-2b, musicgen)
])
def test_pallas_kernel_keeps_p_in_float32(pallas_flash, b, hq, hkv, s, dh,
                                          window):
    import jax.numpy as jnp
    r = np.random.default_rng(s + dh)
    q, k, v = (torch.from_numpy(r.standard_normal(shape).astype(np.float32))
               .bfloat16() for shape in ((b, hq, s, dh), (b, hkv, s, dh),
                                         (b, hkv, s, dh)))
    pallas = torch.from_numpy(np.asarray(pallas_flash(
        *(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v)),
        causal=True, window=window, bq=32, bk=32, interpret=True),
        np.float32))
    plain = ref.flash_attention(q, k, v, causal=True, window=window)
    rounded = _plain_p_bf16(q, k, v, window=window)
    same, other = _rel(pallas, plain), _rel(pallas, rounded)
    assert same <= SAME_P_REL, f"Pallas vs float32-P plain: {same:.3e}"
    assert other >= P_ROUNDING_REL, f"Pallas vs bf16-P plain: {other:.3e}"
    assert other >= 10 * same, (same, other)
