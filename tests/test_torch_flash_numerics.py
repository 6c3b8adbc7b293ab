"""The rounding of the bf16 tensor-core flash kernels (K4, K5), on the CPU.

On the card, bf16 inputs take the tensor-core route of
``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu``: the products of bf16
values are exact in f32, so the scores and dP = do v^T differ from the
plain versions only in summation order, and the one new rounding is of
the products' operands: P to bf16 before P V (K4), and P and dS to bf16
before dv = P^T do, dq = dS k and dk = dS^T q (K5). This file's own
helpers repeat that arithmetic (the forward's online softmax over 64-key
tiles, P rounded against the running max of its tile, as in the kernel)
and hold it to the plain versions ``ref.flash_attention_fwd`` / ``_bwd``
run in f32 on the same bf16 values, so that the only difference is that
rounding. Bounds, relative to the largest |o| or |gradient|:

- forward: 2.5e-3, a quarter of the card gate (1e-2,
  ``tests/test_torch_cuda.py``);
- backward: 5e-3, half the card gate. The rounding of P and dS moves the
  gradients by up to ~3.6e-3 of their largest entry at these shapes: each
  gradient sums up to S rounded terms, while o is a P-weighted mean.

The forward helper is also held to the JAX model's bf16 attention
(``repro.models.attention.flash_attention`` with 64-row blocks, which
rounds P the same way before its P V): it must be at least as close to it
as the f32-P plain version is.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.models.attention import flash_attention as jax_flash_attention
from repro_torch.kernels import ref

NEG_INF = -1e30
TILE = 64  # kv rows of a step of the tensor-core forward
BF16 = torch.bfloat16

# tests/test_torch_cuda.py's FLASH_SHAPES with S cut to <= 256 (hd 8 ... 256,
# S off the 64- and 128-row tiles, Sq != Skv both ways, Sq = 1), then the
# main paths' head widths: smollm-135m's 64 and zamba2-7b's 112
SHAPES = [
    (4, 64, 64, 16, True), (2, 48, 80, 32, False), (3, 33, 33, 8, True),
    (1, 128, 128, 64, True), (2, 96, 32, 16, False),
    (3, 100, 100, 64, True), (2, 200, 200, 112, True),
    (2, 130, 257, 112, False), (2, 70, 70, 128, True), (1, 90, 50, 128, True),
    (2, 65, 65, 256, False), (3, 1, 70, 112, False), (2, 256, 256, 112, True),
    (2, 129, 129, 64, True), (2, 255, 129, 40, True),
    (2, 129, 255, 40, False), (1, 1, 9, 8, False), (2, 255, 255, 256, True),
    (2, 256, 256, 64, True),
]


def _inputs(bh, sq, skv, hd):
    rng = np.random.default_rng(bh * 1000 + sq + hd)
    q, k, v = (torch.as_tensor(rng.normal(size=(bh, s, hd)),
                               dtype=torch.float32).to(BF16)
               for s in (sq, skv, skv))
    do = torch.as_tensor(rng.normal(size=(bh, sq, hd)),
                         dtype=torch.float32).to(BF16)
    return q, k, v, do


def _scores(q, k, causal):
    s = q.float() @ k.float().transpose(1, 2) * q.shape[-1] ** -0.5
    if causal:
        keep = (torch.arange(q.shape[1])[:, None]
                >= torch.arange(k.shape[1])[None, :])
        s = torch.where(keep, s, NEG_INF)
    return s


def tc_fwd(q, k, v, causal):
    """K4's tensor-core arithmetic: f32 scores of the bf16 inputs, the
    online softmax over 64-key tiles, P rounded to bf16 against its tile's
    running max as the operand of P V, l and the accumulator in f32.
    Returns (o f32, lse)."""
    s_all = _scores(q, k, causal)
    bh, sq, hd = q.shape
    m = torch.full((bh, sq, 1), NEG_INF)
    l = torch.zeros((bh, sq, 1))
    acc = torch.zeros((bh, sq, hd))
    vf = v.float()
    for k0 in range(0, k.shape[1], TILE):
        s = s_all[:, :, k0:k0 + TILE]
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + p.to(BF16).float() @ vf[:, k0:k0 + TILE]
        m = m_new
    return acc / l, (m + torch.log(l))[..., 0]


def tc_bwd(q, k, v, o, lse, do, causal):
    """K5's tensor-core arithmetic: P from the f32 scores and lse, dP and
    dsum in f32, dS = P (dP - dsum) scale; P and dS rounded to bf16 as the
    operands of dv = P^T do, dq = dS k, dk = dS^T q, summed in f32."""
    qf, kf, vf, of, dof = (t.float() for t in (q, k, v, o, do))
    p = torch.exp(_scores(q, k, causal) - lse[..., None])
    dsum = (dof * of).sum(-1, keepdim=True)
    ds = p * (dof @ vf.transpose(1, 2) - dsum) * q.shape[-1] ** -0.5
    pb, dsb = p.to(BF16).float(), ds.to(BF16).float()
    return dsb @ kf, dsb.transpose(1, 2) @ qf, pb.transpose(1, 2) @ dof


def _rel_err(got, want) -> float:
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    return err / scale if scale else err


@pytest.mark.parametrize("bh,sq,skv,hd,causal", SHAPES)
def test_tc_forward_rounding_within_a_quarter_of_the_card_gate(
        bh, sq, skv, hd, causal):
    q, k, v, _ = _inputs(bh, sq, skv, hd)
    o, lse = tc_fwd(q, k, v, causal)
    o_r, lse_r = ref.flash_attention_fwd(q.float(), k.float(), v.float(),
                                         causal=causal)
    assert _rel_err(o, o_r) <= 2.5e-3
    torch.testing.assert_close(lse, lse_r, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bh,sq,skv,hd,causal", SHAPES)
def test_tc_backward_rounding_within_half_the_card_gate(
        bh, sq, skv, hd, causal):
    q, k, v, do = _inputs(bh, sq, skv, hd)
    o, lse = ref.flash_attention_fwd(q, k, v, causal=causal)
    got = tc_bwd(q, k, v, o, lse, do, causal)
    want = ref.flash_attention_bwd(q.float(), k.float(), v.float(),
                                   o.float(), lse, do.float(), causal=causal)
    for g, w in zip(got, want):
        assert _rel_err(g, w) <= 5e-3


@pytest.mark.parametrize("bh,sq,skv,hd,causal", SHAPES)
def test_tc_forward_is_as_close_to_the_jax_bf16_attention(
        bh, sq, skv, hd, causal):
    q, k, v, _ = _inputs(bh, sq, skv, hd)
    # (BH, S, hd) as JAX's (B, S, H, hd) with one head, in bf16
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)[
        :, :, None, :] for t in (q, k, v))
    want = np.asarray(jax_flash_attention(
        jq, jk, jv, causal=causal, q_block=TILE, kv_block=TILE
    ).astype(jnp.float32))[:, :, 0]
    o_tc = tc_fwd(q, k, v, causal)[0].to(BF16).float().numpy()
    o_plain = ref.flash_attention_fwd(q, k, v, causal=causal)[0].float()
    err_tc = np.abs(o_tc - want).max()
    err_plain = np.abs(o_plain.numpy() - want).max()
    assert err_tc <= err_plain, (err_tc, err_plain)


@pytest.mark.parametrize("bh,sq,skv,hd,causal", SHAPES)
def test_plain_bf16_p_option_is_the_tc_arithmetic(bh, sq, skv, hd, causal):
    """``ref.flash_attention_fwd/_bwd(bf16_p=True)``, the plain versions'
    like-for-like option, is the tensor-core arithmetic of the helpers
    above, up to f32 summation order."""
    q, k, v, do = _inputs(bh, sq, skv, hd)
    qf, kf, vf = q.float(), k.float(), v.float()
    o, lse = ref.flash_attention_fwd(qf, kf, vf, causal=causal, bf16_p=True)
    o_tc, lse_tc = tc_fwd(q, k, v, causal)
    assert _rel_err(o, o_tc) <= 1e-5
    torch.testing.assert_close(lse, lse_tc, rtol=1e-5, atol=1e-5)
    o_r, lse_r = ref.flash_attention_fwd(q, k, v, causal=causal)
    got = ref.flash_attention_bwd(qf, kf, vf, o_r.float(), lse_r,
                                  do.float(), causal=causal, bf16_p=True)
    want = tc_bwd(q, k, v, o_r, lse_r, do, causal)
    for g, w in zip(got, want):
        assert _rel_err(g, w) <= 1e-5
