"""CPU parity of the port's K5 (flash-attention backward) plain version
with the JAX package's Pallas backward kernels, run in interpret mode;
``FlashAttention``'s gradient against autograd of the dense formula; and
the rule that no kernel path cuts an autograd graph silently.

The same numpy inputs go to both packages. K5's tolerance is the JAX
test's own (tests/test_kernels.py::test_flash_bwd_kernels): rtol 1e-3,
atol 2e-3.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.flash import flash_attention_bwd as jax_flash_bwd
from repro_torch.configs import get_config
from repro_torch.kernels import flash, ops, ref
from repro_torch.models import LM
from repro_torch.models.attention import FlashAttention, flash_attention

# (BH, Sq, Skv, hd, causal): tests/test_kernels.py's three, then hd 64 and
# 112 with S off a tile, and non-causal Skv != Sq
BWD_SHAPES = [
    (2, 64, 64, 16, True), (1, 48, 80, 32, False), (2, 33, 33, 8, True),
    (2, 70, 70, 64, True), (1, 50, 50, 112, True), (2, 40, 90, 64, False),
    (1, 45, 20, 112, False),
]


def _dense_np(q, k, v, causal):
    """o and lse of the dense formula, in float64 then f32."""
    hd = q.shape[-1]
    s = np.einsum("bqh,bkh->bqk", q.astype(np.float64),
                  k.astype(np.float64)) / np.sqrt(hd)
    if causal:
        s = np.where(np.arange(q.shape[1])[:, None]
                     >= np.arange(k.shape[1])[None], s, -1e30)
    m = s.max(-1, keepdims=True)
    e = np.exp(s - m)
    lse = (m + np.log(e.sum(-1, keepdims=True)))[..., 0]
    o = np.einsum("bqk,bkh->bqh", e / e.sum(-1, keepdims=True), v)
    return o.astype(np.float32), lse.astype(np.float32)


def _bwd_inputs(bh, sq, skv, hd, causal):
    rng = np.random.default_rng(bh * 1000 + sq + hd)
    q = rng.normal(size=(bh, sq, hd)).astype(np.float32)
    k = rng.normal(size=(bh, skv, hd)).astype(np.float32)
    v = rng.normal(size=(bh, skv, hd)).astype(np.float32)
    do = rng.normal(size=(bh, sq, hd)).astype(np.float32)
    o, lse = _dense_np(q, k, v, causal)
    return q, k, v, o, lse, do


@pytest.mark.parametrize("bh,sq,skv,hd,causal", BWD_SHAPES)
def test_flash_bwd_plain_matches_jax_kernel(bh, sq, skv, hd, causal):
    args = _bwd_inputs(bh, sq, skv, hd, causal)
    want = jax_flash_bwd(*(jnp.asarray(a) for a in args), causal=causal,
                         q_block=16, kv_block=32, interpret=True)
    got = ops.flash_attention_bwd(*args, causal=causal, device="cpu")
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3,
                                   atol=2e-3, err_msg=name)


def test_flash_bwd_plain_keeps_bf16():
    args = [torch.as_tensor(a).to(torch.bfloat16)
            for a in _bwd_inputs(2, 33, 33, 16, True)]
    args[4] = args[4].float()  # lse stays f32
    dq, dk, dv = ops.flash_attention_bwd(*args, causal=True, device="cpu")
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    want = ops.flash_attention_bwd(*(a.float() for a in args), causal=True,
                                   device="cpu")
    for g, w in zip((dq, dk, dv), want):
        torch.testing.assert_close(g.float(), w, rtol=1e-2, atol=1e-2)


def test_flash_bwd_plain_chunked_rows_change_nothing(monkeypatch):
    args = [torch.as_tensor(a) for a in _bwd_inputs(3, 100, 100, 64, True)]
    g1 = ref.flash_attention_bwd(*args, causal=True)
    monkeypatch.setattr(ref, "_CHUNK_ELEMS", 3 * 100 * 7)  # 7 rows a chunk
    g2 = ref.flash_attention_bwd(*args, causal=True)
    # the same formula per row; dk and dv add the chunks in f32
    for a, b in zip(g1, g2):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def _dense_attention(q, k, v, causal):
    """(B, S, H, hd) attention by the plain formula, GQA by
    repeat_interleave, differentiable by autograd."""
    rep = q.shape[2] // k.shape[2]
    k = torch.repeat_interleave(k, rep, dim=2)
    v = torch.repeat_interleave(v, rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / q.shape[-1] ** 0.5
    if causal:
        mask = (torch.arange(q.shape[1])[:, None]
                >= torch.arange(k.shape[1])[None])
        s = torch.where(mask, s, -1e30)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)


@pytest.mark.parametrize("B,S,Skv,H,KV,hd,causal", [
    (2, 40, 40, 4, 2, 16, True), (1, 33, 33, 9, 3, 64, True),
    (2, 24, 50, 4, 1, 32, False),
])
def test_flash_attention_grad_matches_dense_autograd(B, S, Skv, H, KV, hd,
                                                     causal):
    rng = np.random.default_rng(B + S + H)
    mk = lambda *shape: torch.tensor(  # noqa: E731
        rng.normal(size=shape).astype(np.float32), requires_grad=True)
    q, k, v = mk(B, S, H, hd), mk(B, Skv, KV, hd), mk(B, Skv, KV, hd)
    do = torch.as_tensor(rng.normal(size=(B, S, H, hd)).astype(np.float32))
    o = flash_attention(q, k, v, causal=causal)
    got = torch.autograd.grad(o, (q, k, v), do)
    o_r = _dense_attention(q, k, v, causal)
    want = torch.autograd.grad(o_r, (q, k, v), do)
    torch.testing.assert_close(o, o_r, rtol=1e-5, atol=1e-5)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def test_flash_attention_saves_no_score_matrix():
    """The Function keeps (q, k, v, o, lse): O(S * hd), never (S, S)."""
    q, k, v = (torch.randn(1, 64, 2, 8, requires_grad=True)
               for _ in range(3))
    o = flash_attention(q, k, v, causal=True)
    node = o.grad_fn
    while type(node).__name__ != "FlashAttentionBackward":
        node = node.next_functions[0][0]
    saved = node.saved_tensors
    assert len(saved) == 5
    assert max(t.numel() for t in saved) == 2 * 64 * 8


def test_bwd_is_counted_and_refuses_cpu_tensors():
    assert "flash_attention_bwd" in ops.launch_counts()
    ops.reset_launches()
    assert ops.launch_counts()["flash_attention_bwd"] == 0
    args = [torch.as_tensor(a) for a in _bwd_inputs(1, 8, 8, 16, True)]
    with pytest.raises(ValueError, match="CUDA"):
        flash.flash_attention_bwd(*args)


def test_kernel_paths_refuse_to_cut_a_graph(monkeypatch):
    """Under grad mode, a kernel path given an input that requires grad
    raises instead of returning a result with no graph; without grad it
    goes on to the kernel's wrapper (which refuses a CPU tensor here)."""
    monkeypatch.setattr(ops, "_use_ref", lambda t, force: False)
    rng = np.random.default_rng(0)
    xbar = torch.tensor(rng.normal(size=(2, 16, 8)).astype(np.float32),
                        requires_grad=True)
    loga = torch.full((2, 16), -0.1)
    B = torch.as_tensor(rng.normal(size=(2, 16, 4)).astype(np.float32))
    with pytest.raises(RuntimeError, match="cut silently"):
        ops.ssd_intra_chunk(xbar, loga, B, B, device="cpu")
    with torch.no_grad():
        with pytest.raises(ValueError, match="CUDA"):
            ops.ssd_intra_chunk(xbar, loga, B, B, device="cpu")
    q = torch.randn(2, 8, 16, requires_grad=True)
    with pytest.raises(RuntimeError, match="cut silently"):
        ops.flash_attention_fwd(q, q, q, device="cpu")
    with pytest.raises(RuntimeError, match="cut silently"):
        ops.pairwise_sqdist(q[0], q[1], device="cpu")
    # FlashAttention runs its forward with grad mode off: the guard lets it
    # through to the wrapper
    with pytest.raises(ValueError, match="CUDA"):
        FlashAttention.apply(q, q, q, True, None)


@pytest.mark.parametrize("arch", ["zamba2-7b", "mamba2-2.7b"])
def test_loss_raises_for_families_without_a_backward(arch):
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    lm = LM(cfg)
    params = lm.init(0, device="cpu")
    toks = torch.zeros((1, 8), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="ROADMAP.md step 13.2"):
        lm.loss(params, toks)
