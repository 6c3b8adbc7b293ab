"""LM assembly for every family of the reference (dense, audio, moe, ssm,
hybrid, vlm), and their training loss.

Reference: ``repro/models/model.py`` (``layer_plan`` :50, ``block_init``
:106, ``block_apply_full`` :205, ``block_apply_decode`` :293, ``LM`` :339,
``LM.loss`` :431, ``init_caches`` :517, ``active_param_count`` :588).
A model is a sequence of segments; each segment is ``count`` identical
blocks whose parameters are stacked on a leading axis, exactly the
reference's parameter tree (so ``convert.lm_params_from_arrays`` carries a
JAX tree across leaf by leaf). The reference's ``lax.scan`` and
``fori_loop`` over a segment become Python loops over its blocks, and
the reference's ``jax.checkpoint(body)`` per block (:413-414) is
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)`` per block
when ``forward(remat=True)`` runs under grad mode; the checkpointed
function returns the block's aux with its output, so remat changes no
loss.

Training: ``LM.loss`` is differentiable for every family. The kernels sit
behind ``torch.autograd.Function``s: K4 with its backward K5
(``attention.FlashAttention``, causal self-attention and the vlm's
non-causal cross attention), K6 with its backward K6b
(``mamba.SSDIntraChunk``). The MoE dispatch (``moe.moe_apply``) is plain
torch, differentiated by autograd. The hybrid family's shared attention
block is one set of weights used once a super block; autograd sums its
gradient over the uses, as ``jax.grad`` does through the reference's
``lax.scan``. The loss is the cross-entropy plus 0.01 times the sum of the
MoE blocks' load-balancing aux.

Families -> layer plans:
  dense/audio   [("dense", L)]
  moe           [("moe", L)] or [("moe_pair", L/2)] (interleaved, llama4)
  ssm           [("mamba", L)]
  hybrid        [("zamba_super", L//e), ("mamba", L%e)]   e = shared_attn_every
                (each super = e mamba blocks + ONE shared attn block)
  vlm           [("vlm_super", L//e)]                      e = cross_attn_every
                (each super = e-1 self-attn blocks + 1 cross-attn block
                 attending to the image embeddings ``img``,
                 (B, n_img_tokens, d))

Caches: ``forward(want_caches=True)`` allocates them once (``init_caches``,
at ``cache_len`` positions, so a server can prefill straight into caches
of its full length) and fills them block by block; ``decode_step`` updates
them in place and returns the same tensors. A vlm's cross-attention cache
holds the image's ``n_img_tokens`` keys whatever the cache length, and
an image of another length is refused.
The reference's ``constrain`` calls are left out: the port's
``models.sharding.constrain`` is the identity (a position of a data mesh
computes on its own batch slice already).

Tensor parallel (ROADMAP.md steps 13.7-13.11; every family):
``LM.tp_loss`` is ``LM.loss`` over the positions of one row of a model
axis (a ``launch.mesh.ModelGroup``), each with its model slices of the
parameters, as the reference's ``param_specs(..., tp="model")`` lays them
out and its ``constrain(..., "tp")`` points place the work. The embedding
is vocab-parallel: each position looks up the tokens of its vocab rows
and writes zeros elsewhere, then a reduce-out. Each block copies its
normed input in, runs attention on the position's own heads and the MLP
on its columns of ``w_in``/``w_gate``, and sums the row slices' products
with ``wo`` and ``w_out`` by a reduce-out, each product kept in f32 and
the sum rounded once to the model's dtype (``common.WideProduct``): a
bf16 sum of bf16 partial products would round every partial, which the
whole product does not, so only the order of the f32 sums differs from
it. The heads (``head_range``): position ``j`` of ``tp`` takes the query
heads ``[floor(j H / tp), floor((j + 1) H / tp))``, none where ``tp > H``
leaves it without one (it launches no kernel and its partial is zero).
Where ``tp`` divides ``n_kv`` those are its column slices of ``wq``, and
its slices of ``wk``/``wv`` are whole kv heads (``n_kv/tp``), which K4
and K5 read as GQA. Elsewhere a kv head's columns lie on more than one
position: ``wk`` and ``wv`` are regrouped whole over the axis (as a
Mamba2 block's ``in_proj``; ``wq`` and ``wo`` too where ``tp`` does not
divide ``n_heads``, their even slices cutting through heads), each
position computes q for its heads and k and v for the kv heads they
read, and repeats each kv head to one per query head, the reference's
repeat-then-shard (its ``_self_attn_full``); autograd sums dk and dv over
the repeats, the regroup's backward the whole leaves' gradients over the
positions. A vlm's super block runs its self-attention blocks so, then
the cross attention on each position's heads (q from the normed text, k
and v from the image embeddings, no RoPE, not causal) and the cross
block's MLP. The head
makes each position's vocab columns of the logits, tied or not, and the
loss takes the gold logit as a masked gather and a reduce-out, ``m`` from
the no-gradient max over the axis (the reference's ``m`` carries a
gradient that cancels to zero), and ``logz = m + log(reduce-out(sum
exp(lg - m)))`` in f32: the full (B, S, V) logits are never gathered.
Replicated work (norms, residual stream, RoPE angles, a MoE layer's
route and aux) is done once a row with the first position's copy of a
replicated leaf. A MoE sub-layer's experts split over the axis: each
position fills and runs only its own experts' slots (``_tp_moe_sub``).
A Mamba2 block runs on each position's H/tp heads
(``mamba.tp_mamba_apply``: its ``in_proj`` and conv slices gathered whole
over the axis, its gated norm's mean over d_inner a reduce-out, its
``out_proj`` row slices' f32 products summed by a reduce-out); a hybrid's
super block runs its Mamba2 blocks so, then the shared dense block on each
position's slices of ``params["shared"]``, whose gradient sums over its
uses as the unsharded path's does.
``routes`` (``moe.Routes``) records every MoE layer's route in a forward
without gradients (``route`` / ``tp_route``: the sharded train step's
routing pass) and replays it in the next, whose aux then takes the
counts summed over the data positions.
Under grad mode each block is always checkpointed (remat), with the
positions' slices as its arguments, and its recompute runs the whole block
(early stop off), so a step makes the collectives that
``launch.dryrun.tp_collectives`` counts, whatever the last saved tensor.

Serving over a model axis (ROADMAP.md step 13.12): ``LM.tp_prefill`` is
``tp_loss``'s trunk with caches and no checkpoint, each sub-layer writing
on each position what that position reads back: the k and v of the kv
heads its query heads read (``kv_range``: ``n_kv/tp`` whole heads where
the axis divides ``n_kv``, else the heads its query heads straddle, so a
kv head two positions read is cached on both; none on a headless
position), a vlm's image keys and values of the same heads, a Mamba2
block's final state of its heads and conv window of its conv columns
(``mamba.tp_mamba_apply``); ``models.sharding.cache_slice`` gives the
same slices of a whole tree and ``assemble_caches`` the whole tree back.
The logits are each position's vocab columns, gathered whole
(``ModelGroup.gather_out``, a collective that training has not).
``LM.tp_decode_step`` runs ``block_apply_decode``'s sub-layers the same
way at one token (``_tp_self_attn_decode``, ``_tp_cross_attn_decode``,
``mamba.tp_mamba_decode``, and ``_tp_mlp_sub`` / ``_tp_moe_sub`` as they
are), each position against its own caches, in place; no kernel runs in
it, as in ``decode_step``. ``serve.engine.Engine(..., mesh=)`` drives
both. The reference's other kv cache layouts (ROADMAP.md step 13.13;
``cache_mode``, default "heads"): under "hd" a position caches its
columns of every kv head, under "seq" its slots of every kv head. The
prefill still computes k and v on the positions' own heads (rotated
whole, since RoPE pairs column i with i + hd/2) and re-lays each kv
head's owner's copy by an all-to-all (``_relay_kv``); decode re-lays the
token's q, k and v the same way and attends across the axis
(``_tp_split_attn_decode``: partial scores summed by an all-reduce under
"hd", local softmax terms combined with the axis's max under "seq"). A
vlm's image cache and the Mamba2 caches are laid out as under "heads" in
every layout, as the reference's ``cache_specs`` does.
"""
from __future__ import annotations

import itertools
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from ..configs.base import ArchConfig
from ..device import CUDA, DeviceLike, resolve_device
from .common import (
    NEG_INF,
    Init,
    WideProduct,
    attn_init,
    attn_qkv,
    blockwise_attention,
    decode_attention,
    mlp_apply,
    mlp_hidden,
    mlp_init,
    normal,
    ones,
    rms_norm,
    rope,
)
from .mamba import (
    mamba_apply,
    mamba_decode,
    mamba_dims,
    mamba_init,
    tp_mamba_apply,
    tp_mamba_decode,
)
from .moe import (
    Route,
    Routes,
    load_balance_aux,
    moe_apply,
    moe_experts,
    moe_init,
    route_layer,
)
from .sharding import cache_slice, kv_cache_slice, resolve_cache_mode

Params = Any

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def layer_plan(cfg: ArchConfig) -> list[tuple[str, int]]:
    if cfg.family in ("dense", "audio"):
        return [("dense", cfg.n_layers)]
    if cfg.family == "moe":
        if cfg.moe_every == 1:
            return [("moe", cfg.n_layers)]
        assert cfg.moe_every == 2, cfg.moe_every
        return [("moe_pair", cfg.n_layers // 2)]
    if cfg.family == "ssm":
        return [("mamba", cfg.n_layers)]
    if cfg.family == "hybrid":
        e = cfg.shared_attn_every
        supers, tail = divmod(cfg.n_layers, e)
        plan: list[tuple[str, int]] = [("zamba_super", supers)]
        if tail:
            plan.append(("mamba", tail))
        return plan
    if cfg.family == "vlm":
        e = cfg.cross_attn_every
        assert cfg.n_layers % e == 0
        return [("vlm_super", cfg.n_layers // e)]
    raise ValueError(cfg.family)


# --------------------------------------------------------------------------
# trees of specs and tensors
# --------------------------------------------------------------------------


def _map(fn, *trees):
    t = trees[0]
    if isinstance(t, dict):
        return {key: _map(fn, *(u[key] for u in trees)) for key in t}
    if isinstance(t, (tuple, list)):
        return type(t)(_map(fn, *u) for u in zip(*trees))
    return fn(*trees)


def _leaves(tree) -> list:
    """Leaves in the reference's flattening order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in _leaves(tree[key])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _stack(tree, count: int):
    return _map(lambda s: s.stacked(count), tree)


def _index(tree, i: int):
    return _map(lambda t: t[i], tree)


def _write(dst, src) -> None:
    """Copy a block's cache into its slot; self-attention caches (..., S,
    KV, hd) may be longer than the block's sequence (positions past it
    stay as they are)."""
    def put(d, s):
        if d is s:
            return
        if d.shape != s.shape:
            d = d[..., :s.shape[-3], :, :]
        d.copy_(s)

    _map(put, dst, src)


def _draw(spec: Init, gen: torch.Generator, dev: torch.device):
    out = torch.empty(spec.shape, dtype=spec.dtype, device=dev)
    inner = spec.shape[spec.lead:]
    f32 = torch.float32
    for idx in itertools.product(*(range(n) for n in spec.shape[:spec.lead])):
        dst = out[idx] if idx else out
        if spec.kind == "normal":
            dst.copy_(torch.randn(inner, generator=gen, device=dev,
                                  dtype=f32) * spec.arg[0])
        elif spec.kind == "ones":
            dst.fill_(1)
        elif spec.kind == "zeros":
            dst.zero_()
        else:
            lo, hi = spec.arg
            u = torch.empty(inner, dtype=f32, device=dev).uniform_(
                lo, hi, generator=gen)
            if spec.kind == "log_uniform":
                dst.copy_(torch.log(u))
            elif spec.kind == "inv_softplus_uniform":
                dst.copy_(torch.log(torch.exp(u) - 1.0))
            else:
                raise ValueError(spec.kind)
    return out


# --------------------------------------------------------------------------
# sub-layer specs
# --------------------------------------------------------------------------


def _dense_block_init(cfg: ArchConfig, dtype):
    return {
        "ln1": ones((cfg.d_model,), dtype),
        "attn": attn_init(cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd, dtype),
        "ln2": ones((cfg.d_model,), dtype),
        "mlp": mlp_init(cfg.d_model, cfg.d_ff, cfg.mlp, dtype),
    }


def _moe_block_init(cfg: ArchConfig, dtype):
    return {
        "ln1": ones((cfg.d_model,), dtype),
        "attn": attn_init(cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd, dtype),
        "ln2": ones((cfg.d_model,), dtype),
        "moe": moe_init(cfg.d_model, cfg.d_ff, cfg.n_experts, dtype),
    }


def _mamba_block_init(cfg: ArchConfig, dtype):
    return {
        "ln": ones((cfg.d_model,), dtype),
        "mamba": mamba_init(cfg, dtype),
    }


def block_init(kind: str, cfg: ArchConfig, dtype):
    """The parameter specs of one block of ``kind``."""
    if kind == "dense":
        return _dense_block_init(cfg, dtype)
    if kind == "moe":
        return _moe_block_init(cfg, dtype)
    if kind == "moe_pair":
        return {"dense": _dense_block_init(cfg, dtype),
                "moe": _moe_block_init(cfg, dtype)}
    if kind == "mamba":
        return _mamba_block_init(cfg, dtype)
    if kind == "zamba_super":
        return {"mamba": _stack(_mamba_block_init(cfg, dtype),
                                cfg.shared_attn_every)}
    if kind == "vlm_super":
        return {"dense": _stack(_dense_block_init(cfg, dtype),
                                cfg.cross_attn_every - 1),
                "cross": _dense_block_init(cfg, dtype)}
    raise ValueError(kind)


# --------------------------------------------------------------------------
# sub-layer apply (full-sequence: prefill)
# --------------------------------------------------------------------------


def _self_attn_full(p, x, positions, cfg: ArchConfig, want_cache, force):
    h = rms_norm(x, p["ln1"])
    q, k, v = attn_qkv(h, p["attn"], cfg.n_heads, cfg.n_kv, cfg.hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    cache = (k, v) if want_cache else None
    o = blockwise_attention(q, k, v, causal=True, force=force)
    B, S = x.shape[:2]
    x = x + o.reshape(B, S, -1) @ p["attn"]["wo"]
    return x, cache


def _cross_attn_full(p, x, img, cfg: ArchConfig, want_cache, force):
    """Text queries against the image embeddings: q from the normed text,
    k and v from the raw ``img``, no RoPE, no mask (K4 non-causal)."""
    h = rms_norm(x, p["ln1"])
    B, S, _ = x.shape
    q = (h @ p["attn"]["wq"]).reshape(B, S, cfg.n_heads, cfg.hd)
    ni = img.shape[1]
    k = (img @ p["attn"]["wk"]).reshape(B, ni, cfg.n_kv, cfg.hd)
    v = (img @ p["attn"]["wv"]).reshape(B, ni, cfg.n_kv, cfg.hd)
    cache = (k, v) if want_cache else None
    o = blockwise_attention(q, k, v, causal=False, force=force)
    x = x + o.reshape(B, S, -1) @ p["attn"]["wo"]
    return x, cache


def _mlp_sub(p, x, cfg: ArchConfig):
    return x + mlp_apply(rms_norm(x, p["ln2"]), p["mlp"], cfg.mlp)


# ---- tensor parallel over a model axis (see the module) ----


def check_tensor_parallel(cfg: ArchConfig, tp: int) -> None:
    """Raise, naming the rule, where the port cannot train ``cfg`` over a
    model axis of ``tp`` positions: a position takes whole Mamba heads
    and whole experts. Any number of attention heads splits (see the
    module); a leaf that ``param_specs`` cannot split evenly is refused
    where the state is placed (``sharding.shard_tree``)."""
    if tp <= 1:
        return
    n_mamba = mamba_dims(cfg)[1] if cfg.ssm_state else 0
    if n_mamba % tp:
        raise NotImplementedError(
            f"{cfg.name} on a model axis of {tp}: {tp} does not divide its "
            f"{n_mamba} Mamba heads, and a position takes whole heads (its "
            f"slices of A_log, D, dt_bias, the gated norm and out_proj are "
            f"its head group)")
    if cfg.n_experts % tp:
        raise NotImplementedError(
            f"{cfg.name} on a model axis of {tp}: {tp} does not divide its "
            f"{cfg.n_experts} experts, and a position takes whole experts "
            f"(the expert axis splits evenly over the model axis, as "
            f"param_specs lays it out)")


def head_range(n_heads: int, tp: int, j: int) -> tuple[int, int]:
    """The query heads ``[lo, hi)`` of position ``j`` of a model axis of
    ``tp``: ``lo = floor(j H / tp)``, ``hi = floor((j + 1) H / tp)`` (none
    where ``tp > H`` leaves a position without one)."""
    return n_heads * j // tp, n_heads * (j + 1) // tp


def _vocab_rows(embed, tokens, lo: int):
    """The embedding rows of the tokens in ``[lo, lo + rows)`` from a
    position's vocab slice ``embed``, zeros for the others."""
    local = tokens - lo
    hit = (local >= 0) & (local < embed.shape[0])
    x = F.embedding(torch.where(hit, local, 0), embed)
    return torch.where(hit[..., None], x, torch.zeros((), dtype=x.dtype,
                                                      device=x.device))


def _kv_for_heads(t, rep: int, off: int, n: int):
    """(B, S, G, hd) kv heads -> (B, S, n, hd): each repeated ``rep`` times
    (query head h reads kv head h // rep), then the ``n`` heads from
    ``off`` on, the window of a position's query heads. An expand and a
    copy, so the backward sums the repeats in a fixed order."""
    B, S, G, hd = t.shape
    return t[:, :, :, None].expand(B, S, G, rep, hd).reshape(
        B, S, G * rep, hd)[:, :, off:off + n]


def kv_range(n_heads: int, n_kv: int, tp: int, j: int) -> tuple[int, int]:
    """The kv heads ``[g0, g1)`` that the query heads of position ``j``
    (``head_range``) read, query head h reading kv head ``h // (n_heads /
    n_kv)``: ``n_kv / tp`` whole heads where ``tp`` divides ``n_kv``,
    else the heads its query heads straddle (a kv head read by two
    positions is on both), none for a position without a query head."""
    lo, hi = head_range(n_heads, tp, j)
    rep = n_heads // n_kv
    return lo // rep, ((hi - 1) // rep + 1 if hi > lo else lo // rep)


def kv_owned(n_heads: int, n_kv: int, tp: int, j: int) -> tuple[int, int]:
    """The kv heads ``[a, b)`` of ``kv_range`` for which position ``j`` is
    the first position that computes them: the heads it sends when the
    kv caches are re-laid as columns or slots (every kv head has one
    owner; a position without a query head owns none)."""
    have = 0
    for i in range(j):
        have = max(have, kv_range(n_heads, n_kv, tp, i)[1])
    g0, g1 = kv_range(n_heads, n_kv, tp, j)
    a = max(g0, have)
    return a, max(a, g1)


def _tp_heads(ps, group, cfg, kv: bool = True) -> list:
    """Each local position's ``(wq, wk, wv, wo)`` for its query heads and
    the kv heads they read (``wk`` and ``wv`` None without ``kv``). Where
    the axis divides ``n_kv`` those are its column slices (GQA as ever);
    else ``wk`` and ``wv`` (and ``wq`` and ``wo`` where it does not divide
    ``n_heads`` either) are regrouped whole (``ModelGroup.all_gather``)
    and each position takes its heads' columns and rows."""
    tp, H, KV, hd = group.size, cfg.n_heads, cfg.n_kv, cfg.hd
    att = [p["attn"] for p in ps]
    if KV % tp == 0:
        return [(a["wq"], a["wk"] if kv else None, a["wv"] if kv else None,
                 a["wo"]) for a in att]
    if kv:
        wk = group.all_gather([a["wk"] for a in att], 1)
        wv = group.all_gather([a["wv"] for a in att], 1)
    if H % tp:
        wq = group.all_gather([a["wq"] for a in att], 1)
        wo = group.all_gather([a["wo"] for a in att], 0)
    out = []
    for i, (a, j) in enumerate(zip(att, group.index)):
        lo, hi = head_range(H, tp, j)
        g0, g1 = kv_range(H, KV, tp, j)
        cols, kv_cols = slice(lo * hd, hi * hd), slice(g0 * hd, g1 * hd)
        out.append((a["wq"] if H % tp == 0 else wq[i][:, cols],
                    wk[i][:, kv_cols] if kv else None,
                    wv[i][:, kv_cols] if kv else None,
                    a["wo"] if H % tp == 0 else wo[i][cols]))
    return out


def _n_heads(cfg, tp: int, j: int) -> tuple[int, int]:
    """The number of query heads and kv heads of position ``j``."""
    lo, hi = head_range(cfg.n_heads, tp, j)
    g0, g1 = kv_range(cfg.n_heads, cfg.n_kv, tp, j)
    return hi - lo, g1 - g0


def _per_head_kv(k, v, cfg, tp: int, j: int):
    """Position ``j``'s kv heads ``(B, S, g1 - g0, hd)`` as one per query
    head where the axis does not divide ``n_kv`` (``_kv_for_heads``), as
    they are (GQA) where it does."""
    if cfg.n_kv % tp == 0:
        return k, v
    lo, hi = head_range(cfg.n_heads, tp, j)
    rep = cfg.n_heads // cfg.n_kv
    off = lo - kv_range(cfg.n_heads, cfg.n_kv, tp, j)[0] * rep
    return tuple(_kv_for_heads(t, rep, off, hi - lo) for t in (k, v))


def _tp_attn_sub(ps, x, ctx, img, cs=None):
    """An attention sub-layer over a model axis: each local position's
    query heads (q from its copy of the normed input), k and v of the kv
    heads they read from the same copy (self-attention, ``img`` None:
    RoPE, causal) or from ``img`` (cross attention: no RoPE, no mask),
    each kv head repeated to one per query head where the axis does not
    divide ``n_kv`` (``_tp_heads``), K4 and K5 on its heads, its product
    with its rows of ``wo`` kept in f32 (``WideProduct``), and a
    reduce-out of the products. ``cs``: each local position's cache slot
    ``(k, v)`` of the sub-layer, which takes its kv heads (prefill), or
    in the "hd" and "seq" layouts (``ctx["cache_mode"]``) a self-attention's
    k and v re-laid as columns or slots (``_relay_kv``)."""
    cfg, group = ctx["cfg"], ctx["group"]
    tp, hd = group.size, cfg.hd
    split = (cs is not None and img is None
             and ctx.get("cache_mode", "heads") != "heads")
    h = rms_norm(x, ps[0]["ln1"])
    outs, owned = [], []
    for i, ((wq, wk, wv, wo), hj, j) in enumerate(zip(
            _tp_heads(ps, group, cfg), group.copy_in(h), group.index)):
        B, S = hj.shape[:2]
        src = hj if img is None else img.to(hj.device)
        Skv = src.shape[1]
        nq, nkv = _n_heads(cfg, tp, j)
        q = (hj @ wq).reshape(B, S, nq, hd)
        k = (src @ wk).reshape(B, Skv, nkv, hd)
        v = (src @ wv).reshape(B, Skv, nkv, hd)
        if img is None:
            pos = ctx["positions"].to(hj.device)
            q = rope(q, pos, cfg.rope_theta)
            k = rope(k, pos, cfg.rope_theta)
        if split:
            owned.append(_owned(k, v, cfg, tp, j))
        elif cs is not None:
            _write(cs[i], (k, v))
        k, v = _per_head_kv(k, v, cfg, tp, j)
        o = blockwise_attention(q, k, v, causal=img is None,
                                force=ctx["force"])
        outs.append(WideProduct.apply(o.reshape(B, S, q.shape[2] * hd), wo))
    if split:
        for c, new in zip(cs, _relay_kv(owned, group, cfg, ctx["cache_mode"],
                                        ctx["cache_len"])):
            _write(c, new)
    return x + group.reduce_out(outs).to(x.dtype)


def _owned(k, v, cfg, tp: int, j: int) -> tuple:
    """Position ``j``'s k and v (B, S, g1 - g0, hd) narrowed to the kv
    heads it owns (``kv_owned``)."""
    g0 = kv_range(cfg.n_heads, cfg.n_kv, tp, j)[0]
    a, b = kv_owned(cfg.n_heads, cfg.n_kv, tp, j)
    return k[:, :, a - g0:b - g0], v[:, :, a - g0:b - g0]


def _relay_kv(owned, group, cfg, mode: str, length: int) -> list:
    """Each local position's prefill ``(k, v)`` of the kv heads it owns
    (B, S, n, hd) re-laid to the "hd" or "seq" layout of caches of
    ``length`` slots by an all-to-all: each position's ``(k, v)`` of every
    kv head, its part of the S tokens by ``sharding.kv_cache_slice`` (none
    where the prompt ends before its slots)."""
    tp = group.size
    lay = [kv_cache_slice(mode, tp, d, cfg.hd, length) for d in range(tp)]
    k, v = (group.all_to_all([[t[:, sl, :, cl] for sl, cl in lay]
                              for t in ts], 2) for ts in zip(*owned))
    return list(zip(k, v))


def _tp_self_attn_full(ps, x, ctx, cs=None):
    """``_self_attn_full`` over a model axis: ``ps`` are the local
    positions' block slices, ``ctx["group"]`` their ``ModelGroup``,
    ``cs`` their cache slots (prefill) or None."""
    return _tp_attn_sub(ps, x, ctx, None, cs)


def _tp_cross_attn_full(ps, x, ctx, cs=None):
    """``_cross_attn_full`` over a model axis: k and v from the image
    embeddings ``ctx["img"]`` (no gradient), K4 and K5 not causal; ``cs``
    as ``_tp_self_attn_full``'s (the image's kv heads)."""
    return _tp_attn_sub(ps, x, ctx, ctx["img"], cs)


def _tp_mlp_sub(ps, x, ctx):
    """``_mlp_sub`` over a model axis: each position's MLP columns, the
    row slices' f32 products summed by a reduce-out."""
    cfg, group = ctx["cfg"], ctx["group"]
    h = rms_norm(x, ps[0]["ln2"])
    outs = [WideProduct.apply(mlp_hidden(hj, p["mlp"], cfg.mlp),
                              p["mlp"]["w_out"])
            for p, hj in zip(ps, group.copy_in(h))]
    return x + group.reduce_out(outs).to(x.dtype)


def _tp_moe_sub(ps, x, ctx):
    """``_moe_sub`` over a model axis, the experts split over it: the route
    is taken once a row with the first position's router (replicated over
    the axis), each position runs its own experts' slots and products
    (``moe_experts``, experts ``[j E/tp, (j+1) E/tp)``), and a reduce-out
    sums the partial combines, one nonzero term per (token, choice). The
    gates are copied in, so that their gradient, which each position
    makes for its own pairs only, is summed; the aux is the row's, taken
    once."""
    cfg, group = ctx["cfg"], ctx["group"]
    h = rms_norm(x, ps[0]["ln2"])
    r, counts, n_tokens = route_layer(
        h, ps[0]["moe"]["router"], top_k=cfg.top_k,
        capacity_factor=cfg.capacity_factor, routes=ctx.get("routes"),
        key=ctx.get("key"))
    n = cfg.n_experts // group.size
    outs = []
    for p, hj, gj, j in zip(ps, group.copy_in(h), group.copy_in(r.gate),
                            group.index):
        dev = hj.device
        rj = Route(r.probs.detach().to(dev), gj, r.eidx.to(dev),
                   r.pos.to(dev), r.keep.to(dev), r.cap)
        outs.append(moe_experts(hj, p["moe"], rj, first=j * n))
    y = group.reduce_out(outs)
    return x + y.to(x.dtype), load_balance_aux(r.probs, counts, n_tokens)


def _slots(cs, key):
    """Each position's cache slot ``key`` (a dict key or a stacked index)
    of ``cs``, or None where there are no caches."""
    if cs is None:
        return None
    if isinstance(key, str):
        return [c[key] for c in cs]
    return [_index(c, key) for c in cs]


def _tp_block(kind, ps, x, ctx, cs=None):
    """One block over a model axis, (x, aux or None): the function each
    checkpoint recomputes. A hybrid's shared block is ``ctx["shared"]``,
    each local position's slices of it. ``cs``: each local position's
    cache slot of the block, which the prefill fills (``_tp_trunk``)."""
    if kind == "dense":
        x = _tp_self_attn_full(ps, x, ctx, cs)
        return _tp_mlp_sub(ps, x, ctx), None
    if kind == "moe":
        return _tp_moe_sub(ps, _tp_self_attn_full(ps, x, ctx, cs), ctx)
    if kind == "moe_pair":
        x, _ = _tp_block("dense", [p["dense"] for p in ps], x, ctx,
                         _slots(cs, "dense"))
        return _tp_block("moe", [p["moe"] for p in ps], x, ctx,
                         _slots(cs, "moe"))
    if kind == "mamba":
        cfg, group = ctx["cfg"], ctx["group"]
        h = rms_norm(x, ps[0]["ln"])
        y, caches = tp_mamba_apply(
            group.copy_in(h), [p["mamba"] for p in ps], cfg, group,
            chunk=cfg.ssd_chunk, want_cache=cs is not None,
            force=ctx["force"])
        for c, new in zip(cs or (), caches or ()):
            _write(c, new)
        return x + y.to(x.dtype), None
    if kind == "zamba_super":
        for i in range(ctx["cfg"].shared_attn_every):
            x, _ = _tp_block("mamba", [_index(p["mamba"], i) for p in ps], x,
                             ctx, _slots(_slots(cs, "mamba"), i))
        return _tp_block("dense", ctx["shared"], x, ctx, _slots(cs, "attn"))
    if kind == "vlm_super":
        for i in range(ctx["cfg"].cross_attn_every - 1):
            x, _ = _tp_block("dense", [_index(p["dense"], i) for p in ps], x,
                             ctx, _slots(_slots(cs, "dense"), i))
        cp = [p["cross"] for p in ps]
        x = _tp_cross_attn_full(cp, x, ctx, _slots(cs, "cross"))
        return _tp_mlp_sub(cp, x, ctx), None
    raise ValueError(kind)


def _moe_sub(p, x, ctx):
    """The MoE FFN sub-layer; ``ctx["routes"]`` (if any) records or replays
    the layer's route under ``ctx["key"]`` (``moe.route_layer``)."""
    cfg = ctx["cfg"]
    y, aux = moe_apply(rms_norm(x, p["ln2"]), p["moe"], top_k=cfg.top_k,
                       capacity_factor=cfg.capacity_factor,
                       routes=ctx.get("routes"), key=ctx.get("key"))
    return x + y, aux


def _add(a, b):
    """The sum of two aux terms, either of which may be None (none)."""
    if a is None:
        return b
    return a if b is None else a + b


def _stacked(caches):
    return tuple(torch.stack(parts) for parts in zip(*caches))


def block_apply_full(kind, p, x, ctx, *, want_cache: bool):
    """Returns (x, aux, cache); aux is the block's MoE load-balancing term
    (0-d f32), or None for a block without experts. ctx: dict(cfg,
    positions, img, shared, force)."""
    cfg: ArchConfig = ctx["cfg"]
    if kind in ("dense", "moe"):
        x, cache = _self_attn_full(p, x, ctx["positions"], cfg, want_cache,
                                   ctx["force"])
        if kind == "dense":
            return _mlp_sub(p, x, cfg), None, cache
        x, aux = _moe_sub(p, x, ctx)
        return x, aux, cache
    if kind == "moe_pair":
        x, aux1, c1 = block_apply_full("dense", p["dense"], x, ctx,
                                       want_cache=want_cache)
        x, aux2, c2 = block_apply_full("moe", p["moe"], x, ctx,
                                       want_cache=want_cache)
        cache = {"dense": c1, "moe": c2} if want_cache else None
        return x, _add(aux1, aux2), cache
    if kind == "mamba":
        h = rms_norm(x, p["ln"])
        y, cache = mamba_apply(h, p["mamba"], cfg, chunk=cfg.ssd_chunk,
                               want_cache=want_cache, force=ctx["force"])
        return x + y, None, cache
    if kind == "zamba_super":
        mcaches = []
        for i in range(cfg.shared_attn_every):
            x, _, cache = block_apply_full("mamba", _index(p["mamba"], i), x,
                                           ctx, want_cache=want_cache)
            mcaches.append(cache)
        x, _, acache = block_apply_full("dense", ctx["shared"], x, ctx,
                                        want_cache=want_cache)
        if not want_cache:
            return x, None, None
        return x, None, {"mamba": _stacked(mcaches), "attn": acache}
    if kind == "vlm_super":
        dcaches = []
        for i in range(cfg.cross_attn_every - 1):
            x, _, cache = block_apply_full("dense", _index(p["dense"], i), x,
                                           ctx, want_cache=want_cache)
            dcaches.append(cache)
        x, ccache = _cross_attn_full(p["cross"], x, ctx["img"], cfg,
                                     want_cache, ctx["force"])
        x = _mlp_sub(p["cross"], x, cfg)
        if not want_cache:
            return x, None, None
        return x, None, {"dense": _stacked(dcaches), "cross": ccache}
    raise ValueError(kind)


def _block_out(kind, p, x, ctx):
    """One block's output and aux: the function each checkpoint
    recomputes."""
    x, aux, _ = block_apply_full(kind, p, x, ctx, want_cache=False)
    return x, aux


# --------------------------------------------------------------------------
# sub-layer apply (single-token decode against caches)
# --------------------------------------------------------------------------


def _self_attn_decode(p, x, pos, cache, cfg: ArchConfig):
    kc, vc = cache
    h = rms_norm(x, p["ln1"])
    q, k, v = attn_qkv(h, p["attn"], cfg.n_heads, cfg.n_kv, cfg.hd)
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    kc[:, pos] = k[:, 0].to(kc.dtype)  # in place
    vc[:, pos] = v[:, 0].to(vc.dtype)
    o = decode_attention(q, kc, vc, pos)
    x = x + o.reshape(B, 1, -1) @ p["attn"]["wo"]
    return x, (kc, vc)


def _cross_attn_decode(p, x, cache, cfg: ArchConfig):
    kc, vc = cache  # the image's keys and values, from the prefill
    h = rms_norm(x, p["ln1"])
    B = x.shape[0]
    q = (h @ p["attn"]["wq"]).reshape(B, 1, cfg.n_heads, cfg.hd)
    o = decode_attention(q, kc, vc, kc.shape[1] - 1)
    x = x + o.reshape(B, 1, -1) @ p["attn"]["wo"]
    return x, (kc, vc)


def block_apply_decode(kind, p, x, cache, ctx):
    """Returns (x, cache); attention caches are updated in place."""
    cfg: ArchConfig = ctx["cfg"]
    pos = ctx["pos"]
    if kind == "dense":
        x, cache = _self_attn_decode(p, x, pos, cache, cfg)
        return _mlp_sub(p, x, cfg), cache
    if kind == "moe":
        x, cache = _self_attn_decode(p, x, pos, cache, cfg)
        return _moe_sub(p, x, ctx)[0], cache
    if kind == "moe_pair":
        x, c1 = block_apply_decode("dense", p["dense"], x, cache["dense"],
                                   ctx)
        x, c2 = block_apply_decode("moe", p["moe"], x, cache["moe"], ctx)
        return x, {"dense": c1, "moe": c2}
    if kind == "mamba":
        h = rms_norm(x, p["ln"])
        y, cache = mamba_decode(h, p["mamba"], cfg, cache)
        return x + y, cache
    if kind == "zamba_super":
        for i in range(cfg.shared_attn_every):
            cl = _index(cache["mamba"], i)
            x, cl_new = block_apply_decode("mamba", _index(p["mamba"], i), x,
                                           cl, ctx)
            _write(cl, cl_new)
        x, acache = block_apply_decode("dense", ctx["shared"], x,
                                       cache["attn"], ctx)
        return x, {"mamba": cache["mamba"], "attn": acache}
    if kind == "vlm_super":
        for i in range(cfg.cross_attn_every - 1):
            cl = _index(cache["dense"], i)
            x, cl_new = block_apply_decode("dense", _index(p["dense"], i), x,
                                           cl, ctx)
            _write(cl, cl_new)
        x, ccache = _cross_attn_decode(p["cross"], x, cache["cross"], cfg)
        x = _mlp_sub(p["cross"], x, cfg)
        return x, {"dense": cache["dense"], "cross": ccache}
    raise ValueError(kind)


# ---- single-token decode over a model axis ----


class CacheSlices(list):
    """Each local position's cache tree on a model axis (``LM.tp_prefill``
    returns one), with the kv cache layout it holds, ``mode`` "heads",
    "hd" or "seq" (``models.sharding.cache_slice``), and its self-attention
    caches' ``length`` in slots."""

    def __init__(self, trees, mode: str, length: int):
        super().__init__(trees)
        self.mode, self.length = mode, length


def _attend_decode(q, kc, vc, pos: int, cfg, tp: int, j: int):
    """Position ``j``'s query heads (B, 1, n, hd) against its cached kv
    heads (``decode_attention``); a position without a head gives its
    empty q back."""
    if q.shape[2] == 0:
        return q
    kc, vc = _per_head_kv(kc, vc, cfg, tp, j)
    return decode_attention(q, kc, vc, pos)


def _decode_qkv(ps, x, ctx) -> list:
    """Each local position's q (B, 1, nq, hd) of its query heads, k and v
    (B, 1, nkv, hd) of the kv heads they read, of the token at
    ``ctx["pos"]`` (q and k rotated on whole heads), and its rows of
    ``wo``."""
    cfg, group, pos = ctx["cfg"], ctx["group"], ctx["pos"]
    tp, hd = group.size, cfg.hd
    h = rms_norm(x, ps[0]["ln1"])
    out = []
    for (wq, wk, wv, wo), hj, j in zip(_tp_heads(ps, group, cfg),
                                       group.copy_in(h), group.index):
        B = hj.shape[0]
        nq, nkv = _n_heads(cfg, tp, j)
        positions = torch.full((B, 1), pos, dtype=torch.int32,
                               device=hj.device)
        q = rope((hj @ wq).reshape(B, 1, nq, hd), positions, cfg.rope_theta)
        k = rope((hj @ wk).reshape(B, 1, nkv, hd), positions, cfg.rope_theta)
        out.append((q, k, (hj @ wv).reshape(B, 1, nkv, hd), wo))
    return out


def _decode_out(x, attn: list, wos: list, group):
    """Each local position's attention output (B, 1, nq, hd) times its
    rows of ``wo`` in f32 (``WideProduct``), one reduce-out, the
    residual."""
    outs = [WideProduct.apply(o.flatten(2), wo) for o, wo in zip(attn, wos)]
    return x + group.reduce_out(outs).to(x.dtype)


def _tp_self_attn_decode(ps, x, cs, ctx):
    """``_self_attn_decode`` over a model axis: each position writes the k
    and v of its kv heads at ``pos`` into its cache slot ``cs[i]`` and
    attends its query heads to them; its rows of ``wo`` in f32
    (``WideProduct``), one reduce-out. The "hd" and "seq" layouts
    (``ctx["cache_mode"]``) are ``_tp_split_attn_decode``."""
    if ctx["cache_mode"] != "heads":
        return _tp_split_attn_decode(ps, x, cs, ctx)
    cfg, group, pos = ctx["cfg"], ctx["group"], ctx["pos"]
    heads = _decode_qkv(ps, x, ctx)
    attn = []
    for (q, k, v, _wo), j, (kc, vc) in zip(heads, group.index, cs):
        kc[:, pos] = k[:, 0].to(kc.dtype)  # in place
        vc[:, pos] = v[:, 0].to(vc.dtype)
        attn.append(_attend_decode(q, kc, vc, pos, cfg, group.size, j))
    return _decode_out(x, attn, [t[3] for t in heads], group)


def _tp_split_attn_decode(ps, x, cs, ctx):
    """``_self_attn_decode`` over a model axis whose kv caches are split
    by head-dim columns ("hd") or sequence slots ("seq"), the reference's
    ``cache_specs(mode=)`` layouts. Each position computes q of its query
    heads and k and v of its kv heads (``_decode_qkv``); an all-to-all
    hands each position its columns of every head ("hd") or every head
    whole ("seq") (``sharding.kv_cache_slice``). The owner of slot
    ``pos`` writes k and v there, and each position makes its scores of
    every query head over its part of the caches in f32. "hd": an
    all-reduce sums them in position order, every position applies the
    same mask and softmax and takes P times its v columns, and a second
    all-to-all hands each position its query heads' outputs, all columns.
    "seq": each position masks its slots past ``pos`` and takes their max;
    with the max over the axis (``ModelGroup.pmax``) each makes its sum of
    exps and unnormalised P V, an all-reduce sums them in position order,
    and each position divides and keeps its query heads. A position whose
    slots all lie past ``pos`` has the max ``NEG_INF``, so its exps
    against the axis's max are 0. Then ``_decode_out``, as in the "heads"
    layout."""
    cfg, group, pos, mode = (ctx["cfg"], ctx["group"], ctx["pos"],
                             ctx["cache_mode"])
    tp, hd, H, KV = group.size, cfg.hd, cfg.n_heads, cfg.n_kv
    rep = H // KV
    B = x.shape[0]
    qkv = _decode_qkv(ps, x, ctx)
    owned = [_owned(k, v, cfg, tp, j)
             for (_q, k, v, _wo), j in zip(qkv, group.index)]
    lay = [kv_cache_slice(mode, tp, d, hd, ctx["cache_len"])
           for d in range(tp)]
    q, k, v = (group.all_to_all([[t[..., cl] for _sl, cl in lay]
                                 for t in ts], 2)
               for ts in ([t[0] for t in qkv], *zip(*owned)))
    scores, valid = [], []
    for j, qj, kj, vj, (kc, vc) in zip(group.index, q, k, v, cs):
        sl = lay[j][0]
        if sl.start <= pos < sl.stop:  # the owner of slot pos
            kc[:, pos - sl.start] = kj[:, 0].to(kc.dtype)  # in place
            vc[:, pos - sl.start] = vj[:, 0].to(vc.dtype)
        scores.append(torch.einsum("bgrh,bsgh->bgrs",
                                   qj.reshape(B, KV, rep, -1).float(),
                                   kc.float()))
        valid.append(torch.arange(sl.start, sl.stop, device=kc.device) <= pos)
    heads = [head_range(H, tp, d) for d in range(tp)]
    scale = 1.0 / (hd ** 0.5)
    if mode == "hd":
        sends = []
        for s, ok, (kc, vc) in zip(group.all_reduce(scores), valid, cs):
            p = torch.softmax(torch.where(ok, s * scale, NEG_INF), -1)
            o = torch.einsum("bgrs,bsgh->bgrh", p, vc.float()).reshape(
                B, 1, H, -1).to(x.dtype)
            sends.append([o[:, :, lo:hi] for lo, hi in heads])
        attn = group.all_to_all(sends, 3)
    else:
        scores = [torch.where(ok, s * scale, NEG_INF)
                  for s, ok in zip(scores, valid)]
        m = group.pmax([s.amax(-1) for s in scores])
        parts = []
        for s, (kc, vc) in zip(scores, cs):
            e = torch.exp(s - m.to(s.device)[..., None])
            parts.append(torch.cat([
                torch.einsum("bgrs,bsgh->bgrh", e, vc.float()),
                e.sum(-1, keepdim=True)], -1))
        attn = []
        for t, j in zip(group.all_reduce(parts), group.index):
            lo, hi = heads[j]
            t = (t[..., :hd] / t[..., hd:]).reshape(B, 1, H, hd)
            attn.append(t[:, :, lo:hi].to(x.dtype))
    return _decode_out(x, attn, [t[3] for t in qkv], group)


def _tp_cross_attn_decode(ps, x, cs, ctx):
    """``_cross_attn_decode`` over a model axis: each position's query
    heads against the image keys and values of its kv heads, cached by
    the prefill (``wk`` and ``wv`` are not read, so not regrouped)."""
    cfg, group = ctx["cfg"], ctx["group"]
    tp, hd = group.size, cfg.hd
    h = rms_norm(x, ps[0]["ln1"])
    outs = []
    for (wq, _, _, wo), hj, j, (kc, vc) in zip(
            _tp_heads(ps, group, cfg, kv=False), group.copy_in(h),
            group.index, cs):
        B = hj.shape[0]
        nq, _ = _n_heads(cfg, tp, j)
        q = (hj @ wq).reshape(B, 1, nq, hd)
        o = _attend_decode(q, kc, vc, kc.shape[1] - 1, cfg, tp, j)
        outs.append(WideProduct.apply(o.reshape(B, 1, nq * hd), wo))
    return x + group.reduce_out(outs).to(x.dtype)


def _tp_block_decode(kind, ps, x, cs, ctx):
    """``block_apply_decode`` over a model axis: ``cs`` are the local
    positions' cache slots of the block, updated in place; returns x."""
    if kind == "dense":
        return _tp_mlp_sub(ps, _tp_self_attn_decode(ps, x, cs, ctx), ctx)
    if kind == "moe":
        return _tp_moe_sub(ps, _tp_self_attn_decode(ps, x, cs, ctx), ctx)[0]
    if kind == "moe_pair":
        x = _tp_block_decode("dense", [p["dense"] for p in ps], x,
                             _slots(cs, "dense"), ctx)
        return _tp_block_decode("moe", [p["moe"] for p in ps], x,
                                _slots(cs, "moe"), ctx)
    if kind == "mamba":
        cfg, group = ctx["cfg"], ctx["group"]
        h = rms_norm(x, ps[0]["ln"])
        y, new = tp_mamba_decode(group.copy_in(h), [p["mamba"] for p in ps],
                                 cfg, group, cs)
        for c, n in zip(cs, new):
            _write(c, n)
        return x + y.to(x.dtype)
    if kind == "zamba_super":
        for i in range(ctx["cfg"].shared_attn_every):
            x = _tp_block_decode("mamba", [_index(p["mamba"], i) for p in ps],
                                 x, _slots(_slots(cs, "mamba"), i), ctx)
        return _tp_block_decode("dense", ctx["shared"], x,
                                _slots(cs, "attn"), ctx)
    if kind == "vlm_super":
        for i in range(ctx["cfg"].cross_attn_every - 1):
            x = _tp_block_decode("dense", [_index(p["dense"], i) for p in ps],
                                 x, _slots(_slots(cs, "dense"), i), ctx)
        cp = [p["cross"] for p in ps]
        x = _tp_cross_attn_decode(cp, x, _slots(cs, "cross"), ctx)
        return _tp_mlp_sub(cp, x, ctx)
    raise ValueError(kind)


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------


class LM:
    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg
        self.plan = layer_plan(cfg)
        self.dtype = DTYPES[cfg.dtype]

    # ---- parameters ----

    def param_specs(self) -> dict:
        """The parameter tree as ``Init`` specs (nothing allocated)."""
        cfg = self.cfg
        vp = cfg.vocab_padded
        specs: dict = {
            "embed": normal((vp, cfg.d_model), 0.02, self.dtype),
            "final_norm": ones((cfg.d_model,), self.dtype),
        }
        if not cfg.tie_embeddings:
            specs["lm_head"] = normal((cfg.d_model, vp), 0.02, self.dtype)
        if cfg.family == "hybrid":
            specs["shared"] = _dense_block_init(cfg, self.dtype)
        for si, (kind, count) in enumerate(self.plan):
            specs[f"seg{si}"] = _stack(block_init(kind, cfg, self.dtype),
                                       count)
        return specs

    def init(self, generator=0, *, device: DeviceLike = CUDA) -> Params:
        """Random parameters with the reference's shapes, dtypes and
        distributions, drawn from ``generator`` (a ``torch.Generator`` on
        ``device``, or an int seed for one). A stacked segment is drawn one
        block at a time, so the f32 temporaries stay one block large."""
        dev = resolve_device(device)
        specs = self.param_specs()
        gen = generator
        if not isinstance(gen, torch.Generator):
            gen = torch.Generator(device=dev).manual_seed(int(generator))
        return _map(lambda s: _draw(s, gen, dev), specs)

    def abstract_params(self) -> Params:
        """The parameter tree as tensors on the ``meta`` device (shapes and
        dtypes, no storage), the counterpart of the reference's
        ``abstract_params``."""
        return _map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device="meta"), self.param_specs())

    def param_count(self) -> int:
        return sum(s.numel() for s in _leaves(self.param_specs()))

    def active_param_count(self) -> int:
        """MoE: parameters touched per token (6 * N_active * D accounting),
        the reference's formula."""
        cfg = self.cfg
        total = self.param_count()
        if not cfg.n_experts:
            return total
        per_expert = 3 * cfg.d_model * cfg.d_ff
        n_moe_layers = cfg.n_layers // cfg.moe_every
        return total - (cfg.n_experts - cfg.top_k) * per_expert * n_moe_layers

    # ---- forward (prefill) ----

    def blocks(self, params: Params):
        """(segment, index, kind, parameters) of every block, in order."""
        for si, (kind, count) in enumerate(self.plan):
            seg = params[f"seg{si}"]
            for i in range(count):
                yield si, i, kind, _index(seg, i)

    def _image(self, params: Params, img, batch: int):
        """``img`` as a (batch, n_img_tokens, d_model) tensor of the model's
        dtype on the parameters' device; a vlm needs one, other families
        none."""
        if self.cfg.family != "vlm":
            return None
        if img is None:
            raise ValueError(
                f"{self.cfg.name} is a vlm: pass img, the (batch, "
                f"n_img_tokens, d_model) image embeddings")
        img = torch.as_tensor(img, device=params["embed"].device).to(
            self.dtype)
        want = (batch, self.cfg.n_img_tokens, self.cfg.d_model)
        if tuple(img.shape) != want:
            # the image cache holds n_img_tokens keys (init_caches): a
            # shorter image would leave zero keys for decode to attend to
            raise ValueError(f"img of shape {tuple(img.shape)}, expected "
                             f"{want}")
        return img

    def context(self, params: Params, batch: int, seq_len: int, *,
                img=None, force: Optional[str] = None) -> dict:
        """The ``ctx`` of ``block_apply_full`` for a (batch, seq_len)
        sequence (and, for a vlm, its image embeddings ``img``)."""
        dev = params["embed"].device
        positions = torch.arange(seq_len, dtype=torch.int32,
                                 device=dev).expand(batch, seq_len)
        return dict(cfg=self.cfg, positions=positions,
                    img=self._image(params, img, batch),
                    shared=params.get("shared"), force=force)

    def head(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """Final norm and the output projection: hidden -> logits."""
        x = rms_norm(x, params["final_norm"])
        embed = params["embed"]
        return x @ (embed.T if self.cfg.tie_embeddings else params["lm_head"])

    def forward(
        self,
        params: Params,
        tokens: torch.Tensor,  # (B, S) int
        img: Optional[torch.Tensor] = None,  # (B, n_img_tokens, d) for a vlm
        *,
        want_caches: bool = False,
        cache_len: Optional[int] = None,
        remat: bool = False,
        skip_masked: bool = False,
        force: Optional[str] = None,
        routes: Optional[Routes] = None,
    ):
        """Returns (logits (B,S,V), aux scalar, caches list | None); aux is
        the sum of the MoE blocks' load-balancing terms (0 without experts).
        With ``want_caches`` only the last position's logits are made, and
        the self-attention caches hold ``cache_len`` positions (default S). ``remat``: under
        grad mode each block is checkpointed (its activations are
        recomputed in the backward). ``skip_masked`` is the reference's
        causal block skipping; it is accepted and changes no value: K4 and
        K5 always skip the tiles the causal mask hides, and the plain
        versions compute them and mask them out. ``routes``: the MoE
        layers' routes to record or replay (``route``)."""
        x, aux_total, caches = self._trunk(
            params, tokens, img, want_caches=want_caches,
            cache_len=cache_len, remat=remat, force=force, routes=routes)
        if want_caches:
            # prefill only needs next-token logits: never make (B,S,V)
            x = x[:, -1:]
        logits = self.head(params, x)
        return logits, aux_total, caches

    def _trunk(self, params, tokens, img, *, want_caches=False,
               cache_len=None, remat=False, force=None, routes=None):
        """The embedding and the blocks: (x, aux, caches)."""
        embed = params["embed"]
        tokens = torch.as_tensor(tokens, device=embed.device).long()
        B, S = tokens.shape
        x = F.embedding(tokens, embed)
        ctx = self.context(params, B, S, img=img, force=force)
        caches = (self.init_caches(B, cache_len or S, device=x.device)
                  if want_caches else None)
        remat = remat and not want_caches and torch.is_grad_enabled()
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for si, i, kind, p in self.blocks(params):
            bctx = ctx if routes is None else dict(ctx, routes=routes,
                                                   key=(si, i))
            if remat:
                x, aux = checkpoint(_block_out, kind, p, x, bctx,
                                    use_reentrant=False)
            else:
                x, aux, cache = block_apply_full(kind, p, x, bctx,
                                                 want_cache=want_caches)
                if want_caches:
                    _write(_index(caches[si], i), cache)
            if aux is not None:
                aux_total = aux_total + aux
        return x, aux_total, caches

    def route(self, params: Params, tokens, img=None, *,
              force: Optional[str] = None) -> Routes:
        """The routing pass of the sharded train step: a forward without
        gradients through the blocks (no head) that records every MoE
        layer's experts and first-choice counts, for ``loss(...,
        routes=)`` to replay once the counts are summed over the data
        positions (``Routes.set_total``)."""
        routes = Routes()
        with torch.no_grad():
            self._trunk(params, tokens, img, force=force, routes=routes)
        return routes

    # ---- losses ----

    def loss(self, params: Params, tokens, img=None, *, remat: bool = True,
             skip_masked: bool = False, force: Optional[str] = None,
             routes: Optional[Routes] = None):
        """Next-token cross-entropy + 0.01 * aux, as the reference's
        ``LM.loss``: over all ``vocab_padded`` classes, the mean over
        B x (S - 1) positions, logsumexp in f32. Returns (loss, dict(ce,
        aux)), 0-d f32 tensors. ``skip_masked`` changes no value (see
        ``forward``); ``routes``: the MoE routes to replay (``route``)."""
        logits, aux, _ = self.forward(params, tokens, img, remat=remat,
                                      skip_masked=skip_masked, force=force,
                                      routes=routes)
        tokens = torch.as_tensor(tokens, device=logits.device).long()
        tgt = tokens[:, 1:]
        lg = logits[:, :-1]
        gold = torch.gather(lg, -1, tgt[..., None])[..., 0].to(torch.float32)
        logz = torch.logsumexp(lg.to(torch.float32), dim=-1)
        ce = torch.mean(logz - gold)
        return ce + 0.01 * aux, dict(ce=ce, aux=aux)

    def _tp_embed(self, parts: list, tokens, group):
        """The vocab-parallel embedding: each position's rows of the
        tokens in its vocab slice, zeros elsewhere, summed by a
        reduce-out."""
        vp = self.cfg.vocab_padded // group.size
        return group.reduce_out([
            _vocab_rows(p["embed"], tokens.to(p["embed"].device), j * vp)
            for p, j in zip(parts, group.index)])

    def _tp_trunk(self, parts: list, tokens, group, *, img=None,
                  force=None, routes=None, want_caches: bool = False,
                  cache_len: Optional[int] = None,
                  cache_mode: str = "heads"):
        """``tp_loss``'s embedding and blocks: (x, aux, tokens, caches);
        with ``want_caches`` (the prefill) each local position's cache
        tree (``init_caches(..., tp=, j=, mode=cache_mode)``, the mode
        resolved) filled block by block, and no block checkpointed."""
        cfg = self.cfg
        tp = group.size
        check_tensor_parallel(cfg, tp)
        dev = parts[0]["embed"].device
        tokens = torch.as_tensor(tokens, device=dev).long()
        B, S = tokens.shape
        img = self._image(parts[0], img, B)
        x = self._tp_embed(parts, tokens, group)
        mode, L = resolve_cache_mode(cfg, tp, cache_mode), cache_len or S
        ctx = dict(cfg=cfg, group=group, force=force, img=img,
                   positions=torch.arange(S, dtype=torch.int32,
                                          device=dev).expand(B, S),
                   shared=[p.get("shared") for p in parts], cache_mode=mode,
                   cache_len=L)
        caches = (CacheSlices([
            self.init_caches(B, L, device=d, tp=tp, j=j, mode=mode)
            for d, j in zip(group.devices, group.index)], mode, L)
            if want_caches else None)
        remat = torch.is_grad_enabled() and not want_caches
        aux_total = torch.zeros((), dtype=torch.float32, device=dev)
        for si, (kind, count) in enumerate(self.plan):
            for i in range(count):
                ps = [_index(p[f"seg{si}"], i) for p in parts]
                bctx = ctx if routes is None else dict(ctx, routes=routes,
                                                       key=(si, i))
                if remat:
                    with set_checkpoint_early_stop(False):
                        x, aux = checkpoint(_tp_block, kind, ps, x, bctx,
                                            use_reentrant=False)
                else:
                    cs = (None if caches is None else
                          [_index(c[si], i) for c in caches])
                    x, aux = _tp_block(kind, ps, x, bctx, cs)
                if aux is not None:
                    aux_total = aux_total + aux
        return x, aux_total, tokens, caches

    def tp_route(self, parts: list, tokens, group, *, img=None,
                 force: Optional[str] = None) -> Routes:
        """``route`` over a model axis: ``tp_loss``'s blocks without
        gradients, recording the routes (taken once a row)."""
        routes = Routes()
        with torch.no_grad():
            self._tp_trunk(parts, tokens, group, img=img, force=force,
                           routes=routes)
        return routes

    def tp_loss(self, parts: list, tokens, group, *, img=None,
                force: Optional[str] = None,
                routes: Optional[Routes] = None):
        """``loss`` over a model axis (see the module): ``parts[i]`` is the
        parameter tree of ``group``'s local position i, its model slices
        whole along the data axes; ``img`` a vlm's image embeddings for
        the rows of ``tokens`` (as ``loss``'s). Returns what ``loss``
        returns, the same on every position of the row (on the first local
        position's device); ``routes`` as ``loss``'s."""
        cfg = self.cfg
        tp = group.size
        first = parts[0]
        vp = cfg.vocab_padded // tp
        x, aux, tokens, _ = self._tp_trunk(parts, tokens, group, img=img,
                                           force=force, routes=routes)
        h = rms_norm(x, first["final_norm"])
        tgt = tokens[:, 1:]
        golds, lgs = [], []
        for p, hj, j in zip(parts, group.copy_in(h), group.index):
            w = p["embed"].T if cfg.tie_embeddings else p["lm_head"]
            lg = (hj @ w)[:, :-1]
            t = tgt.to(lg.device) - j * vp
            hit = (t >= 0) & (t < vp)
            g = torch.gather(lg, -1, torch.where(hit, t, 0)[..., None])[..., 0]
            golds.append(torch.where(hit, g, torch.zeros(
                (), dtype=g.dtype, device=g.device)).to(torch.float32))
            lgs.append(lg)
        gold = group.reduce_out(golds)
        m = group.pmax([lg.detach().amax(-1).to(torch.float32)
                        for lg in lgs])
        se = group.reduce_out([
            torch.sum(torch.exp(lg.to(torch.float32)
                                - m.to(lg.device)[..., None]), dim=-1)
            for lg in lgs])
        logz = m + torch.log(se)
        ce = torch.mean(logz - gold)
        return ce + 0.01 * aux, dict(ce=ce, aux=aux)

    # ---- serving ----

    def prefill(self, params, tokens, img=None, *,
                cache_len: Optional[int] = None,
                force: Optional[str] = None):
        logits, _aux, caches = self.forward(
            params, tokens, img, want_caches=True, cache_len=cache_len,
            force=force)
        return logits[:, -1], caches

    def decode_step(self, params, token, caches, pos: int, img=None, *,
                    force: Optional[str] = None):
        """token: (B, 1) int; pos: the write position. Returns (logits
        (B, V), caches), the caches updated in place. Nothing here runs K4
        or K6 (decode attention, the Mamba2 step and the MoE dispatch are
        plain torch). ``img`` is accepted as in the reference and not read:
        a vlm attends to the image keys and values its prefill cached."""
        embed = params["embed"]
        token = torch.as_tensor(token, device=embed.device).long()
        x = embed[token]
        ctx = dict(cfg=self.cfg, pos=int(pos), shared=params.get("shared"),
                   force=force)
        for si, i, kind, p in self.blocks(params):
            cl = _index(caches[si], i)
            x, cl_new = block_apply_decode(kind, p, x, cl, ctx)
            _write(cl, cl_new)
        return self.head(params, x)[:, 0], caches

    # ---- serving over a model axis ----

    def tp_prefill(self, parts: list, tokens, group, img=None, *,
                   cache_len: Optional[int] = None,
                   force: Optional[str] = None, cache_mode: str = "heads"):
        """``prefill`` over a model axis (ROADMAP.md steps 13.12-13.13):
        ``parts`` and ``group`` as ``tp_loss``'s. Returns (the last
        position's logits (B, V), whole, on the first local position's
        device; each local position's cache tree, a ``CacheSlices`` that
        names its layout). ``cache_mode`` lays out the self-attention kv
        caches (``models.sharding.cache_slice``): "heads" (the default),
        the kv heads its query heads read (``kv_range``; a kv head two
        positions read is cached on both, and a position without a query
        head caches none); the reference's "hd", its columns of every kv
        head, or "seq", its slots of every kv head, each re-laid from the
        heads it computed by an all-to-all (``_relay_kv``); "auto" picks
        as the reference's ``cache_specs(mode="auto")`` does. An axis that
        does not divide the head dim ("hd") or ``cache_len`` ("seq")
        raises ``ValueError``. In every layout a vlm's image keys and
        values are cached by the kv heads of its query heads, and a Mamba2
        block's state of its heads and its conv window of its conv
        columns. The logits are each position's vocab columns, gathered
        whole over the axis (``ModelGroup.gather_out``)."""
        x, _aux, _tokens, caches = self._tp_trunk(
            parts, tokens, group, img=img, force=force, want_caches=True,
            cache_len=cache_len, cache_mode=cache_mode)
        return self._tp_logits(parts, x[:, -1:], group)[:, 0], caches

    def tp_decode_step(self, parts: list, token, caches: "CacheSlices",
                       pos: int, group, *, force: Optional[str] = None):
        """``decode_step`` over a model axis: ``token`` (B, 1), ``caches``
        each local position's cache tree, the ``CacheSlices`` that
        ``tp_prefill`` returned, whose layout it reads (a ``ValueError``
        for caches that name none); updated in place. Returns (logits
        (B, V) whole, on the first local position's device, ``caches``).
        Each sub-layer runs on a position's own heads, MLP columns,
        experts or Mamba heads against its own caches, its partial
        products summed by a reduce-out as in ``tp_loss`` (attention in
        the "hd" and "seq" layouts: ``_tp_split_attn_decode``); nothing
        here runs K4 or K6, as in ``decode_step``."""
        cfg = self.cfg
        check_tensor_parallel(cfg, group.size)
        if not isinstance(caches, CacheSlices):
            raise ValueError("tp_decode_step: the caches name no kv cache "
                             "layout; pass the CacheSlices that tp_prefill "
                             "returned")
        dev = parts[0]["embed"].device
        token = torch.as_tensor(token, device=dev).long()
        x = self._tp_embed(parts, token, group)
        ctx = dict(cfg=cfg, group=group, pos=int(pos), force=force,
                   shared=[p.get("shared") for p in parts],
                   cache_mode=caches.mode, cache_len=caches.length)
        for si, (kind, count) in enumerate(self.plan):
            for i in range(count):
                ps = [_index(p[f"seg{si}"], i) for p in parts]
                x = _tp_block_decode(kind, ps, x,
                                     [_index(c[si], i) for c in caches], ctx)
        return self._tp_logits(parts, x, group)[:, 0], caches

    def _tp_logits(self, parts: list, x, group):
        """The final norm and each position's vocab columns of the logits
        of ``x`` (B, 1, d), gathered whole over the axis."""
        h = rms_norm(x, parts[0]["final_norm"])
        tie = self.cfg.tie_embeddings
        return group.gather_out(
            [hj @ (p["embed"].T if tie else p["lm_head"])
             for p, hj in zip(parts, group.copy_in(h))], -1)

    # ---- cache allocation ----

    def init_caches(self, batch: int, seq_len: int, *,
                    device: DeviceLike = CUDA, tp: int = 1,
                    j: int = 0, mode: str = "heads") -> list:
        """Zeroed caches for ``seq_len`` positions, in the reference's
        tree, shapes and dtypes; a vlm's cross-attention cache holds
        ``n_img_tokens`` positions. With ``tp > 1``: the caches that
        position ``j`` of a model axis of ``tp`` holds in the kv cache
        layout ``mode`` (``models.sharding.cache_slice``'s shapes)."""
        dev = resolve_device(device)
        if tp > 1:
            whole = self.init_caches(batch, seq_len, device="meta")
            return _map(lambda t: torch.zeros(t.shape, dtype=t.dtype,
                                              device=dev),
                        cache_slice(self, whole, tp, j, mode))
        cfg = self.cfg
        d_inner, H, N = mamba_dims(cfg) if cfg.ssm_state else (0, 0, 0)
        P = cfg.ssm_head_dim
        conv_ch = d_inner + 2 * N

        def z(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)

        def attn_cache(lead):
            shp = (*lead, batch, seq_len, cfg.n_kv, cfg.hd)
            return (z(shp, self.dtype), z(shp, self.dtype))

        def mamba_cache(lead):
            return (z((*lead, batch, H, P, N), torch.float32),
                    z((*lead, batch, cfg.d_conv - 1, conv_ch), self.dtype))

        caches = []
        for kind, count in self.plan:
            if kind in ("dense", "moe"):
                caches.append(attn_cache((count,)))
            elif kind == "moe_pair":
                caches.append({"dense": attn_cache((count,)),
                               "moe": attn_cache((count,))})
            elif kind == "mamba":
                caches.append(mamba_cache((count,)))
            elif kind == "zamba_super":
                caches.append({
                    "mamba": mamba_cache((count, cfg.shared_attn_every)),
                    "attn": attn_cache((count,)),
                })
            elif kind == "vlm_super":
                img = (count, batch, cfg.n_img_tokens, cfg.n_kv, cfg.hd)
                caches.append({
                    "dense": attn_cache((count, cfg.cross_attn_every - 1)),
                    "cross": (z(img, self.dtype), z(img, self.dtype)),
                })
            else:
                raise ValueError(kind)
        return caches


def tree_leaves(tree) -> list:
    """The tensors (or specs) of a parameter or cache tree, in the
    reference's flattening order."""
    return _leaves(tree)


def tree_map(fn, *trees):
    """``fn`` over the leaves of trees of one structure."""
    return _map(fn, *trees)


__all__ = ["CacheSlices", "LM", "layer_plan", "block_init",
           "block_apply_full", "block_apply_decode", "check_tensor_parallel",
           "head_range", "kv_owned", "kv_range", "tree_leaves", "tree_map"]
