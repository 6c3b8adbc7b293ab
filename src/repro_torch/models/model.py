"""LM assembly for the dense, ssm and hybrid families, and the training
loss of the dense family.

Reference: ``repro/models/model.py`` (``layer_plan`` :50, ``block_init``
:114, ``block_apply_full`` :227, ``block_apply_decode`` :311, ``LM`` :341,
``LM.loss`` :431).
A model is a sequence of segments; each segment is ``count`` identical
blocks whose parameters are stacked on a leading axis, exactly the
reference's parameter tree (so ``convert.lm_params_from_arrays`` carries a
JAX tree across leaf by leaf). The reference's ``lax.scan`` and
``fori_loop`` over a segment become Python loops over its blocks, and
the reference's ``jax.checkpoint(body)`` per block (:413-414) is
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)`` per block
when ``forward(remat=True)`` runs under grad mode.

Training: ``LM.loss`` is differentiable for the dense (and audio) family,
whose only kernels are K4 and K5 behind ``attention.FlashAttention``. The
ssm and hybrid families' Mamba2 layers run K6, which has no backward yet,
so their ``loss`` raises ``NotImplementedError`` (ROADMAP.md step 13.2)
rather than train with a cut gradient; moe and vlm are not ported.

Families -> layer plans:
  dense/audio   [("dense", L)]
  ssm           [("mamba", L)]
  hybrid        [("zamba_super", L//e), ("mamba", L%e)]   e = shared_attn_every
                (each super = e mamba blocks + ONE shared attn block)
  moe, vlm      planned as in the reference; their blocks raise
                NotImplementedError (ROADMAP.md step 13)

Caches: ``forward(want_caches=True)`` allocates them once (``init_caches``,
at ``cache_len`` positions, so a server can prefill straight into caches
of its full length) and fills them block by block; ``decode_step`` updates
them in place and returns the same tensors. ``models/sharding.constrain``
is the identity on one device and has no counterpart here.
"""
from __future__ import annotations

import itertools
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..device import CUDA, DeviceLike, resolve_device
from .common import (
    Init,
    attn_init,
    attn_qkv,
    blockwise_attention,
    decode_attention,
    mlp_apply,
    mlp_init,
    normal,
    ones,
    rms_norm,
    rope,
)
from .mamba import mamba_apply, mamba_decode, mamba_dims, mamba_init

Params = Any

_NOT_PORTED = {
    "moe": "ROADMAP.md step 13 (models/moe.py)",
    "moe_pair": "ROADMAP.md step 13 (models/moe.py)",
    "vlm_super": "ROADMAP.md step 13 (the VLM family)",
}

# families whose loss has a backward path in the port
_TRAINABLE = ("dense", "audio")
_NO_BACKWARD = {
    "ssm": "ROADMAP.md step 13.2 (a backward for the Mamba2 layers' K6 path)",
    "hybrid": "ROADMAP.md step 13.2 (a backward for the Mamba2 layers' K6 "
              "path)",
    "moe": "ROADMAP.md step 13 (models/moe.py)",
    "vlm": "ROADMAP.md step 13 (the VLM family)",
}

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


def _not_ported(kind: str):
    return NotImplementedError(
        f"block kind {kind!r} is not ported yet: {_NOT_PORTED[kind]}")


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
    """Copy a block's cache into its slot; attention caches may be longer
    than the block's sequence (positions past it stay as they are)."""
    def put(d, s):
        if d is s:
            return
        if d.shape != s.shape:
            d = d[:, :s.shape[1]]
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


def _mamba_block_init(cfg: ArchConfig, dtype):
    return {
        "ln": ones((cfg.d_model,), dtype),
        "mamba": mamba_init(cfg, dtype),
    }


def block_init(kind: str, cfg: ArchConfig, dtype):
    """The parameter specs of one block of ``kind``."""
    if kind == "dense":
        return _dense_block_init(cfg, dtype)
    if kind == "mamba":
        return _mamba_block_init(cfg, dtype)
    if kind == "zamba_super":
        return {"mamba": _stack(_mamba_block_init(cfg, dtype),
                                cfg.shared_attn_every)}
    if kind in _NOT_PORTED:
        raise _not_ported(kind)
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


def _mlp_sub(p, x, cfg: ArchConfig):
    return x + mlp_apply(rms_norm(x, p["ln2"]), p["mlp"], cfg.mlp)


def block_apply_full(kind, p, x, ctx, *, want_cache: bool):
    """Returns (x, cache). ctx: dict(cfg, positions, shared, force)."""
    cfg: ArchConfig = ctx["cfg"]
    if kind == "dense":
        x, cache = _self_attn_full(p, x, ctx["positions"], cfg, want_cache,
                                   ctx["force"])
        return _mlp_sub(p, x, cfg), cache
    if kind == "mamba":
        h = rms_norm(x, p["ln"])
        y, cache = mamba_apply(h, p["mamba"], cfg, chunk=cfg.ssd_chunk,
                               want_cache=want_cache, force=ctx["force"])
        return x + y, cache
    if kind == "zamba_super":
        mcaches = []
        for i in range(cfg.shared_attn_every):
            x, cache = block_apply_full("mamba", _index(p["mamba"], i), x,
                                        ctx, want_cache=want_cache)
            mcaches.append(cache)
        x, acache = block_apply_full("dense", ctx["shared"], x, ctx,
                                     want_cache=want_cache)
        if not want_cache:
            return x, None
        stacked = tuple(torch.stack(parts) for parts in zip(*mcaches))
        return x, {"mamba": stacked, "attn": acache}
    if kind in _NOT_PORTED:
        raise _not_ported(kind)
    raise ValueError(kind)


def _block_out(kind, p, x, ctx):
    """One block's output alone: the function each checkpoint recomputes."""
    return block_apply_full(kind, p, x, ctx, want_cache=False)[0]


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


def block_apply_decode(kind, p, x, cache, ctx):
    """Returns (x, cache); attention caches are updated in place."""
    cfg: ArchConfig = ctx["cfg"]
    pos = ctx["pos"]
    if kind == "dense":
        x, cache = _self_attn_decode(p, x, pos, cache, cfg)
        return _mlp_sub(p, x, cfg), cache
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
    if kind in _NOT_PORTED:
        raise _not_ported(kind)
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

    # ---- forward (prefill) ----

    def blocks(self, params: Params):
        """(segment, index, kind, parameters) of every block, in order."""
        for si, (kind, count) in enumerate(self.plan):
            seg = params[f"seg{si}"]
            for i in range(count):
                yield si, i, kind, _index(seg, i)

    def context(self, params: Params, batch: int, seq_len: int, *,
                force: Optional[str] = None) -> dict:
        """The ``ctx`` of ``block_apply_full`` for a (batch, seq_len)
        sequence."""
        dev = params["embed"].device
        positions = torch.arange(seq_len, dtype=torch.int32,
                                 device=dev).expand(batch, seq_len)
        return dict(cfg=self.cfg, positions=positions,
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
        *,
        want_caches: bool = False,
        cache_len: Optional[int] = None,
        remat: bool = False,
        force: Optional[str] = None,
    ):
        """Returns (logits (B,S,V), aux scalar, caches list | None). With
        ``want_caches`` only the last position's logits are made, and the
        caches hold ``cache_len`` positions (default S). ``remat``: under
        grad mode each block is checkpointed (its activations are
        recomputed in the backward). The reference's ``skip_masked`` has no
        counterpart: K4 and K5 always skip masked tiles, which changes no
        value."""
        embed = params["embed"]
        tokens = torch.as_tensor(tokens, device=embed.device).long()
        B, S = tokens.shape
        x = F.embedding(tokens, embed)
        ctx = self.context(params, B, S, force=force)
        caches = (self.init_caches(B, cache_len or S, device=x.device)
                  if want_caches else None)
        remat = remat and not want_caches and torch.is_grad_enabled()
        for si, i, kind, p in self.blocks(params):
            if remat:
                x = checkpoint(_block_out, kind, p, x, ctx,
                               use_reentrant=False)
                continue
            x, cache = block_apply_full(kind, p, x, ctx,
                                        want_cache=want_caches)
            if want_caches:
                _write(_index(caches[si], i), cache)
        if want_caches:
            # prefill only needs next-token logits: never make (B,S,V)
            x = x[:, -1:]
        logits = self.head(params, x)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return logits, aux, caches

    # ---- losses ----

    def loss(self, params: Params, tokens, *, remat: bool = True,
             force: Optional[str] = None):
        """Next-token cross-entropy + 0.01 * aux, as the reference's
        ``LM.loss``: over all ``vocab_padded`` classes, the mean over
        B x (S - 1) positions, logsumexp in f32. Returns (loss, dict(ce,
        aux)), 0-d f32 tensors."""
        fam = self.cfg.family
        if fam not in _TRAINABLE:
            raise NotImplementedError(
                f"LM.loss for the {fam} family has no backward path in the "
                f"port yet: {_NO_BACKWARD.get(fam, 'ROADMAP.md step 13')}")
        logits, aux, _ = self.forward(params, tokens, remat=remat,
                                      force=force)
        tokens = torch.as_tensor(tokens, device=logits.device).long()
        tgt = tokens[:, 1:]
        lg = logits[:, :-1]
        gold = torch.gather(lg, -1, tgt[..., None])[..., 0].to(torch.float32)
        logz = torch.logsumexp(lg.to(torch.float32), dim=-1)
        ce = torch.mean(logz - gold)
        return ce + 0.01 * aux, dict(ce=ce, aux=aux)

    # ---- serving ----

    def prefill(self, params, tokens, *, cache_len: Optional[int] = None,
                force: Optional[str] = None):
        logits, _aux, caches = self.forward(
            params, tokens, want_caches=True, cache_len=cache_len,
            force=force)
        return logits[:, -1], caches

    def decode_step(self, params, token, caches, pos: int, *,
                    force: Optional[str] = None):
        """token: (B, 1) int; pos: the write position. Returns (logits
        (B, V), caches), the caches updated in place. Nothing here runs K4
        or K6 (decode attention and the Mamba2 step are plain torch)."""
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

    # ---- cache allocation ----

    def init_caches(self, batch: int, seq_len: int, *,
                    device: DeviceLike = CUDA) -> list:
        """Zeroed caches for ``seq_len`` positions, in the reference's
        tree, shapes and dtypes."""
        dev = resolve_device(device)
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
            if kind == "dense":
                caches.append(attn_cache((count,)))
            elif kind == "mamba":
                caches.append(mamba_cache((count,)))
            elif kind == "zamba_super":
                caches.append({
                    "mamba": mamba_cache((count, cfg.shared_attn_every)),
                    "attn": attn_cache((count,)),
                })
            elif kind in _NOT_PORTED:
                raise _not_ported(kind)
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


__all__ = ["LM", "layer_plan", "block_init", "block_apply_full",
           "block_apply_decode", "tree_leaves", "tree_map"]
