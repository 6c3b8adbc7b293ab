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
from .moe import moe_apply, moe_init

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


def _moe_sub(p, x, cfg: ArchConfig):
    y, aux = moe_apply(rms_norm(x, p["ln2"]), p["moe"], top_k=cfg.top_k,
                       capacity_factor=cfg.capacity_factor)
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
        x, aux = _moe_sub(p, x, cfg)
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
        return _moe_sub(p, x, cfg)[0], cache
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
    ):
        """Returns (logits (B,S,V), aux scalar, caches list | None); aux is
        the sum of the MoE blocks' load-balancing terms (0 without experts).
        With ``want_caches`` only the last position's logits are made, and
        the self-attention caches hold ``cache_len`` positions (default S). ``remat``: under
        grad mode each block is checkpointed (its activations are
        recomputed in the backward). ``skip_masked`` is the reference's
        causal block skipping; it is accepted and changes no value: K4 and
        K5 always skip the tiles the causal mask hides, and the plain
        versions compute them and mask them out."""
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
            if remat:
                x, aux = checkpoint(_block_out, kind, p, x, ctx,
                                    use_reentrant=False)
            else:
                x, aux, cache = block_apply_full(kind, p, x, ctx,
                                                 want_cache=want_caches)
                if want_caches:
                    _write(_index(caches[si], i), cache)
            if aux is not None:
                aux_total = aux_total + aux
        if want_caches:
            # prefill only needs next-token logits: never make (B,S,V)
            x = x[:, -1:]
        logits = self.head(params, x)
        return logits, aux_total, caches

    # ---- losses ----

    def loss(self, params: Params, tokens, img=None, *, remat: bool = True,
             skip_masked: bool = False, force: Optional[str] = None):
        """Next-token cross-entropy + 0.01 * aux, as the reference's
        ``LM.loss``: over all ``vocab_padded`` classes, the mean over
        B x (S - 1) positions, logsumexp in f32. Returns (loss, dict(ce,
        aux)), 0-d f32 tensors. ``skip_masked`` changes no value (see
        ``forward``)."""
        logits, aux, _ = self.forward(params, tokens, img, remat=remat,
                                      skip_masked=skip_masked, force=force)
        tokens = torch.as_tensor(tokens, device=logits.device).long()
        tgt = tokens[:, 1:]
        lg = logits[:, :-1]
        gold = torch.gather(lg, -1, tgt[..., None])[..., 0].to(torch.float32)
        logz = torch.logsumexp(lg.to(torch.float32), dim=-1)
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

    # ---- cache allocation ----

    def init_caches(self, batch: int, seq_len: int, *,
                    device: DeviceLike = CUDA) -> list:
        """Zeroed caches for ``seq_len`` positions, in the reference's
        tree, shapes and dtypes; a vlm's cross-attention cache holds
        ``n_img_tokens`` positions."""
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


__all__ = ["LM", "layer_plan", "block_init", "block_apply_full",
           "block_apply_decode", "tree_leaves", "tree_map"]
