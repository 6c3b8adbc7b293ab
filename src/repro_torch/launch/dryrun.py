"""Per-cell cost report of the port, counted on ``meta`` tensors.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh both]

Reference: ``repro/launch/dryrun.py`` (``knobs_for`` :51, ``input_specs``
:86, ``build_lowered`` :110, ``model_flops`` :221, ``run_cell`` :268,
``run_all`` :348, the CLI :385). The reference lowers and compiles each
(arch x shape) cell on a 512-device host mesh and reads XLA's memory and
cost analyses. The port has no compiler to ask: it builds each cell on
``meta`` tensors (``LM.abstract_params``, ``abstract_train_state``, meta
tokens, an image for a vlm, ``LM.init_caches`` on meta) and runs one data
position's work under ``op_cost.OpCost``, which counts every op as it is
dispatched. Nothing is allocated and no card is needed.

Per cell:

* **The mesh.** The production shapes, (16, 16) over ("data", "model")
  or (2, 16, 16) over ("pod", "data", "model"), as an in-process mesh
  over ``meta`` positions (``launch.mesh.Mesh``; ``make_production_mesh``
  wants 256 cards). The port's ``param_specs`` and ``cache_specs`` lay
  the state on it; a position's batch is its own rows.
* **One data position's work.** ``global_batch / n_dp`` rows, or the whole
  batch when it does not divide (the reference's ``shardable``; a train
  cell follows the sharded step's rule, M x n_dp must divide it): train is
  ``make_train_step`` with no mesh (forward, the per-block remat
  recompute, backward and AdamW; an FSDP position gathers whole
  parameters, so its FLOPs are the unsharded step's on its rows), after
  a moe model's routing pass (``LM.route`` on each microbatch's rows)
  where its rows split over n_dp > 1 positions, prefill
  ``lm.prefill``, decode ``lm.decode_step``, all with ``force="ref"``.
  Per-device FLOPs and bytes are the position's divided by the model-axis
  size: an ideal tensor-parallel split (the port's tensor-parallel step
  also repeats the norms, the residual stream, a moe's routing and a
  Mamba2 block's B and C on every model position, which this leaves
  out).
* **Collectives.** The FSDP step's own (``train/train_state.py``): an
  all-gather of every sharded parameter slice once a step
  (``gather_tree``), and per microbatch, where the batch splits over the
  positions, a reduce-scatter of each sharded gradient leaf and an
  all-reduce of each whole one in ``accum_dtype`` plus the loss, and a
  moe model's all-reduce of its MoE layers' expert counts (f32); the
  clip norm's all-reduce once a step. Operand bytes of one position, as
  the mesh's counters count them (``launch.mesh.collective_bytes``).
  ``tp_collectives`` are the model axis's, for a train cell of every
  family, which the port trains tensor parallel (ROADMAP.md steps
  13.7-13.11): a position's reduce-outs, copy-ins, regroups and max a
  step, worked out from the step's schedule (``tp_collectives``) and
  added to the per-device collective bytes. There the record's data-axis
  ``collectives`` are that step's own, a device's (``fsdp_collectives``
  with ``tp``). A train cell whose model axis does not divide
  ``n_experts`` or the Mamba heads is counted, with the rule as its
  reason. A prefill or decode cell's ``tp_collectives`` are those of one
  ``LM.tp_prefill`` or ``LM.tp_decode_step`` (ROADMAP.md step 13.12; the
  serving engine on a mesh), worked out from its schedule
  (``serve_collectives``): reduce-outs, regroups and the logits'
  "gather-out"; its data axes move nothing (the engine gathers its model
  slices once, when it is built). ``--cache-shard`` picks the kv cache
  layout counted (ROADMAP.md step 13.13): the port's "heads" without it,
  the reference's "hd" or "seq" (their all-to-alls, all-reduces and
  max), or "auto", the reference's pick. A model axis that
  ``check_tensor_parallel`` refuses, or an "hd" or "seq" split that does
  not divide the head dim or the cache length, gives ``null`` with the
  rule as its reason. The record names the layout counted
  (``cache_mode``) and, where it differs, the reference's ``auto``
  choice (``cache_mode_reference``).
* **Memory.** ``argument_bytes`` is ``local_bytes`` of the state (or
  parameters and caches) and the batch by the specs; a decode cell's
  caches are the largest model position's slices in the layout counted
  (``sharding.cache_slice``: its kv heads, or head-dim columns or
  sequence slots, Mamba heads and conv columns), what
  ``LM.init_caches(tp=, j=, mode=)`` allocates; in a layout the axis
  cannot split, the argument, output, alias and peak figures are
  ``null`` with the rule as ``reason``. ``temp_bytes`` comes
  from the traced run: the most live storage beyond the arguments and the
  step's new outputs, which holds the tensors saved for backward (also
  reported alone, ``saved_bytes``, through ``saved_tensors_hooks``) and
  the largest transient (``largest_op_bytes``). A train cell over n > 1
  positions adds the gathered whole parameters and one leaf's f32 reduce
  slices, and cuts the microbatch accumulators to a position's slices;
  the rest of the trace is the unsharded step's (AdamW's temporaries on
  whole leaves), so there it is an upper bound. The trace runs the plain
  twins of the kernels, whose attention
  scores are (rows, S, S) chunks where K4 and K5 keep tiles, so
  ``temp_bytes`` is the plain path's. ``peak_estimate_gib`` is the
  reference's (argument + output + temp - alias).
* **Kernels.** K4, K5, K6 and K6b launch through ``ctypes``, which no
  dispatch mode sees, and meta tensors launch nothing; so the count runs
  on their plain twins. Each call of a twin is intercepted and measured
  (its FLOPs and bytes from the ``OpCost`` counters around it), and the
  record states, per kernel, the twin's FLOPs beside the kernel's, worked
  out from the shapes of each call: K4 and K5 visit only the 64 x 64 tiles
  a causal mask leaves (K5 runs seven products a tile where the twin runs
  five), K6 and K6b compute C B^T once per batch x chunk where the heads
  share B and C and only causal tiles of the (q, q) products. The kernel
  bytes are each call's inputs read once (a broadcast B or C once) and
  outputs written once.
  ``per_device.flops`` and ``hbm_bytes`` are the kernel path's: the
  twins' counts replaced by the kernels', and AdamW's (traced on the
  whole tree, intercepted the same way) cut to a position's slices.
* **Terms** on an H100 SXM's data-sheet figures (``PERF.md`` section 3):
  989 TFLOP/s bf16 dense (495 TFLOP/s TF32 for an f32 config), 3.35 TB/s
  HBM, 900 GB/s NVLink.

The record keeps the reference's keys, without ``xla_cost_analysis`` and
``compile_s``; ``lower_s`` becomes ``trace_s``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time
from typing import Optional

import torch

from ..configs import ARCH_IDS, SHAPES, get_config, shape_applicable
from ..kernels import ref as _ref
from ..models.mamba import mamba_dims
from ..models.model import (
    DTYPES,
    LM,
    check_tensor_parallel,
    head_range,
    tree_leaves,
)
from ..models.sharding import (
    cache_mode,
    cache_slice,
    check_cache_layout,
    kv_cache_slice,
    local_bytes,
    param_specs,
    reference_cache_mode,
    resolve_cache_mode,
    spec_leaves,
    split_dims,
)
from ..train.optimizer import AdamWConfig
from ..train import train_state as _train_state
from ..train.train_state import (
    StepConfig,
    abstract_train_state,
    make_train_step,
    state_specs,
)
from .mesh import Mesh, data_axes
from .op_cost import OpCost

PEAK_FLOPS = 989e12  # bf16 dense, H100 SXM data sheet
PEAK_FLOPS_TF32 = 495e12  # TF32 dense, for an f32 config
HBM_BW = 3.35e12  # B/s
LINK_BW = 900e9  # B/s, NVLink (H100 SXM data sheet, a GPU's total)
TILE = 64  # K4/K5/K6/K6b tile rows

# --------------------------------------------------------------------------
# per-cell configuration policy (the reference's knobs_for)
# --------------------------------------------------------------------------


def knobs_for(cfg, shape, n_dp: int, overrides: dict):
    lm = LM(cfg)
    n_params = lm.param_count()
    big = n_params > 3e10
    micro = overrides.get("microbatches")
    if micro is None:
        if shape.kind == "train" and n_params > 2e9:
            micro = max(1, shape.global_batch // n_dp)
        else:
            micro = 1
    opt = AdamWConfig(
        moment_dtype=overrides.get(
            "moment_dtype", "bfloat16" if big else "float32"
        ),
        master_dtype=overrides.get(
            "master_dtype", None if big else "float32"
        ),
    )
    step = StepConfig(
        microbatches=micro,
        accum_dtype=overrides.get(
            "accum_dtype", "bfloat16" if big else "float32"
        ),
        skip_masked=overrides.get("skip_masked", False),
    )
    return lm, opt, step


# --------------------------------------------------------------------------
# inputs on meta (no allocation)
# --------------------------------------------------------------------------


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg, shape, lm: LM, rows: Optional[int] = None) -> dict:
    """Meta tokens (and a vlm's image, and decode's caches) for ``rows``
    sequences (default: the shape's global batch)."""
    B = shape.global_batch if rows is None else rows
    S = shape.seq_len
    toks = _meta((B, S if shape.kind != "decode" else 1), torch.int32)
    img = None
    if cfg.family == "vlm":
        img = _meta((B, cfg.n_img_tokens, cfg.d_model), DTYPES[cfg.dtype])
    if shape.kind == "decode":
        caches = lm.init_caches(B, S, device="meta")
        return dict(token=toks, caches=caches, pos=S - 1, img=img)
    return dict(tokens=toks, img=img)


# --------------------------------------------------------------------------
# MODEL_FLOPS (useful flops): the reference's estimator, copied
# --------------------------------------------------------------------------


def model_flops(cfg, shape, lm: LM) -> float:
    B, S = shape.global_batch, shape.seq_len
    n_active = lm.active_param_count()
    d_inner = cfg.ssm_expand * cfg.d_model
    n_ssm_heads = d_inner // cfg.ssm_head_dim if cfg.ssm_state else 0

    n_attn = 0
    if cfg.family in ("dense", "audio", "moe"):
        n_attn = cfg.n_layers
    elif cfg.family == "vlm":
        n_attn = cfg.n_layers  # self + cross both attend
    elif cfg.family == "hybrid":
        n_attn = cfg.n_layers // cfg.shared_attn_every
    n_mamba = 0
    if cfg.family == "ssm":
        n_mamba = cfg.n_layers
    elif cfg.family == "hybrid":
        n_mamba = cfg.n_layers

    attn_dim = cfg.n_heads * cfg.hd if cfg.n_heads else 0

    if shape.kind == "decode":
        tokens = B
        f = 2.0 * n_active * tokens
        f += 4.0 * n_attn * B * S * attn_dim  # score+mix against the cache
        f += 5.0 * n_mamba * B * n_ssm_heads * cfg.ssm_head_dim * cfg.ssm_state
        return f

    tokens = B * S
    mult = 6.0 if shape.kind == "train" else 2.0
    f = mult * n_active * tokens
    # causal attention useful flops: 2*B*S^2*attn_dim fwd per layer (half of
    # the full S^2 score/mix matmuls), x3 for train
    f += (mult / 2.0) * 2.0 * n_attn * B * S * S * attn_dim
    # SSD: chunked matmuls ~ 2*B*S*(Q + 2N)*d_inner fwd per layer
    q = cfg.ssd_chunk
    f += (mult / 2.0) * 2.0 * n_mamba * B * S * (q + 2 * cfg.ssm_state) * d_inner
    return f


# --------------------------------------------------------------------------
# the kernels' plain twins, intercepted
# --------------------------------------------------------------------------

KERNELS = {
    "flash_attention_fwd": ("K4", "src/repro/kernels/flash.py:75",
                            "src/repro_torch/kernels/csrc/flash_fwd.cu"),
    "flash_attention_bwd": ("K5", "src/repro/kernels/flash.py:219",
                            "src/repro_torch/kernels/csrc/flash_bwd.cu"),
    "ssd_intra_chunk": ("K6", "src/repro/kernels/ssd.py:53",
                        "src/repro_torch/kernels/csrc/ssd.cu"),
    "ssd_intra_chunk_bwd": ("K6b", "none (the backward of K6)",
                            "src/repro_torch/kernels/csrc/ssd_bwd.cu"),
}


def _tiles(sq: int, skv: int, causal: bool) -> int:
    """64 x 64 tiles a flash kernel visits: all of them, or, causal (top
    left aligned), the kv tiles j <= i of each q tile i."""
    nq, nk = -(-sq // TILE), -(-skv // TILE)
    if not causal:
        return nq * nk
    return sum(min(nk, i + 1) for i in range(nq))


def _ssd_shapes(xbar, B):
    """(cells, groups, q, p, n): a group is the cells that share B and C
    (the heads of one batch x chunk, where B has size 1 or stride 0 along
    the cells' last axis), else one cell."""
    *lead, q, p = xbar.shape
    n = B.shape[-1]
    cells = math.prod(lead)
    shared = (len(lead) >= 2 and B.dim() == xbar.dim()
              and (B.shape[-3] == 1 or B.stride(-3) == 0))
    groups = cells // lead[-1] if shared else cells
    return cells, groups, q, p, n


def kernel_flops(name: str, args: tuple, causal: bool) -> int:
    """The products' FLOPs of one kernel launch at a plain twin's call
    (math FLOPs: K6 and K6b run three tf32 products for each f32 one on
    the tensor cores, which is not counted here)."""
    if name in ("flash_attention_fwd", "flash_attention_bwd"):
        q, k = args[0], args[1]
        bh, sq, hd = q.shape
        tiles = _tiles(sq, k.shape[1], causal)
        products = 2 if name == "flash_attention_fwd" else 7
        return 2 * products * bh * tiles * TILE * TILE * hd
    cells, groups, q, p, n = _ssd_shapes(args[0], args[2])
    if q <= 32:  # packed tiles (q <= 32): the twin's products
        gram = groups * 2 * q * q * n  # C B^T, once a group
        per = 2 * q * q * p + 2 * q * n * p
        return gram + cells * (per if name == "ssd_intra_chunk" else
                               2 * per + 2 * 2 * q * q * n)
    nt = -(-q // TILE)
    tri = nt * (nt + 1) // 2 * TILE * TILE
    if name == "ssd_intra_chunk":
        # G once a group on causal tiles; (G * L) xbar on causal tiles and
        # the state over every s tile, a cell
        return groups * 2 * tri * n + cells * (2 * tri * p + 2 * q * n * p)
    # K6b: G^T, dB and dC a group on causal tiles; dM^T and M^T dy on
    # causal tiles, xbar dstate^T and (B w) dstate a cell
    return groups * 3 * 2 * tri * n + cells * (2 * 2 * tri * p
                                               + 2 * 2 * q * n * p)


def _io_bytes(tensors) -> int:
    """Bytes of the tensors, each element once: a stride-0 (broadcast)
    dimension, as the heads' shared B and C, counts once."""
    return sum(math.prod(n for n, st in zip(t.shape, t.stride()) if st)
               * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


@contextlib.contextmanager
def plain_calls(oc: OpCost):
    """Intercept the kernels' plain twins in ``kernels.ref`` (where
    ``kernels.ops`` reaches them under ``force="ref"``): each call is
    counted with the FLOPs and bytes the ``OpCost`` counters took inside
    it, and the kernel's FLOPs and bytes at its shapes. Yields the
    per-kernel totals."""
    totals = {name: dict(launches=0, plain_flops=0, plain_bytes=0,
                         kernel_flops=0, kernel_bytes=0, shapes={})
              for name in KERNELS}
    totals["optimizer"] = dict(flops=0, all_flops=0, bytes=0)
    saved = {name: getattr(_ref, name) for name in KERNELS}
    update = _train_state.adamw_update

    def counted_update(*args, **kwargs):
        f0, a0, b0 = oc.flops, oc.all_flops, oc.hbm_bytes
        out = update(*args, **kwargs)
        t = totals["optimizer"]
        t["flops"] += oc.flops - f0
        t["all_flops"] += oc.all_flops - a0
        t["bytes"] += oc.hbm_bytes - b0
        return out

    def wrap(name, fn):
        def call(*args, **kwargs):
            f0, b0 = oc.flops, oc.hbm_bytes
            out = fn(*args, **kwargs)
            t = totals[name]
            t["launches"] += 1
            t["plain_flops"] += oc.flops - f0
            t["plain_bytes"] += oc.hbm_bytes - b0
            causal = kwargs.get("causal", True)
            t["kernel_flops"] += kernel_flops(name, args, causal)
            outs = out if isinstance(out, tuple) else (out,)
            t["kernel_bytes"] += _io_bytes(args) + _io_bytes(outs)
            key = (tuple(tuple(a.shape) for a in args
                         if isinstance(a, torch.Tensor)),
                   causal if "flash" in name else None)
            t["shapes"][key] = t["shapes"].get(key, 0) + 1
            return out
        return call

    for name, fn in saved.items():
        setattr(_ref, name, wrap(name, fn))
    _train_state.adamw_update = counted_update
    try:
        yield totals
    finally:
        for name, fn in saved.items():
            setattr(_ref, name, fn)
        _train_state.adamw_update = update


def _kernel_records(totals: dict) -> list:
    out = []
    for name in KERNELS:
        t = totals[name]
        if not t["launches"]:
            continue
        kid, replaces, source = KERNELS[name]
        if name.startswith("flash"):
            note = ("the twin runs every score of (Sq, Skv): "
                    + ("five" if name.endswith("bwd") else "two")
                    + " products over the whole matrix; the kernel visits "
                    "the 64 x 64 tiles the mask leaves (all of them when "
                    "not causal) and runs "
                    + ("seven products a tile (S and dP in both of its "
                       "kernels)" if name.endswith("bwd") else
                       "two products a tile"))
        else:
            note = ("the twin computes C B^T once per batch x chunk where "
                    "the heads share B and C, and every (q, q) product in "
                    "full for each cell; the kernel computes only the "
                    "causal 64 x 64 tiles of the (q, q) products, and "
                    "runs each f32 product as three tf32 ones (not "
                    "counted)")
        out.append(dict(
            kernel=kid, name=name, replaces=replaces, source=source,
            launches=t["launches"], plain_flops=float(t["plain_flops"]),
            kernel_flops=float(t["kernel_flops"]),
            plain_bytes=float(t["plain_bytes"]),
            kernel_bytes=float(t["kernel_bytes"]),
            calls=[dict(shapes=[list(x) for x in shp], causal=causal,
                        launches=n)
                   for (shp, causal), n in sorted(t["shapes"].items(),
                                                  key=lambda kv: -kv[1])],
            note=note))
    return out


# --------------------------------------------------------------------------
# collectives of the FSDP step (train/train_state.py's schedule)
# --------------------------------------------------------------------------


def fsdp_collectives(lm: LM, step_cfg: StepConfig, n: int,
                     global_batch: int, tp: int = 1) -> dict:
    """Operand bytes a position puts into the sharded step's data-axis
    collectives in one step over ``n`` positions of one data axis and
    ``tp`` of the model axis (the tensor-parallel specs where ``tp > 1``;
    what ``launch.mesh.collective_bytes`` counts for it): the all-gather
    of each data-sharded slice of the position's model slices
    (``gather_over``, once a step); where the batch splits over the data
    positions (``global_batch % (M n) == 0``), per microbatch a
    reduce-scatter of each data-sharded gradient leaf (a model slice) and
    an all-reduce of each other one, cast to ``accum_dtype``, the loss's
    all-reduce (f32) and, with experts, the all-reduce of the (MoE
    layers, E) first-choice counts (f32) between the routing pass and the
    gradient pass; the clip norm's all-reduce once a step."""
    if n * tp <= 1:
        return {}
    params = lm.abstract_params()
    specs = spec_leaves(params, param_specs(
        params, ("data",), tp="model" if tp > 1 else None))
    M = step_cfg.microbatches
    asz = DTYPES[step_cfg.accum_dtype].itemsize
    out = {"all-reduce": 4}
    leaves = []  # (data-split?, a position's model-slice numel, the leaf)
    for leaf, spec in zip(tree_leaves(params), specs):
        ddim, mdim = split_dims(spec, "model")
        leaves.append((ddim is not None, leaf.numel()
                       // (tp if mdim is not None else 1), leaf))
    if n > 1:
        out["all-gather"] = sum(numel // n * leaf.element_size()
                                for split, numel, leaf in leaves if split)
    if n > 1 and global_batch % (M * n) == 0:
        out["reduce-scatter"] = 0
        for split, numel, _leaf in leaves:
            out["reduce-scatter" if split else "all-reduce"] += \
                M * numel * asz
        out["all-reduce"] += M * 4 * (1 + _moe_layers(lm) * lm.cfg.n_experts)
    return out


def _moe_layers(lm: LM) -> int:
    """The MoE sub-layers of a model (one a ``moe`` or ``moe_pair``
    block)."""
    return sum(count for kind, count in lm.plan
               if kind in ("moe", "moe_pair"))


def tp_collectives(lm: LM, step_cfg: StepConfig, n_dp: int, tp: int,
                   batch: tuple) -> dict:
    """Operand bytes a position puts into the model axis's collectives in
    one tensor-parallel step (``LM.tp_loss`` under the sharded step) over
    ``n_dp`` data and ``tp`` model positions, ``batch`` = (global batch,
    sequence): per microbatch of ``rows`` rows (the batch over M, and over
    ``n_dp`` where it splits), per dense sub-layer pair the attention-out
    and MLP-out reduce-outs, their copy-ins' backward sums and remat's
    recompute of both reduce-outs (their operands f32: ``WideProduct``),
    a hybrid's shared block counting as one pair each time it runs and a
    vlm's cross-attention block as one pair (its k and v come from the
    image rows, which no collective moves); per MoE sub-layer the same
    for its attention, and for its experts the combine's reduce-out (the
    model's dtype) with remat's recompute, the copy-ins' backward sums of
    the normed input and of the gates ((rows, S, top_k) f32); per
    attention sub-layer where ``tp`` does not divide ``n_kv``, the
    regroup of its ``wk`` and ``wv`` slices (and of ``wq`` and ``wo``
    where ``tp`` does not divide ``n_heads`` either; the model's dtype)
    with remat's recompute, and the regroup's backward sum of those
    leaves whole (f32); per Mamba2 block (``mamba.tp_mamba_apply``) the
    gated norm's sum of squares ((rows, S) f32) and ``out_proj``'s (f32)
    reduce-outs with remat's recompute, the copy-ins' backward sums of
    the normed input and of the summed squares, the regroup of its
    ``in_proj``, ``conv_w`` and ``conv_b`` slices (the model's dtype)
    with remat's recompute and the regroup's backward sum of those leaves
    whole (f32); the embedding's reduce-out and the head's copy-in (the
    model's dtype); the loss's gold and sum-of-exp reduce-outs and its max
    ((rows, S - 1) f32 each); and, where a moe model's rows split over the
    data axis, the routing pass's reduce-outs and regroups (the embedding
    and the blocks once, no gradient, no head)."""
    if tp <= 1:
        return {}
    cfg = lm.cfg
    B, S = batch
    M = step_cfg.microbatches
    split = n_dp > 1 and B % (M * n_dp) == 0
    rows = B // M // (n_dp if split else 1)
    tok = rows * S * cfg.d_model
    isz = DTYPES[cfg.dtype].itemsize
    act = tok * isz
    vec = rows * (S - 1) * 4
    sq = rows * S * 4
    L = sum(count * (cfg.cross_attn_every if kind == "vlm_super" else 1)
            for kind, count in lm.plan
            if kind in ("dense", "moe_pair", "zamba_super", "vlm_super"))
    E = _moe_layers(lm)
    Lm = sum(count * (cfg.shared_attn_every if kind == "zamba_super" else 1)
             for kind, count in lm.plan if kind in ("mamba", "zamba_super"))
    gate = rows * S * cfg.top_k * 4
    # one pass's reduce-outs
    blocks = 2 * L * tok * 4 + E * (tok * 4 + act) + Lm * (tok * 4 + sq)
    routing = act + blocks if E and split else 0
    out = {"reduce-out": M * (act + 2 * blocks + 2 * vec + routing),
           "copy-in": M * (act * (2 * L + 2 * E + 1) + E * gate
                           + Lm * (act + sq)),
           "max": M * vec}
    # the elements of the leaves regrouped whole in one pass: each
    # attention sub-layer's and each Mamba2 block's
    whole = 0
    if cfg.n_kv and cfg.n_kv % tp:
        per = 2 * cfg.d_model * cfg.n_kv * cfg.hd  # wk, wv
        if cfg.n_heads % tp:
            per += 2 * cfg.d_model * cfg.n_heads * cfg.hd  # wq, wo
        whole += (L + E) * per
    if Lm:
        d_inner, H, N = mamba_dims(cfg)
        whole += Lm * (cfg.d_model * (2 * d_inner + 2 * N + H)
                       + (cfg.d_conv + 1) * (d_inner + 2 * N))
    if whole:
        passes = 3 if E and split else 2  # forward, remat (and routing)
        out["regroup"] = M * passes * whole // tp * isz
        out["regroup-sum"] = M * whole * 4
    return out


def serve_collectives(lm: LM, tp: int, rows: int, seq: int,
                      kind: str, mode: str = "heads",
                      cache_len: Optional[int] = None) -> dict:
    """Operand bytes a position puts into the model axis's collectives in
    one ``LM.tp_prefill`` of ``rows`` x ``seq`` tokens (``kind``
    "prefill") or one ``LM.tp_decode_step`` of ``rows`` tokens
    ("decode"), over ``tp`` model positions, with caches of ``cache_len``
    slots (default ``seq``) in the kv cache layout ``mode``
    (``sharding.CACHE_MODES``): the embedding's reduce-out
    (the model's dtype); per attention sub-layer, self or cross, its
    ``wo`` products' reduce-out (f32: ``WideProduct``), and where ``tp``
    does not divide ``n_kv`` the regroup of its ``wk`` and ``wv`` slices
    (not in a decode step's cross attention, which reads the image's
    cached keys and values) and, where it does not divide ``n_heads``
    either, of ``wq`` and ``wo``; per MLP sub-layer its ``w_out``
    products' reduce-out (f32); per MoE sub-layer its combine's
    reduce-out (the model's dtype); per Mamba2 block its gated norm's sum
    of squares ((rows, tokens) f32) and ``out_proj``'s (f32)
    reduce-outs, and the regroup of its ``in_proj``, ``conv_w`` and
    ``conv_b`` slices; and the last position's logits, each position's
    vocab columns gathered whole ("gather-out", the model's dtype). In
    the "hd" and "seq" layouts, per self-attention sub-layer what the
    first position receives by all-to-all (the model's dtype) and puts
    into the all-reduces and max (f32; ``model._relay_kv``,
    ``model._tp_split_attn_decode``): a prefill's k and v, its columns
    of every kv head ("hd") or its slots of every kv head up to ``seq``
    ("seq"); a decode step's q, k and v of the token, its columns of
    every head and its query heads' outputs whole, and the scores
    (rows, heads, cache_len) ("hd"), or q, k and v whole, the max (rows,
    heads) and the sums of exps and P V (rows, heads, hd + 1) ("seq").
    No copy-in or regroup-sum: nothing runs backward, and nothing takes
    a max over the vocab. The data axes move nothing: the engine gathers
    the parameters' model slices once, when it is built."""
    if tp <= 1:
        return {}
    cfg = lm.cfg
    mode = resolve_cache_mode(cfg, tp, mode)
    L = cache_len or seq
    S = seq if kind == "prefill" else 1
    isz = DTYPES[cfg.dtype].itemsize
    tok = rows * S * cfg.d_model
    act = tok * isz
    n_mlp = sum(count * (cfg.cross_attn_every if kind_ == "vlm_super"
                         else 1)
                for kind_, count in lm.plan
                if kind_ in ("dense", "moe_pair", "zamba_super",
                             "vlm_super"))
    n_cross = sum(count for kind_, count in lm.plan if kind_ == "vlm_super")
    E = _moe_layers(lm)
    Lm = sum(count * (cfg.shared_attn_every if kind_ == "zamba_super"
                      else 1)
             for kind_, count in lm.plan if kind_ in ("mamba",
                                                      "zamba_super"))
    n_attn = n_mlp + E  # every MLP's block and every MoE block attend
    out = {"reduce-out": act + n_attn * tok * 4 + n_mlp * tok * 4
           + E * act + Lm * (tok * 4 + rows * S * 4),
           "gather-out": rows * cfg.vocab_padded // tp * isz}
    whole = 0
    if cfg.n_kv and cfg.n_kv % tp:
        kv = 2 * cfg.d_model * cfg.n_kv * cfg.hd  # wk, wv
        qo = (2 * cfg.d_model * cfg.n_heads * cfg.hd  # wq, wo
              if cfg.n_heads % tp else 0)
        kv_layers = n_attn - (n_cross if kind == "decode" else 0)
        whole += kv_layers * kv + n_attn * qo
    if Lm:
        d_inner, H, N = mamba_dims(cfg)
        whole += Lm * (cfg.d_model * (2 * d_inner + 2 * N + H)
                       + (cfg.d_conv + 1) * (d_inner + 2 * N))
    if whole:
        out["regroup"] = whole // tp * isz
    n_self = n_attn - n_cross
    if cfg.n_kv and mode != "heads":
        check_cache_layout(cfg, tp, mode, L)
        H, G, hd = cfg.n_heads, cfg.n_kv, cfg.hd
        slots, c = kv_cache_slice(mode, tp, 0, hd, L)
        cols = c.stop - c.start
        if kind == "prefill":
            toks = min(S, slots.stop) - slots.start
            out["all-to-all"] = n_self * 2 * rows * toks * G * cols * isz
        else:
            lo, hi = head_range(H, tp, 0)
            back = rows * (hi - lo) * hd if mode == "hd" else 0
            out["all-to-all"] = n_self * (rows * (H + 2 * G) * cols
                                          + back) * isz
            out["all-reduce"] = n_self * rows * H * (
                L if mode == "hd" else hd + 1) * 4
            if mode == "seq":
                out["max"] = n_self * rows * H * 4
    return out


def _cache_bytes(lm: LM, caches, tp: int, mode: str = "heads") -> int:
    """Bytes of the largest model position's cache slices in the kv cache
    layout ``mode`` (``sharding.cache_slice``)."""
    return max(_io_bytes(tree_leaves(cache_slice(lm, caches, tp, j, mode)))
               for j in range(tp))


# --------------------------------------------------------------------------
# counting a cell
# --------------------------------------------------------------------------


def meta_mesh(shape, axes) -> Mesh:
    """An in-process mesh over ``meta`` positions: its shape and axis
    names for the specs, with no card behind it."""
    return Mesh(shape, axes, [torch.device("meta")] * math.prod(shape),
                multi_rank=False)


def production_mesh(kind: str) -> Mesh:
    if kind == "multi":
        return meta_mesh((2, 16, 16), ("pod", "data", "model"))
    return meta_mesh((16, 16), ("data", "model"))


def _storages(tree) -> dict:
    return {id(t.untyped_storage()): t.untyped_storage().nbytes()
            for t in tree_leaves(tree) if isinstance(t, torch.Tensor)}


def count_cell(cfg, shape, mesh: Mesh, overrides: Optional[dict] = None, *,
               opt_cfg: Optional[AdamWConfig] = None,
               step_cfg: Optional[StepConfig] = None) -> dict:
    """One data position's counts for ``cfg`` x ``shape`` on ``mesh``
    (any mesh whose data axes are "pod"/"data" and whose model axis, if
    any, is "model"). ``opt_cfg`` / ``step_cfg`` replace ``knobs_for``'s."""
    overrides = dict(overrides or {})
    fsdp = data_axes(mesh)
    n_dp = mesh.axis_size(fsdp)
    tp = mesh.shape.get("model", 1)
    lm, opt_k, step_k = knobs_for(cfg, shape, n_dp, overrides)
    opt_cfg = opt_cfg or opt_k
    step_cfg = step_cfg or step_k
    shardable = (shape.global_batch % n_dp == 0
                 and shape.global_batch >= n_dp)
    if shape.kind == "train":
        # the sharded step splits a batch that divides by M x the
        # positions, else every position takes it whole
        shardable = shape.global_batch % (step_cfg.microbatches * n_dp) == 0
    rows = shape.global_batch // n_dp if shardable else shape.global_batch
    mode = overrides.get("cache_shard", "heads")
    tp_axis = "model" if "model" in mesh.shape else None
    abstract = lm.abstract_params()
    pspecs = param_specs(abstract, fsdp, tp=tp_axis)
    ins = input_specs(cfg, shape, lm, rows)
    oc = OpCost()
    extra: dict = {}
    t0 = time.perf_counter()
    with plain_calls(oc) as totals:
        if shape.kind == "train":
            state = abstract_train_state(lm, opt_cfg)
            batch = {"tokens": ins["tokens"]}
            if ins["img"] is not None:
                batch["img"] = ins["img"]
            step = make_train_step(lm, opt_cfg, step_cfg, force="ref")
            args_tree = (state, batch)
            with oc:
                watched = oc.watch(args_tree)
                if cfg.n_experts and n_dp > 1 and shardable:
                    # the sharded step's routing pass, a microbatch at once
                    mb = rows // step_cfg.microbatches
                    for i in range(step_cfg.microbatches):
                        lm.route(state["params"],
                                 batch["tokens"][i * mb:(i + 1) * mb],
                                 force="ref")
                new_state, metrics = step(state, batch)
            outs = (new_state, metrics)
            sspecs = state_specs(pspecs, opt_cfg)
            arg_bytes = (local_bytes(state, sspecs, mesh)
                         + _io_bytes(batch.values()))
            extra["microbatches"] = step_cfg.microbatches
        elif shape.kind == "prefill":
            with torch.no_grad(), oc:
                watched = oc.watch((abstract, ins["tokens"], ins["img"]))
                outs = lm.prefill(abstract, ins["tokens"], ins["img"],
                                  force="ref")
            args_tree = (abstract, ins)
            arg_bytes = (local_bytes(abstract, pspecs, mesh)
                         + _io_bytes((ins["tokens"], ins["img"])))
        elif shape.kind == "decode":
            with torch.no_grad(), oc:
                watched = oc.watch((abstract, ins["token"], ins["caches"]))
                outs = lm.decode_step(abstract, ins["token"], ins["caches"],
                                      ins["pos"], ins["img"], force="ref")
            args_tree = (abstract, ins)
            try:  # a position's caches in the layout counted
                arg_bytes = (local_bytes(abstract, pspecs, mesh)
                             + _cache_bytes(lm, ins["caches"], tp, mode)
                             + _io_bytes((ins["token"], ins["img"])))
            except ValueError as e:  # a layout the axis cannot split
                arg_bytes, mem_reason = None, str(e)
        else:
            raise ValueError(shape.kind)
    trace_s = time.perf_counter() - t0
    res = oc.result()
    kernels = _kernel_records(totals)

    # memory: outputs that alias an argument's storage, and fresh ones
    arg_st = _storages(args_tree)
    out_st = _storages(outs)
    alias = sum(b for k, b in out_st.items() if k in arg_st)
    fresh = sum(b for k, b in out_st.items() if k not in arg_st)
    temp = max(0, res["peak_live_bytes"] - watched - fresh)
    if shape.kind == "train" and n_dp > 1:
        # FSDP holds the whole gathered parameters beside its slices, and
        # a leaf's reduce as n f32 slices (one leaf's f32 elements); its
        # microbatch accumulators are slices where the trace's are whole
        n_el = sum(p.numel() for p in tree_leaves(abstract))
        temp += sum(p.numel() * p.element_size()
                    for p in tree_leaves(abstract))
        temp += 4 * max(p.numel() for p in tree_leaves(abstract))
        if step_cfg.microbatches > 1:
            temp -= int(n_el * DTYPES[step_cfg.accum_dtype].itemsize
                        * (1 - 1 / n_dp))
    temp //= tp
    fresh //= tp
    mem = dict(
        temp_bytes=int(temp),
        saved_bytes=int(res["saved_bytes"] // tp),
        largest_op_bytes=int(res["largest_op_bytes"] // tp),
        traced_peak_bytes=int(res["peak_live_bytes"]),
    )
    if arg_bytes is None:  # no caches in a refused layout: no figures
        mem.update(argument_bytes=None, output_bytes=None, alias_bytes=None,
                   peak_estimate_gib=None, reason=mem_reason)
    else:  # the aliased outputs are arguments: on a device, scaled so
        alias_dev = alias * arg_bytes // max(watched, 1)
        mem.update(argument_bytes=int(arg_bytes),
                   output_bytes=int(alias_dev + fresh),
                   alias_bytes=int(alias_dev),
                   peak_estimate_gib=round((arg_bytes + fresh + temp)
                                           / 2**30, 3))

    # the kernel path's counts: the twins' replaced by the kernels', and
    # AdamW on a position's slices (1/n_dp of the traced whole-tree update)
    opt = totals["optimizer"]
    opt_share = 1 - 1 / n_dp
    flops_pos = (res["flops"] - sum(k["plain_flops"] for k in kernels)
                 + sum(k["kernel_flops"] for k in kernels)
                 - opt["flops"] * opt_share)
    bytes_pos = (res["hbm_bytes"] - sum(k["plain_bytes"] for k in kernels)
                 + sum(k["kernel_bytes"] for k in kernels)
                 - opt["bytes"] * opt_share)
    tp_colls, tp_reason = {}, None
    if shape.kind == "train" and tp > 1:
        try:
            check_tensor_parallel(cfg, tp)
        except NotImplementedError as e:
            tp_reason = str(e)
        tp_colls = tp_collectives(lm, step_cfg, n_dp, tp,
                                  (shape.global_batch, shape.seq_len))
    elif tp > 1:  # prefill and decode
        try:
            check_tensor_parallel(cfg, tp)
            tp_colls = serve_collectives(lm, tp, rows, shape.seq_len,
                                         shape.kind, mode)
        except (NotImplementedError, ValueError) as e:
            tp_colls, tp_reason = None, str(e)
        extra["cache_mode"] = cache_mode(cfg, tp, mode)
        if extra["cache_mode"] != reference_cache_mode(cfg, tp):
            extra["cache_mode_reference"] = reference_cache_mode(cfg, tp)
    tp_bytes = float(sum((tp_colls or {}).values()))
    # the data axes' bytes: a device's in the tensor-parallel step where it
    # is counted, else the FSDP specs' over an ideal model-axis split
    if shape.kind != "train":
        colls_dev = colls = {}
    elif tp > 1 and tp_colls is not None:
        colls_dev = fsdp_collectives(lm, step_cfg, n_dp, shape.global_batch,
                                     tp=tp)
        colls = {k: v * tp for k, v in colls_dev.items()}
    else:
        colls = fsdp_collectives(lm, step_cfg, n_dp, shape.global_batch)
        colls_dev = {k: v / tp for k, v in colls.items()}
    coll_pos = float(sum(colls.values()))
    return dict(
        lm=lm, rows=rows, n_dp=n_dp, tp=tp, shardable=shardable,
        counted=dict(flops=res["flops"], all_flops=res["all_flops"],
                     hbm_bytes=res["hbm_bytes"], ops=res["ops"],
                     optimizer=dict(opt)),
        per_position=dict(flops=flops_pos, hbm_bytes=bytes_pos,
                          collective_bytes=coll_pos, collectives=colls),
        per_device=dict(flops=flops_pos / tp, hbm_bytes=bytes_pos / tp,
                        collective_bytes=coll_pos / tp + tp_bytes),
        collectives=dict(sorted(colls_dev.items())),
        tp_collectives=tp_colls, tp_collectives_reason=tp_reason,
        top_dots=res["top_dots"], kernels=kernels, memory=mem,
        trace_s=trace_s, extra=extra)


def roofline(flops_dev: float, bytes_dev: float, coll_dev: float,
             dtype: str) -> dict:
    peak = PEAK_FLOPS_TF32 if dtype == "float32" else PEAK_FLOPS
    return dict(compute_s=flops_dev / peak, memory_s=bytes_dev / HBM_BW,
                collective_s=coll_dev / LINK_BW)


# --------------------------------------------------------------------------
# cell runner
# --------------------------------------------------------------------------


def _record_path(out_dir, arch, shape_name, mesh_kind, tag):
    return os.path.join(out_dir,
                        f"{arch}__{shape_name}__{mesh_kind}__{tag}.json")


def run_cell(arch: str, shape_name: str, mesh_kind: str, overrides: dict,
             out_dir: Optional[str]) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if not shape_applicable(cfg, shape):
        print(f"SKIP {arch} x {shape_name}: full-attention arch at 500k "
              "(DESIGN.md §7)")
        return dict(arch=arch, shape=shape_name, mesh=mesh_kind,
                    skipped="full-attention long-context")
    mesh = production_mesh(mesh_kind)
    n_chips = mesh.size
    c = count_cell(cfg, shape, mesh, overrides)
    lm = c["lm"]
    dev = c["per_device"]
    terms = roofline(dev["flops"], dev["hbm_bytes"],
                     dev["collective_bytes"], cfg.dtype)
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape, lm)
    useful = (mf / n_chips) / dev["flops"] if dev["flops"] else 0.0
    tp = c["tp"]
    rec = dict(
        arch=arch, shape=shape_name, mesh=mesh_kind, chips=n_chips,
        params=lm.param_count(), active_params=lm.active_param_count(),
        per_device=dev,
        per_device_split=(f"a data position's counts over the {tp} "
                          f"positions of the model axis: an ideal "
                          f"tensor-parallel split (the port trains and "
                          f"serves every family so), plus the model "
                          f"axis's own collectives where they are "
                          f"counted"),
        per_position=c["per_position"],
        rows_per_position=c["rows"],
        counted=c["counted"],
        kernels=c["kernels"],
        collectives=c["collectives"],
        tp_collectives=c["tp_collectives"],
        tp_collectives_reason=c["tp_collectives_reason"],
        top_dots=[[round(f / tp / 1e9, 2), m] for f, m in c["top_dots"][:8]],
        top_collectives=[
            [round(b / 1e9, 3), k] for k, b in sorted(
                {**c["collectives"], **(c["tp_collectives"] or {})}.items(),
                key=lambda kv: -kv[1])[:8]
        ],
        terms_s=terms, dominant=dominant,
        model_flops_global=mf, useful_flops_ratio=round(useful, 4),
        roofline_bound_s=max(terms.values()),
        memory=c["memory"],
        constants=dict(peak_flops=(PEAK_FLOPS_TF32 if cfg.dtype == "float32"
                                   else PEAK_FLOPS),
                       hbm_bw=HBM_BW, link_bw=LINK_BW,
                       source="H100 SXM data sheet (PERF.md section 3)"),
        trace_s=round(c["trace_s"], 1),
        **c["extra"], **{f"override_{k}": v for k, v in overrides.items()},
    )
    print(json.dumps(rec, indent=2))
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        path = _record_path(out_dir, arch, shape_name, mesh_kind,
                            overrides.get("tag", "base"))
        with open(path, "w") as f:
            json.dump(rec, f, indent=2)
    return rec


def run_all(mesh_kinds: list[str], out_dir: str, timeout: int) -> None:
    """Every cell in its own subprocess, cached by file: a record already
    in ``out_dir`` is not counted again."""
    failures = []
    env = dict(os.environ)
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = src + (os.pathsep + env["PYTHONPATH"]
                               if env.get("PYTHONPATH") else "")
    for arch in ARCH_IDS:
        for shape_name in SHAPES:
            for mk in mesh_kinds:
                cfg = get_config(arch)
                if not shape_applicable(cfg, SHAPES[shape_name]):
                    continue
                path = _record_path(out_dir, arch, shape_name, mk, "base")
                if os.path.exists(path):
                    print(f"cached: {path}")
                    continue
                cmd = [
                    sys.executable, "-m", "repro_torch.launch.dryrun",
                    "--arch", arch, "--shape", shape_name, "--mesh", mk,
                    "--out-dir", out_dir,
                ]
                print("RUN", " ".join(cmd), flush=True)
                try:
                    r = subprocess.run(cmd, timeout=timeout, env=env,
                                       stdout=subprocess.DEVNULL)
                    if r.returncode != 0:
                        failures.append((arch, shape_name, mk, r.returncode))
                except subprocess.TimeoutExpired:
                    failures.append((arch, shape_name, mk, "timeout"))
    if failures:
        print("FAILURES:", failures)
        sys.exit(1)
    print("all cells OK")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out-dir", default="build/dryrun")
    ap.add_argument("--timeout", type=int, default=1800)
    # perf-iteration overrides
    ap.add_argument("--microbatches", type=int)
    ap.add_argument("--skip-masked", action="store_true")
    ap.add_argument("--moment-dtype")
    ap.add_argument("--master-dtype")
    ap.add_argument("--accum-dtype")
    ap.add_argument("--cache-shard", choices=["auto", "heads", "hd", "seq"])
    ap.add_argument("--tag", default="base")
    args = ap.parse_args(argv)

    overrides = {}
    for k in ("microbatches", "moment_dtype", "master_dtype", "accum_dtype",
              "cache_shard"):
        v = getattr(args, k)
        if v is not None:
            overrides[k] = v
    if args.skip_masked:
        overrides["skip_masked"] = True
    if args.tag != "base":
        overrides["tag"] = args.tag

    kinds = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        run_all(kinds, args.out_dir, args.timeout)
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        for mk in kinds:
            run_cell(args.arch, args.shape, mk, overrides, args.out_dir)


if __name__ == "__main__":
    main()
