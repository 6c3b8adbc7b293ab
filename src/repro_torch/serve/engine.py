"""Batched serving engine: prefill, then greedy decode against caches.

Reference: ``repro/serve/engine.py`` (``pad_caches`` :13, ``Engine`` :35).
The reference prefills into caches of the prompt's length and pads the
attention caches to ``max_len`` by a shape heuristic (any leaf whose
axis -3 is the prompt's length, so a vlm's image cache too when the prompt
is ``n_img_tokens`` long); here the prefill writes straight into caches
allocated at ``max_len`` (the same tokens, without the padded copy), and
``pad_caches`` grows a cache tree by the shapes ``LM.init_caches`` gives
it: the self-attention caches of every plan kind grow, the Mamba2 and
image caches keep their length. Decode steps update the caches in place.

On a mesh (ROADMAP.md step 13.12), ``Engine(..., mesh=)`` serves as the
reference's dry run jits ``prefill`` and ``decode_step`` on sharded
inputs: the parameters are placed by ``param_specs(..., tp="model")``
(``models.sharding.shard_tree``, or a ``ShardedTree`` given as it is) and
each model slice is gathered whole along the data axes once, when the
engine is built (``gather_over``; positions of one model index on one
device share one copy, as the sharded train step does). ``generate``
splits the prompt rows over the data axes by ``batch_spec``'s rule (every
row takes the whole batch where they do not divide it), and each data
row runs its positions of the model axis (a ``launch.mesh.ModelGroup``)
through ``LM.tp_prefill`` and ``LM.tp_decode_step``, each position
holding its own slices of the caches, in the kv cache layout
``cache_mode`` (the port's "heads" by default; the reference's "hd" or
"seq", or "auto", ROADMAP.md step 13.13). The collectives of a ``generate``
are one row's, those of one position (``launch.mesh.collective_bytes``);
the engine's build counts its all-gather of the slices. An in-process mesh
with a "model" axis only: a multi-rank mesh is refused.
"""
from __future__ import annotations

import time
from functools import partial
from typing import Optional

import torch

from ..device import CUDA, DeviceLike, resolve_device
from ..launch.mesh import ModelGroup
from ..models import sharding as sh
from ..models.model import LM, tree_leaves, tree_map


def pad_caches(lm: LM, caches, cur_len: int, target_len: int):
    """Grow the self-attention KV caches from cur_len to target_len along
    the seq axis (Mamba2 state, conv and image caches are
    length-independent and pass through)."""
    first = tree_leaves(caches)[0]
    one = tree_leaves(lm.init_caches(1, cur_len, device="meta"))[0]
    batch = first.numel() // one.numel()
    grown = lm.init_caches(batch, target_len, device=first.device)

    def put(new, old):
        if new.shape == old.shape:
            return old
        new[..., :cur_len, :, :].copy_(old)
        return new

    return tree_map(put, grown, caches)


class Engine:
    def __init__(self, lm: LM, params, max_len: int, *, mesh=None,
                 force: Optional[str] = None, device: DeviceLike = CUDA,
                 cache_mode: str = "heads"):
        """``params``: the whole tree, or on a ``mesh`` also a
        ``ShardedTree`` placed by ``param_specs(..., tp="model")``
        (``device`` is then where the tokens come back). ``cache_mode``:
        the kv cache layout on a mesh's model axis (``LM.tp_prefill``'s:
        "heads", the reference's "hd" or "seq", or "auto")."""
        self.device = resolve_device(device)
        self.lm = lm
        self.max_len = max_len
        self.force = force
        self.mesh = mesh
        self.cache_mode = cache_mode
        self.timings: dict = {}  # of the last generate
        if mesh is None:
            self.params = params
            return
        if mesh.multi_rank or sh.TP not in mesh.shape:
            raise NotImplementedError(
                f"Engine(mesh=) serves on an in-process mesh with a "
                f"{sh.TP!r} axis, not on {mesh!r}")
        self.daxes = tuple(a for a in mesh.axis_names if a != sh.TP)
        if not isinstance(params, sh.ShardedTree):
            params = sh.shard_tree(params, sh.param_specs(
                lm.abstract_params(), self.daxes, tp=sh.TP), mesh)
        slices = sh.gather_over(params, self.daxes)
        del params
        # each data row's positions in shard order, and their trees: one
        # copy a (model index, device)
        self.rows: dict = {}
        on_dev: dict = {}
        for p in mesh.local_positions():
            j, dev = mesh.shard_index(p, (sh.TP,)), mesh.devices[p]
            if (j, dev) not in on_dev:
                on_dev[j, dev] = tree_map(lambda t: t.to(dev), slices[j])
            self.rows.setdefault(mesh.shard_index(p, self.daxes), []).append(
                (p, on_dev[j, dev]))
        self.params = None

    def _synced_clock(self) -> float:
        devs = {self.device} if self.mesh is None else \
            {self.device, *self.mesh.devices}
        for d in devs:
            if d.type == "cuda":
                torch.cuda.synchronize(d)
        return time.perf_counter()

    def _servers(self, tokens, img) -> list:
        """Per data row: (its rows of the batch, whether its tokens are
        returned, its prefill, its decode step (token, caches, pos)): the
        unsharded model's, or its positions' over the model axis."""
        lm, force, L = self.lm, self.force, self.max_len
        if self.mesh is None:
            return [(slice(None), True,
                     partial(lm.prefill, self.params, tokens, img,
                             cache_len=L, force=force),
                     partial(lm.decode_step, self.params, force=force))]
        B = tokens.shape[0]
        n = self.mesh.axis_size(self.daxes)
        split = B % n == 0 and B >= n  # batch_spec's rule
        out = []
        for r, (d, members) in enumerate(sorted(self.rows.items())):
            # every row serves the whole batch where it does not split:
            # the first row's tokens are returned
            sl = slice(d * B // n, (d + 1) * B // n) if split else slice(None)
            parts = [t for _p, t in members]
            group = ModelGroup(self.mesh, sh.TP, [p for p, _t in members],
                               count=r == 0)
            out.append((sl, split or r == 0,
                        partial(lm.tp_prefill, parts, tokens[sl], group,
                                None if img is None else img[sl],
                                cache_len=L, force=force,
                                cache_mode=self.cache_mode),
                        partial(lm.tp_decode_step, parts, group=group,
                                force=force)))
        return out

    def generate(
        self,
        tokens,  # (B, P) prompt
        steps: int,
        img=None,  # (B, n_img_tokens, d) image embeddings of a vlm
        *,
        return_logits: bool = False,
        forced=None,
    ):
        """Greedy continuation: (B, steps) int32 tokens; with
        ``return_logits`` also the (B, steps, V) logits each token was
        picked from. ``img`` goes to the prefill, which caches its keys and
        values for the decode steps. ``forced`` (B, steps - 1): the tokens
        the decode steps take in place of the greedy picks (the returned
        tokens are still the picks), so that two engines' logits compare
        step by step at the same inputs. Afterwards ``timings`` holds the
        host seconds of the prefill and of the decode steps, each ending in
        a device sync."""
        tokens = torch.as_tensor(tokens, device=self.device).long()
        B, P = tokens.shape
        assert P + steps <= self.max_len
        if forced is not None:
            forced = torch.as_tensor(forced, device=self.device).long()
            assert forced.shape == (B, steps - 1), forced.shape
        servers = self._servers(tokens, img)
        t0 = self._synced_clock()
        rows = []  # per data row: its caches, picks and logits
        for _sl, _keep, prefill, _step in servers:
            logits, caches = prefill()
            rows.append(dict(caches=caches, out=[torch.argmax(
                logits, -1).to(torch.int32)], seen=[logits]))
        t1 = self._synced_clock()
        for i in range(steps - 1):
            for (sl, _keep, _prefill, step), row in zip(servers, rows):
                tok = (row["out"][-1][:, None] if forced is None
                       else forced[sl, i:i + 1])
                logits, row["caches"] = step(tok, row["caches"], P + i)
                row["out"].append(torch.argmax(logits, -1).to(torch.int32))
                if return_logits:
                    row["seen"].append(logits)
        kept = [row for (_sl, keep, *_), row in zip(servers, rows) if keep]
        toks = torch.cat([torch.stack(r["out"], dim=1).to(self.device)
                          for r in kept])  # (B, steps)
        t2 = self._synced_clock()
        self.timings = dict(prefill_s=t1 - t0, decode_s=t2 - t1,
                            decode_steps=steps - 1)
        if return_logits:
            return toks, torch.cat([torch.stack(r["seen"], dim=1)
                                    .to(self.device) for r in kept])
        return toks
