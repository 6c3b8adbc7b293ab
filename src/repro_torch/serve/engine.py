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
"""
from __future__ import annotations

import time
from typing import Optional

import torch

from ..device import CUDA, DeviceLike, resolve_device
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
    def __init__(self, lm: LM, params, max_len: int, *,
                 force: Optional[str] = None, device: DeviceLike = CUDA):
        self.device = resolve_device(device)
        self.lm = lm
        self.params = params
        self.max_len = max_len
        self.force = force
        self.timings: dict = {}  # of the last generate

    def _synced_clock(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def generate(
        self,
        tokens,  # (B, P) prompt
        steps: int,
        img=None,  # (B, n_img_tokens, d) image embeddings of a vlm
        *,
        return_logits: bool = False,
    ):
        """Greedy continuation: (B, steps) int32 tokens; with
        ``return_logits`` also the (B, steps, V) logits each token was
        picked from. ``img`` goes to the prefill, which caches its keys and
        values for the decode steps. Afterwards ``timings`` holds the host
        seconds of the prefill and of the decode steps, each ending in a
        device sync."""
        tokens = torch.as_tensor(tokens, device=self.device).long()
        B, P = tokens.shape
        assert P + steps <= self.max_len
        t0 = self._synced_clock()
        logits, caches = self.lm.prefill(self.params, tokens, img,
                                         cache_len=self.max_len,
                                         force=self.force)
        out = [torch.argmax(logits, -1).to(torch.int32)]
        seen = [logits] if return_logits else None
        t1 = self._synced_clock()
        for i in range(steps - 1):
            tok = out[-1][:, None]
            logits, caches = self.lm.decode_step(self.params, tok, caches,
                                                 P + i, force=self.force)
            out.append(torch.argmax(logits, -1).to(torch.int32))
            if return_logits:
                seen.append(logits)
        toks = torch.stack(out, dim=1)  # (B, steps)
        t2 = self._synced_clock()
        self.timings = dict(prefill_s=t1 - t0, decode_s=t2 - t1,
                            decode_steps=steps - 1)
        if return_logits:
            return toks, torch.stack(seen, dim=1)
        return toks
