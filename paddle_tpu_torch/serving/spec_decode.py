"""Speculative decoding: a draft model proposes, the target verifies.
The port's copy of ``paddle_tpu/serving/spec_decode.py``.

Greedy only, so the acceptance rule needs no rejection sampling and the
engine's output stays **bit-identical** to plain decode — the guarantee
crash-recovery replay relies on too.  No kernel of its own: every
forward here is ``forward_paged``, with the same kernels as the
target's.

* The draft model keeps its **own pools but the target's page ids** —
  same ``num_pages``/``page_size``, same allocator, same block tables.
  Its pools are in the draft config's dtype, never int8, whatever the
  target's pages are.  Every engine step mirrors the target's exact
  feed through the draft (one extra forward per step, same Tc), so the
  draft's kv tracks the target's fed counter in lockstep: no catch-up
  pass, prefix-cache pages donated by one request carry valid draft kv
  for the next, and a pool rebuild resets both sides at once.
* **Proposal** is k sequential Tc = 1 greedy draft decodes over the
  speculating slots, writing draft kv at positions ``fed..fed+k-1``
  through the already grown block tables.
* **Verification** is the target forward over ``[x0, d1..dk]`` at
  positions ``fed..fed+k``: a short ragged prefill row in the Tc =
  chunk step (``ScheduledSeq.spec`` marks it; the scheduler widened it
  before growth, so pages cover it).

Greedy acceptance (``greedy_accept``): with target argmax row
``g_0..g_k`` (``g_i`` = argmax after feeding token i of the chunk),
accept drafts while ``d_i == g_{i-1}`` and emit ``g_0..g_a``.  Each
emitted token is what single-token greedy decode would have produced.
Rejected positions leave stale kv past the new ``fed``, which the next
step's feed overwrites before any read.

The reference jit-compiles one draft step per Tc and returns new pools;
here the pools live on the engine's device and ``forward_paged`` writes
them in place.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..models import llama as _llama

__all__ = ["SpecDecodeConfig", "DraftModel", "greedy_accept"]


@dataclasses.dataclass
class SpecDecodeConfig:
    """Draft-model settings for one engine.

    ``cfg``/``params`` are any llama-family config and params with the
    **same vocabulary** as the target (checked at engine build); ``k``
    is the lookahead — each pure-decode row is widened to a verify
    chunk of ``1 + k`` tokens, so ``k`` must stay below the engine's
    prefill ``chunk``.  Passing the engine's own ``params`` object makes
    a self-draft that runs on the engine's weights (its int8 tensors on
    CUDA), not on a second copy."""

    cfg: object
    params: object
    k: int = 3


class DraftModel:
    """Device half of speculative decoding: draft pools shaped by the
    draft config but indexed by the *target's* page ids.  ``params`` are
    on ``device`` already (the engine places them)."""

    def __init__(self, cfg, params, *, num_pages: int, page_size: int,
                 device):
        self.cfg = cfg
        self.params = params
        self.device = torch.device(device)
        self._pool_shape = (cfg.num_hidden_layers,
                            cfg.num_key_value_heads,
                            int(num_pages), int(page_size),
                            cfg.head_dim)
        self._kp = self._vp = None
        self.reset()
        self.pool_bytes = 2 * self._kp.numel() * self._kp.element_size()

    def reset(self) -> None:
        """Fresh zero pools (the engine's pool rebuild: both sides replay
        from scratch, so draft kv stays in lockstep with the target).
        The old pools are dropped before the new ones are allocated."""
        self._kp = self._vp = None
        self._kp = torch.zeros(self._pool_shape, dtype=self.cfg.dtype,
                               device=self.device)
        self._vp = torch.zeros(self._pool_shape, dtype=self.cfg.dtype,
                               device=self.device)

    def forward(self, tokens, tbl, lens, qlens) -> np.ndarray:
        """One draft forward over the [R, Tc] batch (numpy inputs):
        writes draft kv for every fed position, returns the host argmax
        [R, Tc].  Used both to mirror the target's feed and as the
        proposal step (Tc == 1)."""
        args = [torch.from_numpy(a).to(self.device)
                for a in (tokens, tbl, lens, qlens)]
        with torch.no_grad():
            logits, _ = _llama.forward_paged(
                self.cfg, self.params, args[0], self._kp, self._vp,
                args[1], args[2], args[3])
            out = torch.argmax(logits, dim=-1).to(torch.int32)
        return out.cpu().numpy()

    def copy_page(self, src: int, dst: int) -> None:
        """Copy-on-write fork on the draft pools (the same page pair the
        target copied, so donated pages keep valid draft kv)."""
        for pool in (self._kp, self._vp):
            pool[:, :, dst] = pool[:, :, src]

    def propose(self, rows: List[Tuple[int, int, int, List[int]]],
                k: int, R: int, Bmax: int) -> Dict[int, List[int]]:
        """k sequential greedy draft decodes for the speculating slots.

        ``rows`` is ``(slot, last_token, fed, block_row)`` per row —
        the draft feeds ``last_token`` at position ``fed`` (its kv is
        valid through ``fed - 1`` by the mirror invariant) and chains
        its own argmax k times, writing draft kv as it goes.  Returns
        slot -> the k proposed token ids."""
        tokens = np.zeros((R, 1), np.int32)
        tbl = np.zeros((R, Bmax), np.int32)
        lens = np.zeros((R,), np.int32)
        qlens = np.zeros((R,), np.int32)
        cur: Dict[int, int] = {}
        pos: Dict[int, int] = {}
        for slot, last_tok, fed, block_row in rows:
            tbl[slot] = block_row
            cur[slot] = int(last_tok)
            pos[slot] = int(fed)
            qlens[slot] = 1
        drafts: Dict[int, List[int]] = {slot: [] for slot in cur}
        for _ in range(k):
            for slot in cur:
                tokens[slot, 0] = cur[slot]
                lens[slot] = pos[slot] + 1
            out = self.forward(tokens, tbl, lens, qlens)
            for slot in cur:
                d = int(out[slot, 0])
                drafts[slot].append(d)
                cur[slot] = d
                pos[slot] += 1
        return drafts

    def shutdown(self) -> None:
        self._kp = self._vp = None


def greedy_accept(drafts: List[int], target_row: List[int]) -> List[int]:
    """The rejection-sampling-free acceptance rule.

    ``target_row`` holds the target's argmax at each verify position:
    ``g_0`` after the real last token, ``g_i`` after draft ``d_i``.
    Emit ``g_0``; then accept drafts left to right while
    ``d_i == g_{i-1}`` (the draft guessed exactly the token plain
    greedy decode would have fed next), emitting ``g_i`` for each.
    The first mismatch stops.  The output is therefore always a prefix
    of (and at least one token of) what plain greedy decode emits."""
    emitted = [int(target_row[0])]
    for i, d in enumerate(drafts):
        if int(d) != int(target_row[i]):
            break
        emitted.append(int(target_row[i + 1]))
    return emitted
