"""Seq2seq decoding: ``BeamSearchDecoder`` and ``dynamic_decode`` (the
port of ``paddle_tpu/nn/decode.py``).

A host-stepped loop over a step cell, with one host read a step (the
all-finished flag), finished beams extended by ``end_token`` at cost 0,
the parents backtracked at the end and ``impute_finished``.  The top-k
of a step is a stable descending sort: among equal candidates the lower
index wins, as in ``jax.lax.top_k``, on either device (``torch.topk``
promises no order of ties).  LLM generation is the other path
(``models/decoding.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.tensor import Tensor

__all__ = ["BeamSearchDecoder", "dynamic_decode"]


def _arr(x):
    return x._t if isinstance(x, Tensor) else x


def _map_states(fn, states):
    if isinstance(states, (list, tuple)):
        out = [_map_states(fn, s) for s in states]
        if hasattr(states, "_fields"):          # a namedtuple
            return type(states)(*out)
        return type(states)(out)
    if isinstance(states, dict):
        return {k: _map_states(fn, v) for k, v in states.items()}
    if states is None:
        return None
    return fn(_arr(states))


def _leaves(states):
    if isinstance(states, (list, tuple)):
        return [t for s in states for t in _leaves(s)]
    if isinstance(states, dict):
        return [t for s in states.values() for t in _leaves(s)]
    return [] if states is None else [_arr(states)]


def top_k_stable(x, k):
    """The ``k`` largest of each row and their indices; ties go to the
    lower index (``jax.lax.top_k``'s order)."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


class BeamSearchDecoder:
    """Beam search over a step cell (reference: decode.py:33).

    ``cell(inputs, states) -> (outputs, new_states)``; ``embedding_fn``
    maps token ids to cell inputs; ``output_fn`` maps cell outputs to
    vocabulary logits (identity when the cell emits logits).
    """

    def __init__(self, cell, start_token: int, end_token: int,
                 beam_size: int, embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    def _tile(self, a):
        """[B, ...] -> [B*beam, ...] (tile_beam_merge_with_batch)."""
        return torch.repeat_interleave(_arr(a), self.beam_size, dim=0)

    tile_beam_merge_with_batch = _tile

    def initialize(self, initial_cell_states):
        return _map_states(self._tile, initial_cell_states)

    def _logits_of(self, cell_out):
        out = cell_out[0] if isinstance(cell_out, (tuple, list)) \
            else cell_out
        if self.output_fn is not None:
            out = self.output_fn(out)
        return _arr(out)

    def step(self, tokens, states):
        """One expansion: tokens [B*beam] -> (log_probs [B*beam, V],
        new_states)."""
        inputs = Tensor._wrap(tokens)
        if self.embedding_fn is not None:
            inputs = self.embedding_fn(inputs)
        inputs_t = inputs if isinstance(inputs, Tensor) \
            else Tensor._wrap(torch.as_tensor(_arr(inputs)))
        states_t = _map_states(lambda a: Tensor(a), states)
        out = self.cell(inputs_t, states_t)
        cell_out, new_states = out if isinstance(out, tuple) and \
            len(out) == 2 else (out, states_t)
        logits = self._logits_of(cell_out)
        new_states = _map_states(lambda a: a, new_states)
        return torch.log_softmax(logits, dim=-1), new_states


def dynamic_decode(decoder: BeamSearchDecoder, inits=None,
                   max_step_num: int = 100, output_time_major: bool = False,
                   impute_finished: bool = True, is_test: bool = False,
                   return_length: bool = False, **kwargs):
    """Run the decoder to completion (reference: decode.py:605): expand
    beams until every beam emitted ``end_token`` or ``max_step_num``
    steps ran, then backtrack the parent ids into token sequences.

    Returns (predicted_ids, sequence_lengths), int32: predicted_ids
    [B, T, beam] ([T, B, beam] when ``output_time_major``), beams best
    first by accumulated log-prob.
    """
    with torch.no_grad():
        return _decode(decoder, inits, max_step_num, output_time_major,
                       impute_finished)


def _decode(decoder, inits, max_step_num, output_time_major,
            impute_finished):
    beam = decoder.beam_size
    states = decoder.initialize(inits)
    leaves = _leaves(states)
    if not leaves:
        raise ValueError("dynamic_decode needs initial cell states "
                         "(pass inits=cell.get_initial_states(...))")
    dev = leaves[0].device
    B = int(leaves[0].shape[0]) // beam

    tokens = torch.full((B * beam,), decoder.start_token, dtype=torch.int32,
                        device=dev)
    first = torch.arange(B * beam, device=dev) % beam == 0
    scores = torch.where(first, 0.0, float("-inf")).to(torch.float32)
    finished = torch.zeros((B * beam,), dtype=torch.bool, device=dev)
    lengths = torch.zeros((B * beam,), dtype=torch.int32, device=dev)
    step_tokens, step_parents = [], []
    rows = torch.arange(B, device=dev)[:, None] * beam

    for _ in range(int(max_step_num)):
        log_probs, new_states = decoder.step(tokens, states)
        V = log_probs.shape[-1]
        # finished beams only extend with end_token at zero cost
        fin_row = torch.full((V,), float("-inf"), dtype=log_probs.dtype,
                             device=dev)
        fin_row[decoder.end_token] = 0.0
        log_probs = torch.where(finished[:, None], fin_row, log_probs)
        cand = (scores[:, None] + log_probs).reshape(B, beam * V)
        top_v, top_i = top_k_stable(cand, beam)         # [B, beam]
        parent = top_i // V
        tok = (top_i % V).to(torch.int32)
        gather = (rows + parent).reshape(-1)
        states = _map_states(lambda a: a[gather], new_states)
        prev_finished = finished[gather]
        tokens = tok.reshape(-1)
        scores = top_v.reshape(-1)
        lengths = torch.where(prev_finished, lengths[gather],
                              lengths[gather] + 1)
        finished = prev_finished | (tokens == decoder.end_token)
        step_tokens.append(tokens.reshape(B, beam))
        step_parents.append(parent)
        if bool(torch.all(finished)):       # the step's one host read
            break

    # backtrack parent ids (reference: gather_tree)
    T = len(step_tokens)
    toks = torch.stack(step_tokens).cpu().numpy()
    parents = torch.stack(step_parents).cpu().numpy()
    ids = np.zeros((B, T, beam), np.int32)
    cur = np.tile(np.arange(beam), (B, 1))
    for t in range(T - 1, -1, -1):
        ids[:, t, :] = np.take_along_axis(toks[t], cur, axis=1)
        cur = np.take_along_axis(parents[t], cur, axis=1)

    if impute_finished:
        # everything after a beam's first end_token becomes end_token
        done = np.cumsum(ids == decoder.end_token, axis=1) > 0
        shifted = np.roll(done, 1, axis=1)
        shifted[:, 0, :] = False
        ids = np.where(shifted, decoder.end_token, ids)

    seq_len = Tensor(lengths.reshape(B, beam))
    out = np.transpose(ids, (1, 0, 2)) if output_time_major else ids
    return (Tensor(torch.from_numpy(np.ascontiguousarray(out)).to(dev)),
            seq_len)
