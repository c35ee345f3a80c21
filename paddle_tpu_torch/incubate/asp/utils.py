"""Sparsity mask computation utilities (the port of
``paddle_tpu/incubate/asp/utils.py``; reference:
python/paddle/incubate/asp/utils.py -- get_mask_1d, get_mask_2d_greedy,
check_mask_1d/2d, calculate_density, create_mask, check_sparsity).

The masks are the reference's numpy functions, copied.  For torch
tensors ``create_mask`` (1-D) and ``check_sparsity`` (1-D) run on the
tensor's device: a stable ascending sort of each group's magnitudes
keeps the last ``n``, which is numpy's order (its sort of a row of 4 is
an insertion sort, stable), so among equal magnitudes the higher index
is kept and the mask equals the numpy mask bit for bit; bf16 weights
tie often.  The 2-D masks read the tensor on the host.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

__all__ = ["calculate_density", "get_mask_1d", "check_mask_1d",
           "get_mask_2d_greedy", "get_mask_2d_best", "check_mask_2d",
           "create_mask", "check_sparsity", "MaskAlgo", "CheckMethod"]


class MaskAlgo:
    MASK_1D = "mask_1d"
    MASK_2D_GREEDY = "mask_2d_greedy"
    MASK_2D_BEST = "mask_2d_best"


class CheckMethod:
    CHECK_1D = "check_1d"
    CHECK_2D = "check_2d"

    @staticmethod
    def get_checking_method(mask_algo):
        return CheckMethod.CHECK_1D if mask_algo == MaskAlgo.MASK_1D \
            else CheckMethod.CHECK_2D


def _host(x):
    """A torch tensor (or a Tensor) as numpy, the rest as it is."""
    t = getattr(x, "_t", x)
    if torch.is_tensor(t):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(x)


def calculate_density(x) -> float:
    """Fraction of non-zeros (reference: utils.py calculate_density)."""
    t = getattr(x, "_t", x)
    if torch.is_tensor(t):
        return float(torch.count_nonzero(t)) / t.numel()
    x = np.asarray(x)
    return float(np.count_nonzero(x)) / x.size


def _reshape_1d(mat, m):
    """Pad the last dim to a multiple of m and view as [-1, m]."""
    mat = np.asarray(mat)
    if mat.shape[1] % m != 0:
        pad = m - mat.shape[1] % m
        mat = np.concatenate(
            [mat, np.zeros((mat.shape[0], pad), mat.dtype)], axis=1)
    return mat.reshape(-1, m), mat.shape


def get_mask_1d(mat, n=2, m=4):
    """Keep the n largest-|.| of every m consecutive elements along rows."""
    mat = np.asarray(mat)
    orig_shape = mat.shape
    grouped, padded_shape = _reshape_1d(mat, m)
    mask = np.zeros_like(grouped, dtype=mat.dtype)
    order = np.argsort(np.abs(grouped), axis=1)[:, -n:]
    np.put_along_axis(mask, order, 1.0, axis=1)
    mask = mask.reshape(padded_shape)[:orig_shape[0], :orig_shape[1]]
    return mask


def check_mask_1d(mat, n=2, m=4) -> bool:
    grouped, _ = _reshape_1d(mat, m)
    return bool(np.all(np.count_nonzero(grouped, axis=1) <= n))


def _pad_2d(mat, m):
    mat = np.asarray(mat)
    r_pad = (-mat.shape[0]) % m
    c_pad = (-mat.shape[1]) % m
    if r_pad or c_pad:
        mat = np.pad(mat, ((0, r_pad), (0, c_pad)))
    return mat


def _complete_tile(sub_mask, rows_used, cols_used, n, m):
    """Greedy packing can dead-end with rows below n while every
    spare column slot sits in an already-selected cell; finish with
    direct fills, then augmenting swaps (select (i,j2), move the
    displaced (i2,j2) to a deficit column j)."""
    while any(rows_used[i] < n for i in range(m)):
        i = next(i for i in range(m) if rows_used[i] < n)
        direct = [j for j in range(m)
                  if cols_used[j] < n and sub_mask[i, j] == 0]
        if direct:
            j = direct[0]
            sub_mask[i, j] = 1.0
            rows_used[i] += 1
            cols_used[j] += 1
            continue
        swapped = False
        for j2 in range(m):
            if sub_mask[i, j2] == 1:
                continue
            for i2 in range(m):
                if sub_mask[i2, j2] != 1:
                    continue
                for j in range(m):
                    if cols_used[j] < n and sub_mask[i2, j] == 0:
                        sub_mask[i, j2] = 1.0
                        sub_mask[i2, j2] = 0.0
                        sub_mask[i2, j] = 1.0
                        rows_used[i] += 1
                        cols_used[j] += 1
                        swapped = True
                        break
                if swapped:
                    break
            if swapped:
                break
        if not swapped:
            break  # no augmenting move left; tile stays under-filled


def get_mask_2d_greedy(mat, n=2, m=4):
    """Greedy n:m along both dims of each m x m tile, with a completion
    phase to reach exactly-n density
    (reference: utils.py get_mask_2d_greedy)."""
    mat = np.asarray(mat)
    orig = mat.shape
    padded = _pad_2d(np.abs(mat), m)
    mask = np.zeros_like(padded)
    for r0 in range(0, padded.shape[0], m):
        for c0 in range(0, padded.shape[1], m):
            tile = padded[r0:r0 + m, c0:c0 + m]
            sub_mask = np.zeros((m, m))
            rows_used = np.zeros(m, int)
            cols_used = np.zeros(m, int)
            order = np.argsort(-tile.flatten())
            for idx in order:
                i, j = divmod(int(idx), m)
                if rows_used[i] < n and cols_used[j] < n:
                    sub_mask[i, j] = 1.0
                    rows_used[i] += 1
                    cols_used[j] += 1
            _complete_tile(sub_mask, rows_used, cols_used, n, m)
            mask[r0:r0 + m, c0:c0 + m] = sub_mask
    return mask[:orig[0], :orig[1]].astype(mat.dtype)


_PATTERNS_CACHE = {}


def _valid_2d_patterns(n, m):
    key = (n, m)
    if key not in _PATTERNS_CACHE:
        # all m x m 0/1 matrices with exactly n per row and <= n per col
        rows = [np.array(p) for p in itertools.product([0, 1], repeat=m)
                if sum(p) == n]
        patterns = []
        for combo in itertools.product(range(len(rows)), repeat=m):
            mat = np.stack([rows[i] for i in combo])
            if np.all(mat.sum(0) == n):
                patterns.append(mat)
        _PATTERNS_CACHE[key] = np.stack(patterns)
    return _PATTERNS_CACHE[key]


def get_mask_2d_best(mat, n=2, m=4):
    """Exhaustive best n:m 2D pattern per tile
    (reference: utils.py get_mask_2d_best)."""
    mat = np.asarray(mat)
    orig = mat.shape
    padded = _pad_2d(np.abs(mat), m)
    patterns = _valid_2d_patterns(n, m)  # [P, m, m]
    mask = np.zeros_like(padded)
    for r0 in range(0, padded.shape[0], m):
        for c0 in range(0, padded.shape[1], m):
            tile = padded[r0:r0 + m, c0:c0 + m]
            scores = (patterns * tile[None]).sum((1, 2))
            mask[r0:r0 + m, c0:c0 + m] = patterns[int(np.argmax(scores))]
    return mask[:orig[0], :orig[1]].astype(mat.dtype)


def check_mask_2d(mat, n=2, m=4) -> bool:
    padded = _pad_2d(np.asarray(mat), m)
    for r0 in range(0, padded.shape[0], m):
        for c0 in range(0, padded.shape[1], m):
            tile = padded[r0:r0 + m, c0:c0 + m]
            if np.any(np.count_nonzero(tile, axis=1) > n) or \
               np.any(np.count_nonzero(tile, axis=0) > n):
                return False
    return True


def _groups_torch(t2: torch.Tensor, m: int):
    """[rows, cols] -> ([rows * ceil(cols / m), m], padded cols), the
    last dim padded with zeros to a multiple of m."""
    pad = (-t2.shape[1]) % m
    if pad:
        t2 = torch.nn.functional.pad(t2, (0, pad))
    return t2.reshape(-1, m), t2.shape[1]


def mask_1d_torch(t2: torch.Tensor, n=2, m=4) -> torch.Tensor:
    """``get_mask_1d`` on the tensor's device, in its dtype: the same
    mask bit for bit (a stable sort keeps numpy's tie order)."""
    rows, cols = t2.shape
    grouped, padded = _groups_torch(t2, m)
    order = torch.sort(grouped.abs(), dim=1, stable=True).indices[:, -n:]
    mask = torch.zeros_like(grouped)
    mask.scatter_(1, order, 1)
    return mask.reshape(rows, padded)[:, :cols]


def check_mask_1d_torch(t2: torch.Tensor, n=2, m=4) -> bool:
    grouped, _ = _groups_torch(t2, m)
    return bool(torch.all(torch.count_nonzero(grouped, dim=1) <= n))


def _as_2d(t):
    return t.reshape(t.shape[0], -1) if t.ndim != 2 else t


def create_mask(tensor, func_name=MaskAlgo.MASK_1D, n=2, m=4):
    """Rank-agnostic entry: 1D/3D/4D tensors are reshaped to 2D the way
    the reference does (conv weights flattened per output channel).  A
    torch tensor gets a torch mask in its dtype on its device."""
    t = getattr(tensor, "_t", tensor)
    if torch.is_tensor(t):
        t = t.detach()
        if func_name == MaskAlgo.MASK_1D:
            return mask_1d_torch(_as_2d(t), n, m).reshape(t.shape)
        mask = create_mask(_host(t), func_name, n, m)
        return torch.as_tensor(mask).to(device=t.device, dtype=t.dtype)
    t = np.asarray(tensor)
    shape = t.shape
    t2 = _as_2d(t)
    if func_name == MaskAlgo.MASK_1D:
        mask = get_mask_1d(t2, n, m)
    elif func_name == MaskAlgo.MASK_2D_GREEDY:
        mask = get_mask_2d_greedy(t2, n, m)
    elif func_name == MaskAlgo.MASK_2D_BEST:
        mask = get_mask_2d_best(t2, n, m)
    else:
        raise ValueError(f"unknown mask algo {func_name!r}")
    return mask.reshape(shape)


def check_sparsity(tensor, func_name=CheckMethod.CHECK_1D, n=2, m=4):
    t = getattr(tensor, "_t", tensor)
    if torch.is_tensor(t):
        if func_name == CheckMethod.CHECK_1D:
            return check_mask_1d_torch(_as_2d(t.detach()), n, m)
        t = _host(t)
    t = np.asarray(t)
    t2 = _as_2d(t)
    if func_name == CheckMethod.CHECK_1D:
        return check_mask_1d(t2, n, m)
    return check_mask_2d(t2, n, m)
