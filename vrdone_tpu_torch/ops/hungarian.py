"""Batched optimal assignment on the device (counterpart of
``vrdone_tpu/ops/hungarian.py``).

* ``match_padded`` (the hot path): for G <= ``DP_MAX_COLS`` ground-truth
  slots, a subset DP over column sets, vectorised over every (level x batch)
  problem at once: ``dp[S]`` is the least cost of matching exactly the
  column set S with the rows seen so far, rows may be skipped. The Q row
  steps are a Python loop of dense gather/min ops over (N, G, 2^G) blocks,
  with the same float ops in the same order as the JAX ``lax.scan``, so the
  same cost gives the same ``row_for_col`` bit for bit (``argmin`` takes the
  first minimum in both).
* ``hungarian_square``: the O(n^3) shortest-augmenting-path Hungarian
  (potentials, Jonker-Volgenant) in a plain loop, the fallback above
  ``DP_MAX_COLS`` columns.

Both minimise. No scipy.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

INF = 1e18          # float32 "infinity" of the DP, as the JAX package's
DP_MAX_COLS = 12    # 2^G * G states per problem; above this, Hungarian


def _subset_tables(g: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(has_bit, idx_without), each (G, 2^G): whether state S holds column
    j, and S without column j."""
    states = np.arange(1 << g)
    bits = 1 << np.arange(g)[:, None]
    has_bit = (states[None] & bits) != 0
    idx_without = states[None] & ~bits
    return (torch.from_numpy(has_bit).to(device),
            torch.from_numpy(idx_without).to(device))


def subset_dp_match(cost: torch.Tensor) -> torch.Tensor:
    """Exact rectangular assignment of N problems by DP over column subsets.

    cost: (N, Q, G) float32, Q >= G. Every column is matched to a distinct
    row; rows may be left unmatched. Returns row_for_col (N, G) int64.
    """
    n, q, g = cost.shape
    cost = cost.float()
    has_bit, idx_without = _subset_tables(g, cost.device)
    inf = torch.tensor(INF, dtype=torch.float32, device=cost.device)
    dp = torch.full((n, 1 << g), INF, dtype=torch.float32,
                    device=cost.device)
    dp[:, 0] = 0.0
    history = []                                       # dp before row i
    for i in range(q):
        history.append(dp)
        cand = dp[:, idx_without] + cost[:, i, :, None]    # (N, G, 2^G)
        cand = torch.where(has_bit, cand, inf)
        dp = torch.minimum(dp, cand.min(dim=1).values)

    # backward: from the full set, re-evaluate each row's options in reverse
    # and take the first argmin (the same float ops, so the choice lies on
    # an optimal path)
    s = torch.full((n,), (1 << g) - 1, dtype=torch.int64, device=cost.device)
    row_for_col = torch.zeros((n, g), dtype=torch.int64, device=cost.device)
    cols = torch.arange(g, device=cost.device)
    for i in range(q - 1, -1, -1):
        dp_i = history[i]
        sub = idx_without[:, s].T                          # (N, G)
        match_cost = torch.where(has_bit[:, s].T,
                                 dp_i.gather(1, sub) + cost[:, i, :], inf)
        opts = torch.cat([match_cost, dp_i.gather(1, s[:, None])], dim=1)
        choice = opts.argmin(dim=1)
        is_match = choice < g
        jj = choice.clamp(max=g - 1)
        hit = is_match[:, None] & (cols[None] == jj[:, None])
        row_for_col = torch.where(hit, i, row_for_col)
        s = torch.where(is_match, s & ~(1 << jj), s)
    return row_for_col


def hungarian_square(cost: np.ndarray) -> np.ndarray:
    """Solve one square assignment problem. cost: (n, n) float32. Returns
    row_for_col (n,) int64: the row assigned to each column. The JAX
    package's algorithm and float32 arithmetic, in a plain loop."""
    cost = np.asarray(cost, np.float32)
    n = cost.shape[0]
    inf = np.float32(INF)
    u = np.zeros(n + 1, np.float32)
    v = np.zeros(n + 1, np.float32)
    p = np.full(n + 1, -1, np.int64)
    for i in range(n):
        p[n] = i
        minv = np.full(n + 1, inf, np.float32)
        way = np.zeros(n + 1, np.int64)
        used = np.zeros(n + 1, bool)
        j0 = n
        while True:
            used[j0] = True
            i0 = p[j0]
            cur = cost[i0, :] - u[i0] - v[:n]
            better = (cur < minv[:n]) & ~used[:n]
            minv[:n] = np.where(better, cur, minv[:n])
            way[:n] = np.where(better, j0, way[:n])
            masked = np.where(used[:n], inf, minv[:n])
            j1 = int(np.argmin(masked))
            delta = masked[j1]
            rows = p[used]
            u[rows] += delta
            v[used] -= delta
            minv[:n] = np.where(used[:n], minv[:n], minv[:n] - delta)
            j0 = j1
            if p[j0] == -1:
                break
        while j0 != n:
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1
    return p[:n].copy()


def match_padded(cost: torch.Tensor, col_valid: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Assignment for N (Q, G) costs with a validity mask over columns.

    cost: (N, Q, G); col_valid: (N, G) bool. Returns (row_for_col (N, G)
    int64, matched (N, G) bool): matched marks the valid columns (invalid
    columns receive arbitrary distinct rows; callers gate on it).
    """
    n, q, g = cost.shape
    if q < g:
        raise ValueError(f"num_queries {q} must be >= ground-truth slots {g}")
    cost = torch.nan_to_num(cost.float(), nan=0.0, posinf=0.0, neginf=0.0)
    if g <= DP_MAX_COLS:
        # invalid columns: any row-constant cost leaves the valid-column
        # optimum unchanged (they soak up leftover rows)
        cost = torch.where(col_valid[:, None, :], cost, 0.0)
        return subset_dp_match(cost), col_valid
    logging.getLogger("vrdone_tpu_torch").warning(
        "match_padded: G=%d > %d ground-truth slots, so the serial "
        "augmenting-path Hungarian runs on the host", g, DP_MAX_COLS)
    cost_np = cost.detach().cpu().numpy()
    valid_np = col_valid.cpu().numpy()
    rows = np.zeros((n, g), np.int64)
    for b in range(n):
        c, ok = cost_np[b], valid_np[b]
        # pad with a data-derived constant just above the real cost range
        # (a huge sentinel would erase small differences in f32 potentials)
        finite = c[:, ok]
        big = np.float32((finite.max() if finite.size else 0.0) + 1.0)
        c = np.where(ok[None], c, big).astype(np.float32)
        if q > g:
            c = np.concatenate([c, np.full((q, q - g), big, np.float32)], 1)
        rows[b] = hungarian_square(c)[:g]
    return torch.from_numpy(rows).to(cost.device), col_valid
