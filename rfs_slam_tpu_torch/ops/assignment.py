"""Linear-assignment solvers over a batch of matrices (port of the JAX
package's ``ops/assignment.py``).

* :func:`hungarian` / :func:`_hungarian_uv` — the O(n^3) shortest-
  augmenting-path algorithm with dual potentials (HungarianMethod.hpp:
  56-594), exact, batched over a leading axis.  CUDA tensors launch the
  hand-written kernel of :mod:`rfs_slam_tpu_torch.ops.kernels.hungarian`
  (one warp a matrix); CPU tensors run :func:`hungarian_uv_plain`, its twin;
* :func:`murty` — k-best assignments by Murty partitioning over a fixed
  subproblem pool (MurtyAlgorithm.cpp:141-338): k - 1 expansion waves, each
  one batched Hungarian call;
* :func:`murty_gated` — Murty on the lanes whose dual bound admits a second
  hypothesis inside the window, within a lane budget;
* :func:`cost_partition`, :func:`cost_reduce`, :func:`matrix_permanent`,
  and the numpy oracles :func:`brute_force_assignments` and
  :func:`permutations_lexicographic`.

Conventions: square cost matrices, MAXIMIZATION of the sum; disallowed
entries hold the finite :data:`NEG`.  :func:`murty` and
:func:`murty_gated` are fixed-shape, fixed-count programs: nothing in them
reads a value back from the device.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from rfs_slam_tpu_torch.core import planar
from rfs_slam_tpu_torch.ops.kernels import hungarian as hungarian_kernel

NEG = -1e9  # "disallowed" sentinel, finite to keep potentials well-defined

_NEG_INF = float("-inf")


def _inf_sentinel(dtype) -> float:
    """``finfo.max / 8``: the search's "infinite" reduced cost (exact)."""
    return torch.finfo(dtype).max / 8


def hungarian_uv_plain(cost: torch.Tensor, return_trips: bool = False):
    """The plain twin of the CUDA kernel: ``_hungarian_uv`` of the JAX
    package (assignment.py:44-145) over ``cost [B, n, n]``, in its exact
    arithmetic order.

    Per row, the augmenting-path search runs on every lane whose search is
    not done (a done lane is masked, as ``vmap`` masks it), capped at
    ``n + 2`` trips; the augment walk is capped the same way; ``p`` is
    inverted by a max reduce, so a broken chain leaves a row's column in
    range.  The loops test "any lane running" on the host.

    Returns ``(row_to_col [B, n] int64, total [B], u [B, n+1], v [B, n+1])``
    and, with ``return_trips``, the search trips of each lane ``[B]`` and
    the used columns summed over those trips ``[B]`` (the work a trip
    needs: a used column moves ``u`` and ``v``, an unused one its reduced
    cost, compare, argmin and ``minv``).
    ``total`` sums the picked entries row by row, from 0.
    """
    B, n, _ = cost.shape
    dev, dt = cost.device, cost.dtype
    INF = _inf_sentinel(dt)
    a = -cost                                           # minimize
    u = torch.zeros((B, n + 1), dtype=dt, device=dev)
    v = torch.zeros_like(u)
    p = torch.zeros((B, n + 1), dtype=torch.long, device=dev)
    cols = torch.arange(n + 1, device=dev)
    lanes = torch.arange(B, device=dev)
    inf_col = torch.full((B, 1), INF, dtype=dt, device=dev)
    trips = torch.zeros(B, dtype=torch.long, device=dev)
    used_trips = torch.zeros_like(trips)
    for i in range(n):
        minv = torch.full((B, n + 1), INF, dtype=dt, device=dev)
        used = torch.zeros((B, n + 1), dtype=torch.bool, device=dev)
        way = torch.zeros((B, n + 1), dtype=torch.long, device=dev)
        p[:, 0] = i + 1
        j0 = torch.zeros(B, dtype=torch.long, device=dev)
        for _ in range(n + 2):
            i0 = p[lanes, j0]
            run = i0 != 0
            if not bool(run.any()):
                break
            trips += run
            # a done lane is masked: it marks no column, improves no minv
            # and moves by delta = 0 (x - 0 and u + 0 * hits are exact: u
            # is never -0)
            used = used | ((cols == j0[:, None]) & run[:, None])
            used_trips += used.sum(dim=1) * run
            row = a[lanes, (i0 - 1).clamp(min=0)]               # [B, n]
            cur = torch.cat([inf_col,
                             row - u[lanes, i0][:, None] - v[:, 1:]], dim=1)
            better = ~used & (cur < minv) & run[:, None]
            minv = torch.where(better, cur, minv)
            way = torch.where(better, j0[:, None], way)
            dc = torch.where(used, INF, minv)
            j1 = torch.argmin(dc, dim=1)                        # first index
            delta = torch.where(run, dc.gather(1, j1[:, None])[:, 0],
                                0.0)[:, None]
            # u[p[j]] += delta for the used columns: the count of used
            # columns per row, times delta
            hits = torch.zeros_like(u).scatter_add_(1, p, used.to(dt))
            u = u + delta * hits
            v = torch.where(used, v - delta, v)
            minv = torch.where(used, minv, minv - delta)
            j0 = torch.where(run, j1, j0)
        # augment along the parent links, capped like the search (a capped
        # search can leave a broken chain)
        for _ in range(n + 2):
            run = j0 != 0
            if not bool(run.any()):
                break
            j1 = way[lanes, j0]
            p = torch.where(run[:, None] & (cols == j0[:, None]),
                            p[lanes, j1][:, None], p)
            j0 = torch.where(run, j1, j0)
        p[:, 0] = 0
    # p[c + 1] = row + 1 of column c; max reduce (a broken chain can repeat
    # a row, and max keeps its column in range)
    r2c = torch.zeros((B, n + 1), dtype=torch.long, device=dev).scatter_reduce(
        1, p[:, 1:], torch.arange(n, device=dev).expand(B, n), "amax")
    row_to_col = r2c[:, 1:]
    picked = cost.gather(2, row_to_col[:, :, None])[:, :, 0]
    total = torch.zeros(B, dtype=dt, device=dev)
    for r in range(n):
        total = total + picked[:, r]
    if return_trips:
        return row_to_col, total, u, v, trips, used_trips
    return row_to_col, total, u, v


def _hungarian_uv(cost: torch.Tensor):
    """:func:`hungarian` and the optimal dual potentials ``(u, v)``
    ``[..., n+1]`` (1-indexed rows and columns, slot 0 virtual).  For the
    minimized matrix ``a = -cost`` they satisfy ``u[i+1] + v[j+1] <= a[i, j]``
    with equality on assigned pairs: the certificate of Murty's child bound.
    ``cost``: ``[n, n]`` or ``[B, n, n]``."""
    single = cost.dim() == 2
    c = cost[None] if single else cost
    row_to_col, total, u, v = hungarian_kernel.hungarian_uv(c)
    out = (row_to_col.long(), total, u, v)
    return tuple(x[0] for x in out) if single else out


def hungarian(cost: torch.Tensor):
    """Exact max-sum perfect assignment: ``(row_to_col [..., n] int64,
    total [...])`` of ``cost [n, n]`` or ``[B, n, n]``."""
    row_to_col, total, _, _ = _hungarian_uv(cost)
    return row_to_col, total


def _build_eff(cost, forced, ban_r, ban_c, ban_aug, aug_cols):
    """Effective cost matrices of subproblems (bans, then forcing).

    ``cost [..., n, n]`` broadcast against the subproblems: ``forced
    [..., n]`` (column forced for each row, -1 free), the compact ban list
    ``ban_r / ban_c / ban_aug [..., k]`` (ban_aug: the row is banned from
    every augmented column), and ``aug_cols [..., n]`` (column >= real
    columns)."""
    n = cost.shape[-1]
    cols = torch.arange(n, device=cost.device)
    c = cost
    for b in range(ban_r.shape[-1]):
        br = ban_r[..., b:b + 1]
        row_hit = (cols == br) & (br >= 0)
        col_hit = (cols == ban_c[..., b:b + 1]) | (ban_aug[..., b:b + 1]
                                                    & aug_cols)
        c = torch.where(row_hit[..., :, None] & col_hit[..., None, :], NEG, c)
    is_forced = forced >= 0
    keep = (cols == forced[..., None]) | ~is_forced[..., None]
    return torch.where(keep, c, NEG)


def _lanes(x, B: int, device) -> torch.Tensor:
    """An int or a tensor (0-dim or ``[B]``) as a ``[B]`` tensor."""
    if isinstance(x, torch.Tensor):
        return x.to(device).reshape(-1).expand(B)
    return torch.full((B,), x, dtype=torch.long, device=device)


def murty(cost: torch.Tensor, k: int, real_rows=None, real_cols=None,
          child_cap: int | None = None, prune_window: float | None = None,
          return_nvalid: bool = False):
    """k-best max-sum assignments by Murty partitioning, per matrix of
    ``cost [n, n]`` or ``[B, n, n]`` (the JAX package's vmapped ``murty``).

    Returns ``(assignments [..., k, n] int64, scores [..., k], valid [..., k]
    bool)`` in descending score order, plus ``n_valid [..., k-1]`` with
    ``return_nvalid``.  ``real_rows`` / ``real_cols`` restrict partitioning
    to the real assignment block (Murty::setRealAssignmentBlock,
    MurtyAlgorithm.cpp:126-135, 181-186, 255-262): Python ints are static
    dimensions (the pool shrinks with them), tensors (0-dim or ``[B]`` rows,
    0-dim columns) are per-lane values, as traced values are in JAX.
    ``child_cap`` bounds the children solved per wave, kept in descending
    dual-bound order (a stable sort); ``prune_window`` invalidates children
    whose dual bound falls more than the window below the best.  See the JAX
    package's docstring for the semantics; this is its arithmetic, batched.
    """
    single = cost.dim() == 2
    if single:
        cost = cost[None]
    B, n, _ = cost.shape
    dev, dt = cost.device, cost.dtype
    nR = n if real_rows is None else real_rows
    nC = n if real_cols is None else real_cols
    static_dims = isinstance(nR, int) and isinstance(nC, int)
    if static_dims:
        nR, nC = min(nR, n), min(nC, n)
        partition_bound = n - 1 if nR >= n else nR
    else:
        partition_bound = n - 1 if n > 1 else 1
    all_cols_real = static_dims and nC >= n
    nR_b = _lanes(nR, B, dev)
    nC_b = _lanes(nC, B, dev)
    partition_max = torch.where(nR_b >= n, n - 1, nR_b)             # [B]
    cols = torch.arange(n, device=dev)
    aug_cols = cols >= nC_b[:, None]                                # [B, n]
    pb_full = max(partition_bound, 1)
    pb = pb_full if child_cap is None else max(1, min(child_cap, pb_full))
    pool = (k - 1) * pb + 1
    INFB = _inf_sentinel(dt)
    lanes = torch.arange(B, device=dev)
    slots = torch.arange(pool, device=dev)

    forced = torch.full((B, pool, n), -1, dtype=torch.long, device=dev)
    ban_r = torch.full((B, pool, k), -1, dtype=torch.long, device=dev)
    ban_c = torch.zeros((B, pool, k), dtype=torch.long, device=dev)
    ban_aug = torch.zeros((B, pool, k), dtype=torch.bool, device=dev)
    sols = torch.zeros((B, pool, n), dtype=torch.long, device=dev)
    scores = torch.full((B, pool), _NEG_INF, dtype=dt, device=dev)
    active = torch.zeros((B, pool), dtype=torch.bool, device=dev)
    us = torch.zeros((B, pool, n + 1), dtype=dt, device=dev)
    vs = torch.zeros_like(us)

    # the root: no bans, nothing forced, so its effective matrix is cost
    sol, total, u_r, v_r = _hungarian_uv(cost)
    sols[:, 0], scores[:, 0], active[:, 0] = sol, total, True
    us[:, 0], vs[:, 0] = u_r, v_r
    root_score = total

    out_sols = torch.zeros((B, k, n), dtype=torch.long, device=dev)
    out_scores = torch.full((B, k), _NEG_INF, dtype=dt, device=dev)
    out_valid = torch.zeros((B, k), dtype=torch.bool, device=dev)
    n_valid = torch.zeros((B, max(k - 1, 1)), dtype=torch.long, device=dev)
    cand_rows = torch.arange(pb_full, device=dev)
    rows = torch.arange(n, device=dev)

    def extract(t):
        """Pool slot of the best active subproblem -> output row t."""
        best = torch.argmax(torch.where(active, scores, _NEG_INF), dim=1)
        best_score = scores[lanes, best]
        ok = active[lanes, best] & (best_score > NEG / 2)
        if prune_window is not None:
            ok = ok & (best_score >= root_score - prune_window)
        out_sols[:, t] = torch.where(ok[:, None], sols[lanes, best], 0)
        out_scores[:, t] = torch.where(ok, best_score, _NEG_INF)
        out_valid[:, t] = ok
        return best, best_score, ok

    for t in range(k - 1):
        best, best_score, ok = extract(t)
        best_sol = sols[lanes, best]
        active = active & (slots != best[:, None])
        fb, brb = forced[lanes, best], ban_r[lanes, best]
        bcb, bab = ban_c[lanes, best], ban_aug[lanes, best]
        ban_slot = torch.clamp((brb >= 0).sum(dim=1), max=k - 1)
        slot_hot = torch.arange(k, device=dev) == ban_slot[:, None]  # [B, k]

        # dual upper bound of each candidate child (the parent's duals stay
        # feasible under the child's bans and forcing)
        a_eff = -_build_eff(cost, fb, brb, bcb, bab, aug_cols)
        slack = (a_eff - us[lanes, best][:, 1:, None]
                 - vs[lanes, best][:, None, 1:])                     # [B, n, n]
        child_ban = cols == best_sol[:, :, None]
        if not all_cols_real:
            child_ban = child_ban | ((best_sol[:, :, None] >= nC_b[:, None,
                                                                   None])
                                     & aug_cols[:, None, :])
        gap = torch.where(child_ban, INFB, torch.clamp(slack, min=0.0)).amin(
            dim=2)
        duals_ok = torch.where(child_ban, 0.0, slack).amin(dim=(1, 2)) > -1e-2
        gap = torch.where(duals_ok[:, None], gap, 0.0)
        ub = best_score[:, None] - gap                               # [B, n]

        cand_valid = (ok[:, None] & (fb[:, :pb_full] < 0)
                      & (cand_rows < partition_max[:, None]))
        if prune_window is not None:
            cand_valid = cand_valid & (
                ub[:, :pb_full] >= (root_score - prune_window)[:, None])
        n_valid[:, t] = cand_valid.sum(dim=1)
        if pb < pb_full:
            key_ub = torch.where(cand_valid, ub[:, :pb_full], _NEG_INF)
            child_rows = torch.sort(-key_ub, dim=1, stable=True)[1][:, :pb]
            child_valid = cand_valid.gather(1, child_rows)
        else:
            child_rows = cand_rows.expand(B, pb_full)
            child_valid = cand_valid

        # children: rows < r forced to the parent solution, row r banned
        # from its parent column; one batched Hungarian call for the wave
        f_c = torch.where((rows < child_rows[:, :, None]) & (fb[:, None] < 0),
                          best_sol[:, None], fb[:, None])            # [B,pb,n]
        sol_at = best_sol.gather(1, child_rows)                      # [B, pb]
        hot = slot_hot[:, None]
        br_c = torch.where(hot, child_rows[:, :, None], brb[:, None])
        bc_c = torch.where(hot, sol_at[:, :, None], bcb[:, None])
        aug_val = (torch.zeros_like(sol_at, dtype=torch.bool) if all_cols_real
                   else sol_at >= nC_b[:, None])
        baug_c = torch.where(hot, aug_val[:, :, None], bab[:, None])
        eff = _build_eff(cost[:, None], f_c, br_c, bc_c, baug_c,
                         aug_cols[:, None])                          # [B,pb,n,n]
        sols_c, tots_c, us_c, vs_c = _hungarian_uv(eff.reshape(B * pb, n, n))
        s = slice(1 + t * pb, 1 + (t + 1) * pb)
        forced[:, s], ban_r[:, s], ban_c[:, s], ban_aug[:, s] = (
            f_c, br_c, bc_c, baug_c)
        sols[:, s] = sols_c.reshape(B, pb, n)
        scores[:, s] = torch.where(child_valid, tots_c.reshape(B, pb),
                                   _NEG_INF)
        active[:, s] = child_valid
        us[:, s] = us_c.reshape(B, pb, n + 1)
        vs[:, s] = vs_c.reshape(B, pb, n + 1)

    # the last wave's children are never read: extract only
    extract(k - 1)
    out = (out_sols, out_scores, out_valid)
    if return_nvalid:
        out += (n_valid[:, :k - 1],)
    return tuple(x[0] for x in out) if single else out


def second_best_bound(cost, sol, tot, u, v, real_rows, real_cols=None):
    """Dual upper bound on the second-best real-block assignment of each
    matrix: the largest of murty's root-wave child bounds (the same slack
    and ``duals_ok`` arithmetic).  ``cost [..., n, n]``, ``sol [..., n]``,
    ``tot [...]``, ``u, v [..., n+1]``; ``real_rows`` an int or per-matrix
    tensor, ``real_cols`` an int or a 0-dim tensor."""
    n = cost.shape[-1]
    nC = n if real_cols is None else real_cols
    cols = torch.arange(n, device=cost.device)
    slack = -cost - u[..., 1:, None] - v[..., None, 1:]
    aug_cols = cols >= nC
    child_ban = (cols == sol[..., None]) | ((sol[..., None] >= nC)
                                            & aug_cols)
    INFB = _inf_sentinel(cost.dtype)
    gap = torch.where(child_ban, INFB, torch.clamp(slack, min=0.0)).amin(
        dim=-1)
    duals_ok = torch.where(child_ban, 0.0, slack).amin(dim=(-2, -1)) > -1e-2
    gap = torch.where(duals_ok[..., None], gap, 0.0)
    rr = (real_rows if isinstance(real_rows, torch.Tensor)
          else torch.full_like(tot, real_rows, dtype=torch.long))
    partition_max = torch.where(rr >= n, n - 1, rr)
    cand = cols < partition_max[..., None]
    return torch.where(cand, tot[..., None] - gap, _NEG_INF).amax(dim=-1)


def ambiguous_lanes(tables, real_rows, real_cols, prune_window):
    """``[P]`` bool: the lanes whose dual bound admits a second in-window
    hypothesis (murty_gated's classifier, for instrumentation)."""
    sols, tots, us, vs = _hungarian_uv(tables)
    ub2 = second_best_bound(tables, sols, tots, us, vs, real_rows, real_cols)
    return (tots > NEG / 2) & (ub2 >= tots - prune_window)


def murty_gated(tables: torch.Tensor, k: int, real_rows: torch.Tensor,
                real_cols=None, child_cap: int | None = None,
                prune_window: float | None = None, budget: int | None = None,
                return_overflow: bool = False, mesh=None):
    """Batched :func:`murty` with per-lane ambiguity gating.

    Solves the root assignment of every lane, classifies a lane ambiguous
    when its dual second-best bound lies within ``prune_window`` of its
    best, runs the full Murty expansion on the ``budget`` most ambiguous
    lanes (:func:`planar.topk_stable`, as ``lax.top_k``) and scatters their
    results back; every other lane gets its root as its one valid
    hypothesis.  With ``budget`` None, at least P, or ``k <= 1`` every lane
    runs the full expansion.  The budget and the overflow count stay on the
    device.

    Under ``mesh`` (``parallel/mesh.py``) the lanes are the rank's block of
    the particle axis and the budget is global: the lanes' keys are
    all-gathered, every rank takes the unsharded top-``budget`` and runs
    the expansion on the selected lanes of its block, in a fixed batch of
    ``min(budget, P_local)`` lanes (the unselected ones padding it).

    ``real_rows [P]``; ``real_cols`` an int or a 0-dim tensor.  Returns
    ``(assignments [P, k, n], scores [P, k], valid [P, k])`` (+ ``overflow``,
    the ambiguous lanes beyond the budget, with ``return_overflow``; under
    ``mesh`` the global count).
    """
    if prune_window is None:
        raise ValueError("murty_gated requires prune_window")
    P, n, _ = tables.shape
    dev = tables.device
    if budget is None or budget >= (P if mesh is None else mesh.p_global) \
            or k <= 1:
        das, scores, valid = murty(tables, k, real_rows=real_rows,
                                   real_cols=real_cols, child_cap=child_cap,
                                   prune_window=prune_window)
        if return_overflow:
            return das, scores, valid, torch.zeros((), dtype=torch.int32,
                                                   device=dev)
        return das, scores, valid

    sols, tots, us, vs = _hungarian_uv(tables)
    root_ok = tots > NEG / 2
    ub2 = second_best_bound(tables, sols, tots, us, vs, real_rows, real_cols)
    ambiguous = root_ok & (ub2 >= tots - prune_window)
    # most ambiguous first: the 2nd-best bound closest to the best
    amb_key = torch.where(ambiguous, ub2 - tots, _NEG_INF)
    if mesh is None:
        _, sel = planar.topk_stable(amb_key, budget)                # [A]
        sel_amb = ambiguous[sel]
        n_amb, n_sel_amb = ambiguous.sum(), sel_amb.sum()
    else:
        both = mesh.all_gather(torch.stack(
            [amb_key, ambiguous.to(amb_key.dtype)], dim=1))
        amb_all = both[:, 1] > 0
        _, sel_all = planar.topk_stable(both[:, 0], budget)
        n_amb, n_sel_amb = amb_all.sum(), amb_all[sel_all].sum()
        chosen = mesh.block(torch.zeros_like(amb_all).index_fill_(
            0, sel_all, True))
        # this block's selected lanes first (ascending), then padding
        sel = torch.sort((~chosen).int(), stable=True)[1][
            :min(budget, P)]
        sel_amb = chosen[sel] & ambiguous[sel]
    das_s, sc_s, va_s = murty(tables[sel], k, real_rows=real_rows[sel],
                              real_cols=real_cols, child_cap=child_cap,
                              prune_window=prune_window)

    # every lane's default: its root as the single valid hypothesis
    das = torch.zeros((P, k, n), dtype=torch.long, device=dev)
    das[:, 0] = torch.where(root_ok[:, None], sols, 0)
    scores = torch.full((P, k), _NEG_INF, dtype=tables.dtype, device=dev)
    scores[:, 0] = torch.where(root_ok, tots, _NEG_INF)
    valid = torch.zeros((P, k), dtype=torch.bool, device=dev)
    valid[:, 0] = root_ok
    # the selected ambiguous lanes take murty's result (sel is distinct)
    das = das.index_copy(0, sel, torch.where(sel_amb[:, None, None], das_s,
                                             das[sel]))
    scores = scores.index_copy(0, sel, torch.where(sel_amb[:, None], sc_s,
                                                   scores[sel]))
    valid = valid.index_copy(0, sel, torch.where(sel_amb[:, None], va_s,
                                                 valid[sel]))
    if return_overflow:
        return das, scores, valid, (n_amb - n_sel_amb).to(torch.int32)
    return das, scores, valid


def brute_force_assignments(cost: np.ndarray, k: int | None = None):
    """All assignments sorted by score, descending (numpy test oracle;
    BruteForceAssignment.hpp:40-88)."""
    n = cost.shape[0]
    results = []
    for perm in itertools.permutations(range(n)):
        score = sum(cost[i, perm[i]] for i in range(n))
        results.append((score, list(perm)))
    results.sort(key=lambda t: -t[0])
    if k is not None:
        results = results[:k]
    scores = np.array([r[0] for r in results])
    perms = np.array([r[1] for r in results])
    return perms, scores


def cost_partition(gate: torch.Tensor, max_iters: int | None = None):
    """Bipartite connected components of a gated cost table
    (``CostMatrixGeneral::partition``, CostMatrix.cpp:92-157) by
    fixed-iteration min-label propagation.  ``gate [..., R, C]`` bool.

    Returns ``(row_label [..., R], col_label [..., C])`` int64 component
    ids; a row or column with no gated entry keeps its own label.
    """
    R, C = gate.shape[-2:]
    if max_iters is None:
        max_iters = max(1, math.ceil(math.log2(R + C)) + 1)
    dev = gate.device
    lead = gate.shape[:-2]
    row = torch.arange(R, device=dev).expand(lead + (R,))
    col = torch.arange(R, R + C, device=dev).expand(lead + (C,))
    big = R + C
    for _ in range(max_iters):
        # row <- min over gated cols; col <- min over gated rows
        row = torch.minimum(row, torch.where(gate, col[..., None, :],
                                             big).amin(dim=-1))
        col = torch.minimum(col, torch.where(gate, row[..., :, None],
                                             big).amin(dim=-2))
    return row, col


def cost_reduce(cost: torch.Tensor, lim: float):
    """Forced-assignment reduction of square cost tables
    (``CostMatrix::reduce``, CostMatrix.cpp:263-369, the floor-threshold
    mode of FastSLAM's DA): an entry above ``lim`` that is the only one in
    both its row and its column is fixed (one pass); if exactly one free
    pair remains, it is fixed too (CostMatrix.cpp:332-337).

    Returns ``fixed [..., n]`` int64 (column fixed for each row, -1 free),
    ``row_free [..., n]`` and ``col_free [..., n]`` bool.
    """
    n = cost.shape[-1]
    ok = cost > lim
    single = (ok & (ok.sum(dim=-1)[..., :, None] == 1)
              & (ok.sum(dim=-2)[..., None, :] == 1))
    col_of = single.to(torch.uint8).argmax(dim=-1)
    has = single.any(dim=-1)
    fixed = torch.where(has, col_of, -1)
    row_free = ~has
    col_free = ~single.any(dim=-2)
    one_left = (row_free.sum(dim=-1) == 1) & (col_free.sum(dim=-1) == 1)
    ar = torch.arange(n, device=cost.device)
    last_row = ar == row_free.to(torch.uint8).argmax(dim=-1)[..., None]
    last_col = ar == col_free.to(torch.uint8).argmax(dim=-1)[..., None]
    lone = one_left[..., None]
    fixed = torch.where(lone & last_row,
                        col_free.to(torch.uint8).argmax(dim=-1)[..., None],
                        fixed)
    return fixed, row_free & ~(lone & last_row), col_free & ~(lone & last_col)


def permutations_lexicographic(n_m: int, n_z: int) -> np.ndarray:
    """Every landmark -> measurement association vector in lexicographic
    order (``PermutationLexicographic``, PermutationLexicographic.hpp:
    44-79): each of ``n_m`` landmarks takes one of ``n_z`` measurements or
    ``n_z`` (missed), real measurements distinct.  ``[n_assign, n_m]``."""
    out = []

    def rec(prefix, used):
        if len(prefix) == n_m:
            out.append(list(prefix))
            return
        for c in range(n_z + 1):
            if c < n_z and c in used:
                continue
            rec(prefix + [c], used | ({c} if c < n_z else set()))

    rec([], set())
    return np.asarray(out, np.int32)


def matrix_permanent(a: torch.Tensor) -> torch.Tensor:
    """Permanent of ``a [n, n]`` by the Ryser formula
    (MatrixPermanent.hpp:39-68); O(2^n n)."""
    n = a.shape[-1]
    subsets = torch.arange(1, 1 << n, device=a.device)
    bits = ((subsets[:, None] >> torch.arange(n, device=a.device)) & 1).to(
        a.dtype)
    prods = torch.prod(bits @ a.transpose(-1, -2), dim=-1)
    signs = torch.where((n - bits.sum(dim=-1)) % 2 == 0, 1.0, -1.0).to(
        a.dtype)
    return torch.sum(signs * prods, dim=-1)
