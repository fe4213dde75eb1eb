"""Gaussian-mixture map maintenance as fixed-shape masked ops (port of
the JAX package's ``ops/gm.py``).

* ``prune``   — weight-threshold pruning (GaussianMixture.hpp:477-521);
* ``compact`` — sort by weight (dead slots last) and keep ``capacity``;
* ``append``  — append new Gaussians, then ``compact``;
* ``replace_weakest`` — insert new Gaussians over the weakest slots, the
  exact fixed-shape equivalent of append + compact;
* ``merge``   — the pairwise merge fixpoint (GaussianMixture.hpp:394-475) in
  parallel passes of disjoint lowest-index-first pairs.  ``merge_fixpoint``
  is the plain twin of the CUDA kernels in
  :mod:`rfs_slam_tpu_torch.ops.kernels.merge2d` (D=2) and
  :mod:`rfs_slam_tpu_torch.ops.kernels.merge3d` (D=3).

Every order-sensitive top-k goes through :func:`planar.topk_stable`, which
breaks ties by the lower index first as the JAX package does.
"""

from __future__ import annotations

import torch

from rfs_slam_tpu_torch.core import planar
from rfs_slam_tpu_torch.core.state import GMState
from rfs_slam_tpu_torch.ops.kernels import merge2d as merge2d_kernel
from rfs_slam_tpu_torch.ops.kernels import merge3d as merge3d_kernel

_NEG_INF = float("-inf")


def prune(gm: GMState, threshold) -> GMState:
    """Drop Gaussians with weight < threshold (GaussianMixture.hpp:477-521)."""
    return GMState(gm.mean, gm.cov, gm.w, gm.w_prev,
                   gm.alive & (gm.w >= threshold))


def take_slots(gm: GMState, idx: torch.Tensor) -> GMState:
    """Per-particle slot gather: ``idx[P, K]`` -> GMState with capacity K."""
    def take_pl(a):
        return torch.gather(a, 2, idx[None].expand(a.shape[0], -1, -1))

    return GMState(
        mean=take_pl(gm.mean), cov=take_pl(gm.cov),
        w=torch.gather(gm.w, 1, idx), w_prev=torch.gather(gm.w_prev, 1, idx),
        alive=torch.gather(gm.alive, 1, idx),
    )


def _score(w, alive):
    return torch.where(alive, w, torch.full_like(w, _NEG_INF))


def compact(gm: GMState, capacity: int) -> GMState:
    """Keep the top-``capacity`` Gaussians per particle by weight, dead
    slots last (the fixed-shape ``sortByWeight``, GaussianMixture.hpp:523-529)."""
    _, idx = planar.topk_stable(_score(gm.w, gm.alive), capacity)
    return take_slots(gm, idx)


def append(gm: GMState, mean, cov, w, alive,
           capacity: int | None = None) -> GMState:
    """Append new Gaussians (w_prev = 0, GaussianMixture.hpp:267-308) and
    compact to ``capacity`` (default: the map's).  ``mean`` [D, P, K],
    ``cov`` [T, P, K] planes, ``w`` / ``alive`` [P, K]."""
    out = GMState(
        mean=torch.cat([gm.mean, mean], dim=2),
        cov=torch.cat([gm.cov, cov], dim=2),
        w=torch.cat([gm.w, w], dim=1),
        w_prev=torch.cat([gm.w_prev, torch.zeros_like(w)], dim=1),
        alive=torch.cat([gm.alive, alive], dim=1),
    )
    return compact(out, capacity or gm.capacity)


def replace_weakest(gm: GMState, mean, cov, w, alive,
                    sorted_desc: bool = False) -> GMState:
    """Insert K new Gaussians by replacing the K weakest slots.

    With the weakest old slots ascending v_1 <= ... <= v_K and the new
    scores descending n_1 >= ... >= n_K, the predicate ``n_i > v_i`` is
    monotone, so exactly the j strongest new entries displace the j weakest
    old ones: the top-capacity of the union.  Ties keep the old slot.

    ``mean`` [D, P, K], ``cov`` [T, P, K], ``w``/``alive`` [P, K];
    ``sorted_desc``: the new columns are already sorted by descending score.
    """
    K = w.shape[1]
    score_new = _score(w, alive)
    if not sorted_desc:
        score_new, order = planar.topk_stable(score_new, K)
        new = take_slots(GMState(mean, cov, w, w, alive), order)
        mean, cov, w, alive = new.mean, new.cov, new.w, new.alive
    if K > gm.capacity:
        # only the strongest `capacity` new entries can enter
        K = gm.capacity
        mean, cov = mean[:, :, :K], cov[:, :, :K]
        w, alive, score_new = w[:, :K], alive[:, :K], score_new[:, :K]
    v, victim = planar.topk_stable(_score(gm.w, gm.alive), K, largest=False)
    repl = score_new > v                                  # [P, K] prefix-true

    def insert(old, new):
        lead = old.shape[:-2]
        vic = victim.expand(lead + victim.shape)
        kept = torch.gather(old, -1, vic)
        return old.scatter(-1, vic, torch.where(repl, new, kept))

    return GMState(
        mean=insert(gm.mean, mean), cov=insert(gm.cov, cov),
        w=insert(gm.w, w), w_prev=insert(gm.w_prev, torch.zeros_like(w)),
        alive=insert(gm.alive, alive),
    )


def _merge_pairs(gm: GMState, t2):
    """The pair choice of one merge pass over the [P, M, M] pair cube:
    ``(gate, first_i, j_star)``.

    Gate (GaussianMixture.hpp:430-441): merge j into i (i < j, both alive)
    when either mean lies within t^2 of the other under its covariance.
    Lowest-index i claims each j (``first_i [P, j]``, M where none), and
    each i merges with its lowest claimed j (``j_star [P, i]``, M where
    none).  Safe-absorber rule: only a component with no smaller gated
    partner absorbs in this pass, else a broken chain (k-x and x-j gated,
    k-j not) loses j's mass; a deferred x absorbs on a later pass.
    """
    D = gm.dim
    P, M = gm.w.shape
    dev = gm.w.device
    idx = torch.arange(M, device=dev)
    cov_inv = planar.inv_sym(gm.cov, D)
    # diff[d][p, i, j] = mean[d][p, j] - mean[d][p, i]
    diff = [gm.mean[d][:, None, :] - gm.mean[d][:, :, None] for d in range(D)]
    d2_ij = planar.quad_sym(cov_inv[:, :, :, None], diff, D)
    d2_ji = d2_ij.transpose(1, 2)
    both_alive = gm.alive[:, :, None] & gm.alive[:, None, :]
    upper = idx[:, None] < idx[None, :]
    gate = both_alive & upper & ((d2_ij <= t2) | (d2_ji <= t2))

    i_ids = idx[None, :, None].expand(P, M, M)
    big = torch.full_like(i_ids, M)
    first_any = torch.where(gate, i_ids, big).amin(dim=1)          # [P, j]
    can_absorb = first_any == M                                    # [P, i]
    safe_gate = gate & can_absorb[:, :, None]
    first_i = torch.where(safe_gate, i_ids, big).amin(dim=1)       # [P, j]
    claimed = safe_gate & (i_ids == first_i[:, None, :])
    j_ids = idx[None, None, :].expand(P, M, M)
    j_star = torch.where(claimed, j_ids, big).amin(dim=2)          # [P, i]
    return gate, first_i, j_star


def _merge_pass(gm: GMState, t2, f_inflation):
    """One parallel pass of disjoint pairwise merges over the [P, M, M]
    pair cube (:func:`_merge_pairs`), moment-matched with covariance
    inflation.  Returns (gm, number of merges)."""
    D = gm.dim
    P, M = gm.w.shape
    j_star = _merge_pairs(gm, t2)[2]
    has_pair = j_star < M
    j_safe = torch.where(has_pair, j_star, torch.zeros_like(j_star))

    w1 = gm.w
    w2 = torch.gather(gm.w, 1, j_safe)
    wm = w1 + w2
    ok = has_pair & (wm != 0)
    x2 = torch.gather(gm.mean, 2, j_safe[None].expand(D, -1, -1))
    S2 = torch.gather(gm.cov, 2, j_safe[None].expand(gm.cov.shape[0], -1, -1))
    w1n = w1 / wm
    w2n = w2 / wm
    xm = gm.mean * w1n + x2 * w2n
    d1 = [xm[d] - gm.mean[d] for d in range(D)]
    d2v = [xm[d] - x2[d] for d in range(D)]
    # Sm = (w1 (S1 + f d1 d1^T) + w2 (S2 + f d2 d2^T)) / wm
    Sm = torch.stack([
        w1n * (gm.cov[planar.tri_index(i, j, D)] + f_inflation * d1[i] * d1[j])
        + w2n * (S2[planar.tri_index(i, j, D)] + f_inflation * d2v[i] * d2v[j])
        for i in range(D) for j in range(i, D)])

    # each absorbed j has exactly one absorber; slot 0 is never absorbed, so
    # the non-pairs' writes to it (all False) cannot collide with a merge
    merged_j = torch.zeros_like(gm.alive).scatter(1, j_safe, ok)
    out = GMState(
        mean=torch.where(ok, xm, gm.mean),
        cov=torch.where(ok, Sm, gm.cov),
        w=torch.where(ok, wm, gm.w),
        w_prev=torch.where(ok, torch.zeros_like(gm.w_prev), gm.w_prev),
        alive=gm.alive & ~merged_j,
    )
    return out, ok.sum()


def merge_fixpoint(gm: GMState, threshold, f_inflation,
                   max_passes: int = 8) -> GMState:
    """Merge passes until one merges nothing or ``max_passes`` have run (the
    first pass always runs).  The plain twin of the merge2d and merge3d
    kernels; expects slots compacted (see :func:`merge`)."""
    t2 = threshold * threshold
    for _ in range(max_passes):
        gm, n = _merge_pass(gm, t2, f_inflation)
        if int(n) == 0:
            break
    return gm


def merge(gm: GMState, threshold, f_inflation,
          max_passes: int = 8) -> GMState:
    """Merge until fixed point (bounded passes).

    Slots are sorted by descending weight at entry to reproduce the
    reference's weight-sorted vector: the pass's lowest-index pair claiming
    depends on slot order, and unsorted entry measurably degrades the
    filter.  The merge runs in the CUDA kernel of its dimension for CUDA
    tensors, at any capacity (its launch plan picks the form from the
    shape), and in the plain twin for CPU tensors
    (:func:`merge2d_kernel.merge2d`, :func:`merge3d_kernel.merge3d`).
    """
    gm = compact(gm, gm.capacity)
    kernel = merge3d_kernel.merge3d if gm.dim == 3 else merge2d_kernel.merge2d
    return kernel(gm, threshold, f_inflation, max_passes=max_passes)
