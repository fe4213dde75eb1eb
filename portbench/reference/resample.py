"""Low-variance (systematic) resampling (port of
the JAX package's ``ops/resample.py``; ParticleFilter.hpp:399-492).

``u0``, the one uniform draw of systematic resampling, is an input so that a
caller can replay another generator's stream.
"""

from __future__ import annotations

import math

import torch

from .state import map_rows


def normalize_log_weights(log_w: torch.Tensor) -> torch.Tensor:
    """ParticleFilter::normalizeWeights in the log domain (hpp:352-363)."""
    return log_w - torch.logsumexp(log_w, dim=0)


def effective_count(log_w: torch.Tensor) -> torch.Tensor:
    """N_eff = 1 / sum(w_i^2) on normalized weights (hpp:404-415)."""
    return torch.exp(-torch.logsumexp(2.0 * normalize_log_weights(log_w),
                                      dim=0))


def systematic_ancestors(u0: torch.Tensor, log_w: torch.Tensor,
                         n: int) -> torch.Tensor:
    """Ancestor indices [n] (int64): the comb ``(u0 + i) / n`` over the
    cumulative normalized weights (hpp:420-445)."""
    cum = torch.cumsum(torch.exp(normalize_log_weights(log_w)), dim=0)
    pts = (u0 + torch.arange(n, dtype=log_w.dtype, device=log_w.device)) / n
    anc = torch.searchsorted(cum, pts, side="left")
    return torch.clamp(anc, 0, log_w.shape[0] - 1)


def maybe_resample(u0: torch.Tensor, log_w: torch.Tensor, ess_threshold,
                   allow: torch.Tensor):
    """ESS-gated resample; returns ``(ancestors, new_log_w, did)``.

    Both outcomes are computed and selected on the device, so the step
    never waits on the gate.  Without a resample the ancestors are the
    identity and the weights are normalized.
    """
    n = log_w.shape[0]
    do = allow & (effective_count(log_w) <= ess_threshold)
    anc = systematic_ancestors(u0, log_w, n)
    identity = torch.arange(n, device=log_w.device)
    ancestors = torch.where(do, anc, identity)
    new_log_w = torch.where(do, torch.full_like(log_w, -math.log(n)),
                            normalize_log_weights(log_w))
    return ancestors, new_log_w, do


def gather_particles(tree, ancestors: torch.Tensor):
    """Gather every per-particle entry of a dict by ancestor index (the
    resampling map copy, ParticleFilter.hpp:446-479): containers
    (GMState, BirthCandidates) along their own particle axis, tensors along
    their leading axis.
    """
    return map_rows(lambda x, axis: x.index_select(axis, ancestors), tree)
