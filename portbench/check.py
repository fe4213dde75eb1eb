"""The comparison that decides ``correct``: a filter state the program
produced against the state the plain reference works out from the same
state before the step, the same inputs and the same draws.

Particles are matched by their resampling ancestor, not by slot: a
program's particle and a reference particle with the same ancestor were
copied from the same particle before resampling, so they must agree.  The
ancestors themselves are held to the reference's by two numbers: where
rounding moves a boundary of the systematic resampling (the kernels'
rounding differs from the plain twins' by an ulp), a copy goes to the
neighbouring ancestor, a few in a run; a resampling that ignores the
weights moves most of them.

Numbers a step, the worst over the steps compared, each held to the
cell's limit:

* ``pose_gap``: the widest gap of the poses, the log weights and the last
  measurements over the matched particles, as a share of that field's
  largest magnitude in the reference.  A non-finite value on one side
  only reads infinite.
* ``map_gap``: the same gap of the map's means, covariances and weights
  over the slots alive on both sides and of the birth candidates' means
  and covariances over the candidates alive on both sides, taken for each
  ancestor (the widest over its particles' entries); the number is the
  second widest over the ancestors.  A decision at a threshold (a gate,
  a top-k tie, a merge distance) that rounding moves changes one
  particle's map, and its copies, by up to the whole of a weight: one
  ancestor's map may depart, two may not.  ``map_gap_widest``, the
  widest, is reported beside it.
* ``unmatched_share``: the share of the program's particles whose
  ancestor the reference did not pick (their fields are not compared).
* ``copies_share``: the share of the particles copied from another
  ancestor than the reference's: half the sum over the ancestors of the
  gap between the two sides' counts of copies, over the particles.
* ``mismatch_share``: the share of the matched particles' discrete entries
  (alive flags, birth counters, unused-measurement flags, landmarks in
  view) and of the update counters that differ: a prune or a birth that
  keeps or drops other slots than the reference's.

Each reading also says whether the reference resampled in that step
(``resampled``), so that a run shows how many of its compared steps
exercised the resampling.
"""

from __future__ import annotations

import dataclasses
import math

import torch

# float fields compared over the entries alive on both sides, and the flag
# that says which are alive
MASKED = {"gm.mean": "gm.alive", "gm.cov": "gm.alive", "gm.w": "gm.alive",
          "gm.w_prev": "gm.alive", "birth.mean": "birth.alive",
          "birth.cov": "birth.alive"}
POSE_FLOATS = ("particles.pose", "particles.log_w", "last_z")
DISCRETE = ("gm.alive", "birth.alive", "birth.n_support", "birth.n_checks",
            "last_unused", "n_in_fov", "n_updates", "n_meas")
# the particle axis of each per-particle field (the others are shared)
PARTICLE_AXIS = {"particles.pose": 0, "particles.log_w": 0,
                 "particles.parent": 0, "gm.mean": 1, "gm.cov": 1,
                 "gm.w": 0, "gm.w_prev": 0, "gm.alive": 0, "birth.mean": 1,
                 "birth.cov": 1, "birth.n_support": 0, "birth.n_checks": 0,
                 "birth.alive": 0, "last_unused": 0, "n_in_fov": 0}
NUMBERS = ("pose_gap", "map_gap", "unmatched_share", "copies_share",
           "mismatch_share")


def flatten(state, prefix: str = "") -> dict:
    """The state's tensors by dotted field name."""
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if dataclasses.is_dataclass(v):
            out.update(flatten(v, f"{prefix}{f.name}."))
        else:
            out[f"{prefix}{f.name}"] = v
    return out


def clone(state):
    """A copy of every tensor of a state (the same dataclasses)."""
    changes = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        changes[f.name] = (clone(v) if dataclasses.is_dataclass(v)
                           else v.clone())
    return dataclasses.replace(state, **changes)


def particle_gaps(p: torch.Tensor, r: torch.Tensor, mask: torch.Tensor,
                  ax: int) -> torch.Tensor:
    """For each particle, max |p - r| over its entries in ``mask`` as a
    share of max |r| over all of ``mask`` (0 where both are all zero);
    infinite where one side alone is not finite."""
    p, r = p.double(), r.double()
    m = mask.expand_as(r)
    fp, fr = torch.isfinite(p), torch.isfinite(r)
    same = (p == r) | (torch.isnan(p) & torch.isnan(r))
    bad = m & ((fp != fr) | (~fp & ~same))
    ok = m & fp & fr
    zero = torch.zeros((), dtype=p.dtype, device=p.device)
    diff = torch.where(ok, (p - r).abs(), zero)
    scale = float(torch.where(ok, r.abs(), zero).max()) if r.numel() else 0.0
    rel = diff / scale if scale > 0 else torch.where(diff > 0, math.inf,
                                                     0.0)
    rel = torch.where(bad, math.inf, rel)
    P = r.shape[ax]
    if rel.numel() == 0:
        return torch.zeros(P, dtype=rel.dtype, device=rel.device)
    return rel.movedim(ax, 0).reshape(P, -1).amax(dim=1)


def field_gap(p: torch.Tensor, r: torch.Tensor, mask=None) -> float:
    """The widest of :func:`particle_gaps` over the whole field (``mask``
    None: every entry)."""
    if mask is None:
        mask = torch.ones((), dtype=torch.bool, device=r.device)
    g = particle_gaps(p, r, mask, 0)
    return float(g.max()) if g.numel() else 0.0


def second_widest(gap: torch.Tensor, ancestor: torch.Tensor,
                  matched: torch.Tensor) -> tuple[float, float]:
    """``(second widest, widest)`` of the per-ancestor gaps: each
    ancestor's the widest over its matched particles."""
    P = gap.shape[0]
    per = torch.zeros(P, dtype=gap.dtype, device=gap.device)
    per = per.scatter_reduce(0, ancestor[matched], gap[matched],
                             reduce="amax")
    top = torch.topk(per, min(2, P)).values.tolist() + [0.0]
    return top[1], top[0]


def match(prog: dict, ref: dict):
    """``(ref aligned to the program's particles, matched [P])``: for each
    program particle a reference particle with the same ancestor."""
    pa = prog["particles.parent"].long()
    ra = ref["particles.parent"].to(pa.device).long()
    P = pa.shape[0]
    first = torch.full((P,), -1, dtype=torch.long, device=pa.device)
    first = first.scatter_reduce(0, ra, torch.arange(P, device=pa.device),
                                 reduce="amax")
    j = first[pa]
    matched = j >= 0
    idx = j.clamp(min=0)
    aligned = {}
    for name, v in ref.items():
        v = v.to(pa.device)
        ax = PARTICLE_AXIS.get(name)
        aligned[name] = v if ax is None else v.index_select(ax, idx)
    return aligned, matched


def _rows(mask, ax, like):
    """The particle mask ``[P]`` shaped to broadcast over a field whose
    particle axis is ``ax``."""
    shape = [1] * like.dim()
    shape[ax] = mask.shape[0]
    return mask.view(shape)


def copies_share(prog_parent: torch.Tensor, ref_parent: torch.Tensor) -> float:
    """Half the sum over the ancestors of the gap between the counts of
    copies on the two sides, over the particles."""
    P = prog_parent.shape[0]
    cp = torch.bincount(prog_parent.long(), minlength=P)
    cr = torch.bincount(ref_parent.to(prog_parent.device).long(), minlength=P)
    return float((cp - cr).abs().sum()) / (2 * P)


BROKEN = {"pose_gap": math.inf, "map_gap": math.inf,
          "map_gap_widest": math.inf, "unmatched_share": 1.0,
          "copies_share": 1.0, "mismatch_share": 1.0}


def compare(prog, ref) -> dict:
    """The numbers of the program's state against the reference's,
    ``resampled`` (whether the reference resampled) and ``fields``: the
    float gap or the count of differing entries of each field where it is
    not zero."""
    a = flatten(prog)
    rf = flatten(ref)
    P = rf["particles.parent"].shape[0]
    resampled = bool((rf["particles.parent"].long().cpu()
                      != torch.arange(P)).any())
    if a["particles.parent"].shape != rf["particles.parent"].shape:
        return dict(BROKEN, resampled=resampled,
                    fields={"particles.parent": "shape"})
    copies = copies_share(a["particles.parent"], rf["particles.parent"])
    b, matched = match(a, rf)
    fields = {}
    unmatched = int((~matched).sum())
    if unmatched:
        fields["particles.parent"] = unmatched
    for name in POSE_FLOATS + tuple(MASKED):
        if a[name].shape != b[name].shape:
            return dict(BROKEN, resampled=resampled, fields={name: "shape"})
    pose_gap = 0.0
    for name in POSE_FLOATS:
        p, r = a[name], b[name]
        mask = (_rows(matched, PARTICLE_AXIS[name], p)
                if name in PARTICLE_AXIS else None)
        g = field_gap(p, r.to(p.dtype), mask)
        if g:
            fields[name] = g
        pose_gap = max(pose_gap, g)
    P = matched.shape[0]
    per_particle = torch.zeros(P, dtype=torch.float64, device=matched.device)
    for name, flag in MASKED.items():
        p, r = a[name], b[name]
        ax = PARTICLE_AXIS[name]
        both = a[flag] & b[flag]
        if p.dim() == both.dim() + 1:
            both = both[None]
        g = particle_gaps(p, r.to(p.dtype), both & _rows(matched, ax, p), ax)
        widest = float(g.max())
        if widest:
            fields[name] = widest
        per_particle = torch.maximum(per_particle, g)
    map_gap, map_widest = second_widest(
        per_particle, a["particles.parent"].long(), matched)
    bad = total = 0
    for name in DISCRETE:
        p, r = a[name], b[name].to(a[name].dtype)
        if p.shape != r.shape:
            return dict(BROKEN, resampled=resampled, fields={name: "shape"})
        diff = p != r
        if name in PARTICLE_AXIS:
            keep = _rows(matched, PARTICLE_AXIS[name], p).expand_as(p)
            diff, n_all = diff & keep, int(keep.sum())
        else:
            n_all = p.numel()
        n = int(diff.sum())
        if n:
            fields[name] = n
        bad += n
        total += n_all
    return {"pose_gap": pose_gap, "map_gap": map_gap,
            "map_gap_widest": map_widest,
            "unmatched_share": unmatched / matched.shape[0],
            "copies_share": copies,
            "mismatch_share": bad / max(total, 1), "resampled": resampled,
            "fields": fields}


def worst(readings) -> dict:
    """Each number's worst reading (0 where there is none)."""
    return {k: max((r[k] for r in readings), default=0.0) for k in NUMBERS}


def verdict(numbers: dict, limits: dict) -> bool:
    """Whether every number is within its limit."""
    return all(numbers[k] <= limits[k] for k in NUMBERS)
