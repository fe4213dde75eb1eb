"""The least time an NVIDIA H100 could take for a call's work: the larger
of its bytes over the HBM rate and its float32 operations over the card's
float32 rate (NVIDIA's H100 SXM data sheet, dense, at the full 700 W).
The arithmetic of the port's ``chip_smoke.py`` (``bound``,
``map_update_bound``, ``merge_tests``, ``merge_trace``, ``merge_bound``),
frozen here over the reference's plain twins: every input byte counted
once and every output byte once, and the operations these inputs need."""

from __future__ import annotations

import torch

from portbench.reference import gm as gm_ops

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12


def nbytes(*tensors) -> int:
    total = 0
    for t in tensors:
        if isinstance(t, (list, tuple)):
            total += nbytes(*t)
        else:
            total += t.numel() * t.element_size()
    return total


def bound(n_bytes: int, n_flop: float) -> tuple[float, str]:
    """``(seconds, what bounds it)``."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = n_flop / PEAK_F32_FLOP_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def map_update_bound(args, out, T: int) -> tuple[float, str]:
    """:func:`bound` of :func:`map_update_work`."""
    return bound(*map_update_work(args, out, T))


def map_update_work(args, out, T: int) -> tuple[int, float]:
    """``(bytes, FLOP)`` of the 2-D map-update head (``map_update2d``'s
    work): every input read once and every output written once, over
    every slot; the operations this input needs: per alive slot
    (measure, H, S, its inverse, K, the updated covariance: ~60 FLOP), per
    cell of a valid measurement and a table slot, one alive, detectable
    and in range (innovation, angle wrap, quadratic form, likelihood,
    gates, weight and its normalisation: ~27 FLOP), and the iterated
    per-column argmax over the table's slots (2 per slot and pass).
    ``args``: the head's inputs ``(pose, mx, my, c00, c01, c11, w, w_prev,
    alive, z, z_mask, params)``; ``out``: its outputs as the plain twin
    works them out (the kernel's shapes, and its values up to rounding)."""
    alive, z_mask, params = args[8], args[10], args[11]
    r_max, r_min = params[0], params[1]
    r = out.z_exp[0]
    table = alive & (out.pd > 0) & (r >= r_min) & (r <= r_max)
    outs = [out.pd, out.col_sum, out.w, out.w_prev, out.K, out.z_exp,
            out.cov_upd, out.cand_w, out.cand_m, out.unused]
    flop = (int(alive.sum()) * 60
            + int(z_mask.sum()) * int(table.sum()) * (27 + 2 * T))
    return nbytes(*args[:11]) + nbytes(*outs), flop


def merge_tests(gate, alive, first_i):
    """The gate tests one merge pass needs on this input, per particle
    [P]: a safe row (no gated alive partner below it) tests every alive
    slot below it; an unsafe row one partner, then the safe slots below it
    up to its claim (all of them where it claims none)."""
    N = alive.shape[1]
    safe = alive & ~gate.any(dim=1)
    alive_below = torch.cumsum(alive, 1) - alive.long()
    safe_upto = torch.cumsum(safe, 1)
    claims = torch.where(first_i < N,
                         safe_upto.gather(1, first_i.clamp(max=N - 1)),
                         safe_upto - safe.long())
    tests = torch.where(safe, alive_below,
                        torch.where(alive, 1 + claims, 0))
    return tests.sum(dim=1).double()


def merge_trace(gm, threshold, f_inflation, max_passes=8):
    """The passes of the merge fixpoint, each particle until one of its
    passes merges nothing: per pass, (the particles still running [P],
    their alive slots [P], the pairs each merged [P], the gate tests it
    needs [P])."""
    t2 = threshold * threshold
    active = gm.alive.new_ones(gm.alive.shape[0])
    out = []
    for _ in range(max_passes):
        a = gm.alive.sum(dim=1).double()
        gate, first_i, _ = gm_ops._merge_pairs(gm, t2)
        tests = merge_tests(gate, gm.alive, first_i)
        del gate
        gm, _ = gm_ops._merge_pass(gm, t2, f_inflation)
        merged = a - gm.alive.sum(dim=1).double()
        out.append((active, a, merged * active, tests))
        active = active & (merged > 0)
        if not bool(active.any()):
            break
    return out


# per alive slot and pass: the covariance's inverse; per merged pair: the
# moment match (chip_smoke.py's counts)
MERGE_FLOP = {2: (7, 30), 3: (25, 60)}


def merge_bound(gm, threshold, f_inflation) -> tuple[float, str]:
    """:func:`bound` of :func:`merge_work`."""
    return bound(*merge_work(gm, threshold, f_inflation))


def merge_work(gm, threshold, f_inflation) -> tuple[int, float]:
    """``(bytes, FLOP)`` of the merge fixpoint on ``gm`` (compacted, as
    the kernels take it): every plane read once and written once; each
    pass inverts its alive
    slots' covariances, makes the gate tests the pass needs and merges its
    pairs.  A pair's two-way gate needs the D subtractions of v, the T =
    D(D+1)/2 products of v's entries and, per form, T multiplies and T - 1
    adds: 31 FLOP at D=3, 15 at D=2."""
    tri = gm.dim * (gm.dim + 1) // 2
    pair_flop = gm.dim + tri + 2 * (2 * tri - 1)
    inv_flop, merge_flop = MERGE_FLOP[gm.dim]
    flop = sum(float((active * (a * inv_flop + tests * pair_flop
                                + merged * merge_flop)).sum())
               for active, a, merged, tests in merge_trace(
                   gm, threshold, f_inflation))
    planes = [gm.mean, gm.cov, gm.w, gm.w_prev, gm.alive]
    return 2 * nbytes(*planes), flop
