"""The port's MH and Victoria Park diagnostic tools (``scripts/
{mh_ambiguity_probe,vp_cap_count,vp_diag,vp_mh_diag}_torch.py``) on the
CPU: each tool's arithmetic against the JAX package's helpers on the same
arrays (``ops.assignment.ambiguous_lanes`` and ``murty``,
``io.logs.ancestral_path``, ``apps.rbphdslam_victoriapark.gps_rmse``), and
a three-frame synthetic Victoria Park run with snapshots through the
three VP tools."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rfs_slam_tpu.apps.rbphdslam_victoriapark import gps_rmse as jax_rmse
from rfs_slam_tpu.io.logs import ancestral_path as jax_path
from rfs_slam_tpu.ops import assignment as jas
from rfs_slam_tpu_torch.io import vp_synth

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WINDOW = 3.0


def script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


probe = script("mh_ambiguity_probe_torch")
cap_count = script("vp_cap_count_torch")
vp_diag = script("vp_diag_torch")
mh_diag = script("vp_mh_diag_torch")


def da_tables(seed, lanes=12, n=8, real_cols=5):
    """Log-likelihood tables as ``_da_table`` lays them out: the real block
    ``[rows, real_cols]`` of likelihoods, the floor elsewhere; half the
    lanes with one clear assignment, half with near ties."""
    rng = np.random.default_rng(seed)
    floor = -10.0
    t = np.full((lanes, n, n), floor, np.float32)
    rows = rng.integers(1, n + 1, lanes)
    for p in range(lanes):
        blk = rng.uniform(-8.0, -1.0, (rows[p], real_cols))
        if p % 2 == 0:              # one assignment far above the rest
            k = min(rows[p], real_cols)
            blk[:] = floor
            blk[np.arange(k), np.arange(k)] = rng.uniform(-0.5, 0.0, k)
        t[p, :rows[p], :real_cols] = blk
    return t, rows.astype(np.int32), real_cols


@pytest.mark.parametrize("seed", [0, 1])
def test_ambiguous_count_matches_jax(seed):
    t, rows, nz = da_tables(seed)
    want = np.asarray(jas.ambiguous_lanes(jnp.asarray(t), jnp.asarray(rows),
                                          nz, WINDOW))
    got = probe.ambiguous_count(torch.from_numpy(t), torch.from_numpy(rows),
                                torch.tensor(nz), WINDOW)
    assert 0 < want.sum() < len(t)
    assert int(got) == int(want.sum())
    # the JAX script's statistics on the counts
    counts = np.array([0, 3, 7, 7, 12, 5])
    s = probe.summary(counts, 6)
    assert s["mean"] == counts.mean() and s["max"] == 12
    assert s["p90"] == np.percentile(counts, 90)
    assert s["overflow_share"]["6"] == s["budget_overflow_share"] == 0.5
    assert set(s["overflow_share"]) == {"6", "48", "64", "96", "128", "192"}


def test_cap_count_matches_jax():
    t, rows, nz = da_tables(2, lanes=8, n=8, real_cols=6)
    H, cap = 3, 2
    jax_nv = np.asarray(jax.vmap(lambda c, r: jas.murty(
        c, H, real_rows=r, real_cols=nz, child_cap=cap, prune_window=WINDOW,
        return_nvalid=True)[3])(jnp.asarray(t), jnp.asarray(rows)))
    *_, nv = cap_count.murty(torch.from_numpy(t), H,
                             real_rows=torch.from_numpy(rows).long(),
                             real_cols=torch.tensor(nz), child_cap=cap,
                             prune_window=WINDOW, return_nvalid=True)
    np.testing.assert_array_equal(nv.numpy(), jax_nv)
    s = cap_count.cap_summary(nv.numpy(), rows, cap)
    assert s == cap_count.cap_summary(jax_nv, rows, cap)
    assert s["waves"] == len(t) * (H - 1)
    assert s["binds_share"] == float((jax_nv > cap).mean())
    assert s["binds_share_by_cap"]["17"] == 0.0
    assert s["valid_children"]["max"] == int(jax_nv.max())


def vp_outputs(seed, F=40, P=5, M=16):
    rng = np.random.default_rng(seed)
    parent = np.tile(np.arange(P), (F, 1))
    resampled = rng.random(F) < 0.3
    parent[resampled] = rng.integers(0, P, (int(resampled.sum()), P))
    t = np.cumsum(rng.uniform(0.15, 0.3, F))
    gps = np.stack([np.sort(rng.uniform(t[0] - 1, t[-1] + 1, 12)),
                    rng.normal(0, 5, 12), rng.normal(0, 5, 12)], axis=1)
    w = rng.random((F, P))
    outs = {"pose": np.cumsum(rng.normal(0, 3, (F, P, 3)), axis=0),
            "w": w / w.sum(axis=1, keepdims=True), "best": w.argmax(axis=1),
            "gm_w": rng.random((F, M)), "alive": rng.random((F, M)) < 0.6,
            "parent": parent}
    return outs, t, gps


def test_vp_diag_segments_match_jax_helpers():
    outs, t, gps = vp_outputs(3)
    rows = vp_diag.segment_health(outs, t, gps)
    # scripts/vp_diag.py:38-55 with the JAX package's helpers
    path = jax_path(outs["pose"], outs["parent"], outs["best"][-1])
    ess = 1.0 / np.maximum(np.sum(outs["w"] ** 2, axis=1), 1e-30)
    alive = outs["alive"]
    strong = ((outs["gm_w"] >= 0.75) & alive).sum(axis=1)
    total_w = np.where(alive, outs["gm_w"], 0).sum(axis=1)
    resampled = (outs["parent"] != np.arange(5)[None]).any(axis=1)
    assert len(rows) == 10
    for r, s in zip(rows, range(0, 40, 4)):
        sl = slice(s, s + 4)
        assert r["start"] == s and r["frames"] == 4
        assert r["ess"] == ess[sl].mean()
        assert r["map_alive"] == alive[sl].sum(axis=1).mean()
        assert r["strong"] == strong[sl].mean()
        assert r["sum_w"] == total_w[sl].mean()
        assert r["resampled"] == resampled[sl].mean()
        np.testing.assert_equal(r["rmse_gps_m"],
                                jax_rmse(t[sl], path[sl], gps))


@pytest.mark.parametrize("from_frame", [0, 9])
def test_vp_mh_diag_score_matches_jax_helpers(from_frame):
    outs, t, gps = vp_outputs(4)
    outs["pose"] *= 3.0              # some fixes past 10 m
    path = jax_path(outs["pose"], outs["parent"], outs["best"][-1])
    rec = mh_diag.divergence_score(t, path, gps, from_frame)
    assert rec["rmse_m"] == jax_rmse(t[from_frame:], path[from_frame:], gps)
    q = (40 - from_frame) // 4
    for k, quart in enumerate(rec["quartiles"]):
        s = from_frame + k * q
        e = from_frame + (k + 1) * q if k < 3 else 40
        assert quart["frames"] == [s, e]
        np.testing.assert_equal(quart["rmse_m"],
                                jax_rmse(t[s:e], path[s:e], gps))
    # scripts/vp_mh_diag.py:66-86: nearest frame within 0.5 s
    gi = np.array([np.argmin(np.abs(t - g)) for g in gps[:, 0]])
    keep = (np.abs(t[gi] - gps[:, 0]) <= 0.5) & (gi >= from_frame)
    err = np.linalg.norm(path[gi, :2] - gps[:, 1:3], axis=1)[keep]
    assert rec["fixes"] == keep.sum() > 0
    assert rec["per_fix_m"]["max"] == err.max()
    assert rec["fixes_over_10m"] == (err > 10).sum() > 0
    first = np.nonzero(keep)[0][np.argmax(err > 10)]
    assert rec["first_over_10m"]["frame"] == gi[first]
    assert rec["first_over_10m"]["t"] == gps[first, 0]


def test_vp_tools_on_a_three_frame_run(tmp_path):
    """A three-frame synthetic MH VP run with a snapshot a frame (made by
    the cap-count tool through the app), counted and scored; the RB-PHD
    table on the same stream.  Three frames span 0.43 s, shorter than the
    stream's GPS period, so one fix at the second frame's time is written
    for the scores to read."""
    data = tmp_path / "vp"
    vp_synth.write(str(data), seed=0, n_frames=3)
    frame_t = 0.4375
    with open(data / "gps.dat", "w") as f:
        f.write(f"{frame_t:.6f} 0.5 0.1\n")
    cfg = vp_synth.write_config(str(data / "config.xml"))
    ck = str(tmp_path / "ck")
    stream = ["--data", str(data), "--cfg", cfg]
    rec = cap_count.main(stream + ["--ckpt-dir", ck, "--ckpt-every", "1",
                                   "--particles", "2", "--device", "cpu"])
    assert sorted(os.listdir(ck)) == [
        "ckpt_1.pt", "ckpt_2.pt", "ckpt_3.pt", "outs_000000_000001.npz",
        "outs_000001_000002.npz", "outs_000002_000003.npz"]
    assert rec["snapshots"] == 2 and rec["waves"] > 0
    assert rec["waves"] % 2 == 0           # H - 1 = 2 waves a live lane
    assert 0.0 <= rec["binds_share"] <= 1.0
    score = mh_diag.main(stream + ["--ckpt-dir", ck])
    assert score["frames"] == 3 and score["fixes"] == 1
    assert np.isfinite(score["rmse_m"])
    assert score["per_fix_m"]["max"] == pytest.approx(score["rmse_m"])
    assert score["quartiles"][1]["frames"] == [1, 2]
    assert np.isfinite(score["quartiles"][1]["rmse_m"])
    health = vp_diag.main(stream + ["--particles", "2", "--device", "cpu"])
    assert [r["frames"] for r in health["segments"]] == [1, 1, 1]
    assert all(np.isfinite(r["ess"]) for r in health["segments"])
    assert np.isfinite(health["segments"][1]["rmse_gps_m"])
