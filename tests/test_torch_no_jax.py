"""rfs_slam_tpu_torch imports (its package walk reaching the checkpoint,
timing and Victoria Park FastSLAM modules, the library modules, the
examples, the particle mesh and the weak-scaling harness) and the port's
scripts (``scripts/*_torch.py``), and runs a block-diagonal JCBB search, a
nearest-point query, a few 2-D simulation steps of RB-PHD and MH-FastSLAM,
three synthetic Victoria Park frames (RB-PHD with snapshots, MH-FastSLAM)
and RB-PHD steps sharded over a one-rank gloo group, in a process
where JAX and the JAX package cannot be imported (the GPU machine has no
JAX); the Hungarian kernel's launch plan."""

import os
import subprocess
import sys
import textwrap

import pytest

from rfs_slam_tpu_torch.ops.kernels import build, hungarian

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import importlib, pkgutil, sys

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "flax", "rfs_slam_tpu"):
                raise ImportError(f"blocked: {name}")
            return None

    sys.meta_path.insert(0, Block())
    import rfs_slam_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(
        rfs_slam_tpu_torch.__path__, "rfs_slam_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    for name in ("utils.checkpoint", "utils.timing", "apps._vp_common",
                 "apps.fastslam_victoriapark", "apps.vp_map_ospa",
                 "apps.convertlogfiles", "ops.jcbb", "ops.spatial",
                 "core.frame2d", "io.native", "utils.integrity",
                 "utils.memprofile", "examples.linear_assignment_murty",
                 "examples.linear_assignment_partition",
                 "examples.linear_assignment_lexicographic",
                 "examples.ospa_error", "examples.spatial_index",
                 "parallel.mesh", "parallel.dryrun", "apps.example_step",
                 "parallel.map_overflow_demo", "parallel.map_shard_bench",
                 "parallel.scaling_bench"):
        assert "rfs_slam_tpu_torch." + name in names, name
    # the port's scripts (their main() runs only from the command line)
    import glob, importlib.util, os
    tools = sorted(glob.glob(os.path.join("scripts", "*_torch.py")))
    for path in tools:
        spec = importlib.util.spec_from_file_location(
            os.path.basename(path)[:-3], path)
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
    assert len(tools) >= 7, tools

    import torch
    from rfs_slam_tpu_torch.ops import jcbb, spatial
    innov = torch.zeros((3, 4, 2))
    innov[:, 2] = 9.0
    assoc, n, _ = jcbb.jcbb_block_diag(
        innov, torch.eye(2).expand(4, 2, 2), torch.ones(3, dtype=torch.bool),
        torch.ones(4, dtype=torch.bool), beam=8)
    assert assoc.tolist() == [0, 1, 3] and int(n) == 3
    pts = torch.tensor([[0.5, 0.5], [2.5, 1.5], [3.5, 3.5]])
    idx = spatial.build(pts, torch.ones(3, dtype=torch.bool), (0.0, 0.0),
                        1.0, (4, 4))
    assert spatial.nearest(idx, torch.tensor([[2.2, 1.9]]))[0].tolist() == [1]

    import tempfile
    import torch
    from rfs_slam_tpu_torch.apps import rbphdslam2dsim as app
    from rfs_slam_tpu_torch.io import sim2d
    cfg = sim2d.Sim2DConfig(timesteps=8, n_landmarks=5, n_segments=2)
    data = sim2d.generate(cfg, traj_seed=1, noise_seed=1, z_capacity=40)
    filt = app.build_filter(cfg, torch.device("cpu"), n_particles=4)
    from rfs_slam_tpu_torch.apps import sim2d_common as loop
    _, best = loop.run(filt, loop.sim_inputs(data),
                       torch.Generator().manual_seed(0), cfg.dt)
    assert best.shape == (7, 3)

    from rfs_slam_tpu_torch.apps import fastslam2dsim as fs_app
    from rfs_slam_tpu_torch.io import sim2d_xml
    from rfs_slam_tpu_torch.io.xmlconfig import XmlConfig, load_sim2d
    with tempfile.TemporaryDirectory() as d:
        xcfg = XmlConfig(sim2d_xml.write_config(d + "/mh.xml", "mhfastslam"))
    fs = fs_app.build_filter_from_xml(xcfg, cfg, z_capacity=40,
                                      n_particles=2,
                                      device=torch.device("cpu"))
    _, outs = loop.run_logged(fs, loop.sim_inputs(data),
                              torch.Generator().manual_seed(0), cfg.dt)
    assert outs["pose"].shape == (7, 6, 3)

    from rfs_slam_tpu_torch.apps import rbphdslam_victoriapark as vp_app
    from rfs_slam_tpu_torch.io import victoria_park as vp_io, vp_synth
    from rfs_slam_tpu_torch.io.xmlconfig import XmlConfig
    with tempfile.TemporaryDirectory() as d:
        vp_synth.write(d, seed=0, n_frames=3, scans=True)
        vfilt, icov, ack = vp_app.build(
            XmlConfig(vp_synth.write_config(d + "/config.xml")),
            map_capacity=32, n_particles=4, device=torch.device("cpu"))
        frames = vp_io.load(d, z_capacity=24, ackerman=ack)
        _, outs = vp_app.run(vfilt, icov, frames,
                             torch.Generator().manual_seed(0),
                             ckpt_dir=d + "/ckpt", ckpt_every=2)
        assert outs["pose"].shape == (3, 4, 3)
        from rfs_slam_tpu_torch.apps import fastslam_victoriapark as fs_vp
        ffilt, icov, _ = fs_vp.build(
            XmlConfig(d + "/config.xml"), map_capacity=32, n_particles=2,
            hypotheses=3, device=torch.device("cpu"))
        _, outs = fs_vp.run(ffilt, icov, frames,
                            torch.Generator().manual_seed(0))
        assert outs["pose"].shape == (3, 6, 3)
    # a sharded step: a gloo group of one rank, the collectives through it
    from rfs_slam_tpu_torch.parallel import mesh as mesh_lib
    with tempfile.TemporaryDirectory() as d:
        mesh_lib.init_process_group("file://" + d + "/rdv", 1, 0,
                                    torch.device("cpu"))
        m = mesh_lib.make_mesh(4, torch.device("cpu"))
        assert torch.distributed.get_backend(m.group) == "gloo"
        st = loop.steps(filt, loop.device_inputs(loop.sim_inputs(data),
                                                 m.device),
                        torch.Generator().manual_seed(0), cfg.dt,
                        lambda k, s: None, m)
        assert m.stats["collectives"] > 0
        assert mesh_lib.gather_state(st, m).particles.pose.shape == (4, 3)
        torch.distributed.destroy_process_group()
    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "jaxlib", "flax", "rfs_slam_tpu")]
    assert not bad, bad
    print(len(names))
""")


def test_port_imports_and_steps_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"   # small ops: threads only add contention
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 30


@pytest.mark.parametrize("B,n,k,in_smem", [
    (1, 1, 1, True), (200, 32, 1, True), (1200, 32, 1, True),
    (8, 33, 2, True), (4, 128, 4, True), (2, 1024, 32, False),
    (3, 1, 1, True), (3, 32, 1, True), (3, 33, 2, True), (3, 52, 2, True),
    (3, 64, 2, True), (3, 65, 4, True), (3, 128, 4, True),
    (3, 129, 8, True), (3, 240, 8, True), (3, 241, 8, False),
    (3, 256, 8, False), (3, 257, 16, False), (3, 513, 32, False),
    (3, 1024, 32, False)])
def test_hungarian_launch_plan_accepts(B, n, k, in_smem):
    """K = ceil(n / 32) rounded up to an instantiation; the matrix in shared
    memory up to n = 240 (4 n^2 + 4 n bytes within a block's 232,448),
    read from global memory above."""
    plan = hungarian.launch_plan(B, n)
    assert (plan.threads, plan.k, plan.in_smem) == (32, k, in_smem)
    assert plan.smem == 4 * n * n * in_smem + 4 * n
    assert plan.smem <= build.MAX_SMEM


@pytest.mark.parametrize("B,n", [(0, 32), (8, 0), (8, 1025), (0, 300)])
def test_hungarian_launch_plan_refuses(B, n):
    with pytest.raises(ValueError):
        hungarian.launch_plan(B, n)
