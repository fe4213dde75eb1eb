"""Shared helpers of the tests that hold rfs_slam_tpu_torch against the JAX
package: conversions between the two states and JAX's random draws.

Arrays cross between the packages as numpy, on the CPU.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import torch

from rfs_slam_tpu.core.state import BirthCandidates, GMState, ParticleState
from rfs_slam_tpu.filters.fastslam import FastSLAMState
from rfs_slam_tpu.filters.rbphd import RBPHDState
from rfs_slam_tpu_torch import convert

CPU = torch.device("cpu")

# The port's CPU path issues many small ops; intra-op threads only add
# contention (tens of times slower per step beside other test workers).
torch.set_num_threads(1)


def t(a, dtype=None):
    """numpy/JAX array -> CPU tensor."""
    return torch.as_tensor(np.array(a), dtype=dtype)


def jax_gm(d):
    return GMState(**{k: jnp.asarray(v) for k, v in d.items()})


def jax_state(d, key):
    """A JAX RBPHDState from :func:`convert.to_numpy` of a port state."""
    p = d["particles"]
    return RBPHDState(
        particles=jax_particles(p, key),
        gm=jax_gm(d["gm"]),
        birth=BirthCandidates(**{k: jnp.asarray(v)
                                 for k, v in d["birth"].items()}),
        last_z=jnp.asarray(d["last_z"]),
        last_unused=jnp.asarray(d["last_unused"]),
        n_in_fov=jnp.asarray(d["n_in_fov"], jnp.int32),
        n_updates=jnp.asarray(d["n_updates"], jnp.int32),
        n_meas=jnp.asarray(d["n_meas"], jnp.int32),
    )


def jax_particles(p, key):
    return ParticleState(pose=jnp.asarray(p["pose"]),
                         log_w=jnp.asarray(p["log_w"]),
                         parent=jnp.asarray(p["parent"], jnp.int32), key=key)


def jax_fastslam_state(d, key):
    """A JAX FastSLAMState from :func:`convert.to_numpy` of a port state."""
    return FastSLAMState(
        particles=jax_particles(d["particles"], key), gm=jax_gm(d["gm"]),
        cand=BirthCandidates(**{k: jnp.asarray(v)
                                for k, v in d["cand"].items()}),
        n_in_fov=jnp.asarray(d["n_in_fov"], jnp.int32),
        n_updates=jnp.asarray(d["n_updates"], jnp.int32),
        n_meas=jnp.asarray(d["n_meas"], jnp.int32))


def fastslam_step_draws(key, n_particles):
    """The motion draws [P, 3] and the resampling offset of one JAX
    FastSLAM predict + update from the particles' ``key``: predict splits
    ``key, k_prop`` (fastslam.py:190-191), each particle ``_, k_add`` of
    ``split(k_prop, P)``; the update's resample splits ``_, k_rs`` of the
    post-predict key (:525 in grow mode, :668 otherwise)."""
    key2, k_prop = jax.random.split(key)
    noise = jax.vmap(lambda k: jax.random.normal(
        jax.random.split(k)[1], (3,), jnp.float32))(
            jax.random.split(k_prop, n_particles))
    return np.asarray(noise), resample_offset(key2)


def port_state(state, rbphd_state_cls):
    """The port's RBPHDState from a JAX state."""
    return convert.from_numpy(rbphd_state_cls, state, CPU)


def step_draws(key, n_particles):
    """The standard-normal motion draws [P, 3] and the resampling offset
    that one JAX predict + update step takes from ``key``: predict splits
    ``key, k_prop, _``, each particle ``_, k_add`` of ``split(k_prop, P)``;
    the resample phase splits ``_, k_rs`` of the post-predict key."""
    key2, k_prop, _ = jax.random.split(key, 3)
    noise = jax.vmap(lambda k: jax.random.normal(
        jax.random.split(k)[1], (3,), jnp.float32))(
            jax.random.split(k_prop, n_particles))
    u0 = jax.random.uniform(jax.random.split(key2)[1], (), jnp.float32)
    return np.asarray(noise), np.asarray(u0)


def predict_input_draws(key, n_particles):
    """``(next key, input draws [P, 2])`` of one JAX predict with input
    noise: predict splits ``key, k_prop, _``, each particle ``k_in, _`` of
    ``split(k_prop, P)``, and the input is sampled with
    ``normal(k_in, (2,))`` (models/motion.py:_maybe_sample_input)."""
    key2, k_prop, _ = jax.random.split(key, 3)
    draws = jax.vmap(lambda k: jax.random.normal(
        jax.random.split(k)[0], (2,), jnp.float32))(
            jax.random.split(k_prop, n_particles))
    return key2, np.asarray(draws)


def fastslam_input_draws(key, n_particles):
    """``(next key, input draws [P, 2])`` of one JAX FastSLAM predict with
    input noise: it splits ``key, k_prop`` (filters/fastslam.py:190-191),
    each particle ``k_in, _`` of ``split(k_prop, P)``, and the input is
    sampled with ``normal(k_in, (2,))``."""
    key2, k_prop = jax.random.split(key)
    draws = jax.vmap(lambda k: jax.random.normal(
        jax.random.split(k)[0], (2,), jnp.float32))(
            jax.random.split(k_prop, n_particles))
    return key2, np.asarray(draws)


def resample_offset(key):
    """The resampling offset the JAX update's resample phase draws from the
    particles' ``key``: ``uniform(split(key)[1])``."""
    return np.asarray(jax.random.uniform(jax.random.split(key)[1], (),
                                         jnp.float32))


def host(obj):
    """A port or JAX state as a nested dict of numpy arrays (JAX's particle
    key dropped)."""
    return {f.name: host(v) if dataclasses.is_dataclass(v := getattr(
        obj, f.name)) else np.asarray(v)
        for f in dataclasses.fields(obj) if f.name != "key"}


def assert_gm_close(port_gm, jax_gm_, rtol=1e-4, atol=1e-5):
    """Alive exact; floats on alive slots within tolerance."""
    a = np.asarray(jax_gm_.alive)
    np.testing.assert_array_equal(port_gm.alive.numpy(), a)
    for name in ("mean", "cov"):
        np.testing.assert_allclose(getattr(port_gm, name).numpy()[:, a],
                                   np.asarray(getattr(jax_gm_, name))[:, a],
                                   rtol=rtol, atol=atol, err_msg=name)
    for name in ("w", "w_prev"):
        np.testing.assert_allclose(getattr(port_gm, name).numpy()[a],
                                   np.asarray(getattr(jax_gm_, name))[a],
                                   rtol=rtol, atol=1e-6, err_msg=name)
