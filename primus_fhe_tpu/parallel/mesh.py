"""Device mesh construction and sharding specs.

The reference is single-process SIMD-only (SURVEY.md §2, parallelism
inventory); this package introduces the distribution layer it lacks.  The
two scaling axes (SURVEY.md §5) are:

- ``residue``: RNS moduli / CRT primes — embarrassingly parallel through
  NTTs and pointwise ops; one collective at CRT recombine / base
  conversion (a ``psum`` over the residue axis).
- ``batch``: independent ciphertexts (batched bootstrapping) — fully
  parallel, ride-along data parallelism.

Coefficient-axis sharding of a *single* NTT (:mod:`.coeff_sharded`)
serves very large N; at FHE sizes (N <= 2^16) a single device holds the
whole polynomial and residue x batch sharding carries the parallelism.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    n_devices: int | None = None,
    residue: int = 1,
    batch: int | None = None,
    devices=None,
) -> Mesh:
    """Builds a ``(residue, batch)`` mesh over the available devices."""
    if devices is None:
        devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    devices = np.array(devices[:n_devices])
    if batch is None:
        batch = n_devices // residue
    if residue * batch != n_devices:
        raise ValueError(f"residue*batch != n_devices ({residue}*{batch} != {n_devices})")
    return Mesh(devices.reshape(residue, batch), axis_names=("residue", "batch"))


def residue_sharding(mesh: Mesh, ndim: int) -> NamedSharding:
    """Leading axis over ``residue``, rest replicated."""
    return NamedSharding(mesh, P("residue", *([None] * (ndim - 1))))


def batch_sharding(mesh: Mesh, ndim: int, axis: int = 0) -> NamedSharding:
    spec = [None] * ndim
    spec[axis] = "batch"
    return NamedSharding(mesh, P(*spec))


def residue_batch_sharding(mesh: Mesh, ndim: int, batch_axis: int = 1) -> NamedSharding:
    """Axis 0 over ``residue``, ``batch_axis`` over ``batch``."""
    spec = [None] * ndim
    spec[0] = "residue"
    spec[batch_axis] = "batch"
    return NamedSharding(mesh, P(*spec))


def replicate(mesh: Mesh, ndim: int) -> NamedSharding:
    return NamedSharding(mesh, P(*([None] * ndim)))
