"""Distributed halo exchange over a device mesh (NCCL collectives).

Replacement for the reference's MPI halo communication
(/root/reference/src/Distributed/halo_communication.jl:68-86,143-183 —
tagged ``MPI.Isend``/``MPI.Irecv!`` per side + waitall). Here each cut
axis becomes one pair of ``lax.ppermute`` neighbor shifts inside a
``shard_map``; XLA hands the permutes to NCCL over NVLink and overlaps
them with independent compute automatically (no tags, requests or
events).

Shards at the ends of a globally-bounded cut axis overwrite the
exchanged (zero) halo with the physical boundary-condition fill, selected
by ``lax.axis_index`` — SPMD-uniform code, no per-rank branches.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def _axslice(ndim, axis, idx):
    sl = [slice(None)] * ndim
    sl[axis] = idx
    return tuple(sl)


def exchange_axis(data, axis, H, mesh_axis, n_shards, periodic):
    """ppermute halo exchange along one array axis inside shard_map.

    Left halo [0:H) ← left neighbor's top interior slab; right halo
    [N+H : N+2H) ← right neighbor's bottom interior slab. On a
    non-periodic global axis the outermost shards' outer halos receive
    zeros (ppermute semantics) — the caller overlays the physical BC fill.
    """
    if n_shards == 1:
        if periodic:
            # single shard on this mesh axis: periodic wrap is a local copy
            N = data.shape[axis] - 2 * H
            S = lambda idx: _axslice(data.ndim, axis, idx)
            data = data.at[S(slice(0, H))].set(data[S(slice(N, N + H))])
            data = data.at[S(slice(N + H, N + 2 * H))].set(data[S(slice(H, 2 * H))])
        return data
    N = data.shape[axis] - 2 * H
    S = lambda idx: _axslice(data.ndim, axis, idx)

    top_slab = data[S(slice(N, N + H))]      # my last H interior layers
    bottom_slab = data[S(slice(H, 2 * H))]   # my first H interior layers

    fwd = [(i, i + 1) for i in range(n_shards - 1)]
    bwd = [(i + 1, i) for i in range(n_shards - 1)]
    if periodic:
        fwd.append((n_shards - 1, 0))
        bwd.append((0, n_shards - 1))

    from_left = lax.ppermute(top_slab, mesh_axis, fwd)      # fills my left halo
    from_right = lax.ppermute(bottom_slab, mesh_axis, bwd)  # fills my right halo

    data = data.at[S(slice(0, H))].set(from_left)
    data = data.at[S(slice(N + H, N + 2 * H))].set(from_right)
    return data


def select_edge(data, filled, axis_name, n_shards, side):
    """Take `filled` on the shard at the global edge (side 0 = first,
    1 = last along `axis_name`), `data` elsewhere."""
    idx = lax.axis_index(axis_name)
    is_edge = (idx == 0) if side == 0 else (idx == n_shards - 1)
    return jnp.where(is_edge, filled, data)
