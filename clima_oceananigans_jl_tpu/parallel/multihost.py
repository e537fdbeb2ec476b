"""Multi-host execution helpers.

Analog of the reference's MPI architecture setup
(/root/reference/src/Distributed/multi_architectures.jl:9-16 builds the
`Distributed` architecture from an MPI communicator; here the runtime is
`jax.distributed` + a device mesh whose axes are laid out so halo
exchange stays on a host's NVLink-joined GPUs and only the outer
decomposition axis crosses the network between hosts).

Pieces:

* ``initialize_distributed()`` — idempotent `jax.distributed.initialize`
  wrapper with environment auto-detection (a coordinator address or a
  Slurm job in the environment; explicit kwargs override).
* ``pod_mesh(mesh_shape)`` — an ``(x, y)`` Mesh for DistributedModel
  whose device order keeps mesh-adjacent shards on one host: within a
  process the devices vary fastest along ``y`` (the most-exchanged
  axis), and distinct processes tile the outer ``x`` axis, so the only
  inter-host hops are the x-axis halo slabs — the reference's
  "long-dimension-outside" decomposition advice (SURVEY §5). On one
  host every GPU pair is joined by NVLink at the same rate, and any
  order is as good as this one.
* ``save_sharded_checkpoint`` / ``load_sharded_checkpoint`` — per-process
  checkpointing of a distributed state: each process writes only its
  addressable shards; restore re-assembles and re-shards.
"""
from __future__ import annotations

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None, **kw):
    """Initialize the multi-host runtime (idempotent).

    With no arguments, relies on `jax.distributed.initialize()`'s own
    cluster auto-detection (coordinator variables, Slurm); explicit
    values win. Safe to call in single-process runs: if no cluster
    environment is detected and no arguments are given, it's a no-op.
    Returns (process_id, num_processes).
    """
    already = getattr(jax.distributed, "is_initialized", None)
    if callable(already) and jax.distributed.is_initialized():
        return jax.process_index(), jax.process_count()
    explicit = coordinator_address is not None
    auto = any(v in os.environ for v in
               ("COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS",
                "SLURM_JOB_ID"))
    if explicit or auto:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id, **kw)
    return jax.process_index(), jax.process_count()


def _device_key(d):
    """Sort key: process-major, then stable within process — mesh rows
    (x) then enumerate process-local devices along y."""
    return (d.process_index, getattr(d, "id", 0))


def pod_mesh(mesh_shape, devices=None):
    """Build the (x, y) Mesh for ``DistributedModel`` with host-aware
    device placement.

    ``mesh_shape = (nx_shards, ny_shards)``. Requirement for a clean
    host split: the per-process device count must be a multiple of
    ``ny_shards`` (each process owns whole y-rings) — then every y-axis
    ppermute stays inside one host (NVLink) and only x-axis neighbors
    cross hosts. Falls back to simple order if the divisibility fails
    (still correct, just more inter-host traffic).
    """
    arr = mesh_device_array(
        devices if devices is not None else jax.devices(), mesh_shape)
    return Mesh(arr, ("x", "y"))


def mesh_device_array(devices, mesh_shape):
    """The (nx, ny) device array behind ``pod_mesh`` (unit-testable with
    stand-in device objects)."""
    devices = sorted(devices, key=_device_key)
    nx, ny = mesh_shape
    n = nx * ny
    if n > len(devices):
        raise ValueError(f"mesh {mesh_shape} needs {n} devices, "
                         f"have {len(devices)}")
    per_proc = {}
    for d in devices:
        per_proc.setdefault(d.process_index, []).append(d)
    if all(len(ds) % ny == 0 for ds in per_proc.values()):
        # lay each process's devices into whole y-rings: process-local
        # device i → (x_row, y) with y fastest, processes stacked along x
        rows = []
        for p in sorted(per_proc):
            rows.extend(np.asarray(per_proc[p], dtype=object).reshape(-1, ny))
        arr = np.asarray(rows[:nx], dtype=object)
        if arr.shape == (nx, ny):
            return arr
    return np.asarray(devices[:n], dtype=object).reshape(nx, ny)


# -- sharded checkpointing ----------------------------------------------------
def save_sharded_checkpoint(path, state, mesh):
    """Write this process's addressable shards of a distributed state.

    Layout: ``{path}/proc{K}.ckpt`` holds a pickled dict
    leaf-path → [(device mesh coords, numpy shard)]. Every process calls
    this (collectively); single-process runs produce one file.
    """
    os.makedirs(path, exist_ok=True)
    leaves, treedef = jax.tree_util.tree_flatten(state)
    shards_out = []
    dev_coords = {d: idx for idx, d in np.ndenumerate(mesh.devices)}
    for leaf in leaves:
        is_sharded = (isinstance(leaf, jax.Array)
                      and leaf.addressable_shards
                      and leaf.addressable_shards[0].data.shape != leaf.shape)
        if is_sharded:
            entry = [(dev_coords[s.device], np.asarray(s.data))
                     for s in leaf.addressable_shards if s.device in dev_coords]
            shards_out.append(("sharded", entry))
        else:
            shards_out.append(("replicated", np.asarray(leaf)))
    fname = os.path.join(path, f"proc{jax.process_index()}.ckpt")
    with open(fname, "wb") as f:
        pickle.dump({"shards": shards_out,
                     "mesh_shape": tuple(mesh.devices.shape),
                     "process": jax.process_index()}, f)
    return fname


def load_sharded_checkpoint(path, state_template, mesh):
    """Re-assemble a sharded checkpoint (all proc files visible on this
    filesystem) and device_put each leaf back onto the mesh with the
    sharding implied by the saved mesh coordinates."""
    files = sorted(f for f in os.listdir(path) if f.endswith(".ckpt"))
    blobs = []
    for f in files:
        with open(os.path.join(path, f), "rb") as fh:
            blobs.append(pickle.load(fh))
    leaves_t, treedef = jax.tree_util.tree_flatten(state_template)
    n_leaves = len(blobs[0]["shards"])
    if n_leaves != len(leaves_t):
        raise ValueError("checkpoint/template structure mismatch")
    out_leaves = []
    mx, my = mesh.devices.shape
    for i, tmpl in enumerate(leaves_t):
        kind = blobs[0]["shards"][i][0]
        if kind == "replicated":
            val = blobs[0]["shards"][i][1]
            out_leaves.append(jax.device_put(
                jnp.asarray(val), NamedSharding(mesh, P())))
            continue
        pieces = {}
        for b in blobs:
            for coords, arr in b["shards"][i][1]:
                pieces[tuple(coords)] = arr
        rows = [np.concatenate([pieces[(ix, iy)] for iy in range(my)], axis=1)
                for ix in range(mx)]
        full = np.concatenate(rows, axis=0)
        spec = P("x", "y") if full.ndim >= 2 else P()
        out_leaves.append(jax.device_put(jnp.asarray(full, dtype=tmpl.dtype)
                                         if hasattr(tmpl, "dtype")
                                         else jnp.asarray(full),
                                         NamedSharding(mesh, spec)))
    return jax.tree_util.tree_unflatten(treedef, out_leaves)
