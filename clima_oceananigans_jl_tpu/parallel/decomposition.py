"""Domain decomposition: global grid → per-shard local grids.

Array re-design of the reference's distributed grid construction
(/root/reference/src/Distributed/distributed_grids.jl + multi_architectures.jl:
local grid + Communication BCs injected on partitioned sides). Here a
global grid is sliced into identical local grids whose cut axes are
``FULLY_CONNECTED`` and carry ``dist = (mesh_axis, n_shards,
global_topology)``; the halo-fill layer turns that into ``ppermute``
neighbor exchanges inside ``shard_map``. All per-shard leaf arrays
(coordinates, metrics) are assembled into "stacked" arrays partitioned by
the shard_map in_specs, so each device receives its own geometry — shards
differ only in data, never in pytree structure (SPMD-uniform).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from ..grids.rectilinear import RectilinearGrid, _Axis
from ..grids.topology import FLAT, FULLY_CONNECTED, PERIODIC
from ..grids.latlon import LatitudeLongitudeGrid

MESH_AXES = ("x", "y")


def _slice_axis(ax, i, n_loc, mesh_axis, n_shards):
    """Local _Axis for shard i along a cut axis (arrays sliced w/ halos)."""
    sl = slice(i * n_loc, i * n_loc + n_loc + 2 * ax.h)
    topo = FULLY_CONNECTED if n_shards > 1 else ax.topo
    extent = ax.extent / n_shards  # identical float on every shard
    return _Axis(n_loc, ax.h, topo, ax.cf[sl], ax.cc[sl], ax.dc[sl], ax.df[sl],
                 ax.regular, extent)


def partition_grid(grid, mesh_shape):
    """(stacked_grid, grid_specs, local_template) for an (Rx, Ry) mesh.

    `stacked_grid` carries per-shard leaf arrays assembled so that
    shard_map in_specs = `grid_specs` deliver each device its local grid.
    ImmersedGrids partition their parent and slice the per-shard solid
    masks / partial-cell metrics (the reference's distributed immersed
    grids carry per-rank bathymetry the same way).
    """
    from ..immersed.immersed import ImmersedGrid
    imm = grid if isinstance(grid, ImmersedGrid) else None
    grid_p = grid.parent if imm is not None else grid

    Rx, Ry = mesh_shape
    if grid_p.Nx % max(Rx, 1) or grid_p.Ny % max(Ry, 1):
        raise ValueError(f"grid {grid_p.shape} not divisible by mesh {mesh_shape}")
    nxl, nyl = grid_p.Nx // Rx, grid_p.Ny // Ry
    dist = (("x", Rx, grid_p.topology[0]) if Rx > 1 else None,
            ("y", Ry, grid_p.topology[1]) if Ry > 1 else None,
            None)

    def local(i, j):
        new = object.__new__(type(grid_p))
        new.dtype = grid_p.dtype
        new.dist = dist
        new._axes = (
            _slice_axis(grid_p._axes[0], i, nxl, "x", Rx),
            _slice_axis(grid_p._axes[1], j, nyl, "y", Ry),
            grid_p._axes[2],
        )
        new._init_static()
        if isinstance(grid_p, LatitudeLongitudeGrid):
            new.radius = grid_p.radius
            sx = slice(i * nxl, i * nxl + nxl + 2 * grid_p.Hx)
            sy = slice(j * nyl, j * nyl + nyl + 2 * grid_p.Hy)
            pick = lambda m: {k: (v[sx if v.shape[0] > 1 else slice(None),
                                    sy if v.shape[1] > 1 else slice(None)])
                              for k, v in m.items()}
            new._dx_m = pick(grid_p._dx_m)
            new._az_m = pick(grid_p._az_m)
            new._dy_m = {k: v[:, sy] for k, v in grid_p._dy_m.items()}
        if imm is not None:
            sx = slice(i * nxl, i * nxl + nxl + 2 * grid_p.Hx)
            sy = slice(j * nyl, j * nyl + nyl + 2 * grid_p.Hy)
            bl, btd = jax.tree_util.tree_flatten(imm.boundary)
            b_loc = jax.tree_util.tree_unflatten(
                btd, [l[sx, sy, :] for l in bl])
            return ImmersedGrid.wrap(new, b_loc)
        return new

    template = local(0, 0)
    _, treedef = jax.tree_util.tree_flatten(template)
    all_leaves = [[jax.tree_util.tree_flatten(local(i, j))[0] for j in range(Ry)]
                  for i in range(Rx)]

    n_leaves = len(all_leaves[0][0])
    stacked, specs = [], []
    for li in range(n_leaves):
        l00 = all_leaves[0][0][li]
        varies_x = Rx > 1 and not np.array_equal(np.asarray(l00),
                                                 np.asarray(all_leaves[1][0][li]))
        varies_y = Ry > 1 and not np.array_equal(np.asarray(l00),
                                                 np.asarray(all_leaves[0][1][li]))
        if l00.ndim == 1:
            if varies_x:
                stacked.append(jnp.concatenate([all_leaves[i][0][li] for i in range(Rx)]))
                specs.append(P("x"))
            elif varies_y:
                stacked.append(jnp.concatenate([all_leaves[0][j][li] for j in range(Ry)]))
                specs.append(P("y"))
            else:
                stacked.append(l00)
                specs.append(P())
        else:  # (nx, ny, 1)-style metric blocks
            if varies_x or l00.shape[0] > 1:
                rows = [jnp.concatenate([all_leaves[i][j][li] for j in range(Ry)], axis=1)
                        if (varies_y or l00.shape[1] > 1) else all_leaves[i][0][li]
                        for i in range(Rx)]
                stacked.append(jnp.concatenate(rows, axis=0))
                specs.append(P("x", "y" if (varies_y or l00.shape[1] > 1) else None))
            elif varies_y or l00.shape[1] > 1:
                stacked.append(jnp.concatenate([all_leaves[0][j][li] for j in range(Ry)], axis=1))
                specs.append(P(None, "y"))
            else:
                stacked.append(l00)
                specs.append(P())

    stacked_grid = jax.tree_util.tree_unflatten(treedef, stacked)
    grid_specs = jax.tree_util.tree_unflatten(treedef, specs)
    return stacked_grid, grid_specs, template


def scatter_array(arr, grid, mesh_shape):
    """Global with-halo array → stacked per-shard with-halo blocks."""
    Rx, Ry = mesh_shape
    nxl, nyl = grid.Nx // Rx, grid.Ny // Ry
    Hx, Hy = grid.Hx, grid.Hy
    if arr.ndim < 2:
        return arr
    rows = []
    for i in range(Rx):
        sx = slice(i * nxl, i * nxl + nxl + 2 * Hx) if arr.shape[0] > 1 else slice(None)
        cols = []
        for j in range(Ry):
            sy = slice(j * nyl, j * nyl + nyl + 2 * Hy) if arr.shape[1] > 1 else slice(None)
            cols.append(arr[sx, sy])
        rows.append(jnp.concatenate(cols, axis=1) if arr.shape[1] > 1 else cols[0])
    return jnp.concatenate(rows, axis=0) if arr.shape[0] > 1 else rows[0]


def gather_array(stacked, grid, mesh_shape):
    """Stacked per-shard blocks → global with-halo array (interiors + edge halos)."""
    Rx, Ry = mesh_shape
    nxl, nyl = grid.Nx // Rx, grid.Ny // Ry
    Hx, Hy = grid.Hx, grid.Hy
    if stacked.ndim < 2:
        return stacked
    lx, ly = nxl + 2 * Hx, nyl + 2 * Hy
    x_blocked = stacked.shape[0] > 1
    y_blocked = stacked.shape[1] > 1
    rows = []
    for i in range(Rx if x_blocked else 1):
        cols = []
        for j in range(Ry if y_blocked else 1):
            blk = stacked[_sl(i, lx, x_blocked), _sl(j, ly, y_blocked)]
            # keep interior, plus halos only at global edges
            x0 = 0 if (i == 0 or not x_blocked) else Hx
            x1 = blk.shape[0] if (i == (Rx - 1) or not x_blocked) else blk.shape[0] - Hx
            y0 = 0 if (j == 0 or not y_blocked) else Hy
            y1 = blk.shape[1] if (j == (Ry - 1) or not y_blocked) else blk.shape[1] - Hy
            cols.append(blk[x0:x1, y0:y1])
        rows.append(jnp.concatenate(cols, axis=1) if y_blocked else cols[0])
    return jnp.concatenate(rows, axis=0) if x_blocked else rows[0]


def _sl(i, l, blocked):
    return slice(i * l, (i + 1) * l) if blocked else slice(None)
