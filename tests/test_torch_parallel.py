"""The port's device mesh and domain decomposition (icar_tpu_torch/parallel/
mesh.py) against the JAX package's (icar_tpu/parallel/mesh.py).

The shards of the two packages must hold the same natural cells: the
port's owned ranges are held to the cells each JAX device holds of a field
sharded over the 8 virtual CPU devices. Scatter and gather are exact for
mass and staggered fields, and the two-phase halo exchange refills every
halo cell, corners included, from the blocks that own it, also where the
halo reaches past a neighbour. CPU devices stand in for cards (a device
may repeat in a mesh).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding, PartitionSpec as P

from icar_tpu.parallel import mesh as jmesh
from icar_tpu_torch.models.icar import ideal_ridge_model
from icar_tpu_torch.parallel.mesh import (Layout, Mesh, make_mesh,
                                          owned_ranges, scatter_geometry)

torch.set_num_threads(1)

MESHES = [(2, 2), (4, 1), (1, 3), (3, 2)]
NY, NX, NZ = 21, 26, 3    # uneven last blocks on every mesh above


def _mesh(my, mx):
    return Mesh(["cpu"] * (my * mx), (my, mx))


def _jax_mesh(my, mx):
    return JaxMesh(np.array(jax.devices()[:my * mx]).reshape(my, mx),
                   ("y", "x"))


@pytest.mark.parametrize("my,mx", MESHES)
def test_owned_cells_match_the_jax_shards(my, mx):
    """Each shard owns the natural cells its JAX device holds of a field
    sharded P('y', 'x') in the padded frame (``padded_sizes``)."""
    jm = _jax_mesh(my, mx)
    nyp, nxp = jmesh.padded_sizes(NX, NY, jm)
    frame = jax.device_put(jnp.zeros((nyp, nxp)),
                           NamedSharding(jm, P("y", "x")))
    jax_owned = {}
    for sh in frame.addressable_shards:
        (r,), (c,) = np.nonzero(jm.devices == sh.device)
        y0, y1, _ = sh.index[0].indices(nyp)
        x0, x1, _ = sh.index[1].indices(nxp)
        jax_owned[(int(r), int(c))] = (y0, min(y1, NY), x0, min(x1, NX))
    layout = Layout(_mesh(my, mx), NY, NX, 2)
    assert {(s.r, s.c): s.own for s in layout.shards} == jax_owned
    assert layout.frame == (nyp, nxp)
    assert owned_ranges(NY, my) == sorted({v[:2] for v in jax_owned.values()})


@pytest.mark.parametrize("n,nx,ny", [(4, 64, 64), (8, 300, 20), (6, 48, 32),
                                     (3, 26, 21), (8, 32, 96)])
def test_make_mesh_factors_like_jax(n, nx, ny):
    got = make_mesh(nx, ny, devices=["cpu"] * n)
    want = jmesh.make_mesh(nx, ny, devices=jax.devices()[:n])
    assert got.shape == want.devices.shape
    assert got.size == n and got.device_type == "cpu"


def test_make_mesh_defaults_to_the_cards():
    if torch.cuda.is_available():
        m = make_mesh(64, 64)
        assert m.size == torch.cuda.device_count()
        assert m.device_type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(64, 64)


def test_mesh_refuses_what_it_cannot_hold():
    with pytest.raises(ValueError, match="do not fill"):
        Mesh(["cpu"] * 3, (2, 2))
    with pytest.raises(ValueError, match="several types"):
        Mesh(["cpu", "meta"], (1, 2))
    with pytest.raises(ValueError, match="negative halo"):
        Layout(_mesh(1, 2), 8, 8, -1)


@pytest.mark.parametrize("n,parts", [(9, 4), (3, 3), (5, 6)])
def test_a_shard_without_cells_is_refused(n, parts):
    """n_l = ceil((n + 1) / parts) leaves the last shard nothing."""
    with pytest.raises(ValueError, match="would own none"):
        owned_ranges(n, parts)
    with pytest.raises(ValueError, match="would own none"):
        Layout(_mesh(1, parts), 8, n, 1)


def _fields(seed):
    r = np.random.default_rng(seed)
    f = lambda *shape: r.standard_normal(shape).astype(np.float32)
    return {"mass": f(NZ, NY, NX), "plane": f(NY, NX),
            "u": f(NZ, NY, NX + 1), "v": f(NZ, NY + 1, NX),
            "stack": f(4, NZ, NY, NX), "corner": f(NY + 1, NX + 1)}


@pytest.mark.parametrize("halo", [0, 1, 3])
@pytest.mark.parametrize("my,mx", MESHES)
def test_scatter_gather_round_trip(my, mx, halo):
    """Blocks are the global field's cells, halo and both end faces of a
    staggered field included; gather rebuilds the field exactly."""
    layout = Layout(_mesh(my, mx), NY, NX, halo)
    for name, a in _fields(1).items():
        blocks = layout.scatter(a)
        for s, b in zip(layout.shards, blocks):
            assert b.is_contiguous()
            np.testing.assert_array_equal(b.numpy(), layout.block_of(a, s),
                                          err_msg=name)
            by0, by1, bx0, bx1 = s.block
            assert b.shape[-2:] == (by1 - by0 + a.shape[-2] - NY,
                                    bx1 - bx0 + a.shape[-1] - NX)
        np.testing.assert_array_equal(layout.gather(blocks).numpy(), a,
                                      err_msg=name)


def _owned_only(layout, blocks):
    """Copies of ``blocks`` with every cell outside the owned range NaN."""
    out = []
    for s, b in zip(layout.shards, blocks):
        c = torch.full_like(b, float("nan"))
        ly, lx = s.owned
        c[..., ly, lx] = b[..., ly, lx]
        out.append(c)
    return out


@pytest.mark.parametrize("halo", [1, 3, 7])
@pytest.mark.parametrize("my,mx", MESHES)
def test_exchange_fills_every_halo_cell(my, mx, halo):
    """After the two-phase exchange every block equals the global field's
    block, corners included; a halo of 7 reaches past neighbours that own
    fewer rows (4x1: 6, 6, 6, 3)."""
    layout = Layout(_mesh(my, mx), NY, NX, halo)
    a = _fields(2)["stack"]
    blocks = _owned_only(layout, layout.scatter(a))
    layout.exchange(blocks)
    for s, b in zip(layout.shards, blocks):
        np.testing.assert_array_equal(b.numpy(), layout.block_of(a, s))


def test_boundary_masks_are_the_global_ring():
    layout = Layout(_mesh(3, 2), NY, NX, 2)
    ring = np.zeros((NY, NX), np.float32)
    ring[[0, -1], :] = 1.0
    ring[:, [0, -1]] = 1.0
    for s, m in zip(layout.shards, layout.boundary_masks()):
        np.testing.assert_array_equal(m.numpy(), layout.block_of(ring, s))


def test_scatter_geometry_slices_every_horizontal_field():
    geom = ideal_ridge_model(nx=NX, ny=NY, nz=10, hill_height=600.0,
                             device="cpu").geom
    layout = Layout(_mesh(2, 2), NY, NX, 3)
    for s, g in zip(layout.shards, scatter_geometry(geom, layout)):
        by0, by1, bx0, bx1 = s.block
        assert (g.ny, g.nx, g.nz) == (by1 - by0, bx1 - bx0, geom.nz)
        assert g.dx == geom.dx
        np.testing.assert_array_equal(g.dz_levels.numpy(), geom.dz_levels)
        for name in ("terrain", "jacobian", "jacobian_u", "jacobian_v",
                     "dzdx", "dzdy", "z_interface", "advection_dz"):
            np.testing.assert_array_equal(
                getattr(g, name).numpy(),
                layout.block_of(getattr(geom, name), s), err_msg=name)


@pytest.mark.parametrize("my,mx", MESHES)
def test_block_place_interior_columns_and_host_max(my, mx):
    """Each shard knows its place in the domain: ``interior`` leaves out
    exactly the domain's edge ring (a block's inner edge is interior),
    ``columns`` are the domain's row-major indices of its cells, ``whole``
    only for a one-shard layout; ``host_max`` is the largest of the
    blocks' counts, which is the domain's."""
    from icar_tpu_torch.parallel.mesh import host_max
    layout = Layout(_mesh(my, mx), NY, NX, 2)
    ring = np.ones((NY, NX), bool)
    ring[1:-1, 1:-1] = False
    ids = np.arange(NY * NX).reshape(NY, NX)
    counts = np.random.default_rng(4).integers(0, 50, (NY, NX))
    for s in layout.shards:
        by0, by1, bx0, bx1 = s.block
        inside = np.zeros((by1 - by0, bx1 - bx0), bool)
        inside[s.interior] = True
        np.testing.assert_array_equal(inside, ~ring[by0:by1, bx0:bx1])
        np.testing.assert_array_equal(s.columns(),
                                      ids[by0:by1, bx0:bx1].reshape(-1))
        assert not s.whole
    blocks = layout.scatter(counts)
    assert host_max([b.max() for b in blocks]) == counts.max()
    assert Layout(_mesh(1, 1), NY, NX, 0).shards[0].whole


@pytest.mark.parametrize("fn", ["sum0", "pow_scalar", "scalar_pow",
                                "pow_field"])
def test_pointwise_blocks_compute_cells_as_the_domain(fn):
    """``ops/pointwise``'s level sum and powers give a cell of a block the
    bits the whole domain's call gives it (torch's own CPU kernels compute
    the elements at the end of a vectorised loop another way, so a cell's
    bits would follow its place in its tensor); the level sum is torch's
    sum to float32 rounding."""
    from icar_tpu_torch.ops import pointwise as pw
    r = np.random.default_rng(7)
    x = torch.tensor(r.uniform(0.01, 3.0, (20, NY, NX)), dtype=torch.float32)
    e = torch.tensor(r.uniform(-1.0, 2.0, (20, NY, NX)), dtype=torch.float32)
    f = {"sum0": pw.sum0, "pow_scalar": lambda a, b: pw.pow(a, 1.7),
         "scalar_pow": lambda a, b: pw.pow(7.7, b),
         "pow_field": pw.pow}[fn]
    f1 = (lambda a, b: f(a)) if fn == "sum0" else f
    whole = f1(x, e)
    for s in Layout(_mesh(2, 2), NY, NX, 1).shards:
        by0, by1, bx0, bx1 = s.block
        blk = f1(x[:, by0:by1, bx0:bx1].contiguous(),
                 e[:, by0:by1, bx0:bx1].contiguous())
        assert torch.equal(blk.view(torch.int32), whole[
            ..., by0:by1, bx0:bx1].contiguous().view(torch.int32))
    if fn == "sum0":
        torch.testing.assert_close(whole, torch.sum(x, 0), rtol=1e-6,
                                   atol=0.0)


@pytest.mark.parametrize("chunk", [64, 4096])
def test_block_mcica_draws_are_the_domains(chunk, monkeypatch):
    """``rrtmg_lw.BlockCdf``: a block's RRTMG chunks (``column_chunked``
    over its own columns) take, column by column, the draws of the whole
    domain's chunks, with the domain's chunking (chunks of 64 columns:
    nine, the last padded; of 4096: one, which the domain draws at its
    own width)."""
    from icar_tpu_torch.physics import rrtmg_lw
    monkeypatch.setattr(rrtmg_lw, "RRTMG_COL_CHUNK", chunk)
    n, cdf = NY * NX, rrtmg_lw.TorchCdf()

    def draws(source, cols):
        def one(c, n_chunks, a):
            d = source("lw", 30.0, c, n_chunks, (3, a.shape[-1], 5), "cpu")
            return {"d": d.permute(0, 2, 1)}
        return rrtmg_lw.column_chunked(one, (torch.zeros(cols),), cols,
                                       chunk)["d"].permute(0, 2, 1)
    whole = draws(cdf, n)
    for s in Layout(_mesh(2, 2), NY, NX, 1).shards:
        cols = s.columns()
        got = draws(rrtmg_lw.BlockCdf(cdf, cols, n), len(cols))
        assert torch.equal(got, whole[:, torch.as_tensor(cols)])
