"""The port's linear-theory wind solver (icar_tpu_torch/ops/linear_winds.py)
against the JAX package's (icar_tpu/ops/linear_winds.py), on the CPU.

The spectrum and wavenumbers are the same numpy computation (bit for bit).
The table build runs torch's FFT (MKL on this CPU, cuFFT on the card)
where the JAX package runs scipy's pocketfft, so the two tables agree to a
few float32 ulps of the table's largest value; the port's chunked build,
its bfloat16 rounding and the disk cache are held bit for bit. The
stability and the lookup read the same inputs; the port's cumulative sums
take XLA's order (ops/pointwise.cumsum), so they differ from the JAX
package's only by the ulps of log, atan2 and XLA's fused multiply-adds,
which the cumulative-sum differences of the box smoothing amplify (bounds
below, each derived where it is used).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icar_tpu.config import LtOptions
from icar_tpu.ops import linear_winds as jlw
from icar_tpu_torch import convert
from icar_tpu_torch.ops import linear_winds as tlw
from icar_tpu_torch.ops import pointwise as pw

torch.set_num_threads(1)

EPS32 = float(np.finfo(np.float32).eps)
NY, NX, DX = 12, 48, 1000.0
DZ = np.array([50.0, 75.0, 125.0, 200.0, 300.0, 400.0] + [500.0] * 4,
              np.float32)


def small_lt(**kw):
    """tests/test_linear_winds.py's small table, with vert_smooth 5."""
    lt = LtOptions(buffer=10, n_dir_values=8, n_spd_values=4,
                   n_nsq_values=3, variable_n=True, vert_smooth=5)
    for k, v in kw.items():
        setattr(lt, k, v)
    return lt


def ridge(ny=NY, nx=NX):
    x = np.arange(nx) * DX
    return ((600.0 * np.exp(-((x - nx * DX / 2) / 5000.0) ** 2))[None, :]
            * np.ones((ny, 1))
            + 40.0 * np.sin(np.arange(ny) / 3.0)[:, None])


@pytest.fixture(scope="module")
def jax_lut():
    lt = small_lt()
    lu, lv, values = jlw.build_lut(ridge(), DX, DZ, lt)
    return lt, np.asarray(lu), np.asarray(lv), values


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.mark.parametrize("ny,nx,buffer", [(12, 48, 10), (9, 31, 4)])
def test_spectrum_and_wavenumbers_bit_equal(ny, nx, buffer):
    terrain = ridge(ny, nx)
    fj, bj = jlw.fourier_terrain(terrain, buffer)
    ft, bt = tlw.fourier_terrain(terrain, buffer)
    assert bj == bt and ft.dtype == np.complex64
    np.testing.assert_array_equal(ft, np.asarray(fj))
    for a, b in zip(tlw.wavenumber_grids(*ft.shape, DX),
                    jlw.wavenumber_grids(*ft.shape, DX)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, np.asarray(b))


def test_lut_build_matches_jax(jax_lut):
    """Each entry is a sum of sum(n_steps) inverse FFTs of the spectrum
    times the analytic solution, float32 throughout: the two libraries'
    FFTs and complex products differ by about an ulp per operation, so the
    tables agree to 1e-6 of their largest value (8 ulps; 2.3e-7 seen).
    Zero-speed entries are exactly 0 in both."""
    lt, lu, lv, values = jax_lut
    tu, tv, tvalues = tlw.build_lut(ridge(), DX, DZ, lt, "cpu")
    assert tu.shape == lu.shape and tv.shape == lv.shape
    for a, b in zip(tvalues, values):
        np.testing.assert_array_equal(a, b)
    for got, want in ((tu.numpy(), lu), (tv.numpy(), lv)):
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    zero = lt.n_dir_values * lt.n_nsq_values
    assert not tu[:zero].any() and not tv[:zero].any()


def test_chunked_and_bf16_builds_bit_equal():
    """Chunks of 7 and 5 entries give the whole build's bits; the bfloat16
    table rounds the same float32 values as the JAX package's astype."""
    lt = small_lt()
    E = lt.n_spd_values * lt.n_dir_values * lt.n_nsq_values
    whole = tlw.build_lut(ridge(), DX, DZ, lt, "cpu")[:2]
    chunked = tlw.place_lut_chunks(
        tlw.build_lut_chunks(ridge(), DX, DZ, lt, "cpu", chunk=7),
        E, len(DZ), NY, NX, "cpu")
    for a, b in zip(chunked, whole):
        assert torch.equal(a, b)
    bf16 = tlw.place_lut_chunks(
        tlw.build_lut_chunks(ridge(), DX, DZ, lt, "cpu", chunk=5),
        E, len(DZ), NY, NX, "cpu", dtype=torch.bfloat16)
    for a, b in zip(bf16, whole):
        want = np.asarray(jnp.asarray(b.numpy()).astype(jnp.bfloat16))
        np.testing.assert_array_equal(a.view(torch.int16).numpy(),
                                      want.view(np.int16))
    # a chosen subset of entries is the whole build's
    sel = np.array([95, 40, 41])
    (e, u_c, v_c), = tlw.build_lut_chunks(ridge(), DX, DZ, lt, "cpu",
                                          entries=sel)
    np.testing.assert_array_equal(e, sel)
    assert torch.equal(u_c, whole[0][sel]) and torch.equal(v_c, whole[1][sel])


def test_cache_round_trips(jax_lut, tmp_path):
    """A table the JAX package caches reads back in the port bit for bit,
    and one the port caches (while placing its build) reads back in the
    JAX package; either returns None for a changed parameter."""
    lt, lu, lv, _ = jax_lut
    E = lu.shape[0]
    jpath = str(tmp_path / "jax_lut.npz")
    jlw.save_lut(jpath, lu, lv, DZ, lt)
    got = tlw.place_lut_chunks(tlw.load_lut_chunks(jpath, DZ, lt, chunk=5),
                               E, len(DZ), NY, NX, "cpu")
    np.testing.assert_array_equal(got[0].numpy(), lu)
    np.testing.assert_array_equal(got[1].numpy(), lv)

    tpath = str(tmp_path / "port_lut.npz")
    writer = tlw.open_lut_writer(tpath, E, len(DZ), NY, NX, DZ, lt)
    built = tlw.place_lut_chunks(
        tlw.build_lut_chunks(ridge(), DX, DZ, lt, "cpu", chunk=11),
        E, len(DZ), NY, NX, "cpu", writer=writer)
    writer[0].flush()
    writer[1].flush()
    back = jlw.load_lut(tpath, DZ, lt)
    np.testing.assert_array_equal(np.asarray(back[0]), built[0].numpy())
    np.testing.assert_array_equal(np.asarray(back[1]), built[1].numpy())

    other = small_lt(n_dir_values=9)
    assert tlw.load_lut_chunks(jpath, DZ, other) is None
    assert jlw.load_lut(tpath, DZ, other) is None
    assert tlw.load_lut_chunks(jpath, DZ[:-1], lt) is None


def _atmosphere(seed, nz=10, ny=NY, nx=NX):
    r = np.random.default_rng(seed)
    theta = (290 + np.cumsum(r.uniform(0.2, 5, (nz, ny, nx)), 0)
             ).astype(np.float32)
    exner = np.broadcast_to(1 - 0.012 * np.arange(nz)[:, None, None],
                            theta.shape).astype(np.float32)
    z = (np.cumsum(DZ)[:nz, None, None] - DZ[0] / 2
         + r.uniform(0, 300, (1, ny, nx))).astype(np.float32)
    qv = r.uniform(1e-3, 1.2e-2, (nz, ny, nx)).astype(np.float32)
    hyd = np.where(r.uniform(size=(nz, ny, nx)) < 0.3,
                   r.uniform(0, 1e-3, (nz, ny, nx)), 0).astype(np.float32)
    return theta, exner, z, qv, hyd


def _one_ulp(a, seed):
    """``a`` with each value moved by one ulp, up or down at random."""
    sign = np.random.default_rng(seed).choice([-1.0, 1.0], a.shape)
    return np.nextafter(a, (sign * np.inf).astype(a.dtype))


@pytest.mark.parametrize("jitted", [False, True])
@pytest.mark.parametrize("variable_n,smooth", [(True, True), (False, True),
                                               (True, False)])
def test_compute_nsquared_matches_jax(jitted, variable_n, smooth):
    """log N^2 against the JAX package's, run op by op
    (``jax.disable_jit``) and jitted (its wind update's form, with the
    divisions by constants folded). N^2 is a difference of logs of theta
    and of temperatures over a window, so an ulp of log becomes a
    relative error of N^2 as large as the window's cancellation makes
    it: the bound is what the JAX package itself moves when theta and the
    Exner function move by an ulp at random, plus 8 ulps of |log N^2| <=
    16.2 (log's own rounding)."""
    args = (5, variable_n, 3e-5, 1e-7, 6e-4, smooth, 10)
    fields = _atmosphere(3)
    moved = (_one_ulp(fields[0], 1), _one_ulp(fields[1], 2)) + fields[2:]

    def f(*a):
        return jlw.compute_nsquared(*a, *args)
    with jax.disable_jit():
        spread = np.abs(np.asarray(f(*moved)) - np.asarray(f(*fields)))
    if jitted:
        want = np.asarray(jax.jit(f)(*fields))
    else:
        with jax.disable_jit():
            want = np.asarray(f(*fields))
    got = tlw.compute_nsquared(*(_t(a) for a in fields), *args).numpy()
    assert np.abs(got - want).max() <= spread.max() + 8 * EPS32 * 16.2


def test_box_smooth_and_window_sums_match_jax():
    """The cumulative sums take XLA's order, so the box smoothing of the
    same input equals the jitted JAX one bit for bit (rows of 540 cells,
    as at 500x500 with the default window)."""
    r = np.random.default_rng(4)
    a = (r.standard_normal((3, 20, 520)) - 9).astype(np.float32)
    want = np.asarray(jax.jit(lambda x: jlw._box_smooth_2d(x, 10))(a))
    np.testing.assert_array_equal(tlw._box_smooth_2d(_t(a), 10).numpy(),
                                  want)
    np.testing.assert_array_equal(pw.cumsum(_t(a), 2).numpy(),
                                  np.asarray(jnp.cumsum(a, axis=2)))


def test_position_and_weight_edges():
    """Positions and weights equal the JAX package's at the table's edges:
    below the first value (the weight 1 on entry 0), at each value, past
    the last (weight 1 on the last entry), and at direction 2pi (inside
    the table: no wrap)."""
    lt = small_lt()
    spd, dirv, nsq = jlw.table_values(lt)
    for values in (spd, dirv, nsq):
        x = np.concatenate([
            values, values - 1e-3, values + 1e-3, [values[0] - 5.0,
                                                   values[-1] + 5.0],
            np.linspace(values[0], values[-1], 37)]).astype(np.float32)
        pj = jlw._position(jnp.asarray(values), x)
        wj, nj = jlw._weight(jnp.asarray(values), pj, x)
        pt = tlw._position(_t(values), _t(x))
        wt, nt = tlw._weight(_t(values), pt, _t(x))
        np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
        np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
        np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
        # at the edges both corners are one entry, carrying weight 1
        (lo, wlo), (hi, whi) = tlw.corners(_t(values), _t(x))
        edge = lo == hi
        assert edge.any()
        assert (wlo[edge] == 1).all() and (whi[edge] == 0).all()


def _cells(lt, seed, shape=(10, NY, NX + 1)):
    """Per-cell (speed, direction, log N^2) spanning the table with its
    edges: zero speed, speeds past the last value, directions 0 and 2pi,
    N^2 below the first and past the last value, and exact table values."""
    r = np.random.default_rng(seed)
    spd, dirv, nsq = jlw.table_values(lt)
    s = r.uniform(-1, spd[-1] + 5, shape[1:]).clip(0, None)
    d = r.uniform(0, 2 * np.pi, shape[1:])
    n = r.uniform(nsq[0] - 2, nsq[-1] + 2, shape)
    s[0, :6] = np.concatenate([spd[:3], [0.0, spd[-1], spd[-1] + 3]])
    d[1, :5] = [0.0, 2 * np.pi, dirv[1], dirv[-1], dirv[-2]]
    n[:, 2, :3] = [nsq[0], nsq[-1], nsq[1]]
    return tuple(a.astype(np.float32) for a in (s, d, n))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("occupancy", [False, True])
def test_interp_matches_the_stream(jax_lut, dtype, occupancy):
    """The 8-entry gather equals the JAX package's one-hot stream over the
    same table (carried across by convert.py) to 4 ulps of the table's
    largest value (the stream's jitted sum contracts products into fused
    multiply-adds), with and without its occupancy gate, on f32 and bf16
    tables."""
    lt, lu, lv, (spd, dirv, nsq) = jax_lut
    n_dir, n_nsq = lt.n_dir_values, lt.n_nsq_values
    table = jnp.asarray(lu).astype(getattr(jnp, dtype))
    (lut_t, _), _, _ = convert.linear_winds_from_numpy(
        np.asarray(table), lv, lu[0], lv[0], "cpu",
        getattr(torch, dtype))
    s, d, n = _cells(lt, 7, (10, NY, NX + 1))
    pos = []
    for values, x in ((spd, s), (dirv, d), (nsq, n)):
        p = jlw._position(jnp.asarray(values), x)
        w, nxt = jlw._weight(jnp.asarray(values), p, x)
        pos.append((p, nxt, w))
    (sp, sn, sw), (dp, dn, dw), (np_, nn, nw) = pos
    b = lambda a: jnp.broadcast_to(a, n.shape)
    occ = None
    if occupancy:
        E = table.shape[0]
        e = np.arange(E)
        hit = lambda p, q, k: np.isin(k, np.concatenate(
            [np.asarray(p).ravel(), np.asarray(q).ravel()]))
        occ = jnp.asarray(hit(sp, sn, e // (n_dir * n_nsq))
                          & hit(dp, dn, (e // n_nsq) % n_dir)
                          & hit(np_, nn, e % n_nsq))
    want = np.asarray(jax.jit(
        lambda t: jlw._interp_lut(t, b(sp), b(sn), b(dp), b(dn), np_, nn,
                                  b(sw), b(dw), nw, n_dir, n_nsq,
                                  occupancy=occ))(table))
    got = tlw.interp_lut(lut_t, tlw.corners(_t(spd), _t(s)),
                         tlw.corners(_t(dirv), _t(d)),
                         tlw.corners(_t(nsq), _t(n)), n_dir, n_nsq)
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 4 * EPS32 * np.abs(lu).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_spatial_winds_matches_jax(jax_lut, dtype):
    """The whole lookup with the relaxation (fraction 0.7) and the
    contribution (0.8) against the jitted JAX function on the same table
    and N^2: the winds within 8 ulps of the largest wind (the background
    column means, atan2 and the stream's fused multiply-adds each round
    differently by an ulp)."""
    lt, lu, lv, (spd, dirv, nsq) = jax_lut
    r = np.random.default_rng(11)
    nz = len(DZ)
    u3 = (10 + 3 * r.standard_normal((nz, NY, NX + 1))).astype(np.float32)
    v3 = (3 * r.standard_normal((nz, NY + 1, NX))).astype(np.float32)
    pu = r.standard_normal(u3.shape).astype(np.float32)
    pv = r.standard_normal(v3.shape).astype(np.float32)
    nsq_log = r.uniform(nsq[0] - 1, nsq[-1] + 1, (nz, NY, NX)
                        ).astype(np.float32)
    tables = [np.asarray(jnp.asarray(a).astype(getattr(jnp, dtype)))
              for a in (lu, lv)]
    want = jax.jit(lambda *a: jlw.apply_spatial_winds(
        *a, spd, dirv, nsq, lt.vert_smooth, 0.7, 0.8))(
        u3, v3, nsq_log, pu, pv, *tables)
    (tu, tv), tpu, tpv = convert.linear_winds_from_numpy(
        *tables, pu, pv, "cpu", getattr(torch, dtype))
    got = tlw.apply_spatial_winds(_t(u3), _t(v3), _t(nsq_log), tpu, tpv,
                                  tu, tv, _t(spd), _t(dirv), _t(nsq),
                                  lt.vert_smooth, 0.7, 0.8)
    bound = 8 * EPS32 * np.abs(u3).max()
    for g, w in zip(got, want):
        assert np.abs(g.numpy() - np.asarray(w)).max() <= bound
