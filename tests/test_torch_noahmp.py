"""The port's Noah-MP (icar_tpu_torch/physics/noahmp.py and
noahmp_params.resolve_params) against the JAX package's.

The grid mixes bare soil, vegetation, urban and glacier cells (the main
column runs on glacier cells too; the surface stage overrides them), snow
free, one-layer and three-layer packs, frozen and thawing soil, rain and
snow, night (cosz 0) and day, and both hemispheres. Soil type 1 is left
out: the JAX package gathers Noah-MP's soil parameters one category low
(ROADMAP section 3), so soil 1 reads the unused row 0 and turns NaN on
both sides.

Per function: one JAX ``noahmp_driver`` call on that grid records the
arguments of every routine it reaches (the first two calls of each, so
the Monin-Obukhov updates run both their first and a later iteration);
each routine then runs on those arguments in the JAX package op by op
(``jax.disable_jit()``) and in the port, and every output is held to
``TOL`` of its field's largest magnitude (per function, about ten times
the largest difference observed: exp, log and pow round apart between
the libraries by an ulp, and the port divides by a constant as a product
with its float32 reciprocal); integer and boolean outputs are equal.

Chained steps run the JAX driver eagerly: each primitive alone, as
under ``disable_jit`` but with its compiled operations cached, which a
many-step run needs. The JAX package's own scenarios are
tests/test_torch_noahmp_scenarios.py.
"""

import inspect
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icar_tpu.physics import noahmp as J
from icar_tpu.physics.noah_params import load_tables as jax_noah_tables
from icar_tpu.physics.noahmp_params import load_mp_tables as jax_mp_tables
from icar_tpu.physics.noahmp_params import resolve_params as jax_resolve
from icar_tpu_torch.convert import noahmp_state_from_numpy, params_from_numpy
from icar_tpu_torch.physics import noahmp as T
from icar_tpu_torch.physics.noah_params import load_tables
from icar_tpu_torch.physics.noahmp_params import (load_mp_tables,
                                                  resolve_params)

torch.set_num_threads(1)

NY, NX = 4, 6
# bare (16), urban (13), glacier (15) and vegetated classes
VEG = [2, 5, 7, 10, 12, 13, 14, 15, 16]
SOIL = [3, 4, 6, 8, 12]
ORDER = ("lat yearlen julian cosz dt shdfac vegtype sfctmp sfcprs psfc uu "
         "vv q2 soldn lwdn prcp_mm tbot zlvl").split()


def mixed_case(seed=0):
    """Seeded driver inputs and initial state (numpy) on the mixed grid."""
    r = np.random.default_rng(seed)

    def f(lo, hi):
        return r.uniform(lo, hi, (NY, NX)).astype(np.float32)

    def some(frac):
        return r.uniform(size=(NY, NX)) < frac
    veg = r.choice(VEG, (NY, NX)).astype(np.int32)
    veg[0, :3] = (15, 16, 13)
    soil = r.choice(SOIL, (NY, NX)).astype(np.int32)
    cold = some(0.5)
    tsk = np.where(cold, f(255, 271), f(276, 300)).astype(np.float32)
    # snow free, one layer (2.5-5 cm), two and three layers
    depth = r.choice([0.0, 0.0, 0.04, 0.08, 0.3, 0.6], (NY, NX))
    swe = (depth * r.uniform(150, 300, (NY, NX))).astype(np.float32)
    soil_t = np.stack([tsk + d for d in (0.5, 1.5, 3.0, 5.0)]
                      ).astype(np.float32)
    st = J.noahmp_init_state(
        tsk, swe, depth.astype(np.float32), soil_t,
        r.uniform(0.15, 0.4, (4, NY, NX)).astype(np.float32), soil, veg,
        jax_mp_tables(), jax_noah_tables())
    st["canliq"] = np.where(some(0.3), f(0, 0.2), 0).astype(np.float32)
    st["canice"] = np.where(some(0.3), f(0, 0.2), 0).astype(np.float32)
    st["tauss"] = np.where(swe > 0, f(0, 0.5), 0).astype(np.float32)
    st["sneqvo"] = (st["sneqv"] * f(0.8, 1.0)).astype(np.float32)
    sfctmp = np.where(cold, f(255, 272), f(276, 302)).astype(np.float32)
    args = dict(
        lat=np.where(some(0.4), -35.0, 45.0).astype(np.float32),
        yearlen=365.0, julian=100.3,
        cosz=np.where(some(0.35), 0.0, f(0.05, 0.95)).astype(np.float32),
        dt=600.0, shdfac=f(0.0, 1.0), vegtype=veg, sfctmp=sfctmp,
        sfcprs=f(9.0e4, 1.0e5), psfc=f(9.05e4, 1.005e5), uu=f(-6, 6),
        vv=f(-6, 6), q2=f(1e-3, 1.2e-2), soldn=f(0, 850),
        lwdn=f(180, 400),
        prcp_mm=np.where(some(0.5), f(0.0, 4.0), 0).astype(np.float32),
        tbot=f(272, 290), zlvl=f(20, 45))
    return args, st, soil


# JAX routine -> whether its arguments are recorded and replayed
FUNCS = ("atm phenology precip_heat csnow tdfcnd thermoprop snow_age "
         "snowalb_bats groundalb twostream albedo_rad radiation esat _estg "
         "sfcdif1 ragrb stomata vege_flux bare_flux _thomas_stack tsnosoi "
         "phasechange energy canwater _shift_down_nmp _combo_nmp "
         "snowfall_acc compact_snow combine_snow divide_snow snowh2o "
         "snowwater wdfcnd1 srt_sstep soilwater groundwater water sflx "
         "_gather_m _scatter_m").split()
CALLS = 2   # calls recorded per routine
# the routines called more than once a step, whose second call is
# replayed too
MULTI = ("twostream esat _estg sfcdif1 ragrb stomata _thomas_stack "
         "_shift_down_nmp _combo_nmp combine_snow wdfcnd1 srt_sstep "
         "_gather_m _scatter_m").split()

# largest difference allowed, relative to each output's largest
# magnitude (the observed largest in parentheses)
TOL = dict(default=2e-6,           # (1.8e-7)
           vege_flux=3e-5,         # (3.3e-6: q2v and t2mv, small
           energy=3e-5,            # differences of large numbers)
           groundwater=2e-5,       # (1.5e-6 in each of these)
           water=2e-5, sflx=2e-5, noahmp_driver=2e-5)


def to_port(x, pj, pt):
    """A JAX argument as the port takes it: arrays as tensors, the
    resolved parameters as the port's, containers recursively."""
    if x is pj:
        return pt
    if isinstance(x, (jax.Array, np.ndarray)):
        return torch.as_tensor(np.array(x))
    if isinstance(x, dict):
        return {k: to_port(v, pj, pt) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(to_port(v, pj, pt) for v in x)
    return x


def port_args(fn, args, kwargs, pj, pt):
    """``args``/``kwargs`` of a JAX call converted for the port's ``fn``;
    ``dt`` as a 0-d float32 tensor, as the port's step passes it."""
    names = list(inspect.signature(fn).parameters)
    out = [to_port(a, pj, pt) for a in args]
    for i, (name, a) in enumerate(zip(names, out)):
        if name == "dt" and not torch.is_tensor(a):
            out[i] = torch.tensor(float(a), dtype=torch.float32)
    return out, {k: to_port(v, pj, pt) for k, v in kwargs.items()}


def leaves(x, path=""):
    """(path, array-like) pairs of a nested output."""
    if isinstance(x, SimpleNamespace):
        x = vars(x)
    if isinstance(x, dict):
        for k in sorted(x):
            yield from leaves(x[k], f"{path}.{k}")
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            yield from leaves(v, f"{path}[{i}]")
    else:
        yield path, x


def rel_err(want, got):
    """Largest difference relative to ``want``'s largest magnitude, NaNs
    required at the same places (float arrays)."""
    w = np.asarray(want, np.float64)
    g = np.asarray(got, np.float64)
    assert w.shape == g.shape
    nw, ng = np.isnan(w), np.isnan(g)
    assert (nw == ng).all(), "NaN at other cells"
    m = ~nw
    if not m.any():
        return 0.0
    d = np.abs(w[m] - g[m]).max()
    return d / max(np.abs(w[m]).max(), 1e-30) if d else 0.0


def assert_match(want, got, tol):
    """Every leaf of ``got`` (the port's) against ``want`` (JAX's)."""
    w_leaves = dict(leaves(want))
    g_leaves = dict(leaves(got))
    assert sorted(w_leaves) == sorted(g_leaves)
    for k, w in w_leaves.items():
        g = g_leaves[k]
        if torch.is_tensor(g):
            assert g.dtype in (torch.float32, torch.int32, torch.bool), k
            g = g.numpy()
        w = np.asarray(w)
        if w.dtype.kind in "biu":
            np.testing.assert_array_equal(np.asarray(g), w, err_msg=k)
        else:
            assert np.asarray(g).dtype == np.float32 or np.ndim(w) == 0, k
            assert rel_err(w, g) <= tol, (k, rel_err(w, g))


@pytest.fixture(scope="module")
def recorded():
    """The mixed grid, both packages' parameters, and the arguments of
    the first CALLS calls of every routine in FUNCS within one JAX driver
    call."""
    args, st, soil = mixed_case()
    veg = args["vegtype"]
    pj = jax_resolve(jax_mp_tables(), jax_noah_tables(), jnp.asarray(veg),
                     jnp.asarray(soil))
    pt = resolve_params(load_mp_tables(), load_tables(),
                        torch.as_tensor(veg), torch.as_tensor(soil))
    calls = {name: [] for name in FUNCS}
    orig = {name: getattr(J, name) for name in FUNCS}

    def recorder(name):
        def wrap(*a, **kw):
            if len(calls[name]) < CALLS:
                calls[name].append((a, kw))
            return orig[name](*a, **kw)
        return wrap
    for name in FUNCS:
        setattr(J, name, recorder(name))
    try:
        out = J.noahmp_driver(pj, *[jnp.asarray(args[k]) if isinstance(
            args[k], np.ndarray) else args[k] for k in ORDER],
            {k: jnp.asarray(v) for k, v in st.items()})
    finally:
        for name in FUNCS:
            setattr(J, name, orig[name])
    return SimpleNamespace(args=args, st=st, soil=soil, pj=pj, pt=pt,
                           calls=calls, jax_out=out)


def test_resolve_params_matches(recorded):
    """Every per-cell parameter equal (gathers of the same float32
    tables), on the caller's device, with the JAX package's dtypes; and
    the JAX namespace carried across by ``convert.params_from_numpy``
    the same."""
    pj, pt = vars(recorded.pj), vars(recorded.pt)
    assert sorted(pj) == sorted(pt)
    carried = vars(params_from_numpy(recorded.pj, "cpu"))
    for k, v in pt.items():
        if torch.is_tensor(v):
            assert carried[k].dtype == v.dtype, k
            assert torch.equal(carried[k], v), k
    for k, v in pj.items():
        g = pt[k]
        if torch.is_tensor(g):
            w = np.asarray(v)
            assert g.shape == w.shape, k
            assert str(g.dtype).split(".")[1] == str(w.dtype), k
            np.testing.assert_array_equal(g.numpy(), w, err_msg=k)
        elif isinstance(v, np.ndarray):
            np.testing.assert_array_equal(g, v, err_msg=k)
        else:
            assert g == v, k
    assert pt["nroot"].dtype == torch.int32
    assert pt["laim"].shape == (12, NY, NX)


@pytest.mark.parametrize("name,idx", [(n, 0) for n in FUNCS]
                         + [(n, 1) for n in MULTI])
def test_routine_matches(recorded, name, idx):
    """Each routine on the arguments it got within the driver call, the
    JAX package's run op by op."""
    calls = recorded.calls[name]
    a, kw = calls[idx]
    with jax.disable_jit():
        want = getattr(J, name)(*a, **kw)
    fn = getattr(T, name)
    ta, tkw = port_args(fn, a, kw, recorded.pj, recorded.pt)
    got = fn(*ta, **tkw)
    assert_match(want, got, TOL.get(name, TOL["default"]))


# bound over the mixed grid's chained steps (observed 2.3e-5)
SCENARIO_TOL = 2e-4


def _state_np(st):
    return {k: np.asarray(v) for k, v in st.items()}


def _run_driver(lib, p, args, st):
    if lib is J:
        out, new = J.noahmp_driver(p, *[jnp.asarray(args[k]) if isinstance(
            args[k], np.ndarray) else args[k] for k in ORDER],
            {k: jnp.asarray(v) for k, v in st.items()})
        return ({k: np.asarray(v) for k, v in out.items()},
                _state_np(new))
    targs = [torch.as_tensor(args[k]) if isinstance(args[k], np.ndarray)
             else args[k] for k in ORDER]
    targs[ORDER.index("dt")] = torch.tensor(float(args["dt"]))
    out, new = T.noahmp_driver(p, *targs,
                               noahmp_state_from_numpy(st, "cpu"))
    for k, v in list(out.items()) + list(new.items()):
        assert v.dtype == (torch.int32 if k == "isnow"
                           else torch.float32), k
    return ({k: v.numpy() for k, v in out.items()},
            {k: v.numpy() for k, v in new.items()})


def test_driver_matches_op_by_op(recorded):
    """noahmp_driver whole on the mixed grid against the JAX driver run
    op by op; float32 out (int32 layer counts), the grid's branches
    reached."""
    args, st = recorded.args, recorded.st
    with jax.disable_jit():
        want = _run_driver(J, recorded.pj, args, st)
    got = _run_driver(T, recorded.pt, args, st)
    assert_match(want, got, TOL["noahmp_driver"])
    isnow0 = st["isnow"]
    assert {0, -1, -3} <= set(np.unique(isnow0))
    assert (args["cosz"] == 0).any() and (args["cosz"] > 0).any()
    assert (args["lat"] < 0).any() and (args["lat"] > 0).any()
    assert (st["stc"][3] < 273.15).any() and (st["stc"][3] > 273.16).any()
    assert want[0]["qmelt"].max() > 0


def test_driver_matches_over_chained_steps(recorded):
    """Six 600 s steps, each from the last one's state (the JAX driver
    eager), with snowfall on the cold half: layer counts change both
    ways, and each step holds to SCENARIO_TOL."""
    args = dict(recorded.args)
    args["prcp_mm"] = np.where(args["sfctmp"] < 273.0, 6.0,
                               args["prcp_mm"]).astype(np.float32)
    sj = st = recorded.st
    isnow0 = st["isnow"]
    seen = set()
    for _ in range(6):
        outj, sj = _run_driver(J, recorded.pj, args, sj)
        outt, st = _run_driver(T, recorded.pt, args, st)
        assert_match((outj, sj), (outt, st), SCENARIO_TOL)
        seen |= {int(v) for v in np.unique(sj["isnow"] - isnow0)}
    assert min(seen) < 0 < max(seen), seen
