"""PyTorch port (mythos_tpu_torch): the MARTINI bilayer NPT path against JAX.

The 104-bead bilayer ``lattice_bilayer(3, 3, water_layers=1)``, jittered
by 0.03 nm off its lattice (exact half-box separations sit on the minimum
image's rounding edge), goes through the JAX package (under ``jax.jit``,
never Pallas interpret mode) and through the port's plain versions on the
CPU, both in float64:

(a) per-term energies (Bond, Angle G96 and harmonic, LJ), rtol 1e-10;
(b) the LJ pair energy and its position gradient against JAX's
    ``lj_energy_forces_reference``, rtol 1e-10, and its box gradient
    against ``jax.grad`` of ``m2.LJ`` in the box (the JAX K6's VJP has
    none);
(c) ``pressure_diag``, rtol 1e-8;
(d) 50 NPT steps of ``MartiniSimulator`` fed JAX's replayed momenta and
    normals: saved centers and boxes, rtol 1e-6;
(e) ``AreaPerLipid`` and ``MembraneThickness`` on that trajectory, and
    ``LJ.map`` over its states;
(f) couplings, merge and ``opt_params`` carried across by
    ``params_from_numpy``;
(g) (the table gradients and the double backward of ``LJPairEnergy``:
    tests/test_torch_martini_direct.py);
(h) the spatial cells K6 visits (``cell_list_plain``, the kernel's plain
    version) cover every masked pair inside the cutoff, on axes of 2 and 1
    cells too, and in a box too wide for floor(box / LJ_CELL) cells a side
    (coarser cells);
(i) the forward's candidates (``cell_candidates``, j > i, mask bit set)
    hold each pair in reach exactly once, and their energy is the plain
    version's and JAX's ``lj_energy_forces_reference``'s.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mythos_tpu.energy.martini import m2 as jm2  # noqa: E402
from mythos_tpu.energy.martini import m3 as jm3  # noqa: E402
from mythos_tpu.energy.martini.systems import default_bilayer_terms as j_terms  # noqa: E402
from mythos_tpu.energy.martini.systems import lattice_bilayer as j_bilayer  # noqa: E402
from mythos_tpu.observables.membranes import AreaPerLipid as JAreaPerLipid  # noqa: E402
from mythos_tpu.observables.membranes import MembraneThickness as JMembraneThickness  # noqa: E402
from mythos_tpu.ops.lj import lj_energy_forces_reference  # noqa: E402
from mythos_tpu.simulators import MartiniSimulator as JMartiniSimulator  # noqa: E402
from mythos_tpu.simulators import pressure_diag as j_pressure_diag  # noqa: E402
from mythos_tpu.simulators.io import SimulatorTrajectory as JTrajectory  # noqa: E402
from mythos_tpu_torch.energy.base import params_from_numpy  # noqa: E402
from mythos_tpu_torch.energy.martini import m2 as tm2  # noqa: E402
from mythos_tpu_torch.energy.martini import m3 as tm3  # noqa: E402
from mythos_tpu_torch.energy.martini.systems import default_bilayer_terms as t_terms  # noqa: E402
from mythos_tpu_torch.energy.martini.systems import lattice_bilayer as t_bilayer  # noqa: E402
from mythos_tpu_torch.observables.membranes import AreaPerLipid, MembraneThickness  # noqa: E402
from mythos_tpu_torch.ops import lj as tlj  # noqa: E402
from mythos_tpu_torch.simulators import particles as tpt  # noqa: E402
from mythos_tpu_torch.simulators.io import SimulatorTrajectory  # noqa: E402
from mythos_tpu_torch.simulators.martini import MartiniSimulator  # noqa: E402

BAROSTAT = {"pressure0": 1.0, "tau": 4.0, "every": 10}
N_STEPS, SAVE_EVERY = 50, 10


@pytest.fixture(scope="module")
def bilayer():
    """Both packages' 104-bead bilayer, jittered by 0.03 nm (float64)."""
    j_top, pos, box, masses = j_bilayer(3, 3, water_layers=1)
    t_top, t_pos, t_box, t_masses = t_bilayer(3, 3, water_layers=1)
    np.testing.assert_array_equal(t_pos, pos)
    np.testing.assert_array_equal(t_box, box)
    assert t_top.atom_types == j_top.atom_types and t_top.bond_names == j_top.bond_names
    pos = pos + np.random.default_rng(1).normal(scale=0.03, size=pos.shape)
    return j_top, t_top, pos, box, masses


def _snap_j(pos, box):
    return JTrajectory(center=jnp.asarray(pos), orientation=jnp.zeros((pos.shape[0], 4)), box_size=jnp.asarray(box))


def _snap_t(pos, box):
    return SimulatorTrajectory(center=torch.as_tensor(pos), orientation=torch.zeros(pos.shape[0], 4),
                               box_size=torch.as_tensor(box))


def _term_pairs(j_top, t_top):
    """(name, JAX term, port term) for Bond, Angle G96, Angle harmonic, LJ."""
    jb, ja, jl = j_terms(j_top)
    tb, ta, tl = t_terms(t_top)
    j_h = jm3.Angle.from_topology(j_top, params=ja.params)
    t_h = tm3.Angle.from_topology(t_top, params=ta.params)
    return [("Bond", jb, tb), ("AngleG96", ja, ta), ("AngleHarmonic", j_h, t_h), ("LJ", jl, tl)]


@pytest.mark.parametrize("term", ["Bond", "AngleG96", "AngleHarmonic", "LJ"])
def test_term_energy_matches_jax(bilayer, term):
    """(a) per-term energies, float64, rtol 1e-10."""
    j_top, t_top, pos, box, _ = bilayer
    _, jfn, tfn = next(p for p in _term_pairs(j_top, t_top) if p[0] == term)
    e_j = float(jax.jit(lambda x: jfn.compute_energy(_snap_j(x, box)))(jnp.asarray(pos)))
    e_t = float(tfn.compute_energy(_snap_t(pos, box)))
    np.testing.assert_allclose(e_t, e_j, rtol=1e-10)
    assert e_t != 0.0


def test_pair_mask_matches_jax(bilayer):
    """The bit-packed mask unpacks to m2.LJ._pair_mask symmetrised, and its
    upper half to m2.LJ._pair_mask."""
    j_top, t_top, pos, box, _ = bilayer
    jl, tl = j_terms(j_top)[2], t_terms(t_top)[2]
    mask_j = np.asarray(jl._pair_mask())
    pm = tl.pair_mask("cpu")
    assert pm.bits.dtype == torch.int32 and pm.bits.shape == (len(pos), -(-len(pos) // 32))
    np.testing.assert_array_equal(pm.dense().numpy(), mask_j | mask_j.T)
    np.testing.assert_array_equal(torch.cat([pm.upper(i, min(i + 40, len(pos))) for i in range(0, len(pos), 40)]).numpy(),
                                  mask_j)
    np.testing.assert_array_equal(tl.types("cpu").numpy(), np.asarray(jl._atom_type_map))


def test_lj_plain_matches_jax_reference(bilayer):
    """(b) lj_energy_plain, its position gradient (the plain backward and
    LJPairEnergy's) against lj_energy_forces_reference, float64 rtol
    1e-10; the box gradient against jax.grad of m2.LJ in the box."""
    j_top, t_top, pos, box, _ = bilayer
    jl, tl = j_terms(j_top)[2], t_terms(t_top)[2]
    tables_j = (jl.params.sigmas, jl.params.epsilons)
    e_ref, f_ref = jax.jit(lambda x: lj_energy_forces_reference(x, jl._atom_type_map, jl._pair_mask(),
                                                                 jnp.asarray(box), tables_j))(jnp.asarray(pos))
    g_box_ref = jax.jit(jax.grad(lambda b: jl.compute_energy(_snap_j(pos, b))))(jnp.asarray(box))

    x, b = torch.as_tensor(pos), torch.as_tensor(box)
    types, mask, tables = tl.types("cpu"), tl.pair_mask("cpu"), tl.tables("cpu", torch.float64)
    e_plain = tlj.lj_energy_plain(x, types, mask, b, tables)
    g_plain, g_box_plain = tlj.lj_grads_plain(x, types, mask, b, tables)
    xg, bg = x.clone().requires_grad_(True), b.clone().requires_grad_(True)
    e_fn = tlj.lj_pair_energy(xg, types, mask, bg, tables)
    g_fn, g_box_fn = torch.autograd.grad(e_fn, (xg, bg))

    for e in (e_plain, e_fn):
        np.testing.assert_allclose(e.item(), float(e_ref), rtol=1e-10)
    for g in (g_plain, g_fn):
        np.testing.assert_allclose(g.numpy(), -np.asarray(f_ref), rtol=1e-10, atol=1e-10 * np.abs(f_ref).max())
    for g in (g_box_plain, g_box_fn):
        np.testing.assert_allclose(g.numpy(), np.asarray(g_box_ref), rtol=1e-10, atol=1e-12)
    assert np.abs(np.asarray(g_box_ref)).max() > 1.0  # the image term is present, not zero


def test_lj_refuses_small_box(bilayer):
    """The minimum image needs every side above 2 x 1.1 nm."""
    j_top, t_top, pos, box, _ = bilayer
    tl = t_terms(t_top)[2]
    with pytest.raises(ValueError, match="twice the LJ cutoff"):
        tl.compute_energy(_snap_t(pos, np.array([2.1, box[1], box[2]])))


def _sims(j_top, t_top, box, masses):
    jsim = JMartiniSimulator(energy_fns=j_terms(j_top), box=jnp.asarray(box), masses=jnp.asarray(masses),
                             save_every=SAVE_EVERY, barostat=BAROSTAT)
    tsim = MartiniSimulator(energy_fns=t_terms(t_top), box=box, masses=masses, save_every=SAVE_EVERY,
                            barostat=BAROSTAT, device="cpu")
    return jsim, tsim


def test_pressure_diag_matches_jax(bilayer):
    """(c) the AD-virial diagonal pressure, float64, rtol 1e-8."""
    j_top, t_top, pos, box, masses = bilayer
    jsim, tsim = _sims(j_top, t_top, box, masses)
    mom = np.random.default_rng(2).normal(size=pos.shape) * np.sqrt(72.0 * jsim.kT)
    inv_m = 1.0 / masses[:, None]
    p_j = jax.jit(lambda x, p: j_pressure_diag(jsim._energy_fn(None), x, p, jnp.asarray(inv_m), jnp.asarray(box)))(
        jnp.asarray(pos), jnp.asarray(mom))
    p_t = tpt.pressure_diag(tsim._energy_fn(None), torch.as_tensor(pos), torch.as_tensor(mom),
                            torch.as_tensor(inv_m), torch.as_tensor(box))
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=1e-8)


@pytest.fixture(scope="module")
def npt_runs(bilayer):
    """JAX's 50-step NPT run and the port's, fed JAX's momenta and normals."""
    j_top, t_top, pos, box, masses = bilayer
    jsim, tsim = _sims(j_top, t_top, box, masses)
    key = jax.random.PRNGKey(0)
    out_j = jax.jit(lambda x: jsim.run(None, x, N_STEPS, key))(jnp.asarray(pos))

    @jax.jit
    def replay(k):
        # nvt_langevin_particles: init_fn splits once for the momenta, each
        # step splits once for its normals
        k, sub = jax.random.split(k)
        mom = jax.random.normal(sub, pos.shape, jnp.float64) * jnp.sqrt(jnp.asarray(masses)[:, None] * jsim.kT)

        def step(kk, _):
            kk, s = jax.random.split(kk)
            return kk, jax.random.normal(s, pos.shape, jnp.float64)

        _, normals = jax.lax.scan(step, k, None, length=N_STEPS)
        return mom, normals

    mom, normals = replay(key)
    out_t = tsim.run(None, pos, N_STEPS, init_momentum=torch.tensor(np.asarray(mom)),
                     noise=torch.tensor(np.asarray(normals)))
    return j_top, out_j.observables[0], out_t.observables[0], tsim


def test_npt_trajectory_matches_jax(npt_runs):
    """(d) saved centers and boxes of 50 NPT steps, float64, rtol 1e-6."""
    _, tj, tt, _ = npt_runs
    assert tt.center.shape == (N_STEPS // SAVE_EVERY, 104, 3) and tt.box_size.shape == (N_STEPS // SAVE_EVERY, 3)
    np.testing.assert_allclose(tt.center.numpy(), np.asarray(tj.center), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(tt.box_size.numpy(), np.asarray(tj.box_size), rtol=1e-6)
    assert not np.allclose(tt.box_size[0].numpy(), tt.box_size[-1].numpy())  # the barostat acted
    assert float(tt.box_size[-1, 0]) == float(tt.box_size[-1, 1])  # xy coupled
    assert tt.metadata["kinetic_kT"].shape == (N_STEPS // SAVE_EVERY,)


def test_membrane_observables_match_jax(npt_runs):
    """(e) APL and thickness: the port's on its trajectory against JAX's on
    JAX's (rtol 1e-6), and both on JAX's trajectory (rtol 1e-12)."""
    j_top, tj, tt, _ = npt_runs
    heads = np.asarray([i for i, nm in enumerate(j_top.atom_names) if nm == "PO4"], np.int32)
    apl_j = np.asarray(JAreaPerLipid(head_indices=jnp.asarray(heads))(tj))
    th_j = np.asarray(JMembraneThickness(thickness_indices=jnp.asarray(heads))(tj))
    same = SimulatorTrajectory(center=torch.as_tensor(np.asarray(tj.center)), orientation=tt.orientation,
                               box_size=torch.as_tensor(np.asarray(tj.box_size)))
    for traj, rtol in ((same, 1e-12), (tt, 1e-6)):
        np.testing.assert_allclose(AreaPerLipid(head_indices=heads)(traj).numpy(), apl_j, rtol=rtol)
        np.testing.assert_allclose(MembraneThickness(thickness_indices=heads)(traj).numpy(), th_j, rtol=rtol)
    assert 0.3 < apl_j[-1] < 1.0 and 0.5 < th_j[-1] < 5.0


def test_lj_map_and_lennard_jones_match_jax(npt_runs):
    """``LJ.map`` over the saved states of JAX's run (one pair mask for all)
    against JAX's ``m2.LJ.map``, and ``lennard_jones``, float64 rtol 1e-10."""
    j_top, tj, tt, _ = npt_runs
    jl = j_terms(j_top)[2]
    t_top = t_bilayer(3, 3, water_layers=1)[0]
    e_j = np.asarray(jax.jit(jl.map)(tj))
    same = SimulatorTrajectory(center=torch.as_tensor(np.asarray(tj.center)), orientation=tt.orientation,
                               box_size=torch.as_tensor(np.asarray(tj.box_size)))
    np.testing.assert_allclose(t_terms(t_top)[2].map(same).numpy(), e_j, rtol=1e-10)
    r = np.linspace(0.4, 1.3, 50)
    ref = np.asarray(jm2.lennard_jones(jnp.asarray(r), 3.5, 0.47))
    np.testing.assert_allclose(tm2.lennard_jones(torch.as_tensor(r), 3.5, 0.47).numpy(), ref, rtol=1e-10, atol=1e-12)


def test_configuration_carried_across(bilayer):
    """(f) a coupled JAX LJConfiguration through params_from_numpy: params,
    opt_params, bead types and tables; the proxy merge fans out; a merge
    without the proxy drops the coupled targets and raises on both sides
    (the reference's behaviour); the simulator's merged energy agrees."""
    j_top, t_top, pos, box, masses = bilayer
    coup = {"lj_epsilon_tail": ["lj_epsilon_C1_C1", "lj_epsilon_C1_P4"]}
    jl = j_terms(j_top)[2]
    j_cfg = jm2.LJConfiguration(couplings=coup, **(jl.params.params | {"lj_epsilon_tail": 3.0}))
    t_cfg = params_from_numpy(j_cfg.opt_params, dtype=torch.float64, configuration=tm2.LJConfiguration,
                              couplings=j_cfg.couplings)
    assert isinstance(t_cfg, tm2.LJConfiguration)
    assert list(t_cfg.params) == list(j_cfg.params) and list(t_cfg.opt_params) == list(j_cfg.opt_params)
    assert t_cfg.bead_types == j_cfg.bead_types and t_cfg["lj_epsilon_tail"] == 3.0
    sig, eps = t_cfg.tables("cpu", torch.float64)
    np.testing.assert_array_equal(sig.numpy(), np.asarray(j_cfg.sigmas))
    np.testing.assert_array_equal(eps.numpy(), np.asarray(j_cfg.epsilons))
    j_m, t_m = j_cfg | {"lj_epsilon_tail": 2.0}, t_cfg | {"lj_epsilon_tail": 2.0}
    assert {k: float(v) for k, v in t_m.params.items()} == {k: float(v) for k, v in j_m.params.items()}
    for cfg in (j_cfg, t_cfg):
        with pytest.raises(ValueError, match="Missing LJ epsilon"):
            cfg | {"lj_sigma_C1_C1": 0.5}

    jsim, tsim = _sims(j_top, t_top, box, masses)
    jsim = jsim.replace(energy_fns=[jl.replace(params=j_cfg)])
    tsim = tsim.replace(energy_fns=[t_terms(t_top)[2].replace(params=t_cfg)])
    opt = {"lj_epsilon_tail": 2.5, "lj_sigma_P4_P4": 0.48}
    e_j = float(jax.jit(lambda x: jsim._energy_fn(opt)(x, jnp.asarray(box)))(jnp.asarray(pos)))
    e_t = float(tsim._energy_fn(params_from_numpy(opt, dtype=torch.float64))(torch.as_tensor(pos),
                                                                              torch.as_tensor(box)))
    np.testing.assert_allclose(e_t, e_j, rtol=1e-10)


def test_martini_simulator_refuses_missing_card(bilayer):
    """The simulator runs on the card by default and raises without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, t_top, _, box, masses = bilayer
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MartiniSimulator(energy_fns=t_terms(t_top), box=box, masses=masses)


#: the bilayer cases: (lipids a side, water layers)
BILAYER_CASES = {"two cells a side": (3, 1), "scaled box": (8, 4), "wide box": (5, 2)}
#: a box past MAX_CELLS at floor(box / LJ_CELL) cells a side: 63 x 63 x 9
WIDE_BOX = (70.0, 70.0, 10.0)


def _cells_case(case):
    """(positions, box, pair mask) of one cell-list case, float32. The
    "wide box" holds the 456-bead bilayer, jittered, straddling the box's
    x and y faces (shifted by half its own box), in a 70 x 70 x 10 nm box."""
    rng = np.random.default_rng(3)
    if case in BILAYER_CASES:
        n_xy, layers = BILAYER_CASES[case]
        top, pos, box, _ = t_bilayer(n_xy, n_xy, water_layers=layers)
        pos = pos + rng.normal(scale=0.03, size=pos.shape)
        if case == "scaled box":
            box = box * np.array([0.98, 0.98, 1.02])
        if case == "wide box":
            pos = pos - np.array([box[0] / 2, box[1] / 2, 0.0])
            box = np.array(WIDE_BOX)
        mask = t_terms(top)[2].pair_mask("cpu")
    else:
        n = 500
        box = {"random box": [3.7, 5.3, 4.6], "outside [0, box)": [4.0, 3.3, 5.5],
               "one cell along x": [2.2001, 3.4, 4.5]}[case]
        box = np.array(box)
        lo, hi = (-2.0, 3.0) if case == "outside [0, box)" else (0.0, 1.0)
        pos = rng.uniform(lo, hi, size=(n, 3)) * box
        mask = tlj.PairMask.build(n, rng.integers(0, n, size=(n, 2)), "cpu")
    return torch.as_tensor(pos, dtype=torch.float32), torch.as_tensor(box, dtype=torch.float32), mask


CELL_CASES = ["random box", "two cells a side", "scaled box", "outside [0, box)", "one cell along x", "wide box"]


@pytest.mark.parametrize("case", CELL_CASES)
def test_cell_list_covers_pairs_in_reach(case):
    """(h) cell_list_plain: floor(box / LJ_CELL) cells a side, the largest
    count lowered by one at a time (x first on ties) while there are more
    than MAX_CELLS, the beads ordered by (cell, index) with consistent
    starts, and the candidates of each row -- the beads of the cells at most
    one away along every axis, periodically -- hold every masked pair
    inside the cutoff of the dense minimum-image distances; candidate_tests
    counts those candidates."""
    x, box, mask = _cells_case(case)
    n = x.shape[0]
    cells = tlj.cell_list_plain(x, box)
    nc = [int(v) for v in cells.dims]
    want = [max(1, int(np.floor(np.float32(b) / np.float32(tlj.LJ_CELL)))) for b in box.tolist()]
    if case == "wide box":
        assert want == [63, 63, 9] and np.prod(want) > tlj.MAX_CELLS
    while np.prod(want) > tlj.MAX_CELLS:
        want[int(np.argmax(want))] -= 1
    assert nc == want and tuple(nc) == tlj.cell_dims(box)
    if case == "wide box":
        assert nc == [60, 60, 9]
    if case == "two cells a side":
        assert nc[:2] == [2, 2]
    if case == "one cell along x":
        assert nc[0] == 1
    order, cell_of = cells.order.long(), cells.cell_of.long()
    assert sorted(order.tolist()) == list(range(n))
    key = cell_of[order] * n + order
    assert bool((key[1:] > key[:-1]).all())
    total = nc[0] * nc[1] * nc[2]
    counts = torch.bincount(cell_of, minlength=total)
    np.testing.assert_array_equal(cells.start[1 : total + 1].numpy(), torch.cumsum(counts, 0).numpy())
    assert int(cells.start[0]) == 0 and bool((cells.start[total:] == n).all())

    coords = torch.stack([cell_of // (nc[1] * nc[2]), (cell_of // nc[2]) % nc[1], cell_of % nc[2]], 1)
    delta = (coords[:, None, :] - coords[None, :, :]) % torch.tensor(nc)
    cand = ((delta <= 1) | (delta == torch.tensor(nc) - 1)).all(-1)
    dr = x.double()[:, None, :] - x.double()[None, :, :]
    dr = dr - box.double() * torch.round(dr / box.double())
    inside = mask.dense() & ((dr * dr).sum(-1) < tlj.LJ_CUTOFF**2)
    assert int(inside.sum()) > 0
    assert not bool((inside & ~cand).any())
    assert tlj.candidate_tests(cells) == int(cand.sum())


def _cells_energy_inputs(case, n):
    """(types, float64 tables, the JAX term or None) for a cell-list case:
    the bilayer's own for the bilayer cases, random types over the
    104-bead bilayer's tables otherwise."""
    if case in BILAYER_CASES:
        n_xy, layers = BILAYER_CASES[case]
        term = t_terms(t_bilayer(n_xy, n_xy, water_layers=layers)[0])[2]
        return term.types("cpu"), term.tables("cpu", torch.float64), j_terms(j_bilayer(n_xy, n_xy, water_layers=layers)[0])[2]
    term = t_terms(t_bilayer(3, 3, water_layers=1)[0])[2]
    tables = term.tables("cpu", torch.float64)
    types = np.random.default_rng(4).integers(0, tables[0].shape[0], size=n)
    return torch.as_tensor(types, dtype=torch.int32), tables, None


@pytest.mark.parametrize("case", CELL_CASES)
def test_cell_candidates_hold_each_pair_once(case):
    """The candidates K6's forward keeps -- (i, j > i) over each row's
    distinct neighbour cells (cell_candidates on cell_list_plain's cells),
    with the mask bit set -- hold every masked pair inside the cutoff
    exactly once, on axes of 2 and 1 cells too; their float64 energy equals
    lj_energy_plain's (rtol 1e-12) and, on the bilayers, that of JAX's
    lj_energy_forces_reference."""
    x, box, mask = _cells_case(case)
    n = x.shape[0]
    i, j = tlj.cell_candidates(tlj.cell_list_plain(x, box))
    dense = mask.dense()
    keep = (j > i) & dense[i, j]
    i, j = i[keep], j[keep]
    key = i * n + j
    assert key.unique().numel() == key.numel()
    x64, b64 = x.double(), box.double()
    dr = x64[i] - x64[j]
    dr = dr - b64 * torch.round(dr / b64)
    r2 = (dr * dr).sum(-1) + 1e-18
    inside = r2 < tlj.LJ_CUTOFF**2
    drd = x64[:, None, :] - x64[None, :, :]
    drd = drd - b64 * torch.round(drd / b64)
    want = torch.nonzero(torch.triu(dense & ((drd * drd).sum(-1) < tlj.LJ_CUTOFF**2), diagonal=1))
    assert len(want) > 0
    np.testing.assert_array_equal(torch.sort(key[inside]).values.numpy(), (want[:, 0] * n + want[:, 1]).numpy())

    types, tables, j_term = _cells_energy_inputs(case, n)
    t = types.long()
    energy = tlj._lj_terms(r2[inside], tables[0][t[i[inside]], t[j[inside]]], tables[1][t[i[inside]], t[j[inside]]]).sum()
    e_plain = tlj.lj_energy_plain(x64, types, mask, b64, tables)
    np.testing.assert_allclose(float(energy), float(e_plain), rtol=1e-12)
    if j_term is not None:
        tables_j = (j_term.params.sigmas, j_term.params.epsilons)
        e_ref, _ = jax.jit(lambda p: lj_energy_forces_reference(p, j_term._atom_type_map, j_term._pair_mask(),
                                                                jnp.asarray(b64.numpy()), tables_j))(jnp.asarray(x64.numpy()))
        np.testing.assert_allclose(float(energy), float(e_ref), rtol=1e-12)
