"""PyTorch port (mythos_tpu_torch): the stencil band and the block tables
sized from the bound energy, and the guard on a band too narrow for it.

The Debye-Hueckel cutoff ``r_cut`` grows as the salt falls (2.29 at the
default 0.5, 5.11 at 0.1). A band sized at the default salt drops the pairs
between its Debye reach and the bound ``r_cut``, and no band check flags
them. The port sizes the band from the bound energy
(``per_term_site_cutoffs(energy_fn)``), records the cutoffs its reaches
were sized for, and raises before any launch when a bound cutoff passes
one (``StencilBand.bound``, ``ERR_BAND_CUTOFF``); within them its checks
take the bound cutoffs. Port against port, no JAX: (1) at salt 0.1 the
plain stencil force (``field_grads_plain + bonded_grads_plain``)
on the band from the bound energy is within 5e-4 max |d/dcom| of the
float64 pair-list force (in float32, within 1.1 times the float32 pair
list's own error), while
the same force on the default-salt band, its guard taken off, is off by
more than 1e-3; (2) the guard; (3) at the defaults ``build_sim`` sizes
the same bands and tables as the default helpers.
"""

import dataclasses as dc

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny CPU shapes: one thread a worker, no idle pool spinning beside the others

import mythos_tpu_torch.energy.dna1 as dna1  # noqa: E402
import mythos_tpu_torch.energy.dna2 as dna2  # noqa: E402
import mythos_tpu_torch.energy.rna2 as rna2  # noqa: E402
from mythos_tpu_torch import entry  # noqa: E402
from mythos_tpu_torch.io.synthetic import synthetic_duplex  # noqa: E402
from mythos_tpu_torch.ops import stencil as ts  # noqa: E402
from mythos_tpu_torch.rigid_body import RigidBody  # noqa: E402
from mythos_tpu_torch.simulators.neighbors import (  # noqa: E402
    ERR_BAND_CUTOFF,
    block_neighbor_list_for_topology,
    stencil_band_for_site_cutoffs,
    strand_interleave_perm,
)

N_BP = 40
SALT = 0.1
#: the stencil force against the float64 pair list, max |d/dcom|
FORCE_ATOL = 5e-4
#: the float32 stencil force against the float64 pair list, a multiple of the
#: float32 pair list's own error on the same input
NOISE32_FACTOR = 1.1


def _jittered(n_bp: int = N_BP, form: str = "B", dtype=torch.float32):
    top, body = synthetic_duplex(n_bp, form=form, dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(0)
    c = body.center + 0.02 * torch.as_tensor(rng.standard_normal(tuple(body.center.shape)))
    q = body.orientation + 0.02 * torch.as_tensor(rng.standard_normal(tuple(body.orientation.shape)))
    return top, RigidBody(c.to(dtype), (q / q.norm(dim=-1, keepdim=True)).to(dtype))


def _band(top, body, cutoffs):
    return stencil_band_for_site_cutoffs(top, cutoffs, body.center, body.orientation,
                                         perm=strand_interleave_perm(top))


def _stencil_force(energy_fn, band, body, dtype=torch.float32) -> torch.Tensor:
    """(N, 3) d E / d com of the plain stencil (K2's and the bonded plain
    versions) in ``dtype``, original order."""
    ctx = ts.prepare_stencil_context(energy_fn, band, dtype=dtype, device="cpu")
    rows = torch.cat([ctx.to_slots(body.center.T), ctx.to_slots(body.orientation.T)]).to(dtype)
    g = ts.field_grads_plain(ctx, rows) + ts.bonded_grads_plain(ctx, rows)
    return ctx.from_slots(g[:3]).T.double()


def _pair_force(energy_fn, body) -> torch.Tensor:
    """(N, 3) d E / d com of the pair list, by autograd."""
    c = body.center.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(energy_fn(RigidBody(c, body.orientation)), c)
    return g.double()


def test_salt_band_force_within_float32_noise():
    """At salt 0.1 the band from the bound energy reaches the bound Debye
    r_cut (w_wide twice the default's 16), and the plain stencil force on
    it is within 5e-4 max |d/dcom| of the float64 pair-list force in
    float64 (1.9e-6 measured: arccos_poly against safe_arccos). In float32
    it is within 1.1 times the float32 pair list's own error on this input
    (its max|F| is 51: the pair list 5.64e-4 measured, the stencil
    5.56e-4), so float32 alone, not 5e-4, bounds it there. On the
    default-salt band (its guard taken off) the same force misses the pairs
    past its Debye reach by more than 1e-3 (4.25e-3 measured, the 4.2e-3 of
    ROADMAP queue 3)."""
    top, body = _jittered()
    e32 = dna2.create_default_energy_fn(top, overrides={"salt_conc": SALT}, device="cpu")
    e64 = dna2.create_default_energy_fn(top, overrides={"salt_conc": SALT}, dtype=torch.float64, device="cpu")
    body64 = RigidBody(body.center.double(), body.orientation.double())
    ref = _pair_force(e64, body64)
    band = _band(top, body, dna2.per_term_site_cutoffs(e32))
    narrow = _band(top, body, dna2.per_term_site_cutoffs())
    r_cut = float({type(fn).__name__: fn.params for fn in e32.energy_fns}["Debye"].r_cut)
    assert r_cut == pytest.approx(5.113, abs=1e-3)
    assert ("Debye", "back", "back", r_cut, r_cut + 0.9) in band.site_cutoffs  # the backbones' slack
    assert band.w_terms == narrow.w_terms and narrow.w_wide == 16 and band.w_wide >= 2 * narrow.w_wide
    assert not bool(band.did_overflow)
    assert float((_stencil_force(e64, band, body64, torch.float64) - ref).abs().max()) <= FORCE_ATOL
    noise32 = float((_pair_force(e32, body) - ref).abs().max())
    assert float((_stencil_force(e32, band, body) - ref).abs().max()) <= NOISE32_FACTOR * noise32
    unguarded = dc.replace(narrow, site_cutoffs=())
    assert float((_stencil_force(e64, unguarded, body64, torch.float64) - ref).abs().max()) > 1e-3


def test_band_too_narrow_for_bound_cutoff_raises(monkeypatch):
    """A band sized at the default salt reaches each term's site cutoff
    plus its slack (Debye 2.287 + 0.9). The stencil context of an energy
    whose bound cutoff passes that -- salt 0.1 (r_cut 5.11), a fit that
    moved ``lambda_factor`` (an optimised Debye parameter) x 1.5 (3.43), or
    hydrogen bonding's ``dr_high_hb`` and ``dr_c_hb`` by +0.6 (its high
    cutoff 1.38, the reach's 1.28) -- raises ERR_BAND_CUTOFF before
    any launch, also through CudaSimulator.run with such ``opt_params``.
    A bound cutoff inside the reach -- a fit step's drift, ``lambda_factor``
    x 1.1 -- runs, the band's exact checks (K1's row 19 too) and far sweep
    then at the bound cutoff; the default salt, a higher salt and a
    smaller cutoff leave the band as it is."""
    top, body = _jittered()
    energy_fn, sim = entry.build_sim(top, 0.1, init_centers=body.center, init_orientation=body.orientation,
                                     neighbor_update_every=5, device="cpu")
    launches = []
    for name in ("field_grads", "multistep_chunk"):
        monkeypatch.setattr(ts, name, lambda *a, _n=name, **k: launches.append(_n))
    opt = energy_fn.opt_params()
    for bad, term in (({"salt_conc": SALT}, "Debye"), ({"lambda_factor": 1.5 * opt["lambda_factor"]}, "Debye"),
                      ({"dr_high_hb": opt["dr_high_hb"] + 0.6, "dr_c_hb": opt["dr_c_hb"] + 0.6},
                       "HydrogenBonding")):
        with pytest.raises(ValueError, match=f"bound {term} cutoff") as err:
            ts.prepare_stencil_context(energy_fn.with_params(bad), sim.band, device="cpu")
        assert str(err.value).startswith(ERR_BAND_CUTOFF.split("{")[0])
        if "salt_conc" not in bad:
            with pytest.raises(ValueError, match=f"bound {term} cutoff"):
                sim.run(opt | bad, body, 10, torch.Generator().manual_seed(0))
    assert launches == []
    debye = [c for c in sim.band.site_checks if (c[0], c[1]) == ("back", "back") and c[2] > 2.0]
    for fine in ({"salt_conc": 0.5}, {"salt_conc": 1.0}, {"dr_c_hb": opt["dr_c_hb"] - 0.05}):
        bound = ts.bound_band(energy_fn.with_params(fine), sim.band)
        assert bound.site_checks == sim.band.site_checks and bound.far_cutoff == sim.band.far_cutoff
    wider = energy_fn.with_params(lambda_factor=1.1 * opt["lambda_factor"])
    r_cut = float({type(fn).__name__: fn.params for fn in wider.energy_fns}["Debye"].r_cut)
    bound = ts.bound_band(wider, sim.band)
    assert r_cut > debye[0][2] and bound.far_cutoff == r_cut
    assert [c for c in bound.site_checks if c[:2] == ("back", "back") and c[2] > 2.0] == [
        ("back", "back", r_cut, *debye[0][3:])]
    ctx = ts.prepare_stencil_context(wider, sim.band, device="cpu")
    assert bool((ctx.checks[:, 2] == torch.tensor(r_cut, dtype=torch.float32)).any())


def test_build_sim_sizes_from_the_bound_energy():
    """``build_sim`` sizes its band and tables from the energy it builds;
    at the defaults these are the default helpers' (the same reaches,
    checks and flags, the cutoffs to float32 rounding -- the bound
    parameters are float32 --, and bit-equal tables), for the dna2, rna2
    and dna1 stencil and block tiers; each model's bound helpers give its
    default ones within float32 rounding."""
    for model, pkg, form, n_bp in (("dna2", dna2, "B", 20), ("rna2", rna2, "A", 30), ("dna1", dna1, "B", 20)):
        top, body = _jittered(n_bp, form)
        e, sim = entry.build_sim(top, 0.1, model=model, init_centers=body.center,
                                 init_orientation=body.orientation, device="cpu")
        for got, want in ((pkg.default_neighbor_cutoff(e), pkg.default_neighbor_cutoff()),
                          *(((pkg.short_range_neighbor_cutoff(e), pkg.short_range_neighbor_cutoff()),)
                            if model != "dna1" else ())):
            assert got == pytest.approx(want, rel=1e-6), model
        ref = stencil_band_for_site_cutoffs(
            top, pkg.per_term_site_cutoffs(), body.center, body.orientation, perm=strand_interleave_perm(top),
            site_margin=2 if model == "rna2" else 1,
            fam_slack_overrides=rna2.aform_site_slacks() if model == "rna2" else None,
            far_slack=rna2.aform_far_slack() if model == "rna2" else None,
        )
        band = sim.band
        assert (band.w_terms, band.w_wide, band.check_dm, band.check_block) == (
            ref.w_terms, ref.w_wide, ref.check_dm, ref.check_block), model
        assert [c[:2] + c[3:] for c in band.site_checks] == [c[:2] + c[3:] for c in ref.site_checks], model
        np.testing.assert_allclose([c[2] for c in band.site_checks], [c[2] for c in ref.site_checks], rtol=1e-6)
        assert band.far_cutoff == pytest.approx(ref.far_cutoff, rel=1e-6)
        assert bool(band.did_overflow) is bool(ref.did_overflow) is False
        _, blk = entry.build_sim(top, 0.1, mode="block", model=model, init_centers=body.center, device="cpu")
        nbl = blk.neighbors
        ref_nbl = block_neighbor_list_for_topology(
            top, pkg.default_neighbor_cutoff(), block_size=8, init_centers=body.center,
            r_cutoff_inner=pkg.short_range_neighbor_cutoff() if model == "dna2" else None,
            perm=strand_interleave_perm(top), symmetric=model != "rna2",
        )
        assert (nbl.capacity, nbl.capacity_inner, nbl.banded, nbl.r_cutoff_inner is None) == (
            ref_nbl.capacity, ref_nbl.capacity_inner, ref_nbl.banded, ref_nbl.r_cutoff_inner is None), model
        tables, ref_tables = (t if isinstance(t, tuple) else (t,) for t in (nbl.idx, ref_nbl.idx))
        assert all(torch.equal(a, b) for a, b in zip(tables, ref_tables, strict=True)), model
