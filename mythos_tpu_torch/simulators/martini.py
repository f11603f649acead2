"""In-process MARTINI simulator: point-particle MD of coarse-grained lipids.

Counterpart of mythos_tpu/simulators/martini.py. The MARTINI bond/angle/LJ
terms (energy/martini) under the point-particle BAOAB Langevin integrator
with an optional semi-isotropic Berendsen barostat
(simulators/particles.py). On the card the LJ term runs through K6
(ops/lj.py, forward and backward); bonds and angles are eager PyTorch.

A run:

* merges ``opt_params`` into every term whose configuration carries the
  key (the configurations' ``|`` merge respects couplings);
* draws the initial momenta and each step's normals from the run's
  ``torch.Generator`` -- or takes them as ``init_momentum`` (N, 3) and
  ``noise`` (n_steps, N, 3), so a run can replay another's noise;
* steps B-A-O-A-B, and on every ``every``-th step applies the barostat
  (a Python branch where the reference uses ``lax.cond``), then checks on
  the host that the box still holds the LJ minimum image;
* keeps every ``save_every``-th state: centers, box and the kinetic kT
  (metadata ``kinetic_kT``).

The run is differentiable: where grad mode is on and a tensor of
``opt_params`` (or the initial positions or momenta) needs a gradient,
every force and every barostat virial is taken with ``create_graph``
(simulators/particles.py) and the LJ term's double backward is K6's plain
version (ops.lj.LJGrads), so ``loss(sim.run(p, x0, n, gen)).backward()``
gives d loss / d every parameter, through the box as well -- the
reference's ``jax.grad`` through its NPT scan. The forward launches the
same kernels as a run without gradients and gives the same trajectory. The
parameters' tensors (the LJ tables, the bond and angle constants) are built
once a run, not at every force evaluation. The reference's simulator has
no ``checkpoint_every``, nor does this one.

Units follow GROMACS (nm, kJ/mol, ps, amu, bar): kT = kB T with kB =
0.0083144621 kJ/mol/K; the barostat's ``pressure0`` (bar) and
``compressibility`` (1/bar) are converted with BAR (1 kJ/mol/nm^3 =
16.6054 bar).
"""

from __future__ import annotations

import dataclasses as dc

import torch

from mythos_tpu_torch.ops import lj as ops_lj
from mythos_tpu_torch.simulators import particles as pt
from mythos_tpu_torch.simulators.base import SimulatorOutput
from mythos_tpu_torch.simulators.io import SimulatorTrajectory
from mythos_tpu_torch.utils.devices import resolve

KB = 0.0083144621  # kJ/mol/K (GROMACS)
BAR = 1.0 / 16.6054  # kJ/mol/nm^3 per bar

ERR_SAVE_EVERY = "save_every must divide n_steps"


def _term_params_view(fn, opt_params: dict) -> dict:
    """The subset of opt_params this term's configuration accepts."""
    return {k: v for k, v in opt_params.items() if k in fn.params}


@dc.dataclass(frozen=True)
class MartiniSimulator:
    """Native MARTINI MD over a periodic box.

    ``run(opt_params, init_positions, n_steps, generator)`` returns a
    SimulatorOutput with one SimulatorTrajectory (centers, per-state box,
    identity orientations). ``energy_fns`` are MARTINI terms of one
    topology (energy/martini m2/m3 Bond/Angle/LJ).

    ``barostat=None`` runs NVT at the fixed ``box``; otherwise a dict
    ``{"pressure0": bar, "tau": ps, "every": int, "compressibility": 1/bar}``
    enables semi-isotropic Berendsen coupling (xy together, z free). The
    run's dtype is that of ``init_positions``; it runs on ``device`` (the
    card unless ``device="cpu"``).
    """

    energy_fns: list
    box: object  # (3,) nm
    masses: object  # (N,) amu
    dt: float = 0.02  # ps
    kT: float = KB * 305.0  # noqa: N815
    #: friction in amu/ps; tau_t = mass/gamma, so 72 gives the 1 ps coupling
    #: time GROMACS' sd integrator defaults to for MARTINI beads
    gamma: float = 72.0
    save_every: int = 50
    barostat: dict | None = None
    device: torch.device | str = "cuda"

    def __post_init__(self) -> None:
        object.__setattr__(self, "device", resolve(self.device))

    def replace(self, **kw) -> "MartiniSimulator":
        return dc.replace(self, **kw)

    def _energy_fn(self, opt_params: dict | None):
        """energy(position, box) of the terms with ``opt_params`` merged in:
        copies of the terms, which keep the tensors they build from the
        parameters even on the graph (one build of the LJ tables a run)."""
        fns = self.energy_fns
        if opt_params:
            fns = [fn.replace(params=fn.params | _term_params_view(fn, opt_params)) for fn in fns]
            for fn in fns:
                fn.keep_graphs = True
        n = len(fns[0].atom_types)
        quat = torch.tensor([1.0, 0.0, 0.0, 0.0], device=self.device).expand(n, 4)

        def energy(position: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
            snap = SimulatorTrajectory(center=position, orientation=quat.to(position.dtype), box_size=box)
            return sum(fn.compute_energy(snap) for fn in fns)

        return energy

    def run(
        self,
        opt_params: dict | None,
        init_positions,
        n_steps: int,
        generator: torch.Generator | None = None,
        *,
        init_momentum: torch.Tensor | None = None,
        noise: torch.Tensor | None = None,
    ) -> SimulatorOutput:
        if n_steps % self.save_every:
            raise ValueError(ERR_SAVE_EVERY)
        dev = self.device
        x0 = torch.as_tensor(init_positions, device=dev)
        dtype = x0.dtype
        box = torch.as_tensor(self.box, dtype=dtype, device=dev)
        ops_lj.check_box(box)
        masses = torch.as_tensor(self.masses, dtype=dtype, device=dev)
        if init_momentum is None:
            init_momentum = pt.thermal_momentum(x0, masses, self.kT, generator)
        p0 = torch.as_tensor(init_momentum, dtype=dtype, device=dev)
        leaves = [v for v in (opt_params or {}).values() if isinstance(v, torch.Tensor)]
        graph = pt._on_graph(x0, p0, *leaves)
        energy = self._energy_fn(opt_params)
        init_fn, step_fn = pt.nvt_langevin_particles(energy, lambda x, dx: x + dx, self.dt, self.kT, self.gamma)
        state = init_fn(x0, box, masses, p0, graph)

        baro = self.barostat
        every = int(baro["every"]) if baro else 0
        centers, boxes, temps = [], [], []
        for step in range(n_steps):
            if noise is None:
                normals = torch.randn(x0.shape, generator=generator, dtype=dtype, device=dev)
            else:
                normals = torch.as_tensor(noise[step], dtype=dtype, device=dev)
            state = step_fn(state, normals, graph)
            if baro and (step + 1) % every == 0:
                state = pt.berendsen_semi_isotropic(
                    energy,
                    state,
                    pressure0=baro["pressure0"] * BAR,
                    tau=baro["tau"],
                    dt=self.dt * every,
                    compressibility=baro.get("compressibility", 3e-4) / BAR,
                )
                with torch.no_grad():
                    ops_lj.check_box(state.box)
            if (step + 1) % self.save_every == 0:
                centers.append(state.position)
                boxes.append(state.box)
                temps.append(pt.kinetic_kT(state))

        center = torch.stack(centers)
        quats = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=dev).expand(*center.shape[:2], 4)
        traj = SimulatorTrajectory(
            center=center, orientation=quats, box_size=torch.stack(boxes), metadata={"kinetic_kT": torch.stack(temps)}
        )
        return SimulatorOutput(observables=[traj], state={"final_state": state})

    def temperature(self, state: pt.ParticleLangevinState) -> torch.Tensor:
        """Instantaneous kT from the momenta (diagnostics)."""
        return pt.kinetic_kT(state)
