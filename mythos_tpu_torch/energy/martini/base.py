"""Common MARTINI machinery: topology, dict-backed configuration, base term.

Counterpart of mythos_tpu/energy/martini/base.py. MDAnalysis is an
optional host-side dependency, imported only inside ``from_tpr``:
topologies are usually built from arrays (energy/martini/systems.py).
Terms are plain classes; a term evaluates on the device and dtype of the
positions it is given, and caches its per-bond/angle/pair tensors there.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from mythos_tpu_torch import spaces
from mythos_tpu_torch.simulators.io import SimulatorTrajectory


def get_periodic(box_size) -> callable:
    """Displacement function for a periodic box (positions in nm)."""
    return spaces.periodic(box_size)[0]


def derive_bond_names(
    residue_names: tuple[str, ...], atom_names: tuple[str, ...], bonded_neighbors
) -> tuple[str, ...]:
    """``RESIDUE_BEAD1_BEAD2`` names aligned with bonded_neighbors."""
    return tuple(f"{residue_names[b[0]]}_{atom_names[b[0]]}_{atom_names[b[1]]}" for b in np.asarray(bonded_neighbors))


def derive_angle_names(residue_names: tuple[str, ...], atom_names: tuple[str, ...], angles) -> tuple[str, ...]:
    """``RESIDUE_BEAD1_BEAD2_BEAD3`` names aligned with angles."""
    return tuple(
        f"{residue_names[a[0]]}_{atom_names[a[0]]}_{atom_names[a[1]]}_{atom_names[a[2]]}" for a in np.asarray(angles)
    )


class MartiniTopology:
    """Bead types/names/residues, bonds (B, 2) and angles (A, 3) of a
    MARTINI system (index arrays kept as numpy)."""

    def __init__(self, *, atom_types, atom_names, residue_names, angles, bonded_neighbors) -> None:
        self.atom_types = tuple(atom_types)
        self.atom_names = tuple(atom_names)
        self.residue_names = tuple(residue_names)
        self.angles = np.asarray(angles).reshape(-1, 3)
        self.bonded_neighbors = np.asarray(bonded_neighbors).reshape(-1, 2)

    @classmethod
    def from_universe(cls, universe) -> "MartiniTopology":
        """From an MDAnalysis Universe (optional dependency)."""
        return cls(
            atom_types=tuple(universe.atoms.types),
            atom_names=tuple(universe.atoms.names),
            residue_names=tuple(universe.atoms.resnames),
            angles=np.asarray(universe.angles.indices),
            bonded_neighbors=np.asarray(universe.bonds.indices),
        )

    @classmethod
    def from_tpr(cls, tpr_file: Path) -> "MartiniTopology":
        """From a GROMACS TPR file via MDAnalysis (optional dependency)."""
        try:
            import MDAnalysis
        except ImportError as e:
            raise ImportError(
                "MDAnalysis is required to read TPR topologies; install it or build the MartiniTopology from arrays."
            ) from e
        return cls.from_universe(MDAnalysis.Universe(tpr_file))

    @property
    def bond_names(self) -> tuple[str, ...]:
        return derive_bond_names(self.residue_names, self.atom_names, self.bonded_neighbors)

    @property
    def angle_names(self) -> tuple[str, ...]:
        return derive_angle_names(self.residue_names, self.atom_names, self.angles)


class MartiniEnergyConfiguration:
    """Dict-backed parameter container with coupling support.

    MARTINI parameter spaces are large and sparse (per bond/angle/type-pair
    names), so parameters live in a dict. A *coupling* lets one proxy
    parameter drive many targets: couplings is ``{proxy: [target, ...]}``;
    constructor kwargs given under the proxy name are fanned out to the
    targets (kwargs naming a target directly are dropped, as in the
    reference); opt_params reports the proxy. Values are floats or tensors.
    """

    def __init__(self, couplings: dict[str, list[str]] | None = None, **kwargs) -> None:
        self.couplings = couplings or {}
        all_targets = [v for vals in self.couplings.values() for v in vals]
        if len(all_targets) != len(set(all_targets)):
            raise ValueError("Parameters cannot appear in more than one coupling")
        self.reversed_couplings = {v: k for k, vals in self.couplings.items() for v in vals}
        self.params: dict = {}
        for key, value in kwargs.items():
            if key in self.couplings:
                for subkey in self.couplings[key]:
                    self.params[subkey] = value
            elif key not in self.reversed_couplings:
                self.params[key] = value
        self.__post_init__()

    def __post_init__(self) -> None:
        """Hook for additional initialization in subclasses."""

    def init_params(self) -> "MartiniEnergyConfiguration":
        """Dependent-parameter initialization (no-op by default)."""
        return self

    @property
    def opt_params(self) -> dict:
        """Optimizable view: coupled targets reported under their proxy."""
        return {self.reversed_couplings.get(k, k): v for k, v in self.params.items()}

    def __getitem__(self, key: str):
        if key in self.params:
            return self.params[key]
        if key in self.couplings:
            return self.params[self.couplings[key][0]]  # all targets share the value
        raise KeyError(f"Parameter '{key}' not found in configuration.")

    def __contains__(self, key: str) -> bool:
        return key in self.params or key in self.couplings

    def __or__(self, other) -> "MartiniEnergyConfiguration":
        """Merge (other wins); couplings are preserved."""
        new_params = self.params.copy()
        new_params.update(other.params if isinstance(other, MartiniEnergyConfiguration) else dict(other))
        return self.__class__(couplings=self.couplings, **new_params)


def values_tensor(values: list, device, dtype) -> torch.Tensor:
    """(len(values),) tensor of floats or tensors (autograd reaches tensors)."""
    if any(isinstance(v, torch.Tensor) for v in values):
        return torch.stack([torch.as_tensor(v, dtype=dtype, device=device).reshape(()) for v in values])
    return torch.tensor(np.asarray(values, dtype=np.float64), dtype=dtype, device=device)


class MartiniEnergyFunction:
    """Base MARTINI term: point particles in a periodic box.

    ``displacement_fn`` is a factory taking the per-state box size (the box
    is a trajectory property in MARTINI runs). ``compute_energy(trajectory)``
    reads ``trajectory.center`` (N, 3) and ``trajectory.box_size`` (3,).
    """

    def __init__(
        self,
        *,
        atom_types,
        atom_names,
        residue_names,
        angles,
        bonded_neighbors,
        params: MartiniEnergyConfiguration,
        displacement_fn: callable = get_periodic,
    ) -> None:
        self.atom_types = tuple(atom_types)
        self.atom_names = tuple(atom_names)
        self.residue_names = tuple(residue_names)
        self.angles = np.asarray(angles).reshape(-1, 3)
        self.bonded_neighbors = np.asarray(bonded_neighbors).reshape(-1, 2)
        self.params = params
        self.displacement_fn = displacement_fn
        self._cache: dict = {}  # tensors of the parameters
        self._shared: dict = {}  # tensors of the topology, shared by every replace()d copy
        #: keep tensors built from parameters that need a gradient too (a copy
        #: made for one run: their graph lives as long as the run's)
        self.keep_graphs = False

    @classmethod
    def from_topology(cls, topology: MartiniTopology, **kwargs) -> "MartiniEnergyFunction":
        """Build from a MartiniTopology."""
        return cls(
            atom_types=topology.atom_types,
            atom_names=topology.atom_names,
            residue_names=topology.residue_names,
            angles=topology.angles,
            bonded_neighbors=topology.bonded_neighbors,
            **kwargs,
        )

    def replace(self, **kwargs) -> "MartiniEnergyFunction":
        """A copy with fields replaced (the parameter tensors are rebuilt)."""
        fields = {
            "atom_types": self.atom_types, "atom_names": self.atom_names, "residue_names": self.residue_names,
            "angles": self.angles, "bonded_neighbors": self.bonded_neighbors, "params": self.params,
            "displacement_fn": self.displacement_fn,
        }
        new = type(self)(**(fields | kwargs))
        if set(kwargs) <= {"params", "displacement_fn"}:  # the same topology
            new._shared = self._shared
        return new

    @property
    def bond_names(self) -> tuple[str, ...]:
        if "bond_names" not in self._shared:
            self._shared["bond_names"] = derive_bond_names(self.residue_names, self.atom_names, self.bonded_neighbors)
        return self._shared["bond_names"]

    @property
    def angle_names(self) -> tuple[str, ...]:
        if "angle_names" not in self._shared:
            self._shared["angle_names"] = derive_angle_names(self.residue_names, self.atom_names, self.angles)
        return self._shared["angle_names"]

    def opt_params(self) -> dict:
        return self.params.opt_params

    def cached(self, key: str, device, dtype, make, shared: bool = False):
        """``make(device, dtype)``, kept per (key, device, dtype) unless it
        carries a graph (a parameter that requires grad) and ``keep_graphs``
        is off. ``shared``: a tensor of the topology alone, kept for every
        copy replace() makes."""
        cache = self._shared if shared else self._cache
        k = (key, str(torch.device(device)), dtype)
        if k in cache:
            return cache[k]
        v = make(device, dtype)
        graph = any(isinstance(x, torch.Tensor) and x.requires_grad for x in (v if isinstance(v, tuple) else (v,)))
        if self.keep_graphs or not graph:
            cache[k] = v
        return v

    def per_name(self, key: str, prefix: str, names: tuple[str, ...], like: torch.Tensor) -> torch.Tensor:
        """(len(names),) values of ``prefix + name`` on ``like``'s device and
        dtype, cached."""
        return self.cached(key, like.device, like.dtype, lambda d, t: values_tensor(
            [self.params[prefix + nm] for nm in names], d, t))

    def index(self, key: str, array, device) -> torch.Tensor:
        """An index array of the topology as a long tensor on ``device``, cached."""
        return self.cached(key, device, None, lambda d, _: torch.as_tensor(np.asarray(array), device=d).long(), True)

    def compute_energy(self, trajectory) -> torch.Tensor:
        raise NotImplementedError

    def map(self, trajectory) -> torch.Tensor:
        """(S,) energies of the states of a trajectory (``center`` (S, N, 3),
        ``box_size`` (S, 3)); tensors of the topology, such as the LJ pair
        mask, are built once for all states."""
        return torch.stack([self.compute_energy(state) for state in _states(trajectory)])


def _states(trajectory):
    """The single states of a trajectory, each with ``center`` and ``box_size``."""
    boxes = trajectory.box_size
    return [
        SimulatorTrajectory(center=c, orientation=q, box_size=None if boxes is None else boxes[s])
        for s, (c, q) in enumerate(zip(trajectory.center, trajectory.orientation, strict=True))
    ]
