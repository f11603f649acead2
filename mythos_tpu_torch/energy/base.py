"""Parameter containers, energy terms and their composition.

Counterpart of mythos_tpu/energy/base.py plus the parameter contract of
mythos_tpu/energy/configuration.py (which imports chex, so it is ported
here rather than shared): independent (required) params, non-optimizable
params, dependent params re-derived by ``init_params()`` on tensors (so
autograd sees the derivation), the ``opt_params`` filter with the ``OPT_ALL``
wildcard, and ``with_params`` fanning a flat namespace out to every term.
"""

from __future__ import annotations

import copy
from collections.abc import Callable

import numpy as np
import torch

ERR_MISSING_REQUIRED_PARAMS = "Required properties {props} are not initialized."
ERR_OPT_DEPENDENT_PARAMS = "Only {req_params} permitted for optimization, but found {given_params}"
ERR_COMPOSED_ENERGY_FN_LEN_MISMATCH = "Weights must have the same length as energy functions"


class BaseConfiguration:
    """Parameter container of one energy term.

    Subclasses list ``required_params``, ``dependent_params`` and
    ``optional_params`` and implement :meth:`derive` (the dependent values from the required ones).
    Values are tensors (or plain Python values for flags).
    """

    required_params: tuple[str, ...] = ()
    non_optimizable_required_params: tuple[str, ...] = ()
    dependent_params: tuple[str, ...] = ()
    #: settable, never required, derived or optimised through
    #: ``params_to_optimize`` (a probabilistic sequence and its constraints,
    #: a sequence-dependent weight table): ``with_params`` reaches them
    optional_params: tuple[str, ...] = ()
    OPT_ALL: tuple[str, ...] = ("*",)

    def __init__(self, params_to_optimize: tuple[str, ...] = (), **values) -> None:
        unknown = set(values) - set(self.fields())
        if unknown:
            raise TypeError(f"{type(self).__name__} has no parameters {sorted(unknown)}")
        self.__dict__["_values"] = dict(values)
        self.__dict__["params_to_optimize"] = tuple(params_to_optimize)
        missing = [p for p in self.required_params if values.get(p) is None]
        if missing:
            raise ValueError(ERR_MISSING_REQUIRED_PARAMS.format(props=",".join(missing)))
        optimizable = set(self.required_params) - set(self.non_optimizable_required_params)
        bad = set(self.params_to_optimize) - optimizable
        if bad and bad != set(self.OPT_ALL):
            raise ValueError(
                ERR_OPT_DEPENDENT_PARAMS.format(
                    req_params=",".join(sorted(optimizable)), given_params=",".join(sorted(bad))
                )
            )

    @classmethod
    def fields(cls) -> tuple[str, ...]:
        return cls.required_params + cls.dependent_params + cls.optional_params

    def __getattr__(self, name: str):
        values = self.__dict__["_values"]
        if name in values:
            return values[name]
        if name in type(self).fields():
            return None
        raise AttributeError(name)

    def __setattr__(self, name, value):
        raise AttributeError("configurations are immutable; use replace()")

    def __contains__(self, name: str) -> bool:
        return name in type(self).fields()

    def replace(self, **values) -> "BaseConfiguration":
        return type(self)(self.params_to_optimize, **{**self._values, **values})

    def __or__(self, other: dict) -> "BaseConfiguration":
        return self.replace(**other)

    @property
    def opt_params(self) -> dict:
        """The optimizable parameter subset as a dict."""
        if self.params_to_optimize == self.OPT_ALL:
            keys = [
                k for k in self.required_params if k not in self.non_optimizable_required_params
            ]
        else:
            keys = [k for k in self.fields() if k in self.params_to_optimize]
        return {k: self._values[k] for k in keys if k in self._values}

    def derive(self) -> dict:
        """Dependent parameter values from the required ones."""
        return {}

    def init_params(self) -> "BaseConfiguration":
        """Recompute the dependent parameters."""
        return self.replace(**self.derive())

    @classmethod
    def from_dict(cls, params: dict, params_to_optimize: tuple[str, ...] = ()):
        return cls(params_to_optimize, **params)


def params_from_numpy(
    opt_params: dict,
    device: torch.device | str = "cpu",
    dtype: torch.dtype = torch.float32,
    *,
    configuration: type | None = None,
    couplings: dict[str, list[str]] | None = None,
):
    """Carry the JAX package's parameters across, leaf by leaf.

    Input: a dict of floats, numpy scalars or arrays (an ``opt_params()``).
    Output: the same names as tensors of ``dtype`` on ``device``; feed it to
    the port's ``with_params``, which re-derives the dependent parameters.
    With ``configuration`` (a MARTINI configuration class of the port), the
    dict -- a JAX MARTINI configuration's ``opt_params``, coupled targets
    under their proxy -- and its ``couplings`` become that configuration.
    """
    params = {k: torch.as_tensor(np.array(v), dtype=dtype, device=device) for k, v in opt_params.items()}
    if configuration is None:
        return params
    return configuration(couplings=couplings, **params)


class BaseEnergyFunction:
    """One energy term bound to a topology.

    ``compute_energy(nucleotide)`` evaluates the term over the topology's
    pair lists (bonded pairs, or the unbonded pairs): the small-system path
    the stencil kernels are held against. An unbonded term takes its pairs
    from ``unbonded_neighbors`` ((U, 2), every i<j pair less the bonded ones
    when None; or a (2, P) tensor padded with N, a
    ``FixedCapacityNeighborList``'s), or, with ``dense_mask`` set ((N, N)
    bool, upper triangular), evaluates every (i, j) by broadcasts and sums
    under the mask -- the reference's ``dense_unbonded`` path
    (simulators.neighbors.dense_pair_mask) --, or, with ``block_ids`` set
    ((n_blocks, K) int tensor, a non-symmetric block table), sums its pairs
    over the table's (B, K B) tiles (energy/blocks.py, the reference's XLA
    tile path; ``block_perm`` the table's slot order).
    """

    #: a static (U, 2) pair list replacing the topology's (NoNeighborList),
    #: or a (2, P) tensor padded with N (FixedCapacityNeighborList)
    unbonded_neighbors: np.ndarray | torch.Tensor | None = None
    #: (N, N) bool mask of the dense evaluation (DensePairs)
    dense_mask: np.ndarray | None = None
    #: (n_blocks, K) block table of the block sums, its block size and slot order
    block_ids: torch.Tensor | None = None
    block_size: int = 0
    block_perm: np.ndarray | None = None

    _PROPS = ("unbonded_neighbors", "dense_mask", "block_ids", "block_size", "block_perm")

    def __init__(self, params: BaseConfiguration, topology, transform_fn: Callable) -> None:
        self.params = params
        self.topology = topology
        self.transform_fn = transform_fn

    def with_props(self, **props) -> "BaseEnergyFunction":
        """A copy with any of ``unbonded_neighbors``, ``dense_mask``,
        ``block_ids``, ``block_size``, ``block_perm`` set (the reference's
        ``with_props``); the device caches of the pairs start afresh."""
        unknown = set(props) - set(self._PROPS)
        if unknown:
            raise TypeError(f"unknown properties {sorted(unknown)}")
        new = copy.copy(self)
        cache = self.__dict__.get("_device_cache", {})
        new.__dict__["_device_cache"] = {k: v for k, v in cache.items() if k[0] not in ("unbonded", "dense")}
        for k, v in props.items():
            if v is not None and k in ("dense_mask", "block_perm"):
                v = np.asarray(v)
            elif v is not None and k == "unbonded_neighbors" and not isinstance(v, torch.Tensor):
                v = np.asarray(v)
            setattr(new, k, v)
        return new

    def unbonded_index(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        """(i, j) of the unbonded pairs as long tensors on ``device`` (a
        static list cached; a (2, P) tensor's rows as they are, padded with N)."""
        if isinstance(self.unbonded_neighbors, torch.Tensor):
            pairs = self.unbonded_neighbors.to(device=device, dtype=torch.long)
            return pairs[0], pairs[1]

        def make():
            pairs = self.topology.unbonded_neighbors if self.unbonded_neighbors is None else self.unbonded_neighbors
            return tuple(torch.as_tensor(np.asarray(pairs).reshape(-1, 2).T).long())

        return self._cached("unbonded", device, make)

    def dense_mask_on(self, device) -> torch.Tensor:
        """The (N, N) ``dense_mask`` as a bool tensor on ``device``, cached."""
        return self._cached("dense", device, lambda: torch.as_tensor(self.dense_mask, dtype=torch.bool))

    @property
    def seq(self) -> np.ndarray:
        return np.asarray(self.topology.seq)

    @property
    def bonded_neighbors(self) -> np.ndarray:
        return np.asarray(self.topology.bonded_neighbors)

    def bond_index(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        """(i, j) of the bonded pairs as long tensors on ``device``, cached:
        a step on the card then copies no index array from the host."""
        return self._cached("bonds", device, lambda: tuple(torch.as_tensor(self.bonded_neighbors.T).long()))

    def seq_index(self, device) -> torch.Tensor:
        """The (N,) sequence as a long tensor on ``device``, cached."""
        return self._cached("seq", device, lambda: torch.as_tensor(self.seq).long())

    def _cached(self, key: str, device, make):
        # shared by the copies with_params makes (same topology)
        cache = self.__dict__.setdefault("_device_cache", {})
        k = (key, str(torch.device(device)))
        if k not in cache:
            v = make()
            cache[k] = tuple(x.to(device) for x in v) if isinstance(v, tuple) else v.to(device)
        return cache[k]

    def opt_params(self) -> dict:
        return self.params.opt_params

    def with_params(self, **values) -> "BaseEnergyFunction":
        new = copy.copy(self)
        new.params = (self.params | values).init_params()
        return new

    def compute_energy(self, nucleotide) -> torch.Tensor:
        raise NotImplementedError


class ComposedEnergyFunction:
    """Weighted sum of energy terms sharing one parameter namespace.

    ``map_neighbors`` (a symmetric simulators.neighbors.BlockNeighborList)
    switches :meth:`map` to the tile kernels: the DiffTRe re-evaluation
    under oxDNA1 and oxDNA2.
    """

    def __init__(
        self, energy_fns: list[BaseEnergyFunction], weights: torch.Tensor | None = None, map_neighbors=None
    ) -> None:
        if weights is not None and len(weights) != len(energy_fns):
            raise ValueError(ERR_COMPOSED_ENERGY_FN_LEN_MISMATCH)
        self.energy_fns = list(energy_fns)
        self.weights = weights
        self.map_neighbors = map_neighbors

    def replace(self, **kw) -> "ComposedEnergyFunction":
        fields = {"energy_fns": self.energy_fns, "weights": self.weights, "map_neighbors": self.map_neighbors}
        return ComposedEnergyFunction(**(fields | kw))

    def opt_params(self) -> dict:
        return {k: v for fn in self.energy_fns for k, v in fn.opt_params().items()}

    def with_props(self, **props) -> "ComposedEnergyFunction":
        """Every member with ``unbonded_neighbors``/``dense_mask`` set
        (:meth:`BaseEnergyFunction.with_props`); the bonded terms ignore them."""
        return self.replace(energy_fns=[fn.with_props(**props) for fn in self.energy_fns])

    def with_params(self, *repl_dicts: dict, **repl_kwargs) -> "ComposedEnergyFunction":
        replacements = {k: v for d in repl_dicts for k, v in d.items()} | repl_kwargs
        used: set[str] = set()
        fns = []
        for fn in self.energy_fns:
            mine = {k: v for k, v in replacements.items() if k in fn.params}
            used.update(mine)
            fns.append(fn.with_params(**mine))
        if unused := set(replacements) - used:
            raise ValueError(f"Some parameters were not used in any energy function: {unused}.")
        return self.replace(energy_fns=fns)

    def term_weights(self) -> list:
        return [1.0 if self.weights is None else self.weights[i] for i in range(len(self.energy_fns))]

    def compute_terms(self, body) -> torch.Tensor:
        """Each member's energy; each distinct transform runs once.

        Unbonded members bound to the same block table and transform
        (``with_props(block_ids=...)``) are summed together, all their pair
        functions on the same gathered tiles (energy/blocks.py), as the
        reference's ``compute_terms``; the rest run their own pairs."""
        from mythos_tpu_torch.energy import blocks

        cache: dict[int, object] = {}

        def nuc_of(fn):
            key = id(fn.transform_fn)
            if key not in cache:
                cache[key] = fn.transform_fn(body)
            return cache[key]

        groups: dict[tuple[int, int], list[int]] = {}
        for k, fn in enumerate(self.energy_fns):
            if fn.block_ids is not None and hasattr(fn, "pair_energies"):
                groups.setdefault((id(fn.block_ids), id(fn.transform_fn)), []).append(k)
        vals: list = [None] * len(self.energy_fns)
        for idxs in groups.values():
            first = self.energy_fns[idxs[0]]
            sums = blocks.block_pair_sums(
                [self.energy_fns[k].pair_energies for k in idxs], nuc_of(first), first.block_ids,
                first.block_size, first.topology.n_nucleotides, first.bonded_neighbors, perm=first.block_perm,
            )
            for k, v in zip(idxs, sums, strict=True):
                vals[k] = v
        for k, fn in enumerate(self.energy_fns):
            if vals[k] is None:
                vals[k] = fn.compute_energy(nuc_of(fn))
        return torch.stack(vals)

    def __call__(self, body) -> torch.Tensor:
        vals = self.compute_terms(body)
        return vals.sum() if self.weights is None else (self.weights * vals).sum()

    def map(self, states) -> torch.Tensor:
        """(S,) energies of stacked states (``center`` (S, N, 3),
        ``orientation`` (S, N, 4)).

        With ``map_neighbors`` set, the contexts (packed parameters, static
        row fields) are prepared once, each state rebuilds its tables, and
        the unbonded terms run through K4 (ops.tiles.unbonded_tile_energies,
        differentiable in the parameters); a state whose table overflowed
        reads NaN, so that reweighting it fails loudly. The tile kernels
        take oxDNA1 and oxDNA2 (ops.tiles.ERR_UNSUPPORTED_MODEL for another
        family). Without it, every state runs through the energy's own
        pairs: its pair list, dense mask or block table (the block sums).
        """
        from mythos_tpu_torch.rigid_body import RigidBody

        if self.map_neighbors is None:
            return torch.stack([self(RigidBody(c, q)) for c, q in zip(states.center, states.orientation, strict=True)])
        from mythos_tpu_torch.ops import tiles
        from mythos_tpu_torch.soa import BodySoA, Quat, Vec3

        nbl = self.map_neighbors
        ctxs = tiles.prepare_contexts(self, nbl.idx, nbl.block_size, perm=nbl.perm)
        out = []
        for c, q in zip(states.center, states.orientation, strict=True):
            ids, overflow = nbl.build(c)
            e = tiles.fused_energy_ctx(self, ctxs, BodySoA(Vec3(*c.unbind(-1)), Quat(*q.unbind(-1))), ids)
            out.append(torch.where(overflow, torch.full_like(e, torch.nan), e))
        return torch.stack(out)
