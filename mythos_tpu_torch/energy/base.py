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

    Subclasses list ``required_params`` and ``dependent_params`` and
    implement :meth:`derive` (the dependent values from the required ones).
    Values are tensors (or plain Python values for flags).
    """

    required_params: tuple[str, ...] = ()
    non_optimizable_required_params: tuple[str, ...] = ()
    dependent_params: tuple[str, ...] = ()
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
        return cls.required_params + cls.dependent_params

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
    opt_params: dict, device: torch.device | str = "cpu", dtype: torch.dtype = torch.float32
) -> dict[str, torch.Tensor]:
    """Carry the JAX package's ``opt_params()`` across, leaf by leaf.

    Input: the dict with every leaf passed through ``np.asarray``. Output:
    the same names as tensors of ``dtype`` on ``device``; feed it to the
    port's ``with_params``, which re-derives the dependent parameters.
    """
    return {k: torch.as_tensor(np.array(v), dtype=dtype, device=device) for k, v in opt_params.items()}


class BaseEnergyFunction:
    """One energy term bound to a topology.

    ``compute_energy(nucleotide)`` evaluates the term over the topology's
    pair lists (bonded pairs, or every unbonded i<j pair): the small-system
    reference path the stencil kernels are held against.
    """

    def __init__(self, params: BaseConfiguration, topology, transform_fn: Callable) -> None:
        self.params = params
        self.topology = topology
        self.transform_fn = transform_fn

    @property
    def seq(self) -> np.ndarray:
        return np.asarray(self.topology.seq)

    @property
    def bonded_neighbors(self) -> np.ndarray:
        return np.asarray(self.topology.bonded_neighbors)

    def opt_params(self) -> dict:
        return self.params.opt_params

    def with_params(self, **values) -> "BaseEnergyFunction":
        new = copy.copy(self)
        new.params = (self.params | values).init_params()
        return new

    def compute_energy(self, nucleotide) -> torch.Tensor:
        raise NotImplementedError


class ComposedEnergyFunction:
    """Weighted sum of energy terms sharing one parameter namespace."""

    def __init__(self, energy_fns: list[BaseEnergyFunction], weights: torch.Tensor | None = None) -> None:
        if weights is not None and len(weights) != len(energy_fns):
            raise ValueError(ERR_COMPOSED_ENERGY_FN_LEN_MISMATCH)
        self.energy_fns = list(energy_fns)
        self.weights = weights

    def opt_params(self) -> dict:
        return {k: v for fn in self.energy_fns for k, v in fn.opt_params().items()}

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
        return ComposedEnergyFunction(fns, self.weights)

    def term_weights(self) -> list:
        return [1.0 if self.weights is None else self.weights[i] for i in range(len(self.energy_fns))]

    def compute_terms(self, body) -> torch.Tensor:
        """Each member's energy on the pair-list path (transforms shared)."""
        cache: dict[int, object] = {}
        vals = []
        for fn in self.energy_fns:
            key = id(fn.transform_fn)
            if key not in cache:
                cache[key] = fn.transform_fn(body)
            vals.append(fn.compute_energy(cache[key]))
        return torch.stack(vals)

    def __call__(self, body) -> torch.Tensor:
        vals = self.compute_terms(body)
        return vals.sum() if self.weights is None else (self.weights * vals).sum()
