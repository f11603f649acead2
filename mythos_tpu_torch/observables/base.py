"""Observable base class.

Counterpart of mythos_tpu/observables/base.py: an observable maps a
trajectory (anything with stacked ``center`` (S, N, 3) and ``orientation``
(S, N, 4)) to per-state values. The duplex-geometry helpers of the
reference are not ported yet.
"""

from __future__ import annotations

import dataclasses as dc
from collections.abc import Callable

ERR_RIGID_BODY_TRANSFORM_FN_REQUIRED = "rigid_body_transform_fn must be provided"


@dc.dataclass(frozen=True)
class BaseObservable:
    """``__call__(trajectory) -> (S,)`` per-state values."""

    rigid_body_transform_fn: Callable

    def __post_init__(self) -> None:
        if self.rigid_body_transform_fn is None:
            raise ValueError(ERR_RIGID_BODY_TRANSFORM_FN_REQUIRED)
