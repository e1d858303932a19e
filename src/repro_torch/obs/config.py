"""Static observability configuration of the engine's rounds (port of
``repro.obs.config``).

:class:`ObsConfig` is hashable and frozen, as the reference's is. Flipping
``diagnostics`` adds per-round tap ops and record leaves; with
``diagnostics=False`` — the default everywhere — a round issues exactly the
ops it issued before this subsystem existed: no new op, bit-identical
records.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """What the engine's rounds record beyond the base round record.

    diagnostics: compute the cheap per-round scalar taps
      (:class:`repro_torch.core.metrics.RoundDiagnostics` — aggregation
      noise power after reweighting, scheduling-probability entropy,
      eps-guard clamp count, gradient-norm spread) on the device, beside
      the round, and carry them in the records' ``diag`` subtree. Off
      (default): the records and the ops issued are those of the
      uninstrumented engine.
    """

    diagnostics: bool = False


# the default (everything off) — module-level so identity comparisons
# share one object
DEFAULT_OBS = ObsConfig()
