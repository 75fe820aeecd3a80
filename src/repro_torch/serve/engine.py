"""Deprecated location: the LM decode engine lives in
:mod:`repro_torch.models.lm_serve` (as the reference's moved to
:mod:`repro.models.lm_serve`).

``repro_torch.serve`` is the coreset service namespace; this module stays
as a re-export so imports of the old path keep working.
"""

from repro_torch.models.lm_serve import ServeEngine, make_serve_step

__all__ = ["ServeEngine", "make_serve_step"]
