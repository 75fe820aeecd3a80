"""Datasets of the port (port of :mod:`repro.data`): the synthetic
generators matched to the paper's benchmark profiles, and the language
model's token stream."""

from repro_torch.data.lm import TokenStream, lm_batch
from repro_torch.data.synthetic import correlated_vfl_data, kc_house_like, year_prediction_like

__all__ = [
    "year_prediction_like",
    "kc_house_like",
    "correlated_vfl_data",
    "TokenStream",
    "lm_batch",
]
