"""Datasets of the port (port of :mod:`repro.data`): the synthetic
generators matched to the paper's benchmark profiles.  The language-model
token streams come with the LM side."""

from repro_torch.data.synthetic import correlated_vfl_data, kc_house_like, year_prediction_like

__all__ = [
    "year_prediction_like",
    "kc_house_like",
    "correlated_vfl_data",
]
