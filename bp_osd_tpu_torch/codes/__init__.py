"""Quantum and classical code constructions (host-side numpy, construction-time)."""

from .bivariate_bicycle import bivariate_bicycle, gross_code, two_gross_code
from .classical import (
    hamming_code,
    mkmn_16_4_6,
    mkmn_20_5_8,
    mkmn_24_6_10,
    rep_code,
    ring_code,
)
from .code_util import (
    compute_code_parameters,
    compute_exact_code_distance,
    construct_generator_matrix,
)
from .css import css_code
from .hgp import hgp, hgp_single
from .lifted_product import circulant, lifted_hgp, protograph_to_binary
from .spacetime import Spacetime, detection_events, net_data_error, phenomenological
from .stab import gf2_to_gf4, stab_code
from .topological import surface_code, toric_code

__all__ = [
    "rep_code",
    "ring_code",
    "hamming_code",
    "mkmn_16_4_6",
    "mkmn_20_5_8",
    "mkmn_24_6_10",
    "compute_exact_code_distance",
    "compute_code_parameters",
    "construct_generator_matrix",
    "css_code",
    "stab_code",
    "gf2_to_gf4",
    "hgp",
    "hgp_single",
    "lifted_hgp",
    "circulant",
    "protograph_to_binary",
    "bivariate_bicycle",
    "gross_code",
    "two_gross_code",
    "Spacetime",
    "phenomenological",
    "detection_events",
    "net_data_error",
    "surface_code",
    "toric_code",
]
