"""Nuclear case study: NPP + PEM + H2 tank + H2 turbine hybrids (port of
`dispatches_tpu/case_studies/nuclear/`)."""

from .flowsheet import NuclearFlowsheetResult, solve_ne_flowsheet
from .multiperiod import MultiPeriodNuclear
from .pricetaker import (
    NuclearPricetakerConfig,
    build_nuclear_pricetaker,
    run_exhaustive_enumeration,
    run_price_taker,
    settlement_prices,
)
from . import conceptual_design
