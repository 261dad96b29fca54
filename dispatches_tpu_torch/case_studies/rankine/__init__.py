"""Simple Rankine cycle case study (port of
`dispatches_tpu/case_studies/rankine/`)."""

from .flowsheet import (
    RankineSpec,
    RankineState,
    capital_cost_musd,
    solve_rankine,
    specific_energies,
)
from .stochastic import (
    StochasticResult,
    stochastic_optimization_problem,
    surrogate_design_problem,
)
from .surrogate_design import (
    MarketInputBounds,
    conceptual_design_problem_nn,
)
