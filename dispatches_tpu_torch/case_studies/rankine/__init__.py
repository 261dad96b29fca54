"""Simple Rankine cycle case study (port of
`dispatches_tpu/case_studies/rankine/`).

The JAX package's `surrogate_design` names (`MarketInputBounds`,
`conceptual_design_problem_nn`) are not exported here: that module embeds
a trained network through `surrogates.embed`, which comes with the
surrogate layer (ROADMAP A6). `surrogate_design_problem` takes any torch
callable as its revenue model.
"""

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
