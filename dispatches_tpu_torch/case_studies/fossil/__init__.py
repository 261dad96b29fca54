"""Fossil (ultra-supercritical + supercritical + thermal storage) case
study (port of `dispatches_tpu/case_studies/fossil/`)."""

from . import scpc_nlp, usc_nlp, usc_plant
from .multiperiod import MultiPeriodUsc, build_usc_storage_model, salt_flow_per_mw
from .pricetaker import (
    MOD_RTS_LMP_24,
    TANK_SCENARIOS,
    run_all_tank_scenarios,
    run_pricetaker_analysis,
)
from .superstructure import DesignLeaf, evaluate_leaf, solve_superstructure
