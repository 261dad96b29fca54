"""Market-interaction layer — the analogue of `dispatches/workflow/` +
IDAES grid_integration (bidder/tracker/coordinator) plus the in-framework
production-cost simulators (single-bus merit order and 5-bus DC-OPF).

Port of the JAX package's `market/`, with its export list."""

from .contingency import (
    Contingency,
    ContingencySet,
    ScreenResult,
    SecureDispatch,
    base_operating_point,
    contingency_dcopf_program,
    contingency_params,
    lodf_matrix,
    post_contingency_flows,
    ptdf_matrix,
    screen_contingencies,
    secure_dispatch,
    stack_contingency_lp,
)
from .bidder import (
    BatteryParametrizedBidder,
    ParametrizedBidder,
    PEMParametrizedBidder,
    convert_marginal_costs_to_actual_costs,
)
from .coordinator import DoubleLoopCoordinator
from .double_loop import MultiPeriodWindBattery, MultiPeriodWindPEM
from .forecaster import Backcaster, PerfectForecaster
from .model_data import RenewableGeneratorModelData, ThermalGeneratorModelData
from .network import (
    FIVE_BUS_DIR,
    GridData,
    ProductionCostSimulator,
    UnitCommitment,
    dcopf_program,
    load_rts_format,
    solve_hours,
)
from .simulator import SimpleMarket, StaticGenerator
from .tracker import Tracker
