"""Double-loop coordinator: wires bidder + trackers to a market host.

Parity with reference `dispatches/workflow/coordinator.py:27-93`: the
coordinator owns a bidder, a tracker, and a projection tracker, pushes static
generator parameters into the market's model dictionaries, and exposes the
market-facing callbacks. Two hosts are supported:

* `SimpleMarket` / `FiveBusMarket` (market/simulator.py) — the in-framework
  deterministic market world used by tests (the analogue of the reference's
  checked-in 5-bus Prescient dataset, `tests/test_prescient.py:55-101`).
* Prescient itself, if importable — `prescient_plugin_module` returns a
  plugin module with `get_configuration`/`register_plugins` like the
  reference's (`coordinator.py:42-44`); gated on the optional dependency.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..obs.journal import get_tracer


class DoubleLoopCoordinator:
    def __init__(self, bidder, tracker, projection_tracker=None):
        self.bidder = bidder
        self.tracker = tracker
        self.projection_tracker = projection_tracker or tracker
        # realized day-ahead results per RUC day, captured after each RUC
        # solve and handed to the real-time bidder (the reference bidder
        # signature: `parametrized_bidder.py:113` takes
        # realized_day_ahead_prices/_dispatches)
        self._da_results = {}  # day -> (prices, dispatches)

    # -- static-parameter push (`coordinator.py:46-87`) ------------------
    def update_static_params(self, gen_dict: dict):
        md = self.bidder.bidding_model_object.model_data
        is_thermal = md.generator_type == "thermal"
        for param, value in md:
            if param == "gen_name" or value is None:
                continue
            if (
                param in gen_dict
                and isinstance(gen_dict[param], dict)
                and gen_dict[param].get("data_type") == "time_series"
            ):
                continue
            if param == "p_cost" and is_thermal:
                from .bidder import convert_marginal_costs_to_actual_costs

                gen_dict[param] = {
                    "data_type": "cost_curve",
                    "cost_curve_type": "piecewise",
                    "values": convert_marginal_costs_to_actual_costs(value),
                }
            else:
                gen_dict[param] = value

    # -- market-host callbacks ------------------------------------------
    # each callback is a journal span so a double-loop run decomposes into
    # per-day DA-bid / RT-bid / tracking wall-clock in the run journal
    def compute_day_ahead_bids(self, day: int, hour: int = 0):
        with get_tracer().span("da_bids", day=day, hour=hour):
            return self.bidder.compute_day_ahead_bids(day, hour)

    def compute_real_time_bids(self, day: int, hour: int, da_prices=None, da_dispatches=None):
        with get_tracer().span(
            "rt_bids", day=day, hour=hour, has_da=da_prices is not None
        ):
            return self.bidder.compute_real_time_bids(day, hour, da_prices, da_dispatches)

    def track_sced_dispatch(self, dispatch, day: int, hour: int):
        with get_tracer().span("track_sced", day=day, hour=hour):
            sol = self.tracker.track_market_dispatch(dispatch, day, hour)
            # solve_event attaches batch_stats + an obs.health verdict to
            # the span, so a double-loop day whose tracking LP stalls is
            # diagnosed in the journal, not just slower
            get_tracer().solve_event("track_sced", sol, day=day, hour=hour)
            return sol

    # -- Prescient interop (optional dependency) -------------------------
    @property
    def prescient_plugin_module(self):
        """A plugin module with `get_configuration`/`register_plugins`,
        matching the surface Prescient's plugin loader consumes and the
        reference's `coordinator.prescient_plugin_module`
        (`dispatches/workflow/coordinator.py:42-44`).

        Constructing and registering the module requires NO prescient
        install: the callbacks duck-type against Egret-style model dicts
        (`md.data['elements']['generator'][name]`), which is also what the
        real Prescient hands to plugin callbacks. Only launching
        `Prescient().simulate(...)` itself needs gridx-prescient."""
        from types import ModuleType

        coordinator = self

        class PluginModule(ModuleType):
            def __init__(self):
                super().__init__("dispatches_tpu_doubleloop_plugin")

            @staticmethod
            def get_configuration(key):
                return {}

            @staticmethod
            def register_plugins(context, options, plugin_config):
                # mirror of the reference coordinator's registration set
                # (`dispatches/workflow/coordinator.py:29-41`): static-param
                # push before both market solves, DA bids before RUC, RT
                # bids before SCED, tracking after operations.
                context.register_before_ruc_solve_callback(
                    coordinator._plugin_before_ruc_solve
                )
                context.register_after_ruc_generation_callback(
                    coordinator._plugin_after_ruc_generation
                )
                context.register_before_operations_solve_callback(
                    coordinator._plugin_before_operations_solve
                )
                context.register_after_operations_callback(
                    coordinator._plugin_after_operations
                )

        return PluginModule()

    # -- plugin callbacks (Egret-dict duck-typed) ------------------------
    def _participant_gen_dict(self, model) -> Optional[dict]:
        gens = model.data["elements"]["generator"]
        name = self.bidder.bidding_model_object.model_data.gen_name
        return gens.get(name)

    @staticmethod
    def _apply_cost_curve(gen_dict: dict, bid: dict):
        """Write one hour-bid's curve (`{"p_cost": [(mw, $)...]}`, the shape
        ParametrizedBidder emits) into an Egret generator dict. p_max is the
        caller's concern (scalar for SCED, time series for RUC)."""
        gen_dict["p_cost"] = {
            "data_type": "cost_curve",
            "cost_curve_type": "piecewise",
            # plain floats: Egret serializes model dicts to JSON
            # (`egret/data/model_data.py` ModelData round-trip); a numpy
            # scalar leaking in breaks that downstream
            "values": [(float(mw), float(cost)) for mw, cost in bid["p_cost"]],
        }

    @staticmethod
    def _model_n_periods(model) -> Optional[int]:
        """Time-period count of an Egret-shaped model, when discoverable."""
        try:
            keys = model.data["system"]["time_keys"]
        except (AttributeError, KeyError, TypeError):
            return None
        return len(keys) if keys is not None else None

    def _plugin_before_ruc_solve(self, options, simulator, ruc_instance, ruc_date, ruc_hour):
        gen_dict = self._participant_gen_dict(ruc_instance)
        if gen_dict is None:
            return
        self.update_static_params(gen_dict)
        day = _date_to_day(ruc_date)
        hour0 = int(ruc_hour or 0)
        bids = self.compute_day_ahead_bids(day, hour0)  # {abs_hour: {gen: bid}}
        name = self.bidder.bidding_model_object.model_data.gen_name
        hours = sorted(bids)
        # per-hour bid curves -> time-varying p_max series + first-hour curve
        # (Egret cost curves are static per solve; Prescient re-enters here
        # every RUC, so the curve tracks the forecast day by day)
        self._apply_cost_curve(gen_dict, bids[hours[0]][name])
        pmax_series = [float(bids[h][name]["p_max"]) for h in hours]
        # Egret wants one value per model time period (Prescient's default
        # ruc_horizon is 48 h while bidders often carry 24): cycle the bid
        # day to fill, trim if the bidder over-supplied
        n_periods = self._model_n_periods(ruc_instance)
        if n_periods is not None and len(pmax_series) != n_periods:
            reps = -(-n_periods // len(pmax_series))  # ceil
            pmax_series = (pmax_series * reps)[:n_periods]
        gen_dict["p_max"] = {
            "data_type": "time_series",
            "values": pmax_series,
        }

    def _plugin_after_ruc_generation(
        self, options, simulator, ruc_plan, ruc_date, ruc_hour
    ):
        """Capture realized day-ahead results from the SOLVED RUC: the
        participant's committed dispatch (`pg` time series) and its bus's
        day-ahead LMPs. Handed to `compute_real_time_bids` for the rest of
        the operating day — a parametrized RT bidder prices its tranches
        off the DA award (reference signature:
        `PEM_parametrized_bidder.py:94`)."""
        day = _date_to_day(ruc_date)
        prices = dispatches = None
        # real Prescient hands after_ruc_generation a RucPlan wrapper, not
        # the Egret dict itself — unwrap the deterministic instance (the
        # reference coordinator consumes the same attribute); a bare Egret
        # ModelData (the in-framework host / fixtures) passes through
        ruc_md = getattr(ruc_plan, "deterministic_ruc_instance", ruc_plan)
        try:
            gen_dict = self._participant_gen_dict(ruc_md)
        except (AttributeError, KeyError, TypeError):
            gen_dict = None
        if gen_dict is not None:
            try:
                pg = gen_dict.get("pg")
                if isinstance(pg, dict) and pg.get("data_type") == "time_series":
                    dispatches = [float(v) for v in pg["values"]]
                elif pg is not None:
                    dispatches = [float(pg)]
            except (TypeError, ValueError, KeyError):
                dispatches = None  # degrade like the price block below
        try:
            buses = ruc_md.data["elements"]["bus"]
            bus = self.bidder.bidding_model_object.model_data.bus
            lmp = buses.get(str(bus), {}).get("lmp")
            if isinstance(lmp, dict) and lmp.get("data_type") == "time_series":
                prices = [float(v) for v in lmp["values"]]
        except (AttributeError, KeyError, TypeError):
            pass
        self._da_results[day] = (prices, dispatches)

    def _plugin_before_operations_solve(self, options, simulator, sced_instance):
        gen_dict = self._participant_gen_dict(sced_instance)
        if gen_dict is None:
            return
        self.update_static_params(gen_dict)
        day, hour = _sim_day_hour(simulator)
        da_prices, da_dispatches = self._da_results.get(day, (None, None))
        bids = self.compute_real_time_bids(
            day, hour, da_prices, da_dispatches
        )  # {abs_hour: {gen: bid}}
        name = self.bidder.bidding_model_object.model_data.gen_name
        bid = bids[min(bids)][name]
        self._apply_cost_curve(gen_dict, bid)
        gen_dict["p_max"] = float(bid["p_max"])

    def _plugin_after_operations(self, options, simulator, sced_instance, lmp_sced=None):
        gen_dict = self._participant_gen_dict(sced_instance)
        if gen_dict is None:
            return
        pg = gen_dict.get("pg", 0.0)
        if isinstance(pg, dict):
            dispatch = list(pg["values"])
        else:
            dispatch = [float(pg)]
        day, hour = _sim_day_hour(simulator)
        self.track_sced_dispatch(dispatch, day, hour)


def _date_to_day(date) -> int:
    from .tracker import _date_index

    return _date_index(date)


def _sim_day_hour(simulator):
    """Current (day, hour) from a Prescient-shaped simulator
    (`simulator.time_manager.current_time` with `.date`/`.hour`); plain
    `(day, hour)` tuples pass through for the in-framework host."""
    if isinstance(simulator, tuple):
        return simulator
    tm = getattr(simulator, "time_manager", None)
    ct = getattr(tm, "current_time", None)
    if ct is None:
        return 0, 0
    return _date_to_day(ct.date), int(ct.hour)
