"""Concrete thermal energy storage: ConcreteTES + ConcreteTubeSide (port of
`dispatches_tpu/units/concrete_tes.py`).

Re-design of the reference's `dispatches/unit_models/concrete_tes.py:540-963`
(ConcreteBlock wall-temperature evolution `:258-265`, TubeSideHex
per-segment convective transfer `:436-445`, intra-hour periods `:647-692`,
inter-period continuity `:697-701`, conduction-shape HTC surrogate
`u_tes` `:47-50,704-718`) and of the 1-D tube-side exchanger
`heat_exchanger_tube.py` (ConcreteTubeSide).

Physics (per tube, per segment s, per intra-hour period of length dt):

    Q_s      = U A_s (T_wall_s - T_fluid_out_s)          [fluid heat duty]
    h_out_s  = h_in_s + Q_s / mdot                        [energy balance]
    T_fluid  = T(P, h)  via IF97 (condensing/boiling plateaus included)
    T_wall_s = T_wall_init_s - dt (Q_c_s + Q_d_s) / (rho cp V_s)   [backward
               Euler; charge flows segment 1->S, discharge S->1]

Each period is a damped Gauss-Seidel loop on the wall-temperature vector;
each iterate runs the fluid pass of each side, a chain over the segments
whose segment solves f(h) = h - h_in - (UA/mdot)(T_wall - T(P, h)) = 0 by
a fixed-count bisection.

The fluid pass is split so that only the sequential part is a kernel:

- before it, vectorized over segments in plain torch: the full-equilibration
  enthalpies h_eq = h(P, T_wall) and each side's saturation state;
- the chain (`tes_chain`): on a CUDA tensor the hand-written kernel of
  ``csrc/tes_chain.cu`` (built with nvcc at first use; raises if it cannot
  be built or launched), on a CPU tensor its plain version
  `_tes_chain_plain`. Both sides of a combined-mode pass are two lanes of
  one launch. It returns each segment's outlet enthalpy and its weight
  ``a``, the coefficient of the segment's inlet in the outlet (the
  bisection's gradient: its predicate carries none);
- after it, vectorized: the heat duties q = mdot (h_out - h_in), and the
  outlet temperatures for the final profiles only (the Gauss-Seidel
  iterations read only q).

`_TESChain` (an autograd Function) gives the gradient of the JAX package's
fixed-count bisection: a reverse recurrence over the segments,
dh_out[s] = a[s] dh_in[s] + (1 - a[s]) dh_eq[s], dh_in[s] = dh_out[s-1].
"""
from __future__ import annotations

import ctypes
import dataclasses
import threading
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import _nvcc
from ..properties import steam
from ..properties.steam import MW_H2O as M_WATER  # kg/mol

NEWTON_ITERS = 12  # the fluid pass's T(P, h) inversions (`temperature_ph_fn(P, iters=12)`)


def u_tes(r, k, a, b, xp=torch):
    """Conduction shape factor -> overall HTC (reference `u_tes`,
    `concrete_tes.py:47-50`): tube of inner concrete radius ``a`` centred in
    an annulus of outer radius ``b`` with conductivity ``k``. Pass ``xp=np``
    for host-side (static-geometry) evaluation."""
    zz = r + (
        a**3 * (4 * b**2 - a**2) + a * b**4 * (4 * xp.log(b / a) - 3)
    ) / (4 * k * (b**2 - a**2) ** 2)
    return 1.0 / zz


@dataclasses.dataclass(frozen=True)
class TESDesign:
    """The `model_data` dict of the reference (`concrete_tes.py:621-630`),
    defaults from `test_concrete_tes.py:33-47`."""

    num_tubes: int = 10_000
    num_segments: int = 20
    num_time_periods: int = 2  # intra-hour steps; dt = 3600/n (`:630`)
    tube_length: float = 64.9  # m
    tube_diameter: float = 0.0105664  # m (outer)
    face_area: float = 0.00847  # m^2 concrete cross-section per tube
    therm_cond_concrete: float = 1.0  # W/m/K
    dens_mass_concrete: float = 2240.0  # kg/m^3
    cp_mass_concrete: float = 900.0  # J/kg/K

    @property
    def delta_time(self) -> float:
        return 3600.0 / self.num_time_periods

    @property
    def segment_length(self) -> float:
        return self.tube_length / self.num_segments

    @property
    def htc(self) -> float:
        """HTC surrogate (`concrete_tes.py:704-718`): k reduced by 0.8,
        contact resistance r=1e-4, divided by correction factor 1.31."""
        a = self.tube_diameter / 2.0
        b = float(np.sqrt(self.face_area / np.pi + a**2))
        k = self.therm_cond_concrete * 0.8
        return float(u_tes(1e-4, k, a, b, xp=np)) / 1.31

    @property
    def ua_segment(self) -> float:
        """U * (pi * OD * L_seg) [W/K] (`tube_heat_transfer_eq`, `:436-445`)."""
        return self.htc * np.pi * self.tube_diameter * self.segment_length

    @property
    def seg_heat_capacity(self) -> float:
        """rho * cp * face_area * delta_z [J/K] (`temp_segment_constraint`,
        `:258-265`)."""
        return (
            self.dens_mass_concrete
            * self.cp_mass_concrete
            * self.face_area
            * self.segment_length
        )


class FluidStream(NamedTuple):
    """Inlet spec for one side, TOTAL flow over all tubes (the reference
    divides by num_tubes internally, `concrete_tes.py:787-790`)."""

    flow_mol: torch.Tensor  # mol/s, total
    pressure: torch.Tensor  # Pa
    enth_mol: torch.Tensor  # J/mol


def stream_from_pt(flow_mol, pressure, temperature) -> FluidStream:
    """Build an inlet from (P, T): the `iapws95.htpx` idiom."""
    dev, flow_mol, pressure, temperature = steam._args(flow_mol, pressure, temperature)
    h_mass = steam.enthalpy_pt(pressure, temperature)
    return FluidStream(flow_mol=flow_mol, pressure=pressure, enth_mol=h_mass * M_WATER)


class SegmentProfile(NamedTuple):
    enth_mol: torch.Tensor  # (S,) outlet enthalpy of each segment [J/mol]
    temperature: torch.Tensor  # (S,) fluid outlet temperature [K]
    heat_duty: torch.Tensor  # (S,) fluid heat duty per tube [W] (Q<0: cooling)


# ------------------------------------------------------------ the chain
# the kernel's default halvings a round (`tes_chain`'s `levels`): 63 tree
# points a round on a cluster of 8 blocks a lane, the fastest of the levels
# `chip_smoke.py` plants (c) times on the card (PERF.md §6)
CHAIN_LEVELS = 6
# the largest `levels`, csrc/tes_chain.cu's MAX_LEVELS (a test holds the two
# equal); checked here too, since a CPU tensor never reaches the kernel
MAX_LEVELS = 7


class ChainWork(NamedTuple):
    """The work of one pass of the chain kernel at `levels` halvings a
    round, per lane ((L,) tensors), counted from the data: every round
    evaluates f at the 2^depth - 1 points of its midpoint tree."""

    region1: torch.Tensor  # Newton steps in region 1, over every point evaluated
    region2: torch.Tensor  # the same in region 2
    rounds: torch.Tensor  # rounds over all segments
    newton_rounds: torch.Tensor  # rounds with a point off the plateau
    plateau_halvings: torch.Tensor  # halvings of the rounds with every point on it


def _tree_points(lo, hi, depth):
    """The midpoints a round of `depth` halvings from (lo, hi) may take,
    (L, 2^depth - 1), by the serial loop's own expressions."""
    left, right, mids = lo[:, None], hi[:, None], []
    for _ in range(depth):
        mid = 0.5 * (left + right)
        mids.append(mid)
        left, right = torch.cat([left, mid], -1), torch.cat([mid, right], -1)
    return torch.cat(mids, -1)


@torch.no_grad()
def _tes_chain_plain(t_wall, h_eq, par, bisect_iters: int = 48, count_levels=()):
    """Plain PyTorch version of the chain kernel, the same chain in eager
    ops over the lanes, one halving at a time (the kernel takes `levels` of
    them a round; its results do not depend on that number). t_wall, h_eq:
    (L, S) in walk order; par: (L, 6) per lane (h_in0, c, P, T_sat, h_f,
    h_g). Returns (h_out, a), (L, S); with `count_levels`, also {m:
    ChainWork} for each m in it (a point on the plateau takes no Newton
    step)."""
    h_in, c, P, Tsat, hf, hg = par.unbind(-1)
    zero = torch.zeros_like(h_in, dtype=torch.long)
    work = {m: [zero] * 5 for m in count_levels}
    pre_l, pre_v = steam._liquid_pre(P), steam._vapor_pre(P)
    outs, weights = [], []
    for s in range(t_wall.shape[-1]):
        tw, he = t_wall[:, s], h_eq[:, s]
        lo, hi = torch.minimum(h_in, he), torch.maximum(h_in, he)
        wl, wh = torch.ones_like(lo), torch.zeros_like(lo)
        for it in range(bisect_iters):
            for m, w in work.items():
                if it % m == 0:  # a round starts here
                    depth = min(m, bisect_iters - it)
                    pts = _tree_points(lo, hi, depth)
                    liq, vap = pts <= hf[:, None], pts >= hg[:, None]
                    off = (liq | vap).any(-1)
                    w[:] = [w[0] + NEWTON_ITERS * liq.sum(-1), w[1] + NEWTON_ITERS * vap.sum(-1),
                            w[2] + 1, w[3] + off.long(), w[4] + depth * (~off).long()]
            mid = 0.5 * (lo + hi)
            wm = 0.5 * (wl + wh)
            # T(P, mid) as `steam._t_of_h_pre`, but a region no lane is in
            # is skipped, as the kernel's warps skip it
            liq, vap = mid <= hf, mid >= hg
            T = Tsat
            if bool(liq.any()):
                T = torch.where(liq, steam._t_liquid_pre(pre_l, mid, hf, NEWTON_ITERS), T)
            if bool(vap.any()):
                T = torch.where(vap, steam._t_vapor_pre(pre_v, mid, Tsat, hg, NEWTON_ITERS), T)
            f = mid - h_in - c * (tw - T)
            neg = f < 0
            lo, hi = torch.where(neg, mid, lo), torch.where(neg, hi, mid)
            wl, wh = torch.where(neg, wm, wl), torch.where(neg, wh, wm)
        h_out = 0.5 * (lo + hi)
        w = 0.5 * (wl + wh)
        weights.append(torch.where(h_in < he, w, torch.where(h_in > he, 1.0 - w, 0.5)))
        outs.append(h_out)
        h_in = h_out
    out = torch.stack(outs, -1), torch.stack(weights, -1)
    if count_levels:
        return (*out, {m: ChainWork(*w) for m, w in work.items()})
    return out


_lib = None
_lock = threading.Lock()


def build(verbose: bool = False):
    """Compile ``csrc/tes_chain.cu`` into ``_build/`` (once per source
    content) and return the shared library's path."""
    return _nvcc.build("tes_chain.cu", verbose=verbose)


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.tes_chain_f64.argtypes = [
                *[ctypes.c_void_p] * 5, *[ctypes.c_int] * 4, ctypes.c_void_p,
            ]
            lib.tes_chain_f64.restype = ctypes.c_int
            _lib = lib
    return _lib


def tes_chain(t_wall, h_eq, par, bisect_iters: int = 48, levels: int = CHAIN_LEVELS):
    """The tube-side chain of each lane: (h_out, a), both (L, S) in walk
    order, from t_wall and h_eq (L, S) and par (L, 6) = (h_in0, c, P,
    T_sat, h_f, h_g). CPU tensors take `_tes_chain_plain`; CUDA tensors
    launch the kernel on the current stream (float64, contiguous) or
    raise. `levels` (1..7) is the kernel's halvings a round; the results
    are bitwise the same for every value."""
    if not 1 <= levels <= MAX_LEVELS:
        raise ValueError(f"tes_chain: levels must lie in 1..{MAX_LEVELS}, got {levels}")
    if bisect_iters < 1:
        raise ValueError(f"tes_chain: bisect_iters must be >= 1, got {bisect_iters}")
    if t_wall.device.type == "cpu":
        return _tes_chain_plain(t_wall, h_eq, par, bisect_iters)
    if t_wall.device.type != "cuda":
        raise ValueError(f"tes_chain: unsupported device {t_wall.device}")
    L, S = t_wall.shape
    if h_eq.shape != (L, S) or par.shape != (L, 6):
        raise ValueError(f"tes_chain: t_wall {tuple(t_wall.shape)}, h_eq "
                         f"{tuple(h_eq.shape)}, par {tuple(par.shape)} do not match")
    for name, x in (("t_wall", t_wall), ("h_eq", h_eq), ("par", par)):
        if x.dtype != torch.float64:
            raise TypeError(f"tes_chain: {name} must be float64, got {x.dtype}")
        if x.device != t_wall.device or not x.is_contiguous():
            raise ValueError(f"tes_chain: {name} must be contiguous on {t_wall.device}")
    h_out = torch.empty_like(h_eq)
    a = torch.empty_like(h_eq)
    lib = _library()
    with torch.cuda.device(t_wall.device):
        stream = torch.cuda.current_stream(t_wall.device).cuda_stream
        err = lib.tes_chain_f64(t_wall.data_ptr(), h_eq.data_ptr(), par.data_ptr(),
                                h_out.data_ptr(), a.data_ptr(), L, S, bisect_iters, levels,
                                stream)
    if err != 0:
        raise RuntimeError(f"tes_chain kernel launch failed: cudaError {err}")
    tes_chain.launches += 1
    return h_out, a


tes_chain.launches = 0  # launches of the kernel


class _TESChain(torch.autograd.Function):
    """h_out of the chain, differentiable in the lanes' inlet enthalpy and
    in h_eq as `jax.grad` through the fixed-count bisection is."""

    @staticmethod
    def forward(ctx, h_in0, h_eq, t_wall, lane_par, bisect_iters):
        par = torch.cat([h_in0[:, None], lane_par], -1).contiguous()
        h_out, a = tes_chain(t_wall.contiguous(), h_eq.contiguous(), par, bisect_iters)
        ctx.save_for_backward(a)
        return h_out

    @staticmethod
    def backward(ctx, g_out):
        (a,) = ctx.saved_tensors
        carry = torch.zeros_like(g_out[:, 0])
        g_eq = []
        for s in range(a.shape[-1] - 1, -1, -1):
            G = g_out[:, s] + carry
            g_eq.append((1.0 - a[:, s]) * G)
            carry = a[:, s] * G
        return carry, torch.stack(g_eq[::-1], -1), None, None, None


class _Side(NamedTuple):
    mdot: torch.Tensor  # kg/s per tube
    P: torch.Tensor
    h_in0: torch.Tensor  # J/kg
    c: torch.Tensor  # UA / mdot
    sat: tuple  # (T_sat, h_f, h_g) at P
    reverse: bool  # discharge walks the segments S -> 1


def _side(design: TESDesign, stream: FluidStream, mode: str) -> _Side:
    if mode not in ("charge", "discharge"):
        raise ValueError(f"unknown tube-side mode {mode!r}")
    mdot = stream.flow_mol / design.num_tubes * M_WATER
    P = stream.pressure
    return _Side(mdot, P, stream.enth_mol / M_WATER, design.ua_segment / mdot,
                 steam._sat_hf_hg(P), mode == "discharge")


def _fluid_pass(walls, sides, bisect_iters=48, temperatures=False):
    """One fluid pass of each side against the wall profile, all sides as
    lanes of one chain launch. Returns, per side in segment order, (h_out
    [J/kg], q [W per tube], T_out or None)."""
    dev = walls.device
    tw = torch.stack([walls.flip(-1) if s.reverse else walls for s in sides])
    P = torch.stack([s.P.to(dev) for s in sides])
    h_eq = steam.enthalpy_pt(P[:, None], tw)  # full-equilibration limits
    lane_par = torch.stack([
        torch.stack([s.c, s.P, *s.sat]).to(dev) for s in sides
    ]).detach()
    h_in0 = torch.stack([s.h_in0.to(dev) for s in sides])
    h_out = _TESChain.apply(h_in0, h_eq, tw.detach(), lane_par, bisect_iters)
    h_in = torch.cat([h_in0[:, None], h_out[:, :-1]], -1)
    mdot = torch.stack([s.mdot.to(dev) for s in sides])
    q = mdot[:, None] * (h_out - h_in)
    out = []
    for i, s in enumerate(sides):
        h_i, q_i = h_out[i], q[i]
        t_i = steam._t_of_h(s.P, h_i, *s.sat, NEWTON_ITERS) if temperatures else None
        if s.reverse:
            h_i, q_i = h_i.flip(-1), q_i.flip(-1)
            t_i = t_i.flip(-1) if temperatures else None
        out.append((h_i, q_i, t_i))
    return out


def tube_side_profile(
    design: TESDesign,
    wall_temp: torch.Tensor,
    stream: FluidStream,
    mode: str,
    bisect_iters: int = 48,
) -> SegmentProfile:
    """ConcreteTubeSide: one fluid pass through the tube given wall temps.

    The standalone analogue of `heat_exchanger_tube.py`'s ConcreteTubeSide
    and of TubeSideHex (`concrete_tes.py:425-466`). Charge traverses
    segments 1->S, discharge S->1 (`:391-399`). Each segment solves the
    implicit outlet state f(h) = h - h_in - (UA/mdot)(T_wall - T(P, h)) = 0;
    f is strictly increasing and bracketed by h_in and h(P, T_wall), so the
    fixed-count bisection is robust on the two-phase plateau and at
    near-zero flows. Runs on wall_temp's device."""
    wall_temp = steam._f(wall_temp, steam._dev(wall_temp))
    (h, q, t), = _fluid_pass(wall_temp, [_side(design, stream, mode)], bisect_iters,
                             temperatures=True)
    return SegmentProfile(enth_mol=h * M_WATER, temperature=t, heat_duty=q)


class PeriodResult(NamedTuple):
    wall_temp: torch.Tensor  # (S,) end-of-period concrete temperature
    heat_rate: torch.Tensor  # (S,) concrete heat rate per tube [W], + = charging
    charge: Optional[SegmentProfile]
    discharge: Optional[SegmentProfile]


def tes_period(
    design: TESDesign,
    wall_init: torch.Tensor,
    charge: Optional[FluidStream] = None,
    discharge: Optional[FluidStream] = None,
    gs_iters: int = 30,
    damping: float = 0.7,
) -> PeriodResult:
    """One intra-hour period: implicit wall/fluid coupling.

    Damped Gauss-Seidel on the wall vector; each iterate re-runs the fluid
    pass of each side (both sides in one chain launch). The contraction
    factor is dt*UA/(rho cp V) ~ 0.25 at the reference geometry, so 30
    iterations converge far below solver tolerance. Mirrors
    `heat_balance_constraints` + `temp_segment_constraint` +
    `temperature_equality_constraints_*` (`concrete_tes.py:675-692,258-265`)."""
    wall_init = steam._f(wall_init, steam._dev(wall_init))
    dt = design.delta_time
    cap = design.seg_heat_capacity
    zeros = torch.zeros_like(wall_init)
    modes = [m for m, s in (("charge", charge), ("discharge", discharge)) if s is not None]
    sides = [_side(design, s, m) for m, s in (("charge", charge), ("discharge", discharge))
             if s is not None]

    def net_q(passes):
        q = {m: p[1] for m, p in zip(modes, passes)}
        return q.get("charge", zeros) + q.get("discharge", zeros)

    walls = wall_init
    for _ in range(gs_iters):
        q = net_q(_fluid_pass(walls, sides)) if sides else zeros
        w_new = wall_init - dt * q / cap
        walls = (1.0 - damping) * walls + damping * w_new
    passes = _fluid_pass(walls, sides, temperatures=True) if sides else []
    prof = {m: SegmentProfile(enth_mol=h * M_WATER, temperature=t, heat_duty=q)
            for m, (h, q, t) in zip(modes, passes)}
    q_net = net_q(passes) if sides else zeros
    walls = wall_init - dt * q_net / cap  # exact final update
    return PeriodResult(wall_temp=walls, heat_rate=-q_net,
                        charge=prof.get("charge"), discharge=prof.get("discharge"))


class TESHourResult(NamedTuple):
    wall_temp: torch.Tensor  # (P, S) per period
    heat_rate: torch.Tensor  # (P, S)
    charge_temp: Optional[torch.Tensor]  # (P, S) fluid temps
    charge_enth_mol: Optional[torch.Tensor]  # (P, S)
    discharge_temp: Optional[torch.Tensor]
    discharge_enth_mol: Optional[torch.Tensor]
    outlet_charge: Optional[FluidStream]
    outlet_discharge: Optional[FluidStream]


class ConcreteTES:
    """The assembled unit (`concrete_tes.py:540-800`): num_time_periods
    chained periods with inter-period wall-temperature continuity
    (`initial_temperature_constraints`, `:697-701`). ``mode`` is 'charge',
    'discharge', or 'combined'. :meth:`hour` advances one hour from an
    initial wall profile, on that profile's device (the streams' tensors
    must lie there or on the CPU)."""

    def __init__(self, design: TESDesign = TESDesign(), mode: str = "charge"):
        if mode not in ("charge", "discharge", "combined"):
            raise ValueError(f"unknown operating mode {mode!r}")
        self.design = design
        self.mode = mode

    def hour(
        self,
        wall_init,
        charge: Optional[FluidStream] = None,
        discharge: Optional[FluidStream] = None,
    ) -> TESHourResult:
        use_c = self.mode in ("charge", "combined")
        use_d = self.mode in ("discharge", "combined")
        if use_c and charge is None:
            raise ValueError(f"mode {self.mode!r} requires a charge stream")
        if use_d and discharge is None:
            raise ValueError(f"mode {self.mode!r} requires a discharge stream")
        walls = steam._f(wall_init, steam._dev(wall_init))
        rows = []
        for _ in range(self.design.num_time_periods):
            res = tes_period(self.design, walls, charge=charge if use_c else None,
                             discharge=discharge if use_d else None)
            rows.append(res)
            walls = res.wall_temp

        def stacked(get):
            return torch.stack([get(r) for r in rows])

        ch = stacked(lambda r: r.charge.enth_mol) if use_c else None
        dh = stacked(lambda r: r.discharge.enth_mol) if use_d else None
        return TESHourResult(
            wall_temp=stacked(lambda r: r.wall_temp),
            heat_rate=stacked(lambda r: r.heat_rate),
            charge_temp=stacked(lambda r: r.charge.temperature) if use_c else None,
            charge_enth_mol=ch,
            discharge_temp=stacked(lambda r: r.discharge.temperature) if use_d else None,
            discharge_enth_mol=dh,
            outlet_charge=FluidStream(charge.flow_mol, charge.pressure, ch[-1, -1])
            if use_c else None,
            # discharge flows S -> 1, so its outlet is segment 1 (profile
            # index 0) (`concrete_tes.py:462-466`)
            outlet_discharge=FluidStream(discharge.flow_mol, discharge.pressure, dh[-1, 0])
            if use_d else None,
        )
