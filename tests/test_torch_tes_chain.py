"""The tube-side chain kernel (`dispatches_tpu_torch/csrc/tes_chain.cu`).

On the CPU: the kernel's search, a midpoint tree of `levels` halvings a
round, modelled here in torch (T at the tree points through
`steam._t_of_h_pre`, then a walk of the tree with the signs), is bitwise
the serial bisection of `_tes_chain_plain` for levels 1..6 (6 the
kernel's default); the plain
chain's work count, the wrapper's argument checks, and the build tag's
headers. On the card (`cuda` marker; the kernel has no CPU or interpret
mode, so those skip without a card): the kernel against its plain version
and, at every levels, against itself at levels 1. The CPU parity of the plain chain with the
JAX package is `tests/test_torch_tes.py`'s. This file imports no JAX, so
it runs on a machine with the card and no JAX.

Run on the card: ``python -m pytest -q -m cuda tests/test_torch_tes_chain.py``.
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from dispatches_tpu_torch import _nvcc
from dispatches_tpu_torch.units import concrete_tes as T

steam = T.steam
CHARGE = (0.00958 * 1000 / 18.01528 * 1e4, 19.6e6, 865.0)  # `test_concrete_tes.py:49-54`
DISCHARGE = (3 / 18.01528 * 1e4, 8.5e5, 355.0)


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def pass_inputs(walls, specs, design=T.TESDesign(), device="cpu"):
    """The chain's inputs of one fluid pass, one lane a (spec, mode)."""
    walls = torch.as_tensor(walls, dtype=torch.float64, device=device)
    sides = [T._side(design, T.stream_from_pt(*spec), mode) for spec, mode in specs]
    tw = torch.stack([walls.flip(-1) if s.reverse else walls for s in sides]).contiguous()
    P = torch.stack([s.P for s in sides]).to(device)
    h_eq = steam.enthalpy_pt(P[:, None], tw).contiguous()
    par = torch.stack([torch.stack([s.h_in0, s.c, s.P, *s.sat]) for s in sides])
    return tw, h_eq, par.to(device).contiguous()


@pytest.fixture(scope="module")
def seeded():
    """4 segments, a charge and a discharge lane with seeded walls and
    flows; the plain chain's outlets and weights."""
    rng = np.random.default_rng(0)
    walls = np.sort(rng.uniform(420.0, 750.0, 4))[::-1].copy()
    specs = [((CHARGE[0] * rng.uniform(0.5, 2.0), *CHARGE[1:]), "charge"),
             ((DISCHARGE[0] * rng.uniform(0.5, 2.0), *DISCHARGE[1:]), "discharge")]
    inputs = pass_inputs(walls, specs, T.TESDesign(num_segments=4))
    return inputs, T._tes_chain_plain(*inputs)


def tree_chain(t_wall, h_eq, par, levels, bisect_iters=48):
    """The kernel's search in torch: each round takes the 2^depth - 1
    midpoints of its tree in heap order, T at all of them, the signs of f,
    then the serial loop's halvings with those signs."""
    h_in, c, P, Tsat, hf, hg = par.unbind(-1)
    pre_l, pre_v = steam._liquid_pre(P[:, None]), steam._vapor_pre(P[:, None])
    rows = torch.arange(len(h_in))
    outs, weights = [], []
    for s in range(t_wall.shape[-1]):
        tw, he = t_wall[:, s], h_eq[:, s]
        lo, hi = torch.minimum(h_in, he), torch.maximum(h_in, he)
        wl, wh = torch.ones_like(lo), torch.zeros_like(lo)
        for it in range(0, bisect_iters, levels):
            depth = min(levels, bisect_iters - it)
            left, right, pts = lo[:, None], hi[:, None], []
            for _ in range(depth):  # level by level, children left then right
                mid = 0.5 * (left + right)
                pts.append(mid)
                left = torch.stack([left, mid], -1).flatten(-2)
                right = torch.stack([mid, right], -1).flatten(-2)
            pts = torch.cat(pts, -1)
            temp = steam._t_of_h_pre(pre_l, pre_v, pts, Tsat[:, None], hf[:, None],
                                     hg[:, None], T.NEWTON_ITERS)
            neg = pts - h_in[:, None] - c[:, None] * (tw[:, None] - temp) < 0
            node = torch.ones_like(h_in, dtype=torch.long)
            for _ in range(depth):
                mid, wm = 0.5 * (lo + hi), 0.5 * (wl + wh)
                down = neg[rows, node - 1]
                lo, hi = torch.where(down, mid, lo), torch.where(down, hi, mid)
                wl, wh = torch.where(down, wm, wl), torch.where(down, wh, wm)
                node = 2 * node + down.long()
        w = 0.5 * (wl + wh)
        weights.append(torch.where(h_in < he, w, torch.where(h_in > he, 1.0 - w, 0.5)))
        outs.append(0.5 * (lo + hi))
        h_in = outs[-1]
    return torch.stack(outs, -1), torch.stack(weights, -1)


def test_seeded_brackets_cross_the_plateau(seeded):
    (tw, h_eq, par), (h_out, _) = seeded
    h_in = torch.cat([par[:, :1], h_out[:, :-1]], -1)
    lo, hi = torch.minimum(h_in, h_eq), torch.maximum(h_in, h_eq)
    spans = (lo < par[:, 4:5]) & (hi > par[:, 5:6])
    assert spans.any(-1).all(), spans


@pytest.mark.parametrize("levels", [1, 2, 3, 4, 5, 6])
def test_midpoint_tree_is_the_serial_bisection(seeded, levels):
    """h_out and the weights bitwise those of the serial bisection."""
    inputs, (h_ref, a_ref) = seeded
    h_out, a = tree_chain(*inputs, levels)
    assert torch.equal(h_out, h_ref)
    assert torch.equal(a, a_ref)


def test_work_count_follows_the_tree(seeded):
    """`count_levels`: a round a `levels` halvings (the last shorter), its
    points counted by region; at levels 1 every Newton round is one point."""
    inputs, (h_ref, a_ref) = seeded
    S = inputs[0].shape[-1]
    h_out, a, work = T._tes_chain_plain(*inputs, count_levels=(1, 5))
    assert torch.equal(h_out, h_ref) and torch.equal(a, a_ref)
    serial, tree = work[1], work[5]
    assert torch.equal(serial.rounds, torch.full_like(serial.rounds, S * 48))
    assert torch.equal(tree.rounds, torch.full_like(tree.rounds, S * math.ceil(48 / 5)))
    assert torch.equal(serial.region1 + serial.region2, T.NEWTON_ITERS * serial.newton_rounds)
    assert torch.equal(serial.newton_rounds + serial.plateau_halvings,
                       torch.full_like(serial.rounds, S * 48))
    # a round's points include the serial path's, so no fewer Newton steps
    assert torch.all(tree.region1 >= serial.region1) and torch.all(tree.region2 >= serial.region2)
    assert torch.all(tree.newton_rounds <= tree.rounds)
    assert torch.all((tree.region1 + tree.region2) <= T.NEWTON_ITERS * 31 * tree.newton_rounds)


@pytest.mark.parametrize("kw", [dict(levels=0), dict(levels=8), dict(bisect_iters=0)])
def test_wrapper_rejects_bad_search_arguments(seeded, kw):
    inputs, _ = seeded
    with pytest.raises(ValueError):
        T.tes_chain(*inputs, **kw)


def test_wrapper_on_cpu_is_the_plain_chain(seeded):
    inputs, (h_ref, a_ref) = seeded
    for kw in ({}, dict(levels=1), dict(levels=7)):
        h_out, a = T.tes_chain(*inputs, **kw)
        assert torch.equal(h_out, h_ref) and torch.equal(a, a_ref)


def test_levels_range_is_the_kernels():
    """The wrapper's largest `levels` and its default are the kernel's."""
    src = (Path(T.__file__).parent.parent / "csrc" / "tes_chain.cu").read_text()
    assert re.search(r"constexpr int MAX_LEVELS = (\d+);", src).group(1) == str(T.MAX_LEVELS)
    assert 1 <= T.CHAIN_LEVELS <= T.MAX_LEVELS


def test_build_tag_covers_local_headers(tmp_path):
    """A kernel's library is rebuilt when a header it includes changes."""
    (tmp_path / "k.cu").write_text('#include <cuda_runtime.h>\n#include "k.cuh"\n')
    (tmp_path / "k.cuh").write_text("#pragma once\n// one\n")
    before = _nvcc._text(tmp_path / "k.cu")
    (tmp_path / "k.cuh").write_text("#pragma once\n// two\n")
    after = _nvcc._text(tmp_path / "k.cu")
    assert b"// one" in before and b"// two" in after


@pytest.mark.cuda
def test_kernel_matches_plain_chain_on_card():
    """Reference geometry (20 segments), charge and discharge as two lanes
    of one launch: h_out within 1e-9 of each segment's starting bracket
    width, the weights within 1e-9 wherever both outlets are bitwise equal,
    and the launch counted. (The IF97 sums' order differs, so a bisection
    path may part in its last halvings, where the bracket is narrower than
    an ulp of h: the outlet keeps its bits, the weight moves by ~2^-k.)
    At every levels (a cluster of 1 to 8 blocks a lane) the kernel is
    bitwise itself at levels 1, the serial bisection: these brackets cross
    the plateau."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    walls = np.linspace(750.0, 420.0, 20)
    tw, h_eq, par = pass_inputs(walls, [(CHARGE, "charge"), (DISCHARGE, "discharge")],
                                device="cuda")
    n0 = T.tes_chain.launches
    got, a = T.tes_chain(tw, h_eq, par)
    torch.cuda.synchronize()
    assert T.tes_chain.launches == n0 + 1
    ref, a_ref = T._tes_chain_plain(tw, h_eq, par)
    h_in = torch.cat([par[:, :1], ref[:, :-1]], -1)
    width = (h_in - h_eq).abs()
    assert torch.all((got - ref).abs() <= 1e-9 * width + 1e-9)
    same = got == ref
    assert same.any()
    assert torch.all((a[same] - a_ref[same]).abs() <= 1e-9)
    serial = T.tes_chain(tw, h_eq, par, levels=1)
    for levels in range(2, T.MAX_LEVELS + 1):
        h_m, a_m = T.tes_chain(tw, h_eq, par, levels=levels)
        assert torch.equal(h_m, serial[0]) and torch.equal(a_m, serial[1]), levels
