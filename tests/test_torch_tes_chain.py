"""The tube-side chain kernel (`dispatches_tpu_torch/csrc/tes_chain.cu`)
against its plain version on the card. The kernel has no CPU or interpret
mode, so the test skips without a card; the CPU parity of the plain chain
with the JAX package is `tests/test_torch_tes.py`'s. This file imports no
JAX, so it runs on a machine with the card and no JAX.

Run on the card: ``python -m pytest -q -m cuda tests/test_torch_tes_chain.py``.
"""
import numpy as np
import pytest
import torch

from dispatches_tpu_torch.units import concrete_tes as T


@pytest.mark.cuda
def test_kernel_matches_plain_chain_on_card():
    """Reference geometry (20 segments), charge and discharge as two lanes
    of one launch: h_out within 1e-9 of each segment's starting bracket
    width, the weights within 1e-9 wherever both outlets are bitwise equal,
    and the launch counted. (The IF97 sums' order differs, so a bisection
    path may part in its last halvings, where the bracket is narrower than
    an ulp of h: the outlet keeps its bits, the weight moves by ~2^-k.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    d = T.TESDesign()
    walls = torch.tensor(np.linspace(750.0, 420.0, 20), dtype=torch.float64, device="cuda")
    sides = [T._side(d, T.stream_from_pt(*spec), mode) for spec, mode in (
        ((0.00958 * 1000 / 18.01528 * 1e4, 19.6e6, 865.0), "charge"),
        ((3 / 18.01528 * 1e4, 8.5e5, 355.0), "discharge"))]
    tw = torch.stack([walls.flip(-1) if s.reverse else walls for s in sides])
    P = torch.stack([s.P for s in sides]).cuda()
    h_eq = T.steam.enthalpy_pt(P[:, None], tw)
    par = torch.stack([torch.stack([s.h_in0, s.c, s.P, *s.sat]) for s in sides]).cuda()
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
