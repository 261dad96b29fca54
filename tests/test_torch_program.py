"""Port parity: the PyTorch package's program lowering and instantiation
(`dispatches_tpu_torch/core/program.py`) against the JAX package's.

The same flagship design (wind + battery + PEM, design variables free) is
built by both packages' builders and instantiated from the same numpy
parameters: the LP arrays agree to 1e-12 relative (in practice bit for
bit) and the content fingerprints are equal.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dispatches_tpu.case_studies.renewables import params as JP
from dispatches_tpu.case_studies.renewables.pricetaker import (
    HybridDesign as JHybridDesign,
    build_pricetaker as j_build,
)
from dispatches_tpu.core.program import lp_fingerprint as j_fingerprint
from dispatches_tpu_torch.case_studies.renewables.pricetaker import (
    HybridDesign,
    build_pricetaker,
)
from dispatches_tpu_torch.core.program import lp_fingerprint
from dispatches_tpu_torch.convert import lp_from_numpy

DATA = JP.load_rts303()
DESIGN = dict(
    with_battery=True, with_pem=True, design_opt=True,
    h2_price_per_kg=2.5, initial_soc_fixed=None,
)


def _both(T):
    jprog, _ = j_build(JHybridDesign(T=T, **DESIGN))
    tprog, _ = build_pricetaker(HybridDesign(T=T, **DESIGN))
    p = {"lmp": DATA["da_lmp"][:T], "wind_cf": DATA["da_wind_cf"][:T]}
    return jprog, tprog, p


@pytest.mark.parametrize("T", [48, 168])
def test_instantiate_matches_jax(T):
    jprog, tprog, p = _both(T)
    assert tprog.fingerprint() == jprog.fingerprint()
    jlp = jprog.instantiate({k: jnp.asarray(v) for k, v in p.items()})
    tlp = tprog.instantiate(p, device="cpu")
    for name, a, b in zip(jlp._fields, jlp, tlp):
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape, name
        fin = np.isfinite(a)
        assert np.array_equal(fin, np.isfinite(b)), name
        np.testing.assert_allclose(b[fin], a[fin], rtol=1e-12, atol=0, err_msg=name)
        assert np.array_equal(a[~fin], b[~fin]), name
    assert lp_fingerprint(tlp) == j_fingerprint(jlp)
    # the converted JAX problem hashes the same as the JAX original
    assert lp_fingerprint(lp_from_numpy([np.asarray(a) for a in jlp], device="cpu")) == (
        j_fingerprint(jlp)
    )
    assert lp_fingerprint(tlp, {"tol": 1e-8}) != lp_fingerprint(tlp)


def test_batched_params_and_eval_expr():
    """Leading batch axes on a parameter batch every parametric field, lane
    by lane equal to the unbatched instantiation; `eval_expr` and
    `extract` evaluate batched solutions like the JAX package's."""
    jprog, tprog, p = _both(48)
    scales = np.array([0.5, 1.0, 1.7])
    lmps = scales[:, None] * p["lmp"][None, :]
    batched = tprog.instantiate({"lmp": lmps, "wind_cf": p["wind_cf"]}, device="cpu")
    assert batched.A.shape == (3, tprog.M, tprog.N)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, tprog.N))
    got = tprog.eval_expr(
        "NPV", torch.as_tensor(x), {"lmp": lmps, "wind_cf": p["wind_cf"]}
    ).numpy()
    for i in range(3):
        one = tprog.instantiate({"lmp": lmps[i], "wind_cf": p["wind_cf"]}, device="cpu")
        for a, b in zip(one, batched):
            np.testing.assert_array_equal(a.numpy(), b[i].numpy() if b.dim() > a.dim() else b.numpy())
        pi = {"lmp": jnp.asarray(lmps[i]), "wind_cf": jnp.asarray(p["wind_cf"])}
        want = float(jprog.eval_expr("NPV", jnp.asarray(x[i]), pi))
        assert got[i] == pytest.approx(want, rel=1e-12)
        np.testing.assert_allclose(
            tprog.extract("battery.soc", torch.as_tensor(x[i])).numpy(),
            np.asarray(jprog.extract("battery.soc", jnp.asarray(x[i]))),
            rtol=0, atol=0,
        )


def _sequential_scatter_add(a, idx, vals):
    """The scatter-add before its sum order was fixed: one
    ``index_put_(accumulate=True)``, which on the CPU adds the entries in
    order (a sequential sum per index)."""
    idx = torch.as_tensor(np.asarray(idx, np.int64))
    if idx.numel() == 0:
        return a
    lead, n = a.shape[:-1], a.shape[-1]
    nb = int(np.prod(lead)) if lead else 1
    vals = torch.broadcast_to(vals, (*lead, idx.numel())).reshape(-1)
    flat = (torch.arange(nb)[:, None] * n + idx[None, :]).reshape(-1)
    a.reshape(-1).index_put_((flat,), vals, accumulate=True)
    return a


def _scatter_site(site, scatter):
    """(result tensors, gradient) of one scatter-add site, computed with
    `scatter` in place of the port's `_scatter_add`."""
    from dispatches_tpu_torch.core import program
    from dispatches_tpu_torch.solvers import structured

    saved = program._scatter_add
    program._scatter_add = structured._scatter_add = scatter
    try:
        rng = np.random.default_rng(7)
        if site == "scatter":
            # repeats and singletons mixed, magnitudes over 16 decades, onto
            # a nonzero batched base
            idx = rng.integers(0, 40, 500)
            base = torch.as_tensor(rng.normal(size=(3, 50)), dtype=torch.float64)
            vals = torch.as_tensor(rng.normal(size=(3, 500)) * 10.0 ** rng.uniform(-8, 8, 500))
            vals.requires_grad_(True)
            out = program._scatter_add(base.clone(), idx, vals)
            grad = torch.autograd.grad((out * torch.arange(50.0)).sum(), vals)[0]
            return [out.detach()], grad
        _, tprog, p = _both(48)
        lmp = torch.as_tensor(rng.uniform(0.5, 2.0, (3, 1)) * p["lmp"][None, :])
        lmp.requires_grad_(True)
        params = {"lmp": lmp, "wind_cf": p["wind_cf"]}
        if site == "instantiate":
            meta = structured.extract_time_structure(tprog, 48, block_hours=24)
            dense = tprog.instantiate(params, device="cpu")
            banded = meta.instantiate(params, device="cpu")
            grad = torch.autograd.grad(dense.c.sum() + banded.c.sum(), lmp)[0]
            return [f.detach() for f in (*dense, *banded)], grad
        x = torch.as_tensor(rng.normal(size=(3, tprog.N)))
        npv = tprog.eval_expr("NPV", x, params)
        return [npv.detach()], torch.autograd.grad(npv.sum(), lmp)[0]
    finally:
        program._scatter_add = structured._scatter_add = saved


@pytest.mark.parametrize("site", ["scatter", "instantiate", "eval_expr"])
def test_fixed_order_scatter_add_is_the_sequential_cpu_sum(site):
    """The fixed-order `_scatter_add` (repeated indices folded on the host
    in entry order, so a card gives the CPU's bits) equals the sequential
    CPU scatter it replaced, bit for bit, and so do its gradients: on a
    raw scatter, the dense and banded `instantiate`, and
    ``eval_expr("NPV")``, all over a batch of 3."""
    from dispatches_tpu_torch.core.program import _scatter_add

    want, want_g = _scatter_site(site, _sequential_scatter_add)
    got, got_g = _scatter_site(site, _scatter_add)
    assert len(got) == len(want)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.nan_to_num(posinf=0.0), b.nan_to_num(posinf=0.0))
        assert torch.equal(a.isinf(), b.isinf())
    assert torch.equal(want_g, got_g)
