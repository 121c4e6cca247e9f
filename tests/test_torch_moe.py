"""PyTorch port, the MoE layer: ``models/moe.py::moe_ffn`` against the
JAX package's on the committed fixture (``tests/fixtures/torch_lm_zoo``,
made by its ``make_fixture.py`` from ``tests/torch_lm_zoo_script.py``).

Every case drops pairs and holds a token whose router logits tie.  The
routing (``eidx``), each sorted pair's slot and the drop fraction must be
equal; float32 outputs within rtol 1e-5, bf16 outputs within one bf16 ulp
of the output's largest magnitude (the port's products sum in another
order before the bf16 rounding), the aux loss within 1e-6.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import torch_lm_zoo_script as script
from repro.models import moe as jmoe
from repro_torch.models import moe as tmoe

from test_torch_store_index_edges import one_torch_thread  # noqa: F401

FIXTURE = Path(__file__).parent / "fixtures" / "torch_lm_zoo"


@pytest.fixture(scope="module")
def jax_side():
    meta = json.loads((FIXTURE / "lm_zoo.json").read_text())
    with np.load(FIXTURE / "lm_zoo.npz") as z:
        arrays = {k: z[k] for k in z.files if k.startswith("moe/")}
    return meta, arrays


def bf16_ulp(x: float) -> float:
    """One bf16 ulp at magnitude ``x`` (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(x)) - 7)


def _run(name, k, g, dt):
    inp = script.moe_inputs(name)
    args = [torch.from_numpy(inp[n]).to(getattr(torch, dt))
            for n in ("x", "router_w", "we1", "we3", "we2")]
    return args, tmoe.moe_ffn(*args, top_k=k, groups=g,
                              capacity_factor=script.MOE["capacity_factor"])


def _slots(args, k, g):
    """Each sorted pair's slot (E * C when dropped), per group, as the
    JAX module lays its buffer out."""
    x, router_w = args[0], args[1]
    T, D = x.shape
    E = router_w.shape[-1]
    G = g if g > 1 else 1
    C = tmoe.expert_capacity(T // G, E, k, script.MOE["capacity_factor"])
    _, _, eidx = tmoe._route(x.reshape(G, T // G, D).float(), router_w, k)
    _, e_s, _, rank, keep = tmoe._dispatch(eidx, C)
    return eidx.reshape(T, k), torch.where(keep, e_s * C + rank, E * C)


@pytest.mark.parametrize("name,k,g,dt", script.MOE_CASES,
                         ids=[c[0] for c in script.MOE_CASES])
def test_moe_ffn_matches_jax(jax_side, name, k, g, dt):
    meta, arrays = jax_side
    want = meta["moe"][name]
    args, (y, aux) = _run(name, k, g, dt)
    eidx, slot = _slots(args, k, g)
    assert np.array_equal(eidx.numpy(), arrays[f"moe/{name}/eidx"])
    assert np.array_equal(slot.numpy(), arrays[f"moe/{name}/slot"])
    assert float(aux["drop_frac"]) == want["drop_frac"] > 0
    assert_allclose(float(aux["aux_loss"]), want["aux_loss"], rtol=1e-6)
    assert y.dtype == args[0].dtype and y.shape == args[0].shape
    jy = arrays[f"moe/{name}/y"]
    if dt == "float32":
        assert_allclose(y.numpy(), jy, rtol=1e-5, atol=1e-6)
    else:
        assert np.abs(y.float().numpy() - jy).max() <= \
            bf16_ulp(np.abs(jy).max())


def test_tied_row_takes_the_lower_experts(jax_side):
    """Token TIED (all zeros) has equal probabilities: jax.lax.top_k takes
    experts 0, 1, ... in order, and so must the port."""
    _, arrays = jax_side
    for name, k, g, dt in script.MOE_CASES:
        args, _ = _run(name, k, g, dt)
        eidx, _ = _slots(args, k, g)
        assert eidx[script.TIED].tolist() == list(range(k))
        assert arrays[f"moe/{name}/eidx"][script.TIED].tolist() == \
            list(range(k))


def test_expert_capacity_matches_jax():
    """int(cf * T * k / E) in float order, rounded up to a multiple of 8,
    at least 8."""
    for T in (1, 7, 64, 2048, 4096, 32768):
        for E, k in ((8, 1), (8, 2), (128, 8), (128, 1)):
            for cf in (0.5, 1.0, 1.25, 1.3, 2.0, 16.0):
                assert tmoe.expert_capacity(T, E, k, cf) == \
                    jmoe.expert_capacity(T, E, k, cf), (T, E, k, cf)


def test_group_count_that_does_not_divide_dispatches_globally():
    """groups > 1 with T not a multiple of it, and groups 1, take the
    global dispatch (JAX: the grouped path only when T % groups == 0)."""
    name, k, _, dt = script.MOE_CASES[2]
    inp = script.moe_inputs(name)
    args = [torch.from_numpy(inp[n]) for n in ("x", "router_w", "we1",
                                               "we3", "we2")]
    y0, a0 = tmoe.moe_ffn(*args, top_k=k, groups=0)
    for g in (1, 3, 7):
        y, a = tmoe.moe_ffn(*args, top_k=k, groups=g)
        assert torch.equal(y, y0) and float(a["drop_frac"]) == \
            float(a0["drop_frac"])


def test_bf16_expert_products_have_the_cpu_routes_gradient(monkeypatch):
    """The GPU route's matmul of bf16 operands with a float32 output
    (``_BmmF32``: PyTorch gives ``bmm(out_dtype=)`` no derivative) has the
    CPU route's forward and gradients.  ``out_dtype`` has no CPU kernel,
    so it is emulated here by the float32 product it computes."""
    bmm = torch.bmm

    def emulated(a, b, out_dtype=None):
        return bmm(a.float(), b.float()) if out_dtype else bmm(a, b)
    monkeypatch.setattr(torch, "bmm", emulated)
    g = torch.Generator().manual_seed(3)
    a = torch.randn((3, 5, 4), generator=g).bfloat16().requires_grad_()
    b = torch.randn((3, 4, 6), generator=g).bfloat16().requires_grad_()
    y = tmoe._BmmF32.apply(a, b)
    ct = torch.randn(y.shape, generator=g)
    ga, gb = torch.autograd.grad(y, (a, b), ct)
    a2, b2 = (t.detach().requires_grad_() for t in (a, b))
    y2 = tmoe._bmm_f32(a2, b2)
    ga2, gb2 = torch.autograd.grad(y2, (a2, b2), ct)
    assert y.dtype == torch.float32 and torch.equal(y, y2)
    assert ga.dtype == gb.dtype == torch.bfloat16
    assert torch.equal(ga, ga2) and torch.equal(gb, gb2)
