"""Port parity for Volt training: the small Volt of tests/test_torch_volt.py
(volt-s's shape at dim 32, 2 heads, depth 2, stem 8, fp32) takes one and two
steps of ``make_segmentation_train_step`` with Adam(1e-3) in both packages,
from the same JAX variables carried over by ``volt_variables_to_state_dict``.

JAX runs its own step under jit (segment attention on its ``impl="xla"``
path, differentiated by ``jax.grad``); the port's backward goes through the
``SegmentAttention`` Function's plain route. JAX's gradients are read back
from Adam's first moment (``mu_t = 0.9 mu_{t-1} + 0.1 g_t``). fp32
tolerances: the loss within 1e-5 relative, each gradient within 1e-4 of its
tensor's largest entry; post-step parameters tightly where every step's
gradient is above 1e-4 of its tensor's largest, within 2 lr a step
elsewhere (Adam's first steps move a parameter by about ``lr * sign(g)``)."""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from tests.test_torch_volt import _pair
from warpconvnet_tpu.parallel.train import TrainState
from warpconvnet_tpu.parallel.train import make_segmentation_train_step as jax_train_step
from warpconvnet_tpu_torch.kernels import segment_attention as k9
from warpconvnet_tpu_torch.models.convert import volt_variables_to_state_dict
from warpconvnet_tpu_torch.parallel.train import make_segmentation_train_step

LR = 1e-3
B1 = 0.9
NUM_CLASSES = 5
STEPS = 2


def _run_jax(jmodel, variables, jvox, labels, steps):
    """[(loss, grads tree, state)] after each step."""
    tx = optax.adam(LR)
    params = variables["params"]
    state = TrainState(params, {}, tx.init(params), jnp.zeros((), jnp.int32))
    step = jax_train_step(jmodel, tx, NUM_CLASSES)
    out, mu_prev = [], None
    for _ in range(steps):
        state, metrics = step(state, jvox, jnp.asarray(labels))
        mu = state.opt_state[0].mu
        if mu_prev is None:
            grads = jax.tree_util.tree_map(lambda m: m / (1 - B1), mu)
        else:
            grads = jax.tree_util.tree_map(lambda m, p: (m - B1 * p) / (1 - B1), mu, mu_prev)
        mu_prev = mu
        out.append((float(metrics["loss"]), grads, state))
    return out


def _run_torch(model, vox, labels, steps):
    """[(loss, {name: grad}, {name: param})] after each step, and the
    segment-attention backward calls of the first step."""
    opt = torch.optim.Adam(model.parameters(), lr=LR, betas=(B1, 0.999), eps=1e-8)
    step = make_segmentation_train_step(model, opt, NUM_CLASSES)
    out = []
    for _ in range(steps):
        metrics = step(vox, torch.from_numpy(labels))
        grads = {n: None if p.grad is None else p.grad.detach().clone()
                 for n, p in model.named_parameters()}
        params = {n: p.detach().clone() for n, p in model.named_parameters()}
        out.append((float(metrics["loss"]), grads, params))
    return out


@pytest.fixture(scope="module")
def steps():
    model, tv, jmodel, variables, jv = _pair("volt-s")
    labels = np.random.default_rng(4).integers(0, NUM_CLASSES, tv.coords.shape[:2]).astype(np.int32)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    ref = _run_jax(jmodel, variables, jv, labels, STEPS)
    calls = []
    real = k9.segment_attention_bwd

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    k9.segment_attention_bwd = spy
    try:
        got = _run_torch(model, tv, labels, STEPS)
    finally:
        k9.segment_attention_bwd = real
    return got, ref, start, calls, model


def test_every_step_runs_the_attention_backward(steps):
    """Two layers, two steps: four segment-attention backwards, and
    train mode changes nothing else than the rate-0 DropPath leaves as it
    is."""
    got, _, _, calls, model = steps
    assert len(calls) == 2 * STEPS
    assert model.training and all(b.dp1.rate == 0 for b in model.blocks)


@pytest.mark.parametrize("i", range(STEPS))
def test_loss_matches_jax(steps, i):
    got, ref, _, _, _ = steps
    assert abs(got[i][0] - ref[i][0]) <= 1e-5 * abs(ref[i][0])
    if i:
        assert got[i][0] < got[0][0]  # the step moved downhill


@pytest.mark.parametrize("i", range(STEPS))
def test_every_gradient_matches_jax(steps, i):
    """Every parameter has a gradient (the attention's QKV projection
    included), each within 1e-4 of its tensor's largest JAX entry."""
    got, ref, _, _, _ = steps
    want = volt_variables_to_state_dict({"params": ref[i][1]})
    assert set(want) == set(got[i][1])
    for name, g in got[i][1].items():
        assert g is not None, name
        scale = float(want[name].abs().max())
        assert scale > 0, name
        err = float((g - want[name]).abs().max())
        assert err <= 1e-4 * scale, (name, err, scale)


@pytest.mark.parametrize("i", range(STEPS))
def test_post_step_params_match_jax(steps, i):
    got, ref, start, _, _ = steps
    want = volt_variables_to_state_dict(ref[i][2])
    grads = [volt_variables_to_state_dict({"params": r[1]}) for r in ref[: i + 1]]
    for name, g in grads[0].items():
        p, pj = got[i][2][name], want[name]
        assert not torch.equal(pj, start[name]), name  # the step changed it
        firm = torch.ones_like(g, dtype=torch.bool)
        for gs in grads:
            firm &= gs[name].abs() > 1e-4 * gs[name].abs().max()
        diff = (p - pj).abs()
        assert float(diff[firm].max()) <= 1e-5 + 1e-5 * float(pj.abs().max()), name
        assert float(diff.max()) <= 2 * LR * (i + 1), name


def test_convert_takes_a_post_step_train_state(steps):
    """A JAX TrainState maps to the port's parameters (its optimizer state
    is left out; Volt has no batch statistics) and loads into the model."""
    _, ref, _, _, model = steps
    sd = volt_variables_to_state_dict(ref[-1][2], model)
    model.load_state_dict(sd)
    assert set(sd) == set(model.state_dict())
