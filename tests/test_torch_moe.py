"""CPU parity of the port's MoE FFN (``repro_torch.models.moe``) with the
JAX package's (``repro.models.moe``), f32: outputs, aux, routes, kept
masks, slots and gradients.

The JAX ``moe_init`` draws the weights and the same numpy inputs go to
both. The routes (top-k experts, slot positions, kept mask) of the JAX
side are the reference's own lines (src/repro/models/moe.py:46-56) on the
same inputs; they must equal the port's exactly. y within 1e-4 of its
largest entry (TOL_F32 of tests/test_torch_models.py), aux within 1e-6
relative, gradients within 1e-4 relative L2 of JAX's, or of the f64
gradient (the same function in float64) and no farther from it than
JAX's: with top-1 routing the gate is p / p, whose derivative cancels to
rounding noise in f32, and that noise alone sets the router's gradient
apart.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models.moe import moe_apply as jax_moe_apply
from repro.models.moe import moe_init as jax_moe_init
from repro_torch.models.moe import capacity, moe_apply, moe_init, moe_route

B, S, D, F_ = 3, 16, 32, 48
TOL_F32 = 1e-4
KEYS = ("router", "w_gate", "w_in", "w_out")


def _weights(E, seed=0, zero_router=False):
    jp = jax_moe_init(jax.random.PRNGKey(seed), D, F_, E, jnp.float32)
    if zero_router:
        jp["router"] = jnp.zeros_like(jp["router"])
    return jp, {k: torch.as_tensor(np.array(v)) for k, v in jp.items()}


def _x(seed=1, batch=B):
    return np.random.default_rng(seed).standard_normal(
        (batch, S, D), dtype=np.float32)


def _jax_route(x, router, top_k, cf):
    """The reference's routing lines (moe.py:43-56) on the same inputs."""
    E = router.shape[1]
    cap = max(1, int(S * top_k * cf / E + 0.999))
    probs = jax.nn.softmax(jnp.asarray(x) @ router, axis=-1)
    gate, eidx = jax.lax.top_k(probs, top_k)
    flat_e = eidx.reshape(x.shape[0], S * top_k)
    onehot = jax.nn.one_hot(flat_e, E, dtype=jnp.int32)
    pos = jnp.sum((jnp.cumsum(onehot, axis=1) - onehot) * onehot, axis=-1)
    return dict(eidx=np.asarray(eidx), pos=np.asarray(pos),
                keep=np.asarray(pos < cap), cap=cap)


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-30))


CASES = [(k, E, cf) for k in (1, 2) for E in (4, 8) for cf in (0.5, 1.25, 4.0)]


@pytest.mark.parametrize("top_k,E,cf", CASES)
def test_moe_apply_matches_jax(top_k, E, cf):
    jp, p = _weights(E)
    x = _x()
    want_y, want_aux = jax_moe_apply(jnp.asarray(x), jp, top_k=top_k,
                                     capacity_factor=cf)
    y, aux = moe_apply(torch.as_tensor(x), p, top_k=top_k,
                       capacity_factor=cf)
    assert y.shape == (B, S, D) and y.dtype == torch.float32
    assert aux.shape == () and aux.dtype == torch.float32
    assert _rel(y, want_y) < TOL_F32
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)
    r = moe_route(torch.as_tensor(x), p["router"], top_k=top_k,
                  capacity_factor=cf)
    jr = _jax_route(x, jp["router"], top_k, cf)
    assert r.cap == jr["cap"] == capacity(S, top_k, cf, E)
    np.testing.assert_array_equal(r.eidx.numpy(), jr["eidx"])
    np.testing.assert_array_equal(r.pos.numpy(), jr["pos"])
    np.testing.assert_array_equal(r.keep.numpy(), jr["keep"])
    dropped = int((~r.keep).sum())
    if cf == 4.0:  # the reduced configs' factor: dropless
        assert dropped == 0
    if cf == 0.5:  # under one slot a choice: some must drop
        assert dropped > 0


@pytest.mark.parametrize("top_k", [1, 2])
def test_zero_router_ties_pick_the_lowest_experts(top_k):
    """Every probability equal: ``lax.top_k`` picks experts 0..k-1, and
    so must the port (``torch.topk`` picks others on the CPU); the slots
    and drops follow."""
    E = 8
    jp, p = _weights(E, zero_router=True)
    x = _x()
    r = moe_route(torch.as_tensor(x), p["router"], top_k=top_k,
                  capacity_factor=1.25)
    want = np.broadcast_to(np.arange(top_k), (B, S, top_k))
    np.testing.assert_array_equal(r.eidx.numpy(), want)
    jr = _jax_route(x, jp["router"], top_k, 1.25)
    np.testing.assert_array_equal(jr["eidx"], want)
    np.testing.assert_array_equal(r.pos.numpy(), jr["pos"])
    np.testing.assert_array_equal(r.keep.numpy(), jr["keep"])
    want_y, want_aux = jax_moe_apply(jnp.asarray(x), jp, top_k=top_k,
                                     capacity_factor=1.25)
    y, aux = moe_apply(torch.as_tensor(x), p, top_k=top_k,
                       capacity_factor=1.25)
    assert _rel(y, want_y) < TOL_F32
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)


@pytest.mark.parametrize("top_k,cf", [(1, 0.5), (2, 1.25), (2, 4.0)])
def test_moe_gradients_match_jax_vjp(top_k, cf):
    """The gradients of x and of every weight for a random cotangent of y
    and of aux, against ``jax.vjp``; dropped tokens included."""
    E = 4
    jp, p = _weights(E, seed=2)
    x = _x(seed=3)
    rng = np.random.default_rng(4)
    dy = rng.standard_normal((B, S, D), dtype=np.float32)
    daux = np.float32(rng.standard_normal())

    def f(xx, pp):
        return jax_moe_apply(xx, pp, top_k=top_k, capacity_factor=cf)

    _, vjp = jax.vjp(f, jnp.asarray(x), jp)
    jdx, jdp = vjp((jnp.asarray(dy), jnp.asarray(daux)))

    def port(dtype):
        xt = torch.as_tensor(x).to(dtype).requires_grad_(True)
        pt = {k: v.to(dtype).requires_grad_(True) for k, v in p.items()}
        y, aux = moe_apply(xt, pt, top_k=top_k, capacity_factor=cf)
        return [g.numpy() for g in torch.autograd.grad(
            (y, aux), [xt] + [pt[k] for k in KEYS],
            (torch.as_tensor(dy).to(dtype), torch.as_tensor(daux).to(dtype)))]

    def rel(a, b):
        return np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30)

    wants = [np.asarray(jdx)] + [np.asarray(jdp[k]) for k in KEYS]
    truth = port(torch.float64)
    for name, g, w, t in zip(("x",) + KEYS, port(torch.float32), wants,
                             truth):
        assert g.dtype == np.float32 and tuple(g.shape) == w.shape, name
        if rel(g, w) > 1e-4:
            mine, theirs = rel(g, t), rel(w, t)
            print(f"{name}: {rel(g, w):.2e} from JAX's; from f64 "
                  f"{mine:.2e} (port) and {theirs:.2e} (JAX)")
            assert mine <= 1e-4 and mine <= theirs, (name, mine, theirs)


@pytest.mark.parametrize("top_k,cf", [(1, 1.25), (2, 0.5)])
def test_a_row_routes_alone_as_in_a_batch(top_k, cf):
    """Groups are batch rows: a row's output, routes and drops are the same
    alone and in a batch (the aux, a batch mean, is not)."""
    _, p = _weights(8, seed=5)
    x = torch.as_tensor(_x(seed=6))
    y, _ = moe_apply(x, p, top_k=top_k, capacity_factor=cf)
    r = moe_route(x, p["router"], top_k=top_k, capacity_factor=cf)
    for b in range(B):
        yb, _ = moe_apply(x[b:b + 1], p, top_k=top_k, capacity_factor=cf)
        rb = moe_route(x[b:b + 1], p["router"], top_k=top_k,
                       capacity_factor=cf)
        torch.testing.assert_close(yb[0], y[b], rtol=1e-6, atol=1e-6)
        assert torch.equal(rb.keep[0], r.keep[b])
        assert torch.equal(rb.pos[0], r.pos[b])


def test_moe_init_specs_match_jax():
    """Shapes and dtypes of ``moe_init`` as the reference's (the router f32
    in a bf16 tree), with the expert axis drawn one expert at a time."""
    jp = jax_moe_init(jax.random.PRNGKey(0), D, F_, 4, jnp.bfloat16)
    specs = moe_init(D, F_, 4, torch.bfloat16)
    assert sorted(specs) == sorted(jp)
    for k, s in specs.items():
        assert s.shape == jp[k].shape, k
        assert str(s.dtype).split(".")[-1] == jp[k].dtype.name, k
    assert specs["router"].dtype == torch.float32
    assert specs["w_in"].lead == 1 and specs["router"].lead == 0


def test_replayed_routes_change_nothing_when_equal():
    """``moe_route(eidx=...)`` given the route's own choice gives the same
    route: gates, slots and drops follow from the experts alone."""
    _, p = _weights(4, seed=7)
    x = torch.as_tensor(_x(seed=8))
    r = moe_route(x, p["router"], top_k=2, capacity_factor=0.5)
    again = moe_route(x, p["router"], top_k=2, capacity_factor=0.5,
                      eidx=r.eidx)
    for a, b in zip(r[:-1], again[:-1]):
        assert torch.equal(a, b)
