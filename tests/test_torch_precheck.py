"""The streaming scan's block precheck (``ops.block_precheck``, the plain
version ``ref.block_precheck``) on the CPU against the JAX package's
``repro.core.streaming._block_precheck``.

The state comes from the JAX package (a prefix of the stream ingested
there) and is carried over with ``state_from_arrays``; a block of the rest
of the stream is prechecked by both. Every row the reference marks active
must be active in the port too; the port may replay more (its ``SLACK``
band), and on rows both leave alone the forced-discard counts agree.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import streaming as jstream
from repro.core.matroid import MatroidSpec as JSpec
from repro_torch.core import streaming
from repro_torch.core.matroid import MatroidSpec
from repro_torch.kernels import ops, ref
from test_torch_streaming import KINDS, _instance, _port_ingest

CPU = "cpu"
# (eps, c_const) per variant: the diameter variant's open threshold is
# 2 eps R / (c_const k), which the defaults (0.5, 32) put below every
# distance of these instances, so every row would open
PARAMS = {"radius": (0.5, 32), "diameter": (0.9, 1)}


def _jax_state(P, cats, caps, sp, k, tau, n0, variant):
    spec = JSpec(*sp)
    eps, c_const = PARAMS[variant]
    st = jstream.init_stream_state(P.shape[1], cats.shape[1], spec, k, tau)
    return jstream.ingest_batch(
        st, jnp.asarray(P[:n0]), jnp.asarray(cats[:n0]),
        jnp.ones((n0,), bool), spec,
        None if caps is None else jnp.asarray(caps), k, tau,
        variant=variant, eps=eps, c_const=c_const)


@pytest.mark.parametrize("variant", ["radius", "diameter"])
@pytest.mark.parametrize("kind", KINDS)
def test_block_precheck_matches_jax(kind, variant):
    """Blocks of 64 against the states after 20, 60 and 120 points (young
    states add delegates, later ones mostly skip)."""
    n, B, tau = 300, 64, 6
    eps, c_const = PARAMS[variant]
    P, cats, caps, sp, k = _instance(kind, 10, n)
    caps_arr = (jnp.asarray(caps) if caps is not None
                else jnp.zeros((1,), jnp.int32))
    seen = np.zeros(2, int)  # rows the reference leaves, rows it replays
    checked_z = 0
    for n0 in (20, 60, 120):
        jst = _jax_state(P, cats, caps, sp, k, tau, n0, variant)
        xb, xcb = P[n0:n0 + B], cats[n0:n0 + B]
        vb = np.ones(B, bool)
        vb[::7] = False
        j_active, j_forced = jstream._block_precheck(
            JSpec(*sp), k, caps_arr, variant, eps, c_const, jst,
            jnp.asarray(xb), jnp.asarray(xcb), jnp.asarray(vb))
        j_active, j_forced = np.asarray(j_active), np.asarray(j_forced)

        st = streaming.state_from_arrays(jstream.state_to_arrays(jst),
                                         device=CPU)
        scan = streaming._Scan(st, MatroidSpec(*sp), caps, k, tau, variant,
                               eps, c_const, None)
        active, forced = scan.precheck(torch.as_tensor(xb), xcb, vb)
        assert np.all(active[j_active])
        quiet = ~active & ~j_active
        assert np.array_equal(forced[quiet], j_forced[quiet])
        seen += [int(np.sum(vb & ~j_active)), int(j_active.sum())]

        # the op itself: z is the exact nearest valid center wherever the
        # flag is off; the op's one (2, B) int32 tensor holds z, then the
        # flag as 0 or 1
        x1 = r2 = None
        if variant == "diameter":
            x1, r2 = st.x1, float(np.float32(2.0) * scan.R)
        thr = float(scan._thr_new())
        xt = torch.as_tensor(xb)
        out = ops.block_precheck(xt, st.centers, st.cvalid, x1, thr, r2,
                                 device=CPU)
        assert out.dtype == torch.int32 and out.shape == (2, B)
        assert bool(torch.all((out[1] == 0) | (out[1] == 1)))
        z, flags = out[0], out[1] != 0
        cvalid = np.asarray(jst.cvalid)
        dist = np.linalg.norm(np.asarray(jst.centers)[None] - xb[:, None],
                              axis=2)
        nearest = np.argmin(np.where(cvalid[None], dist, np.inf), axis=1)
        off = ~flags.numpy()
        assert np.array_equal(z.numpy()[off], nearest[off])
        checked_z += int(off.sum())
    assert seen.min() > 0 and checked_z > 0


@pytest.mark.parametrize("variant", ["radius", "diameter"])
@pytest.mark.parametrize("kind", KINDS)
def test_block_precheck_paths_give_the_same_state(kind, variant):
    """The op's plain path over center_precheck's matmul form (force
    "ref") and over its exact oracle (force "exact") give the per-point
    scan's state."""
    n, tau = 200, 4
    P, cats, caps, sp, k = _instance(kind, 11, n)
    base = _port_ingest(P, cats, caps, sp, k, tau, [n], block_size=1,
                        variant=variant)
    for force in ("ref", "exact"):
        st = _port_ingest(P, cats, caps, sp, k, tau, [n], block_size=16,
                          variant=variant, force=force)
        for f in streaming.StreamState._fields:
            assert torch.equal(getattr(base, f), getattr(st, f)), (force, f)


def test_block_precheck_flags_each_boundary():
    """One row per replay rule, from the plain path: a far row (no flag), an
    exact candidate tie, a point past the open threshold, one inside the
    SLACK band of it, and (diameter) past 2 R."""
    c = torch.tensor([[0.0, 0.0], [10.0, 0.0], [10.0, 0.0], [0.0, 50.0]])
    cv = torch.tensor([True, True, True, False])
    x = torch.tensor([[1.0, 0.0], [10.0, 3.0], [0.0, 4.0],
                      [0.0, 2.0 * (1 - ref.SLACK / 2)]])
    z, flags = ops.block_precheck(x, c, cv, None, 2.0, None, device=CPU)
    assert z.tolist() == [0, 1, 0, 0]
    assert flags.tolist() == [0, 1, 1, 1]
    z, flags = ops.block_precheck(x, c, cv, x[0], 100.0, 2.0, device=CPU)
    assert flags.tolist() == [0, 1, 1, 1]  # d(x, x1) > 2 R
    z, flags = ops.block_precheck(x, c, torch.zeros(4, dtype=torch.bool),
                                  None, 2.0, None, force="exact", device=CPU)
    assert z.tolist() == [0, 0, 0, 0] and flags.tolist() == [1, 1, 1, 1]


def test_block_precheck_argument_errors():
    x = torch.zeros(3, 2)
    with pytest.raises(ValueError, match="unknown force"):
        ops.block_precheck(x, x, torch.ones(3, dtype=torch.bool), None, 1.0,
                           None, force="matmul", device=CPU)
    with pytest.raises(ValueError, match="x1 and r2"):
        ops.block_precheck(x, x, torch.ones(3, dtype=torch.bool), x[0], 1.0,
                           None, device=CPU)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.block_precheck(x, x, torch.ones(3, dtype=torch.bool), None, 1.0,
                           None)
