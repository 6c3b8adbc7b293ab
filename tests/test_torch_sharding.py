"""The port's PartitionSpec rules against the JAX package's, and their
placement on a mesh.

For every arch of ``ARCH_IDS``, full and reduced: ``param_specs`` (tp
None and "model", FSDP over ("data",) and ("pod", "data")) equal the
reference's leaf for leaf, keyed by the checkpoint's path names;
``cache_specs`` for every mode and both batch rules, and ``batch_spec``,
likewise. ``P`` compares as ``jax.sharding.PartitionSpec`` does.
``constrain`` is the identity that checks rank. ``shard_tree`` then
``gather_tree`` gives the tree back bit for bit (FSDP and FSDP x TP
specs, 1-D and 2-D meshes); an uneven split raises, naming the leaf. The
mesh's new collectives (all-gather along a dim, sum, reduce-scatter)
against direct sums.
"""
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import get_config as jax_get_config
from repro.models import LM as JLM
from repro.models import sharding as jsh
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import make_mesh
from repro_torch.models import LM
from repro_torch.models import sharding as sh
from repro_torch.models.model import tree_leaves
from repro_torch.models.sharding import P

FSDPS = [("data",), ("pod", "data")]


def _cfg(get, arch, reduced):
    cfg = get(arch)
    return cfg.reduced() if reduced else cfg


@functools.lru_cache(maxsize=None)
def _models(arch, reduced):
    return (JLM(_cfg(jax_get_config, arch, reduced)),
            LM(_cfg(get_config, arch, reduced)))


def _jax_flat(specs) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, JP))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): spec for path, spec in leaves}


def _port_flat(specs, prefix="") -> dict:
    if isinstance(specs, dict):
        return {k: v for key in specs
                for k, v in _port_flat(specs[key], f"{prefix}{key}/").items()}
    if isinstance(specs, (tuple, list)) and not isinstance(specs, P):
        return {k: v for i, s in enumerate(specs)
                for k, v in _port_flat(s, f"{prefix}{i}/").items()}
    return {prefix[:-1]: specs}


def _assert_same_specs(port, ref):
    got, want = _port_flat(port), _jax_flat(ref)
    assert sorted(got) == sorted(want)
    for key in want:
        assert isinstance(got[key], P), key
        assert got[key] == P(*want[key]), (key, got[key], want[key])
        assert tuple(got[key]) == tuple(want[key]), key


@pytest.mark.parametrize("tp", [None, "model"])
@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference(arch, reduced, tp):
    jlm, lm = _models(arch, reduced)
    jabs = jlm.abstract_params()
    pabs = lm.abstract_params()
    for fsdp in FSDPS:
        _assert_same_specs(sh.param_specs(pabs, fsdp, tp),
                           jsh.param_specs(jabs, fsdp, tp))


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_match_reference_and_caches(arch, reduced):
    jlm, lm = _models(arch, reduced)
    caches = lm.init_caches(2, 8, device="meta")
    for mode in ("auto", "heads", "hd", "seq"):
        for shardable in (True, False):
            for fsdp in FSDPS:
                got = sh.cache_specs(lm, fsdp, "model", shardable, mode)
                _assert_same_specs(got, jsh.cache_specs(
                    jlm, fsdp, "model", shardable, mode))
                # one entry a dimension of the cache it places
                specs = sh.spec_leaves(caches, got)
                assert [len(s) for s in specs] == [
                    c.dim() for c in tree_leaves(caches)]


def test_batch_spec_and_partition_spec_equality():
    for shardable in (True, False):
        for fsdp in FSDPS:
            want = jsh.batch_spec(shardable, fsdp)
            assert sh.batch_spec(shardable, fsdp) == P(*want)
    # PartitionSpec's own rules: a 1-tuple of names is the name; trailing
    # Nones count
    for a, b in [(("data",), "data"), (("pod", "data"), ("pod", "data"))]:
        assert (P(a) == P(b)) == (JP(a) == JP(b)) is True
    assert (P("data") == P("data", None)) == (JP("data") == JP("data", None))
    assert (P(None) == P()) == (JP(None) == JP())
    assert P("data") != P("pod")
    assert hash(P(("data",), None)) == hash(P("data", None))


def test_constrain_is_identity_that_checks_rank():
    x = torch.arange(24.0).reshape(2, 3, 4)
    for dp in (None, ("data",)):
        sh.set_activation_mesh(dp, None)
        try:
            assert sh.constrain(x, ("dp", None, "tp")) is x
            assert sh.activation_mesh() == (dp, None)
            with pytest.raises(ValueError, match="rank 3"):
                sh.constrain(x, ("dp", None))
        finally:
            sh.clear_activation_mesh()
    assert sh.activation_mesh() == (None, None)


def _tree(arch="zamba2-7b"):
    lm = LM(get_config(arch).reduced())
    return lm, lm.init(0, device="cpu")


@pytest.mark.parametrize("shape,axes,fsdp,tp", [
    ((4,), ("data",), ("data",), None),
    ((2, 2), ("pod", "data"), ("pod", "data"), None),
    ((2, 2), ("data", "model"), ("data",), "model"),
    ((1, 2), ("data", "model"), ("data",), "model"),
])
def test_shard_then_gather_is_bit_for_bit(shape, axes, fsdp, tp):
    lm, params = _tree()
    specs = sh.param_specs(lm.abstract_params(), fsdp, tp)
    mesh = make_mesh(shape, axes, devices=["cpu"] * int(np.prod(shape)))
    st = sh.shard_tree(params, specs, mesh)
    assert len(st.shards) == mesh.size
    for p, shard in zip(st.positions, st.shards):
        for leaf, part, spec in zip(tree_leaves(params), tree_leaves(shard),
                                    sh.spec_leaves(params, specs)):
            assert tuple(part.shape) == sh.shard_shape(leaf.shape, spec,
                                                       mesh)
            assert torch.equal(part, leaf[sh.slices_of(leaf.shape, spec,
                                                       mesh, p)])
            assert part.data_ptr() != leaf.data_ptr()  # its own copy
    back = sh.gather_tree(st)
    for a, b in zip(tree_leaves(back), tree_leaves(params)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # the bytes a position holds, from the specs alone
    meta = sh.local_bytes(lm.abstract_params(), specs, mesh)
    assert meta == sum(t.numel() * t.element_size()
                       for t in tree_leaves(st.shards[0]))


def test_sharded_subtrees_and_donation():
    lm, params = _tree("smollm-135m")
    specs = sh.param_specs(lm.abstract_params(), ("data",), None)
    one = make_mesh((1,), ("data",), devices=["cpu"])
    kept = sh.shard_tree(params, specs, one, donate=True)
    assert kept.shards[0]["embed"] is params["embed"]  # no copy
    st = sh.shard_tree(params, specs,
                       make_mesh((2,), ("data",), devices=["cpu"] * 2),
                       donate=True)
    sub = st["seg0"]
    assert sub.specs is specs["seg0"] and len(sub.shards) == 2
    assert sub.shards[1]["attn"]["wq"] is st.shards[1]["seg0"]["attn"]["wq"]
    # a leaf held whole by two positions: the second has its own copy
    assert st.shards[1]["final_norm"] is not st.shards[0]["final_norm"]


def test_uneven_split_raises_naming_the_leaf():
    lm, params = _tree("smollm-135m")
    specs = sh.param_specs(lm.abstract_params(), ("data",), None)
    d = params["embed"].shape[1]
    mesh = make_mesh((d + 1,), ("data",), devices=["cpu"] * (d + 1))
    with pytest.raises(ValueError, match="embed: dim 1 of size"):
        sh.shard_tree({"embed": params["embed"]}, {"embed": specs["embed"]},
                      mesh)


def test_every_config_splits_evenly_over_2_4_8():
    """Every sharded dim of every config, full and reduced, divides by 2,
    4 and 8 (FSDP over one data axis), so the meta trees place."""
    for arch in ARCH_IDS:
        for reduced in (False, True):
            lm = _models(arch, reduced)[1]
            pabs = lm.abstract_params()
            specs = sh.param_specs(pabs, ("data",), None)
            for n in (2, 4, 8):
                mesh = make_mesh((n,), ("data",), devices=["meta"] * n)
                st = sh.shard_tree(pabs, specs, mesh)
                assert sh.local_bytes(pabs, specs, mesh) == sum(
                    t.numel() * t.element_size()
                    for t in tree_leaves(st.shards[0]))


def test_mesh_sum_and_scatter_collectives():
    mesh = make_mesh((4,), ("data",), devices=["cpu"] * 4)
    g = torch.Generator().manual_seed(0)
    parts = [torch.randn(8, 12, generator=g) for _ in range(4)]
    want = ((parts[0] + parts[1]) + parts[2]) + parts[3]
    for got in mesh.psum(parts, ("data",)):
        assert torch.equal(got, want)
    for dim in (0, 1):
        got = mesh.psum_scatter(parts, ("data",), dim)
        c = want.shape[dim] // 4
        for s, x in enumerate(got):
            assert torch.equal(x, want.narrow(dim, s * c, c))
        assert torch.equal(mesh.all_gather(got, ("data",), dim=dim), want)
    with pytest.raises(ValueError, match="does not split"):
        mesh.psum_scatter([torch.zeros(3)] * 4, ("data",), 0)
    assert mesh.local_positions() == [0, 1, 2, 3]
