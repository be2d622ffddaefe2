"""The port's sharding rules against the JAX package's, with no processes.

Both sides run on abstract trees at every registry config's published
widths: the JAX package's ``abstract_params`` (``eval_shape``) under a
``jax.sharding.AbstractMesh``, the port's ``meta``-device init stacked
into the JAX layout under the port's ``AbstractMesh``.  Checked: every
leaf's path, shape, dtype and spec on meshes (2, 4), (1, 8) and (8, 1),
with ``tp=False`` and ``fsdp=False``; the quantized-suffix rule on a
W4A16 ``tiny_cfg`` tree; ``ParallelContext.spec`` for every logical
name; and the bytes a rank stores against a JAX device's
(``NamedSharding.shard_shape``).
"""
import functools

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh as JAbstractMesh
from jax.sharding import NamedSharding, PartitionSpec as P

from repro.configs import registry as JR
from repro.distributed import sharding as JS
from repro.models import api as JAPI
from repro_torch import bridge
from repro_torch.configs import registry as R
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as S
from repro_torch.models import api
from repro_torch.quant.qlinear import quantize_model_params

ARCHS = R.list_archs()
# (mesh shape, ParallelContext options)
MESHES = {
    "2x4": ((2, 4), {}),
    "1x8": ((1, 8), {}),
    "8x1": ((8, 1), {}),
    "2x4-notp": ((2, 4), {"tp": False}),
    "2x4-nofsdp": ((2, 4), {"fsdp": False}),
}


def pars(mesh_key):
    shape, kw = MESHES[mesh_key]
    names = ("data", "model")
    return (JS.ParallelContext(mesh=JAbstractMesh(shape, names), **kw),
            S.ParallelContext(mesh=S.AbstractMesh(shape, names), **kw))


def norm(spec, ndim):
    """A spec as a tuple of ndim entries, a one-axis tuple as its name."""
    out = []
    for e in tuple(spec) + (None,) * (ndim - len(tuple(spec))):
        if isinstance(e, (tuple, list)):
            e = e[0] if len(e) == 1 else tuple(e)
        out.append(e)
    return tuple(out)


def jax_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    return [("/".join(str(getattr(k, "key", k)) for k in path), leaf)
            for path, leaf in flat]


def port_leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from port_leaves(tree[k], f"{path}/{k}" if path else k)
    else:
        yield path, tree


@functools.lru_cache(maxsize=None)
def abstract_pair(arch):
    jcfg = JR.get_config(arch)
    return (JAPI.get_model(jcfg).abstract_params(jcfg),
            S.stack_layers(api.abstract_params(R.get_config(arch))))


@pytest.mark.parametrize("mesh_key", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_jax(arch, mesh_key):
    jtree, ptree = abstract_pair(arch)
    jpar, ppar = pars(mesh_key)
    jspecs = jax_leaves(JS.param_specs(jtree, jpar))
    jshapes = jax_leaves(jtree)
    pspecs = list(port_leaves(S.param_specs(ptree, ppar)))
    pshapes = list(port_leaves(ptree))
    assert [p for p, _ in pspecs] == [p for p, _ in jspecs]
    for (path, js), (_, ps), (_, jl), (_, pl) in zip(jspecs, pspecs,
                                                     jshapes, pshapes):
        assert tuple(pl.shape) == tuple(jl.shape), path
        assert str(pl.dtype).replace("torch.", "") == str(jl.dtype), path
        assert norm(ps, pl.ndim) == norm(js, jl.ndim), path


@pytest.mark.parametrize("mesh_key", ["2x4", "2x4-notp", "1x8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_rank_bytes_equal_jax_device_bytes(arch, mesh_key):
    """What one rank stores of the tree equals what a device of the JAX
    layout holds, leaf by leaf, and the blocks of ``shard_of`` tile each
    leaf (their shapes are ``local_shape``)."""
    jtree, ptree = abstract_pair(arch)
    jpar, ppar = pars(mesh_key)
    jspecs = dict(jax_leaves(JS.param_specs(jtree, jpar)))
    pspecs = dict(port_leaves(S.param_specs(ptree, ppar)))
    total_j = 0
    for path, jl in jax_leaves(jtree):
        shard = NamedSharding(jpar.mesh, jspecs[path]).shard_shape(jl.shape)
        total_j += int(np.prod(shard)) * jl.dtype.itemsize
        pl = dict(port_leaves(ptree))[path]
        assert S.local_shape(pl.shape, pspecs[path], ppar) == tuple(shard)
        coord = {"data": jpar.mesh.shape["data"] - 1, "model": 0}
        assert tuple(S.shard_of(pl, pspecs[path], ppar, coord=coord).shape) \
            == tuple(shard), path
    assert S.tree_bytes(ptree, S.param_specs(ptree, ppar), ppar) == total_j


def tiny_port_cfg():
    return ModelConfig(name="tiny", n_layers=2, d_model=64, n_heads=4,
                       n_kv_heads=2, d_ff=192, vocab_size=320,
                       dtype="float32", param_dtype="float32", remat="none")


@pytest.mark.parametrize("mesh_key", ["2x4", "1x8", "2x4-notp"])
def test_quantized_suffix_rule_matches_jax(mesh_key):
    """A W4A16 tree (Q4 codes / scales / codebook, Q8 down): codes and
    scales shard like their weight with the tile dims replicated, a
    codebook is replicated; on both sides the same."""
    cfg = tiny_port_cfg()
    q = quantize_model_params(api.get_model(cfg).init_params(
        cfg, seed=0, device="cpu"))
    host = bridge.params_to_jax(q)
    jtree = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                         host)
    ptree = S.stack_layers(q)
    jpar, ppar = pars(mesh_key)
    jpar = JS.ParallelContext(mesh=jpar.mesh, tp=jpar.tp, quantized=True)
    ppar = S.ParallelContext(mesh=ppar.mesh, tp=ppar.tp, quantized=True)
    jspecs = jax_leaves(JS.param_specs(jtree, jpar))
    pspecs = list(port_leaves(S.param_specs(ptree, ppar)))
    assert [p for p, _ in pspecs] == [p for p, _ in jspecs]
    assert any(p.endswith("/codes") for p, _ in pspecs)
    assert any(p.endswith("/codebook") for p, _ in pspecs)
    shapes = dict(port_leaves(ptree))
    for (path, js), (_, ps) in zip(jspecs, pspecs):
        nd = shapes[path].ndim
        assert norm(ps, nd) == norm(js, nd), path


@pytest.mark.parametrize("mesh_key", list(MESHES) + ["3d", "none"])
def test_spec_of_every_logical_name_matches_jax(mesh_key):
    if mesh_key == "none":
        jpar, ppar = JS.ParallelContext(), S.ParallelContext()
    elif mesh_key == "3d":
        names = ("pod", "data", "model")
        jpar = JS.ParallelContext(mesh=JAbstractMesh((2, 4, 2), names),
                                  shard_activations_seq=True)
        ppar = S.ParallelContext(mesh=S.AbstractMesh((2, 4, 2), names),
                                 shard_activations_seq=True)
    else:
        jpar, ppar = pars(mesh_key)
    for kv in (None, "data", "model"):
        jp = JS.ParallelContext(mesh=jpar.mesh, fsdp=jpar.fsdp, tp=jpar.tp,
                                kv_seq_axis=kv,
                                shard_activations_seq=jpar.shard_activations_seq)
        pp = S.ParallelContext(mesh=ppar.mesh, fsdp=ppar.fsdp, tp=ppar.tp,
                               kv_seq_axis=kv,
                               shard_activations_seq=ppar.shard_activations_seq)
        for name in list(S.LOGICAL_RULES) + [None]:
            assert norm(pp.spec(name), 1) == norm(jp.spec(name), 1), name
        assert norm(pp.spec(*S.LOGICAL_RULES), 12) == \
            norm(jp.spec(*S.LOGICAL_RULES), 12)
        for b in (1, 2, 3, 4, 6, 8, 16, 24):
            assert norm((pp.batch_axes_for(b),), 1) == \
                norm((jp.batch_axes_for(b),), 1), b
        assert (pp.n_data, pp.n_model) == (jp.n_data, jp.n_model)
    assert S.LOGICAL_RULES == JS.LOGICAL_RULES
    assert S.PARAM_RULES == JS.PARAM_RULES


def test_logical_axes_for_matches_jax():
    paths = ["layers/attn/wq/w", "enc_layers/attn/wq/w", "embedding/table",
             "layers/moe/experts/gate", "layers/conv/w", "unknown/x",
             "final_norm/scale", "shared_attn/ffn/down/w"]
    for path in paths:
        for ndim in (0, 1, 2, 3, 4):
            for stacked in (False, True):
                assert S.logical_axes_for(path, ndim, stacked) == \
                    JS.logical_axes_for(path, ndim, stacked)


def test_stack_layers_is_the_bridge_layout():
    """``stack_layers`` gives the JAX layout of ``bridge.params_to_jax``,
    values and all, and ``param_specs`` refuses a per-layer list."""
    cfg = tiny_port_cfg()
    p = api.get_model(cfg).init_params(cfg, seed=0, device="cpu")
    st = S.stack_layers(p)
    host = bridge.params_to_jax(p)
    got = dict(port_leaves(st))
    want = dict(port_leaves(host))
    assert list(got) == list(want)
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    with pytest.raises(TypeError, match="stack"):
        S.param_specs(p, S.ParallelContext(
            mesh=S.AbstractMesh((2, 4), ("data", "model"))))
