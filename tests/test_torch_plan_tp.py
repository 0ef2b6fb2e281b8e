"""Tensor-parallel buckets in the exchange plan (``make_plan(model_dims=)``)
and the layout rules of ``launch/sharding.py`` against the JAX package.

- Every arch's ``reduced()`` parameters, as shapes only (the reference's
  ``jax.eval_shape`` of its ungrouped model's init, carried over as meta
  tensors): ``param_specs`` (stacked or not, with and without an FSDP
  axis), ``model_dims``, ``leaf_pin_spec`` and ``batch_spec`` equal the
  reference's ``PartitionSpec`` entries; the TP-bucketed plans built
  from those model dims equal the reference's (every bucket's fields,
  ``describe()``), as do their gather / scatter round trips.
- The global path (``rps_exchange_global``) on TP-bucketed plans, both
  engines, bit for bit on integer stacks, against the reference's.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as jget_config
from repro.core import plan as jplan
from repro.core import rps as jrps
from repro.launch import sharding as jsh
from repro.models import build_model as jbuild_model
from repro.models import inputs as jinputs
from repro_torch import tree as tree_lib
from repro_torch.configs import get_config as tget_config
from repro_torch.core import plan as tplan
from repro_torch.core import rps as trps
from repro_torch.launch import sharding as tsh

ARCHS = sorted(ARCH_IDS) + ["rps-paper-mlp"]


def _meta(sds_tree):
    return jax.tree.map(lambda s: torch.empty(
        s.shape, dtype=getattr(torch, jnp.dtype(s.dtype).name),
        device="meta"), sds_tree)


@functools.cache
def _shapes(arch: str):
    """(reference cfg, port cfg, reference shapes, port meta tree)."""
    jcfg = jget_config(arch).reduced()
    tcfg = tget_config(arch).reduced()
    model = jbuild_model(jcfg, grouped=False)
    sds = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    return jcfg, tcfg, sds, _meta(sds)


def _spec_tuples(tree):
    return jax.tree.map(lambda p: tuple(p), tree,
                        is_leaf=lambda x: isinstance(x, jax.sharding
                                                     .PartitionSpec))


def _stack(sds, n):
    return jax.tree.map(lambda s: jax.ShapeDtypeStruct((n,) + s.shape,
                                                       s.dtype), sds)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharding_rules_equal_reference(arch):
    jcfg, tcfg, sds, meta = _shapes(arch)
    for kw in ({}, {"fsdp_axis": "data"}):
        want = _spec_tuples(jsh.param_specs(sds, jcfg, **kw))
        assert tsh.param_specs(meta, tcfg, **kw) == want
    for axes in (("data",), ("pod", "data")):
        ssds = _stack(sds, 4)
        smeta = _meta(ssds)
        want = _spec_tuples(jsh.param_specs(ssds, jcfg, worker_axes=axes,
                                            stacked=True))
        assert tsh.param_specs(smeta, tcfg, worker_axes=axes,
                               stacked=True) == want
        assert tsh.model_dims(smeta, tcfg, stacked=True) == jsh.model_dims(
            ssds, jcfg, stacked=True)
    assert tsh.model_dims(meta, tcfg) == jsh.model_dims(sds, jcfg)
    for cfg_j, cfg_t in ((jcfg, tcfg),
                         (dataclasses.replace(jcfg, shard_strategy="fsdp"),
                          dataclasses.replace(tcfg,
                                              shard_strategy="fsdp"))):
        paths = jax.tree_util.tree_leaves_with_path(sds)
        for path, s in paths:
            pstr = jsh._path_str(path)
            assert tsh.leaf_pin_spec(pstr, s.shape, cfg_t) == tuple(
                jsh.leaf_pin_spec(pstr, s.shape, cfg_j)), pstr
    batch = _stack(jinputs.train_specs(jcfg, 2, 16), 4)
    bmeta = _meta(batch)
    for axes, data in ((("data",), ()), (("pod",), ("data",)), ((), ())):
        want = _spec_tuples(jsh.batch_spec(batch, axes, data))
        assert tsh.batch_spec(bmeta, axes, data) == want


def _fields(plan):
    return [dataclasses.asdict(b) for b in plan.buckets]


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_plan_equals_reference(arch):
    """The TP-bucketed plan of the arch's replica (model dims from the
    rules) at n = 4: the same buckets, leaf order, pads and describe()
    as the reference's; gather then scatter gives the tree back."""
    jcfg, tcfg, sds, meta = _shapes(arch)
    jmd, tmd = jsh.model_dims(sds, jcfg), tsh.model_dims(meta, tcfg)
    for kw in ({"n_buckets": 3}, {"bucket_bytes": 2 ** 16},
               {"n_buckets": 2, "s": 6}):
        kw = dict(kw)
        s = kw.pop("s", None)
        jp = jplan.make_plan(sds, 4, s, model_dims=jmd, **kw)
        tp_ = tplan.make_plan(meta, 4, s, model_dims=tmd, **kw)
        assert _fields(tp_) == _fields(jp)
        assert tp_.describe() == jp.describe()
        assert any(b.model_dim is not None for b in tp_.buckets) \
            or all(m is None for m in tree_lib.leaves(tmd))


TP_TREE = {"a": (6, 16, 5), "b": (13,), "c": (4, 3, 8), "d": (5, 7)}
TP_DIMS = {"a": 1, "b": None, "c": 2, "d": 0}


@pytest.mark.parametrize("engine", ["xla", "ring"])
@pytest.mark.parametrize("mode,s", [("model", 3), ("grad", 4),
                                    ("model", 8)])
def test_global_path_on_tp_plan_equals_reference(engine, mode, s):
    """rps_exchange_global of an integer-valued stack over a TP-bucketed
    plan (per-bucket masks), bit for bit; the stack gathers into the
    reference's tables and scatters back to itself."""
    n = 4
    rng = np.random.default_rng(s + len(mode) + len(engine))
    x = {k: rng.integers(-8, 9, (n,) + v).astype(np.float32)
         for k, v in TP_TREE.items()}
    sds = {k: jax.ShapeDtypeStruct(v, jnp.float32) for k, v in TP_TREE.items()}
    jp = jplan.make_plan(sds, n, s, n_buckets=2, model_dims=TP_DIMS)
    tp_ = tplan.make_plan(_meta(sds), n, s, n_buckets=2, model_dims=TP_DIMS)
    assert _fields(tp_) == _fields(jp)
    own = np.zeros((n, s), bool)
    own[np.arange(s) % n, np.arange(s)] = True
    rs = (rng.random((jp.n_buckets, n, s)) < 0.6) | own
    ag = (rng.random((jp.n_buckets, n, s)) < 0.6) | own
    tx = {k: torch.from_numpy(v) for k, v in x.items()}
    for jt, tt in zip(jp.gather(jax.tree.map(jnp.asarray, x), lead=1),
                      tp_.gather(tx, lead=1)):
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    back = tp_.scatter(tp_.gather(tx, lead=1), lead=1)
    for k in x:
        np.testing.assert_array_equal(back[k].numpy(), x[k])
    # jitted: every sum of these integers is exact in any order
    want = jax.jit(lambda t, r, a: jrps.rps_exchange_global(
        t, jax.random.PRNGKey(0), 0.3, n, mode=mode, masks=(r, a), plan=jp,
        engine=engine))(jax.tree.map(jnp.asarray, x), jnp.asarray(rs),
                        jnp.asarray(ag))
    got = trps.rps_exchange_global(
        tx, None, 0.3, n, mode=mode,
        masks=(torch.from_numpy(rs), torch.from_numpy(ag)), plan=tp_,
        engine=engine)
    for k in x:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
