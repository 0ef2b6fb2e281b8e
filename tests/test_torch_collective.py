"""The port's collective exchange (one process per RPS worker, gloo on the
CPU) against the JAX package: ``rps_exchange_flat``, ``rps_exchange``,
``rps_exchange_plan``, ``rps_exchange_leaf`` and ``reliable_average``.

Every case runs in one world of four ranks (``_torch_dist.run_cases``)
on the same numpy inputs and masks the reference gets. Two oracles:

- the reference's global path ``rps_exchange_global`` on the stacked
  inputs, in two subprocesses (op by op under ``jax.disable_jit()`` where
  a bit-for-bit comparison needs it, jitted elsewhere), for the whole
  matrix — its own tests hold it equal to its collective path
  (``test_parity_matrix_collective_vs_global_8dev``,
  ``test_ring_engine_bitwise_parity_matrix_8dev``);
- the reference's collective entry points themselves, under
  ``shard_map`` in one subprocess with four forced host devices, for the
  cases marked ``coll`` (each entry point, engine, wire and recovery
  once).

Bit for bit where the reference's own tests are (integer-valued inputs
on the linear wires, both engines; the int8 ring against the reference
op by op); elsewhere within 2e-5 (``test_multiserver.py``'s tolerance),
and the int8 wire against the jitted reference within rel 1e-5 of each
row (it divides by 127 as a product by the reciprocal). The tapped
counters equal the reference's on the same masks.
"""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import plan as jplan
from repro.core import rps as jrps
from repro.core import wire as jwire
from repro.telemetry import counters as jcounters

import _torch_dist as td

N = td.WORLD
P_DROP = 0.3
KEY = jax.random.PRNGKey(3)
WIRE_TAG = 0x77697265
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
FN = "_torch_dist.exchange_case"
XLA_QUICK = ("--xla_backend_optimization_level=0 "
             "--xla_llvm_disable_expensive_passes=true")
TREE = {"a": (5, 7), "b": (13,), "c": (3, 4, 2)}


def _owner(s):
    m = np.zeros((N, s), bool)
    m[np.arange(s) % N, np.arange(s)] = True
    return m


def _masks(rng, s, nb=None, p=0.4):
    shape = (N, s) if nb is None else (nb, N, s)
    rs = (rng.random(shape) >= p) | _owner(s)
    ag = (rng.random(shape) >= p) | _owner(s)
    return rs, ag


def _data(rng, shape, kind, dtype=np.float32):
    if kind == "int":
        return rng.integers(-8, 9, shape).astype(dtype)
    return rng.normal(size=shape).astype(dtype)


def _scatter(x, s):
    """A block-ordered (s, …) array in the owner-major scatter layout."""
    k = -(-s // N)
    S = k * N
    if S != s:
        x = np.concatenate([x, np.zeros((S - s,) + x.shape[1:], x.dtype)])
    if k == 1:
        return x
    r = np.arange(S)
    return x[(r % k) * N + r // k]


def _tree(rng, kind, dtypes=None):
    dtypes = dtypes or {}
    return {k: _data(rng, (N,) + v, kind, dtypes.get(k, np.float32))
            for k, v in TREE.items()}


def _coll_noise(shape_fn, nb=None):
    """The reference collective path's int8 uniforms for rank i:
    ``uniform(fold_in(fold_in(key, wire), i))`` (flat), with the bucket
    folded in before the rank on the plan path."""
    out = []
    for i in range(N):
        base = jax.random.fold_in(KEY, WIRE_TAG)
        if nb is None:
            out.append(np.asarray(jax.random.uniform(
                jax.random.fold_in(base, i), shape_fn(None))))
        else:
            out.append([np.asarray(jax.random.uniform(
                jax.random.fold_in(jax.random.fold_in(base, b), i),
                shape_fn(b))) for b in range(nb)])
    return out


def _cases():
    """name -> spec. ``coll``: also checked against the reference's
    collective path in the subprocess."""
    rng = np.random.default_rng(0)
    cases = {}

    def flat(name, *, s=4, kind="int", D=37, coll=False, **kw):
        rs, ag = _masks(rng, s)
        cases[name] = dict(fn=FN, entry="flat", x=_data(rng, (N, D), kind),
                           rs=rs, ag=ag, p=P_DROP, s=s, coll=coll,
                           kind=kind, **kw)

    # modes x engines (integer tables: bit for bit)
    for mode in ("model", "grad", "grad_renorm"):
        for eng in ("xla", "ring"):
            flat(f"flat-{mode}-{eng}", mode=mode, engine=eng,
                 coll=mode == "model" or (mode, eng) == ("grad", "ring"))
    for s in (3, 8):
        for eng in ("xla", "ring"):
            flat(f"flat-s{s}-{eng}", s=s, engine=eng,
                 coll=(s, eng) == (3, "ring"))
    flat("flat-s3-grad-ring", s=3, mode="grad", engine="ring")
    # wires
    # the bf16 wire on the xla engine: the reference's collective path sums
    # and divides in bf16, its global path in f32 (decode at receiver), so
    # only the collective path is its oracle there
    for eng in ("xla", "ring"):
        flat(f"flat-bf16-{eng}", wire="bf16", engine=eng,
             coll=eng == "xla", only_coll=eng == "xla")
        flat(f"flat-int8-{eng}", wire="int8", engine=eng, noise="global",
             kind="normal")
        flat(f"flat-int8c-{eng}", wire="int8", engine=eng, noise="coll",
             kind="normal", coll=True, only_coll=True)
    flat("flat-int8-grad-xla", mode="grad", wire="int8", engine="xla",
         noise="global", kind="normal")
    # continuous data (the reference's tolerance)
    for eng in ("xla", "ring"):
        flat(f"flat-normal-{eng}", kind="normal", engine=eng)
    flat("flat-normal-bf16-ring", kind="normal", wire="bf16",
         engine="ring")
    flat("flat-normal-s3-grad-xla", s=3, kind="normal", mode="grad")
    # recoveries
    for eng in ("xla", "ring"):
        flat(f"flat-scale-{eng}", recovery="scale", engine=eng,
             coll=eng == "xla")
    for rec in ("median", "trimmed:beta=0.25", "clip"):
        flat(f"flat-{rec.split(':')[0]}", recovery=rec, kind="normal",
             coll=rec == "median")
    # corruption (a deterministic kind: no bits to share)
    for eng in ("xla", "ring"):
        flat(f"flat-signflip-{eng}", engine=eng, corruption="signflip",
             cmask=rng.random((N, 4)) < 0.4, coll=eng == "ring")
    flat("flat-collude-trimmed", corruption="collude:gamma=10",
         cmask=rng.random((N, 4)) < 0.4, recovery="trimmed:beta=0.25",
         kind="normal")
    flat("flat-taps", taps=True, engine="ring",
         corruption="signflip", cmask=rng.random((N, 4)) < 0.4)

    # the pytree wrapper (one bucket)
    for eng in ("xla", "ring"):
        rs, ag = _masks(rng, 4)
        cases[f"tree-{eng}"] = dict(
            fn=FN, entry="tree", x=_tree(rng, "int", {"b": np.float32}),
            rs=rs, ag=ag, p=P_DROP, s=4, engine=eng, coll=eng == "ring")
    rs, ag = _masks(rng, 4)
    cases["tree-bf16"] = dict(fn=FN, entry="tree", x=_tree(rng, "int"),
                              rs=rs, ag=ag, p=P_DROP, s=4,
                              rs_dtype="bfloat16", coll=True,
                              only_coll=True)

    # plans
    def plan(name, plan_kw, *, kind="int", coll=False, **kw):
        plan_kw = {k: v for k, v in plan_kw.items() if v is not None}
        x = _tree(rng, kind)
        per = jax.tree.map(lambda v: jax.ShapeDtypeStruct(v.shape[1:],
                                                          v.dtype), x)
        jp = jplan.make_plan(per, N, **plan_kw)
        nb = jp.n_buckets if jp.per_bucket_masks else None
        rs, ag = _masks(rng, jp.s, nb)
        cases[name] = dict(fn=FN, entry="plan", x=x, rs=rs, ag=ag,
                           p=P_DROP, s=jp.s, plan_kw=plan_kw, coll=coll,
                           kind=kind, **kw)

    for eng in ("xla", "ring"):
        plan(f"plan-perleaf-{eng}", {"n_buckets": None}, engine=eng,
             coll=eng == "xla")
        plan(f"plan-buckets-{eng}", {"n_buckets": 2}, engine=eng)
        plan(f"plan-s8-{eng}", {"s": 8, "n_buckets": 2}, engine=eng)
        plan(f"plan-async-{eng}", {"n_buckets": 2, "schedule": "async",
                                   "compute_ms": 8.0}, engine=eng,
             late=True, taps=True)
        plan(f"plan-tp-{eng}", {"n_buckets": 2,
                                "model_dims": {"a": 1, "b": None,
                                               "c": 2}}, engine=eng,
             coll=eng == "ring")
    for eng in ("xla", "ring"):
        for wire in ("f32", "int8"):
            plan(f"plan-ef-{wire}-{eng}", {"n_buckets": 2},
                 engine=eng, wire=wire, recovery="ef", kind="normal",
                 ef=True, coll=(eng, wire) in (("xla", "int8"),
                                                ("ring", "f32")))
    plan("plan-median-taps", {"n_buckets": 2}, recovery="median",
         kind="normal", taps=True)

    # the per-leaf entry, a model dim kept intact
    for eng in ("xla", "ring"):
        for md in (None, 1):
            rs, ag = _masks(rng, 4)
            cases[f"leaf-md{md}-{eng}"] = dict(
                fn=FN, entry="leaf", x=_data(rng, (N, 6, 16, 3), "int"),
                rs=rs, ag=ag, p=P_DROP, s=4, mode="model", engine=eng,
                model_dim=md, coll=(md, eng) == (1, "ring"))
    cases["reliable"] = dict(fn=FN, entry="reliable",
                             x=_tree(rng, "int"), coll=True)

    # the per-case extras the ranks need
    for name, c in cases.items():
        if c["entry"] == "plan":
            if c.get("late"):
                late_rs = (rng.random(c["rs"].shape) < 0.2) & ~c["rs"]
                late_ag = (rng.random(c["ag"].shape) < 0.2) & ~c["ag"]
                c["late"] = {"rs": late_rs, "ag": late_ag}
            if c.get("ef"):
                c["ef"] = {k: (0.1 * rng.normal(size=v.shape)).astype(
                    np.float32) for k, v in c["x"].items()}
        if c.get("noise") in ("global", "coll"):
            c["noise_kind"] = c["noise"]
            s, D = c["s"], c["x"].shape[1]
            blk = -(-D // s)
            S = -(-s // N) * N
            if c["noise"] == "coll":
                c["noise"] = _coll_noise(lambda b: (S, blk))
            else:
                u = np.asarray(jax.random.uniform(jax.random.fold_in(
                    jax.random.fold_in(KEY, WIRE_TAG), 0), (1, N, s, blk)))
                c["noise"] = [_scatter(u[0, i], s) for i in range(N)]
    return cases


CASES = _cases()
GLOBAL = [k for k, c in CASES.items() if not c.get("only_coll")]
COLL = [k for k, c in CASES.items() if c.get("coll")]


def _ref_taps(c):
    """The reference's per-call counters on this case's masks (the
    collective path taps them before the engine branch)."""
    rec = jwire.make_recovery(c.get("recovery"), p=c["p"])
    mode = c.get("mode", "model")
    rs, ag = jnp.asarray(c["rs"]), jnp.asarray(c["ag"])
    pairs = [(rs, ag)] if rs.ndim == 2 else list(zip(rs, ag))
    out = {"rs_link_delivered": [], "ag_link_delivered": [], "divisor": []}
    for b, (r, a) in enumerate(pairs):
        out["rs_link_delivered"].append(jcounters.link_delivered(r))
        out["ag_link_delivered"].append(jcounters.link_delivered(a))
        out["divisor"].append(jrps._divisor(rec, mode, r, N))
        if c.get("late") is not None:
            for leg in ("rs", "ag"):
                out.setdefault(f"{leg}_link_late", []).append(
                    jcounters.link_late(jnp.asarray(c["late"][leg][b])))
        if c.get("corruption"):
            out.setdefault("rs_link_corrupt", []).append(
                jcounters.link_corrupt(jnp.asarray(c["cmask"]), r))
    return {k: np.stack([np.asarray(v) for v in vs]) for k, vs in
            out.items()}


# ---- the reference's collective path, one subprocess ----------------------

_COLL = textwrap.dedent("""
    import os, sys, pickle
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                               + os.environ.get("XLA_FLAGS", ""))
    sys.path.insert(0, %r)
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from repro import channels as ch
    from repro.core import plan as jplan, rps

    cases = pickle.load(open(sys.argv[1], "rb"))
    N = 4
    mesh = Mesh(np.array(jax.devices()[:N]), ("data",))
    key = jax.random.PRNGKey(3)

    # the per-leaf entry runs partial-manual beside a "model" axis
    mesh_tp = Mesh(np.array(jax.devices()[:N]).reshape(N, 1),
                   ("data", "model"))

    def sm(f, n_in, m=mesh):
        return jax.shard_map(f, mesh=m, in_specs=(P("data"),) * n_in,
                             out_specs=P("data"), axis_names={"data"},
                             check_vma=False)

    def lead(t):
        return jax.tree.map(lambda v: jnp.asarray(v), t)

    out = {}
    for name, c in cases.items():
        kw = {}
        for k in ("mode", "engine", "wire", "recovery"):
            if k in c:
                kw[k] = c[k]
        if c.get("corruption"):
            kw["corruption"] = ch.make_corruption(c["corruption"])
            kw["corrupt_masks"] = jnp.asarray(c["cmask"])
        if c.get("rs_dtype"):
            kw["rs_dtype"] = jnp.bfloat16
        masks = None if c.get("rs") is None else (
            jnp.asarray(c["rs"]), jnp.asarray(c["ag"]))
        e = c["entry"]
        if e == "flat":
            f = lambda v: rps.rps_exchange_flat(
                v[0], key, c["p"], "data", masks=masks, **kw)[None]
            res = jax.jit(sm(f, 1))(jnp.asarray(c["x"]))
        elif e == "tree":
            f = lambda t: jax.tree.map(lambda v: v[None], rps.rps_exchange(
                jax.tree.map(lambda v: v[0], t), key, c["p"], "data",
                masks=masks, **kw))
            res = jax.jit(sm(f, 1))(lead(c["x"]))
        elif e == "plan":
            per = jax.tree.map(lambda v: jax.ShapeDtypeStruct(
                v.shape[1:], v.dtype), c["x"])
            plan = jplan.make_plan(per, N, **c["plan_kw"])
            if c.get("ef") is not None:
                def f(t, ef):
                    o, e2 = rps.rps_exchange_plan(
                        jax.tree.map(lambda v: v[0], t), key, c["p"],
                        "data", plan=plan, masks=masks,
                        ef_state=jax.tree.map(lambda v: v[0], ef), **kw)
                    return jax.tree.map(lambda v: v[None], (o, e2))
                res = jax.jit(sm(f, 2))(lead(c["x"]), lead(c["ef"]))
            else:
                f = lambda t: jax.tree.map(
                    lambda v: v[None], rps.rps_exchange_plan(
                        jax.tree.map(lambda v: v[0], t), key, c["p"],
                        "data", plan=plan, masks=masks, **kw))
                res = jax.jit(sm(f, 1))(lead(c["x"]))
        elif e == "leaf":
            f = lambda v: rps.rps_exchange_leaf(
                v[0], masks[0], masks[1], "data", mode=c["mode"],
                model_dim=c["model_dim"], engine=c["engine"])[None]
            with jax.set_mesh(mesh_tp):
                res = jax.jit(sm(f, 1, mesh_tp))(jnp.asarray(c["x"]))
        elif e == "reliable":
            f = lambda t: jax.tree.map(lambda v: v[None],
                                       rps.reliable_average(
                jax.tree.map(lambda v: v[0], t), "data"))
            res = jax.jit(sm(f, 1))(lead(c["x"]))
        out[name] = jax.tree.map(lambda v: np.asarray(v, np.float32), res)

    pickle.dump(out, open(sys.argv[2], "wb"))
""") % SRC


def _op_by_op(c):
    """Whether the reference's global path runs ``c`` op by op: where a
    bit-for-bit comparison needs it (the int8 ring, the bf16 wire — under
    jit XLA:CPU elides its roundings — and the scale recovery, which jit
    turns into a product by the divisor's reciprocal); the rest compile
    once, which is quicker."""
    return (c.get("wire") == "int8" and c.get("engine") == "ring") \
        or c.get("wire") == "bf16" or c.get("rs_dtype") == "bfloat16" \
        or c.get("recovery") == "scale"


# the reference's global path on the stacked inputs, in two subprocesses:
# the cases it runs op by op (``op_by_op``) in one, the jitted ones in
# the other (the two take about as long)
_GLOBAL = textwrap.dedent("""
    import sys, pickle
    sys.path.insert(0, %r)
    import numpy as np, jax, jax.numpy as jnp
    from repro import channels as jchannels
    from repro.core import plan as jplan, rps as jrps

    cases = pickle.load(open(sys.argv[1], "rb"))
    N, KEY = 4, jax.random.PRNGKey(3)

    def run_case(c):
        kw = dict(mode=c.get("mode", "model"), engine=c.get("engine", "xla"),
                  wire=c.get("wire"), recovery=c.get("recovery"))
        if c.get("rs_dtype"):
            kw["rs_dtype"] = jnp.bfloat16
        if c.get("corruption"):
            kw["corruption"] = jchannels.make_corruption(c["corruption"])
        if c["entry"] == "reliable":
            return {k: np.broadcast_to(v.sum(0) / N, v.shape)
                    for k, v in c["x"].items()}
        plan = None
        if c["entry"] in ("flat", "leaf"):
            x = {"x": c["x"]}
            if c["entry"] == "leaf":
                md = {"x": c["model_dim"]} \
                    if c["model_dim"] is not None else None
                per = {"x": jax.ShapeDtypeStruct(c["x"].shape[1:],
                                                 jnp.float32)}
                plan = jplan.make_plan(per, N, c["s"], model_dims=md)
        else:
            x = c["x"]
            per = jax.tree.map(lambda v: jax.ShapeDtypeStruct(
                v.shape[1:], v.dtype), x)
            plan = jplan.single_bucket_plan(per, N, c["s"]) \
                if c["entry"] == "tree" \
                else jplan.make_plan(per, N, **c["plan_kw"])
        args = jax.tree.map(jnp.asarray, {
            "x": x, "rs": c["rs"], "ag": c["ag"], "cmask": c.get("cmask"),
            "late": c.get("late"), "ef": c.get("ef")})

        def run(a):
            extra = {}
            if a["cmask"] is not None:
                extra["corrupt_masks"] = a["cmask"]
            if a["late"] is not None:
                extra["late"] = a["late"]
            if a["ef"] is not None:
                extra["ef_state"] = a["ef"]
            return jrps.rps_exchange_global(
                a["x"], KEY, c["p"], N, masks=(a["rs"], a["ag"]),
                plan=plan, **kw, **extra)

        if c["op_by_op"]:
            with jax.disable_jit():
                out = run(args)
        else:
            out = jax.jit(run)(args)
        out = jax.tree.map(lambda v: np.asarray(v, np.float32), out)
        return out["x"] if c["entry"] in ("flat", "leaf") else out

    pickle.dump({k: run_case(c) for k, c in cases.items()},
                open(sys.argv[2], "wb"))
""") % SRC


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The port's world and, beside it, three reference subprocesses: the
    collective oracle and the global-path oracle's op-by-op and jitted
    cases."""
    import pickle
    tmp = tmp_path_factory.mktemp("collective")
    def dump(names, path):
        with open(path, "wb") as f:
            pickle.dump({k: dict({kk: vv for kk, vv in CASES[k].items()
                                  if kk != "fn"},
                                 op_by_op=_op_by_op(CASES[k]))
                         for k in names}, f)

    dump(COLL, tmp / "in.pkl")
    for j in range(2):
        dump([k for k in GLOBAL if _op_by_op(CASES[k]) == bool(j)],
             tmp / f"glob{j}.pkl")
    env = dict(os.environ)
    # the reference's compiles at the CPU backend's lowest optimisation
    # level (the HLO, and with it every rounding, is the same)
    env.update({"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
                "JAX_PLATFORMS": "cpu", "XLA_FLAGS": XLA_QUICK})
    cmds = [[sys.executable, "-c", _COLL, str(tmp / "in.pkl"),
             str(tmp / "coll.pkl")]]
    cmds += [[sys.executable, "-c", _GLOBAL, str(tmp / f"glob{j}.pkl"),
              str(tmp / f"glob{j}_out.pkl")] for j in range(2)]
    procs = [subprocess.Popen(c, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    try:
        port = td.run_cases(CASES, path=tmp / "port.npz")
    finally:
        logs = [p.communicate(timeout=900) for p in procs]
    for p, (out, err) in zip(procs, logs):
        assert p.returncode == 0, out + err
    with open(tmp / "coll.pkl", "rb") as f:
        ref = pickle.load(f)
    glob = {}
    for j in range(2):
        with open(tmp / f"glob{j}_out.pkl", "rb") as f:
            glob.update(pickle.load(f))
    return port, ref, glob


def _stack(ranks, key="y"):
    """The ranks' outputs stacked on a leading dim (trees leaf by leaf)."""
    first = ranks[0][key]
    if isinstance(first, dict):
        return {k: np.stack([r[key][k] for r in ranks]) for k in first}
    return np.stack([r[key] for r in ranks])


def _int8(c):
    return c.get("wire") == "int8"


def _exact(c):
    """Bit for bit against the global path: integer tables on the linear
    wires (both engines), the int8 ring (run op by op)."""
    if _int8(c):
        return c.get("engine") == "ring"
    robust = str(c.get("recovery", "")).split(":")[0] in (
        "median", "trimmed", "clip")
    return c.get("kind", "int") == "int" and not robust \
        and not c.get("corruption", "").startswith("collude")


def _bf16(c):
    return c.get("wire") == "bf16" or c.get("rs_dtype") == "bfloat16"


def _bf16_ulp(got, want):
    """Within one bf16 ulp of ``want``: the jitted reference keeps the
    bf16 wire's average in f32 (XLA:CPU elides the rounding to bf16 that
    the port, and the reference run op by op, make)."""
    if isinstance(want, dict):
        for k in want:
            _bf16_ulp(got[k], want[k])
        return
    w = np.abs(want.astype(np.float64))
    ulp = np.exp2(np.floor(np.log2(np.maximum(w, 2.0 ** -126))) - 7)
    assert np.all(np.abs(got - want) <= ulp), np.max(np.abs(got - want))


def _close(got, want, exact, rtol=0.0, atol=2e-5):
    if isinstance(want, dict):
        for k in want:
            _close(got[k], want[k], exact, rtol, atol)
        return
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", GLOBAL)
def test_collective_equals_reference_global_path(results, name):
    """Each case, every rank, against the reference's global path on the
    stacked inputs (the int8 cases on its per-group uniforms, handed to
    each rank in its scatter layout)."""
    port, _, glob = results
    c = CASES[name]
    want = glob[name]
    exact = _exact(c)
    if c.get("ef") is not None:
        _close(_stack(port[name]), want[0], exact)
        _close(_stack(port[name], "ef"), want[1], exact)
        return
    got = _stack(port[name])
    if c["entry"] == "flat" and _int8(c) and not exact:
        # the decoded contributions summed in another order
        _close(got, want, False, rtol=1e-5, atol=1e-5)
    else:
        _close(got, want, exact)


@pytest.mark.parametrize("name", COLL)
def test_collective_equals_reference_collective_path(results, name):
    """The marked cases against the reference's own collective entry
    points under shard_map (four host devices), on the same masks and,
    for int8, the uniforms of its per-rank keys."""
    port, ref, _ = results
    c = CASES[name]
    want = ref[name]
    got = _stack(port[name])
    if c.get("ef") is not None:
        want, want_ef = want
        if _int8(c):    # jitted: the encode's reciprocal, rel 1e-5 a row
            np.testing.assert_allclose(_stack(port[name], "ef")["a"],
                                       want_ef["a"], rtol=1e-5, atol=1e-5)
        else:
            _close(_stack(port[name], "ef"), want_ef, True)
    if _int8(c):
        _close(got, want, False, rtol=1e-5, atol=1e-5)
    elif _bf16(c):
        _bf16_ulp(got, want)
    else:
        # bit for bit on the ring (the reference's test_ring.py); the xla
        # engine's jitted division may take a reciprocal (its
        # test_multiserver.py holds collective to global within 2e-5)
        _close(got, want, _exact(c) and c.get("engine") == "ring"
               and c.get("recovery") != "scale")


@pytest.mark.parametrize("name", [k for k, c in CASES.items()
                                  if c.get("taps")])
def test_collective_taps_equal_reference_counters(results, name):
    """The per-call taps (delivered, late and corrupt counts per sender,
    the divisor) equal the reference's counters on the same masks, on
    every rank."""
    port, _, _ = results
    c = CASES[name]
    want = _ref_taps(c)
    for r in range(N):
        taps = port[name][r]["taps"]
        order = list(jplan.make_plan(
            jax.tree.map(lambda v: jax.ShapeDtypeStruct(v.shape[1:],
                                                        v.dtype), c["x"]),
            N, **c["plan_kw"]).buckets) if c["entry"] == "plan" else None
        for k, v in want.items():
            got = np.asarray(taps[k])
            if got.ndim == v.ndim - 1:
                got = got[None]
            if order is not None and c["plan_kw"].get("schedule") == "async":
                got = got[::-1]          # shipped in reverse plan order
            np.testing.assert_array_equal(got, v, err_msg=k)
