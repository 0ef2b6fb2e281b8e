"""The port's checkpoints (``repro_torch.checkpoint``) against the JAX
package's: round trips of f32, bf16, int8 and packed-state trees, files
that cross between the two packages bit for bit, an exact resume of the
simulator from a checkpointed state, and the shape check."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro_torch import checkpoint as tckpt
from repro_torch import tree as tree_lib
from repro_torch.data import synthetic as tdata
from repro_torch.optim import make_optimizer
from repro_torch.optim import statepack
from repro_torch.train import simulator as tsim
from _torch_sim import mlp_loss_t


def _tree(dtype: str, seed: int = 0):
    """A nested tree of numpy arrays of one dtype (bf16 as its f32
    values), with a list, a tuple and a scalar leaf."""
    rng = np.random.default_rng(seed)
    if dtype == "int8":
        mk = lambda *s: rng.integers(-127, 128, s).astype(np.int8)  # noqa
    else:
        mk = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa
    return {"w": mk(4, 5), "layers": [{"a": mk(3), "b": mk(2, 2)},
                                      {"a": mk(3), "b": mk(2, 2)}],
            "pair": (mk(6), mk(1)), "s": mk()}


def _torch_tree(t, dtype: str):
    tt = tree_lib.map(lambda x: torch.from_numpy(np.array(x)), t)
    return tree_lib.map(lambda x: x.to(torch.bfloat16), tt) \
        if dtype == "bfloat16" else tt


def _jax_tree(t, dtype: str):
    return jax.tree.map(lambda x: jnp.asarray(x, dtype), t)


def _bits(x) -> np.ndarray:
    """The raw bits of a tensor / array (bf16 as uint16)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy().copy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a


def _assert_same_bits(got, want) -> None:
    g, w = tree_lib.leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        ba, bb = _bits(a), _bits(b)
        assert ba.dtype == bb.dtype and ba.shape == bb.shape
        np.testing.assert_array_equal(ba, bb)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_round_trip(tmp_path, dtype):
    t = _torch_tree(_tree(dtype), dtype)
    path = str(tmp_path / "t.npz")
    tckpt.save_pytree(path, t)
    back = tckpt.load_pytree(path, t)
    assert isinstance(back["pair"], tuple) and isinstance(back["layers"],
                                                          list)
    for a, b in zip(tree_lib.leaves(back), tree_lib.leaves(t)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert not (tmp_path / "t.npz.tmp").exists()         # published


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_files_cross_between_packages(tmp_path, dtype, writer):
    """A file either package writes loads in the other bit for bit: the
    same keys (tree paths in JAX order), bf16 as tagged uint16 bits."""
    t = _tree(dtype, seed=1)
    tt, jt = _torch_tree(t, dtype), _jax_tree(t, dtype)
    path = str(tmp_path / "x.npz")
    if writer == "port":
        tckpt.save_pytree(path, tt)
        _assert_same_bits(tt, jckpt.load_pytree(path, jt))
    else:
        jckpt.save_pytree(path, jt)
        _assert_same_bits(tckpt.load_pytree(path, tt), jt)
    with np.load(path) as data:
        keys = sorted(data.files)
    want = ["layers/0/a", "layers/0/b", "layers/1/a", "layers/1/b",
            "pair/0", "pair/1", "s", "w"]
    if dtype == "bfloat16":
        want = [k + "::bf16" for k in want]
    assert keys == want


@pytest.mark.parametrize("pack", ["bf16", "i8"])
def test_packed_state_round_trip_and_crosses(tmp_path, pack):
    """Adam's packed state (bf16 m, int8 payloads, f32 scales, the int32
    step) and an i8-packed EF residual round-trip through save_state /
    load_state, and load into the reference's structure bit for bit."""
    rng = np.random.default_rng(2)
    params = {"w": torch.from_numpy(rng.normal(size=(4, 6, 5))
                                    .astype(np.float32)),
              "b": torch.from_numpy(rng.normal(size=(4, 5))
                                    .astype(np.float32))}
    opt = make_optimizer("adam", state_pack=pack)
    state = opt.init(params)
    grads = tree_lib.map(lambda x: x * 0.5 + 0.1, params)
    gen = torch.Generator().manual_seed(0)
    opt.update(grads, state, params, 0.01, noise=gen)
    ef = statepack.pack_tree(tree_lib.map(lambda x: x * 1e-3, params),
                             statepack.make_state_pack(pack).ef_format,
                             noise=gen)
    path = str(tmp_path / "s.npz")
    tckpt.save_state(path, params=params, opt_state=state, ef_state=ef,
                     ch_state=None)
    back = tckpt.load_state(path, params=params, opt_state=state,
                            ef_state=ef, ch_state=None)
    assert back["ch_state"] is None
    for a, b in zip(tree_lib.leaves((params, state, ef)),
                    tree_lib.leaves((back["params"], back["opt_state"],
                                     back["ef_state"]))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    like = jax.tree.map(lambda x: jnp.zeros(x.shape, {
        torch.bfloat16: jnp.bfloat16, torch.int8: jnp.int8,
        torch.int32: jnp.int32}.get(x.dtype, jnp.float32)),
        {"params": params, "opt_state": state, "ef_state": ef},
        is_leaf=lambda x: isinstance(x, torch.Tensor))
    want = jckpt.load_state(path, **like)
    _assert_same_bits({"params": params, "opt_state": state,
                       "ef_state": ef}, want)


def _teacher():
    task = tdata.TeacherTask(d_in=24, n_classes=8, seed=0, device="cpu")

    def init_fn(gen):
        return {"w1": torch.randn((24, 48), generator=gen) * 0.1,
                "w2": torch.randn((48, 8), generator=gen) * 0.1}

    return init_fn, tdata.make_worker_streams(task, 4, 8)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(optimizer="adam", state_pack="i8", wire="int8", recovery="ef",
         n_buckets=2),
], ids=["sgd", "adam-i8-int8-ef"])
def test_resume_from_checkpoint_is_exact(tmp_path, kw):
    """A run saved mid-way with save_state (params, optimizer state,
    channel state, EF residual), loaded with load_state and resumed ends
    bit for bit where the uninterrupted run ends (masks and noise
    injected: the port's own generators restart with a run)."""
    init_fn, batch_fn = _teacher()
    gen = torch.Generator().manual_seed(4)
    p1 = init_fn(gen)
    nb = kw.get("n_buckets")
    shape = (4, 4) if nb is None else (nb, 4, 4)
    masks = [(torch.rand(shape, generator=gen) > 0.3,
              torch.rand(shape, generator=gen) > 0.3) for _ in range(6)]

    def noise(t, which, i, shape):
        g = torch.Generator().manual_seed(1000 * t + 10 * i + len(which))
        return torch.rand(shape, generator=g)

    def wire(t, g_idx, shape):
        return noise(t, "wire", g_idx, shape)

    def cfg(steps):
        return tsim.SimulatorConfig(n_workers=4, drop_rate=0.3, steps=steps,
                                    eval_every=1, lr=0.2, **kw)

    run_kw = dict(device="cpu", init_params=p1, masks_fn=lambda t: masks[t],
                  wire_noise_fn=wire, pack_noise_fn=noise)
    full = tsim.run_simulation(mlp_loss_t, None, batch_fn, cfg(6), **run_kw)
    half = tsim.run_simulation(mlp_loss_t, None, batch_fn, cfg(3), **run_kw)
    path = str(tmp_path / "mid.npz")
    tckpt.save_state(path, **half["state"])
    restored = tckpt.load_state(path, **half["state"])
    resumed = tsim.run_simulation(mlp_loss_t, None, batch_fn, cfg(6),
                                  state=restored, start_step=3, **run_kw)
    assert resumed["loss"] == full["loss"][3:]
    for a, b in zip(tree_lib.leaves((full["params"], full["state"])),
                    tree_lib.leaves((resumed["params"],
                                     resumed["state"]))):
        assert a is b is None or torch.equal(a, b)


def test_shape_mismatch_raises(tmp_path):
    path = str(tmp_path / "m.npz")
    tckpt.save_pytree(path, {"w": torch.zeros(3, 4)})
    with pytest.raises(ValueError, match="w: shape"):
        tckpt.load_pytree(path, {"w": torch.zeros(4, 3)})
    with pytest.raises(KeyError):
        tckpt.load_pytree(path, {"v": torch.zeros(3, 4)})


def test_load_casts_to_the_like_dtype(tmp_path):
    """As the reference's ``jnp.asarray(arr, leaf.dtype)``: a leaf loads
    in the dtype of its ``like``."""
    path = str(tmp_path / "c.npz")
    tckpt.save_pytree(path, {"w": torch.tensor([1.5, -2.0])})
    back = tckpt.load_pytree(path, {"w": torch.zeros(2,
                                                      dtype=torch.bfloat16)})
    assert back["w"].dtype == torch.bfloat16
    assert back["w"].tolist() == [1.5, -2.0]
