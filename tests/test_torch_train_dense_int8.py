"""The n-worker simulator on the launcher's dense model on the int8 and
bf16 wires against the JAX package's, run op by op (the slowest parity
cases of the training slice, in a file of their own so that they run
beside tests/test_torch_train.py)."""
import dataclasses

import pytest

from repro.configs import get_config as jget_config
from repro.data import synthetic as jdata
from repro.models import build_model as jbuild_model
from repro_torch.configs import get_config as tget_config
from repro_torch.data import synthetic as tdata
from repro_torch.models import build_model as tbuild_model
from _torch_sim import run_both


def _dense_pair(arch, dtype=None):
    jcfg, tcfg = jget_config(arch).reduced(), tget_config(arch).reduced()
    if dtype is not None:
        jcfg = dataclasses.replace(jcfg, dtype=dtype)
        tcfg = dataclasses.replace(tcfg, dtype=dtype)
    jm, tm = jbuild_model(jcfg, grouped=False), tbuild_model(tcfg,
                                                              device="cpu")
    return jcfg, jm, tm


@pytest.mark.parametrize("kw,eager,chaotic_from", [
    (dict(wire="int8"), True, None),
    (dict(wire="int8", recovery="ef"), True, 4),
    (dict(wire="bf16", recovery="ef"), True, None),
], ids=["int8", "int8-ef", "bf16-ef"])
def test_simulator_int8_matches_reference_dense_model(kw, eager,
                                                      chaotic_from):
    """rps-paper-mlp (reduced, its weights in f32) on the char-LM task on
    the ring engine, the int8 wire with renorm and ef and the bf16 wire
    with ef: the per-step loss within 1e-4 over 10 steps, the consensus
    within 1e-4 — at int8 + ef for its first 4 steps (measured: at most
    1.9e-6 there, 7.4e-3 at step 4), 1e-2 after them. The MLP cases of
    test_simulator_int8_and_ef_match_reference_mlp hold the EF residual
    itself at 1e-4 over all 10 steps.

    Against the reference run op by op: jitted, it divides by 127 as a
    product by its reciprocal and keeps the ring's bf16 adds in f32; at
    int8 its consensus is 0.52 % from its own op-by-op run's by step 10
    (the port's: 4.4e-6), at bf16 its loss 1.1e-4. The int8 grid makes this run chaotic: a
    last-bit difference that moves one value across a rounding boundary
    moves it a whole grid step, which alone shifts the consensus by about
    1e-3; a one-ulp change of the initial weights moves the consensus by
    2.5 % within 4 steps at int8 + ef, by 1e-4 at the bf16 wire (measured
    on the CPU). One exchange is bitwise (tests/test_torch_ring_int8.py).
    In f32, where the weights rarely sit on an exact tie of x / Δ, as bf16
    weights often do."""
    jcfg, jm, tm = _dense_pair("rps-paper-mlp", dtype="float32")
    jtask = jdata.CharLMTask(vocab=jcfg.vocab_size, seq_len=16, seed=0)
    ttask = tdata.CharLMTask(vocab=jcfg.vocab_size, seq_len=16, seed=0,
                             device="cpu")
    run_both(dict(aggregator="rps_model", drop_rate=0.3, engine="ring",
                  lr=0.05, **kw),
             lambda p, b: jm.loss(p, b)[0], jm.init,
             jdata.make_worker_streams(jtask, 4, 2),
             lambda p, b: tm.loss(p, b)[0],
             tdata.make_worker_streams(ttask, 4, 2), steps=10, eager=eager,
             chaotic_from=chaotic_from)
