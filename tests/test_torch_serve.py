"""The port's serving path: allocator and scheduler policy (mirroring
tests/test_serve_continuous.py), the continuous-batching engine against
the JAX package's (same weights, greedy, dense), lossy TP serving, the
load generator, the launcher, and the port's import and device rules.
"""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.netsim import NetConfig as JaxNetConfig
from repro.netsim import request_trace as jax_request_trace
from repro.serve import ContinuousEngine as JaxEngine
from repro.serve import make_requests as jax_make_requests
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build_model
from repro_torch.netsim import NetConfig, request_trace
from repro_torch.serve import (BlockAllocator, ContinuousEngine, PagedCache,
                               Request, Scheduler, TPDecodeConfig,
                               make_requests, n_pages)
from repro_torch.serve.kvcache import NULL_BLOCK
from repro_torch.serve.scheduler import FINISHED, RUNNING, WAITING

ROOT = Path(__file__).resolve().parent.parent


# ---------------------------------------------------------------------------
# Block allocator
# ---------------------------------------------------------------------------

def test_allocator_lowest_first_and_null_reserved():
    a = BlockAllocator(8)
    assert a.capacity == 7
    got = a.alloc(3)
    assert got == [1, 2, 3]
    assert NULL_BLOCK not in got


def test_allocator_all_or_nothing():
    a = BlockAllocator(4)
    assert a.alloc(3) == [1, 2, 3]
    assert a.alloc(1) is None
    a.free([2])
    assert a.n_free == 1
    assert a.alloc(2) is None
    assert a.alloc(1) == [2]


def test_allocator_free_validation():
    a = BlockAllocator(4)
    ids = a.alloc(2)
    a.free(ids)
    with pytest.raises(ValueError, match="double free"):
        a.free([ids[0]])
    with pytest.raises(ValueError, match="foreign"):
        a.free([0])


# ---------------------------------------------------------------------------
# Scheduler
# ---------------------------------------------------------------------------

def _req(rid, S=8, max_new=4, arrival=0.0):
    return Request(rid=rid, prompt=np.zeros(S, np.int32), max_new=max_new,
                   arrival_ms=arrival)


def _sched(n_blocks=64, max_batch=4, page=4, chunk=4):
    return Scheduler(BlockAllocator(n_blocks), max_batch=max_batch,
                     page=page, chunk=chunk)


def test_admission_is_fcfs_by_arrival():
    s = _sched(max_batch=2)
    for rid, t in [(0, 5.0), (1, 1.0), (2, 3.0)]:
        s.add(_req(rid, arrival=t))
    admitted, _ = s.schedule()
    assert [r.rid for r in admitted] == [1, 2]
    assert [r.rid for r in s.waiting] == [0]
    assert all(r.state == RUNNING for r in admitted)
    assert admitted[0].pos == admitted[0].prefill_len


def test_head_of_line_blocking():
    s = _sched(n_blocks=5, max_batch=4, page=4, chunk=4)
    s.add(_req(0, S=9, max_new=4, arrival=0.0))
    s.add(_req(1, S=9, max_new=4, arrival=1.0))
    s.add(_req(2, S=2, max_new=2, arrival=2.0))
    admitted, _ = s.schedule()
    assert [r.rid for r in admitted] == [0]
    assert [r.rid for r in s.waiting] == [1, 2]


def test_oom_preempts_youngest():
    s = _sched(n_blocks=7, max_batch=2, page=4, chunk=4)
    r0 = _req(0, S=8, max_new=9, arrival=0.0)
    r1 = _req(1, S=8, max_new=9, arrival=1.0)
    s.add(r0), s.add(r1)
    admitted, _ = s.schedule()
    assert [r.rid for r in admitted] == [0, 1]
    s.advance(r0, [0] * 4), s.advance(r1, [0] * 4)
    _, preempted = s.schedule()
    assert [r.rid for r in preempted] == [1]
    assert r1.state == WAITING and r1.blocks == [] and r1.n_preempt == 1
    assert r1.generated == [0] * 4
    assert r0.state == RUNNING and len(r0.blocks) == 4


def test_no_starvation_oldest_always_finishes_first():
    s = _sched(n_blocks=6, max_batch=3, page=4, chunk=4)
    reqs = [_req(i, S=8, max_new=9, arrival=float(i)) for i in range(3)]
    for r in reqs:
        s.add(r)
    finish_order = []
    for _ in range(50):
        if s.idle:
            break
        s.schedule()
        for r in list(s.running):
            s.advance(r, [0] * min(s.chunk, r.n_left))
            if r.state == FINISHED and r.rid not in finish_order:
                finish_order.append(r.rid)
    assert s.idle
    assert finish_order == [0, 1, 2]


def test_add_rejects_request_larger_than_pool():
    s = _sched(n_blocks=3, page=4)
    with pytest.raises(ValueError, match="blocks"):
        s.add(_req(0, S=12, max_new=8))


def test_request_slot_accounting():
    r = _req(0, S=10, max_new=5)
    assert r.total_slots == 14
    assert n_pages(14, 4) == 4
    with pytest.raises(ValueError, match="max_new"):
        _req(1, max_new=0)


# ---------------------------------------------------------------------------
# Engine against the JAX package's engine (gemma3 reduced, f32, dense)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def served():
    cfg_j = jax_get_config("gemma3-1b").reduced()
    cfg_t = get_config("gemma3-1b").reduced()
    model_j = jax_build_model(cfg_j, grouped=False)
    params_j = jax.jit(model_j.init)(jax.random.PRNGKey(0))
    model_t = build_model(cfg_t, device="cpu")
    params_t = params_from_jax(jax.tree.map(np.asarray, params_j), cfg_t,
                               device="cpu")
    return model_j, params_j, model_t, params_t


def _requests(vocab, lens, max_new, seed):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(0, vocab, size=S),
                    max_new=m) for i, (S, m) in enumerate(zip(lens, max_new))]


def _jax_requests(reqs):
    from repro.serve import Request as JaxRequest
    return [JaxRequest(rid=r.rid, prompt=r.prompt.copy(), max_new=r.max_new)
            for r in reqs]


def test_engine_greedy_tokens_equal_jax_engine(served):
    """Three requests over two lanes (one joins when a lane frees), one
    prompt past the 64-token window: identical greedy tokens."""
    model_j, params_j, model_t, params_t = served
    reqs = _requests(model_t.cfg.vocab_size, (12, 70, 12), (6, 9, 5), 0)
    kw = dict(page=4, n_blocks=65, max_batch=2, chunk=4, max_len=96)
    want = JaxEngine(model_j, params_j, **kw).run(_jax_requests(reqs),
                                                  drain=True)
    got = ContinuousEngine(model_t, params_t, **kw).run(reqs, drain=True)
    assert got.outputs() == want.outputs()
    assert {r.rid: len(r.generated) for r in got.requests} \
        == {r.rid: r.max_new for r in reqs}


def test_engine_preemption_equals_jax_engine(served):
    """A pool too small for the load forces evict + re-prefill in both
    engines; the tokens still agree, and equal an unpreempted run."""
    model_j, params_j, model_t, params_t = served
    reqs = _requests(model_t.cfg.vocab_size, (10, 10, 10), (9, 9, 9), 1)
    kw = dict(page=4, n_blocks=9, max_batch=3, chunk=4, max_len=32)
    want = JaxEngine(model_j, params_j, **kw).run(_jax_requests(reqs),
                                                  drain=True)
    tight = ContinuousEngine(model_t, params_t, **kw).run(
        [dataclasses.replace(r) for r in reqs], drain=True)
    assert sum(r.n_preempt for r in tight.requests) > 0
    assert tight.outputs() == want.outputs()
    roomy = ContinuousEngine(model_t, params_t,
                             **dict(kw, n_blocks=65)).run(reqs, drain=True)
    assert sum(r.n_preempt for r in roomy.requests) == 0
    assert roomy.outputs() == tight.outputs()


def test_paged_prefill_matches_contiguous_view(served):
    _, _, model_t, params_t = served
    S = 10
    toks = torch.arange(1, S + 1)[None, :]
    _, cache = model_t.prefill(params_t, {"tokens": toks}, paged=True)
    pc = PagedCache(model_t, page=4, n_blocks=9)
    blocks = pc.alloc.alloc(n_pages(S, 4))
    pc.write_prefill(cache, blocks, S)
    for got, want in zip(pc.gather_contiguous(blocks, S), cache):
        for leaf in ("k", "v"):
            torch.testing.assert_close(got[leaf], want[leaf], rtol=0, atol=0)


def test_lossy_tp_decode_serves_to_completion(served):
    """4-shard TP decode at p = 0.3: drops perturb values, never the
    control flow."""
    _, _, model_t, params_t = served
    reqs = _requests(model_t.cfg.vocab_size, (6, 10, 14), (3, 5, 9), 3)
    eng = ContinuousEngine(model_t, params_t, page=4, n_blocks=33,
                           max_batch=2, chunk=4, max_len=32,
                           tp=TPDecodeConfig(n_shards=4, p=0.3))
    assert eng.tp_ctx is not None and eng.tp_ctx.n_sites == 4
    rep = eng.run(reqs, drain=True)
    assert {r.rid: len(r.generated) for r in rep.requests} \
        == {r.rid: r.max_new for r in reqs}
    assert all(0 <= t < model_t.cfg.vocab_size
               for v in rep.outputs().values() for t in v)
    again = ContinuousEngine(model_t, params_t, page=4, n_blocks=33,
                             max_batch=2, chunk=4, max_len=32,
                             tp=TPDecodeConfig(n_shards=4, p=0.3))
    assert again.run([dataclasses.replace(r, generated=[], state=WAITING)
                      for r in reqs], drain=True).outputs() == rep.outputs()


def test_engine_rejects_oversized_request(served):
    _, _, model_t, params_t = served
    eng = ContinuousEngine(model_t, params_t, page=4, n_blocks=17,
                           max_len=16)
    bad = Request(rid=0, prompt=np.zeros(12, np.int32), max_new=8)
    with pytest.raises(ValueError, match="prompt_len 12 \\+ max_new 8"):
        eng.run([bad], drain=True)


# ---------------------------------------------------------------------------
# Load generator, launcher, device and import rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7])
def test_request_trace_and_requests_equal_reference(seed):
    a = request_trace(100.0, NetConfig(sim_s=0.5), n_requests=20, seed=seed)
    b = jax_request_trace(100.0, JaxNetConfig(sim_s=0.5), n_requests=20,
                          seed=seed)
    assert a == b
    assert request_trace(50.0) == jax_request_trace(50.0)
    for rt, rj in zip(make_requests(a, 512, seed), jax_make_requests(b, 512,
                                                                     seed)):
        np.testing.assert_array_equal(rt.prompt, rj.prompt)
        assert (rt.max_new, rt.arrival_ms) == (rj.max_new, rj.arrival_ms)


def test_launcher_serves_on_cpu():
    rep = launch_serve.main(["--serve", "continuous", "--tp-shards", "4",
                             "-p", "0.1", "--requests", "4", "--drain",
                             "--device", "cpu"])
    assert len(rep.requests) == 4
    assert all(len(r.generated) == r.max_new for r in rep.requests)
    # the default --serve legacy now serves gemma3 on the contiguous cache
    out = launch_serve.main(["--device", "cpu"])
    assert out.shape == (4, 16)


def test_entry_points_default_to_cuda():
    """Without ``device=`` the port asks for CUDA: it runs there on a GPU
    machine and raises on one without."""
    cfg = get_config("gemma3-1b").reduced()
    if torch.cuda.is_available():
        assert build_model(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            build_model(cfg)
        with pytest.raises(RuntimeError, match="cuda"):
            params_from_jax({}, cfg)


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, env=env,
                         timeout=120, cwd=str(ROOT))
    assert out.returncode != 0
    assert out.stdout == ""


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py",
              ROOT / "tools" / "profile_torch_serve.py",
              ROOT / "tools" / "rglru_variants.py",
              ROOT / "tools" / "ring_rank_variants.py"]
    assert len(files) > 20
    bad = [(str(f.relative_to(ROOT)), name) for f in files
           for name in _imports(f)
           if name.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == []
