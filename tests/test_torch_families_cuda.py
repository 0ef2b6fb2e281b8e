"""On the card: the kernels of the decoder families added beside the
first three. The MoE kind's lossy TP decode launches the TP-combine
kernel at its attention sites (the MoE FFN keeps the dense expert path)
and equals the exchange route bit for bit; the rwkv and rec train kinds
take the reference's XLA routes, so their loss and backward launch
neither forward-only kernel. Every test here needs a CUDA device and
skips without one; this file imports no JAX (the card's machine has
none), and the CPU parity of the same paths is in
tests/test_torch_moe.py and tests/test_torch_train_families.py.

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_families_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch import tree as tree_lib
from repro_torch.configs import get_config
from repro_torch.kernels import masked_avg as K
from repro_torch.kernels import rglru as rglru_kernel
from repro_torch.kernels import rwkv6 as rwkv6_kernel
from repro_torch.models import build_model
from repro_torch.serve import PagedCache, TPDecodeConfig, make_tp_context

PAGE = 8


@pytest.mark.cuda
def test_cuda_moe_tp_decode_launches_the_combine_at_attention_sites():
    """mixtral-8x22b-reduced's lossy TP decode launches the TP-combine
    kernel once per attention site and step (none for the MoE FFN), and
    its logits equal the exchange route's bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = get_config("mixtral-8x22b").reduced()
    model = build_model(cfg, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = model.init(gen)
    pc = PagedCache(model, PAGE, 20)
    S, B = 37, 2
    blocks = []
    for _ in range(B):
        toks = torch.randint(0, cfg.vocab_size, (1, S), generator=gen,
                             device="cuda")
        _, c = model.prefill(params, {"tokens": toks}, paged=True)
        blocks.append(pc.alloc.alloc(-(-(S + 1) // PAGE)))
        pc.write_prefill(c, blocks[-1], S)
    bt = torch.tensor(blocks, device="cuda")
    ctx = make_tp_context(TPDecodeConfig(n_shards=4, p=0.3), cfg, B)
    masks, _ = ctx.sample_site_masks(gen, None)
    args = ({"token": torch.ones((B, 1), dtype=torch.int64,
                                 device="cuda")},
            torch.full((B,), S, device="cuda"), bt)
    copy = [dict(lay, k=lay["k"].clone(), v=lay["v"].clone())
            for lay in pc.pool]
    ctx.fused = False
    want, _ = model.decode_paged(params, copy, *args, page=PAGE, masks=masks,
                                 tp=ctx)
    ctx.fused = True
    before = K.tp_combine.launches
    got, _ = model.decode_paged(params, pc.pool, *args, page=PAGE,
                                masks=masks, tp=ctx)
    torch.cuda.synchronize()
    assert K.tp_combine.launches - before == cfg.n_layers
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "recurrentgemma-9b"])
def test_cuda_train_kinds_take_the_xla_routes(arch):
    """The rwkv and rec kinds' loss and backward launch neither the
    RWKV-6 nor the RG-LRU kernel, their gradients are finite, and the
    loss equals the CPU's on the same weights within 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = get_config(arch).reduced()
    gen = torch.Generator()
    gen.manual_seed(0)
    params = build_model(cfg, device="cpu").init_stacked(gen)
    toks = torch.randint(0, cfg.vocab_size, (2, 33), generator=gen)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    want, _ = build_model(cfg, device="cpu").loss(params, batch)
    card = build_model(cfg, device="cuda")
    p = tree_lib.map(lambda x: x.cuda().requires_grad_(True), params)
    before = (rwkv6_kernel.rwkv6.launches, rglru_kernel.rglru.launches)
    loss, _ = card.loss(p, {k: v.cuda() for k, v in batch.items()})
    grads = torch.autograd.grad(loss, tree_lib.leaves(p))
    torch.cuda.synchronize()
    assert (rwkv6_kernel.rwkv6.launches, rglru_kernel.rglru.launches) == \
        before
    assert all(torch.isfinite(g).all() for g in grads)
    np.testing.assert_allclose(loss.item(), want.item(), rtol=1e-4)
