"""On the card: the four CUDA kernels of the training path (flash forward
with logsumexp, the flash backward's fused pass and dq finish, RMSNorm
backward) against their
plain PyTorch versions in bf16, and the routing of the training forward
through them under autograd. Every test here needs an NVIDIA GPU and skips
without one. The file imports torch only, so it runs on a machine that has
no JAX:

    python -m pytest tests/test_torch_cuda_train.py -q

Gates: bf16 outputs within 1e-2 of each row's largest value (one bf16 ulp
there, at most 2^-7 of it); gradients the same, except that a row's scale
is floored at 2^-8 of the tensor's largest value, since a gradient row can
be zero by cancellation (dq of the first query, whose one live key gives
dP = delta), where the kernel's fp32 sums leave noise of 1e-7; lse within
1e-4 absolute (fp32 sums in another order; a few units in size) and
exactly 1e30 on rows with no live key; dw within 1e-2 of its largest
value.
"""

import dataclasses

import pytest
import torch

from ullava_tpu_torch import kernels
from ullava_tpu_torch.models import llama
from ullava_tpu_torch.ops import attention, norms

_TOL = 1e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _rand(gen, *shape, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)


def _row_rel_err(got, ref):
    got, ref = got.float().flatten(0, -2), ref.float().flatten(0, -2)
    return ((got - ref).abs().amax(-1) / ref.abs().amax(-1).clamp_min(1e-30)).max().item()


def _grad_rel_err(got, ref):
    got, ref = got.float().flatten(0, -2), ref.float().flatten(0, -2)
    scale = ref.abs().amax(-1).clamp_min(ref.abs().max().item() * 2.0**-8 + 1e-30)
    return ((got - ref).abs().amax(-1) / scale).max().item()


_CASES = [(True, (200, 77)), (True, None), (False, (130, 200)), (True, (200, 0))]


@pytest.mark.cuda
@pytest.mark.parametrize("causal,lens", _CASES)
def test_cuda_flash_fwd_lse_matches_plain(cuda, causal, lens):
    q, k, v = (_rand(cuda, 2, 200, 4, 128) for _ in range(3))
    kv = torch.tensor(lens or (200, 200), dtype=torch.int32, device="cuda")
    o, lse = attention.flash_attention_fwd(q, k, v, kv, causal=causal, scale=128**-0.5)
    o_ref, lse_ref = attention.flash_attention_fwd_plain(q, k, v, kv, causal=causal,
                                                         scale=128**-0.5)
    assert _row_rel_err(o, o_ref) <= _TOL
    dead = lse_ref >= 1e29
    assert torch.equal(lse >= 1e29, dead) and bool((lse[dead] == 1e30).all())
    assert (lse[~dead] - lse_ref[~dead]).abs().max().item() <= 1e-4


# The edges of K15's 128-row query tiles and heavy-first block order:
# name: (B, Sq, Sk, H, Hkv, kv_lens, causal, q_offset).
_EDGES = {
    "sq_200": (2, 200, 200, 4, 4, (200, 131), True, 0),
    "q_offset_128": (2, 128, 256, 4, 4, (256, 200), True, 128),
    "kv_len_0": (2, 128, 128, 4, 4, (128, 0), True, 0),
    "non_causal_ragged": (2, 128, 192, 4, 4, (150, 37), False, 0),
    "gqa_rep_2": (2, 256, 256, 4, 2, (256, 190), True, 0),
    "stage1": (4, 1024, 1024, 32, 32, (1024, 1000, 777, 513), True, 0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(_EDGES))
def test_cuda_flash_fwd_lse_edges(cuda, name):
    B, Sq, Sk, H, Hkv, lens, causal, q_offset = _EDGES[name]
    q = _rand(cuda, B, Sq, H, 128)
    k, v = (_rand(cuda, B, Sk, Hkv, 128) for _ in range(2))
    kv = torch.tensor(lens, dtype=torch.int32, device="cuda")
    kw = dict(causal=causal, scale=128**-0.5, q_offset=q_offset)
    o, lse = attention.flash_attention_fwd(q, k, v, kv, **kw)
    o_ref, lse_ref = attention.flash_attention_fwd_plain(q, k, v, kv, **kw)
    torch.cuda.synchronize()
    assert _row_rel_err(o, o_ref) <= _TOL
    dead = lse_ref >= 1e29
    assert torch.equal(lse >= 1e29, dead) and bool((lse[dead] == 1e30).all())
    assert not o.transpose(1, 2)[dead].any()
    assert (lse[~dead] - lse_ref[~dead]).abs().max().item() <= 1e-4


def _bwd_inputs(gen, name):
    B, Sq, Sk, H, Hkv, lens, causal, q_offset = _EDGES[name]
    q, do = (_rand(gen, B, Sq, H, 128) for _ in range(2))
    k, v = (_rand(gen, B, Sk, Hkv, 128) for _ in range(2))
    kv = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return q, k, v, do, kv, dict(causal=causal, scale=128**-0.5, q_offset=q_offset)


@pytest.mark.cuda
@pytest.mark.parametrize("name", [n for n in _EDGES if n != "gqa_rep_2"])
def test_cuda_flash_bwd_edges(cuda, name):
    """The fused backward's key tiles at the forward's edges: a ragged last
    query tile, a query offset past the first key tile, a batch row with no
    live key, ragged kv_lens without the causal mask, the stage-1 shape."""
    q, k, v, do, kv, kw = _bwd_inputs(cuda, name)
    o, lse = attention.flash_attention_fwd(q, k, v, kv, **kw)
    got = attention.flash_attention_bwd(q, k, v, o, lse, do, kv, **kw)
    ref = attention.flash_attention_bwd_plain(q, k, v, o, lse, do, kv, **kw)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert _grad_rel_err(g, r) <= _TOL
    for b, n in enumerate(kv.tolist()):  # key rows at or past kv_len: exact zeros
        assert not got[1][b, n:].any() and not got[2][b, n:].any()


@pytest.mark.cuda
def test_cuda_flash_bwd_delta_prepass(cuda):
    """The pre-pass: delta within 1e-5 of its largest value (fp32 sums in
    another order), the accumulator zeroed whatever it held."""
    q, k, v, do, kv, kw = _bwd_inputs(cuda, "sq_200")
    o = _rand(cuda, *q.shape)
    B, Sq, H, _ = q.shape
    delta = torch.empty(B, H, Sq, device="cuda")
    acc = torch.full(q.shape, 7.0, device="cuda")
    kernels.launch("flash_attention_bwd_delta", do.data_ptr(), o.data_ptr(), delta.data_ptr(),
                   acc.data_ptr(), Sq, H, B * Sq * H)
    ref = attention.flash_bwd_delta_plain(o, do)
    assert (delta - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    assert not acc.any()


@pytest.mark.cuda
def test_cuda_flash_bwd_refuses_gqa(cuda):
    q, k, v, do, kv, kw = _bwd_inputs(cuda, "gqa_rep_2")
    o = torch.zeros_like(q)
    lse = torch.zeros(q.shape[0], q.shape[2], q.shape[1], device="cuda")
    with pytest.raises(ValueError, match="GQA"):
        attention.flash_attention_bwd(q, k, v, o, lse, do, kv, **kw)


@pytest.mark.cuda
def test_cuda_flash_bwd_dk_dv_deterministic(cuda):
    """dk and dv have one owner a row: bit-equal over two calls. dq's fp32
    sums arrive by reduce-adds in no fixed order: within one bf16 ulp of
    a row's largest value between the calls."""
    q, k, v, do, kv, kw = _bwd_inputs(cuda, "stage1")
    o, lse = attention.flash_attention_fwd(q, k, v, kv, **kw)
    dq, dk, dv = attention.flash_attention_bwd(q, k, v, o, lse, do, kv, **kw)
    dq2, dk2, dv2 = attention.flash_attention_bwd(q, k, v, o, lse, do, kv, **kw)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    assert _grad_rel_err(dq2, dq) <= _TOL


@pytest.mark.cuda
@pytest.mark.parametrize("warn_only", [False, True])
def test_cuda_flash_bwd_follows_deterministic_mode(cuda, warn_only):
    """dq's order-dependent sums make the backward nondeterministic: under
    torch's deterministic mode it raises before it launches, with
    `warn_only` it warns and runs, as torch's own such kernels do."""
    q, k, v, do, kv, kw = _bwd_inputs(cuda, "stage1")
    o, lse = attention.flash_attention_fwd(q, k, v, kv, **kw)
    ref = attention.flash_attention_bwd(q, k, v, o, lse, do, kv, **kw)
    before = dict(kernels.launch_counts())
    torch.use_deterministic_algorithms(True, warn_only=warn_only)
    try:
        if warn_only:
            with pytest.warns(UserWarning, match="flash_attention_bwd"):
                got = attention.flash_attention_bwd(q, k, v, o, lse, do, kv, **kw)
            assert torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2])
        else:
            with pytest.raises(RuntimeError, match="flash_attention_bwd"):
                attention.flash_attention_bwd(q, k, v, o, lse, do, kv, **kw)
    finally:
        torch.use_deterministic_algorithms(False)
    ran = kernels.launch_counts()["flash_attention_bwd_dkv"] - before["flash_attention_bwd_dkv"]
    assert ran == (1 if warn_only else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("causal,lens", _CASES)
def test_cuda_flash_bwd_matches_plain(cuda, causal, lens):
    q, k, v = (_rand(cuda, 2, 200, 4, 128) for _ in range(3))
    do = _rand(cuda, 2, 200, 4, 128)
    kv = torch.tensor(lens or (200, 200), dtype=torch.int32, device="cuda")
    o, lse = attention.flash_attention_fwd(q, k, v, kv, causal=causal, scale=128**-0.5)
    got = attention.flash_attention_bwd(q, k, v, o, lse, do, kv, causal=causal, scale=128**-0.5)
    ref = attention.flash_attention_bwd_plain(q, k, v, o, lse, do, kv, causal=causal,
                                              scale=128**-0.5)
    for g, r in zip(got, ref):
        assert _grad_rel_err(g, r) <= _TOL
    # Key rows at or past kv_len get exact zeros.
    for b, n in enumerate(lens or (200, 200)):
        assert not got[1][b, n:].any() and not got[2][b, n:].any()


# Row widths of each register layout the kernel takes (1, 2, 4 and 8
# vectors a thread; 4104 and 1032 leave the last vectors of a row to some
# threads only), row counts below, at and far above the rows in flight.
@pytest.mark.cuda
@pytest.mark.parametrize("rows,D", [(300, 4096), (64, 128), (1, 4096), (4096, 4096),
                                    (1000, 8192), (5, 4104), (333, 1032), (7, 2048)])
def test_cuda_rms_norm_bwd_matches_plain(cuda, rows, D):
    x = _rand(cuda, rows, D, scale=2.0)
    dy = (0.5 * x.float() + torch.randn(rows, D, generator=cuda, device="cuda")).to(torch.bfloat16)
    w = (1 + 0.1 * torch.randn(D, generator=cuda, device="cuda")).to(torch.bfloat16)
    dx_ref, dw_ref = norms.rms_norm_bwd_plain(x, w, dy, 1e-6)
    dx, none = norms.rms_norm_bwd(x, w, dy, 1e-6, need_dw=False)
    assert none is None and _row_rel_err(dx, dx_ref) <= _TOL
    dx2, dw = norms.rms_norm_bwd(x, w, dy, 1e-6, need_dw=True)
    assert torch.equal(dx2, dx)
    assert _row_rel_err(dw[None], dw_ref[None]) <= _TOL
    # Deterministic: the dw partials are summed in a fixed order.
    assert torch.equal(norms.rms_norm_bwd(x, w, dy, 1e-6, need_dw=True)[1], dw)


@pytest.mark.cuda
def test_cuda_rms_norm_bwd_refuses_rows_wider_than_its_registers(cuda):
    D = norms.MAX_BWD_ROW_WIDTH + 8
    x = _rand(cuda, 4, D)
    w = torch.ones(D, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="exceeds"):
        norms.rms_norm_bwd(x, w, x, 1e-6, need_dw=False)


@pytest.mark.cuda
def test_cuda_training_forward_routes_through_the_kernels(cuda):
    """One remat'd layer under autograd: the flash Function (K15 twice with
    the recompute, the backward's pre-pass, K16, K17), the norms (K9, K18; dw where the norm weight
    trains), no K2; without autograd the serving route (K2) as before.
    Gradients against the same layer in fp32 through the plain versions."""
    cfg = llama.LlamaConfig(vocab_size=256, hidden_size=256, intermediate_size=512,
                            num_layers=1, num_heads=2, num_kv_heads=2)
    params = llama.init_params(cfg, cuda, "cuda")
    for t in (params["layers"][0]["input_norm"], params["layers"][0]["q_proj"], params["norm"]):
        t.requires_grad_(True)
    emb = _rand(cuda, 2, 192, 256).requires_grad_(True)
    proj = torch.randn(2, 192, 256, generator=cuda, device="cuda")  # loss = <h, proj>
    lens = torch.tensor([192, 150], dtype=torch.int32, device="cuda")
    kernels.reset_launch_counts()
    out = llama.forward(params, cfg, inputs_embeds=emb, kv_lens=lens, compute_logits=False)
    h = out["hidden_states"]
    assert h.grad_fn is not None
    leaves = (emb, params["layers"][0]["input_norm"], params["layers"][0]["q_proj"], params["norm"])
    grads = torch.autograd.grad((h.float() * proj).sum(), leaves)
    torch.cuda.synchronize()
    counts = {k: n for k, n in kernels.launch_counts().items() if n}
    assert counts == {"flash_attention_fwd_lse": 2, "flash_attention_bwd_delta": 1,
                      "flash_attention_bwd_dkv": 1, "flash_attention_bwd_dq": 1,
                      "rms_norm_fwd": 5, "rms_norm_bwd": 3}
    assert all(torch.isfinite(g).all() and g.abs().max() > 0 for g in grads)

    c32 = dataclasses.replace(cfg, dtype=torch.float32, remat=False)
    p32 = {"embed_tokens": params["embed_tokens"].detach().cpu().float(),
           "layers": [{k: v.detach().cpu().float() for k, v in params["layers"][0].items()}],
           "norm": params["norm"].detach().cpu().float(),
           "lm_head": params["lm_head"].detach().cpu().float()}
    leaves32 = (emb.detach().cpu().float(), p32["layers"][0]["input_norm"],
                p32["layers"][0]["q_proj"], p32["norm"])
    for t in leaves32:
        t.requires_grad_(True)
    h32 = llama.forward(p32, c32, inputs_embeds=leaves32[0], kv_lens=lens.cpu(),
                        compute_logits=False)["hidden_states"]
    refs = torch.autograd.grad((h32 * proj.cpu()).sum(), leaves32)
    for g, r in zip(grads, refs):  # bf16 activations against fp32
        err = ((g.float().cpu() - r).abs().max() / r.abs().max()).item()
        assert err <= 5e-2, err

    kernels.reset_launch_counts()
    with torch.no_grad():
        llama.forward(params, cfg, inputs_embeds=emb, kv_lens=lens, compute_logits=False)
    counts = {k: n for k, n in kernels.launch_counts().items() if n}
    assert counts == {"flash_attention_fwd_bsh": 1, "rms_norm_fwd": 3}
