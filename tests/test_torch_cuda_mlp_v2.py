"""On the card: the chunk-pipelined W8A8 MLP kernel (`fused_mlp_block_v2`,
`kernels/csrc/mlp_block_v2_int8.cu`) against its plain PyTorch version and
against the three-launch kernel of the same function (`fused_mlp_block`),
in bf16. Every test here needs an NVIDIA GPU and skips without one. The
file imports torch only, so it runs on a machine that has no JAX:

    python -m pytest tests/test_torch_cuda_mlp_v2.py -q

Gate: the output within 1e-2 of each row's largest value (one bf16 ulp
there, plus what a flipped int8 step moves), as for `fused_mlp_block`; and
bit-equal to `fused_mlp_block`'s kernel at the same f_chunk, whose
roundings it repeats in the same order. T = 1024 + 64 is the shape of
`fused_mlp_block`'s card test (no multiple of the 128-row tile of either
kernel); 1024 + 40, 1000 and 1 leave the last cluster's rows ragged (TMA
reads its rows past T as zeros, and they are not stored); 4096 + 128
fills 33 clusters, more than the card runs at once.
"""

import pytest
import torch

from ullava_tpu_torch import kernels
from ullava_tpu_torch.ops import mlp_kernel, quant

_TOL = 1e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _rand(gen, *shape, scale=1.0, shift=0.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale + shift).to(torch.bfloat16)


def _row_rel_err(got, ref):
    got, ref = got.float().flatten(0, -2), ref.float().flatten(0, -2)
    return ((got - ref).abs().amax(-1) / ref.abs().amax(-1).clamp_min(1e-30)).max().item()


def _weight(gen, K, N, std=0.05):
    leaf = quant.quantize_int8(torch.randn((K, N), generator=gen, device="cuda") * std)
    return leaf["q"], leaf["scale"]


def _mlp_args(gen, T, C, F):
    x = _rand(gen, T, C, scale=2.0, shift=0.3)
    w1, s1 = _weight(gen, C, F)
    w2, s2 = _weight(gen, F, C)
    g, b = _rand(gen, C, scale=0.1, shift=1.0), _rand(gen, C, scale=0.1)
    b1, b2 = _rand(gen, F, scale=0.5), _rand(gen, C, scale=0.5)
    return (x, g, b, w1, s1, b1, w2, s2, b2, 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1024 + 64, 1024 + 40, 1000, 1, 4096 + 128])
@pytest.mark.parametrize("f_chunk", [512, 1024])
def test_cuda_fused_mlp_block_v2_matches_plain(cuda, f_chunk, T):
    args = _mlp_args(cuda, T, 1280, 5120)
    before = kernels.launch_counts()
    got = mlp_kernel.fused_mlp_block_v2(*args, f_chunk=f_chunk)
    after = kernels.launch_counts()
    launched = {k: n - before[k] for k, n in after.items() if n != before[k]}
    assert launched == {"fused_mlp_block_v2": 1}
    ref = mlp_kernel.fused_mlp_block_v2_plain(*args, f_chunk)
    assert got.shape == (T, 1280) and torch.isfinite(got.float()).all()
    assert _row_rel_err(got, ref) <= _TOL
    k12 = mlp_kernel._mlp_block_cuda(*args, f_chunk)[0]
    assert torch.equal(got, k12)


@pytest.mark.cuda
def test_cuda_fused_mlp_block_v2_refuses_unsupported_shapes(cuda):
    args = _mlp_args(cuda, 64, 1280, 5120)
    for f_chunk in (256, 2560):
        with pytest.raises(ValueError, match="f_chunk"):
            mlp_kernel.fused_mlp_block_v2(*args, f_chunk=f_chunk)
    args = _mlp_args(cuda, 64, 512, 2048)
    with pytest.raises(ValueError, match="C 512"):
        mlp_kernel.fused_mlp_block_v2(*args)
