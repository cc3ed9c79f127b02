"""On the card: the SAM image encoder's `attn_kernel="xla"` route on CUDA
tensors. It takes the JAX package's routes off the TPU (plain attention
with the materialised rel-pos bias in the block layout, the plain MLP)
and launches no kernel at all; it agrees with the kernels' route ("auto")
within 5e-2 of each row's largest value (the SAM-encoder gate of
`chip_smoke.py`), and with the same route on the CPU in fp32 within 1e-3.
The encoder is ViT-B's widths (768, 12 heads of 64) at 1024 px, cut to
one group of four blocks (three window blocks and a global one). It
needs an NVIDIA GPU and skips without one; the file imports torch only:

    python -m pytest tests/test_torch_cuda_sam_xla.py -q
"""

import dataclasses

import pytest
import torch

from ullava_tpu_torch import kernels
from ullava_tpu_torch.models.sam import image_encoder


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _row_rel_err(got, ref):
    got, ref = got.float().flatten(0, -2), ref.float().flatten(0, -2)
    return ((got - ref).abs().amax(-1) / ref.abs().amax(-1).clamp_min(1e-30)).max().item()


@pytest.mark.cuda
def test_xla_route_on_cuda_tensors(cuda):
    cfg = image_encoder.SamVisionConfig(embed_dim=768, depth=4, num_heads=12,
                                        global_attn_indexes=(3,), window_layout="block")
    params = image_encoder.init_params(cfg, cuda, "cuda")
    img = torch.randn((1, 1024, 1024, 3), generator=cuda, device="cuda")
    ref = image_encoder.encode(params, cfg, img)
    xla = dataclasses.replace(cfg, attn_kernel="xla")
    torch.cuda.synchronize()
    before = kernels.launch_counts()
    got = image_encoder.encode(params, xla, img)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == before  # no kernel launched
    assert got.shape == ref.shape and torch.isfinite(got).all()
    assert _row_rel_err(got, ref) <= 5e-2

    f32 = dataclasses.replace(xla, dtype=torch.float32)
    p32 = {k: [{n: t.float() for n, t in b.items()} for b in v] if isinstance(v, list)
           else v.float() for k, v in params.items()}
    on_card = image_encoder.encode(p32, f32, img)
    cpu = image_encoder.encode({k: [{n: t.cpu() for n, t in b.items()} for b in v]
                                if isinstance(v, list) else v.cpu() for k, v in p32.items()},
                               f32, img.cpu())
    assert _row_rel_err(on_card.cpu(), cpu) <= 1e-3
