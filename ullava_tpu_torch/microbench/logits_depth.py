"""How far the first generated position's logits of the kernels' route and
of the plain versions on the card part, by depth: LLaMA-7B at full width
(random weights from a generator seeded 0 on the device), the prefill of
B=16 random 320-token prompts cut to 1, 2, 4, 8, 16 and 32 layers, in bf16
and with the int8 LLM (W8A8 prefill, the fused norm + quantize, the int8
KV cache). Beside it, the plain route against itself with the input
embeddings moved by one bf16 ulp in random places: the model's own spread,
which bounds what a comparison of two roundings can ask of it.

    python ullava_tpu_torch/microbench/logits_depth.py

One JSON line a (LLM, depth): both row-relative errors
(`chip_smoke.row_rel_err`), the share of rows whose argmax agrees, the
largest logit. The plain versions are swapped in by
`stage2_grads.plain_on_card("int8_llm")`. It needs a card (about 75 s).
"""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]


def main() -> int:
    import torch

    sys.path.insert(0, str(HERE))
    import chip_smoke as cs

    from ullava_tpu_torch import kernels
    from ullava_tpu_torch.microbench.stage2_grads import plain_on_card
    from ullava_tpu_torch.models import llama, ullava
    from ullava_tpu_torch.ops.quant import apply_linear

    kernels.build_all(verbose=False)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cfg = cs.full_config()
    params = ullava.init_params(cfg, gen, "cuda")
    core = params["core"]
    B, S = 16, 320
    ids = torch.randint(5, 1000, (B, S), generator=gen, device="cuda")
    lens = torch.full((B,), S, dtype=torch.int32, device="cuda")
    rows = torch.arange(B, device="cuda")

    def first_logits(lcfg, llm, embeds):
        cache = llama.init_kv_cache(lcfg, B, S + 1, device="cuda")
        with torch.no_grad():
            pre = llama.forward(llm, lcfg, inputs_embeds=embeds, kv_lens=lens, kv_cache=cache,
                                compute_logits=False)
            h = pre["hidden_states"][rows, lens.long() - 1].to(lcfg.dtype)
            return apply_linear(h, llm["lm_head"]).float()

    def sweep(tag, lcfg):
        embeds = llama.embed(core["llm"], ids).to(lcfg.dtype)
        noise = torch.randint(0, 2, embeds.shape, generator=gen, device="cuda").to(embeds.dtype)
        bumped = (embeds.float() * (1 + noise.float() * 2.0**-8)).to(embeds.dtype)
        for n in (1, 2, 4, 8, 16, 32):
            c = dataclasses.replace(lcfg, num_layers=n)
            llm = {**core["llm"], "layers": core["llm"]["layers"][:n]}
            k = first_logits(c, llm, embeds)
            with plain_on_card("int8_llm"):
                p = first_logits(c, llm, embeds)
                pb = first_logits(c, llm, bumped)
            print(json.dumps({"llm": tag, "layers": n, "kernel_vs_plain": cs.row_rel_err(k, p),
                              "plain_vs_plain_ulp": cs.row_rel_err(pb, p),
                              "argmax_equal": float((k.argmax(-1) == p.argmax(-1)).float().mean()),
                              "logit_absmax": float(p.abs().max())}), flush=True)

    sweep("bf16", cfg.core.llm)
    ullava.quantize_llm(params)
    torch.cuda.empty_cache()
    sweep("int8", dataclasses.replace(cfg.core.llm, a8_prefill=True, kv_quant=True,
                                      fused_norm_quant=True))
    print(cs.card_name_and_power_limit(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
