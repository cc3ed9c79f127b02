"""Batch evaluation CLI of the port: cIoU / gIoU / Prec@0.5 over the eval
sets (counterpart of the root `eval_ullava.py`).

    python -m ullava_tpu_torch.eval_ullava --cfg_path <yaml> [--max_samples N] [--device cpu]

For each eval dataset: the teacher-forced stage-2 forward, each sample's
masks post-processed to its original resolution on the host, cumulative
cIoU, mean gIoU and box Prec@0.5, written to `<name>.json` under
`training.output_dir`. On the card unless `--device` (or `device=`) says
otherwise. `model.pretrained_ullava` may name a checkpoint the trainer
wrote.
"""

from __future__ import annotations

import argparse
import json
import logging
import os

logger = logging.getLogger("eval_ullava")


def evaluate(cfg, tokenizer=None, max_samples=None, device=None):
    from ullava_tpu_torch import resolve_device
    from ullava_tpu_torch.evaluation.harness import make_teacher_forced_eval_fn
    from ullava_tpu_torch.models import build as model_build

    device = resolve_device(device)
    model_cfg, _, eval_dataset_cfg, training_cfg, _, processor_cfg = cfg.assign_config()
    model_max_length = int(training_cfg.get("model_max_length", 512))
    if tokenizer is None:
        tokenizer = model_build.build_tokenizer(model_cfg.get("llm_path"), model_max_length)

    u_cfg, params = model_build.build_ullava(model_cfg, tokenizer, device=device)
    conv_type = model_cfg.get("conv_type", "conv_sep2")

    eval_fn = make_teacher_forced_eval_fn(
        u_cfg, eval_dataset_cfg, tokenizer, processor_cfg, conv_type,
        model_max_length=model_max_length, max_samples=max_samples,
    )
    results = eval_fn(params)

    out_dir = training_cfg.get("output_dir", "./eval_out")
    os.makedirs(out_dir, exist_ok=True)
    for name, metrics in results.items():
        with open(os.path.join(out_dir, f"{name}.json"), "w") as f:
            json.dump(metrics, f, indent=2)
        logger.info("%s: %s", name, metrics)
    return results


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg_path", required=True)
    parser.add_argument("--max_samples", type=int, default=None)
    parser.add_argument("--device", default=None, help="default: the card")
    args = parser.parse_args(argv)

    from ullava_tpu_torch.config import Config
    import ullava_tpu_torch.models.build  # noqa: F401  (registers the archs)

    evaluate(Config(args.cfg_path), max_samples=args.max_samples, device=args.device)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    main()
