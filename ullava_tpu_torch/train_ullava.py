"""Stage-2 finetuning CLI of the port: segmentation + grounding
(counterpart of the root `train_ullava.py`).

    python -m ullava_tpu_torch.train_ullava --cfg_path <yaml> [--device cpu]

Builds the full model (core + SAM + heads; `quantize`, `lora_r` from the
YAML), freezes as the reference does (CLIP, projector, SAM image and
prompt encoders and the IoU head frozen; the LLM or its LoRA adapters with
the input embeddings and lm_head, the [SEG]/[LOC] heads and the mask
decoder train), and runs the stage-2 step in the trainer with the
per-epoch cIoU / gIoU eval and resume, on the card unless `--device` (or
`device=`) says otherwise, over the (dp, fsdp, tp) mesh of the YAML's
`fsdp` and `tp` keys (dp takes the rest of the world; torchrun's ranks
join from its environment, a lone process is a world of one); the batch
is the per-device batch times dp * fsdp. From Python, `callbacks=` go to
the trainer (`TrainerCallback`).
"""

from __future__ import annotations

import argparse
import logging

logger = logging.getLogger("train_ullava")


def train(cfg, tokenizer=None, device=None, callbacks=()):
    from ullava_tpu_torch import resolve_device
    from ullava_tpu_torch.data.loader import DataLoader
    from ullava_tpu_torch.models import build as model_build
    from ullava_tpu_torch.tasks import setup_task
    from ullava_tpu_torch.parallel import MeshConfig, make_mesh
    from ullava_tpu_torch.training import optim
    from ullava_tpu_torch.training.train_step import (
        jit_step,
        make_stage2_step,
        make_train_state,
        shard_train_state,
    )
    from ullava_tpu_torch.training.trainer import Trainer

    device = resolve_device(device)
    model_cfg, dataset_cfg, eval_dataset_cfg, training_cfg, task_cfg, processor_cfg = (
        cfg.assign_config()
    )
    mesh = make_mesh(MeshConfig(
        fsdp=int(training_cfg.get("fsdp", 1)), tp=int(training_cfg.get("tp", 1)),
    ), device.type)
    n_data = mesh.size(0) * mesh.size(1)

    model_max_length = int(training_cfg.get("model_max_length", 512))
    if tokenizer is None:
        tokenizer = model_build.build_tokenizer(model_cfg.get("llm_path"), model_max_length)

    u_cfg, params = model_build.build_ullava(model_cfg, tokenizer, device=device)

    task = setup_task(task_cfg)
    conv_type = model_cfg.get("conv_type", "conv_sep2")
    dataset = task.build_datasets(dataset_cfg, tokenizer, processor_cfg, conv_type)
    collator = task.build_collator(
        tokenizer.pad_token_id,
        model_max_length=model_max_length,
        max_masks=u_cfg.max_masks,
        mask_frame=u_cfg.mask_loss_frame,
    )

    loader = DataLoader(
        dataset,
        batch_size=int(training_cfg.get("per_device_train_batch_size", 2)) * n_data,
        collate_fn=collator,
        num_workers=int(training_cfg.get("dataloader_num_workers", 8)),
        seed=int(training_cfg.get("seed", 42)), device=device,
    )

    epochs = int(training_cfg.get("num_train_epochs", 5))
    total_steps = max(len(loader) * epochs, 1)
    schedule = optim.make_lr_schedule(
        float(training_cfg.get("learning_rate", 2e-5)),
        total_steps,
        warmup_ratio=float(training_cfg.get("warmup_ratio", 0.03)),
        schedule=training_cfg.get("lr_scheduler_type", "linear"),
    )
    tx = optim.make_optimizer(schedule, weight_decay=float(training_cfg.get("weight_decay", 0.0)))
    use_lora = int(model_cfg.get("lora_r", -1)) > 0
    patterns = optim.STAGE2_LORA if use_lora else optim.STAGE2
    state, labels = make_train_state(params, tx, patterns)
    state = shard_train_state(state, mesh, tx, labels)
    step = jit_step(make_stage2_step(u_cfg, tx, labels))

    eval_fn = None
    if eval_dataset_cfg:
        from ullava_tpu_torch.evaluation.harness import make_teacher_forced_eval_fn

        eval_fn = make_teacher_forced_eval_fn(
            u_cfg, eval_dataset_cfg, tokenizer, processor_cfg, conv_type,
            model_max_length=model_max_length,
        )

    trainer = Trainer(state=state, step_fn=step, train_loader=loader,
                      training_cfg=training_cfg, lr_schedule=schedule, eval_fn=eval_fn,
                      callbacks=callbacks, mesh=mesh)
    final_state = trainer.train(resume=True)
    logger.info("training complete at step %d", int(final_state.step))
    return final_state


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg_path", required=True)
    parser.add_argument("--options", nargs="*", default=None, help="(reserved)")
    parser.add_argument("--device", default=None, help="default: the card")
    args = parser.parse_args(argv)

    from ullava_tpu_torch.config import Config
    import ullava_tpu_torch.models.build  # noqa: F401  (registers the archs)

    train(Config(args.cfg_path), device=args.device)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    main()
