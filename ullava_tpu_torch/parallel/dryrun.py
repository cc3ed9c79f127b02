"""A multi-rank dry run of the sharded paths (counterpart of the JAX
package's `dryrun_multichip`).

    python -m ullava_tpu_torch.parallel.dryrun --world N [--device cpu]

Spawns N processes (NCCL over N cards by default, gloo on the CPU with
`--device cpu`), joined by a TCP rendezvous on localhost. The mesh takes
tp = 2 and fsdp = 2 where N's factors allow (dp the rest). On the tiny
configs each rank runs one sharded stage-2 step (`shard_train_state`,
`jit_step`) and one sharded greedy generate (`make_generate_fn`), which
must give the tokens of the same generate in one process. Rank 0 prints
the mesh, the step's metrics and whether the tokens match; the exit code
is 0 only when every rank passed.
"""

from __future__ import annotations

import argparse
import copy
import datetime
import json
import socket
import sys


def mesh_shape(world: int) -> tuple:
    """(dp, fsdp, tp): tp 2 and fsdp 2 where `world` divides by them."""
    tp = 2 if world % 2 == 0 else 1
    fsdp = 2 if (world // tp) % 2 == 0 else 1
    return world // (tp * fsdp), fsdp, tp


def _rank(rank: int, world: int, device: str, port: int) -> None:
    import torch
    import torch.distributed as dist

    from ullava_tpu_torch import train
    from ullava_tpu_torch.models import generate as gen_mod
    from ullava_tpu_torch.models import ullava
    from ullava_tpu_torch.parallel import MeshConfig, make_mesh, shard_params
    from ullava_tpu_torch.training import optim
    from ullava_tpu_torch.training.train_step import (
        jit_step,
        make_stage2_step,
        make_train_state,
        shard_train_state,
    )

    if device == "cuda":
        torch.cuda.set_device(rank)
    else:
        torch.set_num_threads(1)
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{port}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        dp, fsdp, tp = mesh_shape(world)
        mesh = make_mesh(MeshConfig(dp=dp, fsdp=fsdp, tp=tp), device)
        cfg = ullava.UllavaConfig.tiny()
        params = ullava.init_params(cfg, torch.Generator(device=device).manual_seed(0), device)

        tx = optim.make_optimizer(1e-3)
        state, labels = make_train_state(copy.deepcopy(params), tx, optim.STAGE2)
        state = shard_train_state(state, mesh, tx, labels)
        step = jit_step(make_stage2_step(cfg, tx, labels))
        batch = train.make_stage2_batch(cfg, 2 * dp * fsdp, 24, device=device)
        state, metrics = step(state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        finite = all(v == v and abs(v) != float("inf") for v in metrics.values())

        gen = gen_mod.GenerateConfig(max_new_tokens=4, temperature=0.0)
        g = torch.Generator().manual_seed(1)
        n = 2 * dp * fsdp
        ids = torch.randint(5, 100, (n, 10), generator=g).to(device)
        lens = torch.randint(5, 11, (n,), generator=g).to(device=device, dtype=torch.int32)
        core = params["core"]
        ref = gen_mod.generate(core, cfg.core, gen, input_ids=ids, prompt_lens=lens)
        got = gen_mod.make_generate_fn(cfg.core, gen)(shard_params(core, mesh), ids, lens)
        match = bool(torch.equal(got["sequences"], ref["sequences"])
                     and torch.equal(got["lengths"], ref["lengths"]))
        ok = torch.tensor([int(finite and match)], device=device)
        dist.all_reduce(ok, op=dist.ReduceOp.MIN)
        if rank == 0:
            print(f"mesh dp={dp} fsdp={fsdp} tp={tp} over {world} {device} ranks", flush=True)
            print(json.dumps({"stage2_step": metrics}), flush=True)
            print(f"tokens match: {match}", flush=True)
            print(json.dumps({"ok": bool(ok.item()),
                              "sequences": got["sequences"].cpu().tolist()}), flush=True)
        if not ok.item():
            raise SystemExit(1)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--world", type=int, default=4)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    import torch
    import torch.multiprocessing as mp

    if args.device == "cuda" and torch.cuda.device_count() < args.world:
        print(f"--world {args.world} needs as many cards; {torch.cuda.device_count()} found",
              file=sys.stderr)
        return 2
    ctx = mp.start_processes(_rank, args=(args.world, args.device, _free_port()),
                             nprocs=args.world, join=False, start_method="spawn")
    try:
        while not ctx.join():
            pass
    except mp.ProcessExitedException as e:
        print(f"dryrun: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
