"""Rank processes of the port's multi-rank CPU tests: `spawn` starts
`world` processes (torch.multiprocessing, spawn start), each joins a gloo
group by a file rendezvous under the test's tmp dir and runs one of the
workers below; every rank's return value comes back through a file. A
rank that fails writes its traceback, and a group that has not ended
within its timeout is killed and fails the test. This module imports
torch and the port only (no JAX), so the ranks start fast."""

from __future__ import annotations

import copy
import datetime
import os
import time
import traceback

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.debug import CommDebugMode

JOIN_TIMEOUT_S = 120.0


def _entry(fn, rank, world, root, args):
    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{root}/rdv", rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=JOIN_TIMEOUT_S))
        torch.save(fn(rank, *args), os.path.join(root, f"out{rank}.pt"))
    except BaseException:
        with open(os.path.join(root, f"err{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world: int, root, *args, timeout: float = JOIN_TIMEOUT_S) -> list:
    """Run `fn(rank, *args)` on `world` gloo ranks; their results in rank
    order. Raises AssertionError on a rank's failure or on the timeout."""
    root = str(root)
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(fn, r, world, root, args)) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join(10)
    errs = {r: open(os.path.join(root, f"err{r}.txt")).read() for r in range(world)
            if os.path.exists(os.path.join(root, f"err{r}.txt"))}
    if hung or errs or any(p.exitcode for p in procs):
        raise AssertionError(f"ranks {hung} still running after {timeout} s; exit codes "
                             f"{[p.exitcode for p in procs]}; errors {errs}")
    return [torch.load(os.path.join(root, f"out{r}.pt"), weights_only=False)
            for r in range(world)]


# ---------------------------------------------------------------- helpers


class GatherSizes(CommDebugMode):
    """CommDebugMode that also keeps the element count of every all-gather
    it sees (the output buffer's)."""

    GATHERS = ("_allgather_base_", "allgather_", "all_gather_into_tensor",
               "allgather_into_tensor_coalesced_")

    def __init__(self):
        super().__init__()
        self.gathered = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = getattr(getattr(func, "_overloadpacket", None), "__name__", "")
        if name in self.GATHERS and not any(t is DTensor for t in types):
            out = args[0]
            flat = out if isinstance(out, torch.Tensor) else [
                t for ts in out for t in (ts if isinstance(ts, (list, tuple)) else [ts])]
            self.gathered.append(out.numel() if isinstance(out, torch.Tensor)
                                 else sum(t.numel() for t in flat))
        return super().__torch_dispatch__(func, types, args, kwargs)

    def counts(self) -> dict:
        return {str(k).split(".")[-1]: v for k, v in self.get_comm_counts().items()}


def _full(tree):
    """(path, whole tensor) of every leaf (a collective on DTensors)."""
    from ullava_tpu_torch.training.optim import named_leaves

    return [(n, t.full_tensor() if isinstance(t, DTensor) else t)
            for n, t in named_leaves(tree) if isinstance(t, torch.Tensor)]


def _mesh(dp, fsdp, tp):
    from ullava_tpu_torch.parallel import MeshConfig, make_mesh

    return make_mesh(MeshConfig(dp=dp, fsdp=fsdp, tp=tp), "cpu")


def _stage1(cfg, core, batch, mesh, steps, patterns=None, lr=1e-2):
    """`steps` stage-1 steps from a copy of the `core` params, sharded on
    `mesh` (None: unsharded). Returns (state, labels, metrics per step)."""
    from ullava_tpu_torch.training import optim
    from ullava_tpu_torch.training.train_step import (
        jit_step,
        make_stage1_step,
        make_train_state,
        shard_train_state,
    )

    tx = optim.make_optimizer(lr)
    state, labels = make_train_state({"core": copy.deepcopy(core)}, tx,
                                     patterns or optim.STAGE1_PRETRAIN)
    step = make_stage1_step(cfg, tx, labels)
    if mesh is not None:
        state = shard_train_state(state, mesh, tx, labels)
        step = jit_step(step)
    metrics = []
    for _ in range(steps):
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return state, labels, metrics


def _stage2(params, batch, mesh, steps=1):
    from ullava_tpu_torch.models import ullava
    from ullava_tpu_torch.training import optim
    from ullava_tpu_torch.training.train_step import (
        jit_step,
        make_stage2_step,
        make_train_state,
        shard_train_state,
    )

    cfg = ullava.UllavaConfig.tiny()
    tx = optim.make_optimizer(1e-3)
    state, labels = make_train_state(copy.deepcopy(params), tx, optim.STAGE2)
    step = make_stage2_step(cfg, tx, labels)
    if mesh is not None:
        state = shard_train_state(state, mesh, tx, labels)
        step = jit_step(step)
    metrics = []
    for _ in range(steps):
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def _stage2_inputs():
    from ullava_tpu_torch import train
    from ullava_tpu_torch.models import ullava

    cfg = ullava.UllavaConfig.tiny()
    params = ullava.init_params(cfg, torch.Generator().manual_seed(4), "cpu")
    return params, train.make_stage2_batch(cfg, 4, 24, seed=4, device="cpu")


# ---------------------------------------------------------------- workers


def train_122(rank, path):
    """(1, 2, 2): three sharded stage-1 steps twice over (the placements,
    the losses, the final params), one sharded stage-2 step (the SAM
    encoder before and after), the moments' placements on two same-shaped
    leaves, and the kernels' refusal of a DTensor."""
    from ullava_tpu_torch import kernels
    from ullava_tpu_torch.models import ullava_core
    from ullava_tpu_torch.parallel.sharding import spec_of
    from ullava_tpu_torch.training import optim
    from ullava_tpu_torch.training.train_step import make_train_state, shard_train_state

    data = torch.load(path, weights_only=False)
    cfg = ullava_core.UllavaCoreConfig.tiny()
    mesh = _mesh(1, 2, 2)
    out = {"mesh": (tuple(mesh.mesh_dim_names), tuple(mesh.shape))}
    state, labels, m1 = _stage1(cfg, data["params"], data["batch"], mesh, 3)
    _, _, m2 = _stage1(cfg, data["params"], data["batch"], mesh, 3)
    out["metrics"], out["metrics_again"] = m1, m2
    out["specs"] = [(n, spec_of(t.placements, t.ndim))
                    for n, t in optim.named_leaves(state.params)]
    train = optim.partition_params(state.params, labels)
    out["moments_follow"] = all(
        tuple(m.placements) == tuple(p.placements)
        for k in ("mu", "nu") for m, p in zip(state.opt_state[k], train, strict=True))
    out["final"] = _full(state.params)

    params2, batch2 = _stage2_inputs()
    before = _full(params2["sam"]["image_encoder"])
    s2, m = _stage2(params2, batch2, mesh)
    after = _full(s2.params["sam"]["image_encoder"])
    out["stage2"] = m[0]
    out["sam_encoder_unchanged"] = len(before) > 10 and all(
        torch.equal(a, b) for (_, a), (_, b) in zip(before, after, strict=True))

    leaves = {"llm": {"layers": [{"q_proj": torch.zeros(8, 8), "o_proj": torch.zeros(8, 8)}]}}
    tx = optim.make_optimizer(1e-2)
    st, lab = make_train_state(leaves, tx, (r"^llm/",))
    st = shard_train_state(st, mesh, tx, lab)
    layer = st.params["llm"]["layers"][0]
    out["moments"] = {
        "q": tuple(map(str, layer["q_proj"].placements)),
        "o": tuple(map(str, layer["o_proj"].placements)),
        "mu": [tuple(map(str, t.placements)) for t in st.opt_state["mu"]],
        "nu": [tuple(map(str, t.placements)) for t in st.opt_state["nu"]],
        "count": st.opt_state["count"],
    }
    refused = []
    for check in (lambda: kernels.ptr(layer["q_proj"]),
                  lambda: kernels.check_cuda_tensor("w", layer["q_proj"], torch.float32)):
        try:
            check()
            refused.append(False)
        except TypeError:
            refused.append(True)
    out["kernels_refuse_dtensor"] = refused
    return out if rank == 0 else {"mesh": out["mesh"], "metrics": m1}


def _uneven_stage1(batch):
    """The batch with rows 0-1 (the first dp rank's) mostly IGNORE_INDEX."""
    b = dict(batch)
    labels = b["labels"].clone()
    labels[0, 4:] = -100
    labels[1, 2:] = -100
    b["labels"] = labels
    return b


def _uneven_stage2(batch):
    b = dict(batch)
    labels = b["labels"].clone()
    labels[1, 10:] = -100
    b["labels"] = labels
    mv = b["mask_valid"].clone()
    mv[0, 0] = False
    bv = b["box_valid"].clone()
    bv[3, 0] = False
    b["mask_valid"], b["box_valid"] = mv, bv
    return b


def _generate_checks(cfg, params, mesh, ids, lens, gen):
    """Greedy generate sharded on `mesh` against the unsharded one, and
    the collectives of this rank's own part (its data slice) recorded."""
    from ullava_tpu_torch.models import generate as gen_mod
    from ullava_tpu_torch.parallel.mesh import data_rank
    from ullava_tpu_torch.parallel.sharding import shard_params

    ref = gen_mod.generate(params, cfg, gen, input_ids=ids, prompt_lens=lens)
    sharded = shard_params(params, mesh)
    got = gen_mod.make_generate_fn(cfg, gen)(sharded, ids, lens)
    r, n = data_rank(mesh)
    part = slice(r * len(ids) // n, (r + 1) * len(ids) // n)
    with GatherSizes() as rec:
        gen_mod.generate(sharded, cfg, gen, input_ids=ids[part], prompt_lens=lens[part])
    return {"ref": {k: ref[k] for k in ("sequences", "lengths", "hidden_last")},
            "got": {k: got[k] for k in ("sequences", "lengths", "hidden_last")},
            "gathered": rec.gathered, "counts": rec.counts()}


def dp2_tp2(rank, path):
    """(2, 1, 2): stage-1 and stage-2 losses with uneven valid counts
    across the dp ranks against the unsharded step, greedy generation, and
    the W8A8 int8 serve at tp 2, each against one process."""
    import dataclasses

    from ullava_tpu_torch.models import generate as gen_mod
    from ullava_tpu_torch.models import llama, ullava_core
    from ullava_tpu_torch.ops import quant

    data = torch.load(path, weights_only=False)
    cfg = ullava_core.UllavaCoreConfig.tiny()
    mesh = _mesh(2, 1, 2)
    out = {}
    b1 = _uneven_stage1(data["batch"])
    out["stage1"] = {"sharded": _stage1(cfg, data["params"], b1, mesh, 1)[2][0],
                     "single": _stage1(cfg, data["params"], b1, None, 1)[2][0]}
    params2, batch2 = _stage2_inputs()
    b2 = _uneven_stage2(batch2)
    out["stage2"] = {"sharded": _stage2(params2, b2, mesh)[1][0],
                     "single": _stage2(params2, b2, None)[1][0]}
    gen = gen_mod.GenerateConfig(max_new_tokens=4, temperature=0.0)
    out["generate"] = _generate_checks(cfg, data["params"], mesh, data["ids"], data["lens"], gen)
    q = copy.deepcopy(data["params"])
    q["llm"] = quant.quantize_tree(q["llm"], quant.LLAMA_QUANT_KEYS)
    cfg8 = dataclasses.replace(cfg, llm=dataclasses.replace(
        cfg.llm, a8_prefill=True, kv_quant=True))
    assert llama._use_fused_norm_quant(cfg8.llm, q["llm"]["layers"][0], 10)
    out["int8"] = _generate_checks(cfg8, q, mesh, data["ids"], data["lens"], gen)
    return out


def tp4(rank, path):
    """(1, 1, 4): greedy generation against one process."""
    from ullava_tpu_torch.models import generate as gen_mod
    from ullava_tpu_torch.models import ullava_core

    data = torch.load(path, weights_only=False)
    gen = gen_mod.GenerateConfig(max_new_tokens=4, temperature=0.0)
    return {"generate": _generate_checks(ullava_core.UllavaCoreConfig.tiny(), data["params"],
                                         _mesh(1, 1, 4), data["ids"], data["lens"], gen)}
