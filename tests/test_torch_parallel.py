"""The port's parallel layer against the JAX package's (the counterpart
of `tests/test_parallel_training.py`): the mesh and its errors, the
partition rules leaf by leaf against JAX's specs, sharded stage-1 steps
on a (1, 2, 2) mesh of 4 gloo processes against JAX's `jit_step` on its
virtual 8-device CPU mesh, the freeze policy, a sharded stage-2 step,
global loss counts across dp ranks, tp greedy generation against one
process with no large all-gather in the decode loop, the W8A8 int8 serve
at tp 2, determinism, the moments' placements, the kernels' refusal of a
DTensor, the dryrun entry point and the training CLIs' mesh keys.

The ranks are spawned processes (`torch_parallel_workers.spawn`, a file
rendezvous under tmp_path, a 120 s join timeout); each group of ranks
runs once per module and the tests read its results.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

import torch_parallel_workers as workers
from torch_port_helpers import random_params
from ullava_tpu.models import ullava as jullava
from ullava_tpu.models import ullava_core as jcore
from ullava_tpu.parallel import MeshConfig as JMeshConfig
from ullava_tpu.parallel import make_mesh as jmake_mesh
from ullava_tpu.parallel.sharding import param_partition_specs as jspecs
from ullava_tpu.parallel.sharding import shard_batch as jshard_batch
from ullava_tpu.training import optim as joptim
from ullava_tpu.training import train_step as jstep
from ullava_tpu_torch.bridge import params_from_jax
from ullava_tpu_torch.parallel import MeshConfig, make_mesh
from ullava_tpu_torch.parallel.sharding import param_partition_specs, spec_of

REPO = Path(__file__).resolve().parents[1]
SEED = 5


def _strip(spec):
    spec = tuple(spec)
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec


def _leaf_pairs(port, pspec, jspec, stacked=False, path=""):
    """(path, port leaf, port placements, JAX spec, JAX leaf stacked) over
    the port tree; a port list against a JAX dict is the stacked layers."""
    if isinstance(port, dict):
        for k in port:
            yield from _leaf_pairs(port[k], pspec[k], jspec[k], stacked, f"{path}/{k}")
    elif isinstance(port, list):
        if isinstance(jspec, list):
            for a, b, c in zip(port, pspec, jspec, strict=True):
                yield from _leaf_pairs(a, b, c, stacked, path)
        else:
            for a, b in zip(port, pspec):
                yield from _leaf_pairs(a, b, jspec, True, path)
    else:
        assert isinstance(jspec, PartitionSpec), path
        yield path, port, pspec, jspec, stacked


def _assert_specs_match(port_params, jparams, dp, fsdp, tp):
    mesh = jmake_mesh(JMeshConfig(dp=dp, fsdp=fsdp, tp=tp), jax.devices()[:dp * fsdp * tp])
    ref = jspecs(jparams, mesh)
    got = param_partition_specs(port_params, {"dp": dp, "fsdp": fsdp, "tp": tp})
    n, sharded = 0, 0
    for path, leaf, pl, js, stacked in _leaf_pairs(port_params, got, ref):
        want = _strip(tuple(js)[1:] if stacked else tuple(js))
        assert _strip(spec_of(pl, leaf.ndim)) == want, (path, pl, js)
        n += 1
        sharded += bool(want)
    return n, sharded


def _jax_params():
    jcfg = jcore.UllavaCoreConfig.tiny()
    return jcfg, random_params(jcore.init_params, jcfg, seed=SEED)


def _stage1_batch(cfg, rng, B=8, S=16):
    P = cfg.vision.num_patches
    ids = rng.integers(5, 100, size=(B, S)).astype(np.int64)
    ids[:, 1] = cfg.img_start_id
    ids[:, 2:2 + P] = 149
    ids[:, 2 + P] = cfg.img_end_id
    images = rng.standard_normal((B, 28, 28, 3)).astype(np.float32)
    return {"input_ids": ids, "labels": ids.copy(), "attn_lens": np.full((B,), S, np.int32),
            "images": images}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The JAX tiny stage-1 params (numpy seed), their port copy, a stage-1
    batch and generation prompts, in a file the ranks load."""
    jcfg, jp = _jax_params()
    batch = _stage1_batch(jcfg, np.random.default_rng(SEED))
    rng = np.random.default_rng(7)
    data = {"params": params_from_jax(jp, device="cpu"),
            "batch": {k: torch.as_tensor(v) for k, v in batch.items()},
            "ids": torch.as_tensor(rng.integers(5, 100, size=(4, 10))),
            "lens": torch.tensor([10, 7, 9, 5], dtype=torch.int32)}
    path = tmp_path_factory.mktemp("parallel_inputs") / "inputs.pt"
    torch.save(data, path)
    return {"path": path, "jcfg": jcfg, "jparams": jp, "batch": batch, "data": data}


@pytest.fixture(scope="module")
def run_122(inputs, tmp_path_factory):
    return workers.spawn(workers.train_122, 4, tmp_path_factory.mktemp("r122"), inputs["path"])


@pytest.fixture(scope="module")
def run_212(inputs, tmp_path_factory):
    return workers.spawn(workers.dp2_tp2, 4, tmp_path_factory.mktemp("r212"), inputs["path"])


@pytest.fixture(scope="module")
def run_114(inputs, tmp_path_factory):
    return workers.spawn(workers.tp4, 4, tmp_path_factory.mktemp("r114"), inputs["path"])


# ---------------------------------------------------------------- mesh and rules


def test_mesh_axes(run_122):
    """A (1, 2, 2) mesh over 4 ranks has the JAX axes; counts that do not
    divide, or do not make the world size, raise JAX's messages before
    any process group is joined."""
    assert all(r["mesh"] == (("dp", "fsdp", "tp"), (1, 2, 2)) for r in run_122)
    with pytest.raises(ValueError, match="8 devices not divisible by fsdp\\*tp=3"):
        MeshConfig(fsdp=3, tp=1).resolve(8)
    with pytest.raises(ValueError, match="1 devices not divisible by fsdp\\*tp=4"):
        make_mesh(MeshConfig(fsdp=2, tp=2), "cpu")
    with pytest.raises(ValueError, match="mesh 2x1x1 != 1 devices"):
        make_mesh(MeshConfig(dp=2), "cpu")
    assert MeshConfig(fsdp=2, tp=2).resolve(8) == MeshConfig(dp=2, fsdp=2, tp=2)


@pytest.mark.parametrize("shape", [(1, 2, 2), (2, 2, 2), (2, 1, 4)],
                         ids=["1x2x2", "2x2x2", "2x1x4"])
def test_partition_specs_match_jax(shape):
    """Every leaf of the tiny stage-2 tree: the port's placements, read as
    a spec, equal JAX's `param_partition_specs` with its scan axis dropped
    (int8 leaves and LoRA adapters replicate in both; so does every dim
    that does not divide)."""
    jp = random_params(jullava.init_params, jullava.UllavaConfig.tiny(), seed=1)
    n, sharded = _assert_specs_match(params_from_jax(jp, device="cpu"), jp, *shape)
    assert n > 280 and sharded > 30, (n, sharded)


def test_indivisible_dims_fall_back_to_replication():
    tree = {"llm": {"layers": [{"q_proj": torch.zeros(7, 6)}]}}
    specs = param_partition_specs(tree, {"dp": 2, "fsdp": 2, "tp": 2})
    assert spec_of(specs["llm"]["layers"][0]["q_proj"], 2) == (None, "tp")


def test_sharded_placements_match_jax(run_122, inputs):
    """The DTensors of the sharded stage-1 state on 4 ranks carry the
    placements JAX gives the same tree on its (1, 2, 2) mesh."""
    mesh = jmake_mesh(JMeshConfig(dp=1, fsdp=2, tp=2), jax.devices()[:4])
    ref = jspecs({"core": inputs["jparams"]}, mesh)
    flat = {}
    for path, _, _, js, stacked in _leaf_pairs(
            {"core": inputs["data"]["params"]},
            param_partition_specs({"core": inputs["data"]["params"]}, {}), ref):
        flat[path.lstrip("/")] = _strip(tuple(js)[1:] if stacked else tuple(js))
    got = run_122[0]["specs"]
    assert {p for p, _ in got} == set(flat) and any(s for _, s in got)
    for path, spec in got:
        assert _strip(spec) == flat[path], path


# ---------------------------------------------------------------- training


def test_stage1_sharded_matches_jax(run_122, inputs):
    """Three stage-1 pretraining steps (lr 1e-2, B=8, S=16) on the
    (1, 2, 2) mesh: the loss falls, and each step's loss and gradient norm
    are JAX's `jit_step` on its (1, 2, 2) mesh within 1e-5 (fp32, sums in
    another order); every rank reports the same metrics."""
    jcfg, jp = inputs["jcfg"], inputs["jparams"]
    mesh = jmake_mesh(JMeshConfig(dp=1, fsdp=2, tp=2), jax.devices()[:4])
    tx = joptim.make_optimizer(1e-2)
    state, labels = jstep.make_train_state(
        {"core": jax.tree_util.tree_map(jnp.asarray, jp)}, tx, joptim.STAGE1_PRETRAIN)
    state = jstep.shard_train_state(state, mesh, tx, labels)
    step = jstep.jit_step(jstep.make_stage1_step(jcfg, tx, labels))
    batch = jshard_batch({k: jnp.asarray(v) for k, v in inputs["batch"].items()}, mesh)
    ref = []
    for _ in range(3):
        state, m = step(state, batch)
        ref.append((float(m["loss"]), float(m["grad_norm"])))
    got = run_122[0]["metrics"]
    assert got[-1]["loss"] < got[0]["loss"]
    for g, (loss, gnorm) in zip(got, ref, strict=True):
        np.testing.assert_allclose(g["loss"], loss, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(g["grad_norm"], gnorm, rtol=1e-5, atol=1e-5)
    assert all(r["metrics"] == got for r in run_122)


def test_stage1_freeze_policy_only_updates_projector_and_embeddings(run_122, inputs):
    before = dict(workers._full({"core": inputs["data"]["params"]}))
    after = dict(run_122[0]["final"])
    assert not torch.equal(before["core/projector/fc0/w"], after["core/projector/fc0/w"])
    assert not torch.equal(before["core/llm/embed_tokens"], after["core/llm/embed_tokens"])
    moved = [n for n in before if not torch.equal(before[n], after[n])]
    trained = {n for n in before if n.startswith("core/projector/")} | {"core/llm/embed_tokens"}
    assert len(trained) >= 3 and set(moved) == trained


def test_stage2_sharded_step_runs(run_122):
    """One stage-2 step (STAGE2 policy, B=4) on the (1, 2, 2) mesh: finite
    losses and gradient norm; the frozen SAM image encoder bit-unchanged."""
    m = run_122[0]["stage2"]
    for k in ("loss", "ce_loss", "mask_bce_loss", "mask_dice_loss", "bbox_loss", "grad_norm"):
        assert np.isfinite(m[k]), k
    assert run_122[0]["sam_encoder_unchanged"]


@pytest.mark.parametrize("stage", ["stage1", "stage2"])
def test_losses_divide_by_global_counts(run_212, stage):
    """A batch whose two dp ranks hold different counts of valid labels
    (and, at stage 2, of valid mask and box slots) gives the loss, the aux
    losses and the gradient norm of one process over the whole batch
    (rtol 1e-5: tp 2 reorders fp sums); a mean of per-rank means would
    not."""
    r = run_212[0][stage]
    assert r["sharded"].keys() == r["single"].keys()
    for k, v in r["single"].items():
        np.testing.assert_allclose(r["sharded"][k], v, rtol=1e-5, atol=1e-6, err_msg=k)


def test_merge_params_matches_jax():
    """`optim.merge_params` fills the None leaves of one tree from the
    other, as the JAX `merge_params` does over a partition."""
    from ullava_tpu.training.optim import merge_params as jmerge
    from ullava_tpu_torch.training.optim import merge_params

    a, b, c = torch.ones(2), torch.zeros(3), torch.full((1,), 5.0)
    train = {"x": a, "y": {"z": None, "w": [None, c]}}
    frozen = {"x": None, "y": {"z": b, "w": [a, None]}}
    got = merge_params(train, frozen)
    ref = jmerge(jax.tree_util.tree_map(lambda t: None if t is None else t.numpy(), train,
                                        is_leaf=lambda t: t is None),
                 jax.tree_util.tree_map(lambda t: None if t is None else t.numpy(), frozen,
                                        is_leaf=lambda t: t is None))
    assert got["x"] is a and got["y"]["z"] is b and got["y"]["w"][0] is a and got["y"]["w"][1] is c
    for g, r in zip(jax.tree_util.tree_leaves([got["x"], got["y"]["z"], *got["y"]["w"]]),
                    [ref["x"], ref["y"]["z"], *ref["y"]["w"]], strict=True):
        np.testing.assert_array_equal(g.numpy(), r)


def test_training_determinism(run_122):
    """The same three sharded steps twice: bitwise-equal metrics."""
    assert run_122[0]["metrics"] == run_122[0]["metrics_again"]


def test_opt_state_sharding_is_structural_not_shape_keyed(run_122):
    """q_proj [D, H*hd] and o_proj [H*hd, D] of the same shape take
    different placements; each Adam moment takes its own parameter's (by
    tree position), and the step count is a plain replicated int."""
    m = run_122[0]["moments"]
    assert m["q"] != m["o"]
    assert m["q"] == ("R", "S(0)", "S(1)") and m["o"] == ("R", "S(1)", "S(0)")
    assert m["mu"] == m["nu"] == [m["q"], m["o"]]
    assert m["count"] == 0
    assert run_122[0]["moments_follow"]


# ---------------------------------------------------------------- serving


def _gen_case(run_212, run_114, case):
    return {"dp2_tp2": run_212[0]["generate"], "tp4": run_114[0]["generate"],
            "int8_tp2": run_212[0]["int8"]}[case]


@pytest.mark.parametrize("case", ["dp2_tp2", "tp4", "int8_tp2"])
def test_tp_generation_matches_single_process(run_212, run_114, case):
    """Greedy generation (4 ragged prompts, 4 new tokens) with the decoder
    tensor-parallel and the batch split over dp: the sequences and lengths
    equal one process's exactly, the hidden states within 1e-4 (row-
    parallel sums reorder fp additions). `int8_tp2`: int8 weights, W8A8
    prefill with the fused norm + quantize and the int8 cache at dp 2 x
    tp 2, where the W8A8 o/down products gather their input over tp and
    run the whole weight."""
    g = _gen_case(run_212, run_114, case)
    assert torch.equal(g["got"]["sequences"], g["ref"]["sequences"])
    assert torch.equal(g["got"]["lengths"], g["ref"]["lengths"])
    torch.testing.assert_close(g["got"]["hidden_last"], g["ref"]["hidden_last"],
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case", ["dp2_tp2", "tp4"])
def test_tp_decode_has_no_large_all_gather(run_212, run_114, case):
    """Under CommDebugMode, a rank's whole generate (prefill and decode
    loop, no image) issues all-reduces and the [B, tp] argmax combines
    only: no all-gather of more than 4096 elements (a parameter or the
    logits would be)."""
    g = _gen_case(run_212, run_114, case)
    assert g["gathered"] and max(g["gathered"]) <= 4096, g["gathered"]
    assert g["counts"].get("allreduce_", 0) > 0, g["counts"]


def test_kernels_refuse_a_dtensor(run_122):
    """`kernels.ptr` and `kernels.check_cuda_tensor` raise TypeError on a
    DTensor (whose data_ptr() is 0), so a sharded weight never reaches a
    kernel as a pointer."""
    assert run_122[0]["kernels_refuse_dtensor"] == [True, True]


# ---------------------------------------------------------------- entry points


def test_dryrun_world4_cpu():
    """`python -m ullava_tpu_torch.parallel.dryrun --world 4 --device cpu`:
    one sharded stage-2 step and a sharded greedy generate equal to one
    process's, over 4 gloo ranks."""
    res = subprocess.run([sys.executable, "-m", "ullava_tpu_torch.parallel.dryrun",
                          "--world", "4", "--device", "cpu"],
                         cwd=REPO, capture_output=True, text=True, timeout=150)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "mesh dp=1 fsdp=2 tp=2" in res.stdout
    assert "tokens match: True" in res.stdout


def _cli_cfg(arch, **training):
    import ullava_tpu_torch.models.build  # noqa: F401  (registers the archs)
    from ullava_tpu_torch.config import Config

    return Config(cfg_dict={"model": {"arch": arch}, "task": {}, "processor": {},
                            "training": training})


@pytest.mark.parametrize("cli", ["train_ullava_core", "train_ullava"])
def test_cli_yaml_mesh_keys_reach_make_mesh(cli, monkeypatch):
    """The training CLIs read `fsdp` and `tp` from the YAML's training
    section into the mesh (the repaired fault: they read neither)."""
    import importlib

    import ullava_tpu_torch.parallel as parallel

    seen = []

    class Stop(Exception):
        pass

    def fake(cfg, device_type):
        seen.append((cfg, device_type))
        raise Stop

    monkeypatch.setattr(parallel, "make_mesh", fake)
    mod = importlib.import_module(f"ullava_tpu_torch.{cli}")
    arch = "ullava_core" if cli == "train_ullava_core" else "ullava"
    with pytest.raises(Stop):
        mod.train(_cli_cfg(arch, fsdp=2, tp=1), tokenizer=object(), device="cpu")
    assert seen == [(MeshConfig(fsdp=2, tp=1), "cpu")]


@pytest.mark.parametrize("cli", ["train_ullava_core", "train_ullava"])
def test_cli_world_of_one_with_fsdp2_raises(cli):
    """A lone process asked for `fsdp: 2` raises JAX's divisibility error
    instead of training unsharded."""
    import importlib

    mod = importlib.import_module(f"ullava_tpu_torch.{cli}")
    arch = "ullava_core" if cli == "train_ullava_core" else "ullava"
    with pytest.raises(ValueError, match="1 devices not divisible by fsdp\\*tp=2"):
        mod.train(_cli_cfg(arch, fsdp=2), tokenizer=object(), device="cpu")
