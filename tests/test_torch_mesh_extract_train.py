"""Extraction over a mesh and data-parallel training against the JAX
package (``tests/test_train_step.py``'s mesh tests).

* ``Extractor(mesh=…)`` over ``["cpu"] * 4`` (and a batch that does not
  fill the mesh): each share bit for bit what one device gives on it; the
  whole batch's keypoints identical to one device's, values within 1e-6;
  over ``["cpu"] * 8`` it agrees with the JAX extractor over its 8-device
  mesh as the single-device extractors agree
  (``tests/test_torch_extractor.py``).
* Data-parallel training, one process per device: two ``gloo`` processes
  each take half of a 4-pair batch (full-width ResSegNetV2 at 48², the
  JAX initialisation carried across, the JAX sampler's positions). Their
  loss is within rtol 1e-3 (the bar of ``tests/test_train_step.py``) of
  the single-process step on the global batch and of the JAX step over a
  2-device mesh (measured: within 1e-6); the summed gradients are held to
  the single-process ones with ``tests/test_torch_training_step.py``'s
  bars; both ranks end with the same parameters.
* At world size 1 the synchronised step is the plain step, and
  ``SyncBatchNorm2d`` moves its running variance by the biased variance.
"""

import copy
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from sfd2_torch.models.convert import state_dict_from_flax
from sfd2_torch.models.convert_baselines import superpoint_from_flax
from sfd2_torch.models.layers import BatchNorm2d
from sfd2_torch.models.sfd2 import ResSegNetV2 as TResSegNetV2
from sfd2_torch.models.superpoint import SuperPoint as TSuperPoint
from sfd2_torch.parallel import make_mesh
from sfd2_torch.parallel.distributed import (SyncBatchNorm2d, convert_sync_batchnorm,
                                             init_process_group)
from sfd2_torch.pipeline.extract import ExtractionConfig, Extractor
from sfd2_torch.training import train_step as t_step
from sfd2_torch.training.losses import SegLossConfig as TSegLossConfig
from sfd2_torch.training.sampler import NghSampler2DS as TNgh
from sfd2_tpu.models.sfd2 import ResSegNetV2
from sfd2_tpu.models.superpoint import SuperPoint
from sfd2_tpu.parallel.mesh import make_mesh as jmake_mesh
from sfd2_tpu.parallel.mesh import put_batch as jput_batch
from sfd2_tpu.parallel.mesh import put_replicated as jput_replicated
from sfd2_tpu.pipeline import extract as jextract
from sfd2_tpu.training import train_step as j_step
from sfd2_tpu.training.losses import SegLossConfig
from sfd2_tpu.training.sampler import NghSampler2DS
from test_torch_extractor import _textured
from test_torch_training_losses import TINY_SAMPLER, jax_positions
from test_torch_training_model import _randomise
from test_torch_training_step import make_batch

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
R, B = 48, 4
KEY = jax.random.PRNGKey(2)


@pytest.fixture(scope="module")
def extraction():
    rng = np.random.default_rng(0)
    model = ResSegNetV2(require_stability=True)
    variables = _randomise(jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))),
                           1)
    conf = dict(max_keypoints=64, conf_threshold=1e-5, pad_multiple=32, bf16=False)
    images = [_textured(rng, 64, 64) for _ in range(8)]
    return variables, conf, images


def test_extractor_over_a_mesh_is_the_single_device_extractor(extraction):
    """Each device's share gives bit for bit what one device gives on that
    share alone; against the whole batch on one device the keypoints are
    identical and the values within 1e-6 (the CPU's convolutions sum in
    another order for another batch size)."""
    variables, conf, images = extraction
    sd = state_dict_from_flax(variables)
    cfg = ExtractionConfig(**conf)
    plain = Extractor(sd, cfg, device="cpu")
    sharded = Extractor(sd, cfg, device="cpu", mesh=make_mesh(devices=["cpu"] * 4))
    assert len(sharded._replicas) == 4
    assert sharded._replicas[0].model is not sharded._replicas[1].model
    for batch in (images, images[:2] + [images[5][:40, :48]]):  # 3 images padded to 4
        got = sharded.extract_batch(batch)
        share = -(-len(batch) // 4)
        alone = [f for i in range(0, len(batch), share)
                 for f in plain.extract_batch(batch[i:i + share])]
        whole = plain.extract_batch(batch)
        for a, b, c in zip(got, alone, whole):
            assert len(a.keypoints) > 20
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(a.keypoints, c.keypoints)
            np.testing.assert_allclose(a.descriptors, c.descriptors, rtol=0, atol=1e-6)
            np.testing.assert_allclose(a.scores, c.scores, rtol=1e-5, atol=1e-7)


def test_extractor_over_a_mesh_matches_jax(extraction):
    variables, conf, images = extraction
    jmesh = jmake_mesh(8, ("data",))
    with jmesh:
        ref = jextract.Extractor(variables, jextract.ExtractionConfig(**conf),
                                 mesh=jmesh).extract_batch(images)
    got = Extractor(state_dict_from_flax(variables), ExtractionConfig(**conf), device="cpu",
                    mesh=make_mesh(devices=["cpu"] * 8)).extract_batch(images)
    for f_t, f_j in zip(got, ref):  # tests/test_torch_extractor.py's bars
        key = lambda f: {tuple(p): i for i, p in enumerate(np.rint(f.keypoints).astype(int))}  # noqa: E731
        kt, kj = key(f_t), key(f_j)
        common = sorted(set(kt) & set(kj))
        assert len(kj) > 20 and len(common) >= 0.99 * len(kj), (len(common), len(kj))
        it, ij = [kt[p] for p in common], [kj[p] for p in common]
        np.testing.assert_allclose(f_t.descriptors[it], f_j.descriptors[ij], atol=1e-4)
        np.testing.assert_allclose(f_t.scores[it], f_j.scores[ij], atol=1e-5, rtol=1e-4)


@pytest.fixture(scope="module")
def training():
    """The JAX global-batch step and its mesh step, and the port's plain
    step, on one batch from one initialisation."""
    model, sp = ResSegNetV2(require_stability=True, require_feature=True), SuperPoint()
    cfg = j_step.TrainConfig(loss=SegLossConfig(topk_per_half=32),
                             sampler=NghSampler2DS(**TINY_SAMPLER))
    state = j_step.init_train_state(model, cfg, jax.random.PRNGKey(0))
    v = _randomise({"params": state.params, "batch_stats": state.batch_stats}, 0)
    state = j_step.TrainState(params=v["params"], batch_stats=v["batch_stats"],
                              opt_state=j_step.make_optimizer(cfg).init(v["params"]),
                              step=state.step)
    sp_vars = jax.jit(sp.init)(jax.random.PRNGKey(1), jnp.zeros((1, R, R, 1)))
    step = j_step.make_train_step(model, sp, sp_vars, cfg)
    batch = make_batch(np.random.default_rng(0), b=B)
    jbatch = j_step.TrainBatch(**{k: jnp.asarray(a) for k, a in batch.items()})
    mesh = jmake_mesh(2, ("data",))
    with mesh:
        _, metrics_mesh = jax.jit(step)(jput_replicated(mesh, state), jput_batch(mesh, jbatch),
                                        KEY)
    tcfg = t_step.TrainConfig(loss=TSegLossConfig(topk_per_half=32), sampler=TNgh(**TINY_SAMPLER))
    tsp = TSuperPoint()
    tsp.load_state_dict(superpoint_from_flax(sp_vars))
    positions = jax_positions(TNgh(**TINY_SAMPLER), KEY, B, R // 4, R // 4)
    port = TResSegNetV2(require_stability=True, require_feature=True)
    sd0 = state_dict_from_flax(v)
    port.load_state_dict(sd0)
    pstate = t_step.TrainState(model=port, optimizer=t_step.make_optimizer(tcfg, port))
    fn = t_step.make_train_step(port, tsp, tcfg)
    tbatch = t_step.TrainBatch(**{k: torch.from_numpy(a) for k, a in batch.items()})
    pstate, metrics = fn(pstate, tbatch, None, positions)
    return dict(jax_mesh_loss=float(metrics_mesh["loss"]), metrics=metrics, state=pstate,
                sd0=sd0, tsp=tsp, tcfg=tcfg, batch=batch, positions=positions)


CHILD = r"""
import sys, torch, torch.distributed as dist
torch.set_num_threads(2)
from sfd2_torch.models.sfd2 import ResSegNetV2
from sfd2_torch.models.superpoint import SuperPoint
from sfd2_torch.parallel.distributed import convert_sync_batchnorm, init_process_group
from sfd2_torch.training import train_step as ts

rank, world, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
case = torch.load(f"{work}/case.pt", weights_only=False)
init_process_group(rank, world, f"{work}/rendezvous", device="cpu")
out = {}
for dtype in (torch.float32, torch.float64):
    model = ResSegNetV2(require_stability=True, require_feature=True)
    model.load_state_dict(case["sd0"])
    model.to(dtype)
    convert_sync_batchnorm(model, dist.group.WORLD)
    sp = SuperPoint()
    sp.load_state_dict(case["sp"])
    state = ts.TrainState(model=model, optimizer=ts.make_optimizer(case["cfg"], model))
    fn = ts.make_train_step(model, sp.to(dtype), case["cfg"], group=dist.group.WORLD)
    b = len(case["batch"]["image1"]) // world
    batch = ts.TrainBatch(**{k: torch.from_numpy(v[rank * b:(rank + 1) * b]).to(
        dtype if v.dtype.kind == "f" else torch.int32) for k, v in case["batch"].items()})
    state, metrics = fn(state, batch, None, case["positions"])
    out[str(dtype)] = {"metrics": {k: float(v) for k, v in metrics.items()},
                       "grads": {n: p.grad.clone() for n, p in model.named_parameters()},
                       "state": model.state_dict()}
torch.save(out, f"{work}/rank{rank}.pt")
dist.destroy_process_group()
"""


def _plain_step(training, dtype):
    model = TResSegNetV2(require_stability=True, require_feature=True)
    model.load_state_dict(training["sd0"])
    model.to(dtype)
    state = t_step.TrainState(model=model,
                              optimizer=t_step.make_optimizer(training["tcfg"], model))
    fn = t_step.make_train_step(model, copy.deepcopy(training["tsp"]).to(dtype), training["tcfg"])
    batch = t_step.TrainBatch(**{k: torch.from_numpy(a).to(dtype if a.dtype.kind == "f"
                                                         else torch.int32)
                                 for k, a in training["batch"].items()})
    return fn(state, batch, None, training["positions"])


def test_data_parallel_step_over_two_gloo_processes(training, tmp_path):
    """Two processes, float32 and float64: the float32 losses within rtol
    1e-3 of the single-process step and of JAX's mesh step; in float64
    (where the backward through twenty train-mode BatchNorms is no longer
    ill-conditioned at the bars' level) the summed gradients within 1e-7
    of each tensor's largest single-process magnitude, the running
    statistics within 1e-9 relative; every rank's parameters equal."""
    torch.save({"sd0": training["sd0"], "sp": training["tsp"].state_dict(),
                "cfg": training["tcfg"], "batch": training["batch"],
                "positions": training["positions"]}, tmp_path / "case.pt")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, str(r), "2", str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]
    f32, f64 = str(torch.float32), str(torch.float64)
    for dt in (f32, f64):
        assert ranks[0][dt]["metrics"] == ranks[1][dt]["metrics"]
        for k, a in ranks[0][dt]["state"].items():
            assert torch.equal(a, ranks[1][dt]["state"][k]), k  # one Adam step on every rank
    for k, v in ranks[0][f32]["metrics"].items():
        np.testing.assert_allclose(v, float(training["metrics"][k]), rtol=1e-3, err_msg=k)
    np.testing.assert_allclose(ranks[0][f32]["metrics"]["loss"], training["jax_mesh_loss"],
                               rtol=1e-3)
    state64, metrics64 = _plain_step(training, torch.float64)
    for k, v in ranks[0][f64]["metrics"].items():
        np.testing.assert_allclose(v, float(metrics64[k]), rtol=1e-9, err_msg=k)
    for name, p in state64.model.named_parameters():
        top = float(p.grad.abs().max())
        err = float((ranks[0][f64]["grads"][name] - p.grad).abs().max())
        assert err <= max(1e-7 * top, 1e-12), (name, err, top)
    sd = state64.model.state_dict()
    for k, v in ranks[0][f64]["state"].items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), sd[k].numpy(), rtol=1e-9,
                                       atol=1e-12, err_msg=k)


@pytest.fixture
def world_of_one(tmp_path):
    init_process_group(0, 1, tmp_path / "rendezvous", device="cpu")
    yield dist.group.WORLD
    dist.destroy_process_group()


def test_synchronised_step_at_world_size_one_is_the_plain_step(training, world_of_one):
    """The float32 losses within 1e-5 relative; in float64 the gradients
    within 1e-7 of each tensor's largest magnitude."""
    for dtype in (torch.float32, torch.float64):
        model = TResSegNetV2(require_stability=True, require_feature=True)
        model.load_state_dict(training["sd0"])
        model.to(dtype)
        convert_sync_batchnorm(model, world_of_one)
        assert sum(isinstance(m, SyncBatchNorm2d) for m in model.modules()) > 10
        assert set(model.state_dict()) == set(training["sd0"])
        state = t_step.TrainState(model=model,
                                  optimizer=t_step.make_optimizer(training["tcfg"], model))
        fn = t_step.make_train_step(model, copy.deepcopy(training["tsp"]).to(dtype),
                                    training["tcfg"], group=world_of_one)
        batch = t_step.TrainBatch(**{k: torch.from_numpy(a).to(dtype if a.dtype.kind == "f"
                                                             else torch.int32)
                                     for k, a in training["batch"].items()})
        state, metrics = fn(state, batch, None, training["positions"])
        if dtype == torch.float32:
            for k, v in training["metrics"].items():
                np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-5, err_msg=k)
            continue
        ref = dict(_plain_step(training, dtype)[0].model.named_parameters())
        for name, p in model.named_parameters():
            top = float(ref[name].grad.abs().max())
            assert float((p.grad - ref[name].grad).abs().max()) <= max(1e-7 * top, 1e-12), name

    bn = convert_sync_batchnorm(torch.nn.Sequential(BatchNorm2d(3)), world_of_one)[0]
    x = torch.from_numpy(np.random.default_rng(9).normal(size=(4, 3, 5, 5)).astype(np.float32))
    y = bn(x)
    var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * var)  # biased, as Flax
    torch.testing.assert_close(bn.running_mean, 0.1 * mean)
    torch.testing.assert_close(y, torch.nn.functional.batch_norm(x, None, None, training=True,
                                                                 eps=bn.eps))
