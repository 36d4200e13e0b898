"""``Trainer.train`` of the PyTorch port on two ranks (gloo, CPU) against its one-process
run and the JAX trainer on the 8-device CPU mesh, and the real multi-process entry point.

(c) YOLO-NAS-S, ``num_classes=4``, 64x64, the JAX model's weights carried to the port,
two SGD steps on global batches of 8 (4 a rank), in the regime of
``tests/test_torch_train_step.py`` (``torch_ddp_ranks.TRAIN_PARAMS``). Each group of
tensors (weights, BN running means, BN running variances; live and EMA) is held by the
L2 distance over the group:
- the two-rank fp64 run to the one-process fp64 run within 1e-9 of the group's norm
  (the same global batches, the reductions in another order), the loss history within
  1e-9 relative, and the two ranks' states bit-equal;
- the two-rank fp32 run to that fp64 run within twice the distance of the JAX trainer's
  fp32 run on the 8-device mesh (global batch 8, sharded one image a device, as in
  ``tests/test_trainer.py::test_batch_is_sharded_over_mesh``) plus fp32 resolution (1e-7
  of the group's norm), the JAX running variances mapped to torch's unbiased update over
  the global count (``tests/test_torch_train_step.py`` states the relation).
(g) Two epochs on two ranks, with validation and checkpoints, equal bit for bit to one
epoch, an interruption and a resume to two epochs; only rank 0 opens a file for writing
under the checkpoint root.
(h) ``python -m torch.distributed.run --nproc_per_node=2 -m super_gradients_tpu_torch.train_from_recipe
--config-name=roboflow_yolo_nas_s device=cpu num_devices=2`` on a tiny RF100 tree (8 + 8 PNGs,
global batch 4, one epoch of two steps, mosaic and the rest of the train chain) against the
same command at ``--nproc_per_node=1 num_devices=1``. In fp32 a random-init YOLO-NAS step is
chaotic: the BN and gradient sums taken in another order move the first gradient by ~2e-3
of its norm, and the next step's TAL labels flip. So this test holds the weights fixed
(SGD at LR 0; (c) holds the steps, in fp64) and everything else to the one-rank run:
the parameters (live and EMA) bit-equal, the BN running buffers within 1e-3 of the
distance they moved, the train loss within 1e-4 relative (the fp32 train-mode forward),
the best mAP@0.50 within 1e-6, printed by both ranks.
"""

import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ddp_ranks as ranks
from super_gradients_tpu.training import dataloaders as jax_dataloaders
from super_gradients_tpu.training.trainer import Trainer as JaxTrainer
from super_gradients_tpu_torch import models
from super_gradients_tpu_torch.conversion.from_jax import variables_from_jax_to_torch
from super_gradients_tpu_torch.training.metrics import detection as det
from test_torch_detection_transforms import smooth_image
from test_torch_recipes import _write_split
from test_torch_yolo_nas import jax_numpy_variables
from torch_jax_init import jax_model

torch.set_num_threads(2)

GROUPS = {
    "weights": lambda k: not any(k.endswith(s) for s in ("running_mean", "running_var", "num_batches_tracked")),
    "running_mean": lambda k: k.endswith("running_mean"),
    "running_var": lambda k: k.endswith("running_var"),
}


def _distance(a, b, keys):
    return float(sum(((a[k].double() - b[k].double()) ** 2).sum() for k in keys) ** 0.5)


def _norm(a, keys):
    return float(sum((a[k].double() ** 2).sum() for k in keys) ** 0.5)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("ddp_trainer")
    jm = jax_model("yolo_nas_s", num_classes=ranks.TRAIN_C, image_size=ranks.TRAIN_IMAGE)
    v = jax_numpy_variables(jm)
    jm.update_variables(jax.tree_util.tree_map(jnp.asarray, v))
    init = variables_from_jax_to_torch(v)
    torch.save(init, os.path.join(work, "init.pt"))
    rank_results = ranks.run_ranks("trainer+resume", work, timeout=400)
    shutil.rmtree(work / "resume_ckpt")  # ~1 GB of checkpoints, read by the ranks already

    loader = jax_dataloaders.DataLoader(jax_dataloaders.RandomDetectionDataset(
        2 * ranks.TRAIN_B, (ranks.TRAIN_IMAGE, ranks.TRAIN_IMAGE), ranks.TRAIN_C, ranks.TRAIN_BOXES),
        batch_size=ranks.TRAIN_B)
    jt = JaxTrainer("ddp_parity", ckpt_root_dir=str(work / "jax"))
    jt.train(jm, dict(ranks.TRAIN_PARAMS, valid_metrics_list=[]), loader)
    st = jt.train_state
    one = ranks.train_two_steps(os.path.join(work, "init.pt"), fp64=True)
    return dict(ranks=rank_results, one=one, init=init, jax={"ema": jm.variables,
                                                                "live": {"params": st.params,
                                                                         "batch_stats": st.batch_stats}},
                jax_history=jt.train_loss_history)


def _bn_inputs_per_channel():
    """n = (global B)*H*W of each BN's input in the train forward, by state_dict prefix."""
    net = models.get("yolo_nas_s", num_classes=ranks.TRAIN_C, image_size=ranks.TRAIN_IMAGE, device="cpu").net.train()
    sizes = {}
    hooks = [m.register_forward_pre_hook(lambda mod, inp, name=name: sizes.__setitem__(
        name, inp[0].numel() // inp[0].shape[1])) for name, m in net.named_modules()
        if isinstance(m, torch.nn.BatchNorm2d)]
    with torch.no_grad():
        net(torch.zeros(ranks.TRAIN_B, 3, ranks.TRAIN_IMAGE, ranks.TRAIN_IMAGE))
    for h in hooks:
        h.remove()
    return sizes


def _jax_in_torch_terms(jax_vars, v0, ema):
    """The JAX state as a torch state_dict, running variances made unbiased."""
    out = variables_from_jax_to_torch(jax.tree_util.tree_map(np.asarray, jax.device_get(jax_vars)))
    momentum, decay = 0.03, 0.9
    live = avg = 1.0
    for j in range(2):  # the coefficient of v0 when every batch variance is 0
        live = (1 - momentum) * live
        d = min(decay, (1.0 + j) / (10.0 + j))
        avg = d * avg + (1 - d) * live
    gain = avg if ema else live
    sizes = _bn_inputs_per_channel()
    for key in [k for k in out if k.endswith("running_var")]:
        c = sizes[key[: -len(".running_var")]] / (sizes[key[: -len(".running_var")]] - 1)
        out[key] = c * out[key].double() + (1 - c) * gain * v0[key].double()
    return out


@pytest.mark.parametrize("which", ["live", "ema"])
@pytest.mark.parametrize("group", list(GROUPS))
def test_two_ranks_fp64_equal_one_process(runs, which, group):
    r0, r1 = (r["trainer"]["fp64"][which] for r in runs["ranks"])
    ref = runs["one"][which]
    keys = [k for k in ref if GROUPS[group](k)]
    assert set(r0) == set(ref) and all(torch.equal(r0[k], r1[k]) for k in r0)  # the ranks hold one state
    assert r0[keys[0]].dtype == torch.float64
    moved = _distance(ref, runs["init"], keys)
    assert moved > 0
    assert _distance(r0, ref, keys) <= 1e-9 * _norm(ref, keys), (_distance(r0, ref, keys), moved)


@pytest.mark.parametrize("which", ["live", "ema"])
@pytest.mark.parametrize("group", list(GROUPS))
def test_two_ranks_fp32_within_twice_the_jax_mesh_distance(runs, which, group):
    ddp = runs["ranks"][0]["trainer"]["fp32"][which]
    ref = runs["one"][which]
    jax_t = _jax_in_torch_terms(runs["jax"][which], runs["init"], ema=which == "ema")
    keys = [k for k in ref if GROUPS[group](k)]
    e_jax, e_ddp = _distance(jax_t, ref, keys), _distance(ddp, ref, keys)
    assert e_ddp <= 2 * e_jax + 1e-7 * _norm(ref, keys), (e_jax, e_ddp)


def test_loss_history_and_parameters(runs):
    (h64,) = runs["ranks"][0]["trainer"]["fp64"]["history"]
    (one,) = runs["one"]["history"]
    np.testing.assert_allclose(h64, one, rtol=1e-9)
    assert runs["ranks"][1]["trainer"]["fp64"]["history"] == [h64]  # the logged loss is the global one on every rank
    np.testing.assert_allclose(runs["ranks"][0]["trainer"]["fp32"]["history"], runs["jax_history"], rtol=1e-4)
    assert runs["ranks"][0]["trainer"]["fp32"]["unread"] == []


# ---------------------------------------------------------------- (g)

def test_resume_over_two_ranks_is_bit_equal(runs):
    res = runs["ranks"][0]["resume"]
    straight, resumed = res["straight"], res["resumed"]
    assert straight["step"] == resumed["step"] == 4
    for what in ("live", "ema"):
        assert straight[what].keys() == resumed[what].keys()
        assert all(torch.equal(straight[what][k], resumed[what][k]) for k in straight[what]), what
    for i, state in straight["optimizer"]["state"].items():
        assert all(torch.equal(v, resumed["optimizer"]["state"][i][k]) for k, v in state.items())
    assert straight["valid"][-1] == resumed["valid"][-1] and straight["best"] == resumed["best"]
    other = runs["ranks"][1]["resume"]
    assert other["straight"]["valid"] == straight["valid"] and other["straight"]["best"] == straight["best"]


def test_only_rank_zero_writes(runs):
    written = [r["resume"]["written"] for r in runs["ranks"]]
    assert written[1] == []
    names = {os.path.basename(p) for p in written[0]}
    assert {"recipe.json", "events.jsonl"} <= names
    assert any(n.startswith("ckpt_latest") for n in names) and any(n.startswith("ckpt_best") for n in names)


# ---------------------------------------------------------------- (h)

SIDE = 64


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """8 train and 8 valid PNGs; the valid targets are a random-init model's detections, jittered."""
    root = str(tmp_path_factory.mktemp("ddp_recipe"))
    rng = np.random.RandomState(0)
    train_boxes = []
    for _ in range(8):
        xy = rng.uniform(0, 40, (3, 2))
        train_boxes.append((np.concatenate([xy, xy + rng.uniform(8, 24, (3, 2))], 1), rng.randint(0, 4, 3)))
    _write_split(os.path.join(root, "rf100", "tiny", "train"), [smooth_image(rng, SIDE, SIDE) for _ in range(8)],
                 train_boxes)
    valid_images = [smooth_image(rng, SIDE, SIDE) for _ in range(8)]
    model = models.get("yolo_nas_s", num_classes=4, image_size=SIDE, device="cpu")
    x = torch.from_numpy(np.stack(valid_images).transpose(0, 3, 1, 2).astype(np.float32) / 255.0)
    with torch.no_grad():
        nms = det.DetectionMetrics(num_cls=4).preprocess_device(model.net(x), None)
    valid_boxes = [(nms.boxes[i, :20].numpy() + rng.randn(20, 4) * 2.0, nms.labels[i, :20].numpy())
                   for i in range(8)]
    _write_split(os.path.join(root, "rf100", "tiny", "valid"), valid_images, valid_boxes)
    return root


def _launch(tree, nproc):
    ckpt = os.path.join(tree, f"ckpt{nproc}")
    overrides = ["device=cpu", f"num_devices={nproc}", "num_classes=4", "dataset_name=tiny",
                 "experiment_name=ddp_recipe", f"ckpt_root_dir={ckpt}", "epochs=1", "batch_size=4",
                 "val_batch_size=4", "num_workers=0", "training_hyperparams.lr_warmup_epochs=0",
                 "training_hyperparams.optimizer=SGD", "training_hyperparams.initial_lr=0",
                 "training_hyperparams.sg_logger_params.tensorboard=False"]
    for split in ("train", "val"):
        overrides += [f"dataset_params.{split}_dataset_params.data_dir={tree}/rf100",
                      f"dataset_params.{split}_dataset_params.image_size=[{SIDE},{SIDE}]"]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", f"--nproc_per_node={nproc}",
           "-m", "super_gradients_tpu_torch.train_from_recipe", "--config-name=roboflow_yolo_nas_s", *overrides]
    out = ranks.run_command(cmd, cwd=ranks.REPO, timeout=300, env={"OMP_NUM_THREADS": "1"})
    (run_dir,) = os.listdir(os.path.join(ckpt, "ddp_recipe"))
    run_dir = os.path.join(ckpt, "ddp_recipe", run_dir)
    with open(os.path.join(run_dir, "events.jsonl")) as f:
        loss = [e["value"] for e in map(json.loads, f) if e.get("tag") == "Train/loss"]
    latest = torch.load(os.path.join(run_dir, "ckpt_latest.pth"), weights_only=False)
    shutil.rmtree(ckpt)
    return out, latest, loss


@pytest.fixture(scope="module")
def launched(tree):
    return {n: _launch(tree, n) for n in (1, 2)}


def test_the_entry_point_on_two_ranks_equals_one(launched):
    (out1, ckpt1, loss1), (out2, ckpt2, loss2) = launched[1], launched[2]
    assert "rank 1 of world size 2, backend gloo" in out2 and "rank 0 of world size 1, backend gloo" in out1
    assert ckpt1["step"] == ckpt2["step"] == 2
    best = [float(line.rsplit(":", 1)[1]) for out in (out1, out2) for line in out.splitlines()
            if line.startswith("Training complete. Best mAP@0.50")]
    assert len(best) == 3 and best[0] > 0 and best[1] == best[2] and abs(best[0] - best[1]) <= 1e-6, best
    assert len(loss1) == len(loss2) == 1
    np.testing.assert_allclose(loss2, loss1, rtol=1e-4)
    fresh = models.get("yolo_nas_s", num_classes=4, device="cpu").net.state_dict()
    for what in ("net", "ema_net"):
        a, b = ckpt1[what], ckpt2[what]
        assert all(torch.equal(a[k], b[k]) and torch.equal(a[k], fresh[k]) for k in a if GROUPS["weights"](k))
        for group in ("running_mean", "running_var"):
            keys = [k for k in a if GROUPS[group](k)]
            assert _distance(b, a, keys) <= 1e-3 * _distance(a, fresh, keys), (what, group)
