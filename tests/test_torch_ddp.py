"""Data parallelism of the PyTorch port across processes, on the CPU over gloo, against
the JAX package and the port's one-process run.

The ranks are processes of ``tests/torch_ddp_ranks.py`` (torch and the port only; see
its docstring for the launcher, its timeouts and how a failing rank fails the test).
One launch of two ranks runs the BN, loss, metric, sampler and refusal scenarios; two
small launches prove that a failing or stuck rank ends the test within its timeout.

Tolerances:
- (a) ``GlobalBatchNorm2d`` on 2 ranks x 4 items, fp64: the output, the input gradient
  and the summed weight / bias gradients within 1e-12 (relative to each array's largest
  magnitude) of ``nn.BatchNorm2d`` on the 8 items and of a flax ``BatchNorm`` under
  ``jax.enable_x64``; the running mean within 1e-12, the running variance to flax's
  after the unbiased relation ``rv_torch = c * rv_flax + (1 - c) * (1 - m) * rv0``,
  ``c = n / (n - 1)`` with ``n`` the global count.
- (b) ``PPYoloELoss`` on fixed fp64 outputs split 4 + 4 and 3 + 4: the mean of the ranks'
  losses (and components), and each rank's input gradient over the world size, within
  1e-10 relative of the port's loss and gradient on the whole batch in one process, and
  of the JAX loss on the whole batch within the fp32 parity tolerances of
  ``tests/test_torch_ppyolo_loss.py`` (loss ``rtol=1e-5``, gradients 1e-4 of their largest
  magnitude): the JAX loss casts the logits and the DFL distributions to float32 even
  under ``jax.enable_x64`` (JAX ``ppyolo_loss.py:343,367,381,400``), so the one-process
  fp64 port and it differ by ~5e-8 relative.
- (c) ``KDLogitsLoss`` and ``SegKDLoss`` on fp64 logits split 4 + 4 and 3 + 4: the mean of
  the ranks' losses and each rank's student gradient over the world size within 1e-12
  relative of the one-process loss and gradient on the whole batch.
- (d) ``DetectionMetrics`` over 2 ranks on a set whose scores repeat across images: equal
  (``==``) to the JAX ``DetectionMetrics`` on the whole set and to the port's one-process
  value; the ranks' values identical; a rank-major order of the same images gives
  another mAP (the order matters, so the check is not vacuous).
- (e) ``Accuracy``, ``Top5``, ``IoU`` and ``PixelAccuracy`` equal to the one-process
  values; the validation ``Loss`` within 1e-12 relative (fp64 logits; CE) and 1e-6
  (fp32 logits; segmentation CE).
- (f) the default ``DistributedSampler``, ``RepeatAugSampler`` and
  ``DistributedSamplerWrapper`` under a group give the JAX samplers' indices for the
  explicit ``(2, rank)``; the loader's rank batches are the slices of the one-process
  loader's batches, each sample drawn from its own seed.
"""

import datetime
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ddp_ranks as ranks
from super_gradients_tpu_torch.parallel import mesh
from super_gradients_tpu_torch.training import losses
from super_gradients_tpu_torch.training.dataloaders import DataLoader, sample_seed

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return ranks.run_ranks("bn+loss+kd_loss+metrics+samplers+refusals+collectives", tmp_path_factory.mktemp("ddp"),
                           timeout=240)


def _close(a, b, tol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(float(np.abs(b).max()), 1e-300)
    assert float(np.abs(a - b).max()) <= tol * scale, (float(np.abs(a - b).max()), scale)


# ---------------------------------------------------------------- (a) global BN

def _torch_bn(case):
    bn = torch.nn.BatchNorm2d(ranks.BN_SHAPE[1], momentum=ranks.BN_MOMENTUM).double()
    with torch.no_grad():
        for k in ("weight", "bias", "running_mean", "running_var"):
            getattr(bn, k).copy_(torch.from_numpy(case[k]))
    x = torch.from_numpy(case["x"]).requires_grad_()
    y = bn(x)
    y.backward(torch.from_numpy(case["gy"]))
    return dict(y=y.detach().numpy(), dx=x.grad.numpy(), dweight=bn.weight.grad.numpy(), dbias=bn.bias.grad.numpy(),
                running_mean=bn.running_mean.numpy(), running_var=bn.running_var.numpy())


def _flax_bn(case):
    import flax.linen as fnn

    with jax.enable_x64():
        bn = fnn.BatchNorm(use_running_average=False, momentum=1.0 - ranks.BN_MOMENTUM, epsilon=1e-5)
        x = jnp.asarray(case["x"].transpose(0, 2, 3, 1))
        gy = jnp.asarray(case["gy"].transpose(0, 2, 3, 1))
        stats = {"mean": jnp.asarray(case["running_mean"]), "var": jnp.asarray(case["running_var"])}

        def f(x, scale, bias):
            y, upd = bn.apply({"params": {"scale": scale, "bias": bias}, "batch_stats": stats}, x,
                              mutable=["batch_stats"])
            return (y * gy).sum(), (y, upd["batch_stats"])

        (_, (y, upd)), (dx, dw, db) = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
            x, jnp.asarray(case["weight"]), jnp.asarray(case["bias"]))
        return dict(y=np.asarray(y).transpose(0, 3, 1, 2), dx=np.asarray(dx).transpose(0, 3, 1, 2),
                    dweight=np.asarray(dw), dbias=np.asarray(db), running_mean=np.asarray(upd["mean"]),
                    running_var=np.asarray(upd["var"]))


def _global_bn(results):
    per_rank = [r["bn"] for r in results]
    out = {k: np.concatenate([r[k] for r in per_rank]) for k in ("y", "dx")}
    out.update({k: sum(r[k] for r in per_rank) for k in ("dweight", "dbias")})
    for k in ("running_mean", "running_var"):
        np.testing.assert_array_equal(per_rank[0][k], per_rank[1][k])  # the buffers stay equal on every rank
        out[k] = per_rank[0][k]
    assert per_rank[0]["num_batches_tracked"] == 1
    return out


@pytest.mark.parametrize("key", ["y", "dx", "dweight", "dbias", "running_mean", "running_var"])
def test_global_bn_equals_batch_norm_on_the_global_batch(results, key):
    _close(_global_bn(results)[key], _torch_bn(ranks.bn_case())[key], 1e-12)


@pytest.mark.parametrize("key", ["y", "dx", "dweight", "dbias", "running_mean", "running_var"])
def test_global_bn_equals_flax(results, key):
    case = ranks.bn_case()
    ref = _flax_bn(case)[key]
    if key == "running_var":  # torch's unbiased update over the global count, flax's biased one
        n = ranks.BN_SHAPE[0] * ranks.BN_SHAPE[2] * ranks.BN_SHAPE[3]
        c = n / (n - 1)
        ref = c * ref + (1 - c) * (1 - ranks.BN_MOMENTUM) * case["running_var"]
    _close(_global_bn(results)[key], ref, 1e-12)


def test_one_rank_keeps_batch_norm_and_its_global_path_agrees(tmp_path, monkeypatch):
    """In a group of one rank (in this process, gloo) the global BN is ``nn.BatchNorm2d``
    (its batch is already the global one): equal to it exactly. Forced onto its global
    path there (one all-reduce each way over the one-rank group), it is within 1e-12 of it
    in fp64: output, gradients and running buffers."""
    from super_gradients_tpu_torch.parallel import sync_batch_norm

    ref = _torch_bn(ranks.bn_case())
    torch.distributed.init_process_group("gloo", init_method=f"file://{tmp_path}/store", world_size=1, rank=0,
                                         timeout=datetime.timedelta(seconds=60))
    try:
        kept = ranks.scenario_bn(str(tmp_path))
        monkeypatch.setattr(sync_batch_norm, "is_distributed", lambda: True)
        forced = ranks.scenario_bn(str(tmp_path))
    finally:
        torch.distributed.destroy_process_group()
    for k, r in ref.items():
        np.testing.assert_array_equal(kept[k], r, err_msg=k)
        _close(forced[k], r, 1e-12)


# ---------------------------------------------------------------- (b) PPYoloELoss

def _jax_loss(batch):
    from super_gradients_tpu.training.losses import ppyolo_loss as jax_loss

    cls_logits, reg, targets = ranks.loss_case(batch)
    points, strides, counts = ranks.loss_anchors()
    with jax.enable_x64():
        loss = jax_loss.PPYoloELoss(num_classes=ranks.LOSS_C)

        def f(c, r):
            return loss(ranks.LossOutputs(c, r, jnp.asarray(points), jnp.asarray(strides), counts), jnp.asarray(targets))

        (value, comps), grads = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
            jnp.asarray(cls_logits), jnp.asarray(reg))
        return float(value), {k: float(v) for k, v in comps.items()}, [np.asarray(g) for g in grads]


def _port_loss(batch):
    """The port's PPYoloELoss on the whole batch in one process, fp64."""
    from super_gradients_tpu_torch.training.losses import get_loss

    cls_logits, reg, targets = ranks.loss_case(batch)
    points, strides, counts = ranks.loss_anchors()
    c, r = torch.from_numpy(cls_logits).requires_grad_(), torch.from_numpy(reg).requires_grad_()
    value, comps = get_loss("PPYoloELoss", {"num_classes": ranks.LOSS_C})(
        ranks.LossOutputs(c, r, torch.from_numpy(points), torch.from_numpy(strides), counts), torch.from_numpy(targets))
    value.backward()
    return float(value.detach()), {k: float(v.detach()) for k, v in comps.items()}, [c.grad.numpy(), r.grad.numpy()]


@pytest.mark.parametrize("batch", [8, 7], ids=["4+4", "3+4"])
def test_ppyoloe_loss_over_ranks_equals_the_whole_batch(results, batch):
    per_rank = [r["loss"][batch] for r in results]
    world = len(per_rank)
    assert [len(r["d_cls"]) for r in per_rank] == [batch // 2, batch - batch // 2]
    got_value = np.mean([r["value"] for r in per_rank])
    got_comps = {k: np.mean([r["comps"][k] for r in per_rank]) for k in ("loss_cls", "loss_iou", "loss_dfl")}
    got_grads = [np.concatenate([r[name] for r in per_rank]) / world for name in ("d_cls", "d_reg")]
    for (value, comps, grads), rtol, grad_tol in ((_port_loss(batch), 1e-10, 1e-10), (_jax_loss(batch), 1e-5, 1e-4)):
        np.testing.assert_allclose(got_value, value, rtol=rtol)
        for k, v in got_comps.items():
            assert comps[k] > 0
            np.testing.assert_allclose(v, comps[k], rtol=rtol, err_msg=k)
        for got, ref in zip(got_grads, grads):
            _close(got, ref, grad_tol)


@pytest.mark.parametrize("batch", [8, 7], ids=["4+4", "3+4"])
@pytest.mark.parametrize("name", list(ranks.KD_SHAPES))
def test_kd_loss_over_ranks_equals_the_whole_batch(results, name, batch):
    per_rank = [r["kd_loss"][name, batch] for r in results]
    value, grad = ranks.kd_loss_value_and_grad(name, *ranks.kd_loss_case(name, batch))
    np.testing.assert_allclose(np.mean([v for v, _ in per_rank]), value, rtol=1e-12)
    _close(np.concatenate([g for _, g in per_rank]) / len(per_rank), grad, 1e-12)


# ---------------------------------------------------------------- (d, e) metrics

def _jax_detection_metrics():
    from super_gradients_tpu.training.metrics.detection import DetectionMetrics as JaxDetectionMetrics

    boxes, scores, targets = ranks.detection_set()
    metric = JaxDetectionMetrics(num_cls=ranks.DET_C, score_threshold=0.1)
    nms = metric.preprocess_device(ranks.DetOutputs(jnp.asarray(boxes), jnp.asarray(scores)), None)
    nms = type(nms)(*(np.asarray(t) for t in nms))
    return metric.compute(metric.update(metric.init(), nms, targets))


def test_detection_metrics_gathered_over_ranks_equal_jax_and_one_process(results):
    gathered = [r["metrics"]["detection"] for r in results]
    one_process = ranks.evaluate_metrics()["detection"]
    assert gathered[0] == gathered[1] == one_process
    jax_values = _jax_detection_metrics()
    assert {k: gathered[0][k] for k in jax_values} == jax_values
    assert 0 < gathered[0]["mAP@0.50:0.95"] < 1


def test_detection_metrics_depend_on_the_gather_order():
    """The same images read rank-major (each rank's slices of every batch first) give
    another mAP: equal scores tie across images in the AP's stable sort."""
    rank_major = []
    for r in range(2):
        for b in range(0, ranks.N_VALID, ranks.VALID_BATCH):
            n = min(ranks.VALID_BATCH, ranks.N_VALID - b)
            rank_major += list(range(b + r * n // 2, b + (r + 1) * n // 2))
    assert sorted(rank_major) == list(range(ranks.N_VALID))
    assert ranks.evaluate_metrics(order=rank_major)["detection"]["mAP@0.50:0.95"] != \
        ranks.evaluate_metrics()["detection"]["mAP@0.50:0.95"]


@pytest.mark.parametrize("name", ["classification", "segmentation"])
def test_device_metrics_and_validation_loss_are_global(results, name):
    one_process = ranks.evaluate_metrics()[name]
    for r in results:
        got = r["metrics"][name]
        assert got.keys() == one_process.keys()
        for k, v in one_process.items():
            if k == "Loss":
                np.testing.assert_allclose(got[k], v, rtol=1e-12 if name == "classification" else 1e-6)
            else:
                assert got[k] == v, (k, got[k], v)
    assert 0 < one_process["Loss"]


# ---------------------------------------------------------------- (f) samplers and loaders

@pytest.mark.parametrize("name", ["DistributedSampler", "RepeatAugSampler", "DistributedSamplerWrapper"])
def test_samplers_default_to_the_group_as_jax_to_the_processes(results, name):
    from super_gradients_tpu.training import samplers as jax_samplers

    data = list(range(10))
    make = {"DistributedSampler": lambda r: jax_samplers.DistributedSampler(data, num_replicas=2, rank=r, seed=3),
            "RepeatAugSampler": lambda r: jax_samplers.RepeatAugSampler(data, num_replicas=2, rank=r, seed=3,
                                                                         selected_round=0),
            "DistributedSamplerWrapper": lambda r: jax_samplers.DistributedSamplerWrapper(
                list(range(10)), num_replicas=2, rank=r, shuffle=True, seed=3)}[name]
    for r, res in enumerate(results):
        s = make(r)
        expected = []
        for epoch in (0, 1):
            s.set_epoch(epoch)
            expected.append([int(i) for i in iter(s)])
        assert res["samplers"][name] == expected


def test_loader_ranks_take_slices_of_the_global_batches(results):
    """Each rank's batch k is its slice of the one-process loader's batch k (the same
    epoch order on every rank), each sample drawn from the seed of its place."""
    single = DataLoader(list(range(10)), batch_size=4, shuffle=True, seed=3, drop_last=False)
    for r, res in enumerate(results):
        got = res["samplers"]
        assert got["loader_len"] == len(single) == 3
        for epoch in (0, 1):
            single.set_epoch(epoch)
            for k, (batch, (indices, draws)) in enumerate(zip(single, got["loader"][epoch])):
                n = len(batch)
                part = slice(r * n // 2, (r + 1) * n // 2)
                assert indices == batch.tolist()[part]
                positions = range(4 * k, 4 * k + n)[part]
                assert draws == [np.random.RandomState(sample_seed(3, epoch, p)).rand() for p in positions]
    # a sampler that splits the order itself is batched by batch_size / world
    assert [len(b) for b in results[0]["samplers"]["sharded"]] == [2, 2]
    taken = sum(results[0]["samplers"]["sharded"] + results[1]["samplers"]["sharded"], [])
    assert len(set(taken)) == 8 and set(taken) <= set(range(10))


# ---------------------------------------------------------------- (i) refusals

REFUSED = ["OhemCELoss", "DiceLoss", "BinaryDiceLoss", "BCEDiceLoss", "DiceCEEdgeLoss", "STDCLoss", "RSquaredLoss",
           "AutoTrainBatchSizeSelectionCallback", "a metric whose state does not sum"]


@pytest.mark.parametrize("what", REFUSED)
def test_non_exact_parts_refuse_under_two_ranks(results, what):
    for r in results:
        message = r["refusals"][what]
        assert message.startswith("NotImplementedError") and "item 8" in message, message


def test_loader_refuses_batches_that_do_not_split(results):
    for r in results:
        assert "must divide into the 2 ranks" in r["refusals"]["indivisible batch"]
        assert "drop_last=True" in r["refusals"]["last batch under the ranks"]


def test_setup_device_refusals(monkeypatch):
    """Without a launcher, with another WORLD_SIZE, and NCCL with more ranks than GPUs:
    each message gives the launch command. No process group is created here."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(ValueError, match="torch.distributed.run --nproc_per_node=2"):
        mesh.setup_device(num_devices=2, device="cpu")
    assert mesh.setup_device(device="cpu").num_devices == 1
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="num_devices=3 but the launcher started WORLD_SIZE=2.*nproc_per_node=3"):
        mesh.setup_device(num_devices=3, device="cpu")
    with pytest.raises(ValueError, match="NCCL needs CUDA"):
        mesh.setup_device(device="cpu", backend="nccl")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="Duplicate GPU detected.*nproc_per_node=1"):
        mesh.setup_device(device="cuda")
    assert not torch.distributed.is_initialized()


def test_host_collectives_across_two_ranks(results):
    for r in results:
        got = r["collectives"]
        assert got["distributed"] and got["hosts"] == [0, 1] and got["primary"] == 1
        assert got["mean"]["a"] == 0.5 and got["mean"]["b"].tolist() == [0.5, 1.0]
        assert got["gathered"]["x"].tolist() == [0, 0, 1] and got["gathered"]["y"].shape == (3, 2)
        assert got["gathered"]["y"].dtype == np.bool_ and got["gathered"]["y"].all()
        assert got["total"].tolist() == [3.0, 4.0]
    # d(sum_r w_r . total) / dx = sum_r w_r on every rank: the all-reduce's gradient is summed too
    assert results[0]["collectives"]["grad"].tolist() == results[1]["collectives"]["grad"].tolist() == [2.0, 30.0]


def test_one_process_needs_no_group():
    """Outside a group every helper is an identity, and the losses keep their one-process form."""
    from super_gradients_tpu_torch.parallel import collectives

    t = torch.tensor([1.5, 2.0], requires_grad=True)
    assert collectives.global_sum(t) is t
    assert collectives.global_normalizer(torch.tensor([0.25, 3.0])).tolist() == [1.0, 3.0]  # clamped at 1
    assert collectives.all_gather_from_hosts(3) == [3] and collectives.broadcast_from_primary("x") == "x"
    assert collectives.all_gather_variable_length({"a": np.arange(3)})["a"].tolist() == [0, 1, 2]
    assert collectives.maybe_pmean_across_hosts({"a": 2.0}) == {"a": 2.0}
    assert float(collectives.global_mean(t.detach())) == 1.75
    logits, labels = torch.randn(5, 3), torch.randint(0, 3, (5,))
    loss, _ = losses.CrossEntropyLoss()(logits, labels)
    torch.testing.assert_close(loss, torch.nn.functional.cross_entropy(logits, labels), rtol=1e-6, atol=0)
    assert mesh.local_batch_slice(7) == slice(0, 7)


# ---------------------------------------------------------------- (j) hangs

def test_a_failing_rank_fails_the_run_instead_of_hanging_it(tmp_path):
    """Rank 1 raises while rank 0 waits in an all-reduce: the launcher reports rank 1's
    traceback and kills rank 0, long before the 120 s timeout."""
    import time

    t0 = time.monotonic()
    with pytest.raises(ranks.RankFailure, match="(?s)rank 1 exited with code 1.*rank 1 fails before the collective"):
        ranks.run_ranks("hang", tmp_path, timeout=120)
    assert time.monotonic() - t0 < 60


def test_a_stuck_rank_is_killed_at_the_timeout(tmp_path):
    with pytest.raises(ranks.RankFailure, match="no result after 5 s"):
        ranks.run_ranks("sleep", tmp_path, timeout=5)
    assert not any(name.endswith(".pt") for name in os.listdir(tmp_path))
