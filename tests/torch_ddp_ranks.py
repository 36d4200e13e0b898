"""Rank bodies of the data-parallel tests (``tests/test_torch_ddp*.py``) and their launcher.

This module imports torch, numpy and the port only, so a rank never loads JAX.
:func:`run_ranks` starts ``world`` processes of ``python tests/torch_ddp_ranks.py
<scenario>[+<scenario>...] <workdir>`` with the environment ``torch.distributed.run``
sets (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT`` on a
free port). Each rank joins the group through ``setup_device`` (gloo on the CPU, one
thread, a process-group timeout), runs its scenarios and saves their results to
``<workdir>/<scenarios>.rank<r>.pt``. The launcher polls the ranks: as soon as one
exits with an error it kills the others and raises with every rank's output, and past
its timeout it kills them all, so a rank that fails inside a collective fails the test
instead of hanging the run.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from types import SimpleNamespace
from typing import Callable, Dict, List, NamedTuple

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


class RankFailure(RuntimeError):
    pass


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(scenarios: str, workdir, world: int = 2, timeout: float = 120.0, env: Dict[str, str] = None) -> List:
    """Run ``scenarios`` on ``world`` ranks; returns each rank's results, in rank order."""
    workdir = str(workdir)
    port = str(free_port())
    procs = []
    for rank in range(world):
        rank_env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                        LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1", MASTER_PORT=port, OMP_NUM_THREADS="1",
                        **(env or {}))
        log = open(os.path.join(workdir, f"{scenarios}.rank{rank}.log"), "w")
        procs.append((subprocess.Popen([sys.executable, os.path.abspath(__file__), scenarios, workdir], env=rank_env,
                                       stdout=log, stderr=subprocess.STDOUT), log))
    deadline = time.monotonic() + timeout
    try:
        while True:
            codes = [p.poll() for p, _ in procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                why = f"rank {failed[0]} exited with code {codes[failed[0]]}"
                break
            if all(c == 0 for c in codes):
                return [torch.load(os.path.join(workdir, f"{scenarios}.rank{r}.pt"), weights_only=False)
                        for r in range(world)]
            if time.monotonic() > deadline:
                why = f"no result after {timeout:.0f} s"
                break
            time.sleep(0.05)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)
            log.close()
    logs = "".join(f"\n----- rank {r} -----\n" + open(os.path.join(workdir, f"{scenarios}.rank{r}.log")).read()
                   for r in range(world))
    raise RankFailure(f"{scenarios}: {why}{logs}")


def run_command(cmd: List[str], cwd: str, timeout: float, env: Dict[str, str] = None) -> str:
    """Run a launcher command in a session of its own; past ``timeout`` the whole session
    (the launcher and its ranks) is killed. Returns its output; raises on failure."""
    import signal

    proc = subprocess.Popen(cmd, cwd=cwd, env=dict(os.environ, **(env or {})), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise RankFailure(f"{' '.join(cmd)}: no result after {timeout:.0f} s\n{out}")
    if proc.returncode != 0:
        raise RankFailure(f"{' '.join(cmd)}: exit code {proc.returncode}\n{out}")
    return out


# ------------------------------------------------------------------ shared data

BN_SHAPE = (8, 6, 5, 7)
BN_MOMENTUM = 0.03


def bn_case():
    """fp64 BN input, upstream gradient and module state, from a seed."""
    rng = np.random.RandomState(0)
    x = rng.randn(*BN_SHAPE) * 2.0 + 1.0
    gy = rng.randn(*BN_SHAPE)
    c = BN_SHAPE[1]
    return dict(x=x, gy=gy, weight=rng.rand(c) + 0.5, bias=rng.randn(c), running_mean=rng.randn(c) * 0.1,
                running_var=rng.rand(c) + 0.5)


LOSS_C, LOSS_REG_MAX, LOSS_IMAGE, LOSS_STRIDES = 4, 16, 64, (8, 16, 32)


class LossOutputs(NamedTuple):
    cls_logits: torch.Tensor
    reg_distri: torch.Tensor
    anchor_points: torch.Tensor
    stride_tensor: torch.Tensor
    num_anchors_list: tuple


def loss_anchors():
    points, strides = [], []
    for s in LOSS_STRIDES:
        n = LOSS_IMAGE // s
        gy, gx = np.meshgrid(np.arange(n) + 0.5, np.arange(n) + 0.5, indexing="ij")
        points.append(np.stack([gx, gy], -1).reshape(-1, 2))
        strides.append(np.full((n * n, 1), float(s)))
    return np.concatenate(points), np.concatenate(strides), tuple(len(p) for p in points)


def loss_case(batch: int):
    """fp64 head outputs and padded targets of ``batch`` 64x64 images, from a seed."""
    points, _, _ = loss_anchors()
    rng = np.random.RandomState(batch)
    cls_logits = rng.randn(batch, len(points), LOSS_C) * 2
    reg = rng.randn(batch, len(points), 4 * (LOSS_REG_MAX + 1)) * 2
    targets = np.full((batch, 6, 5), -1.0)
    for b in range(batch):
        count = 1 + b % 5
        xy = rng.rand(count, 2) * 40
        wh = rng.rand(count, 2) * 30 + 8
        targets[b, :count, 0] = rng.randint(0, LOSS_C, count)
        targets[b, :count, 1:5] = np.concatenate([xy, np.minimum(xy + wh, LOSS_IMAGE)], 1)
    return cls_logits, reg, targets


# The validation sets of the metric scenarios: each image is an 8x8 map filled with its
# index, which the stand-in network below turns into that image's fixed outputs.
N_VALID, VALID_BATCH = 10, 4  # batches of 4, 4 and 2: 2, 2 and 1 images a rank
DET_C, DET_A = 3, 6


class DetOutputs(NamedTuple):
    pred_bboxes: torch.Tensor
    pred_scores: torch.Tensor


def detection_set():
    """Boxes ``[N, A, 4]``, scores ``[N, A, C]`` and targets ``[N, 4, 5]``: every score one
    of 0.9 / 0.6 / 0.3, so equal scores recur across images, each image with hits and
    misses in another order."""
    rng = np.random.RandomState(5)
    boxes = np.zeros((N_VALID, DET_A, 4), np.float32)
    scores = np.zeros((N_VALID, DET_A, DET_C), np.float32)
    targets = np.full((N_VALID, 4, 5), -1.0, np.float32)
    for i in range(N_VALID):
        gts = []
        for g in range(1 + i % 3):
            x, y = 4 + 18 * g, 4 + 10 * (i % 4)
            gts.append((int(rng.randint(DET_C)), x, y, x + 14, y + 14))
        targets[i, :len(gts)] = gts
        for a in range(DET_A):
            c, x1, y1, x2, y2 = gts[a % len(gts)]
            hit = (i + a) % 3 != 0
            shift = 0.0 if hit else 9.0
            boxes[i, a] = (x1 + shift, y1 + shift, x2 + shift, y2 + shift)
            scores[i, a, c if hit else (c + 1) % DET_C] = (0.9, 0.6, 0.3)[(i + 2 * a) % 3]
    return boxes, scores, targets


def classification_set():
    rng = np.random.RandomState(6)
    logits = rng.randn(N_VALID, 8)
    logits[::3, 2] = logits[::3].max(1) + 1.0  # some rows' top class is 2
    return logits, rng.randint(0, 8, N_VALID)


def segmentation_set():
    rng = np.random.RandomState(7)
    logits = rng.randn(N_VALID, 4, 6, 6).astype(np.float32)
    targets = rng.randint(0, 4, (N_VALID, 6, 6))
    targets[:, 0, :2] = 255
    return logits, targets


class IndexedImages:
    """Items ``(8x8 map filled with i, target i)``."""

    def __init__(self, targets):
        self.targets = targets

    def __len__(self):
        return len(self.targets)

    def __getitem__(self, i):
        return np.full((3, 8, 8), float(i), np.float32), self.targets[i]


class Lookup(torch.nn.Module):
    """Stands in for a network: the fixed outputs of each input image's index."""

    def __init__(self, make: Callable):
        super().__init__()
        self.make = make

    def forward(self, images):
        return self.make(images[:, 0, 0, 0].long().numpy())


def metric_models():
    """name -> (network, targets, metrics, training params) of the three validation sets."""
    from super_gradients_tpu_torch.training.metrics import Accuracy, DetectionMetrics, IoU, PixelAccuracy, Top5

    boxes, scores, det_targets = detection_set()
    cls_logits, labels = classification_set()
    seg_logits, seg_targets = segmentation_set()
    return {
        "detection": (Lookup(lambda i: DetOutputs(torch.from_numpy(boxes[i]), torch.from_numpy(scores[i]))),
                      det_targets, lambda: [DetectionMetrics(num_cls=DET_C, score_threshold=0.1)], {}),
        "classification": (Lookup(lambda i: torch.from_numpy(cls_logits[i])), labels.astype(np.int64),
                           lambda: [Accuracy(), Top5()], {"loss": "CrossEntropyLoss"}),
        "segmentation": (Lookup(lambda i: torch.from_numpy(seg_logits[i])), seg_targets.astype(np.int64),
                         lambda: [IoU(num_classes=4), PixelAccuracy(num_classes=4)], {"loss": "SegCrossEntropyLoss"}),
    }


def evaluate_metrics(order=None) -> Dict[str, Dict[str, float]]:
    """``Trainer.evaluate`` of each validation set through the port's loader (``order``:
    the dataset indices in the order to read them, the default one)."""
    from super_gradients_tpu_torch.training import Trainer
    from super_gradients_tpu_torch.training.dataloaders import DataLoader

    out = {}
    for name, (net, targets, metrics, params) in metric_models().items():
        dataset = IndexedImages(targets)
        loader = DataLoader(dataset, batch_size=VALID_BATCH, shuffle=False, drop_last=False,
                            sampler=order)
        model = SimpleNamespace(net=net, device=torch.device("cpu"))
        out[name] = Trainer(f"ddp_{name}").evaluate(model, loader, params, metrics_list=metrics())
    return out


# -------------------------------------------------------------------- scenarios

def scenario_bn(workdir):
    from super_gradients_tpu_torch.parallel import GlobalBatchNorm2d, local_batch_slice

    case = bn_case()
    part = local_batch_slice(BN_SHAPE[0])
    bn = GlobalBatchNorm2d(BN_SHAPE[1], momentum=BN_MOMENTUM).double()
    with torch.no_grad():
        for k in ("weight", "bias", "running_mean", "running_var"):
            getattr(bn, k).copy_(torch.from_numpy(case[k]))
    x = torch.from_numpy(case["x"][part]).requires_grad_()
    y = bn(x)
    y.backward(torch.from_numpy(case["gy"][part]))
    return dict(y=y.detach().numpy(), dx=x.grad.numpy(), dweight=bn.weight.grad.numpy(), dbias=bn.bias.grad.numpy(),
                running_mean=bn.running_mean.numpy(), running_var=bn.running_var.numpy(),
                num_batches_tracked=int(bn.num_batches_tracked))


def scenario_bn_cuda(workdir):
    """The BN scenario in fp32 on the rank's GPU, TF32 off."""
    from super_gradients_tpu_torch.parallel import GlobalBatchNorm2d, local_batch_slice

    torch.backends.cudnn.allow_tf32 = False
    case = bn_case()
    part = local_batch_slice(BN_SHAPE[0])
    bn = GlobalBatchNorm2d(BN_SHAPE[1], momentum=BN_MOMENTUM).cuda()
    with torch.no_grad():
        for k in ("weight", "bias", "running_mean", "running_var"):
            getattr(bn, k).copy_(torch.from_numpy(case[k]).float())
    x = torch.from_numpy(case["x"][part]).float().cuda().requires_grad_()
    y = bn(x)
    y.backward(torch.from_numpy(case["gy"][part]).float().cuda())
    return {k: v.detach().cpu().double().numpy() for k, v in dict(
        y=y, dx=x.grad, dweight=bn.weight.grad, dbias=bn.bias.grad, running_mean=bn.running_mean,
        running_var=bn.running_var).items()}


def _loss_on_slice(batch):
    from super_gradients_tpu_torch.parallel import local_batch_slice
    from super_gradients_tpu_torch.training.losses import get_loss

    cls_logits, reg, targets = loss_case(batch)
    part = local_batch_slice(batch)
    points, strides, counts = loss_anchors()
    c = torch.from_numpy(cls_logits[part]).requires_grad_()
    r = torch.from_numpy(reg[part]).requires_grad_()
    loss = get_loss("PPYoloELoss", {"num_classes": LOSS_C})
    value, comps = loss(LossOutputs(c, r, torch.from_numpy(points), torch.from_numpy(strides), counts),
                        torch.from_numpy(targets[part]))
    value.backward()
    return dict(value=float(value.detach()), comps={k: float(v.detach()) for k, v in comps.items()},
                d_cls=c.grad.numpy(), d_reg=r.grad.numpy())


def scenario_loss(workdir):
    """PPYoloELoss on an even (8 = 4 + 4) and an uneven (7 = 3 + 4) split."""
    return {batch: _loss_on_slice(batch) for batch in (8, 7)}


KD_SHAPES = {"KDLogitsLoss": (10,), "SegKDLoss": (3, 4, 5)}  # per-item logits: [C] and [C, H, W]
KD_PARAMS = {"KDLogitsLoss": {"task_loss_fn": "CrossEntropyLoss", "distillation_loss_coeff": 0.3, "temperature": 2.0},
             "SegKDLoss": {"temperature": 3.0}}


def kd_loss_case(name: str, batch: int):
    """fp64 student and teacher logits and int labels of ``batch`` items, from a seed."""
    rng = np.random.RandomState(len(name) + batch)
    shape = (batch, *KD_SHAPES[name])
    return rng.randn(*shape) * 2, rng.randn(*shape) * 2, rng.randint(0, KD_SHAPES[name][0], batch)


def kd_loss_value_and_grad(name: str, student, teacher, labels):
    """The loss of ``KDOutput(student, teacher)`` and its student gradient (torch, fp64)."""
    from super_gradients_tpu_torch.training.losses import get_loss
    from super_gradients_tpu_torch.training.losses.kd_losses import KDOutput

    s = torch.from_numpy(student).requires_grad_()
    value, _ = get_loss(name, KD_PARAMS[name])(KDOutput(s, torch.from_numpy(teacher)), torch.from_numpy(labels))
    value.backward()
    return float(value.detach()), s.grad.numpy()


def scenario_kd_loss(workdir):
    """KDLogitsLoss and SegKDLoss on an even (8 = 4 + 4) and an uneven (7 = 3 + 4) split."""
    from super_gradients_tpu_torch.parallel import local_batch_slice

    out = {}
    for name in KD_SHAPES:
        for batch in (8, 7):
            part = local_batch_slice(batch)
            student, teacher, labels = kd_loss_case(name, batch)
            out[name, batch] = kd_loss_value_and_grad(name, student[part], teacher[part], labels[part])
    return out


def scenario_metrics(workdir):
    return evaluate_metrics()


def scenario_samplers(workdir):
    """The samplers' default replicas, the loader's slices of the global batches and the
    samples' seeds."""
    from super_gradients_tpu_torch.training import samplers
    from super_gradients_tpu_torch.training.dataloaders import DataLoader

    data = list(range(10))
    out = {}
    for name, make in (("DistributedSampler", lambda: samplers.DistributedSampler(data, seed=3)),
                       ("RepeatAugSampler", lambda: samplers.RepeatAugSampler(data, seed=3, selected_round=0)),
                       ("DistributedSamplerWrapper",
                        lambda: samplers.DistributedSamplerWrapper(list(range(10)), shuffle=True, seed=3))):
        s = make()
        out[name] = []
        for epoch in (0, 1):
            s.set_epoch(epoch)
            out[name].append(list(iter(s)))

    class Draws:
        """Item i: (i, a draw of the dataset's generator)."""

        def __init__(self):
            self.rng = np.random.RandomState(0)

        def reseed(self, seed):
            self.rng.seed(seed)

        def __len__(self):
            return 10

        def __getitem__(self, i):
            return np.int64(i), self.rng.rand()

    loader = DataLoader(Draws(), batch_size=4, shuffle=True, seed=3, drop_last=False)
    out["loader"] = []
    for epoch in (0, 1):
        loader.set_epoch(epoch)
        out["loader"].append([(i.tolist(), d.tolist()) for i, d in loader])
    out["loader_len"] = len(loader)
    sharded = DataLoader(data, batch_size=4, sampler=samplers.DistributedSampler(data, seed=3))
    out["sharded"] = [b.tolist() for b in sharded]
    return out


def scenario_collectives(workdir):
    """The JAX package's host collectives and ``global_sum``'s gradient."""
    import torch.distributed as dist

    from super_gradients_tpu_torch.parallel import collectives

    rank = dist.get_rank()
    x = torch.tensor([1.0 + rank, 2.0], dtype=torch.float64, requires_grad=True)
    total = collectives.global_sum(x)
    (total * torch.tensor([1.0, 10.0 * (rank + 1)], dtype=torch.float64)).sum().backward()
    return dict(hosts=collectives.all_gather_from_hosts(rank), primary=collectives.broadcast_from_primary(10 * rank + 1),
                mean=collectives.maybe_pmean_across_hosts({"a": float(rank), "b": np.asarray([rank, 2 * rank])}),
                gathered=collectives.all_gather_variable_length({"x": np.arange(rank + 1), "y": np.ones((rank + 1, 2), bool)}),
                total=total.detach().numpy(), grad=x.grad.numpy(), distributed=collectives.is_distributed())


def _raises(fn) -> str:
    try:
        fn()
    except (NotImplementedError, ValueError) as e:
        return f"{type(e).__name__}: {e}"
    return "did not raise"


def scenario_refusals(workdir):
    """What refuses to run across ranks, and how."""
    from super_gradients_tpu_torch.training import losses
    from super_gradients_tpu_torch.training.dataloaders import DataLoader
    from super_gradients_tpu_torch.training.metrics import Metric, MetricCollection
    from super_gradients_tpu_torch.training.pre_launch_callbacks import AutoTrainBatchSizeSelectionCallback

    seg_logits = torch.randn(2, 4, 8, 8)
    seg_targets = torch.randint(0, 4, (2, 8, 8))
    binary = torch.randint(0, 2, (2, 8, 8)).float()

    class Named(Metric):
        name = "Named"

        def init(self):
            return {"best": "none"}

        def update(self, state, outputs, targets):
            return state

        def compute(self, state):
            return {"Named": 0.0}

    out = {
        "indivisible batch": _raises(lambda: DataLoader(list(range(10)), batch_size=3)),
        "last batch under the ranks": _raises(lambda: DataLoader(list(range(9)), batch_size=4, drop_last=False)),
        "OhemCELoss": _raises(lambda: losses.OhemCELoss()(seg_logits, seg_targets)),
        "DiceLoss": _raises(lambda: losses.DiceLoss()(seg_logits, seg_targets)),
        "BinaryDiceLoss": _raises(lambda: losses.BinaryDiceLoss()(seg_logits[:, :1], binary)),
        "BCEDiceLoss": _raises(lambda: losses.BCEDiceLoss()(seg_logits[:, :1], binary)),
        "DiceCEEdgeLoss": _raises(lambda: losses.DiceCEEdgeLoss(num_classes=4)(seg_logits, seg_targets)),
        "STDCLoss": _raises(lambda: losses.STDCLoss(num_classes=4)(seg_logits, seg_targets)),
        "RSquaredLoss": _raises(lambda: losses.RSquaredLoss()(torch.randn(4), torch.randn(4))),
        "AutoTrainBatchSizeSelectionCallback": _raises(lambda: AutoTrainBatchSizeSelectionCallback()(
            {}, model=SimpleNamespace(device=torch.device("cpu")), loss_fn=lambda o, t: (o, {}))),
        "a metric whose state does not sum": _raises(lambda: MetricCollection([Named()]).compute(({"best": "x"},))),
    }
    return out


def scenario_hang(workdir):
    """Rank 1 fails; rank 0 waits for it in a collective."""
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise RuntimeError("rank 1 fails before the collective")
    dist.all_reduce(torch.ones(1))
    return {}


def scenario_sleep(workdir):
    """Rank 1 never reaches the collective."""
    import torch.distributed as dist

    if dist.get_rank() == 1:
        time.sleep(600)
    dist.all_reduce(torch.ones(1))
    return {}


# ---- the trainer (tests/test_torch_ddp_trainer.py)

TRAIN_B, TRAIN_IMAGE, TRAIN_C, TRAIN_BOXES = 8, 64, 4, 8
TRAIN_PARAMS = dict(
    max_epochs=1, loss="PPYoloELoss", criterion_params={"num_classes": TRAIN_C},
    optimizer="SGD", optimizer_params={"momentum": 0.9, "weight_decay": 1e-4}, zero_weight_decay_on_bias_and_bn=True,
    initial_lr=1e-3, lr_mode="CosineLRScheduler", cosine_final_lr_ratio=0.1, warmup_mode="LinearBatchLRWarmup",
    lr_warmup_steps=1, warmup_initial_lr=1e-4, ema=True, ema_params={"decay": 0.9, "decay_type": "threshold"},
    clip_grad_norm=1.0, save_model=False,
)


class AsDouble:
    """A loader's batches in fp64."""

    def __init__(self, loader):
        self.loader = loader

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        return ((images.double(), targets.double()) for images, targets in self.loader)

    def set_epoch(self, epoch):
        self.loader.set_epoch(epoch)


def train_loader(num_samples=2 * TRAIN_B, shuffle=False, drop_last=True):
    from super_gradients_tpu_torch.training import RandomDetectionDataset
    from super_gradients_tpu_torch.training.dataloaders import DataLoader

    dataset = RandomDetectionDataset(num_samples, (TRAIN_IMAGE, TRAIN_IMAGE), TRAIN_C, TRAIN_BOXES)
    return DataLoader(dataset, batch_size=TRAIN_B, shuffle=shuffle, seed=1, drop_last=drop_last)


def train_model(init_path, fp64: bool):
    from super_gradients_tpu_torch import models

    model = models.get("yolo_nas_s", num_classes=TRAIN_C, image_size=TRAIN_IMAGE, device="cpu")
    model.net.load_state_dict(torch.load(init_path, weights_only=True), strict=True)
    if fp64:
        model.net.double()
    return model


def train_two_steps(init_path, fp64: bool, root=None):
    """Two SGD steps of YOLO-NAS-S on a global batch of 8: (live state, EMA state, loss history)."""
    from super_gradients_tpu_torch.training import Trainer

    model = train_model(init_path, fp64)
    trainer = Trainer("ddp_two_steps", ckpt_root_dir=root)
    loader = train_loader()
    trainer.train(model, TRAIN_PARAMS, AsDouble(loader) if fp64 else loader)
    return dict(live=trainer.train_state.net.state_dict(), ema=model.net.state_dict(),
                history=trainer.train_loss_history, unread=trainer.unconsumed_training_params)


def scenario_trainer(workdir):
    root = os.path.join(workdir, "ckpt")
    return {dtype: train_two_steps(os.path.join(workdir, "init.pt"), dtype == "fp64", root) for dtype in ("fp64", "fp32")}


class WriteLog:
    """Records every file this process opens for writing, or saves with ``torch.save``."""

    def __init__(self):
        import builtins

        self.paths = []
        self._open, self._save = builtins.open, torch.save

    def __enter__(self):
        import builtins

        def logged_open(file, mode="r", *a, **kw):
            if any(m in mode for m in "wax+"):
                self.paths.append(str(file))
            return self._open(file, mode, *a, **kw)

        def logged_save(obj, f, *a, **kw):
            self.paths.append(str(f))
            return self._save(obj, f, *a, **kw)

        builtins.open, torch.save = logged_open, logged_save
        return self

    def __exit__(self, *exc):
        import builtins

        builtins.open, torch.save = self._open, self._save


def stop_after_first_epoch():
    """A callback that ends training after epoch 0's checkpoints, as an interrupted run ends."""
    from super_gradients_tpu_torch.training.callbacks import Callback

    class Stop(Callback):
        def on_train_loader_end(self, context):
            context.stop_training = True

    return Stop()


def scenario_resume(workdir):
    """2 epochs straight, and 1 epoch then a resume to 2, with checkpoints and validation."""
    from super_gradients_tpu_torch.training import Trainer

    root = os.path.join(workdir, "resume_ckpt")
    init = os.path.join(workdir, "init.pt")
    params = dict(TRAIN_PARAMS, max_epochs=2, save_model=True, sg_logger_params={"tensorboard": False},
                  valid_metrics_list=[{"DetectionMetrics": {"num_cls": TRAIN_C}}], metric_to_watch="mAP@0.50:0.95")

    def run(name, extra, callbacks=()):
        model = train_model(init, fp64=False)
        trainer = Trainer(name, ckpt_root_dir=root)
        loader = train_loader(shuffle=True)
        trainer.train(model, dict(params, **extra), loader, train_loader(num_samples=12, drop_last=False),
                      additional_callbacks=callbacks)
        st = trainer.train_state
        return dict(live=st.net.state_dict(), ema=st.ema.state_dict(), optimizer=st.optimizer.state_dict(),
                    step=st.step, valid=trainer.valid_metrics_history, best=trainer.best_metric,
                    ckpt_dir=trainer.ckpt_dir)

    with WriteLog() as log:
        straight = run("straight", {})
        run("resumed", {}, [stop_after_first_epoch()])
        resumed = run("resumed", {"resume": True})
    return dict(straight=straight, resumed=resumed, written=[p for p in log.paths if p.startswith(root)])


SCENARIOS = {name[len("scenario_"):]: fn for name, fn in dict(globals()).items() if name.startswith("scenario_")}


def main(argv):
    scenarios, workdir = argv[1], argv[2]
    torch.set_num_threads(1)
    import torch.distributed as dist

    from super_gradients_tpu_torch.parallel import setup_device

    setup_device(device=os.environ.get("DDP_TEST_DEVICE", "cpu"), backend=os.environ.get("DDP_TEST_BACKEND"))
    results = {name: SCENARIOS[name](workdir) for name in scenarios.split("+")}
    torch.save(results, os.path.join(workdir, f"{scenarios}.rank{dist.get_rank()}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv)
